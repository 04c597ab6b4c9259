"""Model definitions (the reference CNN, ViT-Tiny) and the registry."""
