"""Model definitions (the reference CNN) and the registry."""
