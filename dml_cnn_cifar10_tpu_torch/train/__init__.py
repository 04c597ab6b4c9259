"""Loss, metrics, optimizer and the training driver."""
