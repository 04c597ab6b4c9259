"""Training/eval steps. Only the single-device step is ported so far."""
