"""Training/eval steps, the process mesh and its collectives, the
multi-process bootstrap and ring attention."""
