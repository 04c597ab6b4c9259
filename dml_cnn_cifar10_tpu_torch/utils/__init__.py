"""Host utilities: console/JSONL logging and device selection."""
