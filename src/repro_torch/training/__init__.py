"""Index checkpoints (read side)."""
