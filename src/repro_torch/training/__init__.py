"""Checkpoints (index and training steps), the optimizer, the train loop and
the restart harness."""
