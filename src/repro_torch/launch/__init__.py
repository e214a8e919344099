"""Entry points: ``python -m repro_torch.launch.serve`` builds (or loads) an
index and serves batched queries on the card."""
