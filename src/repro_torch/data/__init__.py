"""Deterministic synthetic data and the step-indexed pipeline."""
