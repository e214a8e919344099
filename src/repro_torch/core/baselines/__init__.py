"""Baselines; this slice ports the exact Flat search (recall ground truth)."""
from .flat import flat_search

__all__ = ["flat_search"]
