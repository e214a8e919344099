"""Configurations of the port (its own copies of the values): the
architecture registry and ``lider-msmarco``'s serving settings."""
from .base import ArchSpec, ShapeSpec
from .registry import ARCHS, ASSIGNED, get_arch

__all__ = ["ArchSpec", "ShapeSpec", "ARCHS", "ASSIGNED", "get_arch"]
