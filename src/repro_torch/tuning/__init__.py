"""Offline autotuning for the serving control plane.

``tuning.pareto`` sweeps the speed-quality knobs (n_probe, r0, prune_margin,
refine, rescore_factor, block_q, sketch_factor) on held-out queries, maps
the Pareto frontier (AQT vs recall@k / MRR@10), and selects an operating
point for a target recall: what ``launch.serve --recall-target`` serves.
"""
from .pareto import (
    OperatingPoint,
    SweepResult,
    default_grid,
    pareto_frontier,
    select_operating_point,
    sweep,
)

__all__ = [
    "OperatingPoint",
    "SweepResult",
    "default_grid",
    "pareto_frontier",
    "select_operating_point",
    "sweep",
]
