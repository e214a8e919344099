"""Architecture registry: ``--arch <id>`` resolution.

The port's copy of the JAX package's registry: the ten assigned
architectures (five LMs, the GNN and four recsys models) and
``lider-msmarco``.
"""
from __future__ import annotations

from . import (
    din,
    gatedgcn,
    lider_msmarco,
    llama4_scout_17b_a16e,
    minitron_4b,
    qwen2_5_3b,
    qwen2_72b,
    qwen3_moe_235b_a22b,
    sasrec,
    two_tower_retrieval,
    xdeepfm,
)
from .base import ArchSpec

_ALL = (
    minitron_4b.ARCH,
    qwen2_5_3b.ARCH,
    qwen2_72b.ARCH,
    qwen3_moe_235b_a22b.ARCH,
    llama4_scout_17b_a16e.ARCH,
    gatedgcn.ARCH,
    sasrec.ARCH,
    two_tower_retrieval.ARCH,
    din.ARCH,
    xdeepfm.ARCH,
    lider_msmarco.ARCH,
)

ARCHS: dict[str, ArchSpec] = {a.arch_id: a for a in _ALL}
ASSIGNED = [a.arch_id for a in _ALL if a.arch_id != "lider-msmarco"]


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(ARCHS)}")
    return ARCHS[arch_id]
