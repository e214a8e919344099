"""Architecture registry: ``--arch <id>`` resolution.

The port has the five LM architectures and ``lider-msmarco``. The recsys
and GNN ids of the JAX package's registry need ``models/recsys.py`` and
``models/gnn.py``, which are not ported yet: :func:`get_arch` refuses them
with ``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

from . import (
    lider_msmarco,
    llama4_scout_17b_a16e,
    minitron_4b,
    qwen2_5_3b,
    qwen2_72b,
    qwen3_moe_235b_a22b,
)
from .base import ArchSpec

_ALL = (
    minitron_4b.ARCH,
    qwen2_5_3b.ARCH,
    qwen2_72b.ARCH,
    qwen3_moe_235b_a22b.ARCH,
    llama4_scout_17b_a16e.ARCH,
    lider_msmarco.ARCH,
)

ARCHS: dict[str, ArchSpec] = {a.arch_id: a for a in _ALL}

_WAITS = "ROADMAP.md queue 1, module 1.2 (models/{recsys,gnn}.py)"
# Ids of the JAX package's registry that the port does not have yet.
UNPORTED: dict[str, str] = {
    "gatedgcn": f"gnn family: {_WAITS}",
    "sasrec": f"recsys family: {_WAITS}",
    "two-tower-retrieval": f"recsys family: {_WAITS}",
    "din": f"recsys family: {_WAITS}",
    "xdeepfm": f"recsys family: {_WAITS}",
}


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id in UNPORTED:
        raise NotImplementedError(f"{arch_id} is not ported yet ({UNPORTED[arch_id]})")
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(ARCHS)}")
    return ARCHS[arch_id]
