"""Config schema: an architecture is a model config plus its input-shape set.

The port's copy of the JAX package's ``configs/base.py`` (which imports no
JAX): each ``<id>.py`` exports ``ARCH`` and :mod:`.registry` collects them
for ``--arch`` selection. Shapes carry the assignment's dimensions;
``skip_shapes`` names cells that are architecturally undefined (512k dense
attention, DESIGN.md).
"""
from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode | serve | retrieval | graph_train
    dims: dict


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str  # lm | gnn | recsys | retrieval
    config: Any
    shapes: tuple[ShapeSpec, ...]
    notes: str = ""
    skip_shapes: tuple[str, ...] = ()
    source: str = ""

    def shape(self, name: str) -> ShapeSpec:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.arch_id} has no shape {name}")


# Shared LM shape set (seq_len x global_batch per the assignment).
LM_SHAPES = (
    ShapeSpec("train_4k", "train", {"seq_len": 4096, "global_batch": 256}),
    ShapeSpec("prefill_32k", "prefill", {"seq_len": 32768, "global_batch": 32}),
    ShapeSpec("decode_32k", "decode", {"seq_len": 32768, "global_batch": 128}),
    ShapeSpec("long_500k", "decode", {"seq_len": 524288, "global_batch": 1}),
)

GNN_SHAPES = (
    ShapeSpec(
        "full_graph_sm",
        "graph_train",
        {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433, "n_classes": 7},
    ),
    ShapeSpec(
        "minibatch_lg",
        "graph_train",
        {
            "n_nodes": 232_965,
            "n_edges": 114_615_892,
            "batch_nodes": 1024,
            "fanout": (15, 10),
            "d_feat": 602,
            "n_classes": 41,
        },
    ),
    ShapeSpec(
        "ogb_products",
        "graph_train",
        {"n_nodes": 2_449_029, "n_edges": 61_859_140, "d_feat": 100, "n_classes": 47},
    ),
    ShapeSpec(
        "molecule",
        "graph_train",
        {
            "n_nodes": 30,
            "n_edges": 64,
            "batch": 128,
            "d_feat": 28,
            "d_edge": 4,
            "regression": True,
        },
    ),
)

RECSYS_SHAPES = (
    ShapeSpec("train_batch", "train", {"batch": 65_536}),
    ShapeSpec("serve_p99", "serve", {"batch": 512}),
    ShapeSpec("serve_bulk", "serve", {"batch": 262_144}),
    ShapeSpec("retrieval_cand", "retrieval", {"batch": 1, "n_candidates": 1_000_000}),
)
