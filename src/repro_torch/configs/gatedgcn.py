"""gatedgcn [gnn] — 16 layers, d_hidden=70, gated aggregation
[arXiv:2003.00982 benchmarking-GNNs]. Per-shape feature/label dims are bound
at step construction (cora / reddit / ogbn-products / ZINC-like molecule).

The port's copy of the JAX package's values, unchanged."""
from ..models.gnn import GNNConfig
from .base import ArchSpec, GNN_SHAPES

ARCH = ArchSpec(
    arch_id="gatedgcn",
    family="gnn",
    config=GNNConfig(
        name="gatedgcn",
        n_layers=16,
        d_hidden=70,
        d_feat=1433,  # overridden per shape
        n_classes=7,
    ),
    shapes=GNN_SHAPES,
    notes="LIDER inapplicable (explicit-graph message passing, no kNN "
    "retrieval stage) — built without the technique per the assignment.",
    source="arXiv:2003.00982",
)
