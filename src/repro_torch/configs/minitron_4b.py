"""minitron-4b [dense] — pruned Nemotron [arXiv:2407.14679; hf]."""
import torch

from ..models.transformer import LMConfig
from .base import ArchSpec, LM_SHAPES

ARCH = ArchSpec(
    arch_id="minitron-4b",
    family="lm",
    config=LMConfig(
        name="minitron-4b",
        n_layers=32,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        d_ff=9216,
        vocab=256_000,
        d_head=128,
        dtype=torch.bfloat16,
    ),
    shapes=LM_SHAPES,
    skip_shapes=("long_500k",),
    notes="Pure full attention; long_500k (512k dense attention) is "
    "architecturally undefined — skipped per DESIGN.md §Arch-applicability.",
    source="arXiv:2407.14679",
)
