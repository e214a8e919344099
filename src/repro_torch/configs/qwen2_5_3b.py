"""qwen2.5-3b [dense] — GQA kv=2, QKV bias [hf:Qwen/Qwen2.5 family]."""
import torch

from ..models.transformer import LMConfig
from .base import ArchSpec, LM_SHAPES

ARCH = ArchSpec(
    arch_id="qwen2.5-3b",
    family="lm",
    config=LMConfig(
        name="qwen2.5-3b",
        n_layers=36,
        d_model=2048,
        n_heads=16,
        n_kv_heads=2,
        d_ff=11008,
        vocab=151_936,
        d_head=128,
        qkv_bias=True,
        dtype=torch.bfloat16,
    ),
    shapes=LM_SHAPES,
    skip_shapes=("long_500k",),
    notes="Pure full attention; long_500k skipped (see DESIGN.md).",
    source="hf:Qwen/Qwen2.5-3B",
)
