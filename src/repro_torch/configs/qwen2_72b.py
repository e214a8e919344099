"""qwen2-72b [dense] — GQA kv=8, QKV bias [arXiv:2407.10671]."""
import torch

from ..models.transformer import LMConfig
from .base import ArchSpec, LM_SHAPES

ARCH = ArchSpec(
    arch_id="qwen2-72b",
    family="lm",
    config=LMConfig(
        name="qwen2-72b",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=29568,
        vocab=152_064,
        d_head=128,
        qkv_bias=True,
        dtype=torch.bfloat16,
        # bf16 parameter storage (the reference's choice): half the weight
        # bytes; the float32 Adam moments keep the precision.
        param_dtype=torch.bfloat16,
    ),
    shapes=LM_SHAPES,
    skip_shapes=("long_500k",),
    notes="Pure full attention; long_500k skipped (see DESIGN.md).",
    source="arXiv:2407.10671",
)
