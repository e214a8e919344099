"""llama4-scout-17b-a16e [moe] — 16 experts top-1 + shared expert,
interleaved chunked-local attention (iRoPE) [hf:meta-llama/Llama-4-Scout]."""
import torch

from ..models.transformer import LMConfig, MoEConfig
from .base import ArchSpec, LM_SHAPES

ARCH = ArchSpec(
    arch_id="llama4-scout-17b-a16e",
    family="lm",
    config=LMConfig(
        name="llama4-scout-17b-a16e",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_ff=8192,  # per-expert ff
        vocab=202_048,
        d_head=128,
        moe=MoEConfig(n_experts=16, top_k=1, d_ff_expert=8192, n_shared=1),
        window=8192,  # 3 local : 1 global chunked attention -> long_500k runs
        local_ratio=4,
        dtype=torch.bfloat16,
    ),
    shapes=LM_SHAPES,
    notes="Long-context arch: chunked local attention (window 8192, every "
    "4th layer global) makes long_500k sub-quadratic in the local layers — "
    "the one LM arch that runs the 512k cell.",
    source="hf:meta-llama/Llama-4-Scout-17B-16E (unverified tier)",
)
