"""qwen3-moe-235b-a22b [moe] — 128 experts top-8, GQA kv=4
[hf:Qwen/Qwen3-235B-A22B family]."""
import torch

from ..models.transformer import LMConfig, MoEConfig
from .base import ArchSpec, LM_SHAPES

ARCH = ArchSpec(
    arch_id="qwen3-moe-235b-a22b",
    family="lm",
    config=LMConfig(
        name="qwen3-moe-235b-a22b",
        n_layers=94,
        d_model=4096,
        n_heads=64,
        n_kv_heads=4,
        d_ff=1536,  # per-expert ff (assignment spec)
        vocab=151_936,
        d_head=128,
        moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=1536),
        dtype=torch.bfloat16,
        # bf16 parameter storage (the reference's choice) beside float32
        # Adam moments.
        param_dtype=torch.bfloat16,
    ),
    shapes=LM_SHAPES,
    skip_shapes=("long_500k",),
    notes="MoE every layer (expert-parallel over the model axis); pure full "
    "attention so long_500k is skipped (see DESIGN.md).",
    source="hf:Qwen/Qwen3-30B-A3B (scaled per assignment)",
)
