"""din [recsys] — deep interest network, target attention over user history
[arXiv:1706.06978].

The port's copy of the JAX package's values, unchanged."""
from ..models.recsys import RecsysConfig
from .base import ArchSpec, RECSYS_SHAPES

ARCH = ArchSpec(
    arch_id="din",
    family="recsys",
    config=RecsysConfig(
        name="din",
        kind="din",
        embed_dim=18,
        seq_len=100,
        attn_dims=(80, 40),
        mlp_dims=(200, 80),
        item_vocab=1_048_576,
    ),
    shapes=RECSYS_SHAPES,
    source="arXiv:1706.06978",
)
