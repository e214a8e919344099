"""sasrec [recsys] — self-attentive sequential recommendation
[arXiv:1808.09781].

The port's copy of the JAX package's values, unchanged."""
from ..models.recsys import RecsysConfig
from .base import ArchSpec, RECSYS_SHAPES

ARCH = ArchSpec(
    arch_id="sasrec",
    family="recsys",
    config=RecsysConfig(
        name="sasrec",
        kind="sasrec",
        embed_dim=50,
        n_blocks=2,
        n_heads=1,
        seq_len=50,
        item_vocab=1_048_576,
    ),
    shapes=RECSYS_SHAPES,
    notes="retrieval_cand scores the last hidden state against candidate "
    "item embeddings — LIDER-servable (optional backend).",
    source="arXiv:1808.09781",
)
