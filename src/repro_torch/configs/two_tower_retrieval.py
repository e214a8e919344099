"""two-tower-retrieval [recsys] — sampled-softmax retrieval
[Yi et al., RecSys'19 (YouTube)]. The flagship LIDER arch: retrieval_cand is
exactly the paper's workload (1 query vs 1M dense candidates).

The port's copy of the JAX package's values, unchanged."""
from ..models.recsys import RecsysConfig
from .base import ArchSpec, RECSYS_SHAPES

ARCH = ArchSpec(
    arch_id="two-tower-retrieval",
    family="recsys",
    config=RecsysConfig(
        name="two-tower-retrieval",
        kind="two_tower",
        embed_dim=256,
        tower_dims=(1024, 512, 256),
        item_vocab=2_097_152,
        field_vocab=131_072,
        n_user_fields=4,
        n_item_fields=2,
    ),
    shapes=RECSYS_SHAPES,
    notes="retrieval_cand served brute-force (Flat) or via LIDER over the "
    "item-tower embeddings — the paper-representative hillclimb cell.",
    source="RecSys'19 (YouTube two-tower; unverified tier)",
)
