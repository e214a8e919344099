"""xdeepfm [recsys] — CIN + DNN CTR model [arXiv:1803.05170].

The port's copy of the JAX package's values, unchanged."""
from ..models.recsys import RecsysConfig
from .base import ArchSpec, RECSYS_SHAPES

ARCH = ArchSpec(
    arch_id="xdeepfm",
    family="recsys",
    config=RecsysConfig(
        name="xdeepfm",
        kind="xdeepfm",
        embed_dim=10,
        n_sparse=39,
        cin_dims=(200, 200, 200),
        dnn_dims=(400, 400),
        field_vocab=1_048_576,  # Criteo-scale: 39 x 2^20 ~ 41M rows
    ),
    shapes=RECSYS_SHAPES,
    notes="Pointwise CTR scorer, no embedding-space kNN stage: LIDER "
    "inapplicable (DESIGN.md §Arch-applicability).",
    source="arXiv:1803.05170",
)
