"""lider-msmarco: the paper's own system, LIDER over an MS MARCO-scale
corpus of 768-d passage embeddings (paper Sec. 7.2.1 settings: c=1024,
c0=20, H=10, W_c=10, W_i=5).

The port's copy of the JAX package's ``configs/lider_msmarco.py`` values,
with two cuts:

- ``corpus_size`` is 1,048,576 passages, not 8,847,360. This is the size
  chosen for the first slice of the port, not one that memory forces: the
  build at 1M peaks near 11.4 GiB on an 80 GB H100, so a larger corpus
  would fit (at 8.8M the f32 corpus alone is 27 GB and an f32 bank at
  capacity 12,288 another 38.6 GB);
- ``capacity=None`` (the largest cluster, no drops) replaces 12,288, which
  was sized for 8.8M passages.

``QUANTIZED`` holds the device-tier quantized operating points searched on
the same corpus: the JAX package's own values (``LiderConfig.rescore_factor``
default 4; ``BENCH_verify.json``: ``sketch_factor`` 4, ``block_q`` 8).

``LIFECYCLE`` is the index-update scenario run on the same corpus: the JAX
package's ``benchmarks/index_update.py`` split (build on 80%, upsert the
other 20% in 4 batches by the exact route, layer 1 frozen), then a delete
of 5% of the ids, drawn from the seed, with eager compaction of every
touched cluster. (That benchmark deletes the first 1% of the ids; 5% drawn
at random touches every cluster.)
"""
import dataclasses

from ..core.lider import LiderConfig


@dataclasses.dataclass(frozen=True)
class RetrievalConfig:
    lider: LiderConfig
    corpus_size: int
    dim: int
    k: int
    batch: int  # queries per batch (the ``serve_online`` shape)


CONFIG = RetrievalConfig(
    lider=LiderConfig(
        n_clusters=1024,
        n_probe=20,
        n_arrays=10,
        n_arrays_centroid=10,
        key_len=16,
        key_len_centroid=10,
        n_leaves=5,
        n_leaves_centroid=10,
        r0=4,
        r0_centroid=4,
        kmeans_iters=20,
        capacity=None,
        storage_dtype="float32",
        rescore_tier="device",
        prune_margin=None,
        refine=False,
    ),
    corpus_size=1_048_576,
    dim=768,
    k=100,
    batch=256,
)



@dataclasses.dataclass(frozen=True)
class OperatingPoint:
    """A quantized device-tier search: the bank's storage and the search
    options passed to ``search_lider``."""

    name: str
    storage_dtype: str
    rescore_factor: int = 4
    sketch_factor: int | None = None
    block_q: int | None = None

    def search_kwargs(self) -> dict:
        return {
            "rescore_factor": self.rescore_factor,
            "sketch_factor": self.sketch_factor,
            "block_q": self.block_q,
        }


QUANTIZED = (
    OperatingPoint("Q8", "int8"),  # int8 first pass, k' = 4k, exact rescore
    OperatingPoint("Q8-cm", "int8", block_q=8),  # the same, cluster-major
    OperatingPoint("Q4-sk", "int4", sketch_factor=4),  # sketch -> int4 -> rescore
    OperatingPoint("Q4-sk-cm", "int4", sketch_factor=4, block_q=8),
)

@dataclasses.dataclass(frozen=True)
class Lifecycle:
    """Build on ``1 - update_fraction`` of the corpus with the centroids
    frozen, upsert the rest in ``upsert_batches`` batches, then delete
    ``delete_fraction`` of the ids."""

    update_fraction: float = 0.2
    upsert_batches: int = 4
    route: str = "exact"
    delete_fraction: float = 0.05
    refit_threshold: float = 0.0  # compact every touched cluster


LIFECYCLE = Lifecycle()

# Cuts from the reference configuration, in the order above.
REDUCED = (
    "corpus_size 8,847,360 -> 1,048,576 (the first slice's size; memory does not force it)",
    "capacity 12,288 -> None (largest cluster; 12,288 was sized for 8.8M passages)",
)
