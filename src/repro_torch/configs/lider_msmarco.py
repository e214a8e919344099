"""lider-msmarco: the paper's own system, LIDER over an MS MARCO-scale
corpus of 768-d passage embeddings (paper Sec. 7.2.1 settings: c=1024,
c0=20, H=10, W_c=10, W_i=5).

The port's copy of the JAX package's ``configs/lider_msmarco.py`` values
at the reference's own size, 8,847,360 passages, with one cut, forced:

- ``capacity=None`` (the largest cluster padded to ``pad_multiple``, no
  drops) replaces 12,288. After the 20 Lloyd steps on this corpus the
  largest cluster holds 12,769 passages (``chip_smoke.py``'s main phase on
  an H100, which checks the rest of this sentence on every run), so a
  capacity of 12,288 drops 1,430 passages from 6 clusters and the build
  raises ``CapacityOverflowError``, as the reference's does. ``allow_drops``
  stays False: a passage that cannot be found is a different result.
  ``Lp`` is 12,776.

``QUANTIZED`` holds the device-tier quantized operating points searched on
the same corpus: the JAX package's own values (``LiderConfig.rescore_factor``
default 4; ``BENCH_verify.json``: ``sketch_factor`` 4, ``block_q`` 8).

``HOST_TIER`` holds the same quantized points with the float32 rescore
table on the host tier (``rescore_tier="host"``: ``lider_config`` builds
their index there), and ``SERVING`` the serving engine's setting for
them: batches of 256, the default ``SchedulerConfig`` (fixed batches, one
FIFO tenant, no cache, no SLO), the engine's fixed pipeline depth of 2
(``serving.engine.PIPELINE_DEPTH``, the JAX engine's double buffer), and
the traffic the engine is driven with: a closed loop of 16 x 256 queries,
and an open loop of 2,048 Zipf-skewed arrivals over a 4,096-query pool at
half the closed loop's measured rate (the JAX package's
``traffic.make_trace``).

``LIFECYCLE`` is the index-update scenario run on the same corpus: the JAX
package's ``benchmarks/index_update.py`` split (build on 80%, upsert the
other 20% in 4 batches by the exact route, layer 1 frozen), then a delete
of 5% of the ids, drawn from the seed, with eager compaction of every
touched cluster. (That benchmark deletes the first 1% of the ids; 5% drawn
at random touches every cluster.)

``chip_smoke.py`` runs ``SERVING``'s engine loops and ``LIFECYCLE`` on a
1,048,576-passage corpus, where they ran before the cell took its full
size; each prints the time, disk or memory the full size would take.

``ARCH`` is the registry's entry (``configs.registry``): the JAX package's
``lider-msmarco`` architecture, with its values uncut (8,847,360 passages,
capacity 12,288) and its three shapes.
"""
import dataclasses

from ..core.lider import LiderConfig
from ..serving.scheduler import SchedulerConfig
from .base import ArchSpec, ShapeSpec


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
    corpus_size=8_847_360,
    dim=768,
    k=100,
    batch=256,
)



@dataclasses.dataclass(frozen=True)
class OperatingPoint:
    """A quantized search: the bank it runs on (storage, rescore tier;
    :meth:`lider_config`) and the options passed to ``search_lider``."""

    name: str
    storage_dtype: str
    rescore_factor: int = 4
    sketch_factor: int | None = None
    block_q: int | None = None
    rescore_tier: str = "device"

    def lider_config(self, base: LiderConfig) -> LiderConfig:
        """``base`` with this point's storage and rescore tier: the config
        ``build_lider`` builds the point's index from."""
        return dataclasses.replace(base, storage_dtype=self.storage_dtype, rescore_tier=self.rescore_tier)

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

# The same points with the rescore table in host memory.
HOST_TIER = tuple(dataclasses.replace(p, rescore_tier="host") for p in QUANTIZED)


@dataclasses.dataclass(frozen=True)
class Serving:
    """The engine setting and the traffic it is driven with."""

    batch: int = 256
    scheduler: SchedulerConfig = SchedulerConfig()
    closed_loop_batches: int = 16  # closed loop: 16 x 256 queries, then drain
    open_loop_arrivals: int = 2048
    open_loop_pool: int = 4096
    open_loop_pattern: str = "zipf"
    open_loop_rate_fraction: float = 0.5  # of the closed loop's queries/s
    held_out_fraction: float = 0.01  # update under serving: upsert 1% held out


SERVING = Serving()

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

@dataclasses.dataclass(frozen=True)
class RetrievalArchConfig:
    lider: LiderConfig
    corpus_size: int
    dim: int
    capacity: int  # padded cluster capacity Lp
    k: int = 100


ARCH = ArchSpec(
    arch_id="lider-msmarco",
    family="retrieval",
    config=RetrievalArchConfig(
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
        ),
        corpus_size=8_847_360,  # 8.8M padded to cluster grid
        dim=768,
        capacity=12_288,  # ~1.4x mean cluster size
        k=100,
    ),
    shapes=(
        ShapeSpec("serve_online", "retrieval_serve", {"batch": 256}),
        ShapeSpec("serve_bulk", "retrieval_serve", {"batch": 8192}),
        ShapeSpec("build_kmeans_step", "build", {}),
    ),
    notes="The paper's system itself: LIDER over an MS MARCO-scale corpus.",
    source="LIDER paper Sec. 7",
)

# Cuts from the reference configuration, in the order above.
REDUCED = (
    "capacity 12,288 -> None (Lp 12,776): forced, the largest cluster after the 20 Lloyd steps "
    "holds 12,769 passages (chip_smoke.py's main phase on the card), so 12,288 would drop 1,430 "
    "passages from 6 clusters and the build raises CapacityOverflowError as the reference's does",
)
