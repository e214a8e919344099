"""LIDER: the clustering-based two-layer learned index (paper Sec. 3).

Layer 1: a *centroids retriever* (one core model over the k-means centroids)
routes each query to ``n_probe`` clusters. Layer 2: the
:class:`~repro_torch.core.bank.ClusterBank`, the per-cluster retrievers
stacked into dense padded tensors, so a (query x probed-cluster) batch is
gathers plus one verification call.

Every verification of a search goes through ``kernels.ops``: the CUDA
kernels on the card, their plain versions on the CPU.

- Float32 / bfloat16 bank: routing, then one ``fused_verify`` pass.
- int8 / int4 bank (device tier): a first pass over the codes keeps the
  provisional top-``k' = rescore_factor * k`` rows, then ``fused_verify``
  rescores them exactly from the float32 table. ``sketch_factor`` puts the
  1-bit ``sketch_prefilter`` pass ahead of the code pass; ``block_q``
  runs the code pass cluster-major (``fused_verify_grouped``) on a host
  schedule. Both spellings give the same ids and scores, bit for bit.
- int8 / int4 bank, host tier (``rescore_tier="host"``): the float32
  table stays in host memory (``bank.EmbStore``) and the search runs in
  three stages: the first pass on the card (:func:`host_first_pass`), the
  host gather of the provisional rows (:func:`host_fetch`), and the same
  ``fused_verify`` rescore over the fetched block (:func:`host_rescore`).
  Ids and scores equal the device tier's, bit for bit. The serving engine
  pipelines the stages across batches.

The seven entries the JAX package compiles with ``jax.jit`` are wrapped in
the graph cache (``core.graphs``): on the card each signature is captured
into a CUDA graph once and replayed after, and :func:`query_path_cache_size`
counts the signatures, as the JAX package counts its traces.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import bank as bank_lib
from . import clustering, lsh as lsh_lib, rescale as rescale_lib, rmi as rmi_lib
from .graphs import query_path_entry
from .. import obs
from ..device import resolve_device
from ..kernels.ops import sketch_topk_op, verify_topk_grouped_op, verify_topk_op
from ..kernels.schedule import _pad_pow2, build_cluster_schedule
from .bank import ClusterBank
from .core_model import CoreModelParams, TopK, build_core_model, search_core_model
from .types import map_tensors
from .utils import dedup_topk


@dataclasses.dataclass(frozen=True)
class LiderConfig:
    """Static build/search configuration (paper Sec. 7.2.1 defaults): the
    JAX package's ``LiderConfig`` fields that this slice uses."""

    n_clusters: int = 1000  # c
    n_probe: int = 20  # c0
    n_arrays: int = 10  # H (in-cluster)
    n_arrays_centroid: int = 10  # H (centroids retriever)
    key_len: int | None = None  # M (in-cluster); None -> ceil(log2 Lp)
    key_len_centroid: int | None = None  # M (centroids); None -> ceil(log2 c)
    n_leaves: int = 5  # RMI width W_i
    n_leaves_centroid: int = 10  # RMI width W_c
    r0: int = 4  # expansion range factor, R = r0 * k
    r0_centroid: int = 4
    kmeans_iters: int = 20
    capacity: int | None = None  # Lp cap; None -> max cluster size (no drops)
    pad_multiple: int = 8
    refine: bool = False  # beyond-paper last-mile searchsorted correction
    # "float32", "bfloat16", "int8" or "int4"; the quantized dtypes add an
    # exact rescore of the provisional top-(rescore_factor * k).
    storage_dtype: str = "float32"
    rescore_factor: int = 4  # k' = rescore_factor * k (quantized storage only)
    # Where the float32 rescore table lives (quantized storage only):
    # "device" next to the codes, or "host" in host memory, fetched B*k'
    # rows at a time.
    rescore_tier: str = "device"
    # Cluster-major first pass (quantized banks only): queries probing the
    # same cluster share one read of its rows, block_q at a time.
    block_q: int | None = None
    # 1-bit sketch pre-filter (quantized banks only): keeps the top
    # sketch_factor * k' rows by Hamming distance ahead of the code pass.
    sketch_factor: int | None = None
    prune_margin: float | None = None
    allow_drops: bool = False


@dataclasses.dataclass(frozen=True)
class LiderParams:
    centroid_cm: CoreModelParams
    centroids: torch.Tensor  # (c, d)
    bank: ClusterBank

    @property
    def n_clusters(self) -> int:
        return self.bank.n_clusters

    @property
    def capacity(self) -> int:
        return self.bank.capacity

    @property
    def dim(self) -> int:
        return self.bank.dim

    @property
    def device(self) -> torch.device:
        return self.centroids.device

    def to(self, device) -> "LiderParams":
        return map_tensors(lambda t: t.to(device), self)


# ---------------------------------------------------------------------------
# Build (paper Sec. 3.3.2: Stage 1 clustering, Stage 2 CR, Stage 3 IRs)
# ---------------------------------------------------------------------------


def padded_capacity(max_size: int, cap: int | None, pad_multiple: int) -> int:
    """Slot count per cluster: requested (or max) size, padded."""
    cap = cap or max_size
    return max(pad_multiple, math.ceil(cap / pad_multiple) * pad_multiple)


def assign_points(
    generator: torch.Generator,
    embs: torch.Tensor,
    config: LiderConfig,
    *,
    centroids: torch.Tensor | None = None,
) -> clustering.KMeansResult:
    """Stage 1: k-means, or nearest-centroid against given centroids."""
    if centroids is None:
        return clustering.kmeans(
            generator, embs, config.n_clusters, iters=config.kmeans_iters
        )
    assignment, _ = clustering.assign_chunked(embs, centroids)
    return clustering.KMeansResult(centroids=centroids, assignment=assignment)


@dataclasses.dataclass(frozen=True)
class BuildStats:
    """Host-side accounting for one offline build."""

    n_indexed: int  # passages that got a slot
    n_dropped: int  # capacity-overflow drops (0 unless allow_drops=True)
    capacity: int  # padded per-cluster slot count Lp


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def build_lider(
    seed: int,
    embs,
    config: LiderConfig,
    *,
    centroids=None,
    return_stats: bool = False,
    device: str | torch.device | None = None,
) -> LiderParams | tuple[LiderParams, BuildStats]:
    """Build the two-layer index over ``embs`` (N, d) on ``device``.

    ``device=None`` means the CUDA device, and raises when there is none;
    pass ``device="cpu"`` for the CPU. ``seed`` seeds three generators on
    that device: k-means init, the centroid LSH and the in-cluster LSH.

    A corpus in host memory (a numpy array, a CPU tensor) given to a build
    on the card stays there: Stage 1 runs on a copy of it on the card,
    freed before the pack, which gathers each chunk of clusters' rows on
    the host (``bank.pack_bank``), so the corpus and the bank's tables are
    never on the card together. The index is the same.
    """
    device = resolve_device(device)
    embs = torch.as_tensor(embs)
    embs = embs.to(torch.float32) if embs.device.type == "cpu" else embs.to(device, torch.float32)
    if centroids is not None:
        centroids = torch.as_tensor(centroids, dtype=torch.float32, device=device)
    n, _ = embs.shape
    c = config.n_clusters

    km = assign_points(_generator(device, seed), bank_lib.to_device(embs, device), config,
                       centroids=centroids)
    sizes = torch.bincount(km.assignment.to(torch.int64), minlength=c)
    cap = padded_capacity(int(sizes.max()), config.capacity, config.pad_multiple)

    bank, n_dropped = bank_lib.build_bank(
        _generator(device, seed + 2),
        embs,
        km.assignment,
        n_clusters=c,
        capacity=cap,
        n_arrays=config.n_arrays,
        key_len=config.key_len or lsh_lib.suggest_key_len(cap),
        n_leaves=config.n_leaves,
        allow_drops=config.allow_drops,
        storage_dtype=config.storage_dtype,
        rescore_tier=config.rescore_tier,
    )
    centroid_cm = build_core_model(
        _generator(device, seed + 1),
        km.centroids,
        n_arrays=config.n_arrays_centroid,
        key_len=config.key_len_centroid or lsh_lib.suggest_key_len(c),
        n_leaves=config.n_leaves_centroid,
    )
    params = LiderParams(centroid_cm=centroid_cm, centroids=km.centroids, bank=bank)
    if return_stats:
        return params, BuildStats(n_indexed=n - n_dropped, n_dropped=n_dropped, capacity=cap)
    return params


# ---------------------------------------------------------------------------
# Search
# ---------------------------------------------------------------------------


def prune_probes(
    cids: torch.Tensor, scores: torch.Tensor, prune_margin: float | None
) -> torch.Tensor:
    """Mask probes whose centroid score is more than ``prune_margin`` below
    the per-query best to -1. ``None`` returns ``cids`` untouched."""
    if prune_margin is None:
        return cids
    valid = cids >= 0
    best = torch.where(valid, scores, float("-inf")).max(dim=-1, keepdim=True).values
    keep = scores >= best - prune_margin
    return torch.where(valid & keep, cids, -1)


def route_queries(
    params: LiderParams,
    queries: torch.Tensor,
    *,
    n_probe: int,
    r0: int = 4,
    prune_margin: float | None = None,
) -> TopK:
    """Layer 1: centroids retriever -> (B, n_probe) cluster ids + scores."""
    routed = search_core_model(
        params.centroid_cm, params.centroids, queries, k=n_probe, r0=r0
    )
    if prune_margin is None:
        return routed
    cids = prune_probes(routed.ids, routed.scores, prune_margin)
    return TopK(ids=cids, scores=torch.where(cids >= 0, routed.scores, float("-inf")))


def set_rescore_tier(params: LiderParams, tier: str) -> LiderParams:
    """Move the index's float32 rescore table between tiers
    (``bank.set_rescore_tier``); search results are bit-identical across
    the move, only which search pipeline runs changes."""
    return dataclasses.replace(params, bank=bank_lib.set_rescore_tier(params.bank, tier))


def _bank_candidates(
    bank: ClusterBank,
    queries: torch.Tensor,
    cids: torch.Tensor,
    *,
    k: int,
    r0: int,
    refine: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Candidate generation over the probed clusters (hash -> rescale -> RMI
    -> window). Returns ``(flat_emb, gids)``, both (B, P, H, R): flat
    ``(cluster, slot)`` rows of the ``(c*Lp, d)`` table and the matching
    global ids (-1 at dead/invalid candidates)."""
    c, h, lp = bank.sorted_keys.shape
    b, p = cids.shape
    r = min(r0 * k, lp)
    dev = queries.device

    qkeys = lsh_lib.hash_vectors(bank.lsh, queries)  # (B, H)
    safe_cid = torch.clamp(cids.to(torch.int64), 0, c - 1)
    cvalid = cids >= 0

    scaled = rescale_lib.rescale(bank.rescale.take(safe_cid), qkeys[:, None, :])
    pos = rmi_lib.predict_banked(bank.rmi.take(safe_cid), scaled)  # (B, P, H)

    h_idx = torch.arange(h, device=dev)[None, None, :, None]
    base = (safe_cid[:, :, None, None] * h + h_idx) * lp  # (B, P, H, 1)
    if refine:
        # Gather a 2R key window around the RMI prediction and binary-search
        # the exact position inside it.
        w1 = min(2 * r, lp)
        start1 = torch.clamp(torch.round(pos).to(torch.int64) - w1 // 2, 0, lp - w1)
        idx1 = start1[..., None] + torch.arange(w1, device=dev)
        keys_win = bank.sorted_keys.reshape(-1)[base + idx1]  # (B, P, H, W1)
        qk = qkeys[:, None, :].expand(b, p, h).reshape(-1, 1)
        off = torch.searchsorted(keys_win.reshape(-1, w1), qk).reshape(b, p, h)
        pos = (start1 + off).to(torch.float32)

    start = torch.clamp(torch.round(pos).to(torch.int64) - r // 2, 0, lp - r)
    idx = start[..., None] + torch.arange(r, device=dev)  # (B, P, H, R)
    local_pos = bank.sorted_pos.reshape(-1)[base + idx]

    valid = (local_pos >= 0) & cvalid[:, :, None, None]
    flat_emb = safe_cid[:, :, None, None] * lp + torch.clamp(local_pos.to(torch.int64), min=0)
    gids = torch.where(valid, bank.gids.reshape(-1)[flat_emb], -1)
    return flat_emb.to(torch.int32), gids.to(torch.int32)


def _provisional_topk(
    bank: ClusterBank,
    flat_rows: torch.Tensor,
    out_rows: torch.Tensor,
    queries: torch.Tensor,
    *,
    kp: int,
    sketch_factor: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The first pass over a quantized bank: ``(Bq, C)`` flat rows, deduped
    and reported by flat row (``out_rows``, -1 where invalid) -> the
    provisional top-``kp`` ``(rows, code-domain scores)``.

    With ``sketch_factor`` the 1-bit pass keeps the top ``sketch_factor *
    kp`` rows first, and only those reach the code pass. A factor that
    covers every distinct candidate changes nothing, bit for bit.
    """
    c, lp = bank.gids.shape
    if sketch_factor is not None and bank.sketches is not None:
        m = min(max(sketch_factor, 1) * kp, out_rows.shape[-1])
        surv, _ = sketch_topk_op(
            bank.sketches.reshape(c * lp, -1), flat_rows, queries, k=m, out_ids=out_rows
        )
        flat_rows = torch.clamp(surv, min=0)
        out_rows = surv
    return verify_topk_op(
        bank.embs.reshape(c * lp, -1),
        flat_rows,
        queries,
        k=kp,
        out_ids=out_rows,
        scales=bank.emb_scales.reshape(-1),
        code_dtype=bank.code_dtype,
    )


@query_path_entry(inputs=("prov_rows", "queries"))
def _rescore_provisional(
    gids: torch.Tensor,
    rescore_embs: torch.Tensor,
    prov_rows: torch.Tensor,
    queries: torch.Tensor,
    *,
    k: int,
) -> TopK:
    """Exact rescore of a provisional top-k' (flat rows, -1 padding) from
    the float32 table, deduped by flat row; rows map to global ids."""
    rows, scores = verify_topk_op(
        rescore_embs.reshape(-1, rescore_embs.shape[-1]),
        torch.clamp(prov_rows, min=0),
        queries,
        k=k,
        out_ids=prov_rows,
    )
    return TopK(ids=_row_gids(gids, rows), scores=scores)


def _verify_bank_rows(
    bank: ClusterBank,
    flat_rows: torch.Tensor,
    out_gids: torch.Tensor,
    queries: torch.Tensor,
    *,
    k: int,
    rescore_factor: int = 4,
    sketch_factor: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Verify ``(Bq, C)`` flat bank rows -> gid-space top-k ids + scores.

    A float bank: one ``verify_topk_op`` over the flat ``(c*Lp, d)`` table,
    deduped by global id. A quantized bank: the first pass
    (:func:`_provisional_topk`, deduped by flat row) keeps the top
    ``k' = rescore_factor * k``, then the exact rescore. Score ties between
    distinct passages break by the smallest flat row on the quantized path
    (by the smallest gid on the float path), as in the JAX package.
    """
    c, lp = bank.gids.shape
    if not bank.quantized:
        return verify_topk_op(
            bank.embs.reshape(c * lp, -1), flat_rows, queries, k=k, out_ids=out_gids
        )
    out_rows = torch.where(out_gids >= 0, flat_rows, -1)
    kp = min(max(rescore_factor, 1) * k, out_rows.shape[-1])
    prov_rows, _ = _provisional_topk(
        bank, flat_rows, out_rows, queries, kp=kp, sketch_factor=sketch_factor
    )
    # The body alone, as the JAX package inlines this stage here.
    obs.mark("rescore", queries)
    out = _rescore_provisional.__wrapped__(bank.gids, bank.rescore_embs, prov_rows, queries, k=k)
    return out.ids, out.scores


def incluster_search(
    params: LiderParams,
    queries: torch.Tensor,
    cids: torch.Tensor,
    *,
    k: int,
    r0: int = 4,
    refine: bool = False,
    merge: bool = True,
    cid_scores: torch.Tensor | None = None,
    prune_margin: float | None = None,
    rescore_factor: int = 4,
    sketch_factor: int | None = None,
) -> TopK:
    """Layer 2: search the probed clusters for each query.

    ``queries``: (B, d); ``cids``: (B, P) cluster ids (-1 = unused probe).
    ``merge=False`` returns the per-(query, probe) top-k, (B, P, k).
    """
    if prune_margin is not None:
        if cid_scores is None:
            raise ValueError("prune_margin needs cid_scores (layer-1 scores)")
        cids = prune_probes(cids, cid_scores, prune_margin)
    bank = params.bank
    if bank.rescore_tier == "host":
        raise ValueError(
            "incluster_search cannot complete on a host-tier bank: the rescore "
            "table is off the device; use search_lider (the staged fetch -> "
            "rescore search) or provisional_rows + rescore_fetched_rows"
        )
    b, p = cids.shape
    obs.mark("candidates", queries)
    flat_emb, gids = _bank_candidates(bank, queries, cids, k=k, r0=r0, refine=refine)
    kw = dict(k=k, rescore_factor=rescore_factor, sketch_factor=sketch_factor)
    obs.mark("verify", queries)
    if merge:
        ids, sc = _verify_bank_rows(
            bank, flat_emb.reshape(b, -1), gids.reshape(b, -1), queries, **kw
        )
        return TopK(ids=ids, scores=sc)
    pair_q = queries[:, None, :].expand(b, p, queries.shape[-1]).reshape(b * p, -1)
    ids, sc = _verify_bank_rows(
        bank, flat_emb.reshape(b * p, -1), gids.reshape(b * p, -1), pair_q, **kw
    )
    return TopK(ids=ids.reshape(b, p, k), scores=sc.reshape(b, p, k))


@query_path_entry(inputs=("queries",), traced=("prune_margin",))
def _search_lider_device(
    params: LiderParams,
    queries: torch.Tensor,
    *,
    k: int,
    n_probe: int = 20,
    r0: int = 4,
    r0_centroid: int = 4,
    refine: bool = False,
    prune_margin: float | None = None,
    with_stats: bool = False,
    rescore_factor: int = 4,
    sketch_factor: int | None = None,
) -> TopK | tuple[TopK, torch.Tensor]:
    """Search of a device-tier bank with the per-query schedule. With
    tracing on, stage marks (``obs.mark``) open the route, candidates,
    verify and (quantized banks) rescore stages, and close the search."""
    obs.mark("route", queries)
    cids, pruned = _route_pruned(
        params, queries, n_probe=n_probe, r0_centroid=r0_centroid, prune_margin=prune_margin
    )
    out = incluster_search(
        params, queries, cids, k=k, r0=r0, refine=refine,
        rescore_factor=rescore_factor, sketch_factor=sketch_factor,
    )
    obs.mark("end", queries)
    return (out, pruned) if with_stats else out


# ---------------------------------------------------------------------------
# Tiered search (host-resident rescore table): three explicit stages
# ---------------------------------------------------------------------------


def provisional_rows(
    params: LiderParams,
    queries: torch.Tensor,
    cids: torch.Tensor,
    *,
    k: int,
    r0: int = 4,
    refine: bool = False,
    merge: bool = True,
    rescore_factor: int = 4,
    sketch_factor: int | None = None,
) -> TopK:
    """Stage 1 of the tiered search: the first pass over the codes only.

    The same candidates and first pass as the device tier's quantized
    search, stopped at the provisional top-``k' = rescore_factor * k``:
    ``ids`` are flat bank rows (-1 padding) and ``scores`` code-domain
    scores. ``merge=False`` keeps the (B, P, k') per-(query, probe) shape.
    """
    bank = params.bank
    if not bank.quantized:
        raise ValueError("provisional_rows needs a quantized (int8/int4) bank")
    b, p = cids.shape
    flat_emb, gids = _bank_candidates(bank, queries, cids, k=k, r0=r0, refine=refine)
    if merge:
        fr, og, q = flat_emb.reshape(b, -1), gids.reshape(b, -1), queries
    else:
        fr, og = flat_emb.reshape(b * p, -1), gids.reshape(b * p, -1)
        q = queries[:, None, :].expand(b, p, queries.shape[-1]).reshape(b * p, -1)
    out_rows = torch.where(og >= 0, fr, -1)
    kp = min(max(rescore_factor, 1) * k, fr.shape[-1])
    rows, sc = _provisional_topk(bank, fr, out_rows, q, kp=kp, sketch_factor=sketch_factor)
    if not merge:
        return TopK(ids=rows.reshape(b, p, kp), scores=sc.reshape(b, p, kp))
    return TopK(ids=rows, scores=sc)


def rescore_fetched_rows(
    fetched: torch.Tensor, out_ids: torch.Tensor, queries: torch.Tensor, *, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage 3 of the tiered search: the exact rescore over fetched rows.

    ``fetched``: (B, k', d) float32 rows, on the device of ``queries``;
    ``out_ids``: (B, k') the ids to dedup and report by (flat bank rows).
    The same ``verify_topk_op`` as the device tier's rescore, with the
    fetched block as its table and ``arange`` row ids, so scores and
    tie-breaks are bit-identical to scoring the resident table.
    """
    b, kp, d = fetched.shape
    row_ids = torch.arange(b * kp, dtype=torch.int32, device=fetched.device).reshape(b, kp)
    return verify_topk_op(fetched.reshape(b * kp, d), row_ids, queries, k=k, out_ids=out_ids)


@query_path_entry(inputs=("queries",), traced=("prune_margin",))
def host_first_pass(
    params: LiderParams,
    queries: torch.Tensor,
    *,
    k: int,
    n_probe: int = 20,
    r0: int = 4,
    r0_centroid: int = 4,
    refine: bool = False,
    prune_margin: float | None = None,
    rescore_factor: int = 4,
    sketch_factor: int | None = None,
) -> tuple[TopK, torch.Tensor]:
    """Route, prune, then :func:`provisional_rows` -> ``(prov, pruned (B,
    P))``, ``prov`` the provisional top-k' (flat rows, code-domain scores).
    Nothing here waits for the device, so a caller can fetch an earlier
    batch's rows while this one runs (the serving engine's pipeline)."""
    cids, pruned = _route_pruned(
        params, queries, n_probe=n_probe, r0_centroid=r0_centroid, prune_margin=prune_margin
    )
    prov = provisional_rows(
        params, queries, cids, k=k, r0=r0, refine=refine,
        rescore_factor=rescore_factor, sketch_factor=sketch_factor,
    )
    return prov, pruned


def host_fetch(params: LiderParams, prov_rows, *, out: torch.Tensor | None = None) -> torch.Tensor:
    """Stage 2 of the tiered search: gather the provisional rows' float32
    rows from the host store, into ``out`` (a CPU buffer) when given. Rows
    on the card are copied to the host first, which waits for them."""
    return params.bank.store.fetch(prov_rows, out=out)


@query_path_entry(inputs=("fetched", "prov_rows", "queries"))
def host_rescore(
    gids: torch.Tensor,
    fetched: torch.Tensor,
    prov_rows: torch.Tensor,
    queries: torch.Tensor,
    *,
    k: int,
) -> TopK:
    """Stage 3: :func:`rescore_fetched_rows` (``fetched`` moved to the
    queries' device if it is not there), deduped by flat row as on the
    device tier, then rows mapped to global ids through ``gids``.

    On the card ``fetched`` is copied into the graph's static buffer (from
    the host, the copy to the card itself), unless it is a buffer registered
    with ``graphs.persistent`` (the serving engine's staging buffers), which
    the graph reads where it lies."""
    rows, scores = rescore_fetched_rows(fetched.to(queries.device), prov_rows, queries, k=k)
    return TopK(ids=_row_gids(gids, rows), scores=scores)


@query_path_entry(inputs=("prov",))
def compressed_only_topk(gids: torch.Tensor, prov: TopK, *, k: int) -> TopK:
    """The degraded answer from stage 1 alone (no fetch, no rescore): the
    provisional top-k' is sorted and deduped by flat row already, so its
    first ``k`` entries, mapped to global ids, are the int8/int4 first
    pass's answer."""
    return TopK(ids=_row_gids(gids, prov.ids[..., :k]), scores=prov.scores[..., :k])


def _row_gids(gids: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Flat bank rows -> global ids (-1 stays -1)."""
    flat = gids.reshape(-1)[torch.clamp(rows, min=0).to(torch.int64)]
    return torch.where(rows >= 0, flat, -1).to(torch.int32)


# ---------------------------------------------------------------------------
# Cluster-major multi-query search
# ---------------------------------------------------------------------------


@query_path_entry(inputs=("queries",), traced=("prune_margin",))
def _route_pruned(
    params: LiderParams,
    queries: torch.Tensor,
    *,
    n_probe: int,
    r0_centroid: int = 4,
    prune_margin: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Layer-1 routing + margin prune -> ``(cids (B, P), pruned (B, P))``,
    the mask of probes that were routed but pruned."""
    routed = route_queries(params, queries, n_probe=n_probe, r0=r0_centroid)
    cids = prune_probes(routed.ids, routed.scores, prune_margin)
    return cids, (routed.ids >= 0) & (cids < 0)


def _scatter_slot_ids(tgt: torch.Tensor, src: torch.Tensor, size: int) -> torch.Tensor:
    """``size`` int32 slots of -1 with ``src`` written at ``tgt``; targets
    equal to ``size`` (out of range) land in one spare slot that is cut off,
    as JAX's ``.at[tgt].set(mode="drop")`` drops them."""
    flat = torch.full((size + 1,), -1, dtype=torch.int32, device=src.device)
    flat[tgt.reshape(-1)] = src.reshape(-1).to(torch.int32)
    return flat[:size]


@query_path_entry(
    inputs=("queries", "cids", "sched_cids", "sched_qids", "pair_step", "pair_slot")
)
def _cluster_major_first_pass(
    params: LiderParams,
    queries: torch.Tensor,
    cids: torch.Tensor,
    sched_cids: torch.Tensor,
    sched_qids: torch.Tensor,
    pair_step: torch.Tensor,
    pair_slot: torch.Tensor,
    *,
    k: int,
    r0: int = 4,
    refine: bool = False,
    rescore_factor: int = 4,
    block_q: int = 8,
    sketch_factor: int | None = None,
) -> TopK:
    """The first pass on the cluster-major schedule -> the provisional
    top-k' (flat rows, code-domain scores), bit-identical to the per-query
    first pass.

    The (B, P, H, R) candidate windows of ``_bank_candidates`` are
    scattered into the dense per-(step, slot) masks over the step
    cluster's Lp rows (``step_slot_ids``; duplicates collapse), the grouped
    kernel keeps each pair's per-cluster top-k', and a dedup merge of each
    query's pairs gives its provisional top-k'. Every global top-k' winner
    from a cluster is inside its pair's per-cluster top-k', and flat rows
    are unique across clusters, so the merge equals the per-query pass.
    """
    bank = params.bank
    b, p = cids.shape
    c, lp = bank.gids.shape
    flat_emb, gids = _bank_candidates(bank, queries, cids, k=k, r0=r0, refine=refine)
    flat_emb = flat_emb.to(torch.int64)
    out_rows = torch.where(gids >= 0, flat_emb, -1)  # (B, P, H, R)
    s_steps = sched_cids.shape[0]
    n_cand = p * flat_emb.shape[2] * flat_emb.shape[3]
    kp = min(max(rescore_factor, 1) * k, n_cand)
    size = s_steps * block_q * lp

    if sketch_factor is not None and bank.sketches is not None:
        # The per-query Hamming pass over the same merged candidate list as
        # the per-query path selects the same survivors; each survivor maps
        # to its (query, probe) pair by its cluster (probe lists hold
        # distinct clusters), and from there to the pair's (step, slot).
        m = min(max(sketch_factor, 1) * kp, n_cand)
        surv, _ = sketch_topk_op(
            bank.sketches.reshape(c * lp, -1), flat_emb.reshape(b, -1), queries,
            k=m, out_ids=out_rows.reshape(b, -1),
        )
        surv = surv.to(torch.int64)
        surv_cid = torch.div(surv, lp, rounding_mode="floor")  # (B, m)
        match = (cids[:, None, :].to(torch.int64) == surv_cid[:, :, None]) & (
            surv[:, :, None] >= 0
        )  # (B, m, P)
        has = match.any(dim=-1)
        pidx = torch.argmax(match.to(torch.uint8), dim=-1)  # the first match
        brow = torch.arange(b, device=surv.device)[:, None]
        st_s = torch.where(has, pair_step[brow, pidx].to(torch.int64), -1)
        sl_s = torch.clamp(pair_slot[brow, pidx].to(torch.int64), min=0)
        valid_s = has & (st_s >= 0)
        tgt = torch.where(valid_s, (st_s * block_q + sl_s) * lp + surv % lp, size)
        src = surv
    else:
        st = pair_step.to(torch.int64)[:, :, None, None]
        sl = pair_slot.to(torch.int64)[:, :, None, None]
        valid = (out_rows >= 0) & (st >= 0)
        tgt = torch.where(valid, (st * block_q + sl) * lp + flat_emb % lp, size)
        src = out_rows
    step_slot_ids = _scatter_slot_ids(tgt, src, size).reshape(s_steps, block_q, lp)

    kp_pair = min(kp, lp)  # a pair has at most Lp distinct rows
    ids_g, sc_g = verify_topk_grouped_op(
        bank.embs, bank.emb_scales, queries, sched_cids, sched_qids, step_slot_ids,
        kp=kp_pair, code_dtype=bank.code_dtype,
    )

    # Gather each query's pairs' per-cluster top-k' and merge; dead pairs
    # (pruned probes) contribute (-1, -inf).
    safe_st = torch.clamp(pair_step.to(torch.int64), min=0)
    safe_sl = torch.clamp(pair_slot.to(torch.int64), min=0)
    dead = (pair_step < 0)[..., None]
    pids = torch.where(dead, -1, ids_g[safe_st, safe_sl])  # (B, P, kp_pair)
    psc = torch.where(dead, float("-inf"), sc_g[safe_st, safe_sl])
    prov_rows, prov_sc = dedup_topk(pids.reshape(b, -1), psc.reshape(b, -1), kp)
    return TopK(ids=prov_rows, scores=prov_sc)


def host_first_pass_cluster_major(
    params: LiderParams,
    queries: torch.Tensor,
    *,
    k: int,
    n_probe: int = 20,
    r0: int = 4,
    r0_centroid: int = 4,
    refine: bool = False,
    prune_margin: float | None = None,
    rescore_factor: int = 4,
    block_q: int = 8,
    sketch_factor: int | None = None,
    stats_out: dict | None = None,
) -> tuple[TopK, torch.Tensor]:
    """Route, build the schedule on the host, then the cluster-major first
    pass -> ``(provisional top-k', pruned (B, P))``.

    ``stats_out``, when given, receives the schedule's ``n_pairs``,
    ``n_steps`` and the per-cluster pair counts, and the schedule is then
    padded to the fixed worst case ``_pad_pow2(B * n_probe)`` steps, so
    every batch of one (B, block_q) has one kernel shape (padding steps are
    empty; results are unchanged).
    """
    cids, pruned = _route_pruned(
        params, queries, n_probe=n_probe, r0_centroid=r0_centroid, prune_margin=prune_margin
    )
    pad_to = None if stats_out is None else _pad_pow2(queries.shape[0] * n_probe)
    cids_np = cids.cpu().numpy()
    sched = build_cluster_schedule(cids_np, block_q=block_q, pad_to=pad_to)
    if stats_out is not None:
        stats_out["n_pairs"] = sched.n_pairs
        stats_out["n_steps"] = sched.n_steps
        stats_out["cluster_counts"] = np.unique(cids_np[cids_np >= 0], return_counts=True)[1]
    dev = queries.device
    prov = _cluster_major_first_pass(
        params, queries, cids,
        *(torch.from_numpy(a).to(dev) for a in (
            sched.sched_cids, sched.sched_qids, sched.pair_step, sched.pair_slot
        )),
        k=k, r0=r0, refine=refine, rescore_factor=rescore_factor,
        block_q=block_q, sketch_factor=sketch_factor,
    )
    return prov, pruned


def _search_lider_cluster_major(
    params: LiderParams,
    queries: torch.Tensor,
    *,
    k: int,
    n_probe: int,
    r0: int,
    r0_centroid: int,
    refine: bool,
    prune_margin: float | None,
    with_stats: bool,
    rescore_factor: int,
    block_q: int,
    sketch_factor: int | None = None,
) -> TopK | tuple[TopK, torch.Tensor]:
    """Route -> host schedule -> grouped first pass -> exact rescore, from
    the resident table or, on the host tier, from the fetched rows."""
    bank = params.bank
    if not bank.quantized:
        raise ValueError(
            "block_q (cluster-major schedule) requires a quantized (int8/int4) "
            "bank; use the per-query schedule (block_q=None) for float banks"
        )
    prov, pruned = host_first_pass_cluster_major(
        params, queries, k=k, n_probe=n_probe, r0=r0, r0_centroid=r0_centroid,
        refine=refine, prune_margin=prune_margin, rescore_factor=rescore_factor,
        block_q=block_q, sketch_factor=sketch_factor,
    )
    if bank.rescore_tier == "host":
        out = host_rescore(bank.gids, host_fetch(params, prov.ids), prov.ids, queries, k=k)
    else:
        out = _rescore_provisional(bank.gids, bank.rescore_embs, prov.ids, queries, k=k)
    return (out, pruned) if with_stats else out


def search_lider(
    params: LiderParams,
    queries,
    *,
    k: int,
    n_probe: int = 20,
    r0: int = 4,
    r0_centroid: int = 4,
    refine: bool = False,
    prune_margin: float | None = None,
    with_stats: bool = False,
    rescore_factor: int = 4,
    block_q: int | None = None,
    sketch_factor: int | None = None,
) -> TopK | tuple[TopK, torch.Tensor]:
    """End-to-end LIDER ANN search (paper Sec. 3.3.2), on the index's device.

    ``queries`` (B, d) move to the device the index lives on. With
    ``with_stats=True`` also returns the (B, n_probe) mask of probes that
    were routed but pruned by ``prune_margin``.

    On a quantized bank the first pass scores codes and the provisional
    top-``rescore_factor * k`` is rescored exactly. ``sketch_factor`` adds
    the 1-bit pre-filter (a no-op on a float bank, which has no sketches);
    ``block_q`` switches the first pass to the cluster-major schedule
    (quantized banks only: ``ValueError`` on a float bank). Both give the
    same ids and scores as the plain quantized search, bit for bit, when
    the sketch factor covers every candidate; ``block_q`` always does.

    On a host-tier bank the search runs as three stages (first pass on the
    card, host gather of the ``B * k'`` provisional rows, rescore of the
    fetched block) and returns the device tier's ids and scores, bit for
    bit.
    """
    queries = torch.as_tensor(queries, dtype=torch.float32, device=params.device)
    kw = dict(
        k=k, n_probe=n_probe, r0=r0, r0_centroid=r0_centroid, refine=refine,
        prune_margin=prune_margin, with_stats=with_stats,
        rescore_factor=rescore_factor, sketch_factor=sketch_factor,
    )
    if block_q is not None:
        return _search_lider_cluster_major(params, queries, block_q=block_q, **kw)
    if params.bank.rescore_tier == "host":
        with_stats = kw.pop("with_stats")
        prov, pruned = host_first_pass(params, queries, **kw)
        out = host_rescore(params.bank.gids, host_fetch(params, prov.ids), prov.ids, queries, k=k)
        return (out, pruned) if with_stats else out
    return _search_lider_device(params, queries, **kw)


# Every entry of the serving query path (all tiers and the degraded answer),
# as the JAX package's ``_QUERY_PATH_JITS``.
_QUERY_PATH_GRAPHS = (
    "_search_lider_device",
    "host_first_pass",
    "host_rescore",
    "compressed_only_topk",
    "_route_pruned",
    "_cluster_major_first_pass",
    "_rescore_provisional",
)


def query_path_cache_size() -> int:
    """The distinct signatures (shapes and dtypes of the tensors, static
    options, device) held across the seven query-path entries, as the JAX
    package's ``query_path_cache_size`` sums ``jax.jit``'s cache sizes.
    After ``RetrievalEngine.warmup()`` it stays flat across any mix of batch
    sizes and ladder rungs: a new signature means a query paid for a first
    run and a capture. A capture on new leaves of known shapes (an update,
    a replica) adds none."""
    return sum(globals()[name].cache_size() for name in _QUERY_PATH_GRAPHS)
