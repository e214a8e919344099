"""LIDER: the clustering-based two-layer learned index (paper Sec. 3).

Layer 1: a *centroids retriever* (one core model over the k-means centroids)
routes each query to ``n_probe`` clusters. Layer 2: the
:class:`~repro_torch.core.bank.ClusterBank`, the per-cluster retrievers
stacked into dense padded tensors, so a (query x probed-cluster) batch is
gathers plus one verification call.

Both verification calls of a search — the centroid table in routing and
the float bank in layer 2 — go through ``verify_topk_op``: the
``fused_verify`` CUDA kernel on the card, its plain version on the CPU.

This slice covers the float32/bfloat16 device-tier bank. ``search_lider``
raises ``NotImplementedError`` for what later slices bring: the quantized
bank (int8/int4 two-stage search), the sketch pre-filter, the host rescore
tier and the cluster-major ``block_q`` schedule.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from . import bank as bank_lib
from . import clustering, lsh as lsh_lib, rescale as rescale_lib, rmi as rmi_lib
from ..device import resolve_device
from ..kernels.ops import verify_topk_op
from .bank import ClusterBank
from .core_model import CoreModelParams, TopK, build_core_model, search_core_model
from .types import map_tensors


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
    storage_dtype: str = "float32"  # float32 / bfloat16 in this slice
    rescore_tier: str = "device"  # the host tier is a later slice
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
    """
    device = resolve_device(device)
    embs = torch.as_tensor(embs, dtype=torch.float32, device=device)
    if centroids is not None:
        centroids = torch.as_tensor(centroids, dtype=torch.float32, device=device)
    if config.storage_dtype not in ("float32", "bfloat16"):
        raise NotImplementedError(
            f"storage_dtype={config.storage_dtype!r}: the quantized bank is "
            "the next port slice"
        )
    n, _ = embs.shape
    c = config.n_clusters

    km = assign_points(_generator(device, seed), embs, config, centroids=centroids)
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


def _verify_bank_rows(
    bank: ClusterBank,
    flat_rows: torch.Tensor,
    out_gids: torch.Tensor,
    queries: torch.Tensor,
    *,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Verify ``(Bq, C)`` flat bank rows -> gid-space top-k ids + scores:
    one ``verify_topk_op`` over the flat ``(c*Lp, d)`` table, deduped by
    global id."""
    if bank.quantized:
        raise NotImplementedError(
            "two-stage verification of a quantized bank is the next port slice"
        )
    c, lp = bank.gids.shape
    return verify_topk_op(
        bank.embs.reshape(c * lp, -1), flat_rows, queries, k=k, out_ids=out_gids
    )


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
    b, p = cids.shape
    flat_emb, gids = _bank_candidates(bank, queries, cids, k=k, r0=r0, refine=refine)
    if merge:
        ids, sc = _verify_bank_rows(
            bank, flat_emb.reshape(b, -1), gids.reshape(b, -1), queries, k=k
        )
        return TopK(ids=ids, scores=sc)
    pair_q = queries[:, None, :].expand(b, p, queries.shape[-1]).reshape(b * p, -1)
    ids, sc = _verify_bank_rows(
        bank, flat_emb.reshape(b * p, -1), gids.reshape(b * p, -1), pair_q, k=k
    )
    return TopK(ids=ids.reshape(b, p, k), scores=sc.reshape(b, p, k))


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
) -> TopK | tuple[TopK, torch.Tensor]:
    """Search of a device-tier float bank: routing, then layer 2."""
    routed = route_queries(params, queries, n_probe=n_probe, r0=r0_centroid)
    cids = prune_probes(routed.ids, routed.scores, prune_margin)
    out = incluster_search(params, queries, cids, k=k, r0=r0, refine=refine)
    if with_stats:
        return out, (routed.ids >= 0) & (cids < 0)
    return out


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
    block_q: int | None = None,
    sketch_factor: int | None = None,
) -> TopK | tuple[TopK, torch.Tensor]:
    """End-to-end LIDER ANN search (paper Sec. 3.3.2), on the index's device.

    ``queries`` (B, d) move to the device the index lives on. With
    ``with_stats=True`` also returns the (B, n_probe) mask of probes that
    were routed but pruned by ``prune_margin``.
    """
    if block_q is not None:
        raise NotImplementedError(
            "block_q (the cluster-major schedule) is a later port slice"
        )
    if sketch_factor is not None:
        raise NotImplementedError("sketch_factor (the sketch tier) is a later port slice")
    if params.bank.rescore_tier == "host":
        raise NotImplementedError("the host rescore tier is a later port slice")
    if params.bank.quantized:
        raise NotImplementedError(
            "searching a quantized (int8/int4) bank is the next port slice"
        )
    queries = torch.as_tensor(queries, dtype=torch.float32, device=params.device)
    return _search_lider_device(
        params, queries, k=k, n_probe=n_probe, r0=r0, r0_centroid=r0_centroid,
        refine=refine, prune_margin=prune_margin, with_stats=with_stats,
    )
