"""IVF-PQ (IVFADC, Jégou et al. 2011), paper baseline 5, the fastest one.

Coarse k-means into C inverted lists + PQ on the residuals. Lists are stored
capacity-padded like LIDER's clusters, so a probed search is a gather.
Score(x) = <q, centroid(x)> + ADC(<q, residual codes>).

The coarse k-means and the residual codebooks run ``kmeans_assign`` on the
card (``clustering.kmeans``, ``pq._encode``); the list scan is plain
PyTorch, as it is plain ``jnp`` in the JAX package, a chunk of queries at a
time so the gathered codes stay small.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .. import clustering
from ..core_model import TopK
from ..utils import NEG_INF, dedup_topk, stable_topk
from ._common import leaf
from .pq import PQParams, _encode, _train_codebooks, adc_lut

# Gathered (query, probe, slot, subspace) codes held at once.
_SCAN_CODES = 1 << 26


@dataclasses.dataclass(frozen=True)
class IVFPQParams:
    centroids: torch.Tensor  # (C, d)
    list_gids: torch.Tensor  # (C, Lp) int32, -1 pad
    list_codes: torch.Tensor  # (C, Lp, m) int32
    codebooks: torch.Tensor  # (m, n_codes, ds)
    n_lists: int
    n_subspaces: int
    n_codes: int

    @property
    def device(self) -> torch.device:
        return self.centroids.device


def build_ivfpq(
    generator: torch.Generator,
    embs: torch.Tensor,
    *,
    n_lists: int | None = None,
    n_subspaces: int = 8,
    bits: int = 8,
    kmeans_iters: int = 15,
    pad_multiple: int = 8,
) -> IVFPQParams:
    embs = embs.to(device=generator.device, dtype=torch.float32)
    n, _ = embs.shape
    c = n_lists or max(4, int(math.sqrt(n)))  # paper: C = sqrt(N)
    km = clustering.kmeans(generator, embs, c, iters=kmeans_iters)
    assign = km.assignment.to(torch.int64)
    residuals = embs - km.centroids[assign]
    codebooks = _train_codebooks(generator, residuals, n_subspaces, 2**bits, kmeans_iters)
    codes = _encode(codebooks, residuals)  # (N, m)
    cap = int(torch.bincount(assign, minlength=c).max())
    cap = max(pad_multiple, math.ceil(cap / pad_multiple) * pad_multiple)
    gids, _ = clustering.group_by_cluster(km.assignment, c, cap)
    list_codes = codes[torch.clamp(gids, min=0).to(torch.int64)] * (gids >= 0)[..., None]
    return IVFPQParams(
        centroids=km.centroids,
        list_gids=gids,
        list_codes=list_codes.to(torch.int32),
        codebooks=codebooks,
        n_lists=c,
        n_subspaces=n_subspaces,
        n_codes=2**bits,
    )


def params_from_numpy(leaves: dict, *, device) -> IVFPQParams:
    """The port's params from the numpy leaves of the JAX package's
    ``IVFPQParams``: ``centroids``, ``list_gids``, ``list_codes``,
    ``codebooks``."""
    centroids = leaf(leaves, "centroids", device, torch.float32)
    codebooks = leaf(leaves, "codebooks", device, torch.float32)
    return IVFPQParams(
        centroids=centroids,
        list_gids=leaf(leaves, "list_gids", device, torch.int32),
        list_codes=leaf(leaves, "list_codes", device, torch.int32),
        codebooks=codebooks,
        n_lists=centroids.shape[0],
        n_subspaces=codebooks.shape[0],
        n_codes=codebooks.shape[1],
    )


def ivfpq_search(params: IVFPQParams, queries: torch.Tensor, *, k: int, n_probe: int = 8) -> TopK:
    queries = queries.to(device=params.device, dtype=torch.float32)
    b = queries.shape[0]
    _, lp, m = params.list_codes.shape
    coarse = queries @ params.centroids.T  # (B, C) inner products
    c_scores, cids = stable_topk(coarse, n_probe)  # (B, p)
    lut = adc_lut(
        PQParams(codebooks=params.codebooks, codes=params.list_codes[:1, 0],
                 rotation=None, n_subspaces=params.n_subspaces, n_codes=params.n_codes),
        queries,
    )  # (B, m, n_codes)
    gids = params.list_gids[cids]  # (B, p, Lp)
    scores = torch.empty(gids.shape, dtype=torch.float32, device=queries.device)
    step = max(1, _SCAN_CODES // max(cids.shape[1] * lp * m, 1))
    for s in range(0, b, step):
        codes = params.list_codes[cids[s : s + step]].to(torch.int64)  # (b', p, Lp, m)
        lut_s = lut[s : s + step]
        flat = codes.reshape(codes.shape[0], -1, m)
        # scores[b, p, l] = sum_j lut[b, j, codes[b, p, l, j]], in subspace order.
        acc = torch.gather(lut_s[:, 0], 1, flat[..., 0])
        for j in range(1, m):
            acc += torch.gather(lut_s[:, j], 1, flat[..., j])
        scores[s : s + step] = acc.view(codes.shape[:3])
    scores = scores + c_scores[..., None]  # residual + coarse
    scores = torch.where(gids < 0, NEG_INF, scores)
    ids, sc = dedup_topk(gids.reshape(b, -1), scores.reshape(b, -1), k)
    return TopK(ids=ids, scores=sc)
