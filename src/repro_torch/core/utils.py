"""Shared numeric helpers: masked top-k with duplicate suppression, recall."""
from __future__ import annotations

import numpy as np
import torch

NEG_INF = float("-inf")


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Row-normalise so inner product == cosine similarity (paper Sec. 7.1.1)."""
    n = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    return x / torch.clamp(n, min=eps)


def stable_topk(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top ``k`` of the last axis -> ``(values, indices)``, values
    descending and equal values in index order: the order of
    ``jax.lax.top_k``, which ``torch.topk`` does not promise. One
    ``torch.topk`` finds the k-th value; of the values equal to it, the
    first ones by index fill the k slots; a stable sort orders the k."""
    c = scores.shape[-1]
    k = min(k, c)
    kth = torch.topk(scores, k, dim=-1).values[..., -1:]
    above = scores > kth
    tied = scores == kth
    room = k - above.sum(dim=-1, keepdim=True)
    take = above | (tied & (torch.cumsum(tied.to(torch.int32), dim=-1) <= room))
    pos = torch.arange(c, device=scores.device).expand_as(scores)
    idx = torch.topk(torch.where(take, pos, c), k, dim=-1, largest=False, sorted=True).values
    vals = torch.gather(scores, -1, idx)
    vals, order = torch.sort(vals, dim=-1, descending=True, stable=True)
    return vals, torch.gather(idx, -1, order)


def dedup_topk(
    ids: torch.Tensor, scores: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last axis with duplicate/invalid candidates suppressed.

    ``ids``: (..., C) int candidate ids, -1 == invalid (padding).
    ``scores``: (..., C) float32; duplicates of one id carry equal scores.

    Returns ``(top_ids int32, top_scores float32)`` of shape (..., k), scores
    descending, ties between distinct ids going to the smallest id; slots
    past the number of unique valid candidates hold (-1, -inf).
    ``torch.topk`` promises no tie order, so the order is made explicit:
    a stable sort by id, then a stable descending sort by score.
    """
    ids = ids.to(torch.int64)
    sid, order = torch.sort(ids, dim=-1, stable=True)
    ssc = torch.gather(scores, -1, order)
    prev = torch.cat(
        [torch.full_like(sid[..., :1], -2), sid[..., :-1]], dim=-1
    )
    masked = torch.where((sid == prev) | (sid < 0), NEG_INF, ssc)
    kk = min(k, masked.shape[-1])
    sorted_sc, idx = torch.sort(masked, dim=-1, descending=True, stable=True)
    top_scores = sorted_sc[..., :kk]
    top_ids = torch.gather(sid, -1, idx[..., :kk])
    top_ids = torch.where(torch.isneginf(top_scores), -1, top_ids)
    if kk < k:  # fewer candidates than k: pad the tail
        pad = k - kk
        top_ids = torch.nn.functional.pad(top_ids, (0, pad), value=-1)
        top_scores = torch.nn.functional.pad(top_scores, (0, pad), value=NEG_INF)
    return top_ids.to(torch.int32), top_scores


def merge_topk(
    ids_list: torch.Tensor, scores_list: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge per-shard top-k lists (..., S, k) -> global (..., k)."""
    flat_ids = ids_list.reshape(*ids_list.shape[:-2], -1)
    flat_scores = scores_list.reshape(*scores_list.shape[:-2], -1)
    return dedup_topk(flat_ids, flat_scores, k)


def recall_at_k(pred_ids: torch.Tensor, true_ids: torch.Tensor) -> torch.Tensor:
    """Mean recall@k: |pred ∩ true| / |true| per row, averaged."""
    hits = (pred_ids[..., :, None] == true_ids[..., None, :]) & (
        true_ids[..., None, :] >= 0
    )
    per_row = hits.any(dim=-2).sum(dim=-1) / torch.clamp(
        (true_ids >= 0).sum(dim=-1), min=1
    )
    return per_row.to(torch.float32).mean()


def mrr_at_10(pred_ids, relevant) -> float:
    """Mean reciprocal rank of the known-relevant id within the top 10."""
    pred = np.asarray(pred_ids)[:, :10]
    rr = []
    for row, r in zip(pred, np.asarray(relevant)):
        pos = np.nonzero(row == r)[0]
        rr.append(1.0 / (pos[0] + 1) if len(pos) else 0.0)
    return float(np.mean(rr))
