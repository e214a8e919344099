"""What the candidate-scoring baselines share: exact inner products of
gathered corpus rows, in query chunks so the gathered block stays small."""
from __future__ import annotations

import numpy as np
import torch

from ..utils import NEG_INF

# Floats of gathered rows held at once (512 MiB of float32).
_GATHER_FLOATS = 1 << 27


def score_candidates(embs: torch.Tensor, cand: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """(B, C) candidate ids (-1 = none) -> (B, C) float32 inner products
    with their query, -inf where the id is -1. Plain PyTorch: a gather and
    a batched product, a chunk of queries at a time."""
    b, c = cand.shape
    d = embs.shape[1]
    out = torch.empty((b, c), dtype=torch.float32, device=embs.device)
    step = max(1, _GATHER_FLOATS // max(c * d, 1))
    for s in range(0, b, step):
        ids = cand[s : s + step]
        rows = embs[torch.clamp(ids, min=0).to(torch.int64)]  # (b', C, d)
        sc = torch.bmm(rows, queries[s : s + step, :, None])[..., 0]
        out[s : s + step] = torch.where(ids < 0, NEG_INF, sc)
    return out


def leaf(leaves: dict, name: str, device, dtype=None) -> torch.Tensor:
    """One numpy leaf of a JAX-built index as a tensor on ``device``
    (uint32 keys widen to int64, as the port holds them)."""
    arr = np.asarray(leaves[name])
    if arr.dtype == np.uint32:
        arr = arr.astype(np.int64)
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    return t if dtype is None else t.to(dtype)
