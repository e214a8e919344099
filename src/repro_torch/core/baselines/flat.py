"""Flat (exact brute-force) search — the quality upper bound and the ground
truth for recall. Chunked over the corpus with a running top-k merge; the
product per chunk is a plain ``torch.matmul``."""
from __future__ import annotations

import torch

from ..core_model import TopK


def flat_search(
    embs: torch.Tensor, queries: torch.Tensor, *, k: int, chunk: int = 65536
) -> TopK:
    n = embs.shape[0]
    b = queries.shape[0]
    queries = queries.to(device=embs.device, dtype=torch.float32)
    ids = torch.full((b, k), -1, dtype=torch.int64, device=embs.device)
    scores = torch.full((b, k), float("-inf"), device=embs.device)
    for s in range(0, n, chunk):
        sc = queries @ embs[s : s + chunk].T  # (B, chunk)
        top_s, top_i = torch.topk(sc, min(k, sc.shape[1]), dim=-1)
        all_s = torch.cat([scores, top_s], dim=-1)
        all_i = torch.cat([ids, top_i + s], dim=-1)
        scores, m = torch.topk(all_s, k, dim=-1)
        ids = torch.gather(all_i, -1, m)
    ids = torch.where(torch.isneginf(scores), -1, ids)
    return TopK(ids=ids.to(torch.int32), scores=scores)
