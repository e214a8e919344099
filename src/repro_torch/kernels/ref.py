"""Plain PyTorch versions of the kernels: the oracles the tests hold the
CUDA kernels against, and the path ``ops`` takes for CPU tensors."""
from __future__ import annotations

import torch

from ..core.utils import NEG_INF, dedup_topk


def verify_topk_ref(
    embs: torch.Tensor,
    row_ids: torch.Tensor,
    queries: torch.Tensor,
    *,
    k: int,
    out_ids: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Materialize-then-score verification, the oracle for ``fused_verify``.

    Gathers the (B, C, d) candidate tensor, scores it against the queries
    with float32 accumulation (a bfloat16 table scores against the query
    rounded to bfloat16, as the kernel does), masks ``out_ids < 0`` to -inf
    and keeps the deduplicated top-k by ``out_ids`` (default ``row_ids``).
    Row ids are clamped into the table, as a JAX gather clamps them.
    """
    if out_ids is None:
        out_ids = row_ids
    if embs.dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(
            f"{embs.dtype} table: quantized verification comes with the "
            "quantized bank, the next port slice"
        )
    safe = row_ids.to(torch.int64).clamp(0, embs.shape[0] - 1)
    cand = embs[safe].to(torch.float32)  # (B, C, d): the materialization
    q = queries.to(embs.dtype).to(torch.float32)
    scores = torch.bmm(cand, q[:, :, None])[..., 0]
    scores = torch.where(out_ids < 0, NEG_INF, scores)
    return dedup_topk(out_ids, scores, k)
