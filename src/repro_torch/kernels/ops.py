"""Device dispatch for the kernels: a CPU tensor goes to the plain PyTorch
version, a CUDA tensor to the hand-written kernel. There is no flag and no
fall-back: a CUDA call the kernel refuses raises."""
from __future__ import annotations

import torch

from . import fused_verify as _fv
from . import ref


def verify_topk_op(
    embs: torch.Tensor,
    row_ids: torch.Tensor,
    queries: torch.Tensor,
    *,
    k: int,
    out_ids: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Candidate verification -> deduplicated top-k, (B, k) ids + scores.

    Same semantics on both paths: dedup by ``out_ids`` (< 0 == padding),
    scores descending, ties to the smallest id, (-1, -inf) fill. Float32
    and bfloat16 tables; the quantized (``scales``) form is the next slice.
    """
    if embs.device.type == "cpu":
        return ref.verify_topk_ref(embs, row_ids, queries, k=k, out_ids=out_ids)
    if embs.device.type != "cuda":
        raise ValueError(f"no verification kernel for device {embs.device}")
    row_ids = row_ids.to(torch.int32).contiguous()
    out_ids = row_ids if out_ids is None else out_ids.to(torch.int32).contiguous()
    return _fv.fused_verify(
        embs.contiguous(),
        row_ids,
        queries.to(torch.float32).contiguous(),
        k=k,
        out_ids=out_ids,
    )
