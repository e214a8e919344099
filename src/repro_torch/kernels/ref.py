"""Plain PyTorch versions of the kernels: the oracles the tests hold the
CUDA kernels against, and the path ``ops`` takes for CPU tensors.

Quantized scores are exact integer dot products of the codes, computed as a
float product of the codes: exact while every partial sum stays below
2**24 in float32 (d * 127**2 < 2**24, so d <= 1040) and in float64 beyond
that. (``torch.bmm`` on int8 returns int8 and wraps; on CUDA it has no
integer form.) The combined scale is then folded in as
``float(int_dot) * (row_scale * q_scale)``, in that order, as the JAX
package does, so ids and scores are bit-exact against it.
"""
from __future__ import annotations

import torch

from ..core.utils import NEG_INF, dedup_topk
from . import quant

_F32_EXACT_DIM = (2**24) // (127 * 127)


def int_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact ``a @ b.mT`` of integer codes, ``(..., M, d) x (..., N, d) ->
    (..., M, N)`` float32 (the integer values, which fit float32 exactly
    for int8 codes at these widths)."""
    ft = torch.float32 if a.shape[-1] <= _F32_EXACT_DIM else torch.float64
    return torch.matmul(a.to(ft), b.to(ft).transpose(-1, -2)).to(torch.float32)


def verify_topk_ref(
    embs: torch.Tensor,
    row_ids: torch.Tensor,
    queries: torch.Tensor,
    *,
    k: int,
    out_ids: torch.Tensor | None = None,
    scales: torch.Tensor | None = None,
    code_dtype: str = "int8",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Materialize-then-score verification, the oracle for ``fused_verify``.

    Gathers the (B, C, d) candidate tensor, scores it against the queries
    with float32 accumulation (a bfloat16 table scores against the query
    rounded to bfloat16, as the kernel does), masks ``out_ids < 0`` to -inf
    and keeps the deduplicated top-k by ``out_ids`` (default ``row_ids``).
    Row ids are clamped into the table, as a JAX gather clamps them.

    With ``scales`` ((N,) f32) the table holds int8 codes (``code_dtype=
    "int4"``: packed int4, width d//2): queries are quantized with
    ``quant.quantize_rows`` and scored in the exact integer domain.
    """
    if out_ids is None:
        out_ids = row_ids
    safe = row_ids.to(torch.int64).clamp(0, embs.shape[0] - 1)
    if scales is not None:
        cand = embs[safe]  # (B, C, d_store): the materialization
        if code_dtype == "int4":
            cand = quant.unpack_int4(cand)
        q_codes, q_scales = quant.quantize_rows(queries)
        int_scores = int_dot(cand, q_codes[:, None, :])[..., 0]
        comb = scales[safe].to(torch.float32) * q_scales[:, None]
        scores = int_scores * comb
    elif embs.dtype in (torch.float32, torch.bfloat16):
        cand = embs[safe].to(torch.float32)  # (B, C, d): the materialization
        q = queries.to(embs.dtype).to(torch.float32)
        scores = torch.bmm(cand, q[:, :, None])[..., 0]
    else:
        raise ValueError(f"a {embs.dtype} table needs its row scales (scales=)")
    scores = torch.where(out_ids < 0, NEG_INF, scores)
    return dedup_topk(out_ids, scores, k)


def sketch_topk_ref(
    sketches: torch.Tensor,
    row_ids: torch.Tensor,
    queries: torch.Tensor,
    *,
    k: int,
    out_ids: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Hamming oracle for ``sketch_prefilter``: the score of a candidate is
    ``-(float) popcount(row_sketch XOR query_sketch)`` over its ceil(d/32)
    words (exact: Hamming <= d < 2**24), then the same dedup top-k."""
    if out_ids is None:
        out_ids = row_ids
    safe = row_ids.to(torch.int64).clamp(0, sketches.shape[0] - 1)
    cand = sketches[safe]  # (B, C, w) int32
    q_sk = quant.sketch_rows(queries)  # (B, w)
    ham = quant.popcount32(cand ^ q_sk[:, None, :]).sum(dim=-1)
    scores = torch.where(out_ids < 0, NEG_INF, -ham.to(torch.float32))
    return dedup_topk(out_ids, scores, k)


def verify_topk_grouped_ref(
    embs: torch.Tensor,
    row_scales: torch.Tensor,
    queries: torch.Tensor,
    sched_cids: torch.Tensor,
    sched_qids: torch.Tensor,
    step_slot_ids: torch.Tensor,
    *,
    kp: int,
    code_dtype: str = "int8",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Materialized oracle for ``fused_verify_grouped``.

    Gathers each step's whole cluster ``(S, Lp, d)``, scores it against the
    step's ``block_q`` query-code tile in the exact integer domain, folds
    in ``q_scale * row_scale``, masks non-candidates (``step_slot_ids <
    0``) and keeps a dedup top-``kp`` per (step, slot): ``(S, block_q, kp)``
    ids and scores. Pad slots (``sched_qids < 0``) take query scale 1.0.
    """
    c = embs.shape[0]
    s_steps, block_q, lp = step_slot_ids.shape
    safe_c = sched_cids.to(torch.int64).clamp(0, c - 1)
    rows = embs[safe_c]  # (S, Lp, d_store)
    if code_dtype == "int4":
        rows = quant.unpack_int4(rows)
    q_codes, q_scales = quant.quantize_rows(queries)
    safe_q = sched_qids.to(torch.int64).clamp(min=0)
    qt = q_codes[safe_q]  # (S, block_q, d)
    qscl = torch.where(sched_qids >= 0, q_scales[safe_q], 1.0).to(torch.float32)
    int_scores = int_dot(qt, rows)  # (S, block_q, Lp)
    comb = qscl[:, :, None] * row_scales[safe_c][:, None, :].to(torch.float32)
    scores = torch.where(step_slot_ids >= 0, int_scores * comb, NEG_INF)
    ids, sc = dedup_topk(
        step_slot_ids.reshape(s_steps * block_q, lp),
        scores.reshape(s_steps * block_q, lp),
        kp,
    )
    return ids.reshape(s_steps, block_q, kp), sc.reshape(s_steps, block_q, kp)
