"""The CUDA verification kernels and their wrappers.

- ``fused_verify`` (``csrc/fused_verify.cu``): gather-score-reduce
  verification with a deduplicated top-k; float32, bfloat16, int8 and
  packed-int4 tables. Replaces ``repro/kernels/fused_verify.py::fused_verify``.
- ``sketch_prefilter`` (``csrc/sketch_prefilter.cu``): the 1-bit Hamming
  first pass over sign sketches. Replaces ``...::sketch_prefilter``.

  Both cut each query's C candidates into chunks (:func:`split_candidates`),
  one block each; a block loads each distinct row of its chunk once and
  keeps a partial top-k, and the last block of a query merges the partial
  lists (``csrc/topk.cuh``), in shared memory up to ``MAX_SMEM_K`` and in
  global memory above it, so any k >= 1 is answered (:func:`verify_plan`).
- ``fused_verify_grouped`` (``csrc/fused_verify_grouped.cu``): the
  cluster-major first pass, one cluster tile against ``block_q`` queries:
  a score kernel per (step, slot group) on the tensor cores, then a select
  kernel per (step, slot), through a scratch of scores
  (:func:`grouped_scratch`). Replaces
  ``...::fused_verify_grouped``.

Each source's header says what bounds it on the card and how the design
answers that. A wrapper validates its inputs, allocates the outputs and
launches on the current stream; it never runs on CPU tensors (``ops`` sends
those to the plain versions in ``ref``) and raises when the launch fails.
Each wrapper's ``launches`` counts its kernel launches, so a run can show
that its main path went through the kernel.
"""
from __future__ import annotations

import dataclasses

import torch

from . import quant
from .launch import I as _I, LL as _LL, P as _P
from .launch import bind as _bind, check as _check, count as _count
from .launch import launch as _launch, on_cuda as _on_cuda

MAX_CHUNK = 4096  # candidates per block: its (row, id) hash set fits in shared memory
MAX_SMEM_K = 4096  # above it, a query's top-k is merged in global memory (topk.cuh kMaxSmemK)
# The grouped kernels (csrc/fused_verify_grouped.cu kMaxLp): the select
# kernel sorts up to next_pow2(Lp) (score, id) entries in shared memory.
MAX_LP = 16384

_MODES = {torch.float32: 0, torch.bfloat16: 1}
_INT8, _INT4 = 2, 3


def _check_k(k: int) -> None:
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")


def split_candidates(c: int) -> tuple[int, int]:
    """How ``fused_verify`` and ``sketch_prefilter`` cut a query's ``c``
    candidates: ``(n_chunks, chunk)``, chunk ``i`` being candidates ``[i *
    chunk, min(c, (i + 1) * chunk))``. The fewest chunks of at most
    ``MAX_CHUNK``, of equal length but the last: one for a call of up to
    4,096 candidates, 20 of 4,000 for the in-cluster call's 80,000."""
    n = max(1, -(-c // MAX_CHUNK))
    chunk = -(-c // n)
    return (-(-c // chunk) if chunk else 1), chunk


@dataclasses.dataclass(frozen=True)
class VerifyPlan:
    """How ``fused_verify`` and ``sketch_prefilter`` run a (B, C) call at k."""

    n_chunks: int
    chunk: int
    large: bool  # k > MAX_SMEM_K: the final merge runs in global memory
    list_len: int  # entries of a chunk's partial list
    words: int  # int32 words of the workspace; 0 when there is none


def verify_plan(b: int, c: int, k: int) -> VerifyPlan:
    """The (query, chunk) split and the workspace of a call. With more than
    one chunk, each query has ``n_chunks`` partial lists of ``list_len``
    (score, id) entries and their lengths; on the large-k path a chunk's
    list keeps all its distinct entries (at most the chunk) and each query
    also has a k-entry list for the final merge (``csrc/topk.cuh``)."""
    n_chunks, chunk = split_candidates(c)
    large = k > MAX_SMEM_K
    list_len = min(k, chunk) if large else k
    words = 0
    if n_chunks > 1:
        words = b * n_chunks * (2 * list_len + 1) + (2 * b * k if large else 0)
    return VerifyPlan(n_chunks, chunk, large, list_len, words)


def _workspace(b: int, c: int, k: int, device):
    """``(n_chunks, chunk, workspace, arrive)`` of a call: the workspace of
    :func:`verify_plan` and each query's arrival counter (B zeros), or None
    for one chunk."""
    plan = verify_plan(b, c, k)
    if not plan.words:
        return plan.n_chunks, plan.chunk, None, None
    return (plan.n_chunks, plan.chunk,
            torch.empty((plan.words,), dtype=torch.int32, device=device),
            torch.zeros((b,), dtype=torch.int32, device=device))


def grouped_scratch(s_steps: int, block_q: int, lp: int) -> int:
    """float32 entries of a grouped call's scratch, the score of every
    (step, slot, row): S * block_q * Lp. Raises where the kernels cannot
    run: block_q or Lp below 1, or Lp above ``MAX_LP``. The score kernel
    picks its slot group in the C entry point, from its shared memory and
    the device's limit."""
    if block_q < 1 or lp < 1:
        raise ValueError(f"block_q and Lp must be >= 1, got {block_q}, {lp}")
    if lp > MAX_LP:
        raise ValueError(f"Lp must be at most {MAX_LP} (the select kernel sorts a slot's "
                         f"candidates in shared memory), got {lp}")
    return s_steps * block_q * lp


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def fused_verify(
    embs: torch.Tensor,
    row_ids: torch.Tensor,
    queries: torch.Tensor,
    *,
    k: int,
    out_ids: torch.Tensor | None = None,
    scales: torch.Tensor | None = None,
    code_dtype: str = "int8",
) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, d_store) table, (B, C) int32 rows, (B, d) f32 queries -> (B, k)
    int32 ids and (B, k) f32 scores: the top-k deduplicated by ``out_ids``
    (default ``row_ids``; < 0 marks padding), scores descending, ties to the
    smallest id, (-1, -inf) past the number of unique valid ids.

    With ``scales`` ((N,) f32) the table holds int8 codes, or packed int4
    codes of width d/2 with ``code_dtype="int4"``; the queries are quantized
    here with ``quant.quantize_rows``, as the JAX wrapper does.
    """
    if code_dtype not in ("int8", "int4"):
        raise ValueError(f"code_dtype must be 'int8' or 'int4', got {code_dtype!r}")
    if code_dtype == "int4" and scales is None:
        raise ValueError("code_dtype='int4' requires scales (a packed code table)")
    if out_ids is None:
        out_ids = row_ids
    device = _on_cuda("fused_verify", embs, "verify_topk_ref")
    quantized = scales is not None
    if embs.dim() != 2 or not embs.is_contiguous():
        raise ValueError(f"embs must be a contiguous 2-D table, got {tuple(embs.shape)}")
    if quantized and embs.dtype != torch.int8:
        raise ValueError(f"a quantized table must be int8 codes, got {embs.dtype}")
    if not quantized and embs.dtype not in _MODES:
        raise ValueError(f"embs must be float32 or bfloat16 without scales, got {embs.dtype}")
    n, d_store = embs.shape
    d = 2 * d_store if quantized and code_dtype == "int4" else d_store
    if row_ids.dim() != 2:
        raise ValueError(f"row_ids must be (B, C), got {tuple(row_ids.shape)}")
    b, c = row_ids.shape
    _check("row_ids", row_ids, torch.int32, (b, c), device)
    _check("out_ids", out_ids, torch.int32, (b, c), device)
    _check("queries", queries, torch.float32, (b, d), device)
    _check_k(k)
    if n == 0:
        raise ValueError("embs has no rows")
    if quantized:
        _check("scales", scales, torch.float32, (n,), device)
        q, q_scales = quant.quantize_rows(queries)
        mode = _INT4 if code_dtype == "int4" else _INT8
        scale_ptr, q_scale_ptr = scales.data_ptr(), q_scales.data_ptr()
    else:
        q, mode, scale_ptr, q_scale_ptr = queries, _MODES[embs.dtype], None, None
    ids = torch.empty((b, k), dtype=torch.int32, device=device)
    scores = torch.empty((b, k), dtype=torch.float32, device=device)
    if b == 0:
        return ids, scores
    n_chunks, chunk, ws, arrive = _workspace(b, c, k, device)
    fn = _bind("fused_verify", "fused_verify_launch",
               [_P, _I, _LL, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P])
    _launch(
        "fused_verify", fn, embs.data_ptr(), mode, n, d_store, scale_ptr,
        row_ids.data_ptr(), out_ids.data_ptr(), q.data_ptr(), q_scale_ptr,
        b, c, chunk, n_chunks, k, ids.data_ptr(), scores.data_ptr(), _ptr(ws), _ptr(arrive),
        device=device,
    )
    _count(fused_verify, 1)
    return ids, scores


fused_verify.launches = 0


def sketch_prefilter(
    sketches: torch.Tensor,
    row_ids: torch.Tensor,
    queries: torch.Tensor,
    *,
    k: int,
    out_ids: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, w) int32 sign sketches, (B, C) int32 rows, (B, d) f32 queries ->
    (B, k) int32 survivor ids and (B, k) f32 negated-Hamming scores, with the
    dedup, padding and tie-break of ``fused_verify``. The queries are
    sketched here with ``quant.sketch_rows``."""
    if out_ids is None:
        out_ids = row_ids
    device = _on_cuda("sketch_prefilter", sketches, "sketch_topk_ref")
    if sketches.dim() != 2:
        raise ValueError(f"sketches must be (N, w), got {tuple(sketches.shape)}")
    n, w = sketches.shape
    if row_ids.dim() != 2 or queries.dim() != 2:
        raise ValueError("row_ids and queries must be 2-D")
    b, c = row_ids.shape
    d = queries.shape[1]
    if quant.sketch_width(d) != w:
        raise ValueError(f"queries of width {d} sketch to {quant.sketch_width(d)} words, table has {w}")
    _check("sketches", sketches, torch.int32, (n, w), device)
    _check("row_ids", row_ids, torch.int32, (b, c), device)
    _check("out_ids", out_ids, torch.int32, (b, c), device)
    _check("queries", queries, torch.float32, (b, d), device)
    _check_k(k)
    if n == 0:
        raise ValueError("sketches has no rows")
    q_sk = quant.sketch_rows(queries).contiguous()
    ids = torch.empty((b, k), dtype=torch.int32, device=device)
    scores = torch.empty((b, k), dtype=torch.float32, device=device)
    if b == 0:
        return ids, scores
    n_chunks, chunk, ws, arrive = _workspace(b, c, k, device)
    fn = _bind("sketch_prefilter", "sketch_prefilter_launch",
               [_P, _LL, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P])
    _launch(
        "sketch_prefilter", fn, sketches.data_ptr(), n, w, row_ids.data_ptr(),
        out_ids.data_ptr(), q_sk.data_ptr(), b, c, chunk, n_chunks, k, ids.data_ptr(),
        scores.data_ptr(), _ptr(ws), _ptr(arrive), device=device,
    )
    _count(sketch_prefilter, 1)
    return ids, scores


sketch_prefilter.launches = 0


def fused_verify_grouped(
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
    """Cluster-major first pass: ``(c, Lp, d_store)`` int8 codes (packed
    int4 with ``code_dtype="int4"``), ``(c, Lp)`` f32 row scales, ``(B, d)``
    f32 queries (quantized here), the schedule ``sched_cids (S,)``,
    ``sched_qids (S, block_q)`` and ``step_slot_ids (S, block_q, Lp)``, all
    int32 -> ``(S, block_q, kp)`` ids and scores: each (step, slot)'s
    dedup top-``kp`` within its cluster. Any block_q and kp >= 1, Lp up to
    ``MAX_LP``; two kernel launches (score, then select), both counted."""
    if code_dtype not in ("int8", "int4"):
        raise ValueError(f"code_dtype must be 'int8' or 'int4', got {code_dtype!r}")
    device = _on_cuda("fused_verify_grouped", embs, "verify_topk_grouped_ref")
    if embs.dim() != 3:
        raise ValueError(f"embs must be (c, Lp, d_store), got {tuple(embs.shape)}")
    c, lp, d_store = embs.shape
    d = 2 * d_store if code_dtype == "int4" else d_store
    if step_slot_ids.dim() != 3 or queries.dim() != 2:
        raise ValueError("step_slot_ids must be (S, block_q, Lp) and queries (B, d)")
    s_steps, block_q, _ = step_slot_ids.shape
    b = queries.shape[0]
    n_scratch = grouped_scratch(s_steps, block_q, lp)
    _check("embs", embs, torch.int8, (c, lp, d_store), device)
    _check("row_scales", row_scales, torch.float32, (c, lp), device)
    _check("queries", queries, torch.float32, (b, d), device)
    _check("sched_cids", sched_cids, torch.int32, (s_steps,), device)
    _check("sched_qids", sched_qids, torch.int32, (s_steps, block_q), device)
    _check("step_slot_ids", step_slot_ids, torch.int32, (s_steps, block_q, lp), device)
    _check_k(kp)
    q_codes, q_scales = quant.quantize_rows(queries)
    ids = torch.empty((s_steps, block_q, kp), dtype=torch.int32, device=device)
    scores = torch.empty((s_steps, block_q, kp), dtype=torch.float32, device=device)
    if s_steps == 0:
        return ids, scores
    scratch = torch.empty((n_scratch,), dtype=torch.float32, device=device)
    fn = _bind("fused_verify_grouped", "fused_verify_grouped_launch",
               [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P])
    _launch(
        "fused_verify_grouped", fn, embs.data_ptr(), row_scales.data_ptr(), c, lp,
        d_store, int(code_dtype == "int4"), q_codes.data_ptr(), q_scales.data_ptr(),
        sched_cids.data_ptr(), sched_qids.data_ptr(), step_slot_ids.data_ptr(),
        s_steps, block_q, kp, scratch.data_ptr(), ids.data_ptr(),
        scores.data_ptr(), device=device,
    )
    _count(fused_verify_grouped, 2)  # the score kernel, then the select kernel
    return ids, scores


fused_verify_grouped.launches = 0
