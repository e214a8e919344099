"""``fused_verify``: the CUDA gather-score-reduce verification kernel.

Replaces ``repro/kernels/fused_verify.py::fused_verify`` (the Pallas TPU
kernel) for float32 and bfloat16 tables; the source is
``csrc/fused_verify.cu``, whose header says what bounds it and how the
design answers that. This wrapper validates its inputs, allocates the
outputs and launches the kernel on the current stream; it never runs on
CPU tensors (``ops.verify_topk_op`` sends those to ``ref.verify_topk_ref``).

``fused_verify.launches`` counts kernel launches, so a run can show that
its main path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

MAX_K = 4096  # the merge buffer (2 * next_pow2(2k) entries) must fit in shared memory

_TABLE_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib: ctypes.CDLL):
    fn = lib.fused_verify_launch
    p = ctypes.c_void_p
    fn.argtypes = [
        p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, p, p, p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, p, p, p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


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
    """(N, d) table, (B, C) int32 rows, (B, d) f32 queries -> (B, k) int32
    ids and (B, k) f32 scores: the top-k deduplicated by ``out_ids``
    (default ``row_ids``; < 0 marks padding), scores descending, ties to the
    smallest id, (-1, -inf) past the number of unique valid ids.
    """
    if scales is not None or code_dtype != "int8":
        raise NotImplementedError(
            "the int8 / packed-int4 branches of fused_verify (scales, "
            "code_dtype) come with the quantized bank, the next port slice"
        )
    if out_ids is None:
        out_ids = row_ids
    device = embs.device
    if device.type != "cuda":
        raise ValueError(
            f"fused_verify runs on CUDA tensors, got {device}; the plain "
            "version is ref.verify_topk_ref"
        )
    if embs.dtype not in _TABLE_DTYPES or embs.dim() != 2:
        raise ValueError(
            f"embs must be a 2-D float32 or bfloat16 table, got "
            f"{embs.dtype} {tuple(embs.shape)}"
        )
    if not embs.is_contiguous():
        raise ValueError("embs must be contiguous")
    n, d = embs.shape
    if row_ids.dim() != 2:
        raise ValueError(f"row_ids must be (B, C), got {tuple(row_ids.shape)}")
    b, c = row_ids.shape
    _check("row_ids", row_ids, torch.int32, (b, c), device)
    _check("out_ids", out_ids, torch.int32, (b, c), device)
    _check("queries", queries, torch.float32, (b, d), device)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}], got {k}")
    if n == 0:
        raise ValueError("embs has no rows")
    ids = torch.empty((b, k), dtype=torch.int32, device=device)
    scores = torch.empty((b, k), dtype=torch.float32, device=device)
    if b == 0:
        return ids, scores
    fn = _bind(build.load_library("fused_verify"))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            embs.data_ptr(), _TABLE_DTYPES[embs.dtype], n, d,
            row_ids.data_ptr(), out_ids.data_ptr(), queries.data_ptr(),
            b, c, k, ids.data_ptr(), scores.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_verify launch failed with CUDA error {err}")
    fused_verify.launches += 1
    return ids, scores


fused_verify.launches = 0
