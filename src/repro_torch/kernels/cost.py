"""What a hand-written kernel's call costs, from its shapes and dtypes alone:
the figures the kernels' wrappers (``kernels/ops.py``) report to the dry
run's counter (``repro_torch/counting.py``).

Each cost function returns ``(flops, bytes)``: the operations the function
computes (not a kernel's split-TF32 passes: the plain version and the JAX
reference do the same work) and the bytes it must move, each input read once
and each output written once. Every candidate counts as valid and distinct,
as the plain version and the JAX reference score every one. Ids are the
kernels' int32, queries float32, a top-k output an int32 id and a float32
score.
"""
from __future__ import annotations

import math


def _topk_out(rows: int, k: int) -> int:
    return rows * k * 8  # int32 ids + float32 scores


def row_bytes(table, scales=None) -> int:
    """Bytes a stored row: its elements at their width (quantized codes as
    stored, int4 packed two a byte), and its float32 scale where there is
    one."""
    return table.shape[-1] * table.element_size() + (0 if scales is None else 4)


def fused_verify(b: int, c: int, d: int, k: int, row: int, *,
                 out_ids: bool = False) -> tuple[int, int]:
    """B queries of width d against C candidate rows each -> a top-k:
    2d operations a (query, candidate) pair; bytes: the B x C gathered rows
    of ``row`` bytes (:func:`row_bytes`), the row ids (and ``out_ids`` where
    they are a separate array), the queries and the (B, k) outputs."""
    ids = b * c * 4 * (2 if out_ids else 1)
    return 2 * d * b * c, b * c * row + ids + b * d * 4 + _topk_out(b, k)


def sketch_prefilter(b: int, c: int, d: int, k: int, *, out_ids: bool = False) -> tuple[int, int]:
    """The 1-bit sketch pass: 2w operations a pair (XOR + popcount) for
    w = ceil(d / 32) words; bytes: the gathered sketches, ids, the float32
    queries and the outputs."""
    w = math.ceil(d / 32)
    ids = b * c * 4 * (2 if out_ids else 1)
    return 2 * w * b * c, b * c * w * 4 + ids + b * d * 4 + _topk_out(b, k)


def fused_verify_grouped(steps: int, block_q: int, lp: int, b: int, d: int, kp: int,
                         row: int) -> tuple[int, int]:
    """The cluster-major first pass: 2d operations a (slot, schedule row),
    S x block_q x Lp of them; bytes: each step's Lp rows of ``row`` bytes
    (codes and scale), the (S, block_q, Lp) slot ids, the schedule's
    cluster and query ids, the B queries and the (S, block_q, k') outputs."""
    return (2 * d * steps * block_q * lp,
            steps * lp * row + steps * block_q * lp * 4
            + (steps + steps * block_q) * 4 + b * d * 4 + _topk_out(steps * block_q, kp))


def lsh_hash(n: int, d: int, n_arrays: int, key_len: int, elem_bytes: int = 4) -> tuple[int, int]:
    """(N, d) rows of ``elem_bytes`` an element through the (d, H M) float32
    projections: 2 N d H M operations; the rows and projections read, the
    (N, H) int32 keys written."""
    hm = n_arrays * key_len
    return 2 * n * d * hm, n * d * elem_bytes + d * hm * 4 + n * n_arrays * 4


def kmeans_assign(n: int, c: int, d: int) -> tuple[int, int]:
    """N float32 rows against c centroids: 2 N c d operations; rows and
    centroids read, the int32 assignment and float32 distance written."""
    return 2 * n * c * d, (n * d + c * d) * 4 + n * 8
