"""Device dispatch for the kernels: a CPU tensor goes to the plain PyTorch
version, a CUDA tensor to the hand-written kernel. There is no flag and no
fall-back: a CUDA call the kernel refuses raises."""
from __future__ import annotations

import torch

from . import fused_verify as _fv
from . import kmeans_assign as _km
from . import lsh_hash as _lsh
from . import ref


def _on_cpu(t: torch.Tensor, what: str) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"no {what} kernel for device {t.device}")
    return False


def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


def verify_topk_op(
    embs: torch.Tensor,
    row_ids: torch.Tensor,
    queries: torch.Tensor,
    *,
    k: int,
    out_ids: torch.Tensor | None = None,
    scales: torch.Tensor | None = None,
    code_dtype: str = "int8",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Candidate verification -> deduplicated top-k, (B, k) ids + scores.

    Same semantics on both paths: dedup by ``out_ids`` (< 0 == padding),
    scores descending, ties to the smallest id, (-1, -inf) fill. Float32
    and bfloat16 tables; with ``scales`` an int8 code table (packed int4
    with ``code_dtype="int4"``) scored in the exact integer domain.
    """
    if _on_cpu(embs, "verification"):
        return ref.verify_topk_ref(
            embs, row_ids, queries, k=k, out_ids=out_ids, scales=scales,
            code_dtype=code_dtype,
        )
    row_ids = _i32(row_ids)
    out_ids = row_ids if out_ids is None else _i32(out_ids)
    return _fv.fused_verify(
        embs.contiguous(),
        row_ids,
        queries.to(torch.float32).contiguous(),
        k=k,
        out_ids=out_ids,
        scales=None if scales is None else scales.to(torch.float32).contiguous(),
        code_dtype=code_dtype,
    )


def sketch_topk_op(
    sketches: torch.Tensor,
    row_ids: torch.Tensor,
    queries: torch.Tensor,
    *,
    k: int,
    out_ids: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Binary-sketch pre-filter -> deduplicated top-k survivor rows, scored
    by negated Hamming distance (``sketch_prefilter`` on the card)."""
    if _on_cpu(sketches, "sketch pre-filter"):
        return ref.sketch_topk_ref(sketches, row_ids, queries, k=k, out_ids=out_ids)
    row_ids = _i32(row_ids)
    out_ids = row_ids if out_ids is None else _i32(out_ids)
    return _fv.sketch_prefilter(
        sketches.contiguous(), row_ids, queries.to(torch.float32).contiguous(),
        k=k, out_ids=out_ids,
    )


def verify_topk_grouped_op(
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
    """Cluster-major verification -> per-(step, slot) dedup top-k'
    (``fused_verify_grouped`` on the card); quantized banks only."""
    if _on_cpu(embs, "grouped verification"):
        return ref.verify_topk_grouped_ref(
            embs, row_scales, queries, sched_cids, sched_qids, step_slot_ids,
            kp=kp, code_dtype=code_dtype,
        )
    return _fv.fused_verify_grouped(
        embs.contiguous(),
        row_scales.to(torch.float32).contiguous(),
        queries.to(torch.float32).contiguous(),
        _i32(sched_cids),
        _i32(sched_qids),
        _i32(step_slot_ids),
        kp=kp,
        code_dtype=code_dtype,
    )


def lsh_hash_op(
    x: torch.Tensor, proj: torch.Tensor, *, n_arrays: int, key_len: int
) -> torch.Tensor:
    """(N, d) rows, (d, H*M) projections -> (N, H) int64 packed sign keys
    (``lsh_hash`` on the card). float32 and bfloat16 rows are hashed as
    they are; any other float type is widened to float32 first."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.to(torch.float32)
    if _on_cpu(x, "LSH hash"):
        return ref.lsh_hash_ref(x, proj, n_arrays=n_arrays, key_len=key_len)
    return _lsh.lsh_hash(
        x.contiguous(), proj.to(torch.float32).contiguous(),
        n_arrays=n_arrays, key_len=key_len,
    )


def kmeans_assign_op(
    x: torch.Tensor, centroids: torch.Tensor, *, chunk: int = 4096
) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest centroid -> (assignment (N,) int32, min squared L2 (N,)).

    On the card one ``kmeans_assign`` call covers all N (its kernels never
    build the (N, c) distances); the plain version runs ``chunk`` rows at
    a time so its (chunk, c) distances stay small.
    """
    x = x.to(torch.float32)
    centroids = centroids.to(torch.float32)
    if not _on_cpu(x, "k-means assignment"):
        return _km.kmeans_assign(x.contiguous(), centroids.contiguous())
    n = x.shape[0]
    assign = torch.empty((n,), dtype=torch.int32, device=x.device)
    min_d = torch.empty((n,), dtype=torch.float32, device=x.device)
    for s in range(0, n, chunk):
        assign[s : s + chunk], min_d[s : s + chunk] = ref.kmeans_assign_ref(
            x[s : s + chunk], centroids
        )
    return assign, min_d
