"""Device dispatch for the kernels: a CPU tensor goes to the plain PyTorch
version, a CUDA tensor to the hand-written kernel. There is no flag and no
fall-back: a CUDA call the kernel refuses raises.

A tensor that holds no values (a ``FakeTensor``, as the dry run runs its
steps, or a meta tensor) takes a shape-only branch: empty outputs of the
kernel's shapes and dtypes on the input's device, and no launch counted.
There is nothing to compute, on any device.

Under a counter (``repro_torch/counting.py``) each wrapper reports its
call's cost from shapes and dtypes (``kernels/cost.py``), the same from
every branch, and the counter counts none of the wrapper's own ops."""
from __future__ import annotations

import torch

from .. import counting
from ..device import is_fake

from . import fused_verify as _fv
from . import kmeans_assign as _km
from . import lsh_hash as _lsh
from . import cost, quant, ref
from .fused_verify import _workspace, grouped_scratch


def _on_cpu(t: torch.Tensor, what: str) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"no {what} kernel for device {t.device}")
    return False


def _topk_shape(t: torch.Tensor, lead: tuple[int, ...], k: int, *temps):
    """The shape-only answer of a top-k kernel: (lead..., k) int32 ids and
    float32 scores. ``temps`` are thunks that make the wrapper's own
    temporaries (the quantized or sketched queries, the chunk workspace),
    held while the outputs are made, as the wrapper holds them around its
    launch, so that a dry run's memory sees them."""
    held = [make() for make in temps]
    out = (torch.empty(lead + (k,), dtype=torch.int32, device=t.device),
           torch.empty(lead + (k,), dtype=torch.float32, device=t.device))
    del held
    return out


def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


def _separate(out_ids, row_ids) -> bool:
    return out_ids is not None and out_ids is not row_ids


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
    with counting.kernel(lambda: cost.fused_verify(
            *row_ids.shape, queries.shape[-1], k, cost.row_bytes(embs, scales),
            out_ids=_separate(out_ids, row_ids))):
        fake = is_fake(embs) or is_fake(row_ids)
        if not fake and _on_cpu(embs, "verification"):
            return ref.verify_topk_ref(
                embs, row_ids, queries, k=k, out_ids=out_ids, scales=scales,
                code_dtype=code_dtype,
            )
        row_ids = _i32(row_ids)
        out_ids = row_ids if out_ids is None else _i32(out_ids)
        queries = queries.to(torch.float32).contiguous()
        if fake:
            b, c = row_ids.shape
            return _topk_shape(embs, (b,), k, lambda: _workspace(b, c, k, embs.device),
                               *(() if scales is None else (lambda: quant.quantize_rows(queries),)))
        return _fv.fused_verify(
            embs.contiguous(),
            row_ids,
            queries,
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
    with counting.kernel(lambda: cost.sketch_prefilter(
            *row_ids.shape, queries.shape[-1], k, out_ids=_separate(out_ids, row_ids))):
        fake = is_fake(sketches) or is_fake(row_ids)
        if not fake and _on_cpu(sketches, "sketch pre-filter"):
            return ref.sketch_topk_ref(sketches, row_ids, queries, k=k, out_ids=out_ids)
        row_ids = _i32(row_ids)
        out_ids = row_ids if out_ids is None else _i32(out_ids)
        queries = queries.to(torch.float32).contiguous()
        if fake:
            b, c = row_ids.shape
            return _topk_shape(sketches, (b,), k, lambda: _workspace(b, c, k, sketches.device),
                               lambda: quant.sketch_rows(queries))
        return _fv.sketch_prefilter(sketches.contiguous(), row_ids, queries, k=k, out_ids=out_ids)


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
    with counting.kernel(lambda: cost.fused_verify_grouped(
            *step_slot_ids.shape, *queries.shape, kp, cost.row_bytes(embs, row_scales))):
        fake = is_fake(embs) or is_fake(step_slot_ids)
        if not fake and _on_cpu(embs, "grouped verification"):
            return ref.verify_topk_grouped_ref(
                embs, row_scales, queries, sched_cids, sched_qids, step_slot_ids,
                kp=kp, code_dtype=code_dtype,
            )
        args = (embs.contiguous(), row_scales.to(torch.float32).contiguous(),
                queries.to(torch.float32).contiguous(), _i32(sched_cids), _i32(sched_qids),
                _i32(step_slot_ids))
        if fake:
            s_steps, block_q, lp = step_slot_ids.shape
            scratch = grouped_scratch(s_steps, block_q, lp)
            return _topk_shape(embs, (s_steps, block_q), kp, lambda: quant.quantize_rows(args[2]),
                               lambda: torch.empty((scratch,), dtype=torch.float32,
                                                   device=embs.device))
        return _fv.fused_verify_grouped(*args, kp=kp, code_dtype=code_dtype)


def lsh_hash_op(
    x: torch.Tensor, proj: torch.Tensor, *, n_arrays: int, key_len: int
) -> torch.Tensor:
    """(N, d) rows, (d, H*M) projections -> (N, H) int64 packed sign keys
    (``lsh_hash`` on the card). float32 and bfloat16 rows are hashed as
    they are; any other float type is widened to float32 first."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.to(torch.float32)
    with counting.kernel(lambda: cost.lsh_hash(*x.shape, n_arrays, key_len, x.element_size())):
        fake = is_fake(x)
        if not fake and _on_cpu(x, "LSH hash"):
            return ref.lsh_hash_ref(x, proj, n_arrays=n_arrays, key_len=key_len)
        x, proj = x.contiguous(), proj.to(torch.float32).contiguous()
        if fake:  # the kernel writes int32 keys, widened to int64
            return torch.empty((x.shape[0], n_arrays), dtype=torch.int32,
                               device=x.device).to(torch.int64)
        return _lsh.lsh_hash(x, proj, n_arrays=n_arrays, key_len=key_len)


def kmeans_assign_op(
    x: torch.Tensor, centroids: torch.Tensor, *, chunk: int = 4096
) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest centroid -> (assignment (N,) int32, min squared L2 (N,)).

    On the card one ``kmeans_assign`` call covers all N (its kernels never
    build the (N, c) distances); the plain version runs ``chunk`` rows at
    a time so its (chunk, c) distances stay small.
    """
    with counting.kernel(lambda: cost.kmeans_assign(x.shape[0], *centroids.shape)):
        x = x.to(torch.float32)
        centroids = centroids.to(torch.float32)
        if is_fake(x):
            n = x.shape[0]
            return (torch.empty((n,), dtype=torch.int32, device=x.device),
                    torch.empty((n,), dtype=torch.float32, device=x.device))
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
