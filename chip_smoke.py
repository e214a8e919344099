#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of LIDER on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing its lines; any failure exits non-zero:

1. device   — the card's name and power limit (``nvidia-smi``); no CUDA
              device is an error, never a fall-back to the CPU.
2. build    — ``nvcc`` builds every kernel of the port from ``csrc/``.
3. parity   — ``fused_verify`` against its plain version on edge cases
              (duplicates, dead tiles, an all-invalid row, k above the
              valid count), float32 and bfloat16 tables.
4. main     — the ``lider-msmarco`` configuration (1,048,576 x 768
              synthetic corpus): ``build_lider``, then 4 batches of 256
              queries through ``search_lider`` at k=100, recall@100 against
              Flat, the first 8 queries against the same search with the
              kernel swapped for its plain version, and the kernel's launch
              count (2 per batch: routing, in-cluster verification), then
              a ``torch.profiler`` trace of one more batch.
5. shapes   — ``fused_verify`` on the exact inputs the main path gives it
              (routing and in-cluster), float32 and bfloat16 tables, held
              against the plain version over the whole batch (the in-cluster
              plain side chunked by 8 queries), timed with CUDA events,
              beside its byte/operation bound.
6. kernels  — one JSON line per ported kernel with those numbers.

The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path
from unittest import mock

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # f32 CUDA cores; bf16 tensor
RECALL_FLOOR = 0.5  # only catches garbage
N_BATCHES, BATCH, SEED = 4, 256, 0
PLAIN_CHUNK = 8  # queries per plain-version call at the in-cluster shape


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, reps: int) -> float:
    fn()  # warm
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log("device", f"{kind}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"count {torch.cuda.device_count()}")
    print(smi, flush=True)
    if torch.backends.cuda.matmul.allow_tf32:
        raise SystemExit("chip_smoke: float32 matmuls must not run in TF32 here")
    return {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count(), "smi": smi}


def phase_build() -> float:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    lib = build.build("fused_verify")
    secs = time.perf_counter() - t0
    log("build", f"kernel library built in {secs:.2f} s: {lib.name}")
    return secs


def compare(kernel_out, plain_out) -> tuple[float, int]:
    """Ids equal up to swaps of near-equal scores; returns (max |score
    error| over finite scores, swaps admitted)."""
    from repro_torch.testing import assert_topk_match

    gi, gs = kernel_out
    wi, ws = plain_out
    swaps = assert_topk_match(gi, gs, wi, ws)
    fin = torch.isfinite(ws)
    if not torch.equal(torch.isneginf(gs), torch.isneginf(ws)):
        raise AssertionError("padding slots differ between kernel and plain version")
    err = float((gs[fin] - ws[fin]).abs().max()) if bool(fin.any()) else 0.0
    return err, swaps


def phase_parity(dev) -> float:
    from repro_torch.core.utils import l2_normalize
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_verify import fused_verify

    g = torch.Generator(device=dev).manual_seed(SEED)
    worst = 0.0
    cases = [  # (n, d, b, c, k)
        (40, 32, 3, 17, 5), (25, 16, 2, 12, 6), (200, 64, 4, 700, 10),
        (1000, 20, 5, 300, 7), (100, 768, 3, 1000, 300), (30, 16, 2, 6, 9),
        (5000, 768, 4, 4000, 100),
    ]
    for dtype in (torch.float32, torch.bfloat16):
        for n, d, b, c, k in cases:
            embs = l2_normalize(torch.randn((n, d), generator=g, device=dev)).to(dtype)
            rows = torch.randint(0, n, (b, c), generator=g, device=dev, dtype=torch.int32)
            rows[:, c // 2 :] = rows[:, : c - c // 2]  # every candidate twice
            out = rows.clone()
            out[torch.rand((b, c), generator=g, device=dev) < 0.3] = -1
            if c > 1024:
                out[:, :512] = -1  # dead leading tiles
            out[-1] = -1  # an all-invalid row
            if k >= c:
                out[0, 3:] = -1  # k above the valid count
            q = l2_normalize(torch.randn((b, d), generator=g, device=dev))
            got = fused_verify(embs, rows, q, k=k, out_ids=out)
            torch.cuda.synchronize()
            want = ref.verify_topk_ref(embs, rows, q, k=k, out_ids=out)
            err, _ = compare(got, want)
            if not bool((got[0][-1] == -1).all()):
                raise AssertionError("all-invalid row returned ids")
            worst = max(worst, err)
    log("parity", f"fused_verify edge cases x {len(cases)} shapes, float32 + bfloat16: "
        f"ids equal, max |score err| {worst:.3g} (unit-norm rows; scores held "
        "to rtol 1e-5 / atol 1e-6 of the plain version)")
    return worst


def plain_verify(embs, row_ids, queries, *, k, out_ids=None, scales=None, code_dtype="int8"):
    """The plain version under the kernel wrapper's signature."""
    from repro_torch.kernels import ref

    return ref.verify_topk_ref(embs, row_ids, queries, k=k, out_ids=out_ids)


def phase_main(dev) -> dict:
    from repro_torch.configs.lider_msmarco import CONFIG, REDUCED
    from repro_torch.core import lider
    from repro_torch.core.baselines import flat_search
    from repro_torch.core.utils import recall_at_k
    from repro_torch.data import synthetic
    from repro_torch.kernels import fused_verify as fv_mod, ops
    from repro_torch.testing import assert_topk_match

    cfg = CONFIG.lider
    log("main", f"lider-msmarco: N={CONFIG.corpus_size} d={CONFIG.dim} c={cfg.n_clusters} "
        f"n_probe={cfg.n_probe} H={cfg.n_arrays} M={cfg.key_len} k={CONFIG.k}; cuts: "
        + "; ".join(REDUCED))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    corpus = synthetic.retrieval_corpus(SEED, CONFIG.corpus_size, CONFIG.dim, device=dev)
    queries, _ = synthetic.retrieval_queries(SEED + 1, corpus, N_BATCHES * BATCH)
    torch.cuda.synchronize()
    t_data = time.perf_counter() - t0
    t0 = time.perf_counter()
    params, stats = lider.build_lider(SEED, corpus, cfg, return_stats=True, device=dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    peak_build = torch.cuda.max_memory_allocated()
    log("main", f"data {t_data:.2f} s; build_lider {t_build:.2f} s; capacity Lp={stats.capacity}; "
        f"indexed {stats.n_indexed}, dropped {stats.n_dropped}; peak device memory "
        f"{peak_build / 2**30:.2f} GiB")

    k, n_probe = CONFIG.k, cfg.n_probe
    search = lambda q: lider.search_lider(
        params, q, k=k, n_probe=n_probe, r0=cfg.r0, r0_centroid=cfg.r0_centroid
    )
    batches = [queries[i * BATCH : (i + 1) * BATCH] for i in range(N_BATCHES)]
    fv = fv_mod.fused_verify
    # Warm-up, before the counter is reset. It records the arguments of the
    # batch's two kernel calls, which phase_shapes times and checks.
    kernel_calls = []

    def recording(embs, row_ids, queries, *, k, out_ids=None, **kw):
        kernel_calls.append((embs, row_ids, queries, k, out_ids))
        return fv(embs, row_ids, queries, k=k, out_ids=out_ids, **kw)

    # Patched where ops looks the wrapper up, so the real wrapper (and its
    # counter) stays in place under its own name.
    with mock.patch.object(ops, "_fv", types.SimpleNamespace(fused_verify=recording)):
        search(batches[0])
    torch.cuda.synchronize()
    if len(kernel_calls) != 2:
        raise AssertionError(f"one search batch made {len(kernel_calls)} kernel calls, expected 2")

    fv.launches = 0
    outs, lat_ms, wall_ms = [], [], []
    for qb in batches:
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        s.record()
        outs.append(search(qb))
        e.record()
        torch.cuda.synchronize()
        wall_ms.append((time.perf_counter() - h0) * 1e3)
        lat_ms.append(s.elapsed_time(e))
    launches = fv.launches
    if launches != 2 * N_BATCHES:
        raise AssertionError(f"fused_verify launched {launches} times, expected {2 * N_BATCHES}")
    ids = torch.cat([o.ids for o in outs])
    scores = torch.cat([o.scores for o in outs])
    if ids.shape != (N_BATCHES * BATCH, k) or not bool(torch.isfinite(scores).all()):
        raise AssertionError(f"bad result: shape {tuple(ids.shape)}, finite {bool(torch.isfinite(scores).all())}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gt = flat_search(corpus, queries, k=k)
    torch.cuda.synchronize()
    t_flat = time.perf_counter() - t0
    rec = float(recall_at_k(ids, gt.ids))
    med = statistics.median(lat_ms)
    log("main", f"{N_BATCHES} x {BATCH} queries at k={k}: fused_verify launches {launches} "
        f"(2 per batch); per-batch latency median {med:.3f} ms (CUDA events; all "
        f"{', '.join(f'{v:.3f}' for v in lat_ms)}), host wall median "
        f"{statistics.median(wall_ms):.3f} ms, {BATCH / med * 1e3:.0f} queries/s")
    log("main", f"recall@{k} vs Flat = {rec:.4f} (floor {RECALL_FLOOR}); Flat {t_flat:.2f} s")
    if rec < RECALL_FLOOR:
        raise AssertionError(f"recall@{k} {rec} below {RECALL_FLOOR}")

    # The same search with the kernel swapped for its plain version.
    q8 = batches[0][:8]
    with mock.patch.object(fv_mod, "fused_verify", plain_verify):
        plain = search(q8)
    kern = search(q8)
    if fv.launches != launches + 2:
        raise AssertionError("the plain-version search launched the kernel")
    swaps = assert_topk_match(kern.ids, kern.scores, plain.ids, plain.scores)
    log("main", f"first 8 queries: kernel search == plain-version search, ids equal "
        f"({swaps} swaps of near-equal scores admitted)")
    phase_trace(search, batches[1], med)
    return {
        "kernel_calls": kernel_calls, "launches": launches, "recall": rec,
        "latency_ms": med, "build_s": t_build, "peak_gib": peak_build / 2**30,
    }


def phase_trace(search, qb, batch_ms: float) -> None:
    """Where one batch's time goes: a ``torch.profiler`` trace of one warm
    search call, run after the launch count was read. The profiler slows
    the host, so the idle share is taken against ``batch_ms``, the
    unprofiled batch latency, not against the traced call's own wall."""
    from torch.profiler import ProfilerActivity, profile

    search(qb)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        search(qb)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        log("trace", "device time not measured: the profiler recorded no device events")
        return
    by_name: dict[str, float] = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    fv = sum(v for n, v in by_name.items() if "fused_verify_kernel" in n)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    log("trace", f"one profiled batch: device busy {busy / 1e3:.3f} ms over {len(dev)} "
        f"device ops, {busy / 1e3 / batch_ms:.1%} of the unprofiled batch latency "
        f"{batch_ms:.3f} ms (idle {1 - busy / 1e3 / batch_ms:.1%}; traced wall "
        f"{wall_us / 1e3:.3f} ms); "
        f"fused_verify {fv / 1e3:.3f} ms ({fv / busy:.1%} of device "
        "time); top: " + "; ".join(f"{n[:60]} {v / 1e3:.3f} ms" for n, v in top))


def bound(embs, row_ids, out_ids, b, k) -> tuple[float, str]:
    """Least time for the call: each distinct valid row read once, the id
    arrays and queries read once, the outputs written once; or 2d operations
    per distinct (query, row) pair at the card's peak for the table type."""
    d = embs.shape[1]
    valid = out_ids >= 0
    rows = row_ids.to(torch.int64)
    distinct_rows = int(torch.unique(rows[valid]).numel())
    pairs = int(torch.unique((torch.arange(b, device=rows.device)[:, None] * embs.shape[0] + rows)[valid]).numel())
    id_bytes = row_ids.numel() * 4 * (1 if out_ids.data_ptr() == row_ids.data_ptr() else 2)
    n_bytes = distinct_rows * d * embs.element_size() + id_bytes + b * d * 4 + b * k * 8
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = 2 * d * pairs / PEAK_FLOPS[embs.dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_shapes(dev, main) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_verify import fused_verify

    # The two kernel calls of one main-path search batch, on the arguments
    # that search_lider passed them: routing first, then in-cluster.
    (rt, rr, rq, rk, ro), (it, ir, iq, ik, io) = main["kernel_calls"]
    calls = [
        ("routing", rt, rr, rq, rr if ro is None else ro, rk, 20, rq.shape[0]),
        ("in-cluster", it, ir, iq, ir if io is None else io, ik, 5, PLAIN_CHUNK),
    ]
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, table, rows, q, out, k, reps, chunk in calls:
            b = q.shape[0]
            tab = table if dtype == torch.float32 else table.to(torch.bfloat16)
            run = lambda: fused_verify(tab, rows, q, k=k, out_ids=out)
            got = run()
            torch.cuda.synchronize()

            def plain_all():
                parts = [
                    ref.verify_topk_ref(tab, rows[i : i + chunk], q[i : i + chunk], k=k,
                                        out_ids=out[i : i + chunk])
                    for i in range(0, b, chunk)
                ]
                return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])

            want = plain_all()
            err, swaps = compare(got, want)
            ms = cuda_ms(run, reps)
            plain_ms = cuda_ms(plain_all, 1)
            bound_ms, bound_by = bound(tab, rows, out, b, k)
            res[(name, dtype)] = {
                "call": name, "table": str(dtype).removeprefix("torch."),
                "B": b, "C": rows.shape[1], "N": tab.shape[0], "d": tab.shape[1], "k": k,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "max_abs_err": err, "swaps_admitted": swaps,
            }
            log("shapes", f"fused_verify {name} {res[(name, dtype)]['table']} "
                f"B={b} C={rows.shape[1]} N={tab.shape[0]} k={k}: ids equal to the plain "
                f"version over all {b} queries (plain side in chunks of {chunk}), max |score "
                f"err| {err:.3g}; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
                f"{bound_ms:.4f} ms ({bound_by}); no single PyTorch call computes gather + "
                "dedup top-k, so no library time")
            del tab
    return res


def main() -> int:
    device = phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    phase_parity(dev)
    main_res = phase_main(dev)
    shapes = phase_shapes(dev, main_res)
    f32 = [shapes[("routing", torch.float32)], shapes[("in-cluster", torch.float32)]]
    entry = {
        "name": "fused_verify",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_verify.cu",
        "replaces": "src/repro/kernels/fused_verify.py:82",
        "launches": main_res["launches"],
        "max_abs_err": max(v["max_abs_err"] for v in shapes.values()),
        # Per batch of the main path: its routing call plus its in-cluster call.
        "ms": sum(v["ms"] for v in f32),
        "plain_ms": sum(v["plain_ms"] for v in f32),
        "bound_ms": sum(v["bound_ms"] for v in f32),
        "bound_by": max(f32, key=lambda v: v["bound_ms"])["bound_by"],  # the dominant call
        "library_ms": None,
        "calls": list(shapes.values()),
    }
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {k: device[k] for k in ("platform", "kind", "count")}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
