#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of LIDER on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing its lines; any failure exits non-zero:

1. device    — the card's name and power limit (``nvidia-smi``); no CUDA
               device is an error, never a fall-back to the CPU.
2. build     — ``nvcc`` builds every kernel source under ``csrc/``, one
               process per source, all at once.
3. parity    — each kernel against its plain version on edge cases
               (duplicates, dead tiles, an all-invalid row, k above the
               valid count, heavy score ties): ``fused_verify`` on float32,
               bfloat16, int8 and packed-int4 tables, ``sketch_prefilter``,
               ``fused_verify_grouped`` on schedules with padding steps and
               empty slots. Quantized and sketch kernels must be bit-equal
               (ids and scores). Then a small quantized index: a covering
               ``sketch_factor`` and the cluster-major schedule give the
               unfiltered search, bit for bit.
4. main      — the ``lider-msmarco`` configuration (1,048,576 x 768
               synthetic corpus, float32 bank): ``build_lider``, then 4
               batches of 256 queries through ``search_lider`` at k=100,
               recall@100 against Flat, the first 8 queries against the
               same search with the kernel swapped for its plain version,
               ``fused_verify`` launches (2 per batch), and a
               ``torch.profiler`` trace of one more batch.
5. shapes    — each kernel call of one main-path batch, on the arguments
               the search passed it, held against the plain version over
               the whole batch and timed with CUDA events beside its bound.
6. quantized — the float index is freed, then the int8 and the int4 index
               are built at full width in turn, and 4 x 256 queries run on
               each quantized operating point (Q8, Q8-cm on int8; Q4-sk,
               Q4-sk-cm on int4): recall@100, each kernel's launches per
               batch, Q8-cm == Q8 and Q4-sk-cm == Q4-sk bit for bit, the
               first 8 queries against the all-plain search, the schedule's
               sharing, the shapes phase on each path's kernel calls, and a
               trace of one Q4-sk-cm batch.
7. kernels   — one JSON line with an entry per kernel.

The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import gc
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
PEAK_OPS = {  # per second: f32 CUDA cores; bf16 and int8 tensor cores (dense)
    torch.float32: 67e12, torch.bfloat16: 989e12, torch.int8: 1979e12,
}
RECALL_FLOOR = 0.5  # only catches garbage
N_BATCHES, BATCH, SEED = 4, 256, 0
KERNELS = {  # wrapper -> (CUDA source, the TPU kernel it replaces)
    "fused_verify": ("src/repro_torch/kernels/csrc/fused_verify.cu",
                     "src/repro/kernels/fused_verify.py:82"),
    "sketch_prefilter": ("src/repro_torch/kernels/csrc/sketch_prefilter.cu",
                         "src/repro/kernels/fused_verify.py:346"),
    "fused_verify_grouped": ("src/repro_torch/kernels/csrc/fused_verify_grouped.cu",
                             "src/repro/kernels/fused_verify.py:541"),
}
# Kernel launches per search batch of each quantized operating point:
# (fused_verify, sketch_prefilter, fused_verify_grouped).
PER_BATCH = {
    "Q8": (3, 0, 0), "Q8-cm": (2, 0, 1), "Q4-sk": (3, 1, 0), "Q4-sk-cm": (2, 1, 1),
}


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


def wrappers():
    from repro_torch.kernels import fused_verify as fv_mod

    return {name: getattr(fv_mod, name) for name in KERNELS}


def reset_counts() -> None:
    for fn in wrappers().values():
        fn.launches = 0


def read_counts() -> tuple[int, int, int]:
    return tuple(fn.launches for fn in wrappers().values())


def plain_fns():
    """The plain versions under the wrappers' signatures."""
    from repro_torch.kernels import ref

    def fused_verify(embs, row_ids, queries, *, k, out_ids=None, scales=None, code_dtype="int8"):
        return ref.verify_topk_ref(embs, row_ids, queries, k=k, out_ids=out_ids, scales=scales,
                                   code_dtype=code_dtype)

    def sketch_prefilter(sketches, row_ids, queries, *, k, out_ids=None):
        return ref.sketch_topk_ref(sketches, row_ids, queries, k=k, out_ids=out_ids)

    def fused_verify_grouped(embs, row_scales, queries, sched_cids, sched_qids, step_slot_ids,
                             *, kp, code_dtype="int8"):
        return ref.verify_topk_grouped_ref(embs, row_scales, queries, sched_cids, sched_qids,
                                           step_slot_ids, kp=kp, code_dtype=code_dtype)

    return {"fused_verify": fused_verify, "sketch_prefilter": sketch_prefilter,
            "fused_verify_grouped": fused_verify_grouped}


def all_plain():
    """Patch every kernel wrapper with its plain version (ops looks them up
    on the module at each call)."""
    from repro_torch.kernels import fused_verify as fv_mod

    return mock.patch.multiple(fv_mod, **plain_fns())


def recording(calls: list):
    """Patch ops' view of the wrappers so each kernel call of a search is
    recorded, (name, args, kwargs), and then launched by the real wrapper
    (whose counter stays under its own name)."""
    from repro_torch.kernels import ops

    real = wrappers()

    def rec(name):
        def f(*args, **kw):
            calls.append((name, args, kw))
            return real[name](*args, **kw)
        return f

    return mock.patch.object(ops, "_fv", types.SimpleNamespace(**{n: rec(n) for n in real}))


def bit_equal(got, want) -> bool:
    return torch.equal(got[0], want[0]) and torch.equal(
        got[1].contiguous().view(torch.int32), want[1].contiguous().view(torch.int32)
    )


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
    libs = build.build_all()
    secs = time.perf_counter() - t0
    log("build", f"{len(libs)} kernel libraries built in {secs:.2f} s (one nvcc each, in "
        f"parallel): {', '.join(p.name for p in libs.values())}")
    return secs


def _edge_case(g, dev, n, d, b, c, k):
    """Rows with exact ties and a zero row, candidates each twice, 30%
    invalid, dead leading tiles, an all-invalid row, k above the valid
    count."""
    from repro_torch.core.utils import l2_normalize

    embs = l2_normalize(torch.randn((n, d), generator=g, device=dev))
    if n > 13:
        embs[7] = embs[2]
        embs[13] = embs[2]
    embs[n // 2] = 0
    rows = torch.randint(0, n, (b, c), generator=g, device=dev, dtype=torch.int32)
    rows[:, c // 2 :] = rows[:, : c - c // 2]
    out = rows.clone()
    out[torch.rand((b, c), generator=g, device=dev) < 0.3] = -1
    if c > 1024:
        out[:, :512] = -1
    out[-1] = -1
    if k >= c:
        out[0, 3:] = -1
    q = l2_normalize(torch.randn((b, d), generator=g, device=dev))
    return embs, rows, out, q


def phase_parity(dev) -> float:
    from repro_torch.kernels import quant, ref
    from repro_torch.kernels.fused_verify import fused_verify, fused_verify_grouped, sketch_prefilter
    from repro_torch.kernels.schedule import build_cluster_schedule

    g = torch.Generator(device=dev).manual_seed(SEED)
    worst = 0.0
    cases = [  # (n, d, b, c, k)
        (40, 32, 3, 17, 5), (25, 16, 2, 12, 6), (200, 64, 4, 700, 10),
        (1000, 20, 5, 300, 7), (100, 768, 3, 1000, 300), (30, 16, 2, 6, 9),
        (5000, 768, 4, 4000, 100), (20000, 768, 3, 6000, 400),
    ]
    n_bit = 0
    for n, d, b, c, k in cases:
        embs, rows, out, q = _edge_case(g, dev, n, d, b, c, k)
        for dtype in (torch.float32, torch.bfloat16):
            t = embs.to(dtype)
            got = fused_verify(t, rows, q, k=k, out_ids=out)
            torch.cuda.synchronize()
            err, _ = compare(got, ref.verify_topk_ref(t, rows, q, k=k, out_ids=out))
            if not bool((got[0][-1] == -1).all()):
                raise AssertionError("all-invalid row returned ids")
            worst = max(worst, err)
        for code in ("int8", "int4"):
            if code == "int4" and d % 2:
                continue
            codes, scales = (quant.quantize_rows if code == "int8" else quant.quantize_rows_int4)(embs)
            kw = dict(k=k, out_ids=out, scales=scales, code_dtype=code)
            got = fused_verify(codes, rows, q, **kw)
            torch.cuda.synchronize()
            if not bit_equal(got, ref.verify_topk_ref(codes, rows, q, **kw)):
                raise AssertionError(f"fused_verify {code} differs from its plain version at "
                                     f"{(n, d, b, c, k)}")
            n_bit += 1
        sk = quant.sketch_rows(embs)
        for kk in (k, min(4 * k, 1600)):
            got = sketch_prefilter(sk, rows, q, k=kk, out_ids=out)
            torch.cuda.synchronize()
            if not bit_equal(got, ref.sketch_topk_ref(sk, rows, q, k=kk, out_ids=out)):
                raise AssertionError(f"sketch_prefilter differs from its plain version at "
                                     f"{(n, d, b, c, kk)}")
            n_bit += 1
    log("parity", f"fused_verify float32 + bfloat16 x {len(cases)} shapes: ids equal, max "
        f"|score err| {worst:.3g} (unit-norm rows; rtol 1e-5 / atol 1e-6); fused_verify "
        f"int8 + int4 and sketch_prefilter (k up to 1600): {n_bit} cases bit-equal (ids and "
        "scores) to the plain version")

    n_g = 0
    for c, lp, d, b, p, block_q, kp in [
        (6, 16, 32, 5, 3, 4, 6), (8, 200, 64, 12, 4, 8, 40), (5, 120, 48, 9, 3, 3, 150),
        (4, 1500, 64, 6, 2, 8, 10), (64, 2584, 768, 96, 6, 8, 400),
    ]:
        x = torch.randn((c, lp, d), generator=g, device=dev)
        x[0, 3] = 0
        x[1, 5] = x[1, 2]
        w = torch.arange(1, c + 1, device=dev, dtype=torch.float32) ** -1.3
        cids = torch.stack([torch.multinomial(w, p, generator=g) for _ in range(b)]).int().cpu().numpy()
        sched = build_cluster_schedule(cids, block_q=block_q)
        sc_, sq_ = (torch.from_numpy(a).to(dev) for a in (sched.sched_cids, sched.sched_qids))
        slot = torch.where((sq_ >= 0)[:, :, None], sc_[:, None, None] * lp
                           + torch.arange(lp, device=dev, dtype=torch.int32), -1)
        slot[torch.rand(slot.shape, generator=g, device=dev) < 0.4] = -1
        slot[:, :, : min(lp, 40)] = -1  # a dead leading tile
        slot = slot.to(torch.int32).contiguous()
        q = torch.randn((b, d), generator=g, device=dev)
        for code in ("int8", "int4"):
            codes, scales = (quant.quantize_rows if code == "int8" else quant.quantize_rows_int4)(x)
            args = (codes.contiguous(), scales, q, sc_, sq_, slot)
            got = fused_verify_grouped(*args, kp=kp, code_dtype=code)
            torch.cuda.synchronize()
            want = plain_chunked("fused_verify_grouped", args, {"kp": kp, "code_dtype": code}, 64)
            if not bit_equal(got, want):
                raise AssertionError(f"fused_verify_grouped {code} differs from its plain version "
                                     f"at {(c, lp, d, b, p, block_q, kp)}")
            n_g += 1
    log("parity", f"fused_verify_grouped int8 + int4: {n_g} schedules (padding steps, empty "
        "slots, sparse masks, dead tiles, staging merges) bit-equal to the plain version")
    phase_parity_search(dev)
    return worst


def phase_parity_search(dev) -> None:
    """A small quantized index on the card: a sketch factor covering every
    candidate, and the cluster-major schedule, give the unfiltered search
    bit for bit (the full-width covering k of 80,000 is above the kernels'
    MAX_K, so it is checked here)."""
    from repro_torch.core import lider
    from repro_torch.data import synthetic

    x = synthetic.retrieval_corpus(SEED + 5, 20_000, 768, device=dev)
    q, _ = synthetic.retrieval_queries(SEED + 6, x, 64)
    for sd in ("int8", "int4"):
        p = lider.build_lider(SEED, x, lider.LiderConfig(n_clusters=64, n_probe=4, storage_dtype=sd),
                              device=dev)
        kw = dict(k=10, n_probe=4, r0=4)  # C = 4 * 10 * 40 = 1600 candidates, k' = 40
        base = lider.search_lider(p, q, **kw)
        for extra in ({"sketch_factor": 40}, {"block_q": 8}, {"sketch_factor": 40, "block_q": 8}):
            got = lider.search_lider(p, q, **kw, **extra)
            if not bit_equal((got.ids, got.scores), (base.ids, base.scores)):
                raise AssertionError(f"{sd} search with {extra} differs from the unfiltered search")
        with all_plain():
            plain = lider.search_lider(p, q, **kw, sketch_factor=2, block_q=8)
        kern = lider.search_lider(p, q, **kw, sketch_factor=2, block_q=8)
        compare((kern.ids, kern.scores), (plain.ids, plain.scores))
        del p
    log("parity", "small int8 and int4 indexes (20,000 x 768, c=64): covering sketch_factor "
        "(40 x k' = every candidate), block_q=8 and both == the unfiltered search, bit for bit; "
        "sketch_factor=2 + block_q=8 equal to the all-plain search")


def phase_main(dev) -> dict:
    from repro_torch.configs.lider_msmarco import CONFIG, REDUCED
    from repro_torch.core import lider
    from repro_torch.core.baselines import flat_search
    from repro_torch.core.utils import recall_at_k
    from repro_torch.data import synthetic
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
    # Warm-up, before the counts are reset: it records the arguments of the
    # batch's kernel calls, which phase_shapes times and checks.
    kernel_calls = []
    with recording(kernel_calls):
        search(batches[0])
    torch.cuda.synchronize()
    if [c[0] for c in kernel_calls] != ["fused_verify"] * 2:
        raise AssertionError(f"one search batch made kernel calls {[c[0] for c in kernel_calls]}")

    reset_counts()
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
    counts = read_counts()
    if counts != (2 * N_BATCHES, 0, 0):
        raise AssertionError(f"kernel launches {counts}, expected ({2 * N_BATCHES}, 0, 0)")
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
    log("main", f"{N_BATCHES} x {BATCH} queries at k={k}: fused_verify launches {counts[0]} "
        f"(2 per batch); per-batch latency median {med:.3f} ms (CUDA events; all "
        f"{', '.join(f'{v:.3f}' for v in lat_ms)}), host wall median "
        f"{statistics.median(wall_ms):.3f} ms, {BATCH / med * 1e3:.0f} queries/s")
    log("main", f"recall@{k} vs Flat = {rec:.4f} (floor {RECALL_FLOOR}); Flat {t_flat:.2f} s")
    if rec < RECALL_FLOOR:
        raise AssertionError(f"recall@{k} {rec} below {RECALL_FLOOR}")

    q8 = batches[0][:8]
    with all_plain():
        plain = search(q8)
    kern = search(q8)
    swaps = assert_topk_match(kern.ids, kern.scores, plain.ids, plain.scores)
    log("main", f"first 8 queries: kernel search == plain-version search, ids equal "
        f"({swaps} swaps of near-equal scores admitted)")
    phase_trace("trace", search, batches[1], med)
    return {
        "kernel_calls": kernel_calls, "launches": counts[0], "recall": rec,
        "latency_ms": med, "build_s": t_build, "peak_gib": peak_build / 2**30,
        "corpus": corpus, "queries": queries, "gt": gt.ids, "params": params,
    }


def phase_trace(phase: str, search, qb, batch_ms: float) -> None:
    """Where one batch's time goes: a ``torch.profiler`` trace of one warm
    search call, run after the launch counts were read. The profiler slows
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
        log(phase, "device time not measured: the profiler recorded no device events")
        return
    by_name: dict[str, float] = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    per_kernel = {
        n: sum(v for name, v in by_name.items() if f"{n}_kernel" in name) for n in KERNELS
    }
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    log(phase, f"one profiled batch: device busy {busy / 1e3:.3f} ms over {len(dev)} "
        f"device ops, {busy / 1e3 / batch_ms:.1%} of the unprofiled batch latency "
        f"{batch_ms:.3f} ms (idle {1 - busy / 1e3 / batch_ms:.1%}; traced wall "
        f"{wall_us / 1e3:.3f} ms); "
        + "; ".join(f"{n} {v / 1e3:.3f} ms ({v / busy:.1%})" for n, v in per_kernel.items() if v)
        + "; top: " + "; ".join(f"{n[:60]} {v / 1e3:.3f} ms" for n, v in top))


def bound(name: str, args, kw) -> tuple[float, str]:
    """Least time for the call: each input read once and each output
    written once over the memory rate, or the operations over the peak rate
    of their type, whichever is larger. Rows count once per distinct valid
    row (with their scale on quantized tables), id arrays and queries once.
    Operations: 2d per distinct (query, candidate row) pair for a dot
    product, 2w per pair for a w-word XOR + popcount; for the grouped
    kernel 2d per (slot, candidate row) of the schedule."""
    if name == "fused_verify_grouped":
        embs, _, q, sched_cids, sched_qids, slot_ids = args
        c, lp, d_store = embs.shape
        s_steps, block_q, _ = slot_ids.shape
        real = (sched_qids >= 0).any(dim=1)
        live = (slot_ids >= 0).any(dim=1) & real[:, None]  # (S, Lp) rows any slot needs
        keys = sched_cids.to(torch.int64)[:, None] * lp + torch.arange(lp, device=embs.device)
        rows = int(torch.unique(keys[live]).numel())
        n_bytes = (rows * (d_store + 4) + int(real.sum()) * block_q * lp * 4
                   + (sched_cids.numel() + sched_qids.numel()) * 4 + q.numel() * 4
                   + s_steps * block_q * kw["kp"] * 8)
        ops, peak = 2 * q.shape[1] * int((slot_ids >= 0).sum()), PEAK_OPS[torch.int8]
    else:
        table, row_ids, q = args
        out = kw.get("out_ids")
        out = row_ids if out is None else out
        b, k = q.shape[0], kw["k"]
        valid = out >= 0
        rows = row_ids.to(torch.int64)
        distinct = int(torch.unique(rows[valid]).numel())
        pairs = int(torch.unique(
            (torch.arange(b, device=rows.device)[:, None] * table.shape[0] + rows)[valid]).numel())
        if name == "sketch_prefilter":
            row_bytes, per_pair, peak = table.shape[1] * 4, 2 * table.shape[1], PEAK_OPS[torch.int8]
        elif kw.get("scales") is not None:
            row_bytes, per_pair, peak = table.shape[1] + 4, 2 * q.shape[1], PEAK_OPS[torch.int8]
        else:
            row_bytes = table.shape[1] * table.element_size()
            per_pair, peak = 2 * q.shape[1], PEAK_OPS[table.dtype]
        id_bytes = row_ids.numel() * 4 * (1 if out.data_ptr() == row_ids.data_ptr() else 2)
        n_bytes = distinct * row_bytes + id_bytes + q.numel() * 4 + b * k * 8
        ops = per_pair * pairs
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def plain_chunked(name: str, args, kw, chunk: int):
    """The plain version over the whole call, ``chunk`` query rows (or
    schedule steps) at a time, so its materialization fits the card."""
    plain = plain_fns()[name]
    if name == "fused_verify_grouped":
        embs, rs, q, sc, sq, ss = args
        parts = [plain(embs, rs, q, sc[i : i + chunk], sq[i : i + chunk], ss[i : i + chunk], **kw)
                 for i in range(0, sc.shape[0], chunk)]
    else:
        table, rows, q = args
        out = kw.get("out_ids")
        out = rows if out is None else out
        parts = [plain(table, rows[i : i + chunk], q[i : i + chunk],
                       **dict(kw, out_ids=out[i : i + chunk]))
                 for i in range(0, rows.shape[0], chunk)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def describe(name: str, args, kw) -> dict:
    if name == "fused_verify_grouped":
        embs, _, q, sc, sq, ss = args
        return {"table": kw.get("code_dtype", "int8"), "S": sc.shape[0], "block_q": sq.shape[1],
                "Lp": ss.shape[2], "N": embs.shape[0] * embs.shape[1], "d": q.shape[1],
                "B": q.shape[0], "k": kw["kp"]}
    table, rows, q = args
    kind = ("sketch" if name == "sketch_prefilter" else
            kw.get("code_dtype", "int8") if kw.get("scales") is not None else
            str(table.dtype).removeprefix("torch."))
    return {"table": kind, "B": rows.shape[0], "C": rows.shape[1], "N": table.shape[0],
            "d": q.shape[1], "k": kw["k"]}


def time_call(path: str, role: str, name: str, args, kw, *, reps: int, chunk: int) -> dict:
    """One recorded kernel call: checked against the plain version over the
    whole call (bit-equal on quantized and sketch tables), then the kernel
    and the plain version timed with CUDA events, beside the bound."""
    run = lambda: wrappers()[name](*args, **kw)
    got = run()
    torch.cuda.synchronize()
    want = plain_chunked(name, args, kw, chunk)
    exact = name != "fused_verify" or kw.get("scales") is not None
    if exact:
        if not bit_equal(got, want):
            raise AssertionError(f"{path} {role}: {name} differs from its plain version")
        err, swaps = 0.0, 0
    else:
        err, swaps = compare(got, want)
    ms = cuda_ms(run, reps)
    plain_ms = cuda_ms(lambda: plain_chunked(name, args, kw, chunk), 1)
    bound_ms, bound_by = bound(name, args, kw)
    res = {"kernel": name, "path": path, "call": role, **describe(name, args, kw), "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "max_abs_err": err, "swaps_admitted": swaps, "bit_equal": exact}
    shape = ", ".join(f"{k}={v}" for k, v in describe(name, args, kw).items())
    log("shapes", f"{path} {role}: {name} [{shape}]: "
        + ("ids and scores bit-equal to" if exact else f"ids equal ({swaps} near-tie swaps), max "
           f"|score err| {err:.3g} vs") + f" the plain version over the whole call (chunks of "
        f"{chunk}); kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}, {bound_ms / ms:.1%} of it); no single PyTorch call computes gather + "
        "dedup top-k, so no library time")
    return res


def phase_shapes_f32(main) -> list[dict]:
    """The float main path's two calls, float32 and (the same arguments on
    a bfloat16 copy of the table) bfloat16."""
    res = []
    for dtype in (torch.float32, torch.bfloat16):
        for role, (name, args, kw), reps, chunk in zip(
            ("routing", "in-cluster"), main["kernel_calls"], (20, 5), (256, 8)
        ):
            if dtype == torch.bfloat16:
                args = (args[0].to(torch.bfloat16), *args[1:])
            path = "F32" if dtype == torch.float32 else "BF16 table"
            res.append(time_call(path, role, name, args, kw, reps=reps, chunk=chunk))
            del args
    return res


def _role(name: str, args, kw, first: bool) -> tuple[str, int, int]:
    """(role in the path, timing reps, plain-version chunk) of one recorded
    call; a search's first call is its routing."""
    if name == "sketch_prefilter":
        return "sketch pre-filter", 5, 8
    if name == "fused_verify_grouped":
        return "grouped first pass", 3, 32
    if kw.get("scales") is not None:
        return "first pass", 5, 8 if args[1].shape[1] > 10_000 else 64
    return ("routing" if first else "rescore"), 20, 256


def phase_quantized(dev, main, storage: str, points) -> dict:
    """Build the ``storage`` index at full width, drive each operating point
    in ``points`` over 4 x 256 queries, check it, and time its calls."""
    from repro_torch.configs.lider_msmarco import CONFIG
    from repro_torch.core import lider
    from repro_torch.core.utils import recall_at_k
    from repro_torch.kernels.schedule import build_cluster_schedule
    from repro_torch.testing import assert_topk_match

    cfg = CONFIG.lider
    k = CONFIG.k
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, stats = lider.build_lider(
        SEED, main["corpus"], dataclasses.replace(cfg, storage_dtype=storage),
        return_stats=True, device=dev,
    )
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    b = params.bank
    log("quantized", f"{storage} index: build_lider {t_build:.2f} s; Lp={stats.capacity}, dropped "
        f"{stats.n_dropped}; codes {tuple(b.embs.shape)} {b.embs.dtype}, rescore "
        f"{tuple(b.rescore_embs.shape)}, sketches {tuple(b.sketches.shape)} {b.sketches.dtype}; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    batches = [main["queries"][i * BATCH : (i + 1) * BATCH] for i in range(N_BATCHES)]
    out = {"build_s": t_build, "paths": {}, "calls": []}
    results = {}
    for op in points:
        search = lambda q, op=op: lider.search_lider(
            params, q, k=k, n_probe=cfg.n_probe, r0=cfg.r0, r0_centroid=cfg.r0_centroid,
            **op.search_kwargs(),
        )
        calls = []
        with recording(calls):
            search(batches[0])
        torch.cuda.synchronize()
        reset_counts()
        outs, lat_ms = [], []
        for qb in batches:
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            outs.append(search(qb))
            e.record()
            torch.cuda.synchronize()
            lat_ms.append(s.elapsed_time(e))
        counts = read_counts()
        want = tuple(N_BATCHES * v for v in PER_BATCH[op.name])
        if counts != want:
            raise AssertionError(f"{op.name}: kernel launches {counts}, expected {want}")
        ids = torch.cat([o.ids for o in outs])
        scores = torch.cat([o.scores for o in outs])
        if ids.shape != (N_BATCHES * BATCH, k) or not bool(torch.isfinite(scores).all()):
            raise AssertionError(f"{op.name}: bad result shape {tuple(ids.shape)}")
        rec = float(recall_at_k(ids, main["gt"]))
        med = statistics.median(lat_ms)
        log("quantized", f"{op.name} ({storage}, {op.search_kwargs()}): launches per batch "
            f"fused_verify {counts[0] // N_BATCHES}, sketch_prefilter {counts[1] // N_BATCHES}, "
            f"fused_verify_grouped {counts[2] // N_BATCHES} (as expected); recall@{k} vs Flat "
            f"{rec:.4f} (float32 bank {main['recall']:.4f}; floor {RECALL_FLOOR}); batch latency "
            f"median {med:.3f} ms (all {', '.join(f'{v:.3f}' for v in lat_ms)}), "
            f"{BATCH / med * 1e3:.0f} queries/s")
        if rec < RECALL_FLOOR:
            raise AssertionError(f"{op.name}: recall@{k} {rec} below {RECALL_FLOOR}")
        q8 = batches[0][:8]
        with all_plain():
            plain = search(q8)
        kern = search(q8)
        swaps = assert_topk_match(kern.ids, kern.scores, plain.ids, plain.scores)
        log("quantized", f"{op.name}: first 8 queries == the search with every kernel swapped "
            f"for its plain version ({swaps} near-tie swaps admitted)")
        results[op.name] = (ids, scores)
        out["paths"][op.name] = {"recall": rec, "latency_ms": med, "launches": counts,
                                 "calls": calls, "search": search}
        if op.block_q is not None:
            cids, _ = lider._route_pruned(params, batches[0], n_probe=cfg.n_probe,
                                          r0_centroid=cfg.r0_centroid)
            sched = build_cluster_schedule(cids.cpu().numpy(), block_q=op.block_q)
            log("quantized", f"{op.name} schedule of batch 0: n_pairs {sched.n_pairs}, n_steps "
                f"{sched.n_steps} (padded {sched.n_padded_steps}), sharing ratio "
                f"{sched.sharing_ratio:.3f} pairs per cluster read")
            base = [p.name for p in points if p.block_q is None and p.sketch_factor == op.sketch_factor][0]
            if not bit_equal(results[op.name], results[base]):
                raise AssertionError(f"{op.name} differs from {base}")
            log("quantized", f"{op.name} == {base} over all {N_BATCHES * BATCH} queries, ids and "
                "scores bit for bit")
    for op in points:
        path = out["paths"][op.name]
        for i, (name, args, kw) in enumerate(path.pop("calls")):
            role, reps, chunk = _role(name, args, kw, first=i == 0)
            res = time_call(op.name, role, name, args, kw, reps=reps, chunk=chunk)
            res["launches_per_batch"] = PER_BATCH[op.name][list(KERNELS).index(name)]
            out["calls"].append(res)
    if storage == "int4":
        last = points[-1]
        phase_trace("trace", out["paths"][last.name]["search"], batches[1],
                    out["paths"][last.name]["latency_ms"])
    for p in out["paths"].values():
        p.pop("search")
    del params, b
    return out


def entry(name: str, calls: list[dict], launches: int, main_calls: list[dict]) -> dict:
    """One kernel's JSON entry: ``ms``, ``plain_ms`` and ``bound_ms`` sum
    the kernel's calls in one batch of the path that ``launches`` counts."""
    source, replaces = KERNELS[name]
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches,
        "max_abs_err": max(v["max_abs_err"] for v in calls),
        "ms": sum(v["ms"] for v in main_calls),
        "plain_ms": sum(v["plain_ms"] for v in main_calls),
        "bound_ms": sum(v["bound_ms"] for v in main_calls),
        "bound_by": max(main_calls, key=lambda v: v["bound_ms"])["bound_by"],
        "library_ms": None,
        "calls": calls,
    }


def main() -> int:
    from repro_torch.configs.lider_msmarco import QUANTIZED

    t_start = time.perf_counter()
    device = phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    phase_parity(dev)
    main_res = phase_main(dev)
    f32_calls = phase_shapes_f32(main_res)
    for key in ("kernel_calls", "params"):
        main_res.pop(key)
    gc.collect()
    torch.cuda.empty_cache()
    q8 = phase_quantized(dev, main_res, "int8", [p for p in QUANTIZED if p.storage_dtype == "int8"])
    gc.collect()
    torch.cuda.empty_cache()
    q4 = phase_quantized(dev, main_res, "int4", [p for p in QUANTIZED if p.storage_dtype == "int4"])
    qcalls = q8["calls"] + q4["calls"]
    by = lambda name, path=None: [c for c in qcalls if c["kernel"] == name and (path is None or c["path"] == path)]
    kernels = [
        # fused_verify: the float main path (routing + in-cluster per batch).
        entry("fused_verify", f32_calls + by("fused_verify"), main_res["launches"], f32_calls[:2]),
        # sketch_prefilter: the Q4-sk path (one call per batch).
        entry("sketch_prefilter", by("sketch_prefilter"),
              q4["paths"]["Q4-sk"]["launches"][1], by("sketch_prefilter", "Q4-sk")),
        # fused_verify_grouped: the Q8-cm path (one call per batch).
        entry("fused_verify_grouped", by("fused_verify_grouped"),
              q8["paths"]["Q8-cm"]["launches"][2], by("fused_verify_grouped", "Q8-cm")),
    ]
    log("kernels", f"whole run {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {k: device[k] for k in ("platform", "kind", "count")}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
