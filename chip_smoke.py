#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of LIDER on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing its lines; any failure exits non-zero:

1. device    — the card's name and power limit (``nvidia-smi``); no CUDA
               device is an error, never a fall-back to the CPU.
2. build     — ``nvcc`` builds every kernel source under ``csrc/``, one
               process per source, all at once; ``cuobjdump -res-usage``
               prints the registers and stack frame of every kernel.
3. parity    — each kernel against its plain version on edge cases
               (duplicates, dead tiles, an all-invalid row, k above the
               valid count, heavy score ties): ``fused_verify`` on float32,
               bfloat16, int8 and packed-int4 tables, ``sketch_prefilter``,
               ``fused_verify_grouped`` on schedules with padding steps,
               empty slots and an id repeated on bit-equal rows, at block_q
               up to 32 and k' up to Lp = 12,288. Quantized and sketch
               kernels must be bit-equal (ids and scores). Then the cases
               that reach the per-query kernels' (query, chunk) split: one
               id repeated across every chunk, a chunk of only invalid ids,
               ties at the k-th score straddling chunk boundaries, C not a
               multiple of the chunk, k = C, k = 6,400 (the large-k path,
               over three chunks and within one), and a LIDER-like
               candidate layout at full width (bit-equal on int8, int4 and
               sketch tables). Then a small quantized index: a covering
               ``sketch_factor`` and the cluster-major schedule give the
               unfiltered search, bit for bit. Then the build kernels:
               ``lsh_hash`` (N off the 64-row block and on both sides of the
               layouts' switch, d in {8, 33, 768, 770}, H=1, M in {1, 10, 16,
               31}; bfloat16 rows, which must hash exactly as their float32
               widening) and ``kmeans_assign`` (N, c and d off its tiles,
               rows off a 16-byte boundary, duplicate centroids in one tile
               and across tiles) within float32
               rounding of their plain versions, k-means distances within
               16 times the plain version's error against float64 (a TF32
               product, run to show the check can fail, must exceed it),
               duplicate-centroid ties exact, and each row's key and
               assignment the same alone, in a large batch and at another
               offset.
4. main      — the ``lider-msmarco`` configuration (1,048,576 x 768
               synthetic corpus, float32 bank): ``build_lider`` through
               both build kernels, three times. The first build of the
               process is the main path's (its launches counted, its
               stages timed, run under ``cProfile``, the arguments of each
               kernel's first call kept); a second, warm build is timed the
               same way and its k-means centroids and assignments must equal
               the first's, bit for bit (the Lloyd sums add each cluster's
               rows in one fixed order); then the Lloyd sums at full size,
               timed beside ``index_add_``; a third build times every
               build-kernel call on its own, beside its plain version and
               the cuBLAS product. Then 4 batches of 256 queries through
               ``search_lider`` at k=100, recall@100 against Flat, the first 8 queries against
               the same search with every kernel swapped for its plain
               version (query keys compared first), launches per batch
               (2 ``fused_verify``, 2 ``lsh_hash``), and a
               ``torch.profiler`` trace of one more batch.
5. shapes    — each kernel call of the main path (the build's and one
               search batch's), on the arguments it was given, held against
               the plain version over the whole call and timed with CUDA
               events beside its bound and its kernels' device time (and,
               for the build kernels, beside the cuBLAS product alone and
               the float32 bound; a hash call also with the bits a cuBLAS
               TF32 product puts outside the rounding bound; for
               ``fused_verify`` and ``sketch_prefilter``, beside the
               per-query floor: the distinct (query, row) pairs read once
               each, and for a
               multi-chunk call its chunks alone, without the final
               merges; for ``fused_verify_grouped``, beside the per-step
               floor: each real step's live rows and ids read once). Then
               the in-cluster shape on traffic without repeated rows
               (float32, int8, sketch), timed the same way.
6. quantized — the float index is freed, then the int8 and the int4 index
               are built at full width in turn, and 4 x 256 queries run on
               each quantized operating point (Q8, Q8-cm on int8; Q4-sk,
               Q4-sk-cm on int4): recall@100, each kernel's launches per
               batch, Q8-cm == Q8 and Q4-sk-cm == Q4-sk bit for bit, the
               first 8 queries against the all-plain search, the schedule's
               sharing, the shapes phase on each path's kernel calls, and a
               trace of one Q8, one Q8-cm and one Q4-sk-cm batch. Then the
               shapes the kernels once refused, at full width: Q8-cm at
               block_q 32, and Q8 and Q8-cm at k' = 1,100, == the per-query
               search bit for bit; the covering sketch factor (m = C =
               80,000) == the unfiltered Q4 search bit for bit; each of
               their grouped and sketch calls timed.
7. lifecycle — ``configs.lider_msmarco.LIFECYCLE`` at full width, the main
               path's centroids frozen and the capacity fixed from the full
               assignment: build on 80%, upsert 20% in 4 batches, equal bit
               for bit to a rebuild over 100% (bank and search ids); delete
               5% with eager compaction, equal to a rebuild over the
               survivors, deleted ids never surfacing; ``save_index`` then
               ``load_index``, every leaf and the search ids identical;
               small int8 and int4 indexes through upsert == rebuild.
8. kernels   — one JSON line with an entry per kernel.

The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import cProfile
import dataclasses
import gc
import json
import math
import pstats
import re
import shutil
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
PEAK_OPS = {  # per second: f32 CUDA cores; tf32, bf16 and int8 tensor cores (dense)
    torch.float32: 67e12, "tf32": 495e12, torch.bfloat16: 989e12, torch.int8: 1979e12,
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
    "lsh_hash": ("src/repro_torch/kernels/csrc/lsh_hash.cu",
                 "src/repro/kernels/lsh_hash.py:27"),
    "kmeans_assign": ("src/repro_torch/kernels/csrc/kmeans_assign.cu",
                      "src/repro/kernels/kmeans_assign.py:27"),
}
BUILD_KERNELS = ("lsh_hash", "kmeans_assign")
# Kernel calls per search batch, in KERNELS order: (fused_verify,
# sketch_prefilter, fused_verify_grouped, lsh_hash, kmeans_assign). Every
# search hashes its queries twice: the centroid model's keys in routing,
# then the bank's in candidate generation. A grouped call is counted as its
# two launches, its score kernel and then its select kernel; a hash call is
# ``lsh_hash.LAUNCHES_PER_CALL`` launches (:func:`per_batch`).
PER_BATCH = {
    "F32": (2, 0, 0, 2, 0),
    "Q8": (3, 0, 0, 2, 0), "Q8-cm": (2, 0, 2, 2, 0),
    "Q4-sk": (3, 1, 0, 2, 0), "Q4-sk-cm": (2, 1, 2, 2, 0),
}


def per_batch(point: str) -> tuple:
    """Launches per search batch of an operating point: ``PER_BATCH`` with
    each hash call counted as ``lsh_hash.LAUNCHES_PER_CALL`` launches."""
    from repro_torch.kernels.lsh_hash import LAUNCHES_PER_CALL

    fv, sk, gr, lsh, km = PER_BATCH[point]
    return (fv, sk, gr, lsh * LAUNCHES_PER_CALL, km)


def hash_launches(calls: int) -> int:
    from repro_torch.kernels.lsh_hash import LAUNCHES_PER_CALL

    return calls * LAUNCHES_PER_CALL


def per_build(cfg, *, kmeans: bool = True) -> tuple:
    """Launches of one ``build_lider``, from the code: k-means runs
    ``kmeans_iters`` Lloyd steps and one final assignment (one
    ``kmeans_assign`` call each, of ``LAUNCHES_PER_CALL`` launches: the
    centroid norms, then the assignment; a build with given centroids
    assigns once); the bank fit hashes ``bank._FIT_CHUNK`` clusters per
    ``lsh_hash`` call, and the centroid model hashes the centroids once
    (``lsh_hash.LAUNCHES_PER_CALL`` launches a call)."""
    from repro_torch.core import bank
    from repro_torch.kernels.kmeans_assign import LAUNCHES_PER_CALL

    n_fit = math.ceil(cfg.n_clusters / bank._FIT_CHUNK)
    return (0, 0, 0, hash_launches(n_fit + 1),
            LAUNCHES_PER_CALL * (cfg.kmeans_iters + 1 if kmeans else 1))


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


def kernel_modules() -> dict:
    from repro_torch.kernels import fused_verify as fv, kmeans_assign as km, lsh_hash as lh

    return {"fused_verify": fv, "sketch_prefilter": fv, "fused_verify_grouped": fv,
            "lsh_hash": lh, "kmeans_assign": km}


def wrappers():
    return {name: getattr(mod, name) for name, mod in kernel_modules().items()}


def reset_counts() -> None:
    for fn in wrappers().values():
        fn.launches = 0


def read_counts() -> tuple[int, ...]:
    return tuple(fn.launches for fn in wrappers().values())


def fmt_counts(counts) -> str:
    return ", ".join(f"{n} {c}" for n, c in zip(KERNELS, counts))


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

    def lsh_hash(x, proj, *, n_arrays, key_len):
        return ref.lsh_hash_ref(x, proj, n_arrays=n_arrays, key_len=key_len)

    def kmeans_assign(x, centroids, chunk=65536):
        parts = [ref.kmeans_assign_ref(x[s : s + chunk], centroids)
                 for s in range(0, x.shape[0], chunk)]
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])

    return {"fused_verify": fused_verify, "sketch_prefilter": sketch_prefilter,
            "fused_verify_grouped": fused_verify_grouped, "lsh_hash": lsh_hash,
            "kmeans_assign": kmeans_assign}


def all_plain():
    """Patch every kernel wrapper with its plain version (ops looks them up
    on their modules at each call)."""
    stack = contextlib.ExitStack()
    plain = plain_fns()
    for name, mod in kernel_modules().items():
        stack.enter_context(mock.patch.object(mod, name, plain[name]))
    return stack


def recording(calls: list, keep=None):
    """Patch ops' view of the wrappers so each kernel call is recorded,
    (name, args, kwargs) (only where ``keep(name, args, kwargs)``, when
    given), and then launched by the real wrapper (whose counter stays
    under its own name)."""
    from repro_torch.kernels import ops

    real = wrappers()

    def rec(name):
        def f(*args, **kw):
            if keep is None or keep(name, args, kw):
                calls.append((name, args, kw))
            return real[name](*args, **kw)
        return f

    stack = contextlib.ExitStack()
    for attr, names in (("_fv", ("fused_verify", "sketch_prefilter", "fused_verify_grouped")),
                        ("_lsh", ("lsh_hash",)), ("_km", ("kmeans_assign",))):
        stack.enter_context(mock.patch.object(
            ops, attr, types.SimpleNamespace(**{n: rec(n) for n in names})))
    return stack


def first_eight(params, search, q8) -> str:
    """The first 8 queries through the search and through the same search
    with every kernel swapped for its plain version. The query keys are
    compared first: a key bit may differ only within float32 rounding of
    0, and every query whose keys agree must return the same ids (up to
    swaps of near-equal scores)."""
    from repro_torch.testing import assert_topk_match, query_key_flips, query_keys

    with all_plain():
        plain = search(q8)
        plain_keys = query_keys(params, q8)
    kern = search(q8)
    same, rep = query_key_flips(params, q8, query_keys(params, q8), plain_keys)
    same = same.to(kern.ids.device)
    swaps = assert_topk_match(kern.ids[same], kern.scores[same], plain.ids[same], plain.scores[same])
    return (f"first 8 queries: keys equal on {int(same.sum())} of 8 ({rep['flips']} of "
            f"{rep['bits']} key bits flipped, each within the rounding bound; {rep['near']} "
            f"near-ties); on those, ids == the all-plain search ({swaps} near-tie swaps admitted)")


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
    for name in KERNELS:
        log("build", f"cuobjdump -res-usage {name}: {res_usage(libs[name])}")
    return secs


def res_usage(lib: Path) -> str:
    """Registers and stack frame of each kernel in a built library, from
    ``cuobjdump -res-usage`` (names demangled by ``c++filt`` where it is
    installed)."""
    from repro_torch.kernels import build

    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    if not tool.exists():
        return "not measured (no cuobjdump)"
    lines = subprocess.run([str(tool), "-res-usage", str(lib)], capture_output=True,
                           text=True).stdout.splitlines()
    rows = []
    for i, line in enumerate(lines[:-1]):
        if "Function " in line and "REG:" in lines[i + 1]:
            fn = line.split("Function ", 1)[1].rstrip(":").strip()
            use = dict(kv.split(":", 1) for kv in lines[i + 1].split() if ":" in kv)
            rows.append((fn, use.get("REG"), use.get("STACK")))
    if shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows), capture_output=True,
                               text=True).stdout.splitlines()
        rows = [(n.replace("(anonymous namespace)::", "").split("(")[0].removeprefix("void "), r, st)
                for n, (_, r, st) in zip(names, rows)]
    return "; ".join(f"{fn} {r} registers, stack {st} B" for fn, r, st in sorted(rows))


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
    for c, lp, d, b, p, block_q, kp, pairs in GROUPED_CASES:
        x = torch.randn((c, lp, d), generator=g, device=dev)
        x[0, 3] = 0
        x[1, 5] = x[1, 2]
        if pairs:
            x[:, 1::2] = x[:, 0::2]
        w = torch.arange(1, c + 1, device=dev, dtype=torch.float32) ** -1.3
        cids = torch.stack([torch.multinomial(w, p, generator=g) for _ in range(b)]).int().cpu().numpy()
        n_steps = build_cluster_schedule(cids, block_q=block_q).n_steps
        sched = build_cluster_schedule(cids, block_q=block_q, pad_to=n_steps + 3)
        sc_, sq_ = (torch.from_numpy(a).to(dev) for a in (sched.sched_cids, sched.sched_qids))
        slot = torch.where((sq_ >= 0)[:, :, None], sc_[:, None, None] * lp
                           + torch.arange(lp, device=dev, dtype=torch.int32), -1)
        slot[torch.rand(slot.shape, generator=g, device=dev) < 0.4] = -1
        slot[:, :, : min(lp, 40)] = -1  # a dead leading tile
        if lp > 5:  # rows 2 and 5 of cluster 1 are bit-equal: one id on both
            slot[sc_ == 1, :, 5] = slot[sc_ == 1, :, 2]
        if pairs:  # every id on two bit-equal rows
            slot[:, :, 1::2] = slot[:, :, 0::2]
        slot = slot.to(torch.int32).contiguous()
        q = torch.randn((b, d), generator=g, device=dev)
        for code in ("int8", "int4") if d % 2 == 0 else ("int8",):
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
        "slots, sparse masks, dead tiles, an id on two bit-equal rows or every id on two; "
        "(block_q, k') in " + ", ".join(f"({bq}, {kp})" for *_, bq, kp, _ in GROUPED_CASES)
        + ") bit-equal to the plain version")
    worst = max(worst, phase_parity_chunks(dev))
    phase_parity_search(dev)
    return max(worst, phase_parity_build(dev))


GROUPED_CASES = [  # (c, Lp, d, B, probes, block_q, k', every id on two rows)
    (6, 16, 32, 5, 3, 4, 6, False), (8, 200, 64, 12, 4, 8, 40, False),
    (5, 120, 48, 9, 3, 3, 150, False), (4, 1500, 64, 6, 2, 8, 10, False),
    (64, 2584, 768, 96, 6, 8, 400, False), (24, 2584, 768, 32, 4, 8, 1100, False),
    (24, 2584, 768, 96, 4, 24, 400, False), (24, 2584, 768, 128, 4, 32, 2048, False),
    (4, 12288, 64, 16, 2, 32, 12288, False), (24, 2584, 768, 32, 4, 8, 400, True),
    (5, 118, 33, 9, 3, 3, 150, False),  # rows of 33 bytes, Lp off a multiple of 4 (int8 only)
    (4, 256, 4096, 40, 2, 32, 100, False),  # wide rows: int8 24 slots a block, 4 ring stages
]


def _chunk_case(g, dev, kind: str, n: int, b: int, c: int):
    """Unit-norm rows (d=768) and candidates that reach the (query, chunk)
    split of ``fused_verify`` and ``sketch_prefilter``."""
    from repro_torch.core.utils import l2_normalize
    from repro_torch.kernels.fused_verify import split_candidates

    embs = l2_normalize(torch.randn((n, 768), generator=g, device=dev))
    rows = torch.randint(0, n, (b, c), generator=g, device=dev, dtype=torch.int32)
    out = rows.clone()
    _, chunk = split_candidates(c)
    if kind == "one id in every chunk":
        rows[:, ::97] = 5
        out = rows.clone()
    elif kind == "a chunk of only invalid ids":
        out[:, chunk : 2 * chunk] = -1
    elif kind == "ties at the k-th score across chunks":
        embs = embs[torch.arange(n, device=dev) % 300]  # ~n/300 ids share each score
    elif kind == "LIDER-like windows":  # 10 windows of 400 over each probed cluster
        lp, size = 2584, 1024
        cid = torch.randint(0, n // lp, (b, c // 4000), generator=g, device=dev)
        pos = torch.randint(0, size, (b, c), generator=g, device=dev)
        rows = (cid.repeat_interleave(4000, dim=1) * lp + pos).to(torch.int32)
        out = rows.clone()
        out[torch.rand((b, c), generator=g, device=dev) < 0.05] = -1
    q = l2_normalize(torch.randn((b, 768), generator=g, device=dev))
    return embs, rows.contiguous(), out.contiguous(), q


CHUNK_CASES = [  # (kind, n, b, c, k); the chunks are split_candidates(c)
    ("one id in every chunk", 20_000, 3, 12_000, 100),
    ("a chunk of only invalid ids", 20_000, 3, 12_000, 400),
    ("ties at the k-th score across chunks", 20_000, 3, 9_001, 100),
    ("C not a multiple of the chunk", 20_000, 3, 80_003, 400),
    ("k = C", 20_000, 3, 4_096, 4_096),
    ("k = C", 20_000, 3, 3_000, 3_000),
    ("k above a chunk's distinct rows", 3_000, 3, 9_000, 4_096),
    ("k above the shared-memory list", 20_000, 3, 12_000, 6_400),
    ("k above C, one chunk", 20_000, 3, 3_000, 6_400),
    ("LIDER-like windows", 1_048_576, 8, 80_000, 400),
]


def phase_parity_chunks(dev) -> float:
    """The per-query kernels' (query, chunk) split against the plain
    versions: quantized and sketch tables bit-equal, float32 ids equal."""
    from repro_torch.kernels import quant, ref
    from repro_torch.kernels.fused_verify import fused_verify, sketch_prefilter, split_candidates

    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    worst, n_bit = 0.0, 0
    for kind, n, b, c, k in CHUNK_CASES:
        embs, rows, out, q = _chunk_case(g, dev, kind, n, b, c)
        got = fused_verify(embs, rows, q, k=k, out_ids=out)
        torch.cuda.synchronize()
        worst = max(worst, compare(got, ref.verify_topk_ref(embs, rows, q, k=k, out_ids=out))[0])
        for code in ("int8", "int4"):
            codes, scales = (quant.quantize_rows if code == "int8" else quant.quantize_rows_int4)(embs)
            kw = dict(k=k, out_ids=out, scales=scales, code_dtype=code)
            got = fused_verify(codes, rows, q, **kw)
            torch.cuda.synchronize()
            if not bit_equal(got, ref.verify_topk_ref(codes, rows, q, **kw)):
                raise AssertionError(f"fused_verify {code} differs from its plain version: {kind}")
            n_bit += 1
        sk = quant.sketch_rows(embs)
        got = sketch_prefilter(sk, rows, q, k=k, out_ids=out)
        torch.cuda.synchronize()
        if not bit_equal(got, ref.sketch_topk_ref(sk, rows, q, k=k, out_ids=out)):
            raise AssertionError(f"sketch_prefilter differs from its plain version: {kind}")
        n_bit += 1
        del embs, rows, out, q
    log("parity", f"(query, chunk) split: {len(CHUNK_CASES)} cases ("
        + "; ".join(f"{kind} C={c} k={k} in {split_candidates(c)[0]} chunks"
                    for kind, _, _, c, k in CHUNK_CASES)
        + f"): int8, int4 and sketch {n_bit} calls bit-equal to the plain version, float32 ids "
        f"equal (max |score err| {worst:.3g})")
    return worst


def phase_parity_search(dev) -> None:
    """A small quantized index on the card: a sketch factor covering every
    candidate, and the cluster-major schedule, give the unfiltered search
    bit for bit. The quantized phase checks the covering factor again at
    full width (m = C = 80,000)."""
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


LSH_CASES = [  # (n, d, H, M, row dtype): N off the 64-row block and on both sides of the
    # layouts' switch at 16,384 rows, d off the 32-deep stage and 16-byte rows, H=1, M in {1, 16, 31}
    (1, 8, 1, 1, torch.float32), (37, 33, 3, 31, torch.float32), (1000, 768, 10, 16, torch.float32),
    (4099, 768, 10, 16, torch.bfloat16), (513, 33, 1, 16, torch.bfloat16),
    (300, 768, 10, 10, torch.float32), (2000, 8, 7, 31, torch.float32), (65, 768, 1, 1, torch.bfloat16),
    (256, 768, 10, 16, torch.float32), (129, 768, 3, 31, torch.float32),
    (17000, 768, 10, 10, torch.float32), (20000, 770, 16, 16, torch.bfloat16),
]
KMEANS_CASES = [  # (n, c, d, offset): N, c and d off every tile and stage; rows 4 bytes off 16
    (1, 1, 8, 0), (257, 7, 33, 0), (1000, 70, 768, 0), (4099, 1, 768, 0), (129, 70, 8, 0),
    (3001, 7, 768, 0), (127, 129, 770, 0), (4099, 1024, 768, 1), (129, 130, 33, 1),
]


def phase_parity_build(dev) -> float:
    """``lsh_hash`` and ``kmeans_assign`` against their plain versions: a
    key bit or an assignment may differ only within float32 rounding of
    the decision (the two sum in other orders); duplicate centroids resolve
    to the first index; each row's result is the same wherever it sits."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.kmeans_assign import kmeans_assign
    from repro_torch.kernels.lsh_hash import lsh_hash
    from repro_torch.testing import assignment_flips, lsh_key_flips

    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    tot = {"bits": 0, "flips": 0, "near": 0}
    for n, d, h, m, dtype in LSH_CASES:
        x = torch.randn((n, d), generator=g, device=dev).to(dtype)
        p = torch.randn((d, h * m), generator=g, device=dev)
        got = lsh_hash(x, p, n_arrays=h, key_len=m)
        torch.cuda.synchronize()
        if got.shape != (n, h) or not bool((got >= 0).all()) or not bool((got < 2**m).all()):
            raise AssertionError(f"lsh_hash keys out of range at {(n, d, h, m)}")
        r = lsh_key_flips(x, p, h, m, got, ref.lsh_hash_ref(x, p, n_arrays=h, key_len=m))
        tot = {k: tot[k] + r[k] for k in tot}
        if dtype == torch.bfloat16 and not torch.equal(lsh_hash(x.float(), p, n_arrays=h, key_len=m), got):
            raise AssertionError(f"bfloat16 rows hash unlike their float32 widening at {(n, d, h, m)}")
    log("parity", f"lsh_hash x {len(LSH_CASES)} cases (float32 + bfloat16 rows): {tot['flips']} of "
        f"{tot['bits']} key bits differ from the plain version ({tot['flips'] / tot['bits'] * 1e6:.2f} "
        f"per million), each within the rounding bound; {tot['near']} bits are near-ties "
        f"({tot['near'] / tot['bits'] * 1e6:.2f} per million); bfloat16 rows hash exactly as their "
        "float32 widening")

    rows = differ = 0
    worst = 0.0
    errs = {"kernel": 0.0, "plain": 0.0, "tf32": 0.0}
    for n, c, d, offset in KMEANS_CASES:
        x = torch.randn((n * d + 4,), generator=g, device=dev)[offset : offset + n * d].view(n, d)
        cen = torch.randn((c, d), generator=g, device=dev)
        dup = c >= 7
        if dup:  # centroids 5, 6 and the last copy 2; row 0 sits on them, row 1 next to them
            cen[5] = cen[2]
            cen[6] = cen[2]
            cen[c - 1] = cen[2]
            x[0] = cen[2]
            x[1] = cen[2] + 1e-3 * torch.randn((d,), generator=g, device=dev)
        got_a, got_d = kmeans_assign(x, cen)
        torch.cuda.synchronize()
        want_a, want_d = plain_fns()["kmeans_assign"](x, cen)
        r = assignment_flips(x, cen, got_a, want_a)
        rows, differ = rows + r["rows"], differ + r["differ"]
        e = min_dist_errors(x, cen, (got_a, got_d), (want_a, want_d))
        errs = {k: max(errs[k], e[k]) for k in errs}
        rest = slice(2, None) if dup else slice(None)
        torch.testing.assert_close(got_d[rest], want_d[rest], rtol=1e-4, atol=1e-4)
        worst = max(worst, float((got_d[rest] - want_d[rest]).abs().max()) if n > 2 else 0.0)
        if dup:
            if got_a[:2].tolist() != [2, 2] or bool(((got_a == 5) | (got_a == 6) | (got_a == c - 1)).any()):
                raise AssertionError("duplicate centroids did not resolve to the first index")
            bnd = d * 2.0**-24 * 4 * float((x[0].double() ** 2).sum())
            if abs(float(got_d[0])) > bnd:  # a distance of 0 computed by cancellation
                raise AssertionError(f"row on a centroid at distance {float(got_d[0])}, bound {bnd}")
    log("parity", f"kmeans_assign x {len(KMEANS_CASES)} cases: {differ} of {rows} assignments "
        f"differ from the plain version ({differ / rows * 1e6:.2f} per million), each a near-tie "
        f"within the rounding bound; min distances allclose (rtol = atol = 1e-4, max |err| "
        f"{worst:.3g}); {hold_min_dist(errs, 'parity')}; duplicate centroids resolve to the first "
        "index")

    x = torch.randn((20000, 768), generator=g, device=dev)
    p = torch.randn((768, 160), generator=g, device=dev)
    cen = torch.randn((1024, 768), generator=g, device=dev)
    keys = lsh_hash(x, p, n_arrays=10, key_len=16)
    a, dd = kmeans_assign(x, cen)
    for s, e in ((0, 1), (12345, 12346), (19999, 20000), (3, 4100), (7000, 20000)):
        sk = lsh_hash(x[s:e].contiguous(), p, n_arrays=10, key_len=16)
        sa, sd = kmeans_assign(x[s:e].contiguous(), cen)
        if not (torch.equal(sk, keys[s:e]) and torch.equal(sa, a[s:e])
                and torch.equal(sd.view(torch.int32), dd[s:e].view(torch.int32))):
            raise AssertionError(f"rows {s}:{e} hash or assign differently from the same rows in a batch")
    log("parity", "row determinism: rows of a 20,000 x 768 batch hashed and assigned alone, at "
        "other offsets and in sub-batches: keys, assignments and distances identical bit for bit")
    return worst


@contextlib.contextmanager
def tf32_products():
    """Let cuBLAS run float32 products on TF32 inputs, to show that the
    float64 distance check tells a TF32 product from a float32 one."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def min_dist_errors(x, cen, got, want) -> dict:
    """Largest relative error against float64 of the (assignment, distance)
    pairs ``got`` (the kernel's) and ``want`` (the plain version's), and of
    the plain version run on TF32 products."""
    from repro_torch.testing import min_dist_error

    with tf32_products():
        tf = plain_fns()["kmeans_assign"](x, cen)
    return {"kernel": min_dist_error(x, cen, *got), "plain": min_dist_error(x, cen, *want),
            "tf32": min_dist_error(x, cen, *tf)}


def hold_min_dist(errs: dict, where: str) -> str:
    """The kernel's distances may err at most ``F32_ERROR_FACTOR`` times the
    plain version's error against float64, and the TF32 product must err
    more than that, or the check could not catch one."""
    from repro_torch.testing import F32_ERROR_FACTOR as f

    lim = f * errs["plain"]
    if errs["kernel"] > lim:
        raise AssertionError(f"{where}: kmeans_assign distances err {errs['kernel']:.3g} against "
                             f"float64, over {f} x the plain version's {errs['plain']:.3g}")
    if errs["tf32"] <= lim:
        raise AssertionError(f"{where}: a TF32 product errs {errs['tf32']:.3g}, within the limit "
                             f"{lim:.3g}: the check cannot tell TF32 from float32")
    return (f"min distances against float64: kernel max rel err {errs['kernel']:.3g}, plain "
            f"{errs['plain']:.3g} (limit {f} x plain = {lim:.3g}), a TF32 product {errs['tf32']:.3g}")


def phase_main(dev) -> dict:
    from repro_torch.configs.lider_msmarco import CONFIG, REDUCED
    from repro_torch.core import lider
    from repro_torch.core.baselines import flat_search
    from repro_torch.core.utils import recall_at_k
    from repro_torch.data import synthetic

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
    build_calls = []
    first = build_counted("main", dev, corpus, cfg, calls=build_calls, profile=True)
    params, stats = first.params, first.stats
    peak_build = torch.cuda.max_memory_allocated()
    warm = build_counted("main", dev, corpus, cfg)
    del warm.params
    log("main", same_builds(first.km, warm.km))
    log("main", lloyd_sums(corpus, first.km.assignment, cfg.n_clusters))
    timed = time_every_build_call(dev, corpus, cfg)
    log("main", f"data {t_data:.2f} s; capacity Lp={stats.capacity}; indexed {stats.n_indexed}, "
        f"dropped {stats.n_dropped}; peak device memory of the first build "
        f"{peak_build / 2**30:.2f} GiB")
    log("main", f"first build_lider of the process {first.secs:.2f} s ({fmt_stages(first)}); warm "
        f"build {warm.secs:.2f} s ({fmt_stages(warm)})")
    log("main", f"first build under cProfile, the functions with most time of their own: {first.top}")
    for name in BUILD_KERNELS:
        mine = [t for t in timed if t["kernel"] == name]
        log("main", f"a third build, every call timed alone: {len(mine)} {name} calls, kernel "
            f"{sum(t['ms'] for t in mine):.3f} ms in all, plain version "
            f"{sum(t['plain_ms'] for t in mine):.3f} ms, cuBLAS product alone "
            f"{sum(t['product_ms'] for t in mine):.3f} ms, bound {sum(t['bound_ms'] for t in mine):.3f} ms"
            f" (one float32 product on the CUDA cores: {sum(t['f32_bound_ms'] for t in mine):.3f} ms)")

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
    order = [c[0] for c in kernel_calls]
    if order != ["lsh_hash", "fused_verify"] * 2:
        raise AssertionError(f"one search batch made kernel calls {order}")

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
    want = tuple(N_BATCHES * v for v in per_batch("F32"))
    if counts != want:
        raise AssertionError(f"kernel launches {counts}, expected {want}")
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
    log("main", f"{N_BATCHES} x {BATCH} queries at k={k}: launches {fmt_counts(counts)} "
        f"({per_batch('F32')} per batch, as the code predicts); per-batch latency median "
        f"{med:.3f} ms (CUDA events; all {', '.join(f'{v:.3f}' for v in lat_ms)}), host wall "
        f"median {statistics.median(wall_ms):.3f} ms, {BATCH / med * 1e3:.0f} queries/s")
    log("main", f"recall@{k} vs Flat = {rec:.4f} (floor {RECALL_FLOOR}); Flat {t_flat:.2f} s")
    if rec < RECALL_FLOOR:
        raise AssertionError(f"recall@{k} {rec} below {RECALL_FLOOR}")

    log("main", first_eight(params, search, batches[0][:8]))
    phase_trace("trace F32", search, batches[1], med)
    return {
        "kernel_calls": kernel_calls, "build_calls": build_calls, "launches": counts,
        "build_launches": first.counts, "build_timed": timed, "recall": rec, "latency_ms": med,
        "peak_gib": peak_build / 2**30, "corpus": corpus, "queries": queries, "gt": gt.ids,
        "params": params, "centroids": params.centroids,
    }


def build_counted(phase: str, dev, corpus, cfg, *, calls=None, profile=False, **kw):
    """``build_lider`` with the launch counts reset just before it and
    checked just after against :func:`per_build`. Returns a namespace: the
    index (``params``, ``stats``), its wall ``secs``, ``stages`` (the
    synchronized seconds of the k-means or the assignment, the bank build,
    the centroid model, and the ``rest`` of the wall), ``counts`` (the
    launches read) and, with ``profile``, ``top``: the functions with the
    most time of their own under ``cProfile``. ``calls`` receives the first
    call of each build-kernel role (k-means step, bank fit, centroid fit)."""
    from repro_torch.core import bank as bank_lib
    from repro_torch.core import lider

    stages, outs = {}, {}

    def timed(mod, attr, key):
        real = getattr(mod, attr)

        def f(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(*a, **k)
            torch.cuda.synchronize()
            stages[key] = stages.get(key, 0.0) + time.perf_counter() - t0
            outs[key] = out
            return out
        return mock.patch.object(mod, attr, f)

    seen = set()

    def keep(name, args, kw_):
        role = build_role(name, args, cfg.n_clusters)
        if role is None or role in seen:
            return False
        seen.add(role)
        return True

    kmeans = kw.get("centroids") is None
    prof = cProfile.Profile() if profile else None
    with contextlib.ExitStack() as stack:
        stack.enter_context(timed(lider, "assign_points", "k-means" if kmeans else "assignment"))
        stack.enter_context(timed(bank_lib, "build_bank", "bank"))
        stack.enter_context(timed(lider, "build_core_model", "centroid model"))
        if calls is not None:
            stack.enter_context(recording(calls, keep))
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if prof is not None:
            prof.enable()
        params, stats = lider.build_lider(SEED, corpus, cfg, return_stats=True, device=dev, **kw)
        torch.cuda.synchronize()
        if prof is not None:
            prof.disable()
        secs = time.perf_counter() - t0
        counts = read_counts()
    stages["rest"] = secs - sum(stages.values())
    want = per_build(cfg, kmeans=kmeans)
    if counts != want:
        raise AssertionError(f"{phase}: one build launched {counts}, expected {want}")
    log(phase, f"one build_lider launched {fmt_counts(counts)}, as the code predicts "
        f"({cfg.kmeans_iters} Lloyd steps + 1 final assignment; ceil({cfg.n_clusters} / "
        "64) bank-fit chunks + 1 centroid-model fit)" if kmeans else
        f"one build_lider (given centroids) launched {fmt_counts(counts)}, as the code predicts")
    return types.SimpleNamespace(params=params, stats=stats, secs=secs, stages=stages,
                                 counts=counts, top=top_functions(prof) if prof else None,
                                 km=outs["k-means" if kmeans else "assignment"])


def same_builds(a, b) -> str:
    """Two builds of the same corpus and seed must reach the same k-means
    result, bit for bit (a kernel fault or a Lloyd sum in atomic order
    would show here); raises otherwise."""
    same_c = same_bits(a.centroids, b.centroids)
    rows = int((a.assignment != b.assignment).sum())
    if same_c and rows == 0:
        return "first and warm build: k-means centroids and assignments identical bit for bit"
    diff = (a.centroids - b.centroids).abs()
    raise AssertionError(
        f"first and warm build differ: {int((diff > 0).any(1).sum())} of {diff.shape[0]} "
        f"centroids (max |diff| {float(diff.max()):.3g}), {rows} of {a.assignment.numel()} "
        "assignments")


def lloyd_sums(x, assignment, n_clusters: int) -> str:
    """The Lloyd step's sums at the main path's shape (the corpus and the
    first build's final assignment): ``clustering.cluster_sums``, which
    adds each cluster's rows in one fixed order (two calls must be equal
    bit for bit), timed beside ``index_add_``, which adds in atomic order
    (two calls compared)."""
    from repro_torch.core import clustering

    idx = assignment.to(torch.int64)
    fixed = lambda: clustering.cluster_sums(x, idx, n_clusters)
    atomic = lambda: torch.zeros((n_clusters, x.shape[1]), dtype=x.dtype,
                                 device=x.device).index_add_(0, idx, x)
    if not same_bits(fixed(), fixed()):
        raise AssertionError("two calls of cluster_sums on the same inputs differ")
    a, b = atomic(), atomic()
    differ = int((a != b).any(1).sum())
    del a, b
    fixed_ms, atomic_ms = cuda_ms(fixed, 5), cuda_ms(atomic, 5)
    return (f"Lloyd sums at N={x.shape[0]}, d={x.shape[1]}, c={n_clusters} (CUDA events, mean of "
            f"5): cluster_sums (index_put_, fixed order) {fixed_ms:.3f} ms, two calls equal bit for "
            f"bit; index_add_ (atomic order) {atomic_ms:.3f} ms, two calls differ in {differ} of "
            f"{n_clusters} clusters")


def fmt_stages(build) -> str:
    return ", ".join(f"{k} {v:.3f} s ({v / build.secs:.1%})" for k, v in build.stages.items())


def top_functions(prof: cProfile.Profile, n: int = 6) -> str:
    rows = sorted(pstats.Stats(prof).stats.items(), key=lambda kv: -kv[1][2])[:n]
    return "; ".join(f"{Path(f).name}:{line}({fn}) {tt:.3f} s own, {ct:.3f} s in all, {nc} calls"
                     for (f, line, fn), (_, nc, tt, ct, _) in rows)


def kernel_pattern(name: str):
    """Device kernels of a wrapper, by name (the grouped call's two kernels
    count as one, and so do ``kmeans_assign``'s norm and assignment
    kernels)."""
    return re.compile(rf"\b{name}(_score|_select|_norms)?_kernel\b")


def device_ms(name: str, run, wrapper, n: int = 5, tries: int = 3) -> float | None:
    """Milliseconds the card spends in ``name``'s kernels per call of
    ``run``, from a ``torch.profiler`` trace of ``n`` calls: the kernel time
    without the host's time to launch it. The trace must hold one device
    event for each launch that ``wrapper``'s count records over those
    calls; one that holds another number is taken again, up to ``tries``
    traces, and then the figure is None (not measured)."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    pat = kernel_pattern(name)
    for _ in range(tries):
        before = wrapper.launches
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                run()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and pat.search(e.name)]
        if us and len(us) == wrapper.launches - before:
            return sum(us) / n / 1e3
    return None


def event_ms(fn):
    """``(fn(), its milliseconds by CUDA events)``: one call, synchronized
    on both sides."""
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    out = fn()
    e.record()
    torch.cuda.synchronize()
    return out, s.elapsed_time(e)


def time_every_build_call(dev, corpus, cfg) -> list[dict]:
    """One more main-path build in which every ``lsh_hash`` and
    ``kmeans_assign`` call is timed on its own with CUDA events, then its
    plain version and the cuBLAS product alone on the same arguments: one
    dict per call, with the call's bound. Two builds ran before, so every
    kernel and library is loaded."""
    from repro_torch.core import lider
    from repro_torch.kernels import ops

    real, plain = wrappers(), plain_fns()
    rows = []

    def timed(name):
        def f(*args, **kw):
            before = real[name].launches
            out, ms = event_ms(lambda: real[name](*args, **kw))
            launches = real[name].launches - before
            _, plain_ms = event_ms(lambda: plain[name](*args, **kw))
            product, bound_ms, bound_by, shape = build_call_model(name, args, kw)
            _, product_ms = event_ms(product)
            rows.append({"kernel": name, "launches": launches, "ms": ms, "plain_ms": plain_ms,
                         "product_ms": product_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                         "f32_bound_ms": shape["f32_bound_ms"]})
            return out
        return f

    with contextlib.ExitStack() as stack:
        for attr, name in (("_lsh", "lsh_hash"), ("_km", "kmeans_assign")):
            stack.enter_context(mock.patch.object(ops, attr, types.SimpleNamespace(**{name: timed(name)})))
        lider.build_lider(SEED, corpus, cfg, device=dev)
    return rows


def build_role(name: str, args, n_clusters: int) -> str | None:
    if name == "kmeans_assign":
        return "k-means step"
    if name == "lsh_hash":
        return "centroid fit" if args[0].shape[0] == n_clusters else "bank fit"
    return None


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
    per_kernel = {n: sum(v for name, v in by_name.items() if kernel_pattern(n).search(name))
                  for n in KERNELS}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    log(phase, f"one profiled batch: device busy {busy / 1e3:.3f} ms over {len(dev)} "
        f"device ops, {busy / 1e3 / batch_ms:.1%} of the unprofiled batch latency "
        f"{batch_ms:.3f} ms (idle {1 - busy / 1e3 / batch_ms:.1%}; traced wall "
        f"{wall_us / 1e3:.3f} ms); "
        + "; ".join(f"{n} {v / 1e3:.3f} ms ({v / busy:.1%})" for n, v in per_kernel.items() if v)
        + "; top: " + "; ".join(f"{n[:60]} {v / 1e3:.3f} ms" for n, v in top))


def verify_counts(name: str, args, kw) -> tuple:
    """What a ``fused_verify`` or ``sketch_prefilter`` call must move:
    ``(distinct valid rows, distinct valid (query, row) pairs, bytes of a
    row (with its scale on quantized tables), bytes of the id arrays,
    queries and outputs, operations per pair, the peak rate of their
    type)``. Operations: 2d per pair for a dot product, 2w per pair for a
    w-word XOR + popcount."""
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
    return distinct, pairs, row_bytes, id_bytes + q.numel() * 4 + b * k * 8, per_pair, peak


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
        distinct, pairs, row_bytes, other_bytes, per_pair, peak = verify_counts(name, args, kw)
        n_bytes, ops = distinct * row_bytes + other_bytes, per_pair * pairs
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def per_query_floor(name: str, args, kw) -> tuple[int, float]:
    """``(pairs, ms)``: the distinct valid (query, row) pairs of a
    ``fused_verify`` or ``sketch_prefilter`` call, and the least time of a
    kernel that loads each pair's row once: those rows' bytes with the id
    arrays, queries and outputs, over the memory rate. ``bound`` counts each
    row once per call, which only a cluster-major schedule approaches."""
    _, pairs, row_bytes, other_bytes, _, _ = verify_counts(name, args, kw)
    return pairs, (pairs * row_bytes + other_bytes) / PEAK_BYTES_PER_S * 1e3


def per_step_floor(args) -> float:
    """Milliseconds a ``fused_verify_grouped`` call must take at least to
    read, for each real step (some slot has a query), its live rows (rows
    some slot has as a candidate) with their scales, and its slot ids, over
    the memory rate: the floor of a kernel that loads each step's rows once
    (``bound`` counts each distinct row once per call)."""
    embs, _, _, _, sched_qids, slot_ids = args
    real = (sched_qids >= 0).any(dim=1)
    live = int(((slot_ids >= 0).any(dim=1) & real[:, None]).sum())
    n_bytes = live * (embs.shape[2] + 4) + int(real.sum()) * slot_ids.shape[1] * slot_ids.shape[2] * 4
    return n_bytes / PEAK_BYTES_PER_S * 1e3


def chunks_alone(args, kw):
    """A multi-chunk call's candidates recast as one chunk per query row,
    (B * n_chunks, chunk) with each query repeated: the same chunk work
    without the final merge of each query's partial lists. None where the
    call is one chunk, C is not a whole number of chunks, or k exceeds a
    chunk (each recast row would write k outputs)."""
    from repro_torch.kernels.fused_verify import split_candidates

    table, rows, q = args
    out = kw.get("out_ids")
    out = rows if out is None else out
    b, c = rows.shape
    n_chunks, chunk = split_candidates(c)
    if n_chunks == 1 or c != n_chunks * chunk or kw["k"] > chunk:
        return None
    return ((table, rows.reshape(b * n_chunks, chunk), q.repeat_interleave(n_chunks, dim=0)),
            dict(kw, out_ids=out.reshape(b * n_chunks, chunk)))


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
    from repro_torch.kernels.fused_verify import split_candidates

    table, rows, q = args
    kind = ("sketch" if name == "sketch_prefilter" else
            kw.get("code_dtype", "int8") if kw.get("scales") is not None else
            str(table.dtype).removeprefix("torch."))
    return {"table": kind, "B": rows.shape[0], "C": rows.shape[1], "N": table.shape[0],
            "d": q.shape[1], "k": kw["k"], "chunks": split_candidates(rows.shape[1])[0]}


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
    dev_ms = device_ms(name, run, wrappers()[name])
    plain_ms = cuda_ms(lambda: plain_chunked(name, args, kw, chunk), 1)
    bound_ms, bound_by = bound(name, args, kw)
    res = {"kernel": name, "path": path, "call": role, **describe(name, args, kw), "ms": ms,
           "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "max_abs_err": err, "swaps_admitted": swaps, "bit_equal": exact}
    floor = ""
    if name == "fused_verify_grouped":
        floor_ms = per_step_floor(args)
        floor = f", per-step floor {floor_ms:.4f} ms ({floor_ms / ms:.1%} of it)"
    else:
        pairs, floor_ms = per_query_floor(name, args, kw)
        floor = (f", per-query floor {floor_ms:.4f} ms ({pairs} distinct (query, row) pairs, "
                 f"{floor_ms / ms:.1%} of it)")
        alone = chunks_alone(args, kw)
        if alone is not None:
            res["chunks_ms"] = cuda_ms(lambda: wrappers()[name](*alone[0], **alone[1]), reps)
            floor += (f"; its chunks alone {res['chunks_ms']:.4f} ms, so the final merges cost "
                      f"~{ms - res['chunks_ms']:.4f} ms")
    shape = ", ".join(f"{k}={v}" for k, v in describe(name, args, kw).items())
    log("shapes", f"{path} {role}: {name} [{shape}]: "
        + ("ids and scores bit-equal to" if exact else f"ids equal ({swaps} near-tie swaps), max "
           f"|score err| {err:.3g} vs") + f" the plain version over the whole call (chunks of "
        f"{chunk}); kernel {ms:.4f} ms (its kernels' device time "
        + ("not measured" if dev_ms is None else f"{dev_ms:.4f} ms") + f"), plain {plain_ms:.3f} ms, "
        f"bound {bound_ms:.4f} ms "
        f"({bound_by}, {bound_ms / ms:.1%} of it){floor}; no single PyTorch call computes "
        "gather + dedup top-k, so no library time")
    return res


def phase_shapes_f32(main) -> list[dict]:
    """The float main path's two calls, float32 and (the same arguments on
    a bfloat16 copy of the table) bfloat16."""
    res = []
    fv_calls = [c for c in main["kernel_calls"] if c[0] == "fused_verify"]
    for dtype in (torch.float32, torch.bfloat16):
        for role, (name, args, kw), reps, chunk in zip(
            ("routing", "in-cluster"), fv_calls, (20, 5), (256, 8)
        ):
            if dtype == torch.bfloat16:
                args = (args[0].to(torch.bfloat16), *args[1:])
            path = "F32" if dtype == torch.float32 else "BF16 table"
            res.append(time_call(path, role, name, args, kw, reps=reps, chunk=chunk))
            del args
    return res


def phase_shapes_distinct(dev) -> None:
    """The in-cluster calls' shape (B=256, C=80,000, N=1,048,576, d=768) on
    traffic without repeats: rows drawn uniformly over N, so a chunk of
    4,000 candidates holds ~3,990 distinct rows where a LIDER chunk holds
    ~730, which fills the kernels' 4,096-slot hash set to ~97%. Each kernel
    is held to its plain version and timed beside its per-query floor,
    which here is about every candidate's row."""
    from repro_torch.core.utils import l2_normalize
    from repro_torch.kernels import quant

    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    n, c, path = 1_048_576, 80_000, "distinct rows"
    embs = l2_normalize(torch.randn((n, 768), generator=g, device=dev))
    rows = torch.randint(0, n, (BATCH, c), generator=g, device=dev, dtype=torch.int32)
    q = l2_normalize(torch.randn((BATCH, 768), generator=g, device=dev))
    time_call(path, "float32", "fused_verify", (embs, rows, q), {"k": 100}, reps=3, chunk=8)
    codes, scales = quant.quantize_rows(embs)
    time_call(path, "int8", "fused_verify", (codes, rows, q),
              {"k": 400, "scales": scales, "code_dtype": "int8"}, reps=5, chunk=8)
    del codes, scales
    time_call(path, "sketch", "sketch_prefilter", (quant.sketch_rows(embs), rows, q), {"k": 1600},
              reps=5, chunk=8)


def build_call_model(name: str, args, kw):
    """``(the cuBLAS product alone, bound ms, bound_by, shape)`` of one
    ``lsh_hash`` or ``kmeans_assign`` call. Bound: the operations the
    kernel's design must do over their peak, or the bytes (rows and P or
    the centroids read once, the int32 keys or the assignment and distance
    written once), whichever is larger. Both kernels run three TF32
    products (split TF32) on the tensor cores, 2 d per output each;
    ``shape["f32_bound_ms"]`` gives one float32 product on the CUDA cores
    beside it."""
    x = args[0]
    n, d = x.shape
    if name == "lsh_hash":
        proj = args[1]
        h, m = kw["n_arrays"], kw["key_len"]
        product = lambda: x.to(torch.float32) @ proj
        n_bytes, ops = x.numel() * x.element_size() + proj.numel() * 4 + n * h * 4, 2 * n * d * h * m
        shape = {"N": n, "d": d, "H": h, "M": m, "rows": str(x.dtype).removeprefix("torch.")}
    else:
        cen = args[1]
        c = cen.shape[0]
        product = lambda: x @ cen.T
        n_bytes, ops = (x.numel() + cen.numel()) * 4 + n * 8, 2 * n * c * d
        shape = {"N": n, "c": c, "d": d}
    t_ops = 3 * ops / PEAK_OPS["tf32"]
    shape["f32_bound_ms"] = max(n_bytes / PEAK_BYTES_PER_S, ops / PEAK_OPS[torch.float32]) * 1e3
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    return product, max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), shape


def time_build_call(path: str, role: str, name: str, args, kw, *, reps: int) -> dict:
    """One recorded ``lsh_hash`` or ``kmeans_assign`` call: held against
    the plain version over the whole call (key bits and assignments may
    differ only within float32 rounding; distances allclose at rtol = atol
    = 1e-4 and within ``F32_ERROR_FACTOR`` times the plain version's error
    against float64), then the kernel, the plain version and the cuBLAS
    product alone (``x @ P``, ``x @ c.T``: no single PyTorch call computes
    hash or assignment, so there is no library time) timed with CUDA
    events, per call, beside the call's bound (:func:`build_call_model`).
    Beside a hash call's flips: how many bits the plain version run on a
    cuBLAS TF32 product puts outside the rounding bound (printed, not
    held: the bound refuses one-pass TF32 at ~2e-7 a bit, so a small call
    may show none; ``tests/test_torch_build_kernels.py`` holds the check
    to refusing it)."""
    from repro_torch.testing import assignment_flips, lsh_bits_outside_bound, lsh_key_flips

    run = lambda: wrappers()[name](*args, **kw)
    plain = lambda: plain_fns()[name](*args, **kw)
    got = run()
    torch.cuda.synchronize()
    want = plain()
    x = args[0]
    product, bound_ms, bound_by, shape = build_call_model(name, args, kw)
    if name == "lsh_hash":
        h, m = kw["n_arrays"], kw["key_len"]
        rep = lsh_key_flips(x, args[1], h, m, got, want)
        with tf32_products():
            tf = plain()
        tf_out = lsh_bits_outside_bound(x, args[1], h, m, tf, want)
        del tf
        err = 0.0
        check = (f"{rep['flips']} of {rep['bits']} key bits differ from the plain version "
                 f"({rep['flips'] / rep['bits'] * 1e6:.2f} per million), each within the rounding "
                 f"bound; {rep['near']} near-ties ({rep['near'] / rep['bits'] * 1e6:.2f} per "
                 f"million); a TF32 product puts {tf_out} bits outside the bound")
        extra = {"bits": rep["bits"], "flips": rep["flips"], "near_ties": rep["near"],
                 "tf32_bits_outside_bound": tf_out}
    else:
        cen = args[1]
        rep = assignment_flips(x, cen, got[0], want[0])
        torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-4)
        err = float((got[1] - want[1]).abs().max())
        errs = min_dist_errors(x, cen, got, want)
        check = (f"{rep['differ']} of {rep['rows']} assignments differ from the plain version "
                 f"({rep['differ'] / rep['rows'] * 1e6:.2f} per million), each a near-tie within the "
                 f"rounding bound; distances allclose (max |err| {err:.3g}); "
                 + hold_min_dist(errs, f"{path} {role}"))
        extra = {"rows_differ": rep["differ"], "f64_rel_err": errs}
    del got, want
    ms = cuda_ms(run, reps)
    dev_ms = device_ms(name, run, wrappers()[name])
    plain_ms = cuda_ms(plain, 1)
    product_ms = cuda_ms(product, reps)
    f32 = f", one float32 product on the CUDA cores {shape.pop('f32_bound_ms'):.4f} ms"
    dims = ", ".join(f"{k}={v}" for k, v in shape.items())
    log("shapes", f"{path} {role}: {name} [{dims}]: "
        f"{check}; per call: kernel {ms:.4f} ms (device time of its kernels "
        f"{'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'}), plain {plain_ms:.3f} ms, "
        f"cuBLAS product alone {product_ms:.4f} ms ({ms / product_ms:.2f} x), bound "
        f"{bound_ms:.4f} ms ({bound_by}, {bound_ms / ms:.1%} of it){f32}")
    return {"kernel": name, "path": path, "call": role, **shape, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "product_ms": product_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err": err, **extra}


def phase_shapes_build(main) -> list[dict]:
    """The build's first call of each role (the k-means step over all N,
    one bank-fit chunk, the centroid-model fit) and one search batch's two
    query hashes."""
    res = []
    reps = {"k-means step": 5, "bank fit": 20, "centroid fit": 50}
    for name, args, kw in main["build_calls"]:
        role = build_role(name, args, main["params"].n_clusters)
        res.append(time_build_call("build", role, name, args, kw, reps=reps[role]))
    hashes = [c for c in main["kernel_calls"] if c[0] == "lsh_hash"]
    for role, (name, args, kw) in zip(("query hash (centroids)", "query hash (bank)"), hashes):
        res.append(time_build_call("F32", role, name, args, kw, reps=50))
    return res


def _role(name: str, args, kw, first: bool) -> tuple[str, int, int]:
    """(role in the path, timing reps, plain-version chunk) of one recorded
    call; a search's first call is its routing."""
    if name == "sketch_prefilter":
        return "sketch pre-filter", 5, 8
    if name == "fused_verify_grouped":
        return "grouped first pass", 10, 32
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

    cfg = CONFIG.lider
    k = CONFIG.k
    torch.cuda.reset_peak_memory_stats()
    built = build_counted("quantized", dev, main["corpus"], dataclasses.replace(cfg, storage_dtype=storage))
    params, stats, t_build = built.params, built.stats, built.secs
    del built
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
        want = tuple(N_BATCHES * v for v in per_batch(op.name))
        if counts != want:
            raise AssertionError(f"{op.name}: kernel launches {counts}, expected {want}")
        ids = torch.cat([o.ids for o in outs])
        scores = torch.cat([o.scores for o in outs])
        if ids.shape != (N_BATCHES * BATCH, k) or not bool(torch.isfinite(scores).all()):
            raise AssertionError(f"{op.name}: bad result shape {tuple(ids.shape)}")
        rec = float(recall_at_k(ids, main["gt"]))
        med = statistics.median(lat_ms)
        log("quantized", f"{op.name} ({storage}, {op.search_kwargs()}): launches per batch "
            f"{fmt_counts(c // N_BATCHES for c in counts)} (as the code predicts); recall@{k} vs Flat "
            f"{rec:.4f} (float32 bank {main['recall']:.4f}; floor {RECALL_FLOOR}); batch latency "
            f"median {med:.3f} ms (all {', '.join(f'{v:.3f}' for v in lat_ms)}), "
            f"{BATCH / med * 1e3:.0f} queries/s")
        if rec < RECALL_FLOOR:
            raise AssertionError(f"{op.name}: recall@{k} {rec} below {RECALL_FLOOR}")
        log("quantized", f"{op.name}: " + first_eight(params, search, batches[0][:8]))
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
    out["calls"] += phase_wide(params, storage, batches, results, out["paths"])
    for op in points:
        path = out["paths"][op.name]
        calls = path.pop("calls")
        hash_roles = iter(("query hash (centroids)", "query hash (bank)"))
        first = next(c for c in calls if c[0] != "lsh_hash")  # the routing call
        for call in calls:
            name, args, kw = call
            if name == "lsh_hash":
                res = time_build_call(op.name, next(hash_roles), name, args, kw, reps=50)
            else:
                role, reps, chunk = _role(name, args, kw, first=call is first)
                res = time_call(op.name, role, name, args, kw, reps=reps, chunk=chunk)
            res["launches_per_batch"] = per_batch(op.name)[list(KERNELS).index(name)]
            out["calls"].append(res)
    for name in ("Q8", "Q8-cm") if storage == "int8" else ("Q4-sk-cm",):
        traced = out["paths"][name]
        phase_trace(f"trace {name}", traced["search"], batches[1], traced["latency_ms"])
    for p in out["paths"].values():
        p.pop("search")
    del params, b
    return out


def phase_wide(params, storage: str, batches, results: dict, paths: dict) -> list[dict]:
    """The shapes the kernels once refused, on the full-width index, each
    search over all ``batches`` and held bit for bit. int8: Q8-cm at
    block_q 32 == Q8, and Q8-cm == Q8 at rescore_factor 11 (k' = 1,100).
    int4: the covering sketch factor (m = C, every candidate of the first
    pass) == the unfiltered Q4 search. The first batch's grouped or sketch
    call of each is timed as the shapes phase times a call."""
    from repro_torch.configs.lider_msmarco import CONFIG
    from repro_torch.core import lider

    cfg, k = CONFIG.lider, CONFIG.k

    def run(**kw):
        """The search over every batch, the first batch's grouped and sketch
        calls, and each kernel's launches per batch, counted in this run."""
        calls = []
        keep = lambda name, a, kw_: name in ("fused_verify_grouped", "sketch_prefilter")
        torch.cuda.synchronize()
        reset_counts()
        with recording(calls, keep):
            outs = [lider.search_lider(params, batches[0], k=k, n_probe=cfg.n_probe, r0=cfg.r0,
                                       r0_centroid=cfg.r0_centroid, **kw)]
        outs += [lider.search_lider(params, qb, k=k, n_probe=cfg.n_probe, r0=cfg.r0,
                                    r0_centroid=cfg.r0_centroid, **kw) for qb in batches[1:]]
        torch.cuda.synchronize()
        counts = dict(zip(KERNELS, read_counts()))
        per_batch = {}
        for name in ("fused_verify_grouped", "sketch_prefilter"):
            # Every batch makes batch 0's calls; a grouped call is two launches.
            want = sum(c[0] == name for c in calls) * (2 if name == "fused_verify_grouped" else 1)
            if counts[name] != want * len(batches):
                raise AssertionError(f"{kw}: {name} launched {counts[name]} times over "
                                     f"{len(batches)} batches, expected {want * len(batches)}")
            per_batch[name] = counts[name] // len(batches)
        return (torch.cat([o.ids for o in outs]), torch.cat([o.scores for o in outs])), calls, per_batch

    def held(name, got, want, base):
        if not bit_equal(got, want):
            raise AssertionError(f"{name} differs from {base}")
        log("quantized", f"{name} == {base} over all {len(batches) * BATCH} queries, ids and "
            "scores bit for bit")

    timed = []
    if storage == "int8":
        got, calls, per_batch = run(block_q=32)
        held("Q8-cm at block_q 32", got, results["Q8"], "Q8")
        timed += [("Q8-cm block_q 32", "grouped first pass", c, per_batch) for c in calls]
        want, _, _ = run(rescore_factor=11)
        got, calls, per_batch = run(rescore_factor=11, block_q=8)
        held("Q8-cm at rescore_factor 11 (k' 1,100)", got, want, "Q8 at rescore_factor 11")
        timed += [("Q8-cm k' 1,100", "grouped first pass", c, per_batch) for c in calls]
    else:
        calls = paths["Q4-sk"]["calls"]
        n_cand = next(c for c in calls if c[0] == "sketch_prefilter")[1][1].shape[1]
        kp = next(c for c in calls if c[0] == "fused_verify" and c[2].get("scales") is not None)[2]["k"]
        factor = -(-n_cand // kp)
        want, _, _ = run()
        got, calls, per_batch = run(sketch_factor=factor)
        held(f"Q4 with the covering sketch_factor {factor} (m = C = {n_cand})", got, want,
             "the unfiltered Q4 search")
        timed += [("Q4 covering sketch", "sketch pre-filter", c, per_batch) for c in calls]
    res = []
    for path, role, (name, args, kw), per_batch in timed:
        res.append(time_call(path, role, name, args, kw, reps=3 if name == "sketch_prefilter" else 10,
                             chunk=8 if name == "sketch_prefilter" else 32))
        res[-1]["launches_per_batch"] = per_batch[name]
    return res


LIFE_BANK = ("sorted_keys", "sorted_pos", "gids", "sizes", "embs", "next_gid")
QUANT_BANK = ("emb_scales", "rescore_embs", "sketches")


def same_bits(a, b) -> bool:
    if a is None or b is None:
        return a is b
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        view = {4: torch.int32, 2: torch.int16}[a.element_size()]
        a, b = a.view(view), b.view(view)
    return torch.equal(a, b)


def mismatched(a, b, fields) -> list[str]:
    return [f for f in fields if not same_bits(getattr(a, f), getattr(b, f))]


def fit_leaves_equal(a, b) -> tuple[int, int]:
    """(fit leaves bit-equal, fit leaves) of two banks: rescale and RMI."""
    pairs = [(getattr(a.rescale, f), getattr(b.rescale, f)) for f in ("key_min", "key_max", "length")]
    pairs += [(getattr(a.rmi, f), getattr(b.rmi, f))
              for f in ("root_w", "root_b", "leaf_w", "leaf_b", "length", "max_err")]
    return sum(same_bits(x, y) for x, y in pairs), len(pairs)


def search_all(params, queries, cfg, k):
    from repro_torch.core import lider

    outs = [lider.search_lider(params, queries[i : i + BATCH], k=k, n_probe=cfg.n_probe,
                               r0=cfg.r0, r0_centroid=cfg.r0_centroid)
            for i in range(0, queries.shape[0], BATCH)]
    return torch.cat([o.ids for o in outs]), torch.cat([o.scores for o in outs])


def phase_lifecycle(dev, main) -> dict:
    """``LIFECYCLE`` at full width: upsert == frozen rebuild, compaction ==
    rebuild over the survivors, deleted ids absent, save/load identical."""
    from repro_torch.configs.lider_msmarco import CONFIG, LIFECYCLE as L
    from repro_torch.core import bank as bank_lib
    from repro_torch.core import clustering, lider, update
    from repro_torch.kernels.kmeans_assign import LAUNCHES_PER_CALL
    from repro_torch.training import checkpoint

    cfg, k = CONFIG.lider, CONFIG.k
    corpus, queries, cen = main["corpus"], main["queries"], main["centroids"]
    n = corpus.shape[0]
    chunks = lambda m: math.ceil(m / bank_lib._FIT_CHUNK)
    torch.cuda.reset_peak_memory_stats()
    assign, _ = clustering.assign_chunked(corpus, cen)
    cap = lider.padded_capacity(
        int(torch.bincount(assign.long(), minlength=cfg.n_clusters).max()), None, cfg.pad_multiple)
    fcfg = dataclasses.replace(cfg, capacity=cap)
    n_base = int(n * (1 - L.update_fraction))
    log("lifecycle", f"{L}: corpus {n} x {corpus.shape[1]}, main-path centroids frozen, capacity "
        f"Lp={cap} from the full assignment; base {n_base} passages")
    base = build_counted("lifecycle", dev, corpus[:n_base], fcfg, centroids=cen)
    up, t_base = base.params, base.secs
    del base

    rates, t_up = [], []
    for i, part in enumerate(torch.tensor_split(corpus[n_base:], L.upsert_batches)):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        up, st = update.upsert(up, part, pad_multiple=cfg.pad_multiple, route=L.route)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = read_counts()
        want = (0, 0, 0, hash_launches(chunks(st.n_refit)), LAUNCHES_PER_CALL)
        if counts != want or st.capacity_grew or st.n_added != part.shape[0]:
            raise AssertionError(f"upsert batch {i}: launches {counts} (expected {want}), {st}")
        t_up.append(dt)
        rates.append(part.shape[0] / dt)
        log("lifecycle", f"upsert batch {i}: {part.shape[0]} passages in {dt:.3f} s = "
            f"{rates[-1]:.0f} passages/s; {st.n_refit} clusters refit; launches {fmt_counts(counts)}")
    rebuilt = build_counted("lifecycle", dev, corpus, fcfg, centroids=cen)
    full, t_full = rebuilt.params, rebuilt.secs
    del rebuilt
    bad = mismatched(up.bank, full.bank, LIFE_BANK)
    if bad:
        raise AssertionError(f"upserted bank differs from the frozen rebuild in {bad}")
    fit_eq = fit_leaves_equal(up.bank, full.bank)
    ids_up, sc_up = search_all(up, queries, cfg, k)
    ids_full, sc_full = search_all(full, queries, cfg, k)
    if not torch.equal(ids_up, ids_full):
        raise AssertionError(f"search ids differ on {int((ids_up != ids_full).any(1).sum())} queries")
    log("lifecycle", f"base build {t_base:.2f} s, upserts {sum(t_up):.3f} s in all, frozen rebuild "
        f"over 100% {t_full:.2f} s: bank {', '.join(LIFE_BANK)} equal bit for bit; fit leaves "
        f"(rescale, RMI) {fit_eq[0]} of {fit_eq[1]} bit-equal; search ids on {ids_up.shape[0]} "
        f"queries equal (scores bit-equal: {same_bits(sc_up, sc_full)})")
    del full

    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    dead = torch.sort(torch.randperm(n, generator=g, device=dev)[: int(n * L.delete_fraction)]).values
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    deleted, dst = update.delete(up, dead, refit_threshold=L.refit_threshold)
    torch.cuda.synchronize()
    t_delete = time.perf_counter() - t0
    counts = read_counts()
    if counts != (0, 0, 0, hash_launches(chunks(dst.n_refit)), 0) or dst.n_deleted != dead.numel():
        raise AssertionError(f"delete: launches {counts}, {dst}")
    del up
    ids_del, _ = search_all(deleted, queries, cfg, k)
    if bool(torch.isin(ids_del, dead.to(ids_del.dtype)).any()):
        raise AssertionError("a deleted id surfaced")
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    alive[dead] = False
    surv = torch.nonzero(alive)[:, 0]
    rebuilt = build_counted("lifecycle", dev, corpus[surv], fcfg, centroids=cen).params
    rb = rebuilt.bank
    mapped = torch.where(rb.gids >= 0, surv[rb.gids.clamp(min=0).long()].to(torch.int32), -1)
    # Rows compare by value: a fresh pack zeroes its pad slots by a multiply
    # (-0.0 where corpus row 0 is negative), compaction by a select (+0.0),
    # as in the JAX package; every other field compares bit for bit.
    bad = [f for f in ("sorted_keys", "sorted_pos", "sizes")
           if not same_bits(getattr(deleted.bank, f), getattr(rb, f))]
    bad += [] if torch.equal(deleted.bank.embs, rb.embs) else ["embs"]
    if bad or not torch.equal(deleted.bank.gids, mapped) or int(deleted.bank.tombstones.sum()):
        raise AssertionError(f"compacted bank differs from the rebuild over the survivors: {bad}")
    ids_rb, _ = search_all(rebuilt, queries, cfg, k)
    ids_rb = torch.where(ids_rb >= 0, surv[ids_rb.clamp(min=0).long()].to(torch.int32), -1)
    if not torch.equal(ids_del, ids_rb):
        raise AssertionError("search after compaction differs from the rebuild over the survivors")
    fit_eq = fit_leaves_equal(deleted.bank, rb)
    log("lifecycle", f"delete {dead.numel()} ids ({L.delete_fraction:.0%}, refit_threshold "
        f"{L.refit_threshold}): {t_delete:.3f} s with {dst.n_refit} clusters compacted and refit; "
        f"launches {fmt_counts(counts)}; no deleted id in {ids_del.shape[0]} searches; bank equals "
        f"a frozen rebuild over the {surv.numel()} survivors (keys, positions, sizes bit for bit, "
        f"rows in value, gids mapped back; fit leaves "
        f"{fit_eq[0]} of {fit_eq[1]} bit-equal), search ids equal")
    del rebuilt, rb

    d = ROOT / "build" / "lifecycle_index"
    shutil.rmtree(d, ignore_errors=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.save_index(str(d), deleted)
    t_save = time.perf_counter() - t0
    size = sum(f.stat().st_size for f in (d / "index").iterdir())
    t0 = time.perf_counter()
    loaded = checkpoint.load_index(str(d), device=dev)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    leaves = checkpoint.index_leaves(deleted)
    bad = [name for (name, a), (_, b) in zip(leaves, checkpoint.index_leaves(loaded))
           if not same_bits(a, b)]
    ids_ld, _ = search_all(loaded, queries, cfg, k)
    if bad or not torch.equal(ids_ld, ids_del):
        raise AssertionError(f"save/load changed leaves {bad} or the search ids")
    shutil.rmtree(d, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log("lifecycle", f"save_index {t_save:.2f} s ({size / 1e9:.2f} GB on disk), load_index "
        f"{t_load:.2f} s: all {len(leaves)} leaves identical, search ids identical; peak device "
        f"memory of the phase {peak:.2f} GiB")
    del loaded, deleted
    small = phase_lifecycle_small(dev)
    return {"upsert_per_s": rates, "upsert_s": t_up, "delete_s": t_delete, "save_s": t_save,
            "load_s": t_load, "peak_gib": peak, "small": small}


def phase_lifecycle_small(dev) -> list[str]:
    """Small int8 and int4 indexes (20,000 x 768, c=64): build(80%) +
    upsert(20%, two batches) == a frozen rebuild over 100%, bit for bit."""
    from repro_torch.core import clustering, lider, update
    from repro_torch.data import synthetic

    x = synthetic.retrieval_corpus(SEED + 5, 20_000, 768, device=dev)
    q, _ = synthetic.retrieval_queries(SEED + 6, x, 64)
    n_base = 16_000
    km = clustering.kmeans(torch.Generator(device=dev).manual_seed(SEED), x[:n_base], 64, iters=10)
    assign, _ = clustering.assign_chunked(x, km.centroids)
    cap = lider.padded_capacity(int(torch.bincount(assign.long(), minlength=64).max()), None, 8)
    done = []
    for sd in ("int8", "int4"):
        cfg = lider.LiderConfig(n_clusters=64, n_probe=4, capacity=cap, storage_dtype=sd)
        up = lider.build_lider(SEED, x[:n_base], cfg, centroids=km.centroids, device=dev)
        for part in torch.tensor_split(x[n_base:], 2):
            up, _ = update.upsert(up, part)
        full = lider.build_lider(SEED, x, cfg, centroids=km.centroids, device=dev)
        bad = mismatched(up.bank, full.bank, LIFE_BANK + QUANT_BANK)
        a = lider.search_lider(up, q, k=10, n_probe=4)
        b = lider.search_lider(full, q, k=10, n_probe=4)
        if bad or not torch.equal(a.ids, b.ids):
            raise AssertionError(f"{sd}: upsert differs from the rebuild in {bad} or the search ids")
        done.append(sd)
    log("lifecycle", "small int8 and int4 indexes (20,000 x 768, c=64): build(80%) + upsert(20%, "
        "2 batches) == the frozen rebuild over 100%: codes, scales, rescore rows, sketches, keys, "
        "positions, gids bit for bit; search ids equal")
    return done


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


def build_entry(name: str, calls: list[dict], launches: int, timed: list[dict]) -> dict:
    """A build kernel's JSON entry over one main-path build: ``launches``
    is the count read around the main path's (first) build; ``ms``,
    ``plain_ms``, ``product_ms`` and ``bound_ms`` sum every call of the
    build that times each call alone (:func:`time_every_build_call`),
    which must launch as often as the main path's build."""
    source, replaces = KERNELS[name]
    mine = [t for t in timed if t["kernel"] == name]
    if sum(t["launches"] for t in mine) != launches:
        raise AssertionError(f"{name}: the timed build made {sum(t['launches'] for t in mine)} "
                             f"launches in {len(mine)} calls, the main build {launches}")
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches,
        "max_abs_err": max(v["max_abs_err"] for v in calls),
        "ms": sum(t["ms"] for t in mine),
        "plain_ms": sum(t["plain_ms"] for t in mine),
        "bound_ms": sum(t["bound_ms"] for t in mine),
        "bound_by": max(mine, key=lambda t: t["bound_ms"])["bound_by"],
        "library_ms": None,
        "product_ms": sum(t["product_ms"] for t in mine),
        "calls": calls,
    }


def main() -> int:
    from repro_torch.configs.lider_msmarco import CONFIG, QUANTIZED

    t_start = time.perf_counter()
    device = phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    phase_parity(dev)
    main_res = phase_main(dev)
    f32_calls = phase_shapes_f32(main_res)
    build_calls = phase_shapes_build(main_res)
    phase_shapes_distinct(dev)
    for key in ("kernel_calls", "build_calls", "params"):
        main_res.pop(key)
    gc.collect()
    torch.cuda.empty_cache()
    q8 = phase_quantized(dev, main_res, "int8", [p for p in QUANTIZED if p.storage_dtype == "int8"])
    gc.collect()
    torch.cuda.empty_cache()
    q4 = phase_quantized(dev, main_res, "int4", [p for p in QUANTIZED if p.storage_dtype == "int4"])
    gc.collect()
    torch.cuda.empty_cache()
    phase_lifecycle(dev, main_res)
    qcalls = q8["calls"] + q4["calls"]
    by = lambda name, path=None: [c for c in qcalls if c["kernel"] == name and (path is None or c["path"] == path)]
    cfg = CONFIG.lider
    counts, timed = main_res["build_launches"], main_res["build_timed"]
    kernels = [
        # fused_verify: the float main path (routing + in-cluster per batch).
        entry("fused_verify", f32_calls + by("fused_verify"), main_res["launches"][0], f32_calls[:2]),
        # sketch_prefilter: the Q4-sk path (one call per batch).
        entry("sketch_prefilter", by("sketch_prefilter"),
              q4["paths"]["Q4-sk"]["launches"][1], by("sketch_prefilter", "Q4-sk")),
        # fused_verify_grouped: the Q8-cm path (one call per batch).
        entry("fused_verify_grouped", by("fused_verify_grouped"),
              q8["paths"]["Q8-cm"]["launches"][2], by("fused_verify_grouped", "Q8-cm")),
        # lsh_hash: the main build (bank-fit chunks + the centroid model).
        build_entry("lsh_hash", [c for c in build_calls if c["kernel"] == "lsh_hash"] + by("lsh_hash"),
                    counts[3], timed),
        # kmeans_assign: the main build's k-means (Lloyd steps + the final assignment).
        build_entry("kmeans_assign", [c for c in build_calls if c["kernel"] == "kmeans_assign"],
                    counts[4], timed),
    ]
    log("kernels", f"whole run {time.perf_counter() - t_start:.1f} s ({cfg.n_clusters} clusters: "
        f"{counts[3]} lsh_hash and {counts[4]} kmeans_assign launches in the main build)")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {k: device[k] for k in ("platform", "kind", "count")}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
