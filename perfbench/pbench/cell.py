"""One run of one cell: set-up, the measured window, the metrics, and the
check that decides ``correct``.

Everything that belongs to one configuration, traffic mix or metric is a
file found by its name in ``BENCHMARK.json``:

- ``configs/<config>.json``: the deployment's sizes and options (the
  file the cell names), with ``reference`` naming its plain reference
  under ``pbench/reference/`` and ``limits`` its file under ``limits/``;
- ``traffic/<traffic>.json``: the load, read by :mod:`.loops`;
- ``metrics/<metric>.py``: a ``read(ctx)`` that returns the metric's value
  from the run's context, or None where it finds nothing to read.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import data, loops
from .trace import Stretch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

# Seeds of the run's inputs, offset from ``--seed``.
CORPUS, BUILD, POOL, ARRIVALS, SAMPLE = 0, 1009, 2003, 3001, 4001


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def load_spec(workload: str, root: Path = ROOT) -> dict:
    """The cell, its configuration, traffic, limits and metric entries."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = json.loads((root / conf["file"]).read_text())
    bench_dir = root / BENCH.name
    traffic = json.loads((bench_dir / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((bench_dir / "limits" / f"{cfg['limits']}.json").read_text())
    applies = lambda m: workload in m.get("workloads", [workload])
    return {
        "cell": cell, "config": cfg, "traffic": traffic, "limits": limits,
        "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
        "per_layer": [m for m in bench["per_layer"] if applies(m)],
    }


def reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"pbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules(names=None) -> list[str]:
    """The forbidden top-level names among ``names`` (default: the modules
    this process has loaded), each compared whole."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(workload: str, seed: int, seconds: float, trace: bool, *, device: torch.device,
        t_start: float, root: Path = ROOT, search_hook=None) -> dict:
    """Run the cell once -> ``{"result": the result line, "checks":
    {name: (value, limit)}, "info": {...}}``.

    ``search_hook(search, env) -> search`` wraps or replaces the timed
    search: tests plant faults with it, and the control puts the reference
    in the program's place. ``env`` holds the run's ``corpus`` (the hook's
    to keep or drop), the built index as ``state``, the ``config``, the
    ``limits``, the ``reference`` module and the ``build_seed``."""
    from . import system  # the program, imported once the allocator is set

    spec = load_spec(workload, root)
    cfg, tr, lim = spec["config"], spec["traffic"], spec["limits"]
    ref = importlib.import_module(f"pbench.reference.{cfg['reference']}")
    n, d, k = cfg["corpus_size"], cfg["dim"], cfg["k"]
    info: dict = {}
    marks = {"start": time.perf_counter() - t_start}  # set-up's stages, for the log

    corpus = data.retrieval_corpus(seed + CORPUS, n, d, spread=cfg["spread"], device=device)
    closed = tr["loop"] == "closed"
    if closed:
        nb, b = tr["pool_batches"], tr["batch"]
        pool = data.retrieval_queries(seed + POOL, corpus, nb * b, noise=cfg["query_noise"])
        pool = pool.reshape(nb, b, d)
    else:
        pool = data.retrieval_queries(seed + POOL, corpus, tr["pool"], noise=cfg["query_noise"])
    _sync(device)
    marks["inputs"] = time.perf_counter() - t_start
    params, stats = system.build(corpus, cfg, seed + BUILD)
    info["build"] = {"indexed": stats.n_indexed, "dropped": stats.n_dropped, "lp": stats.capacity}
    env = None if search_hook is None else {
        "corpus": corpus, "state": system.index_state(params), "config": cfg, "limits": lim,
        "reference": ref, "build_seed": seed + BUILD}
    del corpus
    _sync(device)
    if device.type == "cuda":
        torch.cuda.empty_cache()

    marks["build"] = time.perf_counter() - t_start
    rng = np.random.default_rng(seed + SAMPLE)
    stretch = Stretch(device) if trace else None
    if closed:
        search = system.searcher(params, cfg)
        if search_hook is not None:
            search = search_hook(search, env)
        for _ in range(2):  # the first run captures the batch's graph, the second replays it
            search(pool[0])
        _sync(device)
        keep_n = min(tr["keep_per_batch"], tr["batch"])
        keep_rows = lambda j: torch.from_numpy(
            np.random.default_rng([seed + SAMPLE, j]).choice(tr["batch"], keep_n, replace=False))
    else:
        eng = system.engine(params, cfg, tr)
        if search_hook is not None:
            eng.search_fn = search_hook(eng.search_fn, env)
        eng.warmup()
        pool_np = pool.cpu().numpy()
        n_arr = int(tr["rate"] * seconds * 1.2) + 64
        times, qidx, tidx = data.make_trace(
            seed=seed + ARRIVALS, n_arrivals=n_arr, pool_size=tr["pool"], mean_rate=tr["rate"],
            pattern=tr["pattern"], zipf_a=tr["zipf_a"], n_tenants=tr["tenants"],
            burst_factor=tr.get("burst_factor", 4.0), episode_len=tr.get("episode_len", 64))
        due = times < seconds
        times, qidx = times[due], qidx[due]
        tenants = [f"tenant{t}" for t in tidx[due]]
        keep = set(rng.choice(times.shape[0], min(tr["check_queries"], times.shape[0]),
                              replace=False).tolist())
    env = None
    if stretch is not None:
        stretch.prepare()
    graphs_before = system.query_path_cache_size()
    _sync(device)
    setup_s = time.perf_counter() - t_start
    info["setup_marks"] = {**marks, "warm": setup_s}

    if closed:
        win = loops.closed_loop(search, pool, seconds, k=k, in_flight=tr["in_flight"],
                                keep_rows=keep_rows, stretch=stretch,
                                trace_from=tr["trace_from"], trace_batches=tr["trace_batches"])
    else:
        win = loops.open_loop(eng, pool_np, times, qidx, tenants, keep=keep,
                              answer_of=system.answer_of, stretch=stretch,
                              trace_from_s=max(seconds - tr["trace_seconds"], 0.0))
    _sync(device)
    graphs_after = system.query_path_cache_size()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    log(f"query_path_cache_size before {graphs_before} after {graphs_after}")
    if closed:
        log(f"window: {win['n_batches']} batches in {win['window_s']:.3f} s")
    else:
        ms = lambda a, q: float(np.percentile(a, q)) * 1e3
        late = win["submit"] - win["due"]
        log(f"window: {len(win['drain_s'])} drains, drain p50 {ms(win['drain_s'], 50):.3f} ms "
            f"p95 {ms(win['drain_s'], 95):.3f} ms; submit late p50 {ms(late, 50):.3f} ms "
            f"p95 {ms(late, 95):.3f} ms; answered by {win['window_s']:.3f} s")

    ctx = {"cell": spec["cell"], "config": cfg, "traffic": tr, "seconds": seconds,
           "setup_s": setup_s, "window": win, "closed": closed,
           "trace": stretch.summary() if stretch is not None else None,
           "hand_written": system.hand_written_kernels()}
    if not closed:
        ctx["engine_stats"] = system.engine_counts(eng)

    # The check: the program's state freed but for its index's small arrays.
    state = system.index_state(params)
    if closed:
        del search
    else:
        del eng
    del params
    system.release_graphs()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks, extra = check(ref, state, cfg, tr, lim, seed, device, win, pool, rng, closed)
    info.update(extra)
    info["check_s"] = time.perf_counter() - t_check
    ctx["verify_work"] = extra.get("verify_work")

    metrics = {}
    for m in spec["per_layer" if trace else "end_to_end"]:
        v = reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    if closed:
        attempted, failed = win["n_queries"], 0
    else:
        attempted = win["n_requests"]
        failed = win["refused"] + int(np.isnan(win["answer"]).sum())
    correct = all(v <= lim_ for v, lim_ in checks.values()) and failed == 0
    device_rec = {"platform": "gpu" if device.type == "cuda" else device.type,
                  "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                  "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
              "metrics": metrics, "device": device_rec}
    if trace and ctx["trace"]:
        device_rec["busy_s"] = ctx["trace"]["busy_s"]
        device_rec["window_s"] = ctx["trace"]["window_s"]
        result["breakdown"] = {"device_ops": ctx["trace"]["device_ops"],
                               "idle_gaps": ctx["trace"]["idle_gaps"]}
    result["checks"] = {name: {"value": v, "limit": lim_} for name, (v, lim_) in checks.items()}
    return {"result": result, "checks": checks, "info": info}


def check(ref, state, cfg, tr, lim, seed, device, win, pool, rng, closed):
    """Judge a seeded sample of the window's answers, and the index, against
    the plain reference -> ``({name: (value, limit)}, info)``."""
    n, d, k = cfg["corpus_size"], cfg["dim"], cfg["k"]
    corpus = data.retrieval_corpus(seed + CORPUS, n, d, spread=cfg["spread"], device=device)
    b_seed = seed + BUILD
    proj_c = ref.draw_projections(b_seed + 1, d, cfg["n_arrays_centroid"], cfg["key_len_centroid"],
                                  device)
    proj_b = ref.draw_projections(b_seed + 2, d, cfg["n_arrays"], cfg["key_len"], device)
    info: dict = {}
    t_index = time.perf_counter()
    faults, readings = ref_index(ref).check_index(
        state, cfg, corpus, proj_c, proj_b, b_seed, band_key=lim["band_key"],
        band_dist=lim["band_dist"], pos_tol=lim["pos_tol"], tol_centroid=lim["tol_centroid"])
    info["index_faults"], info["index_readings"] = faults, readings
    info["index_check_s"] = time.perf_counter() - t_index
    log("index faults " + " ".join(f"{s} {c}" for s, c in faults.items()))
    log("index readings " + " ".join(f"{s} {v!r}" for s, v in readings.items()))

    if closed:
        kq, kid, ksc = [], [], []
        for j, rows, ids, sc in win["kept"]:
            kq.append(pool[j % pool.shape[0]][rows.to(pool.device)])
            kid.append(ids)
            ksc.append(sc)
        qs, ids, scs = torch.cat(kq), torch.cat(kid), torch.cat(ksc)
        pick = torch.from_numpy(np.sort(rng.choice(qs.shape[0], min(tr["check_queries"],
                                                                   qs.shape[0]), replace=False)))
        qs, ids, scs = qs[pick.to(qs.device)], ids[pick], scs[pick]
    else:
        order = sorted(win["kept"])
        qs = pool[torch.as_tensor([int(win["qidx"][j]) for j in order], device=pool.device)]
        ids = torch.as_tensor(np.stack([win["kept"][j][0] for j in order]))
        scs = torch.as_tensor(np.stack([win["kept"][j][1] for j in order]))
    ids, scs = ids.to(device), scs.to(device)
    block = max(1, int(lim["judge_bytes"] // (n * 10)))
    agg = {"score_err": 0.0, "topk_gap": float("-inf"), "bad": 0, "foreign": 0, "short": 0,
           "recall": 0.0}
    for s in range(0, qs.shape[0], block):
        sl = slice(s, s + block)
        r = ref.judge(state, cfg, qs[sl], corpus, proj_c, proj_b, ids[sl], scs[sl],
                      band_key=lim["band_key"], band_score=lim["band_score"])
        _fold(agg, r)
    agg["recall"] /= max(qs.shape[0], 1)
    info["judged"] = int(qs.shape[0])
    info["recall_at_k"] = agg["recall"]
    info["answers"] = agg
    log(f"judged {qs.shape[0]} answers: recall@{k} {agg['recall']:.4f}, foreign "
        f"{agg['foreign']}, short {agg['short']}")
    if closed and win["traced"]:
        info["verify_work"] = _verify_work(ref, state, cfg, pool, win["traced"], proj_c, proj_b)
    checks = {
        "score_err": (agg["score_err"], lim["score_err"]),
        "topk_gap": (agg["topk_gap"], lim["topk_gap"]),
        "bad_answers": (agg["bad"], 0),
        "index_faults": (sum(faults.values()), 0),
        "centroids_off": (readings["centroids_off"], lim["centroids_off"]),
    }
    return checks, info


def ref_index(ref):
    return importlib.import_module(ref.__name__ + "_index")


def _fold(acc: dict, r: dict) -> None:
    for key, v in r.items():
        if key not in acc:
            continue
        if key in ("score_err", "topk_gap"):
            acc[key] = max(acc[key], v)
        else:
            acc[key] += v


def _verify_work(ref, state, cfg, pool, traced, proj_c, proj_b) -> dict:
    """The traced batches' verification work, counted on the reference's
    candidates."""
    c, _, lp = state["b_sorted_pos"].shape
    dev = pool.device
    out = {"batches": len(traced), "batch": int(pool.shape[1]), "routing_pairs": 0,
           "incluster_pairs": 0, "routing_rows": 0, "incluster_rows": 0}
    step = max(1, int(2e9 // (c * lp)))
    for j in traced:
        q = pool[j % pool.shape[0]]
        tc = torch.zeros(c, dtype=torch.bool, device=dev)
        tb = torch.zeros(c * lp, dtype=torch.bool, device=dev)
        for s in range(0, q.shape[0], step):
            w = ref.verify_work(state, cfg, q[s:s + step], proj_c, proj_b, tc, tb)
            out["routing_pairs"] += w["routing_pairs"]
            out["incluster_pairs"] += w["incluster_pairs"]
        out["routing_rows"] += int(tc.sum())
        out["incluster_rows"] += int(tb.sum())
    return out
