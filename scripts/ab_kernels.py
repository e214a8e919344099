#!/usr/bin/env python3
"""Time this checkout's verification kernels and build kernels against
another tree's on the main path's own calls, in turns, in one process:

    python3 scripts/ab_kernels.py OTHER_TREE

OTHER_TREE is another commit unpacked with ``git archive``. Its
``repro_torch`` package is imported under another name (the package's
imports are relative), so its own wrappers launch its own
``fused_verify``, ``sketch_prefilter``, ``fused_verify_grouped``,
``kmeans_assign`` and ``lsh_hash``, built from its sources into
``OTHER_TREE/build/kernels``; a call its wrappers do not take fails as a
Python error. The verification calls are recorded from one batch of 256
queries on each operating point of ``chip_smoke.py`` (F32 on the float32
index, Q8 and Q8-cm on the int8 index, Q4-sk and Q4-sk-cm on the int4
index; the ``lider-msmarco`` configuration at full width, seed 0); the
``kmeans_assign`` call from the float32 build's first k-means step; the
``lsh_hash`` calls from the same build's first bank-fit chunk and its
centroid fit, and from the F32 batch's two query hashes. Each call is timed
other, this, this, other (CUDA events, the mean of ``reps`` calls a turn;
then each tree's kernels' device time from a ``torch.profiler`` trace of 5
calls). The two trees' verification outputs must be bit-equal (ids equal up
to near-tie swaps on float32); their k-means assignments and hash keys may
differ only within float32 rounding of the decision, and each tree's
distances err against float64 at most ``F32_ERROR_FACTOR`` times the plain
version's, and each tree's key bits differ from the plain version's only
within the rounding bound. Prints the card's name and power limit, a line
per call beside its bound (and the per-query or per-step floor, or the
cuBLAS product alone), and one JSON line.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts this tree's src on the path)

SOURCES = ("fused_verify", "sketch_prefilter", "fused_verify_grouped")
BUILD = ("kmeans_assign", "lsh_hash")


def load_other(tree: Path) -> dict:
    """The other tree's three verification wrappers and its build kernels'
    wrappers, their kernels built."""
    import importlib
    import importlib.util

    pkg = tree / "src" / "repro_torch"
    spec = importlib.util.spec_from_file_location(
        "other_repro_torch", pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    sys.modules["other_repro_torch"] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sys.modules["other_repro_torch"])
    importlib.import_module("other_repro_torch.kernels.build").build_all([*SOURCES, *BUILD])
    wrappers = importlib.import_module("other_repro_torch.kernels.fused_verify")
    built = {name: getattr(importlib.import_module(f"other_repro_torch.kernels.{name}"), name)
             for name in BUILD}
    return {**{name: getattr(wrappers, name) for name in SOURCES}, **built}


def record(params, queries, cfg, k, names=SOURCES, **kw) -> list:
    from repro_torch.core import lider

    search = lambda: lider.search_lider(params, queries, k=k, n_probe=cfg.n_probe, r0=cfg.r0,
                                        r0_centroid=cfg.r0_centroid, **kw)
    search()
    calls = []
    keep = lambda name, a, kw_: name in names
    with cs.recording(calls, keep):
        search()
    torch.cuda.synchronize()
    return calls


def time_pair(path: str, role: str, name: str, args, kw, other: dict) -> dict:
    """Other, this, this, other; the outputs held equal."""
    this_fn = cs.wrappers()[name]
    run_other = lambda: other[name](*args, **kw)
    a, b = run_other(), this_fn(*args, **kw)
    torch.cuda.synchronize()
    exact = name != "fused_verify" or kw.get("scales") is not None
    if exact and not cs.bit_equal(a, b):
        raise AssertionError(f"{path} {role}: the two trees' {name} differ")
    if not exact:
        cs.compare(a, b)
    reps = 3 if name == "fused_verify" and args[1].shape[1] > 10_000 and not exact else 10
    times = [cs.cuda_ms(f, reps) for f in (run_other, lambda: this_fn(*args, **kw),
                                           lambda: this_fn(*args, **kw), run_other)]
    dev = [cs.device_ms(name, run_other, other[name]),
           cs.device_ms(name, lambda: this_fn(*args, **kw), this_fn)]
    bound_ms, bound_by = cs.bound(name, args, kw)
    floor = (cs.per_step_floor(args) if name == "fused_verify_grouped"
             else cs.per_query_floor(name, args, kw)[1])
    res = {"path": path, "call": role, "kernel": name, **cs.describe(name, args, kw),
           "other_ms": [times[0], times[3]], "this_ms": [times[1], times[2]],
           "other_device_ms": dev[0], "this_device_ms": dev[1],
           "bound_ms": bound_ms, "bound_by": bound_by, "floor_ms": floor}
    fmt = lambda v: "not measured" if v is None else f"{v:.4f} ms"
    cs.log("ab", f"{path} {role}: {name}: other {times[0]:.4f}, {times[3]:.4f} ms; this "
           f"{times[1]:.4f}, {times[2]:.4f} ms; device time of the kernels: other {fmt(dev[0])}, "
           f"this {fmt(dev[1])}; bound {bound_ms:.4f} ms ({bound_by}), "
           f"{'per-step' if name == 'fused_verify_grouped' else 'per-query'} floor {floor:.4f} ms; "
           "outputs " + ("bit-equal" if exact else "ids equal"))
    return res


def time_kmeans(args, other: dict) -> dict:
    """The first k-means step of the float32 build: other, this, this,
    other; assignments held to the rounding bound, distances to float64."""
    from repro_torch.testing import assignment_flips

    x, cen = args
    this_fn = cs.wrappers()["kmeans_assign"]
    run_other, run_this = (lambda: other["kmeans_assign"](x, cen)), (lambda: this_fn(x, cen))
    a, b = run_other(), run_this()
    torch.cuda.synchronize()
    flips = assignment_flips(x, cen, b[0], a[0])
    want = cs.plain_fns()["kmeans_assign"](x, cen)
    errs = cs.min_dist_errors(x, cen, b, want)
    held = cs.hold_min_dist(errs, "this tree")
    other_errs = cs.min_dist_errors(x, cen, a, want)
    cs.hold_min_dist(other_errs, "the other tree")
    del a, b, want
    times = [cs.cuda_ms(f, 5) for f in (run_other, run_this, run_this, run_other)]
    dev = [cs.device_ms("kmeans_assign", run_other, other["kmeans_assign"]),
           cs.device_ms("kmeans_assign", run_this, this_fn)]
    product, bound_ms, bound_by, shape = cs.build_call_model("kmeans_assign", args, {})
    f32_bound_ms = shape.pop("f32_bound_ms")
    product_ms = cs.cuda_ms(product, 5)
    fmt = lambda v: "not measured" if v is None else f"{v:.4f} ms"
    cs.log("ab", f"F32 k-means step: kmeans_assign [N={shape['N']}, c={shape['c']}, d={shape['d']}]: "
           f"other {times[0]:.4f}, {times[3]:.4f} ms; this {times[1]:.4f}, {times[2]:.4f} ms; device "
           f"time of the kernels: other {fmt(dev[0])}, this {fmt(dev[1])}; cuBLAS product alone "
           f"{product_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}; one float32 product on the "
           f"CUDA cores {f32_bound_ms:.4f} ms); {flips['differ']} of {flips['rows']} "
           f"assignments differ between the trees, each within the rounding bound; this tree's {held}; "
           f"the other tree's max rel err {other_errs['kernel']:.3g}")
    return {"path": "F32", "call": "k-means step", "kernel": "kmeans_assign", **shape,
            "other_ms": [times[0], times[3]], "this_ms": [times[1], times[2]],
            "other_device_ms": dev[0], "this_device_ms": dev[1], "product_ms": product_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "rows_differ": flips["differ"],
            "f64_rel_err": errs, "other_f64_rel_err": other_errs["kernel"]}


def time_hash(path: str, role: str, args, kw, other: dict) -> dict:
    """One recorded ``lsh_hash`` call: other, this, this, other; each tree's
    keys held to the plain version's by ``lsh_key_flips``, and to each
    other."""
    from repro_torch.testing import lsh_key_flips

    x, proj = args
    h, m = kw["n_arrays"], kw["key_len"]
    this_fn = cs.wrappers()["lsh_hash"]
    run_other, run_this = (lambda: other["lsh_hash"](*args, **kw)), (lambda: this_fn(*args, **kw))
    a, b = run_other(), run_this()
    torch.cuda.synchronize()
    want = cs.plain_fns()["lsh_hash"](*args, **kw)
    reps = {"this": lsh_key_flips(x, proj, h, m, b, want), "other": lsh_key_flips(x, proj, h, m, a, want),
            "between": lsh_key_flips(x, proj, h, m, b, a)}
    del a, b, want
    n_reps = 20 if x.shape[0] > 10_000 else 50
    times = [cs.cuda_ms(f, n_reps) for f in (run_other, run_this, run_this, run_other)]
    dev = [cs.device_ms("lsh_hash", run_other, other["lsh_hash"]),
           cs.device_ms("lsh_hash", run_this, this_fn)]
    product, bound_ms, bound_by, shape = cs.build_call_model("lsh_hash", args, kw)
    f32_bound_ms = shape.pop("f32_bound_ms")
    product_ms = cs.cuda_ms(product, n_reps)
    fmt = lambda v: "not measured" if v is None else f"{v:.4f} ms"
    dims = ", ".join(f"{k_}={v}" for k_, v in shape.items())
    cs.log("ab", f"{path} {role}: lsh_hash [{dims}]: other {times[0]:.4f}, {times[3]:.4f} ms; this "
           f"{times[1]:.4f}, {times[2]:.4f} ms; device time of the kernels: other {fmt(dev[0])}, "
           f"this {fmt(dev[1])}; cuBLAS product alone {product_ms:.4f} ms; bound {bound_ms:.4f} ms "
           f"({bound_by}; one float32 product on the CUDA cores {f32_bound_ms:.4f} ms); key bits "
           f"differing from the plain version, each within the rounding bound: this "
           f"{reps['this']['flips']}, other {reps['other']['flips']} of {reps['this']['bits']}; "
           f"between the trees {reps['between']['flips']}")
    return {"path": path, "call": role, "kernel": "lsh_hash", **shape,
            "other_ms": [times[0], times[3]], "this_ms": [times[1], times[2]],
            "other_device_ms": dev[0], "this_device_ms": dev[1], "product_ms": product_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "flips": {k_: v["flips"] for k_, v in reps.items()}}


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("ab_kernels: no CUDA device", file=sys.stderr)
        return 1
    import dataclasses
    import gc

    from repro_torch.configs.lider_msmarco import CONFIG, QUANTIZED
    from repro_torch.core import lider
    from repro_torch.data import synthetic
    from repro_torch.kernels import build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    build.build_all([*SOURCES, *BUILD])
    other = load_other(Path(sys.argv[1]).resolve())
    cfg, k = CONFIG.lider, CONFIG.k
    corpus = synthetic.retrieval_corpus(cs.SEED, CONFIG.corpus_size, CONFIG.dim, device=dev)
    queries, _ = synthetic.retrieval_queries(cs.SEED + 1, corpus, cs.BATCH)
    build_calls, roles = [], set()

    def first_of_role(name, a, kw_):
        role = cs.build_role(name, a, cfg.n_clusters)
        if role is None or role in roles:
            return False
        roles.add(role)
        return True

    with cs.recording(build_calls, first_of_role):
        params = lider.build_lider(cs.SEED, corpus, cfg, device=dev)
    del params
    rows = []
    for name, args, kw in build_calls:
        if name == "kmeans_assign":
            rows.append(time_kmeans(args, other))
        else:
            rows.append(time_hash("build", cs.build_role(name, args, cfg.n_clusters), args, kw, other))
    del build_calls
    for storage, points in (("float32", [("F32", {})]),
                            ("int8", [(p.name, p.search_kwargs()) for p in QUANTIZED
                                      if p.storage_dtype == "int8"]),
                            ("int4", [(p.name, p.search_kwargs()) for p in QUANTIZED
                                      if p.storage_dtype == "int4"])):
        params = lider.build_lider(cs.SEED, corpus, dataclasses.replace(cfg, storage_dtype=storage),
                                   device=dev)
        for path, kw in points:
            if path == "F32":
                hashes = record(params, queries, cfg, k, names=("lsh_hash",), **kw)
                for role, (_, args, ckw) in zip(("query hash (centroids)", "query hash (bank)"), hashes):
                    rows.append(time_hash(path, role, args, ckw, other))
                del hashes
            calls = record(params, queries, cfg, k, **kw)
            first = next(c for c in calls if c[0] == "fused_verify")
            for call in calls:
                name, args, ckw = call
                role = cs._role(name, args, ckw, first=call is first)[0]
                if path == "F32" and call is not first:
                    role = "in-cluster"
                rows.append(time_pair(path, role, name, args, ckw, other))
            del calls
        del params
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"ab": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
