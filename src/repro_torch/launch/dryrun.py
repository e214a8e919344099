"""The dry run: every (arch x shape) cell on the production grids, on rank
0 of a fake world, with no card.

The port of the JAX package's ``launch/dryrun.py``. JAX lowers and
compiles each cell's step on the production mesh and reads the compiled
program's memory analysis, cost analysis and collectives. Here a rank runs
its step eagerly, so the dry run runs it: in a :func:`~.mesh.fake_world`
of 256 (or 512) ranks, this process rank 0 of the production grid
(:func:`~.mesh.make_production_grid`), under a ``FakeTensorMode``, the
step of :func:`~.steps.make_bundle` runs once on rank 0's own shards
(``FakeTensor`` s: shapes, dtypes and a device, no memory, no values).
On the way it reads:

- memory: every storage the step makes, live from its first op to its
  last reference (:class:`MemoryTracker`): ``peak_bytes`` is the largest
  sum of live storages with the arguments counted, ``argument_bytes`` the
  rank's shards, ``temp_bytes`` the peak less them, ``output_bytes`` the
  storages the step returns, and ``fits`` whether the peak fits the card
  (:data:`CARD_BYTES`). Memory that no op allocates (the cuBLAS
  workspace, the CUDA context, the caching allocator's rounding) is not
  in it;
- ``cost.flops``: ``torch.utils.flop_counter.FlopCounterMode``'s count of
  the products and attention (the checkpointed layers' recompute
  included; not the hand-written kernels' work, which runs no PyTorch
  product); ``bytes_accessed`` is null (nothing counts it here);
- ``collectives``: per kind, the calls and the bytes the rank sent in,
  from the grid's accounting (``Grid.comm_by_kind``).

An LM cell runs at depths 1 and 2 (:data:`LM_DEPTHS`), and every count
is carried to the model's layers: each layer does the same work, so a
step's memory, FLOPs and collectives are ``a + (L - 1) b``
(``tests/test_torch_dryrun.py`` holds this equal to a run at full depth).
Where the step accumulates micro-batches (an LM train cell), it runs two
of them, and the dry run scales the second's counts to all of them; the
peak is the second's, the steady state. ``loop_factor`` is the
reference's (layers x micro-batches), for the records to compare.

On a PyTorch built with CUDA the fake tensors are CUDA tensors, so the
steps take the card's code paths (and the kernels' wrappers their
shape-only branch); a CPU-only build (no fake CUDA tensor takes Python
indexing there) runs them as CPU tensors. Each record says which
(``device``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun [--mesh single|multi|both]
        [--arch ID] [--shape NAME] [--out experiments/dryrun_torch.json] [--append]

The cells of a grid run side by side, one worker process for each CPU
this process may use (:func:`sweep`).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..configs import ARCHS, get_arch
from . import mesh as mesh_lib
from .steps import arg_tensors, make_bundle, nbytes

# The NVIDIA H100 80GB HBM3's memory as torch.cuda.get_device_properties
# reports it (chip_smoke.py holds the two equal).
CARD_BYTES = 85_017_493_504
CARD_NAME = "NVIDIA H100 80GB HBM3"
# The two depths an LM cell runs at (_run_lm_depths): a step's counts are
# linear in its layers, each layer the same work.
LM_DEPTHS = (1, 2)
MESHES = {"single": ("single_pod_16x16", False), "multi": ("multi_pod_2x16x16", True)}


class MemoryTracker(TorchDispatchMode):
    """Live storage bytes over a run: each storage an op returns counts
    from then until it is freed (a finalizer on its storage object), each
    once however many views share it. ``track`` counts tensors made before
    the run (the arguments)."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._sizes: dict[int, int] = {}

    def track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._sizes:
            return
        n = st.nbytes()
        self._sizes[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.track(t)
        return out


def dry_device() -> torch.device:
    """Fake CUDA tensors where PyTorch is built with CUDA, else CPU ones
    (module docstring)."""
    return torch.device("cuda", 0) if torch.backends.cuda.is_built() else torch.device("cpu")


def _counts(grid, flops) -> dict:
    """The run's counters so far: ``"flops"`` and a ``(kind, "count" |
    "bytes")`` entry for each kind of collective."""
    out = {"flops": flops.get_total_flops()}
    for kind, v in grid.comm_by_kind.items():
        out.update({(kind, f): v[f] for f in ("count", "bytes")})
    return out


def _scaled(marks: list, end: dict, accum: int) -> dict:
    """Counters at the start of the run, as each micro-batch began, and at
    its end -> the whole step's: the second micro-batch's share repeated
    for every micro-batch not run."""
    total = {k: v - marks[0].get(k, 0) for k, v in end.items()}
    if len(marks) >= 3:
        extra = accum - (len(marks) - 1)
        for k in total:
            total[k] += extra * (marks[2].get(k, 0) - marks[1].get(k, 0))
    return total


def run_bundle(bundle, grid) -> dict:
    """Run one bundle's step under the trackers (inside the fake mode the
    bundle was built in) -> the record's measured fields."""
    from torch.utils.flop_counter import FlopCounterMode

    args = arg_tensors(bundle.args)
    mem = MemoryTracker()
    for t in args:
        mem.track(t)
    arg_bytes = mem.live
    with mesh_lib.use_grid(grid), FlopCounterMode(display=False) as flops, mem:
        marks = [_counts(grid, flops)]
        hook = lambda: marks.append(_counts(grid, flops))  # noqa: E731
        bundle.micro_hooks.append(hook)
        try:
            out = bundle.fn(*bundle.args)
        finally:
            bundle.micro_hooks.remove(hook)
        end = _counts(grid, flops)
    total = _scaled(marks, end, bundle.accum)
    seen, out_bytes = set(), 0
    for t in arg_tensors(out):
        key = t.untyped_storage()._cdata
        if key not in seen:
            seen.add(key)
            out_bytes += t.untyped_storage().nbytes()
    return {
        "memory": {"argument_bytes": int(arg_bytes), "output_bytes": int(out_bytes),
                   "temp_bytes": int(mem.peak - arg_bytes), "peak_bytes": int(mem.peak),
                   "fits": bool(mem.peak <= CARD_BYTES)},
        "cost": {"flops": float(total.pop("flops")), "bytes_accessed": None},
        "collectives": {kind: {"count": total[(kind, "count")], "bytes": total[(kind, "bytes")]}
                        for kind, _ in total},
    }


def _run_lm_depths(arch, shape, grid, device, bundle, knobs: dict) -> dict:
    """An LM cell run at the depths of :data:`LM_DEPTHS` and carried to
    its layer count: every count of the run (memory, FLOPs, collectives)
    is ``a + (L - 1) b``, ``b`` a layer's share (the two runs' difference);
    the arguments are the whole model's (``bundle``)."""
    base = knobs.get("cfg") or arch.config
    runs = []
    for k in LM_DEPTHS:
        grid.comm_by_kind.clear()
        cut = make_bundle(arch, shape, grid, device=device,
                          **{**knobs, "cfg": dataclasses.replace(base, n_layers=k)})
        runs.append(run_bundle(cut, grid))
    out = _extrapolate(runs[0], runs[1], base.n_layers - LM_DEPTHS[0])
    m = out["memory"]
    args = nbytes(arg_tensors(bundle.args))
    m["temp_bytes"] = m["peak_bytes"] - args
    m["argument_bytes"] = args
    m["fits"] = bool(m["peak_bytes"] <= CARD_BYTES)
    out["depth"] = {"run": list(LM_DEPTHS), "layers": base.n_layers}
    return out


def _extrapolate(a, b, n: int):
    """``a + n (b - a)`` through nested dicts of numbers (None and bools
    as in ``a``)."""
    if isinstance(a, dict):
        return {k: _extrapolate(v, b[k], n) for k, v in a.items()}
    if a is None or isinstance(a, bool):
        return a
    return type(a)(a + n * (b - a))


def measure(arch, shape, grid, *, device=None, **knobs) -> dict:
    """One cell's measured fields and its bundle's numbers: the step of
    ``make_bundle(arch, shape, grid, **knobs)`` run on rank 0's fake
    shards (an LM's at two depths, :func:`_run_lm_depths`)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    device = torch.device(device) if device is not None else dry_device()
    with FakeTensorMode():
        bundle = make_bundle(arch, shape, grid, device=device, **knobs)
        if arch.family == "lm":
            rec = _run_lm_depths(arch, shape, grid, device, bundle, knobs)
        else:
            grid.comm_by_kind.clear()
            rec = run_bundle(bundle, grid)
    rec["model_flops"] = bundle.model_flops
    rec["loop_factor"] = bundle.loop_factor
    if bundle.accum > 1:
        rec["micro_batches"] = {"step": bundle.accum, "run": bundle.accum_run}
    if bundle.tier_memory is not None:
        rec["tier_memory"] = bundle.tier_memory
    return rec


def run_cell(arch_id: str, shape_name: str, grid, mesh_name: str, *, device=None) -> dict:
    """One cell's record (the reference's keys; module docstring). A
    failure is recorded with its traceback, not raised."""
    arch = get_arch(arch_id)
    device = device or dry_device()
    rec = {"arch": arch_id, "shape": shape_name, "mesh": mesh_name, "n_devices": grid.size,
           "device": device.type}
    if shape_name in arch.skip_shapes:
        rec.update(status="skipped", reason=arch.notes)
        return rec
    t0 = time.perf_counter()
    try:
        rec.update(measure(arch, arch.shape(shape_name), grid, device=device))
        rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        rec["status"] = "failed"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["run_s"] = round(time.perf_counter() - t0, 3)
    return rec


def iter_cells(arch_filter=None, shape_filter=None):
    for arch_id, arch in ARCHS.items():
        if arch_filter and arch_id != arch_filter:
            continue
        for shape in arch.shapes:
            if shape_filter and shape.name != shape_filter:
                continue
            yield arch_id, shape.name


def summary(rec: dict) -> str:
    """One line of a cell's record: argument and peak GiB a rank, whether
    it fits, model and counted FLOPs, collective GB by kind."""
    if rec["status"] != "ok":
        return f"{rec['status']} ({rec.get('error', rec.get('reason', ''))[:120]})"
    m = rec["memory"]
    coll = ", ".join(f"{k} {v['bytes'] / 1e9:.3f} GB x{v['count']}"
                     for k, v in sorted(rec["collectives"].items())) or "none"
    return (f"args {m['argument_bytes'] / 2**30:.3f} GiB, peak {m['peak_bytes'] / 2**30:.3f} GiB"
            f"{'' if m['fits'] else ' (does not fit)'}, model flops {rec['model_flops']:.4g}, "
            f"counted {rec['cost']['flops']:.4g}; {coll}; {rec['run_s']:.1f} s")


_WORKER: dict = {}


def _worker_init(key: str) -> None:
    """A worker process of the sweep: its own fake world and grid (torch
    single-threaded: the cells run side by side)."""
    torch.set_num_threads(1)
    mesh_name, multi = MESHES[key]
    world = mesh_lib.fake_world(512 if multi else 256)
    world.__enter__()  # held in _WORKER for the process's life
    _WORKER.update(world=world, mesh_name=mesh_name,
                   grid=mesh_lib.make_production_grid(multi_pod=multi, device=dry_device()))


def _worker_cell(cell: tuple[str, str]) -> dict:
    return run_cell(*cell, _WORKER["grid"], _WORKER["mesh_name"])


def sweep(mesh_keys, arch_filter=None, shape_filter=None, *, done=(), emit=print,
          on_record=None) -> list[dict]:
    """Run the cells on each named production grid, each grid in a fake
    world of its size; ``done`` holds (arch, shape, mesh) keys to skip.
    The cells of a grid run in one worker process for each CPU this
    process may use, each rank 0 of a fake world of its own (in this
    process where that is one worker, or one cell); the records come back
    in the cells' order either way."""
    results = []
    for key in mesh_keys:
        mesh_name, multi = MESHES[key]
        cells = [c for c in iter_cells(arch_filter, shape_filter) if c + (mesh_name,) not in done]
        jobs = min(len(cells), len(os.sched_getaffinity(0)))

        def report(rec):
            emit(f"{rec['arch']} x {rec['shape']} x {mesh_name}: {summary(rec)}")
            results.append(rec)
            if on_record is not None:
                on_record(rec)

        if jobs > 1:
            import concurrent.futures as cf
            import multiprocessing as mp

            with cf.ProcessPoolExecutor(jobs, mp_context=mp.get_context("spawn"),
                                        initializer=_worker_init, initargs=(key,)) as pool:
                for rec in pool.map(_worker_cell, cells):
                    report(rec)
            continue
        with mesh_lib.fake_world(512 if multi else 256):
            grid = mesh_lib.make_production_grid(multi_pod=multi, device=dry_device())
            for cell in cells:
                report(run_cell(*cell, grid, mesh_name))
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--out", default="experiments/dryrun_torch.json")
    ap.add_argument("--append", action="store_true")
    args = ap.parse_args(argv)

    results = []
    if args.append and os.path.exists(args.out):
        with open(args.out) as f:
            # keep ok/skipped records; failed cells run again
            results = [r for r in json.load(f) if r["status"] in ("ok", "skipped")]
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results}

    def write(rec):
        results.append(rec)
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)

    keys = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    t0 = time.perf_counter()
    sweep(keys, args.arch, args.shape, done=done,
          emit=lambda s: print(f"[dryrun] {s}", flush=True), on_record=write)
    n = {s: sum(r["status"] == s for r in results) for s in ("ok", "skipped", "failed")}
    print(f"[dryrun] done in {time.perf_counter() - t0:.1f} s: {n['ok']} ok, {n['skipped']} "
          f"skipped, {n['failed']} failed -> {args.out}")
    if n["failed"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
