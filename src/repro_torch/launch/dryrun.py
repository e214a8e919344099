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
On the way it reads, in one dispatch mode (:class:`StepCounter`):

- memory: every storage the step makes, live from its first op to its
  last reference: ``peak_bytes`` is the largest
  sum of live storages with the arguments counted, ``argument_bytes`` the
  rank's shards, ``temp_bytes`` the peak less them, ``output_bytes`` the
  storages the step returns, and ``fits`` whether the peak fits the card
  (:data:`CARD_BYTES`). Memory that no op allocates (the cuBLAS
  workspace, the CUDA context, the caching allocator's rounding) is not
  in it;
- ``cost``: XLA's ``cost_analysis()`` for a program that fuses nothing,
  which is what an eager rank runs. Each dispatched op counts the bytes of
  its tensor operands and of its results (``bytes_accessed``; a gather
  counts its whole source, as XLA's does; an in-place op's tensor is read
  and written) and the FLOPs of ``torch.utils.flop_counter``'s formulas
  (``flops``: products and attention, the checkpointed layers' recompute
  included; elementwise ops count none, where XLA counts one a element).
  Views, metadata and aliasing ops and allocations that read nothing
  (:func:`op_bytes`) count 0, and so does the autograd engine's store of a
  new gradient into ``.grad`` (:data:`GRAD_STORE_OPS`). A kernel wrapper reports its call's
  ``(flops, bytes)`` from shapes alone (``kernels/cost.py``), the same from
  the launch, the plain version and the shape-only branch, and none of its
  own ops counts; a collective of the grid counts its input and output
  once each. The counts cover the whole step as it runs, every layer and
  micro-batch: the reference's count one loop body, which its
  ``loop_factor`` corrects, so a roofline must not multiply these by it;
- ``collectives``: per kind, the calls and the bytes the rank sent in,
  from the grid's accounting (``Grid.comm_by_kind``).

An LM cell runs at depths 1 and 2 (:data:`LM_DEPTHS`), and every count
is carried to the model's layers: each layer does the same work, so a
step's memory, FLOPs, bytes and collectives are ``a + (L - 1) b``
(``tests/test_torch_dryrun.py`` holds this equal to a run at full depth).
Where the step accumulates micro-batches (an LM train cell), it runs
three of them, and the dry run scales the second's counts to all of them
(the first's backward makes the gradients, the others add to them); the
peak is the steady state's. ``loop_factor`` is the
reference's (layers x micro-batches), for the records to compare.

On a PyTorch built with CUDA the fake tensors are CUDA tensors, so the
steps take the card's code paths (and the kernels' wrappers their
shape-only branch); a CPU-only build (no fake CUDA tensor takes Python
indexing there) runs them as CPU tensors. Each record says which
(``device``). :func:`measure` with ``fake=False`` runs the same step on
real tensors (uninitialised, or the caller's): the same ops dispatch, so it
counts the same.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun [--mesh single|multi|both]
        [--arch ID] [--shape NAME] [--out experiments/dryrun_torch.json] [--append]

The cells of a grid run side by side, one worker process for each CPU
this process may use (:func:`sweep`).
"""
from __future__ import annotations

import argparse
import contextlib
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
from .. import counting
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


# Ops that move no data: allocations that read nothing, and aliasing ops
# whose schema does not mark them as views (``OpOverload.is_view`` marks the
# rest: view, expand, t, transpose, permute, slice, select, as_strided, ...).
FREE_OPS = frozenset({
    "aten::_unsafe_view", "aten::lift_fresh", "aten::detach", "aten::alias",
    "aten::empty", "aten::empty_like", "aten::empty_strided", "aten::empty_permuted",
    "aten::new_empty", "aten::new_empty_strided",
})


# The autograd engine storing a new gradient into ``.grad`` takes the tensor,
# or copies it where something else still holds it (a collective's work
# object over gloo, released on its own thread): a matter of timing. XLA's
# program returns a gradient where it made it, so neither counts; adding into
# an existing gradient (the micro-batches' accumulation) does.
GRAD_STORE_OPS = frozenset({"aten::clone", "aten::copy_"})


def _stores_a_gradient(func) -> bool:
    if func._schema.name not in GRAD_STORE_OPS:
        return False
    node = torch._C._current_autograd_node()
    return node is not None and node.name() == "torch::autograd::AccumulateGrad"


def op_bytes(func, args, kwargs, out) -> int:
    """The bytes one op accesses, as XLA counts an unfused instruction: the
    bytes of its tensor operands and of its results; 0 for views, aliasing
    ops, allocations (:data:`FREE_OPS`) and ops that return no tensor
    (metadata: sizes, devices, dtypes)."""
    if func.is_view or func._schema.name in FREE_OPS:
        return 0
    results = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
    if not results:
        return 0
    operands = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
    return sum(t.numel() * t.element_size() for t in operands + results)


class StepCounter(TorchDispatchMode):
    """One pass over a step's ops: live storage bytes (each storage an op
    returns counts from then until it is freed, a finalizer on its storage
    object, each once however many views share it; ``track`` counts
    tensors made before the run, the arguments), and ``flops`` and
    ``bytes_accessed`` (module docstring). Register it with
    ``counting.counting`` to receive the kernels' and collectives'
    reports (:meth:`add`)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.live = 0
        self.peak = 0
        self.flops = 0
        self.bytes_accessed = 0
        self._sizes: dict[int, int] = {}
        self._flop_fns = flop_registry

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

    def add(self, flops: int, nbytes: int) -> None:
        self.flops += flops
        self.bytes_accessed += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.track(t)
        if not counting.is_hidden() and not _stores_a_gradient(func):
            flop_fn = self._flop_fns.get(func._overloadpacket)
            if flop_fn is not None:
                self.flops += flop_fn(*args, **kwargs, out_val=out)
            self.bytes_accessed += op_bytes(func, args, kwargs, out)
        return out


def dry_device() -> torch.device:
    """Fake CUDA tensors where PyTorch is built with CUDA, else CPU ones
    (module docstring)."""
    return torch.device("cuda", 0) if torch.backends.cuda.is_built() else torch.device("cpu")


def _counts(grid, counter: StepCounter) -> dict:
    """The run's counters so far: ``"flops"``, ``"bytes"`` and a ``(kind,
    "count" | "bytes")`` entry for each kind of collective."""
    out = {"flops": counter.flops, "bytes": counter.bytes_accessed}
    for kind, v in grid.comm_by_kind.items():
        out.update({(kind, f): v[f] for f in ("count", "bytes")})
    return out


def _scaled(marks: list, end: dict, accum: int) -> dict:
    """Counters at the start of the run, as each micro-batch began, and at
    its end -> the whole step's: the second micro-batch's share (from its
    start to the third's) repeated for every micro-batch not run."""
    total = {k: v - marks[0].get(k, 0) for k, v in end.items()}
    extra = accum - (len(marks) - 1)
    if len(marks) > 1 and extra:
        for k in total:
            total[k] += extra * (marks[3].get(k, 0) - marks[2].get(k, 0))
    return total


def run_bundle(bundle, grid) -> dict:
    """Run one bundle's step under the counters (inside the fake mode the
    bundle was built in, or on real tensors) -> the record's measured
    fields."""
    args = arg_tensors(bundle.args)
    counter = StepCounter()
    for t in args:
        counter.track(t)
    arg_bytes = counter.live
    with mesh_lib.use_grid(grid), counting.counting(counter), counter:
        marks = [_counts(grid, counter)]
        hook = lambda: marks.append(_counts(grid, counter))  # noqa: E731
        bundle.micro_hooks.append(hook)
        try:
            out = bundle.fn(*bundle.args)
        finally:
            bundle.micro_hooks.remove(hook)
        end = _counts(grid, counter)
    total = _scaled(marks, end, bundle.accum)
    seen, out_bytes = set(), 0
    for t in arg_tensors(out):
        key = t.untyped_storage()._cdata
        if key not in seen:
            seen.add(key)
            out_bytes += t.untyped_storage().nbytes()
    return {
        "memory": {"argument_bytes": int(arg_bytes), "output_bytes": int(out_bytes),
                   "temp_bytes": int(counter.peak - arg_bytes), "peak_bytes": int(counter.peak),
                   "fits": bool(counter.peak <= CARD_BYTES)},
        "cost": {"flops": float(total.pop("flops")), "bytes_accessed": float(total.pop("bytes"))},
        "collectives": {kind: {"count": total[(kind, "count")], "bytes": total[(kind, "bytes")]}
                        for kind, _ in total},
    }


def _run_lm_depths(arch, shape, grid, device, bundle, knobs: dict) -> dict:
    """An LM cell run at the depths of :data:`LM_DEPTHS` and carried to
    its layer count: every count of the run (memory, FLOPs, bytes,
    collectives) is ``a + (L - 1) b``, ``b`` a layer's share (the two runs' difference);
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


def measure(arch, shape, grid, *, device=None, fake: bool = True, args=None,
            **knobs) -> dict:
    """One cell's measured fields and its bundle's numbers: the step of
    ``make_bundle(arch, shape, grid, **knobs)`` run on rank 0's fake
    shards (an LM's at two depths, :func:`_run_lm_depths`).

    With ``fake=False`` the step runs on real tensors on ``device``: the
    caller's ``args`` where given (not for an LM, whose depths are cut),
    else the builders' uninitialised ones (they zero what they index with:
    tokens, ids); the whole cell's bundle is still built fake, for its
    numbers."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    device = torch.device(device) if device is not None else dry_device()
    mode = FakeTensorMode()
    with mode:
        bundle = make_bundle(arch, shape, grid, device=device, **knobs)
    with mode if fake else contextlib.nullcontext():
        if arch.family == "lm":
            rec = _run_lm_depths(arch, shape, grid, device, bundle, knobs)
        else:
            grid.comm_by_kind.clear()
            run = bundle
            if not fake:
                run = (dataclasses.replace(bundle, args=tuple(args)) if args is not None
                       else make_bundle(arch, shape, grid, device=device, **knobs))
            rec = run_bundle(run, grid)
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
    it fits, model and counted FLOPs, bytes accessed, collective GB by
    kind."""
    if rec["status"] != "ok":
        return f"{rec['status']} ({rec.get('error', rec.get('reason', ''))[:120]})"
    m = rec["memory"]
    coll = ", ".join(f"{k} {v['bytes'] / 1e9:.3f} GB x{v['count']}"
                     for k, v in sorted(rec["collectives"].items())) or "none"
    return (f"args {m['argument_bytes'] / 2**30:.3f} GiB, peak {m['peak_bytes'] / 2**30:.3f} GiB"
            f"{'' if m['fits'] else ' (does not fit)'}, model flops {rec['model_flops']:.4g}, "
            f"counted {rec['cost']['flops']:.4g}, bytes accessed {rec['cost']['bytes_accessed']:.4g}; "
            f"{coll}; {rec['run_s']:.1f} s")


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
