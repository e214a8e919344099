"""The process grid: named axes over a ``torch.distributed`` world.

The JAX package lays a distributed index over a mesh of devices
(``launch/mesh.py``: ``make_host_mesh``, ``data_axes``, ``n_chips``; here
:func:`make_grid`, :func:`data_axes` and ``Grid.size``). Here one process
is one rank, and a :class:`Grid` names the world's ranks by
their coordinates along named axes, default ``("data", "model")``, in
row-major order: rank ``r`` sits at ``np.unravel_index(r, shape)``. A rank's
flat index along a tuple of axes is row-major over that tuple, as
``jax.lax.axis_index(tuple(axes))`` numbers a device.

:meth:`Grid.group` holds one process group per tuple of axes that a
collective runs over: the ranks that differ only along those axes. The
distributed search (``core/distributed.py``) gathers over its cluster axes
and sums its drop count over the cluster and query axes together; the
sharded models (``models/sharding.py``) all-gather FSDP weights over the
data axes, sum tensor-parallel partials over ``model`` and take the
vocabulary-parallel softmax's maximum. The model code reads the grid from
:func:`use_grid` (:func:`current_grid`), the ambient grid that training,
decode and the step checkpoints run under.

Collectives (:meth:`Grid.all_gather`, :meth:`Grid.all_reduce`) take
tensors on the rank's device. Over NCCL a CUDA tensor goes to the
collective as it is. Over gloo a CUDA tensor is copied to the host, the
collective runs on the host copy and the result is copied back: gloo's
collectives are promised for CPU tensors only. That is a few KB a batch
for the search, and a layer's weights (MBs to GBs) for an FSDP gather.
Each collective is timed from a sync of the rank's device before it to a
sync after it, so a rank's own queued kernels are not counted:
``Grid.comm_s`` and ``Grid.comm_bytes`` add up the seconds and the bytes
the rank sent in, and ``Grid.comm_by_kind`` the calls and those bytes per
kind (``all-gather``, ``all-reduce``); callers read their differences.
Under a cost counter (``repro_torch/counting.py``) a collective counts its
input and its output once each, as XLA counts an all-gather's operand and
result, and none of the staging and copies it makes.

:func:`spawn` starts a world of ``n`` ranks on this machine, runs a
function on each and returns their results.

The dry run (``launch/dryrun.py``) lays its cells on the production grids
of :func:`make_production_grid`: ``(16, 16)`` over ``("data", "model")``
and ``(2, 16, 16)`` over ``("pod", "data", "model")``. These are the JAX
package's TPU v5e-256 mesh shapes (``make_production_mesh``), kept so that
the two packages' records compare cell for cell; on H100s of 8 cards a
node, a model axis of 16 spans two nodes. It builds them in a
:func:`fake_world`: a world of 256 or 512 ranks whose process group
carries no data (``torch.distributed``'s ``fake`` backend), this process
its rank 0. There a collective moves nothing and the device is never
synchronised (the tensors are ``FakeTensor`` s, which hold no values);
the accounting counts every call all the same. Nothing initialises a
world at import.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import math
import os
import pickle
import shutil
import tempfile
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..device import is_fake, resolve_device
from .. import counting

DEFAULT_AXES = ("data", "model")
# How long a rank waits in a collective or the rendezvous before it fails.
TIMEOUT = datetime.timedelta(seconds=900)


@dataclasses.dataclass(frozen=True)
class World:
    """What :func:`spawn` tells each rank: its rank, the world size, the
    device it runs on and the backend its process group uses."""

    rank: int
    size: int
    device: torch.device
    backend: str


class Grid:
    """A grid of named axes over the default process group.

    ``shape`` must multiply to the world size. ``device`` is the rank's
    device (``None``: the current CUDA device, raising without one; pass
    ``"cpu"`` for the CPU). Build the same grid on every rank, and call
    :meth:`group` (and so the collectives) for the same axes in the same
    order on every rank: each first call of a tuple creates its process
    groups, which every rank of the world must enter.
    """

    def __init__(self, shape: Sequence[int], axes: Sequence[str] = DEFAULT_AXES, *, device=None):
        if not dist.is_initialized():
            raise RuntimeError("Grid needs an initialised torch.distributed world (see spawn)")
        if len(shape) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"grid shape {tuple(shape)} does not match axes {tuple(axes)}")
        self.axis_names = tuple(axes)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.size = dist.get_world_size()
        if math.prod(self.shape.values()) != self.size:
            raise ValueError(f"grid {self.shape} needs {math.prod(self.shape.values())} ranks, "
                             f"the world has {self.size}")
        self.rank = dist.get_rank()
        self.device = resolve_device(device)
        self.backend = dist.get_backend()
        self._dims = tuple(self.shape.values())
        self._groups: dict[tuple[str, ...], tuple[Any, list[int]]] = {}
        self._by_members: dict[tuple[int, ...], Any] = {}
        # Accounting of the collectives (module docstring).
        self.comm_s = 0.0
        self.comm_bytes = 0
        self.comm_by_kind: dict[str, dict[str, int]] = {}

    def __repr__(self):
        return f"Grid({self.shape}, rank {self.rank}, {self.device}, {self.backend})"

    def coords(self, rank: int | None = None) -> dict[str, int]:
        """The coordinates of ``rank`` (default: this rank) by axis."""
        r = self.rank if rank is None else rank
        return dict(zip(self.axis_names, (int(i) for i in np.unravel_index(r, self._dims))))

    def _check(self, axes: Sequence[str]) -> tuple[str, ...]:
        axes = tuple(axes)
        unknown = [a for a in axes if a not in self.shape]
        if unknown or len(set(axes)) != len(axes):
            raise ValueError(f"axes {axes} are not distinct axes of the grid {self.shape}")
        return axes

    def axis_size(self, axes: Sequence[str]) -> int:
        """Ranks along ``axes`` (1 for no axes)."""
        return math.prod(self.shape[a] for a in self._check(axes))

    def flat_index(self, axes: Sequence[str], rank: int | None = None) -> int:
        """The flat index of ``rank`` (default: this rank) along ``axes``,
        row-major over the tuple as given (0 for no axes)."""
        axes = self._check(axes)
        if not axes:
            return 0
        c = self.coords(rank)
        return int(np.ravel_multi_index([c[a] for a in axes], [self.shape[a] for a in axes]))

    def group(self, axes: Sequence[str]):
        """``(process group, member ranks)`` of the ranks that differ from
        this one only along ``axes``; members in flat-index order along
        ``axes``. The first call for a tuple creates the groups of every
        such set of ranks, on every rank in the same order."""
        axes = self._check(axes)
        if axes not in self._groups:
            sets: dict[tuple, list[int]] = {}
            for r in range(self.size):
                c = self.coords(r)
                key = tuple(c[a] for a in self.axis_names if a not in axes)
                sets.setdefault(key, []).append(r)
            mine = None
            for key in sorted(sets):
                members = sorted(sets[key], key=lambda r: self.flat_index(axes, r))
                ident = tuple(sorted(members))
                if ident not in self._by_members:
                    self._by_members[ident] = dist.new_group(ranks=list(ident))
                if self.rank in members:
                    mine = (self._by_members[ident], members)
            self._groups[axes] = mine
        return self._groups[axes]

    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.device.type == "cuda"

    def all_gather(self, t: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        """Every rank's ``t`` along ``axes`` stacked on a new leading axis,
        in flat-index order -> ``(S, *t.shape)`` on ``t``'s device. The
        list form of ``dist.all_gather``; over gloo a CUDA tensor goes
        through the host (module docstring)."""
        group, members = self.group(axes)
        with counting.hidden():
            t0 = self._start(t)
            src = t.cpu() if self._staged(t) else t.contiguous()
            if self.backend == "gloo" and src.dtype == torch.bfloat16:
                src = src.view(torch.float16)  # gloo moves the 16-bit payload as float16 bits
            parts = [torch.empty_like(src) for _ in members]
            dist.all_gather(parts, src, group=group)
            by_rank = dict(zip(sorted(members), parts))  # group ranks go by global rank
            out = torch.stack([by_rank[r] for r in members]).view(t.dtype)
            out = out.to(t.device) if self._staged(t) else out
            self._finish(t, t0, "all-gather")
        counting.report(0, _nbytes(t) + _nbytes(out))
        return out

    def all_reduce(self, t: torch.Tensor, axes: Sequence[str], op: str = "sum") -> torch.Tensor:
        """The sum (``op="sum"``) or the maximum (``op="max"``) of ``t``
        over the ranks along ``axes`` (a new tensor on ``t``'s device; over
        gloo a CUDA tensor goes through the host)."""
        group, _ = self.group(axes)
        with counting.hidden():
            t0 = self._start(t)
            out = t.cpu() if self._staged(t) else t.clone()
            if self.backend == "gloo" and out.dtype == torch.bfloat16:
                out = out.float()  # gloo sums bfloat16 in float32 here, rounded once after
            dist.all_reduce(out, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op],
                            group=group)
            out = out.to(device=t.device, dtype=t.dtype)
            self._finish(t, t0, "all-reduce")
        counting.report(0, _nbytes(t) + _nbytes(out))
        return out

    def _start(self, t: torch.Tensor) -> float:
        self._sync(t)
        return time.perf_counter()

    def _finish(self, t: torch.Tensor, t0: float, kind: str) -> None:
        self._sync(t)
        self.comm_s += time.perf_counter() - t0
        nbytes = _nbytes(t)
        self.comm_bytes += nbytes
        tally = self.comm_by_kind.setdefault(kind, {"count": 0, "bytes": 0})
        tally["count"] += 1
        tally["bytes"] += nbytes

    def _sync(self, t: torch.Tensor) -> None:
        """Wait for the rank's device; a fake world or a fake tensor has
        nothing to wait for."""
        if t.device.type == "cuda" and self.backend != "fake" and not is_fake(t):
            torch.cuda.synchronize(t.device)

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


_AMBIENT: list[Grid] = []


@contextlib.contextmanager
def use_grid(grid: Grid | None):
    """Make ``grid`` ambient for the model code inside the block (``None``:
    no grid, every model on one device); blocks nest."""
    _AMBIENT.append(grid)
    try:
        yield grid
    finally:
        _AMBIENT.pop()


def current_grid() -> Grid | None:
    """The innermost :func:`use_grid`'s grid, or None."""
    return _AMBIENT[-1] if _AMBIENT else None


def make_grid(shape: Sequence[int] = (2, 2), axes: Sequence[str] = DEFAULT_AXES, *, device=None) -> Grid:
    """A :class:`Grid` over the current world (the counterpart of the JAX
    package's ``make_host_mesh``)."""
    return Grid(shape, axes, device=device)


PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_grid(*, multi_pod: bool = False, device=None) -> Grid:
    """The dry run's grid: ``(data=16, model=16)``, or with ``multi_pod``
    ``(pod=2, data=16, model=16)`` (the counterpart of the JAX package's
    ``make_production_mesh``; module docstring). The world must have 256
    or 512 ranks, as the grid's (see :func:`fake_world`)."""
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    need = math.prod(shape)
    if not dist.is_initialized() or dist.get_world_size() != need:
        have = dist.get_world_size() if dist.is_initialized() else 0
        raise RuntimeError(f"the production grid {shape} needs a world of {need} ranks, "
                           f"have {have} (see fake_world)")
    return Grid(shape, axes, device=device)


@contextlib.contextmanager
def fake_world(n: int):
    """A world of ``n`` ranks with no peers: ``torch.distributed``'s
    ``fake`` backend over a ``FakeStore``, this process its rank 0. Its
    collectives move nothing (run them on fake tensors). The world is
    destroyed on leaving the block, also on an error."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a torch.distributed world is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def data_axes(grid: Grid) -> tuple[str, ...]:
    """The grid's data-parallel axes: ``pod`` and ``data`` where present."""
    return tuple(a for a in ("pod", "data") if a in grid.axis_names)


def default_backend(n: int, device_type: str) -> str:
    """``nccl`` when every one of ``n`` ranks has a CUDA card of its own,
    ``gloo`` when ranks share a card or run on the CPU (NCCL refuses two
    ranks on one device)."""
    if device_type == "cuda" and torch.cuda.device_count() >= n:
        return "nccl"
    return "gloo"


def _rank_main(rank, n, fn, args, device_type, backend, root, threads):
    if device_type == "cuda":
        index = rank if backend == "nccl" else rank % torch.cuda.device_count()
        device = torch.device("cuda", index)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
        torch.set_num_threads(threads)
    why = ("a card for each rank" if backend == "nccl" else
           "ranks share a card" if device_type == "cuda" else "ranks on the CPU")
    print(f"[world] rank {rank} of {n}: backend {backend} ({why}) on {device}", flush=True)
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(root, 'store')}", world_size=n, rank=rank,
        timeout=TIMEOUT,
    )
    try:
        result = fn(World(rank, n, device, backend), *args)
        path = os.path.join(root, f"result_{rank}.pkl")
        with open(path + ".tmp", "wb") as f:
            pickle.dump(result, f)
        os.replace(path + ".tmp", path)
        if backend == "nccl":
            dist.barrier(device_ids=[device.index])
        else:
            dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(
    n: int,
    fn: Callable,
    *args,
    device: str | torch.device | None = None,
    backend: str | None = None,
) -> list:
    """Start a world of ``n`` ranks, run ``fn(world, *args)`` on each
    (``world`` a :class:`World`) and return their results in rank order.

    ``device=None`` means the CUDA device, and raises without one; pass
    ``device="cpu"`` for ranks on the CPU (each then runs ``cpu_count / n``
    threads, at least one). ``backend=None`` follows
    :func:`default_backend`; ``nccl`` with ranks sharing a card raises.
    Each rank prints the backend it runs.

    The world meets through a file store in a temporary directory, not a
    TCP port, so that several worlds on one machine never collide. The
    ranks start with ``spawn``: ``fn`` must be importable by its module
    name, and ``args`` travel as ``torch.multiprocessing`` pickles them
    (CPU tensors through shared memory, CUDA tensors as CUDA IPC handles
    that the caller keeps alive until this returns). Results must pickle
    without CUDA tensors. A rank that raises stops the world, and its
    error is raised here.
    """
    import torch.multiprocessing as mp

    device_type = resolve_device(device).type
    backend = backend or default_backend(n, device_type)
    if backend == "nccl" and (device_type != "cuda" or torch.cuda.device_count() < n):
        raise ValueError(f"nccl needs a CUDA card for each of the {n} ranks; "
                         f"this machine has {torch.cuda.device_count()}")
    threads = max(1, (os.cpu_count() or 1) // n)
    root = tempfile.mkdtemp(prefix="lider-world-")
    try:
        mp.start_processes(
            _rank_main, args=(n, fn, args, device_type, backend, root, threads),
            nprocs=n, join=True, start_method="spawn",
        )
        out = []
        for r in range(n):
            with open(os.path.join(root, f"result_{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)
