"""Sharding of the models over a :class:`~repro_torch.launch.mesh.Grid`.

The port of the JAX package's ``models/sharding.py``. Model code names
*logical* axes; on a grid they resolve to the physical axes present:
``"dp"`` -> ``("pod", "data")``, ``"tp"`` -> ``("model",)``, ``"all"`` ->
all three, each filtered by the grid's axes (:func:`resolve_spec`). A spec
has one entry per dimension; a resolved entry is None (the dimension is
whole on every rank) or a tuple of axis names (the dimension is split into
that many blocks, row-major over the tuple, as ``NamedSharding`` splits it).

JAX lays a sharded model out by ``with_sharding_constraint`` and GSPMD
inserts the collectives. Here a rank holds its block of each parameter
(:func:`shard_module`, :func:`shard`) and the model code calls the
collectives itself, each a ``torch.autograd.Function`` over the grid's own
collectives:

- :func:`copy_to`: identity forward, sum over the axes backward (Megatron's
  *f*: a value whole on every rank feeds a computation split over the axes).
- :func:`reduce_from`: sum forward, identity backward (Megatron's *g*: a
  split computation's partials summed into a value whole on every rank).
- :func:`psum`: sum forward and backward (a sum that split computations
  read, such as the batch statistics of edges split over the ranks).
- :func:`gather`: all-gather along a dimension. Backward ``"sum"`` sums the
  gradient over the axes and keeps the rank's slice (a reduce-scatter: the
  gathered value feeds split work); ``"slice"`` keeps the rank's slice of
  the gradient as it is (the gathered value feeds work that every rank does
  alike).
- :func:`reduce_scatter`: sum forward and keep the rank's slice, all-gather
  backward (sequence-parallel residual streams).
- :func:`all_max`: the maximum over the axes, without a gradient (the
  vocabulary-parallel softmax's shift).

A rank's gradients then come out whole for its own blocks: a parameter
whole on every rank but used in work split over some axes is read through
:func:`materialize`, which gathers its FSDP dimensions and applies
:func:`copy_to` over the rest, so the backward sums its partial gradients.
Each parameter carries its resolved spec (:func:`spec_of`), and the
optimizer state made from it carries the same (``optimizer.init_state``):
the clipping norm, the checkpoints and :func:`unshard_named` read it.

``maybe_shard`` (a layout constraint in JAX, which changes no value) has
no counterpart: the sharded layers lay their activations out explicitly.
Where the port's layout departs from the one the reference pins:

- MoE expert buffers: each model rank builds only its experts' slots of
  the (B, E, C, d) buffers, from rows that are whole on every model rank,
  and the combine is one sum over ``model`` (JAX pins the buffers to
  (data, model) and lets GSPMD place the dispatch).
- GNN node states are whole on every rank (JAX pins them to ``model``);
  edges split over every axis, as in JAX.
- Prefill's keys and values are computed head-split over ``model`` and
  all-gathered into the sequence-split cache (JAX pins the cache slice to
  (data, model) inside the layer scan).
"""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch
from torch import nn

DP = "dp"  # logical data-parallel axis -> ("pod", "data")
TP = "tp"  # logical tensor/expert-parallel axis -> ("model",)
ALL = "all"  # every grid axis (edge-parallel GNN aggregation)

_LOGICAL = {
    DP: ("pod", "data"),
    TP: ("model",),
    ALL: ("pod", "data", "model"),
}
SPEC_ATTR = "grid_spec"  # the attribute a sharded tensor carries its resolved spec in


def physical_axes(logical: str, axis_names) -> tuple[str, ...]:
    return tuple(a for a in _LOGICAL[logical] if a in axis_names)


def resolve_spec(spec_entries, axis_names) -> tuple:
    """One entry per dimension: None, or the tuple of the grid's axes that
    split it. An entry may be logical (``"dp"``), a physical axis name, or
    a tuple of physical names (as ``param_specs`` writes the data axes);
    axes the grid lacks are dropped."""
    out = []
    for e in spec_entries:
        if e is None:
            out.append(None)
            continue
        if isinstance(e, str):
            phys = physical_axes(e, axis_names) if e in _LOGICAL else (e,)
        else:
            phys = tuple(e)
        phys = tuple(a for a in phys if a in axis_names)
        out.append(phys or None)
    return tuple(out)


def spec_axes(spec) -> tuple[str, ...]:
    """Every axis a resolved spec splits over, in dimension order."""
    return tuple(a for e in (spec or ()) if e for a in e)


# ---------------------------------------------------------------------------
# Blocks of full tensors
# ---------------------------------------------------------------------------


def block_slices(shape: Sequence[int], spec, grid) -> tuple[slice, ...]:
    """The rank's block of a tensor of ``shape`` under a resolved spec."""
    spec = tuple(spec or ()) + (None,) * (len(shape) - len(spec or ()))
    out = []
    for n, axes in zip(shape, spec):
        if not axes:
            out.append(slice(None))
            continue
        parts = grid.axis_size(axes)
        if n % parts:
            raise ValueError(f"dimension {n} does not split over {axes} ({parts} ranks)")
        size = n // parts
        i = grid.flat_index(axes)
        out.append(slice(i * size, (i + 1) * size))
    return tuple(out)


def block_shape(shape: Sequence[int], spec, grid) -> tuple[int, ...]:
    """The shape of the rank's block of a tensor of ``shape``."""
    return tuple(len(range(*sl.indices(n))) for n, sl in zip(shape, block_slices(shape, spec, grid)))


def shard(full, spec, grid):
    """The rank's block of ``full`` (a tensor or a numpy array; a
    contiguous copy of the same kind)."""
    block = full[block_slices(full.shape, spec, grid)]
    if isinstance(full, np.ndarray):
        return np.array(block, order="C", copy=True)
    return block.clone(memory_format=torch.contiguous_format)


def unshard(local: torch.Tensor, spec, grid) -> torch.Tensor:
    """The full tensor from every rank's block (a collective: every rank
    calls it for the same tensors in the same order)."""
    out = local
    for dim, axes in enumerate(spec or ()):
        if axes and grid.axis_size(axes) > 1:
            out = _cat_gathered(grid.all_gather(out.contiguous(), axes), dim)
    return out


def _cat_gathered(stacked: torch.Tensor, dim: int) -> torch.Tensor:
    """(S, *shape) from ``Grid.all_gather`` -> the S parts concatenated
    along ``dim``."""
    return torch.cat(stacked.unbind(0), dim=dim)


def shard_batch(batch: Mapping[str, torch.Tensor], grid, axes: Sequence[str] = (DP,)) -> dict:
    """Each tensor's rows (leading dimension) split over ``axes`` (logical
    or physical names): the rank's share of a global batch."""
    spec = resolve_spec((tuple(axes) if len(axes) > 1 else axes[0],), grid.axis_names)
    return {k: shard(v, spec, grid) if isinstance(v, torch.Tensor) and v.dim() else v
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Differentiable collectives
# ---------------------------------------------------------------------------


def _live(grid, axes) -> tuple[str, ...]:
    return tuple(axes) if grid is not None and axes and grid.axis_size(axes) > 1 else ()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grid, axes):
        ctx.grid, ctx.axes = grid, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.grid.all_reduce(g.contiguous(), ctx.axes), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grid, axes):
        return grid.all_reduce(x.contiguous(), axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grid, axes):
        ctx.grid, ctx.axes = grid, axes
        return grid.all_reduce(x.contiguous(), axes)

    @staticmethod
    def backward(ctx, g):
        return ctx.grid.all_reduce(g.contiguous(), ctx.axes), None, None


def _my_slice(x: torch.Tensor, dim: int, grid, axes) -> torch.Tensor:
    n = grid.axis_size(axes)
    size = x.shape[dim] // n
    return x.narrow(dim, grid.flat_index(axes) * size, size).contiguous()


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grid, axes, dim, grad):
        ctx.grid, ctx.axes, ctx.dim, ctx.grad = grid, axes, dim, grad
        return _cat_gathered(grid.all_gather(x.contiguous(), axes), dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad == "sum":
            g = ctx.grid.all_reduce(g.contiguous(), ctx.axes)
        return _my_slice(g, ctx.dim, ctx.grid, ctx.axes), None, None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grid, axes, dim):
        ctx.grid, ctx.axes, ctx.dim = grid, axes, dim
        return _my_slice(grid.all_reduce(x.contiguous(), axes), dim, grid, axes)

    @staticmethod
    def backward(ctx, g):
        return _cat_gathered(ctx.grid.all_gather(g.contiguous(), ctx.axes), ctx.dim), None, None, None


def copy_to(x: torch.Tensor, grid, axes) -> torch.Tensor:
    axes = _live(grid, axes)
    return _CopyTo.apply(x, grid, axes) if axes else x


def reduce_from(x: torch.Tensor, grid, axes) -> torch.Tensor:
    axes = _live(grid, axes)
    return _ReduceFrom.apply(x, grid, axes) if axes else x


def psum(x: torch.Tensor, grid, axes) -> torch.Tensor:
    axes = _live(grid, axes)
    return _Psum.apply(x, grid, axes) if axes else x


def gather(x: torch.Tensor, grid, axes, dim: int, *, grad: str = "sum") -> torch.Tensor:
    if grad not in ("sum", "slice"):
        raise ValueError(f"gather's backward is 'sum' or 'slice', not {grad!r}")
    axes = _live(grid, axes)
    return _Gather.apply(x, grid, axes, dim % x.dim(), grad) if axes else x


def reduce_scatter(x: torch.Tensor, grid, axes, dim: int) -> torch.Tensor:
    axes = _live(grid, axes)
    if not axes:
        return x
    if x.shape[dim] % grid.axis_size(axes):
        raise ValueError(f"dimension {x.shape[dim]} does not split over {axes}")
    return _ReduceScatter.apply(x, grid, axes, dim % x.dim())


@torch.no_grad()
def all_reduce_nograd(x: torch.Tensor, grid, axes) -> torch.Tensor:
    """The sum over the axes of a value without a gradient (counts)."""
    axes = _live(grid, axes)
    return grid.all_reduce(x.detach().contiguous(), axes) if axes else x.detach()


@torch.no_grad()
def all_max(x: torch.Tensor, grid, axes) -> torch.Tensor:
    axes = _live(grid, axes)
    return grid.all_reduce(x.detach().contiguous(), axes, op="max") if axes else x.detach()


def vocab_take(table: torch.Tensor, ids: torch.Tensor, grid, axes) -> torch.Tensor:
    """The rank's share of ``full_table[ids]`` when the table's rows split
    over ``axes`` (``table`` the rank's rows): its rows taken, every other
    id's row zero. Summed over ``axes`` it is the full take, bit for bit
    (each id's row plus exact zeros); the gradient reaches only the rank's
    rows. With no axis of more than one rank it is the plain take."""
    if not _live(grid, axes):
        return torch.nn.functional.embedding(ids, table)
    rows = table.shape[0]
    local = ids - my_index(grid, axes) * rows
    inside = (local >= 0) & (local < rows)
    got = torch.nn.functional.embedding(torch.clamp(local, 0, rows - 1), table)
    return torch.where(inside[..., None], got, torch.zeros((), dtype=got.dtype, device=got.device))


def my_index(grid, axes) -> int:
    """The rank's flat index along ``axes`` (0 without a grid)."""
    return grid.flat_index(axes) if grid is not None and axes else 0


def size_of(grid, axes) -> int:
    return grid.axis_size(axes) if grid is not None and axes else 1


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def spec_of(t: torch.Tensor):
    """The resolved spec a sharded tensor carries, or None (whole)."""
    return getattr(t, SPEC_ATTR, None)


def tag(t: torch.Tensor, spec) -> torch.Tensor:
    setattr(t, SPEC_ATTR, spec)
    return t


def materialize(p: torch.Tensor, grid, over: Sequence[str]) -> torch.Tensor:
    """A parameter as the work split over ``over`` reads it: its
    dimensions split over axes of ``over`` all-gathered (FSDP; the
    backward sums the gradient over them and keeps the rank's block), then
    :func:`copy_to` over the axes of ``over`` it is whole along. Dimensions
    split over other axes (tensor parallelism) stay split."""
    if grid is None:
        return p
    spec = spec_of(p) or ()
    x = p
    for dim, axes in enumerate(spec):
        if axes and all(a in over for a in axes):
            x = gather(x, grid, axes, dim)
    split = set(spec_axes(spec))
    rest = tuple(a for a in over if a not in split)
    return copy_to(x, grid, rest)


def spec_lookup(specs, name: str):
    """The spec of parameter ``name`` in a nested spec tree whose stacked
    ``layers`` hold one per-layer tree (``layers.3.wq`` ->
    ``specs["layers"]["wq"]``); lists are indexed by number."""
    parts = name.split(".")
    if parts[0] == "layers":
        parts = [parts[0], *parts[2:]]
    node = specs
    for key in parts:
        node = node[int(key)] if isinstance(node, (list, tuple)) and key.isdigit() else node[key]
    return node


@torch.no_grad()
def shard_module(model: nn.Module, specs, grid, *, source=None, device=None) -> nn.Module:
    """Replace each parameter of ``model`` by the rank's block under its
    spec in ``specs`` (a nested tree as the families' ``param_specs`` give
    it), resolved on the grid's axes, tagged with the resolved spec. In
    place; returns ``model``.

    The full values are the parameters' own, or with ``source`` those of
    ``{parameter name: tensor}`` or the leaves of the reference's parameter
    tree (numpy arrays or tensors, stacked layers as in
    :func:`~repro_torch.models.tree.lookup`): then ``model``
    may live on the ``meta`` device and only the rank's blocks are made,
    exactly the slices of the full leaves, on ``device`` (default: the
    source's)."""
    from .tree import lookup
    from ..core.types import numpy_to_tensor

    for prefix, mod in model.named_modules():
        for pname, p in list(mod._parameters.items()):
            if p is None:
                continue
            name = f"{prefix}.{pname}" if prefix else pname
            spec = resolve_spec(spec_lookup(specs, name), grid.axis_names)
            if len(spec) != p.dim():
                raise ValueError(f"{name}: spec {spec} for a tensor of {p.dim()} dimensions")
            full = (p.data if source is None else source[name] if name in source
                    else lookup(source, name))
            if tuple(full.shape) != tuple(p.shape):
                raise ValueError(f"{name}: source holds {tuple(full.shape)}, the model {tuple(p.shape)}")
            block = shard(full, spec, grid)
            if isinstance(block, np.ndarray):
                block = numpy_to_tensor(block)
            dev = device if device is not None else (p.device if source is None else block.device)
            new = nn.Parameter(block.to(device=dev, dtype=p.dtype), requires_grad=p.requires_grad)
            mod._parameters[pname] = tag(new, spec)
    warm_groups(grid)
    return model


@torch.no_grad()
def empty_blocks(model: nn.Module, specs, grid, *, device) -> nn.Module:
    """Replace each parameter of ``model`` (built on the ``meta`` device,
    say) by an uninitialised tensor of the rank's block shape under its
    spec in ``specs`` (None: every parameter whole), on ``device``, tagged
    with the resolved spec: the layout :func:`shard_module` gives, with no
    full tensor ever made. Under a ``FakeTensorMode`` the blocks are fake
    (the dry run). In place; returns ``model``."""
    for prefix, mod in model.named_modules():
        for pname, p in list(mod._parameters.items()):
            if p is None:
                continue
            name = f"{prefix}.{pname}" if prefix else pname
            entries = (None,) * p.dim() if specs is None else spec_lookup(specs, name)
            spec = resolve_spec(entries, grid.axis_names)
            if len(spec) != p.dim():
                raise ValueError(f"{name}: spec {spec} for a tensor of {p.dim()} dimensions")
            block = torch.empty(block_shape(p.shape, spec, grid), dtype=p.dtype, device=device)
            mod._parameters[pname] = tag(nn.Parameter(block, requires_grad=p.requires_grad), spec)
    warm_groups(grid)
    return model


def warm_groups(grid) -> None:
    """Create the process groups the sharded models use, on every rank in
    the same order, before any backward pass needs one."""
    names = grid.axis_names
    for axes in [(a,) for a in names] + [physical_axes(DP, names), physical_axes(ALL, names)]:
        if axes:
            grid.group(axes)


@torch.no_grad()
def unshard_named(named: Mapping[str, torch.Tensor], grid) -> dict[str, torch.Tensor]:
    """``{name: full tensor}`` from every rank's tagged blocks (a
    collective; untagged tensors come back as they are)."""
    return {n: unshard(t, spec_of(t), grid) if spec_of(t) else t for n, t in named.items()}
