"""Plain dataclass helpers for the parameter containers of the port.

The JAX package registers its containers as pytrees; here they are frozen
dataclasses holding tensors: :func:`map_tensors` maps their tensors (moving
an index between devices) and :func:`tensor_leaves` lists them.

Trees of tensors (parameters, optimizer state, step checkpoints) are nested
dicts, flattened in the JAX package's order by :func:`tree_flatten_with_path`;
:class:`Stacked` stands for a stack of per-layer tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch


def tensor_leaves(obj: Any) -> list[torch.Tensor]:
    """Every tensor inside nested dataclasses / named tuples, in field order."""
    out: list[torch.Tensor] = []
    map_tensors(lambda t: out.append(t) or t, obj)
    return out


def map_tensors(fn: Callable[[torch.Tensor], torch.Tensor], obj: Any) -> Any:
    """Apply ``fn`` to every tensor inside nested dataclasses / tuples."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        changes = {
            f.name: map_tensors(fn, getattr(obj, f.name))
            for f in dataclasses.fields(obj)
        }
        return dataclasses.replace(obj, **changes)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(map_tensors(fn, v) for v in obj))
    return obj


# ---------------------------------------------------------------------------
# Trees of tensors (model parameters, optimizer state, checkpoints)
# ---------------------------------------------------------------------------


class Stacked:
    """A leaf made of equal-shaped tensors that stands for their stack on a
    new leading axis, without copying them: the transformer's per-layer
    weights seen as the reference's ``(L, ...)`` leaves. A checkpoint
    writes it as one stacked array and restores it part by part, in
    place."""

    def __init__(self, parts: list[torch.Tensor]):
        self.parts = list(parts)

    @property
    def shape(self) -> tuple[int, ...]:
        return (len(self.parts), *self.parts[0].shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype


def tree_flatten_with_path(tree: Any, path: tuple = ()) -> list[tuple[tuple, Any]]:
    """``(path, leaf)`` for every leaf, in the JAX package's flattening
    order: a dict's keys sorted, a list's or tuple's items in order, None an
    empty subtree. A path holds dict keys and sequence indexes."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in tree_flatten_with_path(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in tree_flatten_with_path(v, path + (i,))]
    if tree is None:
        return []
    return [(path, tree)]


def tree_unflatten(like: Any, leaves: list) -> Any:
    """A tree of ``like``'s structure with ``leaves`` in flattening order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        if node is None:
            return None
        return next(it)

    return build(like)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor on the host as numpy; bfloat16 as its 16-bit payload typed
    ``'V2'``, the type numpy writes for the JAX package's bfloat16 arrays."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def numpy_to_tensor(arr: np.ndarray) -> torch.Tensor:
    """The inverse of :func:`tensor_to_numpy`; also takes ``ml_dtypes``
    bfloat16 arrays (what the JAX package's ``np.asarray`` gives)."""
    if not (arr.flags.c_contiguous and arr.flags.writeable):
        arr = np.array(arr, order="C")
    if arr.dtype.kind == "V" or str(arr.dtype) == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)
