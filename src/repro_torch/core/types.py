"""Plain dataclass helpers for the parameter containers of the port.

The JAX package registers its containers as pytrees; here they are frozen
dataclasses holding tensors: :func:`map_tensors` maps their tensors (moving
an index between devices) and :func:`tensor_leaves` lists them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

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
