"""The reference's parameter tree for any model family of the port.

A model's ``named_parameters()`` names its tensors with dots
(``blocks.0.wq``, ``layers.3.moe.w_up``); the JAX package keeps the same
weights as a nested tree. :func:`param_tree` maps the one to the other:

- a dotted name is a path of dict keys;
- a numeric part under ``layers`` indexes the reference's stacked layers
  (the transformer's and the GNN's ``jax.vmap``-initialised ``(L, ...)``
  leaves), so ``layers.{i}.x`` is the ``i``-th part of the
  :class:`~repro_torch.core.types.Stacked` leaf ``tree["layers"]["x"]``;
- any other numeric part indexes a Python list of the reference
  (SASRec's ``blocks``, xDeepFM's ``cin``), so ``blocks.0.wq`` is
  ``tree["blocks"][0]["wq"]``.

The checkpoint module flattens such a tree in ``tree_flatten_with_path``
order (dict keys sorted, list items by index), which names the leaves as
the reference's step files do (``blocks__0__wq``, ``layers__wq``).
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from ..core.types import Stacked, numpy_to_tensor, tensor_to_numpy

STACKED = "layers"  # the one key whose numeric children are stacked on a leading axis


def param_tree(named: Mapping[str, torch.Tensor]) -> dict:
    """``{parameter name: tensor}`` (the parameters, their gradients or the
    optimizer's moments keyed by them) in the reference's nested layout;
    no copy."""
    tree: dict = {}
    stacks: dict[tuple, dict[int, torch.Tensor]] = {}
    for name, t in named.items():
        parts = name.split(".")
        if parts[0] == STACKED:
            stacks.setdefault((STACKED, *parts[2:]), {})[int(parts[1])] = t
        else:
            _set(tree, parts, t)
    for key, by_layer in stacks.items():
        _set(tree, key, Stacked([by_layer[i] for i in range(len(by_layer))]))
    return _lists(tree)


def _set(tree: dict, path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _lists(node):
    """Dicts keyed ``"0" .. "n-1"`` become lists, recursively."""
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and all(k.isdigit() for k in out):
        return [out[str(i)] for i in range(len(out))]
    return out


def lookup(tree, name: str):
    """The leaf of the reference's tree that parameter ``name`` holds (a
    layer's slice of a stacked leaf)."""
    parts = name.split(".")
    index = None
    if parts[0] == STACKED:
        index, parts = int(parts[1]), [STACKED, *parts[2:]]
    node = tree
    for key in parts:
        node = node[int(key)] if isinstance(node, (list, tuple)) else node[key]
    return node if index is None else node[index]


def to_numpy(model: nn.Module) -> dict:
    """The module's weights as the reference's parameter tree of numpy
    arrays, stacked layers on a leading axis (bfloat16 as ``'V2'``)."""

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if isinstance(node, Stacked):
            return np.stack([tensor_to_numpy(t) for t in node.parts])
        return tensor_to_numpy(node)

    return walk(param_tree(dict(model.named_parameters())))


@torch.no_grad()
def load(model: nn.Module, tree) -> nn.Module:
    """Copy the weights of the reference's parameter tree (numpy or
    array-likes) into ``model``; each leaf's shape and dtype must match."""
    for name, p in model.named_parameters():
        t = numpy_to_tensor(np.asarray(lookup(tree, name)))
        if t.shape != p.shape or t.dtype != p.dtype:
            raise ValueError(f"{name}: tree holds {tuple(t.shape)} {t.dtype}, "
                             f"the model {tuple(p.shape)} {p.dtype}")
        p.copy_(t)
    return model


@torch.no_grad()
def draw(model: nn.Module, generator: torch.Generator,
         scales: Mapping[str, float] | None = None) -> None:
    """Draw every weight as the reference's ``init`` functions do: norm
    scales (``ln*``, ``bn_*``) 1, MLP biases (``b0``, ``b1``, ...) 0, and
    every other matrix N(0, 1) times ``scales[name]`` (default
    1 / sqrt(shape[0])), drawn in float32 and cast to the parameter dtype.
    Not the reference's values: the two frameworks' random streams differ."""
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf.startswith(("ln", "bn_")):
            p.fill_(1.0)
        elif leaf[:1] == "b" and leaf[1:].isdigit():
            p.zero_()
        else:
            z = torch.randn(p.shape, generator=generator, dtype=torch.float32, device=p.device)
            p.copy_(z.mul_((scales or {}).get(name, p.shape[0] ** -0.5)))
