"""AdamW with a warmup + cosine schedule, global-norm clipping and a
gradient-compression hook (a bfloat16 round trip of the gradients).

The port of the JAX package's ``training/optimizer.py``. The state mirrors
the parameters: ``{"mu": {name: tensor}, "nu": {name: tensor}, "step":
int32 scalar}``, keyed by the module's parameter names
(:func:`~repro_torch.models.tree.param_tree` gives it the
reference's layout for a checkpoint).

:func:`apply_updates` updates the parameters and the moments in place, where
the reference returns new trees: it takes the global norm first, then
updates one leaf at a time, so only one leaf's temporaries are live beside
the parameters, the gradients and the moments (the reference maps over the
whole tree three times, which in eager PyTorch would keep a second copy of
every gradient). The moments and the weights update in place, a leaf in
about a dozen passes over its bytes.

On a grid (parameters sharded by ``models.sharding.shard_module``) each
rank updates its blocks: the moments carry their parameter's spec, and
the clipping norm sums each leaf's squares over the axes that leaf is split
over (a leaf whole on every rank is counted once), so clipping equals the
single-device clipping.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import torch

from ..launch.mesh import current_grid
from ..models import sharding


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    compress_grads: bool = False


def schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step``: linear warmup, then cosine decay to
    ``min_lr_ratio * peak_lr`` at ``decay_steps``; float32."""
    step = torch.as_tensor(step).float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0
    )
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.peak_lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_state(params: Mapping[str, torch.Tensor]) -> dict:
    """Zero moments shaped as the parameters (a sharded parameter's
    moments are its blocks and carry its spec) and step 0."""
    zeros = lambda: {n: sharding.tag(torch.zeros_like(p, dtype=torch.float32), sharding.spec_of(p))
                     for n, p in params.items()}
    device = next(iter(params.values())).device
    return {"mu": zeros(), "nu": zeros(), "step": torch.zeros((), dtype=torch.int32, device=device)}


def _as_f32(g: torch.Tensor, compress: bool) -> torch.Tensor:
    return g.to(torch.bfloat16).float() if compress else g.float()


def global_norm(tensors, *, specs=None, grid=None) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in float32 (one
    float32 partial per tensor, added in order). With a ``grid``, tensor
    ``i`` is a block under the resolved ``specs[i]``: the partials of the
    blocks split over the same axes are summed over those axes, so each
    leaf counts once."""
    if grid is None:
        total = None
        for x in tensors:
            sq = torch.sum(torch.square(x.float()))
            total = sq if total is None else total + sq
        return torch.sqrt(total)
    groups: dict[tuple, torch.Tensor] = {}
    for x, spec in zip(tensors, specs):
        axes = tuple(a for a in grid.axis_names if a in sharding.spec_axes(spec))
        sq = torch.sum(torch.square(x.float()))
        groups[axes] = sq if axes not in groups else groups[axes] + sq
    total = sum(sharding.all_reduce_nograd(sq, grid, axes) for axes, sq in sorted(groups.items()))
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(
    params: Mapping[str, torch.Tensor],
    grads: Mapping[str, torch.Tensor | None],
    state: dict,
    cfg: OptimizerConfig,
) -> dict:
    """One AdamW step, in place on ``params`` and ``state`` -> metrics
    ``{"grad_norm", "lr"}`` (device scalars). A missing (None) gradient is
    a zero gradient, as JAX's gradient of an unused weight is. Under an
    ambient grid the parameters are the rank's blocks (their gradients
    whole for those blocks) and the norm is the global one."""
    state["step"] += 1
    step = state["step"]
    grads = {n: (torch.zeros_like(p) if grads.get(n) is None else grads[n]) for n, p in params.items()}
    grid = current_grid()
    gnorm = global_norm((_as_f32(g, cfg.compress_grads) for g in grads.values()),
                        specs=[sharding.spec_of(p) for p in params.values()], grid=grid)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()
    for n, p in params.items():
        g = _as_f32(grads[n], cfg.compress_grads) * scale
        mu, nu = state["mu"][n], state["nu"][n]
        mu.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)  # b1 mu + (1 - b1) g
        nu.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)  # b2 nu + (1 - b2) g g
        del g
        denom = torch.div(nu, b2c).sqrt_().add_(cfg.eps)
        delta = torch.div(mu, b1c).div_(denom)
        del denom
        pf = p.float()
        delta.add_(pf, alpha=cfg.weight_decay).mul_(lr)  # lr (mhat / (sqrt(nhat) + eps) + wd p)
        if p.dtype == torch.float32:
            p.sub_(delta)
        else:  # pf is a float32 copy of a lower-precision master weight
            p.copy_(pf.sub_(delta))
    return {"grad_norm": gnorm, "lr": lr}
