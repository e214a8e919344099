"""Train-step factory (gradient accumulation, metrics) and the host loop.

The port of the JAX package's ``training/train_loop.py``.
``make_train_step(loss_fn, opt_cfg, grad_accum=...)`` returns ``step(model,
opt_state, batch) -> (model, opt_state, metrics)``, which updates the
model's parameters and the optimizer state in place (PyTorch runs eagerly;
there is nothing to jit). ``loss_fn(model, batch)`` returns a scalar.

Micro-batches run one after another, so one micro-batch's activations are
live at a time; their gradients are summed in float32 and divided by
``grad_accum`` at the end, as the reference's ``lax.scan`` does.

Under an ambient grid (``launch.mesh.use_grid`` around the step's calls)
the model holds the rank's blocks (``models.sharding.shard_module``) and
the batch the rank's rows. The model's loss is the mean over the global
batch, the same on every rank; its backward leaves each block's whole
gradient (the data-split gathers and the copies of data-replicated weights
sum over the data axes), and AdamW updates the rank's blocks with the
global clipping norm.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from ..models.tree import param_tree
from . import optimizer as opt_lib


def make_train_step(
    loss_fn: Callable,
    opt_cfg: opt_lib.OptimizerConfig,
    *,
    grad_accum: int = 1,
):
    """Batch leaves must have a leading dim divisible by ``grad_accum``."""

    def step(model: nn.Module, opt_state: dict, batch: dict):
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        if grad_accum == 1:
            loss = loss_fn(model, batch)
            loss.backward()
            grads = {n: p.grad for n, p in params.items()}
        else:
            rows = next(iter(batch.values())).shape[0]
            if rows % grad_accum:
                raise ValueError(f"batch of {rows} rows does not split into {grad_accum} micro-batches")
            acc: dict[str, torch.Tensor] = {}
            for i in range(grad_accum):
                micro = {k: torch.chunk(v, grad_accum)[i] for k, v in batch.items()}
                mloss = loss_fn(model, micro)
                mloss.backward()
                loss = mloss.detach() if i == 0 else loss + mloss.detach()
                for n, p in params.items():
                    # float32 parameters sum in their own .grad; others in a
                    # float32 buffer (the reference's float32 carry).
                    if p.grad is not None and p.grad.dtype != torch.float32:
                        acc[n] = p.grad.float() if n not in acc else acc[n].add_(p.grad)
                        p.grad = None
            loss = loss / grad_accum
            grads = {}
            for n, p in params.items():
                g = acc.get(n, p.grad)
                grads[n] = None if g is None else g / grad_accum
        for p in params.values():
            p.grad = None
        metrics = opt_lib.apply_updates(params, grads, opt_state, opt_cfg)
        metrics["loss"] = loss.detach()
        return model, opt_state, metrics

    return step


def state_tree(model: nn.Module, opt_state: dict) -> dict:
    """``{"params", "opt_state"}`` in the reference's checkpoint layout,
    viewing the live tensors, for a model of any family (stacked layers as
    ``Stacked`` leaves, the reference's lists as lists)."""
    return {
        "params": param_tree(dict(model.named_parameters())),
        "opt_state": {"mu": param_tree(opt_state["mu"]), "nu": param_tree(opt_state["nu"]),
                      "step": opt_state["step"]},
    }


def run(
    step_fn,
    model: nn.Module,
    opt_state: dict,
    data_iter,
    *,
    n_steps: int,
    log_every: int = 10,
    checkpoint_manager=None,
    checkpoint_every: int = 0,
    start_step: int = 0,
    log_fn=print,
):
    """Host-side loop: data, step, periodic checkpoint of
    :func:`state_tree`. Returns ``(model, opt_state, history)``."""
    history = []
    for i in range(start_step, n_steps):
        batch = next(data_iter)
        model, opt_state, metrics = step_fn(model, opt_state, batch)
        if log_every and (i % log_every == 0 or i == n_steps - 1):
            m = {k: float(v) for k, v in metrics.items()}
            history.append({"step": i, **m})
            log_fn(f"step {i}: " + " ".join(f"{k}={v:.4g}" for k, v in m.items()))
        if checkpoint_manager and checkpoint_every and (i + 1) % checkpoint_every == 0:
            checkpoint_manager.save(i + 1, state_tree(model, opt_state))
    return model, opt_state, history
