"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

The port of the JAX package's ``launch/train.py``: config registry ->
synthetic data pipeline -> train step -> checkpoint manager. It takes the
reference's flags plus ``--device`` (default: the CUDA device; ``cpu``
runs on the CPU by name; with no card and no ``--device cpu`` it raises).
``--preset smoke`` trains the architecture's reduced config
(:func:`reduced_lm`, :func:`reduced_recsys`, :func:`reduced_gnn`), ``full``
the published widths. Every assigned architecture of the registry trains:
the LMs on token batches, the recsys models on their step-indexed batches,
and the GNN full-batch on one random graph of 512 nodes and 4,096 edges.

With ``--ckpt-dir`` a :class:`~repro_torch.training.checkpoint.
CheckpointManager` saves ``{"params", "opt_state"}`` every
``--ckpt-every`` steps in the reference's layout, and a run whose directory
already holds a step resumes from the newest verified one (the data
pipeline is step-indexed, so the resumed run sees the batches it would
have seen).

:func:`main` takes the arguments as a list and returns the logged history.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Sequence

import torch

from ..configs import get_arch
from ..data import pipeline as pipe_lib
from ..data import synthetic
from ..device import resolve_device
from ..models import gnn as gnn_lib
from ..models import recsys as recsys_lib
from ..models import transformer as tfm
from ..training import checkpoint as ckpt_lib
from ..training import optimizer as opt_lib
from ..training import train_loop


def reduced_lm(cfg: tfm.LMConfig) -> tfm.LMConfig:
    """The smoke preset: two layers of width 128, keeping the family's
    traits (GQA ratio, MoE, local windows), float32 compute."""
    return dataclasses.replace(
        cfg,
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=max(1, cfg.n_kv_heads * 4 // cfg.n_heads),
        d_head=32,
        d_ff=256,
        vocab=512,
        moe=dataclasses.replace(cfg.moe, n_experts=4, top_k=min(2, cfg.moe.top_k), d_ff_expert=64)
        if cfg.moe
        else None,
        dtype=torch.float32,
    )


def reduced_recsys(cfg: recsys_lib.RecsysConfig) -> recsys_lib.RecsysConfig:
    """The smoke preset of a recsys model: small vocabularies and towers."""
    return dataclasses.replace(
        cfg,
        item_vocab=2048,
        field_vocab=256,
        seq_len=min(cfg.seq_len, 20),
        tower_dims=(64, 32),
        cin_dims=(16, 16),
        dnn_dims=(32, 32),
        n_sparse=min(cfg.n_sparse, 13),
    )


def reduced_gnn(cfg: gnn_lib.GNNConfig) -> gnn_lib.GNNConfig:
    """The smoke preset of the GNN: 3 layers of width 32."""
    return dataclasses.replace(cfg, n_layers=3, d_hidden=32, d_feat=16, n_classes=5)


def build_task(arch_id: str, preset: str, batch: int, seq: int, *, device=None):
    """-> (model, loss_fn, batch_at) on ``device``; the smoke preset
    shrinks the config."""
    arch = get_arch(arch_id)
    device = resolve_device(device)
    smoke = preset == "smoke"
    if arch.family == "lm":
        cfg = reduced_lm(arch.config) if smoke else arch.config
        model = tfm.init(0, cfg, device=device)
        batch_at = lambda s: synthetic.lm_batch(0, s, batch=batch, seq=seq, vocab=cfg.vocab,
                                                device=device)
        return model, tfm.train_loss, batch_at
    if arch.family == "recsys":
        cfg = reduced_recsys(arch.config) if smoke else arch.config
        model = recsys_lib.init(0, cfg, device=device)
        batch_at = lambda s: synthetic.recsys_batch(0, s, kind=cfg.kind, batch=batch, cfg=cfg,
                                                    device=device)
        return model, recsys_lib.LOSS[cfg.kind], batch_at
    if arch.family == "gnn":
        cfg = reduced_gnn(arch.config) if smoke else arch.config
        model = gnn_lib.init(0, cfg, device=device)
        graph = synthetic.random_graph(0, 512, 4096, cfg.d_feat, cfg.n_classes, device=device)
        g = {k: graph[k] for k in ("node_feat", "edge_index", "labels")}
        return model, gnn_lib.train_loss, lambda s: g  # full-batch
    raise ValueError(f"{arch_id}: family {arch.family} has no training entry point")


def main(argv: Sequence[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--preset", choices=["smoke", "full"], default="smoke")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    args = ap.parse_args(argv)

    model, loss_fn, batch_at = build_task(args.arch, args.preset, args.batch, args.seq,
                                          device=args.device)
    opt_cfg = opt_lib.OptimizerConfig(
        peak_lr=args.lr, warmup_steps=max(args.steps // 10, 1), decay_steps=args.steps
    )
    opt_state = opt_lib.init_state(dict(model.named_parameters()))
    step = train_loop.make_train_step(loss_fn, opt_cfg, grad_accum=args.grad_accum)
    mgr = ckpt_lib.CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if mgr is not None:
        restored, _ = mgr.restore_latest(train_loop.state_tree(model, opt_state))
        if restored is not None:
            start = restored
            print(f"resumed from {args.ckpt_dir} at step {start}")
    pipe = pipe_lib.DataPipeline(batch_at, start_step=start, prefetch=2)
    try:
        _, _, history = train_loop.run(
            step,
            model,
            opt_state,
            pipe,
            n_steps=args.steps,
            checkpoint_manager=mgr,
            checkpoint_every=args.ckpt_every,
            start_step=start,
        )
    finally:
        pipe.close()
    return history


if __name__ == "__main__":
    main()
