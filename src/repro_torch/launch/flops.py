"""Analytic model FLOPs per (architecture, shape): the roofline numerator.

The port of the JAX package's ``launch/flops.py``. It counts the
algorithmically necessary FLOPs: parameter products (6ND to train, 2ND to
serve, N the active parameters), attention's score and value products, and
the interactions that define a model (two-tower's in-batch logits,
xDeepFM's CIN outer products, the GNN's message products). Embedding
lookups are bytes, not FLOPs, and are left out.

Where the reference takes a recsys model's parameter shapes from
``jax.eval_shape``, the port builds the model on the ``meta`` device, which
allocates nothing.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..configs.base import ArchSpec, ShapeSpec


def _matmul_params(shapes, vocab_cutoff: int = 100_000) -> int:
    """The parameters of every product weight: leaves of two or more
    dimensions whose leading dimension is not a vocabulary."""
    total = 0
    for shape in shapes:
        if len(shape) >= 2 and shape[0] < vocab_cutoff:
            total += math.prod(shape[-2:]) * math.prod(shape[:-2])
    return total


def lm_flops(cfg, tokens: int, *, train: bool, seq_len: int | None = None,
             batch: int | None = None, decode_cache: int | None = None) -> float:
    n = cfg.flops_params()
    f = (6.0 if train else 2.0) * n * tokens
    if decode_cache is not None:  # one-token attention against the cache
        f += 4.0 * cfg.n_layers * (batch or 1) * cfg.n_heads * decode_cache * cfg.head_dim
    elif seq_len is not None:  # causal attention ~ S^2/2 per layer
        mult = 3.0 if train else 1.0
        f += mult * 2.0 * cfg.n_layers * tokens * seq_len * cfg.n_heads * cfg.head_dim
    return f


def gnn_flops(cfg, n: int, e: int, *, train: bool) -> float:
    h = cfg.d_hidden
    per_layer = 2 * h * h * (3 * e + 2 * n)
    io = 2 * n * cfg.d_feat * h + 2 * n * h * cfg.n_classes
    return (3.0 if train else 1.0) * (cfg.n_layers * per_layer + io)


def recsys_param_shapes(cfg) -> list[tuple[int, ...]]:
    """The shapes of a recsys model's parameters, from the model built on
    the ``meta`` device."""
    from ..models import recsys as R

    model = R.MODELS[cfg.kind](cfg, torch.device("meta"))
    return [tuple(p.shape) for p in model.parameters()]


def recsys_flops(cfg, param_shapes, batch: int, *, kind_shape: str) -> float:
    mult = 3.0 if kind_shape == "train" else 1.0
    f = mult * 2.0 * batch * _matmul_params(param_shapes)
    if cfg.kind == "sasrec":
        f += mult * cfg.n_blocks * 4.0 * batch * cfg.seq_len**2 * cfg.embed_dim
    if cfg.kind == "two_tower" and kind_shape == "train":
        dout = cfg.tower_dims[-1]
        f += mult * 2.0 * batch * batch * dout  # in-batch softmax logits
    if cfg.kind == "din":
        d = cfg.embed_dim
        attn = 4 * d * cfg.attn_dims[0] + cfg.attn_dims[0] * cfg.attn_dims[1]
        f += mult * 2.0 * batch * cfg.seq_len * attn
    if cfg.kind == "xdeepfm":
        m, dd = cfg.n_sparse, cfg.embed_dim
        cin = sum(
            2 * h_prev * m * dd * h
            for h_prev, h in zip((m,) + cfg.cin_dims[:-1], cfg.cin_dims)
        )
        f += mult * batch * cin
    return f


def lider_search_flops(rcfg, batch: int) -> float:
    cfg = rcfg.lider
    d = rcfg.dim
    hash_f = 2.0 * batch * d * (
        cfg.n_arrays * (cfg.key_len or 16)
        + cfg.n_arrays_centroid * (cfg.key_len_centroid or 10)
    )
    cen_verify = 2.0 * batch * cfg.r0_centroid * cfg.n_probe * cfg.n_arrays_centroid * d
    r = cfg.r0 * rcfg.k
    verify = 2.0 * batch * cfg.n_probe * cfg.n_arrays * r * d
    return hash_f + cen_verify + verify


def model_flops(arch: ArchSpec, shape: ShapeSpec) -> float:
    """Dispatch on the family; shapes as assigned."""
    if arch.family == "lm":
        cfg = arch.config
        b = shape.dims["global_batch"]
        s = shape.dims["seq_len"]
        if shape.kind == "train":
            return lm_flops(cfg, b * s, train=True, seq_len=s)
        if shape.kind == "prefill":
            return lm_flops(cfg, b * s, train=False, seq_len=s)
        return lm_flops(cfg, b, train=False, batch=b, decode_cache=s)
    if arch.family == "gnn":
        d = shape.dims
        cfg = dataclasses.replace(
            arch.config,
            d_feat=d["d_feat"],
            n_classes=1 if d.get("regression") else d.get("n_classes", 7),
        )
        if shape.name == "minibatch_lg":
            bn = d["batch_nodes"]
            f1, f2 = d["fanout"]
            n = bn + bn * f1 + bn * f1 * f2
            e = bn * f1 + bn * f1 * f2
        elif shape.name == "molecule":
            n = d["batch"] * d["n_nodes"]
            e = d["batch"] * d["n_edges"]
        else:
            n, e = d["n_nodes"], d["n_edges"]
        return gnn_flops(cfg, n, e, train=True)
    if arch.family == "recsys":
        cfg = arch.config
        shapes = recsys_param_shapes(cfg)
        b = shape.dims.get("batch", shape.dims.get("n_candidates", 1))
        if shape.kind == "retrieval":
            b = shape.dims["n_candidates"]
            kind = "serve"
            if cfg.kind == "two_tower":
                return 2.0 * b * cfg.tower_dims[-1]
            if cfg.kind == "sasrec":
                return 2.0 * b * cfg.embed_dim
        else:
            kind = "train" if shape.kind == "train" else "serve"
        return recsys_flops(cfg, shapes, b, kind_shape=kind)
    # retrieval (the paper's arch)
    rcfg = arch.config
    if shape.kind == "build":
        return 2.0 * rcfg.corpus_size * rcfg.lider.n_clusters * rcfg.dim
    return lider_search_flops(rcfg, shape.dims["batch"])
