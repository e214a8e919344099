"""Decoder-only transformer LM: dense or MoE, GQA, RoPE, optional
local/global interleaved attention (llama4-scout's iRoPE style).

The port of the JAX package's ``models/transformer.py`` as an
``nn.Module``: :class:`Transformer` holds the embedding, the LM head, the
final norm and one :class:`Block` per layer, with the reference's parameter
names. Each layer runs under ``torch.utils.checkpoint`` (the reference
wraps its layer body in ``jax.checkpoint(..., nothing_saveable)``), with its
float32 master weights cast to ``cfg.dtype`` inside it, so neither the
layer's activations nor its cast weights outlive its forward.
:func:`lm_loss` is the sequence-chunked cross-entropy: each chunk of
``loss_chunk`` positions is checkpointed too, so one chunk's (B, chunk, V)
logits are live at a time.

The reference keeps its layers stacked on a leading ``(L, ...)`` axis.
:func:`param_tree` gives any ``{parameter name: tensor}`` mapping (the
parameters, or optimizer moments keyed by them) in that layout, with each
layer leaf a :class:`~repro_torch.core.types.Stacked` view of the per-layer
tensors; :func:`params_to_numpy` and :func:`params_from_numpy` carry
weights between the module and the reference's numpy tree.

LM serving (``prefill``, ``decode_step``, ``init_cache``) and the sharding
specs wait for later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.types import Stacked, numpy_to_tensor, tensor_to_numpy
from ..device import resolve_device
from . import layers


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0  # shared (always-on) experts, llama4 style
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int | None = None
    qkv_bias: bool = False
    moe: MoEConfig | None = None
    # every `local_ratio`-th layer is global, the rest use `window` (llama4);
    # window=None -> all layers full attention.
    window: int | None = None
    local_ratio: int = 4
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16  # compute
    param_dtype: torch.dtype = torch.float32  # master weights
    loss_chunk: int = 128

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def flops_params(self) -> int:
        """Parameter count N for the 6*N*D model-FLOPs estimate (active
        params for MoE)."""
        d, dh = self.d_model, self.head_dim
        attn = d * dh * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * dh * d
        if self.moe:
            ff = 3 * d * self.moe.d_ff_expert * (self.moe.top_k + self.moe.n_shared)
        else:
            ff = 3 * d * self.d_ff
        return self.n_layers * (attn + ff) + 2 * self.vocab * d


MOE_SEQ_CHUNK = 8192  # cap on the MoE dispatch buffers' length for long sequences


def layer_windows(cfg: LMConfig, seq_len: int) -> torch.Tensor:
    """Per-layer attention window, int32 (L,); ``2**30`` (the mask never
    fires) on full-attention layers."""
    full = torch.full((cfg.n_layers,), 2**30, dtype=torch.int32)
    if cfg.window is None:
        return full
    idx = torch.arange(cfg.n_layers)
    is_global = (idx % cfg.local_ratio) == (cfg.local_ratio - 1)
    return torch.where(is_global, full, torch.tensor(cfg.window, dtype=torch.int32))


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


def _mlp_params(d: int, ff: int, dtype, device, *, experts: int | None = None) -> nn.ParameterDict:
    lead = () if experts is None else (experts,)
    return nn.ParameterDict({
        "w_gate": _param(lead + (d, ff), dtype, device),
        "w_up": _param(lead + (d, ff), dtype, device),
        "w_down": _param(lead + (ff, d), dtype, device),
    })


class Block(nn.Module):
    """One decoder layer: pre-norm GQA attention, then a pre-norm SwiGLU
    MLP or MoE. Parameters are allocated, not initialised
    (:meth:`Transformer.reset_parameters`)."""

    def __init__(self, cfg: LMConfig, device):
        super().__init__()
        self.cfg = cfg
        d, dh, pd = cfg.d_model, cfg.head_dim, cfg.param_dtype
        hq, hkv = cfg.n_heads, cfg.n_kv_heads
        self.ln_attn = _param((d,), pd, device)
        self.ln_mlp = _param((d,), pd, device)
        self.wq = _param((d, hq * dh), pd, device)
        self.wk = _param((d, hkv * dh), pd, device)
        self.wv = _param((d, hkv * dh), pd, device)
        self.wo = _param((hq * dh, d), pd, device)
        if cfg.qkv_bias:
            self.bq = _param((hq * dh,), pd, device)
            self.bk = _param((hkv * dh,), pd, device)
            self.bv = _param((hkv * dh,), pd, device)
        if cfg.moe:
            e, ffe = cfg.moe.n_experts, cfg.moe.d_ff_expert
            self.moe = _mlp_params(d, ffe, pd, device, experts=e)
            self.moe["router"] = _param((d, e), torch.float32, device)
            if cfg.moe.n_shared:
                self.shared = _mlp_params(d, ffe * cfg.moe.n_shared, pd, device)
        else:
            self.mlp = _mlp_params(d, cfg.d_ff, pd, device)

    def weights(self) -> dict:
        """The layer's parameters as the reference's nested dict, cast to
        the compute dtype (the router stays float32)."""
        tree: dict = {}
        for name, p in self.named_parameters():
            *outer, leaf = name.split(".")
            node = tree
            for key in outer:
                node = node.setdefault(key, {})
            node[leaf] = p
        return layers.cast_floats(tree, self.cfg.dtype)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, window: int | None):
        """x (B, S, d) -> (x after the layer, MoE aux loss); ``cos``/``sin``
        are RoPE's tables (``layers.rope_tables``)."""
        lp = self.weights()
        x = x + _attn_block(lp, self.cfg, x, cos, sin, window)
        mlp_out, aux = _mlp_block(lp, self.cfg, x)
        return x + mlp_out, aux


def _attn_block(lp: dict, cfg: LMConfig, x: torch.Tensor, cos, sin, window) -> torch.Tensor:
    b, s, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = layers.rms_norm(x, lp["ln_attn"])
    q, k, v = h @ lp["wq"], h @ lp["wk"], h @ lp["wv"]
    if cfg.qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    q = layers.apply_rope(q.reshape(b, s, hq, dh), cos, sin)
    k = layers.apply_rope(k.reshape(b, s, hkv, dh), cos, sin)
    v = v.reshape(b, s, hkv, dh)
    o = layers.flash_attention(q, k, v, causal=True, window=window)
    return o.reshape(b, s, hq * dh) @ lp["wo"]


def _mlp_block(lp: dict, cfg: LMConfig, x: torch.Tensor):
    h = layers.rms_norm(x, lp["ln_mlp"])
    if not cfg.moe:
        return layers.swiglu_mlp(lp["mlp"], h), torch.zeros((), device=x.device)
    s = h.shape[1]
    moe = lambda hx: layers.moe_mlp(
        lp["moe"], hx, top_k=cfg.moe.top_k, capacity_factor=cfg.moe.capacity_factor
    )
    if s > MOE_SEQ_CHUNK and s % MOE_SEQ_CHUNK == 0:
        # Dispatch sequence chunks one after another: one chunk's expert
        # buffers are live at a time.
        parts = [moe(h[:, i : i + MOE_SEQ_CHUNK]) for i in range(0, s, MOE_SEQ_CHUNK)]
        out = torch.cat([o for o, _ in parts], dim=1)
        aux = torch.stack([a for _, a in parts]).sum()
    else:
        out, aux = moe(h)
    if cfg.moe.n_shared:
        out = out + layers.swiglu_mlp(lp["shared"], h)
    return out, aux


class Transformer(nn.Module):
    """The LM: ``embed`` (V, d), ``layers`` (one :class:`Block` each),
    ``ln_final`` (d,), ``lm_head`` (d, V). Built with allocated but
    uninitialised parameters on ``device``; :func:`init` draws them."""

    def __init__(self, cfg: LMConfig, *, device: str | torch.device | None = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        d, pd = cfg.d_model, cfg.param_dtype
        self.embed = _param((cfg.vocab, d), pd, device)
        self.lm_head = _param((d, cfg.vocab), pd, device)
        self.ln_final = _param((d,), pd, device)
        self.layers = nn.ModuleList(Block(cfg, device) for _ in range(cfg.n_layers))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw every weight as the reference's ``init`` does: norms 1,
        biases 0, matrices N(0, 1) / sqrt(shape[0]) (the embedding
        N(0, 0.02^2)), drawn in float32 and cast to the parameter dtype."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf.startswith("ln_"):
                p.fill_(1.0)
            elif leaf in ("bq", "bk", "bv"):
                p.zero_()
            else:
                scale = 0.02 if name == "embed" else 1.0 / (p.shape[0] ** 0.5)
                z = torch.randn(p.shape, generator=generator, dtype=torch.float32, device=p.device)
                p.copy_(z.mul_(scale))

    def forward(self, tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """tokens (B, S) -> (hidden (B, S, d) after the final norm, the MoE
        aux loss summed over layers)."""
        cfg = self.cfg
        b, s = tokens.shape
        x = F.embedding(tokens, self.embed).to(cfg.dtype)
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        cos, sin = layers.rope_tables(positions, cfg.head_dim, theta=cfg.rope_theta)
        auxes = []
        for layer, w in zip(self.layers, layer_windows(cfg, s).tolist()):
            window = w if w < s else None  # a window at least S long masks nothing
            if torch.is_grad_enabled():
                x, aux = checkpoint(layer, x, cos, sin, window, use_reentrant=False,
                                    preserve_rng_state=False)
            else:
                x, aux = layer(x, cos, sin, window)
            auxes.append(aux)
        return layers.rms_norm(x, self.ln_final), torch.stack(auxes).sum()


def init(seed: int, cfg: LMConfig, *, device: str | torch.device | None = None) -> Transformer:
    """A :class:`Transformer` drawn from ``seed`` by a ``torch.Generator``
    on ``device`` (None = the CUDA device). Not the reference's values:
    the two frameworks' random streams differ."""
    model = Transformer(cfg, device=device)
    dev = next(model.parameters()).device
    model.reset_parameters(torch.Generator(device=dev).manual_seed(seed))
    return model


def _chunk_loss(h: torch.Tensor, t: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    logits = (h @ head).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, t[..., None])[..., 0]
    return torch.sum(lse - gold)


def lm_loss(model: Transformer, hidden: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy, ``loss_chunk`` positions at a time."""
    b, s, _ = hidden.shape
    chunk = min(model.cfg.loss_chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of loss_chunk {chunk}")
    head = model.lm_head.to(model.cfg.dtype)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, s, chunk):
        h, t = hidden[:, i : i + chunk], targets[:, i : i + chunk]
        if torch.is_grad_enabled():
            total = total + checkpoint(_chunk_loss, h, t, head, use_reentrant=False,
                                       preserve_rng_state=False)
        else:
            total = total + _chunk_loss(h, t, head)
    return total / (b * s)


def train_loss(model: Transformer, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    hidden, aux = model(batch["tokens"])
    return lm_loss(model, hidden, batch["targets"]) + 0.01 * aux


# ---------------------------------------------------------------------------
# The reference's layout
# ---------------------------------------------------------------------------


def param_tree(named: Mapping[str, torch.Tensor]) -> dict:
    """``{parameter name: tensor}`` in the reference's nested layout:
    ``layers.{i}.moe.w_up`` becomes the ``i``-th part of the
    :class:`Stacked` leaf ``tree["layers"]["moe"]["w_up"]``; no copy."""
    tree: dict = {}
    stacks: dict[tuple, dict[int, torch.Tensor]] = {}
    for name, t in named.items():
        parts = name.split(".")
        if parts[0] == "layers":
            stacks.setdefault(("layers", *parts[2:]), {})[int(parts[1])] = t
        else:
            _set(tree, parts, t)
    for key, by_layer in stacks.items():
        _set(tree, key, Stacked([by_layer[i] for i in range(len(by_layer))]))
    return tree


def _set(tree: dict, path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _lookup(tree, name: str) -> np.ndarray:
    parts = name.split(".")
    index = None
    if parts[0] == "layers":
        index, parts = int(parts[1]), ["layers", *parts[2:]]
    node = tree
    for key in parts:
        node = node[key]
    return node if index is None else node[index]


def params_to_numpy(model: Transformer) -> dict:
    """The module's weights as the reference's parameter tree of numpy
    arrays, layers stacked on a leading axis (bfloat16 as ``'V2'``)."""

    def leaf(v):
        if isinstance(v, Stacked):
            return np.stack([tensor_to_numpy(t) for t in v.parts])
        return tensor_to_numpy(v)

    def walk(node):
        return {k: walk(v) for k, v in node.items()} if isinstance(node, dict) else leaf(node)

    return walk(param_tree(dict(model.named_parameters())))


@torch.no_grad()
def params_from_numpy(tree, cfg: LMConfig, *, device: str | torch.device | None = None) -> Transformer:
    """A :class:`Transformer` on ``device`` holding the weights of the
    reference's parameter tree (numpy or array-likes, layers stacked)."""
    model = Transformer(cfg, device=device)
    for name, p in model.named_parameters():
        t = numpy_to_tensor(np.asarray(_lookup(tree, name)))
        if t.shape != p.shape or t.dtype != p.dtype:
            raise ValueError(f"{name}: tree holds {tuple(t.shape)} {t.dtype}, "
                             f"the model {tuple(p.shape)} {p.dtype}")
        p.copy_(t)
    return model
