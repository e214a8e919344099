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
:func:`~repro_torch.models.tree.param_tree` gives any ``{parameter name:
tensor}`` mapping (the parameters, or optimizer moments keyed by them) in
that layout, with each layer leaf a :class:`~repro_torch.core.types.Stacked`
view of the per-layer tensors; :func:`params_to_numpy` and
:func:`params_from_numpy` carry weights between the module and the
reference's numpy tree.

LM serving: :func:`prefill` runs the prompt and returns the last position's
logits and the KV cache (:func:`init_cache`'s layout, ``(L, B, S, Hkv,
Dh)``); :func:`decode_step` feeds one token a step. The sharding specs
wait for the distributed slice.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from . import layers, tree


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
        nested: dict = {}
        for name, p in self.named_parameters():
            *outer, leaf = name.split(".")
            node = nested
            for key in outer:
                node = node.setdefault(key, {})
            node[leaf] = p
        return layers.cast_floats(nested, self.cfg.dtype)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, window: int | None,
                collect: bool = False):
        """x (B, S, d) -> (x after the layer, MoE aux loss), and with
        ``collect`` the layer's (k, v), each (B, S, Hkv, Dh) after RoPE;
        ``cos``/``sin`` are RoPE's tables (``layers.rope_tables``)."""
        lp = self.weights()
        o, kv = _attn_block(lp, self.cfg, x, cos, sin, window)
        x = x + o
        mlp_out, aux = _mlp_block(lp, self.cfg, x)
        return (x + mlp_out, aux, kv) if collect else (x + mlp_out, aux)

    def decode(self, x: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor, length: int,
               cos: torch.Tensor, sin: torch.Tensor, window: int) -> torch.Tensor:
        """One token, x (B, 1, d), against this layer's cache (B, S, Hkv,
        Dh): its k and v are written into the cache at ``length``, in
        place, and it attends to positions ``< length + 1``."""
        cfg = self.cfg
        b = x.shape[0]
        hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        lp = self.weights()
        h = layers.rms_norm(x, lp["ln_attn"])
        q, k, v = h @ lp["wq"], h @ lp["wk"], h @ lp["wv"]
        if cfg.qkv_bias:
            q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
        q = layers.apply_rope(q.reshape(b, 1, hq, dh), cos, sin)
        cache_k[:, length] = layers.apply_rope(k.reshape(b, 1, hkv, dh), cos, sin)[:, 0]
        cache_v[:, length] = v.reshape(b, hkv, dh)
        o = layers.decode_attention(q, cache_k, cache_v, length=length + 1, window=window)
        x = x + o.reshape(b, 1, hq * dh) @ lp["wo"]
        mlp_out, _ = _mlp_block(lp, cfg, x)
        return x + mlp_out


def _attn_block(lp: dict, cfg: LMConfig, x: torch.Tensor, cos, sin, window):
    """-> (the attention's output (B, S, d), its (k, v) after RoPE)."""
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
    return o.reshape(b, s, hq * dh) @ lp["wo"], (k, v)


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

    def forward(self, tokens: torch.Tensor, *, collect_cache: bool = False):
        """tokens (B, S) -> (hidden (B, S, d) after the final norm, the MoE
        aux loss summed over layers); with ``collect_cache``, (hidden,
        (ks, vs), aux), the per-layer keys and values stacked (L, B, S,
        Hkv, Dh)."""
        cfg = self.cfg
        b, s = tokens.shape
        x = F.embedding(tokens, self.embed).to(cfg.dtype)
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        cos, sin = layers.rope_tables(positions, cfg.head_dim, theta=cfg.rope_theta)
        auxes, kvs = [], []
        for layer, w in zip(self.layers, layer_windows(cfg, s).tolist()):
            window = w if w < s else None  # a window at least S long masks nothing
            if torch.is_grad_enabled():
                out = checkpoint(layer, x, cos, sin, window, collect_cache, use_reentrant=False,
                                 preserve_rng_state=False)
            else:
                out = layer(x, cos, sin, window, collect_cache)
            x, aux = out[0], out[1]
            auxes.append(aux)
            if collect_cache:
                kvs.append(out[2])
        hidden, aux = layers.rms_norm(x, self.ln_final), torch.stack(auxes).sum()
        if collect_cache:
            ks = torch.stack([k for k, _ in kvs])
            vs = torch.stack([v for _, v in kvs])
            return hidden, (ks, vs), aux
        return hidden, aux


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
# Serving: prefill + decode
# ---------------------------------------------------------------------------


def init_cache(cfg: LMConfig, batch: int, max_len: int, *, device=None) -> dict:
    """An empty KV cache: ``k`` and ``v`` (L, B, max_len, Hkv, Dh) in the
    compute dtype, ``length`` 0 (a host int)."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    device = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device), "length": 0}


def _logits(model: Transformer, hidden: torch.Tensor) -> torch.Tensor:
    return (hidden @ model.lm_head.to(model.cfg.dtype)).float()


@torch.no_grad()
def prefill(model: Transformer, tokens: torch.Tensor, *, max_len: int | None = None):
    """Run the prompt (B, S) -> (the last position's logits (B, V) in
    float32, the cache). The cache holds the prompt's keys and values at
    positions ``0 .. S-1`` and ``length`` S; ``max_len`` (default S, the
    reference's) sizes it, so that ``max_len - S`` tokens can follow."""
    hidden, (ks, vs), _ = model(tokens, collect_cache=True)
    s = tokens.shape[1]
    if max_len is not None and max_len > s:
        cache = init_cache(model.cfg, tokens.shape[0], max_len, device=tokens.device)
        cache["k"][:, :, :s], cache["v"][:, :, :s] = ks, vs
    else:
        cache = {"k": ks, "v": vs}
    cache["length"] = s
    return _logits(model, hidden[:, -1]), cache


@torch.no_grad()
def decode_step(model: Transformer, cache: dict, token: torch.Tensor):
    """One autoregressive step, token (B, 1) -> (logits (B, V) in float32,
    the cache). The cache is updated in place: each layer's k and v are
    written at position ``length`` (where the reference's
    ``dynamic_update_slice`` writes them), and ``length`` grows by one. A
    full cache raises (the reference would clamp the write to the last
    position)."""
    cfg = model.cfg
    b = token.shape[0]
    length, max_len = int(cache["length"]), cache["k"].shape[2]
    if length >= max_len:
        raise ValueError(f"the cache is full: length {length} of {max_len}")
    x = F.embedding(token, model.embed).to(cfg.dtype)  # (B, 1, d)
    positions = torch.full((b, 1), length, device=token.device)
    cos, sin = layers.rope_tables(positions, cfg.head_dim, theta=cfg.rope_theta)
    for i, (layer, w) in enumerate(zip(model.layers, layer_windows(cfg, max_len).tolist())):
        x = layer.decode(x, cache["k"][i], cache["v"][i], length, cos, sin, w)
    cache["length"] = length + 1
    return _logits(model, layers.rms_norm(x, model.ln_final))[:, 0], cache


# ---------------------------------------------------------------------------
# The reference's layout
# ---------------------------------------------------------------------------


def params_to_numpy(model: Transformer) -> dict:
    """The module's weights as the reference's parameter tree of numpy
    arrays, layers stacked on a leading axis (bfloat16 as ``'V2'``)."""
    return tree.to_numpy(model)


def params_from_numpy(t, cfg: LMConfig, *, device: str | torch.device | None = None) -> Transformer:
    """A :class:`Transformer` on ``device`` holding the weights of the
    reference's parameter tree (numpy or array-likes, layers stacked)."""
    return tree.load(Transformer(cfg, device=device), t)
