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
Dh)``); :func:`decode_step` feeds one token a step.

On a grid (``launch.mesh.use_grid``, parameters laid out by
:func:`param_specs` through ``sharding.shard_module``) the same entry points
run Megatron tensor parallelism over ``model`` and FSDP over the data axes:

- ``wq``/``wk``/``wv`` (and their biases) are split evenly by their
  flattened head columns over ``model``, ``wo`` by row, as the reference
  stores them; the attention's output is summed over ``model``. Where the
  heads split whole (``n_heads`` and ``n_kv_heads`` divisible by the
  model ranks) rank ``r`` attends with its own query heads and the kv
  heads they read. Where they do not (GQA's few kv heads, or 24 query
  heads over 16 ranks), the rank all-gathers the k and v columns over
  ``model`` (and the q columns where the query heads do not split whole),
  attends with the query heads whose output columns meet its ``wo`` rows,
  and keeps those columns: exactly what one device computes
  (:func:`_heads`). The MLP's ``w_gate``/``w_up`` by column, ``w_down``
  by row. MoE experts split over ``model`` (``layers.moe_mlp``).
- Each layer's data-split weights are all-gathered inside the layer, so
  the checkpointed recompute gathers them again and no gathered weight
  outlives the step; the gather's backward sums the gradient over the data
  axes and keeps the rank's block.
- ``embed`` is vocabulary-parallel (a masked local take, summed over
  ``model``) and so is ``lm_head``, with a vocabulary-parallel
  cross-entropy (the maximum and the sum of exponentials over ``model``,
  the gold logit from the rank that holds it), chunked as on one device.
- ``seq_shard_activations`` splits the residual stream's sequence over
  ``model`` between the layers' attention and MLP (all-gathered before
  each, reduce-scattered after).
- The loss is the mean over the global batch (every data rank's rows).
- Decode splits the cache by :func:`cache_specs`: the sequence over
  ``model`` (batch over data), or over every axis (``seq_sharded``). Each
  rank attends over its positions and the partials are combined
  (``layers.decode_attention_split``); q, k and v are all-gathered over
  their columns first, and the rank holding position ``length`` writes k
  and v.

The reference stacks its layers (a leading ``L`` axis, spec entry None);
the port keeps a :class:`Block` per layer, so its per-layer spec is the
reference's without that leading None.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..launch.mesh import current_grid
from . import layers, sharding, tree


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
    # Sequence parallelism for activations: on a grid the residual stream
    # splits its sequence over 'model' between the layers' attention and
    # MLP, at the cost of a sequence all-gather before each.
    seq_shard_activations: bool = False

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


@dataclasses.dataclass(frozen=True)
class _Layout:
    """How the work of one call splits over a grid: rows over ``dp``,
    heads, MLP columns, experts and the vocabulary over ``tp``, and with
    ``seq`` the residual stream's sequence over ``tp`` too. Without a grid
    (``grid`` None, no axes) every collective the layers call is the
    identity, so one body serves both."""

    grid: object = None
    dp: tuple[str, ...] = ()
    tp: tuple[str, ...] = ()
    seq: bool = False
    # Whether the query and kv heads split whole over ``tp`` (module
    # docstring; :func:`_heads`).
    whole_heads: bool = True

    @property
    def act(self) -> tuple[str, ...]:
        """The axes the residual stream (and so the norms) splits over."""
        return self.dp + (self.tp if self.seq else ())

    @property
    def tp_size(self) -> int:
        return sharding.size_of(self.grid, self.tp)


_LOCAL = _Layout()  # one device


def _layout(cfg: "LMConfig", grid, *, seq: bool | None = None) -> _Layout:
    if grid is None:
        return _LOCAL
    names = grid.axis_names
    tp = sharding.physical_axes(sharding.TP, names)
    tpn = sharding.size_of(grid, tp)
    return _Layout(grid, sharding.physical_axes(sharding.DP, names), tp,
                   cfg.seq_shard_activations if seq is None else seq,
                   cfg.n_heads % tpn == 0 and cfg.n_kv_heads % tpn == 0)


def _heads(cfg: LMConfig, L: _Layout, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           cos, sin):
    """The rank's q, k, v columns (B, S, cols) -> (q, k, v) in whole heads
    after RoPE for the rank's attention, the (k, v) to keep for the cache,
    and the slice of the attention's flattened output that meets the
    rank's ``wo`` rows (None: all of it).

    Heads split whole (and on one device): the rank's own heads. Otherwise
    k and v are all-gathered over ``tp`` (and q where the query heads do
    not split whole); the rank takes the query heads ``h_lo .. h_hi - 1``
    that its ``wo`` rows read and the kv heads they read: a contiguous
    range where each of them serves as many of those query heads, else one
    kv head per query head. The gathers' backward sums the gradient over
    ``tp`` and keeps the rank's columns. The cache keeps every kv head."""
    b, s, _ = q.shape
    dh = cfg.head_dim
    if L.whole_heads:
        q = layers.apply_rope(q.reshape(b, s, -1, dh), cos, sin)
        k = layers.apply_rope(k.reshape(b, s, -1, dh), cos, sin)
        v = v.reshape(b, s, -1, dh)
        return q, k, v, (k, v), None
    hq, hkv, grid = cfg.n_heads, cfg.n_kv_heads, L.grid
    cq = hq * dh // L.tp_size
    c_lo = sharding.my_index(grid, L.tp) * cq
    h_lo, h_hi = c_lo // dh, -(-(c_lo + cq) // dh)
    if hq % L.tp_size:
        q = sharding.gather(q, grid, L.tp, 2).reshape(b, s, hq, dh)[:, :, h_lo:h_hi]
    q = layers.apply_rope(q.reshape(b, s, h_hi - h_lo, dh), cos, sin)
    k = layers.apply_rope(sharding.gather(k, grid, L.tp, 2).reshape(b, s, hkv, dh), cos, sin)
    v = sharding.gather(v, grid, L.tp, 2).reshape(b, s, hkv, dh)
    g = hq // hkv
    need = [h // g for h in range(h_lo, h_hi)]
    n_kv = need[-1] - need[0] + 1
    per = (h_hi - h_lo) // n_kv
    if (h_hi - h_lo) % n_kv == 0 and all(need[i] - need[0] == i // per for i in range(len(need))):
        ks, vs = k[:, :, need[0] : need[-1] + 1], v[:, :, need[0] : need[-1] + 1]
    else:
        idx = torch.tensor(need, device=k.device)
        ks, vs = k.index_select(2, idx), v.index_select(2, idx)
    return q, ks, vs, (k, v), slice(c_lo - h_lo * dh, c_lo - h_lo * dh + cq)


def _enter(h: torch.Tensor, L: _Layout) -> torch.Tensor:
    """A layer's normed input as every tp rank holds it: the whole
    sequence (all-gathered when the stream is sequence-split; its gradient
    is whole on every rank, so the backward keeps the rank's slice)."""
    return sharding.gather(h, L.grid, L.tp, 1, grad="slice") if L.seq else h


def _leave(out: torch.Tensor, L: _Layout) -> torch.Tensor:
    """A tp-partial output summed over ``model`` (and split by sequence
    again when the stream is sequence-split)."""
    if L.seq:
        return sharding.reduce_scatter(out, L.grid, L.tp, 1)
    return sharding.reduce_from(out, L.grid, L.tp)


def _windows(cfg: LMConfig) -> list[int]:
    """Per-layer attention window; ``2**30`` (the mask never fires) on
    full-attention layers. Host ints: the layers read them to build their
    masks, with no device tensor to read back."""
    if cfg.window is None:
        return [2**30] * cfg.n_layers
    return [2**30 if i % cfg.local_ratio == cfg.local_ratio - 1 else cfg.window
            for i in range(cfg.n_layers)]


def layer_windows(cfg: LMConfig, seq_len: int) -> torch.Tensor:
    """Per-layer attention window, int32 (L,); ``2**30`` (the mask never
    fires) on full-attention layers."""
    return torch.tensor(_windows(cfg), dtype=torch.int32)


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

    def weights(self, L: _Layout = _LOCAL) -> dict:
        """The layer's parameters as the reference's nested dict, cast to
        the compute dtype (the router stays float32). On a grid each is
        read through ``sharding.materialize``: its data-split dimensions
        gathered (then cast), the norms over the residual stream's axes."""
        nested: dict = {}
        for name, p in self.named_parameters():
            *outer, leaf = name.split(".")
            node = nested
            for key in outer:
                node = node.setdefault(key, {})
            node[leaf] = sharding.materialize(p, L.grid, L.act if leaf.startswith("ln_") else L.dp)
        return layers.cast_floats(nested, self.cfg.dtype)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, window: int | None,
                collect: bool = False, grid=None):
        """x (B, S, d) -> (x after the layer, MoE aux loss), and with
        ``collect`` the layer's (k, v), each (B, S, Hkv, Dh) after RoPE;
        ``cos``/``sin`` are RoPE's tables (``layers.rope_tables``). On a
        ``grid`` (passed in, so that the checkpointed recompute sees it) x
        is the rank's block of the residual stream and k, v its heads."""
        L = _layout(self.cfg, grid)
        lp = self.weights(L)
        o, kv = _attn_block(lp, self.cfg, x, cos, sin, window, L)
        x = x + o
        mlp_out, aux = _mlp_block(lp, self.cfg, x, L)
        return (x + mlp_out, aux, kv) if collect else (x + mlp_out, aux)

    def decode(self, x: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor, length: int,
               cos: torch.Tensor, sin: torch.Tensor, window: int, grid=None,
               seq_axes: tuple[str, ...] = ()) -> torch.Tensor:
        """One token, x (B, 1, d), against this layer's cache (B, S, Hkv,
        Dh): its k and v are written into the cache at ``length``, in
        place, and it attends to positions ``< length + 1``. On a grid the
        cache holds the rank's positions (split over ``seq_axes``)."""
        cfg = self.cfg
        b = x.shape[0]
        L = _layout(cfg, grid, seq=False)
        hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        lp = self.weights(L)
        h = layers.rms_norm(x, lp["ln_attn"])
        q, k, v = h @ lp["wq"], h @ lp["wk"], h @ lp["wv"]
        if cfg.qkv_bias:
            q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
        # On a grid: every column of the token's q, k and v, then the
        # rank's positions of the cache.
        q, k, v = (sharding.gather(t, grid, L.tp, 2) for t in (q, k, v))
        q = layers.apply_rope(q.reshape(b, 1, hq, dh), cos, sin)
        k = layers.apply_rope(k.reshape(b, 1, hkv, dh), cos, sin)
        v = v.reshape(b, 1, hkv, dh)
        if grid is None:
            cache_k[:, length], cache_v[:, length] = k[:, 0], v[:, 0]
            o = layers.decode_attention(q, cache_k, cache_v, length=length + 1, window=window)
            x = x + o.reshape(b, 1, hq * dh) @ lp["wo"]
        else:
            s_loc = cache_k.shape[1]
            lo = sharding.my_index(grid, seq_axes) * s_loc
            if lo <= length < lo + s_loc:
                cache_k[:, length - lo], cache_v[:, length - lo] = k[:, 0], v[:, 0]
            o = layers.decode_attention_split(q, cache_k, cache_v, length=length + 1,
                                              window=window, offset=lo, grid=grid, axes=seq_axes)
            cq = lp["wo"].shape[0]  # the rank's rows of wo: its columns of the output
            c_lo = sharding.my_index(grid, L.tp) * cq
            o = o.reshape(b, 1, hq * dh)[:, :, c_lo : c_lo + cq]
            x = x + sharding.reduce_from(o @ lp["wo"], grid, L.tp)
        mlp_out, _ = _mlp_block(lp, cfg, x, L)
        return x + mlp_out


def _attn_block(lp: dict, cfg: LMConfig, x: torch.Tensor, cos, sin, window, L: _Layout):
    """-> (the attention's output (B, S, d), its (k, v) after RoPE). On a
    grid: the rank's heads, the output summed over ``model``."""
    h = sharding.copy_to(_enter(layers.rms_norm(x, lp["ln_attn"]), L), L.grid, L.tp)
    b, s, _ = h.shape
    q, k, v = h @ lp["wq"], h @ lp["wk"], h @ lp["wv"]
    if cfg.qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    q, k, v, kv, cols = _heads(cfg, L, q, k, v, cos, sin)
    o = layers.flash_attention(q, k, v, causal=True, window=window).reshape(b, s, -1)
    if cols is not None:
        o = o[:, :, cols]
    return _leave(o @ lp["wo"], L), kv


def _mlp_block(lp: dict, cfg: LMConfig, x: torch.Tensor, L: _Layout):
    """-> (the MLP's output, the MoE aux loss). On a grid: the dense MLP
    split by columns and rows, or the rank's experts (and its columns of
    the shared experts), the output summed over ``model``."""
    h = _enter(layers.rms_norm(x, lp["ln_mlp"]), L)
    hp = sharding.copy_to(h, L.grid, L.tp)
    if not cfg.moe:
        return _leave(layers.swiglu_mlp(lp["mlp"], hp), L), torch.zeros((), device=x.device)
    s = h.shape[1]
    moe = lambda hx: layers.moe_mlp(
        lp["moe"], hx, top_k=cfg.moe.top_k, capacity_factor=cfg.moe.capacity_factor,
        grid=L.grid, tp=L.tp, dp=L.dp,
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
        out = out + layers.swiglu_mlp(lp["shared"], hp)
    return _leave(out, L), aux


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
        Hkv, Dh). Under an ambient grid: the rank's rows, hidden whole on
        every model rank, and k, v the rank's kv heads (every kv head where
        the heads do not split whole over ``model``)."""
        cfg = self.cfg
        grid = current_grid()
        L = _layout(cfg, grid)
        b, s = tokens.shape
        got = sharding.vocab_take(sharding.materialize(self.embed, grid, L.dp), tokens, grid, L.tp)
        x = (sharding.reduce_scatter(got, grid, L.tp, 1) if L.seq
             else sharding.reduce_from(got, grid, L.tp)).to(cfg.dtype)
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        cos, sin = layers.rope_tables(positions, cfg.head_dim, theta=cfg.rope_theta)
        auxes, kvs = [], []
        for layer, w in zip(self.layers, _windows(cfg)):
            window = w if w < s else None  # a window at least S long masks nothing
            if torch.is_grad_enabled():
                out = checkpoint(layer, x, cos, sin, window, collect_cache, grid,
                                 use_reentrant=False, preserve_rng_state=False)
            else:
                out = layer(x, cos, sin, window, collect_cache, grid)
            x, aux = out[0], out[1]
            auxes.append(aux)
            if collect_cache:
                kvs.append(out[2])
        aux = torch.stack(auxes).sum()
        hidden = _enter(layers.rms_norm(x, sharding.materialize(self.ln_final, grid, L.act)), L)
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
    gold = torch.gather(logits, -1, t.long()[..., None])[..., 0]
    return torch.sum(lse - gold)


def _chunk_loss_sharded(h: torch.Tensor, t: torch.Tensor, head: torch.Tensor, grid,
                        tp: tuple[str, ...]) -> torch.Tensor:
    """The chunk's summed cross-entropy with the vocabulary split over
    ``tp``: ``head`` is the rank's (d, V/tp) columns."""
    h = sharding.copy_to(h, grid, tp)
    logits = (h @ head).float()
    m = sharding.all_max(torch.amax(logits, dim=-1), grid, tp)
    se = sharding.reduce_from(torch.sum(torch.exp(logits - m[..., None]), dim=-1), grid, tp)
    lse = m + torch.log(se)
    v_loc = head.shape[1]
    local = t - sharding.my_index(grid, tp) * v_loc
    inside = (local >= 0) & (local < v_loc)
    gold = torch.gather(logits, -1, torch.clamp(local, 0, v_loc - 1).long()[..., None])[..., 0]
    gold = sharding.reduce_from(torch.where(inside, gold, 0.0), grid, tp)
    return torch.sum(lse - gold)


def lm_loss(model: Transformer, hidden: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy, ``loss_chunk`` positions at a time.
    Under an ambient grid: vocabulary-parallel over ``model``, the mean
    over every data rank's rows (the same value on every rank)."""
    b, s, _ = hidden.shape
    chunk = min(model.cfg.loss_chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of loss_chunk {chunk}")
    grid = current_grid()
    L = _layout(model.cfg, grid)
    head = sharding.materialize(model.lm_head, grid, L.dp).to(model.cfg.dtype)
    fn, extra = (_chunk_loss, ()) if grid is None else (_chunk_loss_sharded, (grid, L.tp))
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, s, chunk):
        h, t = hidden[:, i : i + chunk], targets[:, i : i + chunk]
        if torch.is_grad_enabled():
            total = total + checkpoint(fn, h, t, head, *extra, use_reentrant=False,
                                       preserve_rng_state=False)
        else:
            total = total + fn(h, t, head, *extra)
    return sharding.reduce_from(total / (b * s * sharding.size_of(grid, L.dp)), grid, L.dp)


def train_loss(model: Transformer, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    hidden, aux = model(batch["tokens"])
    return lm_loss(model, hidden, batch["targets"]) + 0.01 * aux


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------


def init_cache(cfg: LMConfig, batch: int, max_len: int, *, device=None,
               seq_sharded: bool = False) -> dict:
    """An empty KV cache: ``k`` and ``v`` (L, B, max_len, Hkv, Dh) in the
    compute dtype, ``length`` 0 (a host int). Under an ambient grid, the
    rank's block of that cache under :func:`cache_specs` (``seq_sharded``
    chooses the layout, which the cache records)."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    device = resolve_device(device)
    grid = current_grid()
    layout = {}
    if grid is not None:
        spec = sharding.resolve_spec(cache_specs(cfg, grid.axis_names, seq_sharded=seq_sharded)["k"],
                                     grid.axis_names)
        shape = tuple(sl.stop - sl.start if sl.stop is not None else n
                      for n, sl in zip(shape, sharding.block_slices(shape, spec, grid)))
        layout = {"seq_sharded": seq_sharded}
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device), "length": 0, **layout}


def _seq_axes(grid, seq_sharded: bool) -> tuple[str, ...]:
    """The axes a sharded cache splits its sequence over."""
    return sharding.physical_axes(sharding.ALL if seq_sharded else sharding.TP, grid.axis_names)


def _logits(model: Transformer, hidden: torch.Tensor) -> torch.Tensor:
    L = _layout(model.cfg, current_grid(), seq=False)
    head = sharding.materialize(model.lm_head, L.grid, L.dp).to(model.cfg.dtype)
    return sharding.gather((hidden @ head).float(), L.grid, L.tp, -1)


@torch.no_grad()
def prefill(model: Transformer, tokens: torch.Tensor, *, max_len: int | None = None,
            seq_sharded: bool = False):
    """Run the prompt (B, S) -> (the last position's logits (B, V) in
    float32, the cache). The cache holds the prompt's keys and values at
    positions ``0 .. S-1`` and ``length`` S; ``max_len`` (default S, the
    reference's) sizes it, so that ``max_len - S`` tokens can follow.

    Under an ambient grid ``tokens`` are the rank's rows (split over the
    data axes; with ``seq_sharded``, the whole batch on every rank) and the
    cache is the rank's block under :func:`cache_specs`."""
    hidden, (ks, vs), _ = model(tokens, collect_cache=True)
    b, s = tokens.shape
    grid = current_grid()
    if grid is not None:
        L = _layout(model.cfg, grid, seq=False)
        if L.whole_heads:  # the layers kept their own kv heads; else every one
            ks, vs = (sharding.gather(t, grid, L.tp, 3) for t in (ks, vs))
        n = sharding.size_of(grid, _seq_axes(grid, seq_sharded))
        max_len = max(max_len or s, s)
        cache = init_cache(model.cfg, b * (1 if seq_sharded else sharding.size_of(grid, L.dp)),
                           max_len, device=tokens.device, seq_sharded=seq_sharded)
        s_loc = max_len // n
        lo = sharding.my_index(grid, _seq_axes(grid, seq_sharded)) * s_loc
        hi = min(lo + s_loc, s)
        if hi > lo:
            cache["k"][:, :, : hi - lo], cache["v"][:, :, : hi - lo] = ks[:, :, lo:hi], vs[:, :, lo:hi]
    elif max_len is not None and max_len > s:
        cache = init_cache(model.cfg, b, max_len, device=tokens.device)
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
    grid = current_grid()
    seq_axes = () if grid is None else _seq_axes(grid, cache.get("seq_sharded", False))
    length = int(cache["length"])
    max_len = cache["k"].shape[2] * sharding.size_of(grid, seq_axes)
    if length >= max_len:
        raise ValueError(f"the cache is full: length {length} of {max_len}")
    L = _layout(cfg, grid, seq=False)
    table = sharding.materialize(model.embed, grid, L.dp)
    x = sharding.reduce_from(sharding.vocab_take(table, token, grid, L.tp), grid,
                             L.tp).to(cfg.dtype)  # (B, 1, d)
    positions = torch.full((b, 1), length, device=token.device)
    cos, sin = layers.rope_tables(positions, cfg.head_dim, theta=cfg.rope_theta)
    for i, (layer, w) in enumerate(zip(model.layers, _windows(cfg))):
        x = layer.decode(x, cache["k"][i], cache["v"][i], length, cos, sin, w, grid, seq_axes)
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


# ---------------------------------------------------------------------------
# Partitioning
# ---------------------------------------------------------------------------


def param_specs(cfg: LMConfig, axis_names, *, fsdp: bool = True) -> dict:
    """Megatron TP layout + FSDP, entry for entry the reference's: the
    non-TP matrix dimension also splits over the data axes (ZeRO-3: the
    parameters, gradients and AdamW moments all follow these specs), and
    ``fsdp=False`` gives pure TP. ``layers`` holds one per-layer tree: the
    reference's stacked specs without their leading ``L`` entry (None)."""
    tp = "model" if "model" in axis_names else None
    dp = tuple(a for a in ("pod", "data") if a in axis_names)
    if not dp or not fsdp:
        dp = None
    layer: dict = {
        "ln_attn": (None,),
        "ln_mlp": (None,),
        "wq": (dp, tp),
        "wk": (dp, tp),
        "wv": (dp, tp),
        "wo": (tp, dp),
    }
    if cfg.qkv_bias:
        layer["bq"] = (tp,)
        layer["bk"] = (tp,)
        layer["bv"] = (tp,)
    mlp = {"w_gate": (dp, tp), "w_up": (dp, tp), "w_down": (tp, dp)}
    if cfg.moe:
        layer["moe"] = {
            "router": (None, None),
            "w_gate": (tp, dp, None),  # expert parallel + FSDP on d
            "w_up": (tp, dp, None),
            "w_down": (tp, None, dp),
        }
        if cfg.moe.n_shared:
            layer["shared"] = dict(mlp)
    else:
        layer["mlp"] = mlp
    return {"embed": (tp, dp), "lm_head": (dp, tp), "ln_final": (None,), "layers": layer}


def cache_specs(cfg: LMConfig, axis_names, *, seq_sharded: bool) -> dict:
    """KV-cache layout (L, B, S, Hkv, Dh), the reference's. GQA's few kv
    heads cannot split over a wide model axis, so the cache splits its
    **sequence**: over ``model`` with the batch over the data axes, or
    (``seq_sharded``, batch-1 long context) over every axis."""
    dp = tuple(a for a in ("pod", "data") if a in axis_names)
    tp = "model" if "model" in axis_names else None
    if seq_sharded:
        all_axes = dp + ((tp,) if tp else ())
        kv = (None, None, all_axes if all_axes else None, None, None)
    else:
        kv = (None, dp if dp else None, tp, None, None)
    return {"k": kv, "v": kv, "length": ()}
