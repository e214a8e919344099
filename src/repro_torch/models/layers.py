"""Transformer layers: norms, RoPE, GQA blockwise attention, SwiGLU MLP, MoE.

The port of the JAX package's ``models/layers.py``. The functions take
tensors and mappings of tensors (``{"w_gate": ..., ...}``), so the module
code (:mod:`.transformer`) and the tests call them alike. None of them is a
Pallas kernel in the reference: attention is a blockwise ``jnp`` function
and the MLPs are ``einsum`` products, so they are plain PyTorch here too.

Where the reference asks for ``preferred_element_type=float32`` on a
product of bfloat16 operands, the port upcasts the operands and multiplies
in float32: a product of two bfloat16 values is exact in float32, so this
is the reference's arithmetic up to the order of the sum.
"""
from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

from ..core.utils import stable_topk
from . import sharding

Params = Mapping[str, torch.Tensor]

_NEG = -1e30


# ---------------------------------------------------------------------------
# Norms / positional
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(dt) * scale.to(dt)


def layer_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps)).to(dt) * scale.to(dt) + bias.to(dt)


def cast_floats(tree, dtype: torch.dtype, *, exempt: tuple[str, ...] = ("router",)):
    """Floating leaves of a (nested) mapping of tensors cast to the compute
    dtype; the names in ``exempt`` stay as they are (router logits are
    precision-sensitive, so the router stays float32)."""
    if isinstance(tree, Mapping):
        return {k: v if k in exempt else cast_floats(v, dtype, exempt=exempt)
                for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def rope_tables(positions: torch.Tensor, d: int, *, theta: float = 10000.0):
    """RoPE's (cos, sin), each (B, S, 1, d/2) float32, for positions (B, S):
    one computation serves every layer's q and k."""
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=positions.device) / half)
    angles = positions[..., None].float() * freqs  # (B, S, half)
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, *, theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding. x: (B, S, H, D), positions: (B, S)."""
    return apply_rope(x, *rope_tables(positions, x.shape[-1], theta=theta))


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def flash_attention(
    q: torch.Tensor,  # (B, S, Hq, D)
    k: torch.Tensor,  # (B, S, Hkv, D)
    v: torch.Tensor,  # (B, S, Hkv, D)
    *,
    causal: bool = True,
    window: int | None = None,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
) -> torch.Tensor:
    """Blockwise softmax attention with GQA and a streaming (online) softmax.

    ``window=w`` restricts each query to keys with ``qpos - w < kpos <=
    qpos`` (llama4-scout's local layers). At most one (q_chunk, kv_chunk)
    score tile per (batch, head) is live. Masked scores are ``-1e30``, not
    ``-inf``, and the normaliser is floored at ``1e-30``, as in the
    reference, so a fully masked row gives zeros.

    A tile whose every pair the causal mask or the window masks is
    skipped: it would add ``exp(-1e30 - m) = 0`` to each sum and multiply
    the running state by ``exp(0) = 1``, so the result is the same bit for
    bit (a row's state before its first unmasked key is wiped by the
    ``exp(-1e30 - m) = 0`` correction that key brings, as when every tile
    runs).
    """
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    q_chunk = min(q_chunk, s)
    kv_chunk = min(kv_chunk, s)
    if s % q_chunk or s % kv_chunk:
        raise ValueError(f"sequence {s} is not a multiple of the chunks {q_chunk}, {kv_chunk}")
    scale = 1.0 / (d**0.5)
    qr = q.reshape(b, s // q_chunk, q_chunk, hkv, g, d)
    kr = k.reshape(b, s // kv_chunk, kv_chunk, hkv, d)
    vr = v.reshape(b, s // kv_chunk, kv_chunk, hkv, d)
    ar = torch.arange(max(q_chunk, kv_chunk), device=q.device)
    outs = []
    for qi in range(s // q_chunk):
        q_tile = qr[:, qi].float()  # (B, qc, Hkv, G, D)
        q_pos = qi * q_chunk + ar[:q_chunk]
        q_lo, q_hi = qi * q_chunk, (qi + 1) * q_chunk - 1
        first = True
        for ki in range(s // kv_chunk):
            k_lo, k_hi = ki * kv_chunk, (ki + 1) * kv_chunk - 1
            if (causal and k_lo > q_hi) or (window is not None and q_lo - k_hi >= window):
                continue  # every pair masked (docstring)
            v_tile = vr[:, ki]
            k_pos = ki * kv_chunk + ar[:kv_chunk]
            s_ = torch.einsum("bqhgd,bkhd->bhgqk", q_tile, kr[:, ki].float()) * scale
            mask = None
            if causal:
                mask = q_pos[:, None] >= k_pos[None, :]
            if window is not None:
                near = q_pos[:, None] - k_pos[None, :] < window
                mask = near if mask is None else mask & near
            if mask is not None:
                s_ = torch.where(mask, s_, _NEG)
            if first:
                # The running state starts at (m, l, acc) = (-1e30, 0, 0), so
                # the first tile's correction multiplies zeros: skipped.
                m = torch.clamp(torch.amax(s_, dim=-1), min=_NEG)
                p = torch.exp(s_ - m[..., None])
                l, acc = torch.sum(p, dim=-1), _weighted_values(p, v_tile)
                first = False
                continue
            m_new = torch.maximum(m, torch.amax(s_, dim=-1))
            p = torch.exp(s_ - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            acc = acc * corr[..., None] + _weighted_values(p, v_tile)
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]  # (B, Hkv, G, qc, D)
        outs.append(out.permute(0, 3, 1, 2, 4))  # (B, qc, Hkv, G, D)
    return torch.cat(outs, dim=1).reshape(b, s, hq, d).to(q.dtype)


def _weighted_values(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p (B, Hkv, G, qc, kc) against v (B, kc, Hkv, D): p rounded to v's
    type, the product summed in float32."""
    return torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), v.float())


def decode_attention(
    q: torch.Tensor,  # (B, 1, Hq, D)
    cache_k: torch.Tensor,  # (B, S, Hkv, D)
    cache_v: torch.Tensor,  # (B, S, Hkv, D)
    *,
    length: torch.Tensor | int,  # valid cache length (scalar or (B,))
    window: int | None = None,
) -> torch.Tensor:
    """Single-token attention against a KV cache: positions ``< length``
    (and ``>= length - window``) are attended to. Scores and the weighted
    sum run in float32 over the cache (the reference's
    ``preferred_element_type=float32``), the weights rounded to the cache's
    type first; masked scores are ``-1e30``."""
    b, s, hkv, d = cache_k.shape
    hq = q.shape[2]
    g = hq // hkv
    scale = 1.0 / (d**0.5)
    qr = q.reshape(b, hkv, g, d)
    s_ = torch.einsum("bhgd,bkhd->bhgk", qr.float(), cache_k.float()) * scale
    pos = torch.arange(s, device=q.device)
    length = torch.as_tensor(length, device=q.device)
    if length.ndim == 0:
        length = length.expand(b)
    valid = pos[None, :] < length[:, None]  # (B, S)
    if window is not None:
        valid &= pos[None, :] >= (length[:, None] - window)
    s_ = torch.where(valid[:, None, None, :], s_, _NEG)
    m = torch.amax(s_, dim=-1, keepdim=True)
    p = torch.exp(s_ - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    w = (p / torch.clamp(l, min=1e-30)).to(cache_v.dtype).float()
    out = torch.einsum("bhgk,bkhd->bhgd", w, cache_v.float())
    return out.reshape(b, 1, hq, d).to(q.dtype)


def decode_attention_split(
    q: torch.Tensor,  # (B, 1, Hq, D), every head
    cache_k: torch.Tensor,  # (B, S_loc, Hkv, D): the rank's positions
    cache_v: torch.Tensor,
    *,
    length: int,
    window: int | None,
    offset: int,
    grid,
    axes: tuple[str, ...],
) -> torch.Tensor:
    """:func:`decode_attention` over a cache whose positions are split over
    ``axes`` (split-KV, flash-decoding style): the rank holds positions
    ``offset .. offset + S_loc - 1``; it takes the partial maximum, sum of
    exponentials and weighted values over them, and the partials are
    combined over ``axes`` (a maximum, then two sums). The weights multiply
    the values unrounded and the sum is divided once at the end (the
    single-device version rounds each weight to the cache's type first:
    the same in float32 up to the order of the sums)."""
    b, s, hkv, d = cache_k.shape
    hq = q.shape[2]
    g = hq // hkv
    scale = 1.0 / (d**0.5)
    qr = q.reshape(b, hkv, g, d)
    s_ = torch.einsum("bhgd,bkhd->bhgk", qr.float(), cache_k.float()) * scale
    pos = offset + torch.arange(s, device=q.device)
    valid = pos < length
    if window is not None:
        valid &= pos >= length - window
    s_ = torch.where(valid[None, None, None, :], s_, _NEG)
    m = torch.amax(s_, dim=-1)  # (B, Hkv, G)
    m_all = sharding.all_max(m, grid, axes)
    p = torch.where(valid[None, None, None, :], torch.exp(s_ - m_all[..., None]), 0.0)
    l = sharding.all_reduce_nograd(p.sum(dim=-1), grid, axes)
    acc = sharding.all_reduce_nograd(torch.einsum("bhgk,bkhd->bhgd", p, cache_v.float()), grid, axes)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, 1, hq, d).to(q.dtype)


# ---------------------------------------------------------------------------
# MLP / MoE
# ---------------------------------------------------------------------------


def _promoted(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Both operands in JAX's promotion of their types (bfloat16 with
    float32 multiplies in float32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.einsum(eq, *_promoted(a, b))


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = _promoted(a, b)
    return a @ b


def swiglu_mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    gate = _mm(x, p["w_gate"])
    up = _mm(x, p["w_up"])
    return _mm(F.silu(gate) * up, p["w_down"])


def moe_mlp(
    p: Params,
    x: torch.Tensor,  # (B, S, d)
    *,
    top_k: int,
    capacity_factor: float = 1.25,
    grid=None,
    tp: tuple[str, ...] = (),
    dp: tuple[str, ...] = (),
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort-based token-choice MoE with per-batch-row dispatch -> (output,
    aux load-balance loss).

    Each batch row sorts its (token, choice) pairs by expert (a stable
    sort) into per-expert capacity slots; pairs past an expert's capacity
    go to a spill row that is dropped. Ties in the router go to the lower
    expert id (``jax.lax.top_k``'s order, :func:`~repro_torch.core.utils.
    stable_topk`). Each token's pairs are combined in one fixed order, the
    order of their slots in the sorted pairs, which is the order JAX's
    ``segment_sum`` adds them in.

    Expert parallelism (``grid`` given): ``p``'s expert weights are the
    rank's ``E / |tp|`` experts (the router whole), and ``x`` is whole on
    every ``tp`` rank. Every rank routes every row; it fills and runs only
    its experts' slots, and returns its share of the combine, which the
    caller sums over ``tp``. The aux loss's batch means are taken over the
    rows of every ``dp`` rank.
    """
    b, s, d = x.shape
    e = p["router"].shape[1]
    e_loc = p["w_gate"].shape[0]
    e_lo = sharding.my_index(grid, tp) * e_loc
    cap = int(max(top_k, round(s * top_k / e * capacity_factor)))
    cap = min(cap, s * top_k)

    logits = _mm(x, p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, experts = stable_topk(probs, top_k)  # (B, S, K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(dim=-1, keepdim=True), min=1e-9)

    # Aux loss (Switch-style): mean fraction routed vs mean router prob.
    if grid is None:
        density = torch.mean(F.one_hot(experts[..., 0], e).float(), dim=(0, 1))
        density_prob = torch.mean(probs, dim=(0, 1))
    else:
        rows = b * s * sharding.size_of(grid, dp)
        routed = F.one_hot(experts[..., 0], e).float().sum(dim=(0, 1))
        density = sharding.all_reduce_nograd(routed, grid, dp) / rows
        density_prob = sharding.reduce_from(probs.sum(dim=(0, 1)), grid, dp) / rows
        # Each tp rank combines its experts' pairs from the rows and gates
        # that every tp rank holds alike: their gradients are partial.
        x = sharding.copy_to(x, grid, tp)
        gate_vals = sharding.copy_to(gate_vals, grid, tp)
    aux = torch.sum(density * density_prob) * e

    # Dispatch, one batch row per leading index.
    n = s * top_k
    flat_e = experts.reshape(b, n)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    counts = F.one_hot(flat_e, e).sum(dim=1)  # (B, E)
    starts = torch.cumsum(counts, dim=-1) - counts
    pos = torch.arange(n, device=x.device) - torch.gather(starts, 1, sorted_e)
    # The slot of each sorted pair among this rank's experts' slots, or the
    # spill row (dropped past capacity, or another rank's expert).
    mine = (pos < cap) & (sorted_e >= e_lo) & (sorted_e < e_lo + e_loc)
    slot = torch.where(mine, (sorted_e - e_lo) * cap + pos, e_loc * cap)  # (B, n)
    tok = torch.div(order, top_k, rounding_mode="floor")
    rows = torch.arange(b, device=x.device)[:, None]
    buf = x.new_zeros((b, e_loc * cap + 1, d))
    buf[rows, slot] = x[rows, tok]
    expert_in = buf[:, :-1].reshape(b, e_loc, cap, d)

    h = _einsum("becd,edf->becf", expert_in, p["w_gate"])
    u = _einsum("becd,edf->becf", expert_in, p["w_up"])
    expert_out = _einsum("becf,efd->becd", F.silu(h) * u, p["w_down"])  # (B, E, C, d)

    # Combine: the gated output of each sorted pair (zero where dropped),
    # then each token's top_k pairs summed in the order of their slots.
    flat = expert_out.reshape(b, e_loc * cap, d)
    safe = torch.clamp(slot, max=e_loc * cap - 1)
    y = torch.where((slot < e_loc * cap)[..., None], flat[rows, safe], 0.0)
    gsel = torch.gather(gate_vals.reshape(b, n), 1, order)
    y = y * gsel[..., None]
    where = torch.sort(torch.argsort(order, dim=-1).reshape(b, s, top_k), dim=-1).values
    out = torch.zeros((b, s, d), dtype=y.dtype, device=x.device)
    for j in range(top_k):
        out = out + y[rows, where[..., j]]
    return out.to(x.dtype), aux
