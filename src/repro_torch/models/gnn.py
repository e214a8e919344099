"""GatedGCN (Bresson & Laurent 2017; benchmarking-GNNs arXiv:2003.00982).

The port of the JAX package's ``models/gnn.py``. Message passing sums over
an explicit edge list: the reference's ``segment_sum`` is ``index_add``
here (on the card an atomic sum, so its order, and the float32 rounding of
the sums, can change between runs). Each layer is a module under
``torch.utils.checkpoint`` (the reference scans its layers under
``jax.checkpoint(..., nothing_saveable)``); the layers are named
``layers.{i}``, the reference's stacked ``(L, ...)`` leaves
(:mod:`.tree`).

Norm note: as in the reference, batch statistics computed on the fly (no
running statistics), with the population variance (``correction=0``, as
``jnp.var``).

Edge parallelism: under an ambient grid (``launch.mesh.use_grid``) the
graph's edges split over every axis (:func:`shard_edges`) and its nodes
are whole on every rank (the reference pins node states to ``model``; here
every rank holds them all, which costs one node-sized buffer a layer and
keeps the node work collective-free). Each rank scatters its edges'
messages and gates into node buffers, and one sum over every axis gives
``num`` and ``den``. The edges' batch statistics are taken over every
rank's edges (two sums over the grid), the nodes' over the nodes as on one
device; the loss is the same value on every rank. The parameters are whole
on every rank; those the edge work reads (``A``, ``B``, ``C``, ``V``,
``bn_e``, ``w_edge``) have their gradients summed over the grid.

:func:`neighbor_sample` is the 2-hop fanout sampler for the
``minibatch_lg`` shape. Its random draws (:func:`sample_draws`) are apart
from the gather (:func:`neighbor_block`), so a caller can feed the
reference's draws and get its block, bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..launch.mesh import current_grid
from . import sharding, tree


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    n_layers: int = 16
    d_hidden: int = 70
    d_feat: int = 1433
    d_edge: int = 0  # 0 -> constant edge features
    n_classes: int = 7
    readout: str = "node"  # "node" (classification) | "graph" (regression)
    dtype: torch.dtype = torch.float32


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


def _batch_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5, grid=None,
                axes: tuple[str, ...] = ()) -> torch.Tensor:
    """Batch statistics over dimension 0; with ``grid``, over every rank's
    rows along ``axes`` (a sum for the mean, then one for the variance)."""
    if grid is None:
        mu = torch.mean(x, dim=0, keepdim=True)
        var = torch.var(x, dim=0, keepdim=True, correction=0)
    else:
        n = x.shape[0] * sharding.size_of(grid, axes)
        mu = sharding.psum(torch.sum(x, dim=0, keepdim=True), grid, axes) / n
        var = sharding.psum(torch.sum(torch.square(x - mu), dim=0, keepdim=True), grid, axes) / n
    return (x - mu) * torch.rsqrt(var + eps) * scale


def _edge_axes(grid) -> tuple[str, ...]:
    """The axes the edges split over: every axis of the grid (none without one)."""
    return () if grid is None else sharding.physical_axes(sharding.ALL, grid.axis_names)


def _segment_sum(x: torch.Tensor, segments: torch.Tensor, n: int) -> torch.Tensor:
    return x.new_zeros((n, *x.shape[1:])).index_add(0, segments, x)


class GatedGCNLayer(nn.Module):
    """One gated layer: edge terms ``A`` (source), ``B`` (destination),
    ``C`` (edge); node terms ``U`` (self), ``V`` (neighbour)."""

    def __init__(self, cfg: GNNConfig, device):
        super().__init__()
        h = cfg.d_hidden
        for name in ("A", "B", "C", "U", "V"):
            setattr(self, name, _param((h, h), cfg.dtype, device))
        self.bn_h = _param((h,), cfg.dtype, device)
        self.bn_e = _param((h,), cfg.dtype, device)

    def forward(self, h, e, src, dst, edge_mask, grid=None):
        """``grid`` (passed in, so that the checkpointed recompute sees it):
        ``e``, ``src``, ``dst`` and ``edge_mask`` are the rank's edges."""
        axes = _edge_axes(grid)
        he = sharding.copy_to(h, grid, axes)  # node states read by the rank's edges
        w = {n: sharding.materialize(getattr(self, n), grid, axes) for n in ("A", "B", "C", "V", "bn_e")}
        h_src, h_dst = he[src], he[dst]
        e_new = e + F.relu(_batch_norm(h_src @ w["A"] + h_dst @ w["B"] + e @ w["C"], w["bn_e"],
                                       grid=grid, axes=axes))
        eta = torch.sigmoid(e_new)
        if edge_mask is not None:
            eta = eta * edge_mask[:, None]
        msg = eta * (h_src @ w["V"])
        n = h.shape[0]
        num = sharding.reduce_from(_segment_sum(msg, dst, n), grid, axes)
        den = sharding.reduce_from(_segment_sum(eta, dst, n), grid, axes)
        agg = num / (den + 1e-6)
        return h + F.relu(_batch_norm(h @ self.U + agg, self.bn_h)), e_new


class GatedGCN(nn.Module):
    """``w_in`` (F, h), ``w_edge`` (max(d_edge, 1), h), ``w_out`` (h, C)
    and ``layers``. Parameters are allocated, not initialised (:func:`init`
    draws them)."""

    def __init__(self, cfg: GNNConfig, *, device: str | torch.device | None = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        h, dt = cfg.d_hidden, cfg.dtype
        self.w_in = _param((cfg.d_feat, h), dt, device)
        self.w_edge = _param((max(cfg.d_edge, 1), h), dt, device)
        self.w_out = _param((h, cfg.n_classes), dt, device)
        self.layers = nn.ModuleList(GatedGCNLayer(cfg, device) for _ in range(cfg.n_layers))

    def forward(self, graph: Mapping) -> torch.Tensor:
        """graph: node_feat (N, F), edge_index (2, E), optional edge_feat
        (E, Fe), edge_mask (E,), and graph_ids (N,) with n_graphs for
        batched small graphs -> node logits (N, C) or graph outputs (G, C)."""
        cfg = self.cfg
        grid = current_grid()
        n = graph["node_feat"].shape[0]
        src, dst = graph["edge_index"][0], graph["edge_index"][1]
        h = graph["node_feat"].to(cfg.dtype) @ self.w_in
        w_edge = sharding.materialize(self.w_edge, grid, _edge_axes(grid))
        if cfg.d_edge and "edge_feat" in graph:
            e = graph["edge_feat"].to(cfg.dtype) @ w_edge
        else:
            e = h.new_zeros((src.shape[0], cfg.d_hidden)) + w_edge[0]
        edge_mask = graph.get("edge_mask")
        for layer in self.layers:
            if torch.is_grad_enabled():
                h, e = checkpoint(layer, h, e, src, dst, edge_mask, grid, use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                h, e = layer(h, e, src, dst, edge_mask, grid)
        out = h @ self.w_out
        if cfg.readout == "graph":
            gids, g = graph["graph_ids"], int(graph["n_graphs"])
            pooled = _segment_sum(out, gids, g)
            counts = _segment_sum(out.new_ones((n, 1)), gids, g)
            return pooled / torch.clamp(counts, min=1.0)
        return out


def shard_edges(graph: Mapping, grid) -> dict:
    """The rank's share of a graph for edge parallelism: ``edge_index``,
    ``edge_feat`` and ``edge_mask`` split over every axis of ``grid``
    (contiguous blocks of edges, in rank order), the rest as given. The
    edge count must split evenly: pad with masked edges first, as the
    reference pads its inputs."""
    axes = _edge_axes(grid)
    out = dict(graph)
    out["edge_index"] = sharding.shard(graph["edge_index"], (None, axes), grid)
    for k in ("edge_feat", "edge_mask"):
        if k in graph:
            out[k] = sharding.shard(graph[k], (axes,), grid)
    return out


def init(seed: int, cfg: GNNConfig, *, device: str | torch.device | None = None) -> GatedGCN:
    """A :class:`GatedGCN` drawn from ``seed`` by a ``torch.Generator`` on
    ``device`` (None = the CUDA device), at the reference's scales."""
    model = GatedGCN(cfg, device=device)
    dev = next(model.parameters()).device
    tree.draw(model, torch.Generator(device=dev).manual_seed(seed))
    return model


def train_loss(model: GatedGCN, graph: Mapping) -> torch.Tensor:
    """Graph readout: mean squared error against ``graph_targets``. Node
    readout: cross-entropy, over the ``label_mask``ed nodes when given."""
    out = model(graph)
    if model.cfg.readout == "graph":
        return torch.mean((out[:, 0] - graph["graph_targets"]) ** 2)
    logp = F.log_softmax(out.float(), dim=-1)
    nll = -torch.gather(logp, -1, graph["labels"].long()[:, None])[:, 0]
    mask = graph.get("label_mask")
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def params_to_numpy(model: GatedGCN) -> dict:
    """The module's weights as the reference's tree, layers stacked."""
    return tree.to_numpy(model)


def params_from_numpy(t, cfg: GNNConfig, *, device: str | torch.device | None = None) -> GatedGCN:
    return tree.load(GatedGCN(cfg, device=device), t)


# ---------------------------------------------------------------------------
# Neighbour sampler (minibatch_lg shape): 2-hop fanout sampling over CSR.
# ---------------------------------------------------------------------------


def sample_draws(generator: torch.Generator, n_seeds: int, fanouts: Sequence[int], *,
                 device=None) -> list[torch.Tensor]:
    """One (|frontier|, fanout) int32 draw in [0, 2**30) per hop, as the
    reference draws them (``jax.random.randint``, from another stream)."""
    device = resolve_device(device)
    draws, n = [], n_seeds
    for f in fanouts:
        draws.append(torch.randint(0, 1 << 30, (n, f), generator=generator, device=device,
                                   dtype=torch.int32))
        n *= f
    return draws


def neighbor_block(
    indptr: torch.Tensor,  # (N+1,)
    indices: torch.Tensor,  # (E,)
    node_feat: torch.Tensor,  # (N, F)
    labels: torch.Tensor,  # (N,)
    seeds: torch.Tensor,  # (B,)
    draws: Sequence[torch.Tensor],  # per hop (|frontier|, fanout)
) -> dict:
    """The sampled block for given draws: each frontier node takes the
    neighbours at offsets ``draw % degree`` of its CSR row (with
    replacement); a node of degree 0 takes itself. Block node order:
    [seeds, hop-1, hop-2, ...]; edges point sampled neighbour -> parent,
    in block-local int32 ids."""
    dev = seeds.device
    frontier = seeds
    all_nodes, srcs, dsts = [seeds], [], []
    offset, parent_base = seeds.shape[0], 0
    for draw in draws:
        if draw.dim() != 2 or draw.shape[0] != frontier.shape[0]:
            raise ValueError(f"draws of shape {tuple(draw.shape)} do not fit a frontier "
                             f"of {frontier.shape[0]} nodes")
        f = draw.shape[1]
        start = indptr[frontier]
        deg = indptr[frontier + 1] - start
        off = draw % torch.clamp(deg, min=1)[:, None]
        neigh = indices[start[:, None] + off]  # (|F|, f)
        neigh = torch.where(deg[:, None] > 0, neigh, frontier[:, None].to(neigh.dtype))
        n_new = frontier.shape[0] * f
        srcs.append(offset + torch.arange(n_new, dtype=torch.int32, device=dev))
        dsts.append(parent_base + torch.arange(frontier.shape[0], dtype=torch.int32,
                                               device=dev).repeat_interleave(f))
        all_nodes.append(neigh.reshape(-1))
        parent_base = offset
        offset += n_new
        frontier = neigh.reshape(-1)
    block_nodes = torch.cat([t.to(all_nodes[-1].dtype) for t in all_nodes])
    return {
        "node_feat": node_feat[block_nodes],
        "edge_index": torch.stack([torch.cat(srcs), torch.cat(dsts)]),
        "labels": labels[block_nodes],
        "label_mask": (torch.arange(block_nodes.shape[0], device=dev) < seeds.shape[0]).float(),
        "block_nodes": block_nodes,
    }


def neighbor_sample(
    generator: torch.Generator,
    indptr: torch.Tensor,
    indices: torch.Tensor,
    node_feat: torch.Tensor,
    labels: torch.Tensor,
    seeds: torch.Tensor,
    fanouts: Sequence[int],
) -> dict:
    """GraphSAGE-style sampled block with static shapes: the draws from
    ``generator``, then :func:`neighbor_block`."""
    draws = sample_draws(generator, seeds.shape[0], fanouts, device=seeds.device)
    return neighbor_block(indptr, indices, node_feat, labels, seeds, draws)
