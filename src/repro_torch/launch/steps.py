"""Step construction: (arch x shape x grid) -> one rank's step and its
arguments, for the dry run (``launch/dryrun.py``).

The port of the JAX package's ``launch/steps.py``. :func:`make_bundle`
returns a :class:`StepBundle`: the step function, the rank's own shards of
its arguments, the analytic model FLOPs of the whole step (the reference's
formulas, not :mod:`.flops`' where they differ), the loop factor and, for
the retrieval cells, the index bytes by storage tier.

JAX lowers a jitted step over abstract global arrays with shardings; here
a rank runs eagerly on its own blocks. So ``args`` are built directly at
the shape of the rank's block (``sharding.empty_blocks``, :func:`_block`),
as uninitialised tensors on ``device``: called under a ``FakeTensorMode``
they are ``FakeTensor`` s, which hold no memory, and no global tensor is
ever made. ``fn(*args)`` runs one step under the ambient grid
(``mesh.use_grid``): the collectives it calls go through the grid, and the
kernels' wrappers take their shape-only branch (``kernels/ops.py``).

Where the reference's step scans micro-batches (the LM train step,
``grad_accum = b // dp`` by default), ``fn`` runs three of them
(``accum_run``; all of them where there are fewer) and calls every hook in
``micro_hooks`` as each begins, so the dry run can read its counters per
micro-batch and scale the repeated one to ``accum`` micro-batches. The
first micro-batch is not the repeated one: its backward makes the
gradients that the others' add to.

Where a rank's arguments differ from the reference's per-device shards
(each pinned exactly in ``tests/test_torch_dryrun.py``):

- GNN full-batch cells (``full_graph_sm``, ``ogb_products``): the node
  arrays are whole on every rank, where the reference splits them over
  ``model`` (``models/gnn.py``: the port's nodes are whole).
- Retrieval: the hash keys (the bank's and the centroid retriever's
  ``sorted_keys``, ``key_min``, ``key_max``) are int64, the reference's
  uint32 (``core/lsh.py``: the pad sentinel ``0xFFFFFFFF`` must sort after
  every key).
- LM decode: the cache's ``length`` is a host int, the reference's a
  4-byte device scalar.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from ..configs.base import ArchSpec, ShapeSpec
from ..core import bank as bank_lib
from ..core import distributed as dist_lib
from ..core import lsh as lsh_lib
from ..core import rescale as rescale_lib
from ..core import rmi as rmi_lib
from ..core.core_model import CoreModelParams
from ..core.lider import LiderParams
from ..core.types import map_tensors
from ..core.utils import stable_topk
from ..kernels import quant as quant_lib
from ..models import gnn as gnn_lib
from ..models import recsys as recsys_lib
from ..models import sharding
from ..models import transformer as tfm
from ..training import optimizer as opt_lib
from ..training.train_loop import make_train_step
from . import flops as flops_lib
from .mesh import Grid, data_axes


@dataclasses.dataclass
class StepBundle:
    name: str
    fn: Callable
    args: tuple
    model_flops: float
    donate_argnums: tuple = ()
    # The reference's dominant static trip count (layers x micro-batches),
    # kept for the records to compare; the dry run runs every layer.
    loop_factor: float = 1.0
    # Retrieval cells: index bytes by storage tier per storage config.
    tier_memory: dict | None = None
    # Micro-batches of the whole step, and how many ``fn`` runs (module
    # docstring); ``fn`` calls each of ``micro_hooks`` as one begins.
    accum: int = 1
    accum_run: int = 1
    micro_hooks: list = dataclasses.field(default_factory=list)


def arg_tensors(args) -> list[torch.Tensor]:
    """Every tensor of a bundle's arguments: the parameters of a module,
    the leaves of dicts, lists, dataclasses and named tuples."""
    out: list[torch.Tensor] = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, torch.nn.Module):
            out.extend(x.parameters())
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
            for v in x:
                walk(v)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
        elif isinstance(x, tuple):  # a named tuple
            for v in x:
                walk(v)

    walk(args)
    return out


def nbytes(tensors) -> int:
    return int(sum(t.numel() * t.element_size() for t in tensors))


def _block(shape, dtype, spec, grid: Grid, device, *, zero: bool = False) -> torch.Tensor:
    """An uninitialised (or zero) tensor of the rank's block of ``shape``
    under the logical or physical ``spec``."""
    bs = sharding.block_shape(shape, sharding.resolve_spec(spec, grid.axis_names), grid)
    return (torch.zeros if zero else torch.empty)(bs, dtype=dtype, device=device)


def _dense_flops(shapes, batch: int, *, factor: float = 2.0) -> float:
    """2 B sum(product weight sizes): leaves of two or more dimensions
    whose leading dimension is below 100,000 (the embedding tables are
    lookups); factor 6 to train."""
    total = 0
    for shape in shapes:
        if len(shape) >= 2 and shape[0] < 100_000:
            total += math.prod(shape[-2:]) * math.prod(shape[:-2])
    return factor * batch * total


def _name(arch: ArchSpec, shape: ShapeSpec) -> str:
    return f"{arch.arch_id}:{shape.name}"


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------


def _lm_flops(cfg: tfm.LMConfig, tokens: int, *, train: bool) -> float:
    return (6.0 if train else 2.0) * cfg.flops_params() * tokens


def _train_fn(loss_fn, accum: int, accum_run: int, hooks: list):
    """The train step over the first ``accum_run`` of the rank's
    ``accum`` micro-batches: ``make_train_step``'s accumulation (with
    ``grad_accum=accum_run``), calling ``hooks`` as each micro-batch
    begins."""
    def counted(model, micro):
        for h in hooks:
            h()
        return loss_fn(model, micro)

    step = make_train_step(counted, opt_lib.OptimizerConfig(), grad_accum=accum_run)

    def fn(model, opt_state, batch):
        rows = next(iter(batch.values())).shape[0]
        if rows % accum:
            raise ValueError(f"{rows} rows do not split into {accum} micro-batches")
        run = rows // accum * accum_run
        return step(model, opt_state, {k: v[:run] for k, v in batch.items()})

    return fn


def make_lm_bundle(arch: ArchSpec, shape: ShapeSpec, grid: Grid, *, device,
                   grad_accum: int | None = None, cfg: tfm.LMConfig | None = None,
                   **_) -> StepBundle:
    """``grad_accum`` (default: the reference's ``b // dp``) and ``cfg``
    (default: the arch's) rebuild a cell as a run configured it."""
    cfg = cfg or arch.config
    dp = data_axes(grid)
    dp_size = grid.axis_size(dp)
    b, s = shape.dims["global_batch"], shape.dims["seq_len"]
    model = sharding.empty_blocks(tfm.Transformer(cfg, device="meta"),
                                  tfm.param_specs(cfg, grid.axis_names), grid,
                                  device=device)
    name = _name(arch, shape)

    if shape.kind == "train":
        opt_state = opt_lib.init_state(dict(model.named_parameters()))
        accum = grad_accum or max(1, b // max(dp_size, 1))
        run = min(accum, 3)
        hooks: list = []
        batch = {k: _block((b, s), torch.int32, (dp, None), grid, device, zero=True)
                 for k in ("tokens", "targets")}
        return StepBundle(name, _train_fn(tfm.train_loss, accum, run, hooks),
                          (model, opt_state, batch), _lm_flops(cfg, b * s, train=True),
                          donate_argnums=(0, 1), loop_factor=float(cfg.n_layers * accum),
                          accum=accum, accum_run=run, micro_hooks=hooks)

    if shape.kind == "prefill":
        tokens = _block((b, s), torch.int32, (dp, None), grid, device, zero=True)
        return StepBundle(name, lambda m, t: tfm.prefill(m, t), (model, tokens),
                          _lm_flops(cfg, b * s, train=False), loop_factor=float(cfg.n_layers))

    # Decode: one token against a cache of seq_len positions. Batch-1 long
    # context splits the cache's sequence over every axis; batched decode
    # splits the batch over the data axes.
    seq_sharded = b < dp_size
    with_grid = sharding.resolve_spec(
        tfm.cache_specs(cfg, grid.axis_names, seq_sharded=seq_sharded)["k"], grid.axis_names)
    full = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.head_dim)
    kv_shape = sharding.block_shape(full, with_grid, grid)
    cache = {"k": torch.zeros(kv_shape, dtype=cfg.dtype, device=device),
             "v": torch.zeros(kv_shape, dtype=cfg.dtype, device=device),
             "length": s - 1, "seq_sharded": seq_sharded}
    token = _block((b, 1), torch.int32, (None if seq_sharded else dp, None), grid, device,
                   zero=True)
    attn = 4.0 * cfg.n_layers * b * cfg.n_heads * s * cfg.head_dim  # QK^T and PV on the cache
    return StepBundle(name, lambda m, c, t: tfm.decode_step(m, c, t), (model, cache, token),
                      _lm_flops(cfg, b, train=False) + attn, donate_argnums=(1,),
                      loop_factor=float(cfg.n_layers))


# ---------------------------------------------------------------------------
# GNN family
# ---------------------------------------------------------------------------


def _gnn_cfg_for_shape(base: gnn_lib.GNNConfig, shape: ShapeSpec) -> gnn_lib.GNNConfig:
    d = shape.dims
    return dataclasses.replace(
        base,
        d_feat=d["d_feat"],
        d_edge=d.get("d_edge", 0),
        n_classes=1 if d.get("regression") else d.get("n_classes", base.n_classes),
        readout="graph" if d.get("regression") else "node",
    )


def _edges_over_model(graph: dict, grid: Grid, keys) -> dict:
    """Edges split over the data axes -> the rank's share of them over every
    axis (the port's edge parallelism, ``gnn.shard_edges``): the block of
    its model index within its data block, a slice with no collective."""
    tp = sharding.physical_axes(sharding.TP, grid.axis_names)
    n, i = grid.axis_size(tp), grid.flat_index(tp)
    out = dict(graph)
    for k in keys:
        dim = 1 if k == "edge_index" else 0
        size = graph[k].shape[dim] // n
        out[k] = graph[k].narrow(dim, i * size, size)
    return out


def make_gnn_bundle(arch: ArchSpec, shape: ShapeSpec, grid: Grid, *, device, **_) -> StepBundle:
    """The reference's three layouts: ``minibatch_lg`` (a sampled block,
    nodes whole, edges over the data axes), ``molecule`` (nodes and edges
    over the data axes) and full batch (nodes and edges padded to 1,024;
    edges over every axis, nodes over ``model`` in the reference and whole
    here). Where the reference's edges split over the data axes only, the
    step takes the rank's share over ``model`` too; ``molecule``'s nodes
    are all-gathered whole, as the port's GNN holds them."""
    cfg = _gnn_cfg_for_shape(arch.config, shape)
    dp = data_axes(grid)
    every = sharding.physical_axes(sharding.ALL, grid.axis_names)
    d = shape.dims
    f32, i32 = torch.float32, torch.int32
    arr = lambda shp, dt, spec: _block(shp, dt, spec, grid, device, zero=True)  # noqa: E731
    prepare = lambda g: g  # noqa: E731
    if shape.name == "minibatch_lg":
        bn = d["batch_nodes"]
        f1, f2 = d["fanout"]
        n, e = bn + bn * f1 + bn * f1 * f2, bn * f1 + bn * f1 * f2
        graph = {"node_feat": arr((n, cfg.d_feat), f32, (None, None)),
                 "edge_index": arr((2, e), i32, (None, dp)),
                 "labels": arr((n,), i32, (None,)), "label_mask": arr((n,), f32, (None,))}
        prepare = lambda g: _edges_over_model(g, grid, ("edge_index",))  # noqa: E731
    elif shape.name == "molecule":
        g_count = d["batch"]
        n, e = g_count * d["n_nodes"], g_count * d["n_edges"]
        graph = {"node_feat": arr((n, cfg.d_feat), f32, (dp, None)),
                 "edge_index": arr((2, e), i32, (None, dp)),
                 "edge_feat": arr((e, cfg.d_edge), f32, (dp, None)),
                 "graph_ids": arr((n,), i32, (dp,)),
                 "graph_targets": arr((g_count,), f32, (None,))}

        def prepare(g):
            whole = {k: sharding.gather(g[k], grid, dp, 0) for k in ("node_feat", "graph_ids")}
            return {**_edges_over_model(g, grid, ("edge_index", "edge_feat")), **whole,
                    "n_graphs": g_count}
    else:  # full batch: full_graph_sm, ogb_products
        n = math.ceil(d["n_nodes"] / 1024) * 1024
        e = math.ceil(d["n_edges"] / 1024) * 1024
        graph = {"node_feat": arr((n, cfg.d_feat), f32, (None, None)),
                 "edge_index": arr((2, e), i32, (None, every)),
                 "edge_mask": arr((e,), f32, (every,)),
                 "labels": arr((n,), i32, (None,)), "label_mask": arr((n,), f32, (None,))}

    model = sharding.empty_blocks(gnn_lib.GatedGCN(cfg, device="meta"), None, grid, device=device)
    opt_state = opt_lib.init_state(dict(model.named_parameters()))
    step = make_train_step(gnn_lib.train_loss, opt_lib.OptimizerConfig())
    return StepBundle(
        _name(arch, shape), lambda m, o, g: step(m, o, prepare(g)), (model, opt_state, graph),
        flops_lib.gnn_flops(cfg, n, e, train=True), donate_argnums=(0, 1),
        loop_factor=float(cfg.n_layers))


# ---------------------------------------------------------------------------
# RecSys family
# ---------------------------------------------------------------------------


def _recsys_batch(cfg: recsys_lib.RecsysConfig, batch: int, grid: Grid, device, *,
                  labels: bool = True) -> dict:
    """The rank's rows of a batch of ``cfg.kind``: int32 ids (float32
    labels), rows over the data axes."""
    dp = data_axes(grid)
    ids = lambda *shp: _block((batch, *shp), torch.int32, (dp,) + (None,) * len(shp), grid,  # noqa: E731
                              device, zero=True)
    k = cfg.kind
    if k == "sasrec":
        out = {"seq": ids(cfg.seq_len)}
        if labels:
            out.update(pos=ids(cfg.seq_len), neg=ids(cfg.seq_len))
    elif k == "two_tower":
        out = {"user_fields": ids(cfg.n_user_fields), "item_fields": ids(cfg.n_item_fields)}
    elif k == "din":
        out = {"history": ids(cfg.seq_len), "target": ids()}
    else:
        out = {"fields": ids(cfg.n_sparse)}
    if labels and k in ("din", "xdeepfm"):
        out["label"] = _block((batch,), torch.float32, (dp,), grid, device, zero=True)
    return out


def _recsys_forward(cfg: recsys_lib.RecsysConfig):
    k = cfg.kind
    if k == "sasrec":
        return lambda m, b: recsys_lib.sasrec_forward(m, b["seq"])[:, -1]
    if k == "two_tower":
        return lambda m, b: recsys_lib.user_embed(m, b["user_fields"])
    if k == "din":
        return lambda m, b: recsys_lib.din_forward(m, b)
    return lambda m, b: recsys_lib.xdeepfm_forward(m, b)


def _global_topk(scores: torch.Tensor, first: int, grid: Grid, axes, k: int):
    """(n,) scores of the rank's candidates ``first .. first + n - 1`` ->
    the top ``k`` (scores, ids) of every rank's along ``axes``, ties to the
    smaller id (``jax.lax.top_k`` over the whole array): the rank's top k,
    all-gathered in rank order, then the top k of those."""
    sc, idx = stable_topk(scores.float(), min(k, scores.shape[0]))
    packed = torch.stack([sc, (idx + first).float()])  # ids below 2**24: exact
    allp = sharding.gather(packed, grid, axes, 1)
    top, where = stable_topk(allp[0], k)
    return top, allp[1][where].to(torch.int64)


def make_recsys_bundle(arch: ArchSpec, shape: ShapeSpec, grid: Grid, *, device,
                       **_) -> StepBundle:
    cfg: recsys_lib.RecsysConfig = arch.config
    dp = data_axes(grid)
    meta = recsys_lib.MODELS[cfg.kind](cfg, torch.device("meta"))
    shapes = [tuple(p.shape) for p in meta.parameters()]
    model = sharding.empty_blocks(meta, recsys_lib.param_specs(meta), grid, device=device)
    name = _name(arch, shape)

    if shape.kind == "train":
        b = shape.dims["batch"]
        opt_state = opt_lib.init_state(dict(model.named_parameters()))
        step = make_train_step(recsys_lib.LOSS[cfg.kind], opt_lib.OptimizerConfig())
        return StepBundle(name, step, (model, opt_state, _recsys_batch(cfg, b, grid, device)),
                          _dense_flops(shapes, b, factor=6.0), donate_argnums=(0, 1))

    if shape.kind == "serve":
        b = shape.dims["batch"]
        fwd = torch.no_grad()(_recsys_forward(cfg))
        return StepBundle(name, fwd, (model, _recsys_batch(cfg, b, grid, device, labels=False)),
                          _dense_flops(shapes, b, factor=2.0))

    # retrieval_cand: one query context scored against n_candidates items,
    # the candidates over the data axes; the top 100 over all of them.
    c, k_top = shape.dims["n_candidates"], 100
    c_loc = c // grid.axis_size(dp)
    first = grid.flat_index(dp) * c_loc
    whole = lambda *shp: _block(shp, torch.int32, (None,) * len(shp), grid, device, zero=True)  # noqa: E731
    cands = lambda: _block((c,), torch.int32, (dp,), grid, device, zero=True)  # noqa: E731
    named = dict(meta.named_parameters())
    if cfg.kind == "two_tower":
        dout = cfg.tower_dims[-1]

        @torch.no_grad()
        def step(m, user_fields, cand_embs):
            u = recsys_lib.user_embed(m, user_fields)
            return _global_topk((cand_embs @ u[0]).float(), first, grid, dp, k_top)

        args = (model, whole(1, cfg.n_user_fields),
                _block((c, dout), torch.float32, (dp, None), grid, device, zero=True))
        tower = [tuple(p.shape) for n, p in named.items() if n.startswith("user_tower")]
        flops = 2.0 * c * dout + _dense_flops(tower, 1, factor=2.0)
    elif cfg.kind == "sasrec":

        @torch.no_grad()
        def step(m, seq, cand_ids):
            h = recsys_lib.sasrec_forward(m, seq)[:, -1]  # (1, d)
            emb = recsys_lib.embedding_lookup(m.item_emb, cand_ids)
            return _global_topk((emb @ h[0]).float(), first, grid, dp, k_top)

        args = (model, whole(1, cfg.seq_len), cands())
        flops = 2.0 * c * cfg.embed_dim
    elif cfg.kind == "din":

        @torch.no_grad()
        def step(m, history, cand_ids):
            hist = history.expand(cand_ids.shape[0], cfg.seq_len)
            logits = recsys_lib.din_forward(m, {"history": hist, "target": cand_ids})
            return _global_topk(logits, first, grid, dp, k_top)

        args = (model, whole(1, cfg.seq_len), cands())
        mlp = [tuple(p.shape) for n, p in named.items() if n.startswith("mlp")]
        flops = 2.0 * c * cfg.seq_len * (
            4 * cfg.embed_dim * cfg.attn_dims[0] + cfg.attn_dims[0] * cfg.attn_dims[1]
        ) + _dense_flops(mlp, c, factor=2.0)
    else:  # xdeepfm: the forward splits its rows over model too (padded to split)
        tp = sharding.physical_axes(sharding.TP, grid.axis_names)
        n_tp = grid.axis_size(tp)
        pad = -c_loc % n_tp

        @torch.no_grad()
        def step(m, fields):
            padded = torch.nn.functional.pad(fields, (0, 0, 0, pad))
            logits = recsys_lib.xdeepfm_forward(m, {"fields": padded})
            rows = logits.shape[0]  # the rank's share over model of its data block's rows
            lo = grid.flat_index(tp) * rows
            mine = lo + torch.arange(rows, device=logits.device)
            logits = torch.where(mine < c_loc, logits, float("-inf"))
            sc, ids = _global_topk(logits, lo, grid, tp, k_top)
            both = sharding.gather(torch.stack([sc, (ids + first).float()]), grid, dp, 1)
            top, where = stable_topk(both[0], k_top)
            return top, both[1][where].to(torch.int64)

        args = (model, _block((c, cfg.n_sparse), torch.int32, (dp, None), grid, device, zero=True))
        m_, dd = cfg.n_sparse, cfg.embed_dim
        cin = sum(2 * h_prev * m_ * dd * h
                  for h_prev, h in zip((m_,) + cfg.cin_dims[:-1], cfg.cin_dims))
        flops = c * (cin + 2 * m_ * dd * cfg.dnn_dims[0])
    return StepBundle(name, step, args, float(flops))


# ---------------------------------------------------------------------------
# Retrieval family (the paper's own arch)
# ---------------------------------------------------------------------------


def lider_param_structs(rcfg, *, storage_dtype: str | None = None,
                        rescore_tier: str | None = None, device="meta") -> LiderParams:
    """Uninitialised ``LiderParams`` of the whole index at ``rcfg``'s shape
    (on the ``meta`` device by default: no memory), in the port's dtypes.

    ``storage_dtype`` (default: the config's) shapes the bank's storage:
    "int8" / "int4" add the ``emb_scales``, ``sketches`` and, on the device
    tier, ``rescore_embs`` leaves (int4 codes packed two a byte, ``(c, Lp,
    d // 2)``). ``rescore_tier="host"`` (quantized only) attaches an
    abstract host-tier ``EmbStore`` of the rescore table's shape instead of
    the ``rescore_embs`` leaf."""
    cfg = rcfg.lider
    storage_dtype = storage_dtype or cfg.storage_dtype
    rescore_tier = rescore_tier or cfg.rescore_tier
    quantized = storage_dtype in ("int8", "int4")
    if rescore_tier == "host" and not quantized:
        raise ValueError("rescore_tier='host' requires storage_dtype='int8' or 'int4'")
    c, d, lp = cfg.n_clusters, rcfg.dim, rcfg.capacity
    if storage_dtype == "int4" and d % 2:
        raise ValueError(f"int4 packing requires even dim, got d={d}")
    h, hc = cfg.n_arrays, cfg.n_arrays_centroid
    m, mc = cfg.key_len, cfg.key_len_centroid
    w, wc = cfg.n_leaves, cfg.n_leaves_centroid
    t = lambda shp, dt: torch.empty(shp, dtype=dt, device=device)  # noqa: E731
    f32, i32, i64 = torch.float32, torch.int32, torch.int64

    def rmi_s(lead, nl):
        return rmi_lib.RMIParams(root_w=t(lead, f32), root_b=t(lead, f32),
                                 leaf_w=t(lead + (nl,), f32), leaf_b=t(lead + (nl,), f32),
                                 length=t(lead, f32), max_err=t(lead + (nl,), f32), n_leaves=nl)

    def resc_s(lead):
        return rescale_lib.RescaleParams(key_min=t(lead, i64), key_max=t(lead, i64),
                                         length=t(lead, f32))

    centroid_cm = CoreModelParams(
        lsh=lsh_lib.LSHParams(projections=t((d, hc * mc), f32), n_arrays=hc, key_len=mc),
        rescale=resc_s((hc,)), rmi=rmi_s((hc,), wc),
        sorted_keys=t((hc, c), i64), sorted_ids=t((hc, c), i32),
    )
    storage = torch.int8 if quantized else {"float32": f32, "bfloat16": torch.bfloat16}[storage_dtype]
    bank = bank_lib.ClusterBank(
        lsh=lsh_lib.LSHParams(projections=t((d, h * m), f32), n_arrays=h, key_len=m),
        rescale=resc_s((c, h)), rmi=rmi_s((c, h), w),
        sorted_keys=t((c, h, lp), i64), sorted_pos=t((c, h, lp), i32),
        embs=t((c, lp, d // 2 if storage_dtype == "int4" else d), storage),
        gids=t((c, lp), i32), sizes=t((c,), i32), tombstones=t((c,), i32), next_gid=t((), i32),
        emb_scales=t((c, lp), f32) if quantized else None,
        rescore_embs=t((c, lp, d), f32) if quantized and rescore_tier == "device" else None,
        sketches=t((c, lp, quant_lib.sketch_width(d)), i32) if quantized else None,
        store=(bank_lib.EmbStore(shape=(c, lp, d)) if quantized and rescore_tier == "host"
               else None),
        code_dtype=storage_dtype if quantized else "int8",
    )
    return LiderParams(centroid_cm=centroid_cm, centroids=t((c, d), f32), bank=bank)


def _lider_shard(params: LiderParams, grid: Grid, caxes, device) -> LiderParams:
    """The rank's shard of ``params`` as uninitialised tensors on
    ``device``: each leaf at its block shape under
    ``core.distributed.lider_param_specs`` (the host store's cluster slice
    abstract too)."""
    specs = iter(dist_lib.lider_param_specs(params, caxes).values())
    mk = lambda x: _block(x.shape, x.dtype, next(specs) or (None,) * x.dim(), grid, device)  # noqa: E731
    out = map_tensors(mk, params)
    store = params.bank.store
    if store is not None:
        lo = sharding.block_shape(store.shape, (tuple(caxes),), grid)
        out = dataclasses.replace(out, bank=dataclasses.replace(
            out.bank, store=bank_lib.EmbStore(shape=lo)))
    return out


def lider_tier_memory(rcfg) -> dict:
    """Index bytes by tier for the storage configs the memory story
    compares: float32 (the baseline), int8 / int4 with the rescore table on
    the device (more device bytes than float32) and on the host tier
    (codes, scales and sketches on the device). The reference's asserts:
    the quantized device bytes hold the sketch table, and the host tier
    pays (int8 + host below int8 on the device and below float32; packed
    int4 below int8)."""
    variants = {
        "float32_device": lider_param_structs(rcfg, storage_dtype="float32", rescore_tier="device"),
        "int8_device": lider_param_structs(rcfg, storage_dtype="int8", rescore_tier="device"),
        "int8_host": lider_param_structs(rcfg, storage_dtype="int8", rescore_tier="host"),
        "int4_device": lider_param_structs(rcfg, storage_dtype="int4", rescore_tier="device"),
        "int4_host": lider_param_structs(rcfg, storage_dtype="int4", rescore_tier="host"),
    }
    out = {name: p.bank.nbytes_by_tier() for name, p in variants.items()}
    c, lp = rcfg.lider.n_clusters, rcfg.capacity
    sketch_bytes = c * lp * quant_lib.sketch_width(rcfg.dim) * 4
    out["sketch_table"] = {"device": int(sketch_bytes), "host": 0}
    host8 = variants["int8_host"].bank
    assert (out["int8_host"]["device"] - host8.embs.numel() - host8.emb_scales.numel() * 4
            >= sketch_bytes), "quantized device bytes must include the sketch table"
    assert out["int8_host"]["device"] < out["int8_device"]["device"], (
        "host tier must shrink the device-resident index")
    assert out["int8_host"]["device"] < out["float32_device"]["device"], (
        "int8+host must beat the f32 device footprint")
    assert out["int4_host"]["device"] < out["int8_host"]["device"], (
        "packed int4 codes must shrink the device-resident index vs int8")
    return out


def make_retrieval_bundle(arch: ArchSpec, shape: ShapeSpec, grid: Grid, *, device,
                          capacity_factor: float = 2.0, **_) -> StepBundle:
    """The build cell is the sharded Lloyd step over the corpus's rows;
    the serve cells are the sharded search, per query, over the rank's
    shard of the index (the config's storage and tier), the queries over
    ``model`` where the batch splits (the reference's ``q_axes`` rule). A
    host-tier bank's step is its device phase, ``search.stage1``."""
    rcfg = arch.config
    cfg = rcfg.lider
    dp = data_axes(grid)
    name = _name(arch, shape)
    if shape.kind == "build":
        step = dist_lib.make_sharded_kmeans_step(grid, n_clusters=cfg.n_clusters, data_axes=dp)
        x = _block((rcfg.corpus_size, rcfg.dim), torch.float32, (dp, None), grid, device)
        cen = _block((cfg.n_clusters, rcfg.dim), torch.float32, (None, None), grid, device)
        return StepBundle(name, step, (x, cen),
                          2.0 * rcfg.corpus_size * cfg.n_clusters * rcfg.dim,
                          loop_factor=float(rcfg.corpus_size // grid.axis_size(dp) // 4096))

    b = shape.dims["batch"]
    q_axes = ("model",) if "model" in grid.axis_names and b % grid.shape["model"] == 0 else ()
    params = _lider_shard(lider_param_structs(rcfg), grid, dp, device)
    search = dist_lib.make_sharded_search(
        grid, params, k=rcfg.k, n_probe=cfg.n_probe, r0=cfg.r0, r0_centroid=cfg.r0_centroid,
        cluster_axes=dp, query_axes=q_axes, capacity_factor=capacity_factor)
    queries = _block((b, rcfg.dim), torch.float32, (q_axes or None, None), grid, device)
    return StepBundle(name, getattr(search, "stage1", search), (params, queries),
                      flops_lib.lider_search_flops(rcfg, b),
                      tier_memory=lider_tier_memory(rcfg))


FAMILY_BUILDERS = {
    "lm": make_lm_bundle,
    "gnn": make_gnn_bundle,
    "recsys": make_recsys_bundle,
    "retrieval": make_retrieval_bundle,
}


def make_bundle(arch: ArchSpec, shape: ShapeSpec, grid: Grid, *, device, **knobs) -> StepBundle:
    """The bundle of one cell; ``knobs`` go to the family's builder (an
    LM's ``cfg``, say)."""
    return FAMILY_BUILDERS[arch.family](arch, shape, grid, device=device, **knobs)
