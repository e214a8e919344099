"""Distributed LIDER on ``torch.distributed``: the cluster-sharded search on
both rescore tiers and in both spellings, degraded shards, and the sharded
Lloyd step (the paper's "parallelise across clusters").

The port of the JAX package's ``core/distributed.py``, laid over a
:class:`~repro_torch.launch.mesh.Grid` of ranks, one process each:

- the cluster axis of every bank tensor is sharded over ``cluster_axes``
  (default ``data``): a rank holds ``c / S`` clusters
  (:func:`shard_lider_params`, from the bank's ``cluster_axis`` field
  metadata);
- the query batch is sharded over ``query_axes`` (default ``model``): each
  (cluster shard, query shard) rank owns a disjoint tile of (clusters x
  queries), so the search covers every pair once;
- the centroid retriever and the bank's LSH are replicated.

Search on each rank:

1. route its ``B / Q`` queries on the replicated centroid retriever
   (redundant across cluster shards, cheaper than sending routed ids);
2. capacity dispatch: of its ``B_loc * n_probe`` (query, cluster) pairs,
   keep those this shard owns, packed to ``cap`` slots (my pairs first, a
   stable sort); overflow drops are counted;
3. the per-pair in-cluster search;
4. scatter the pair results back to their queries, local top-k;
5. one all-gather of the (B_loc, k) ids and scores over the cluster axes,
   and the final merge, plus the sum of the drop count over the cluster
   and query axes.

Every kernel call goes through ``kernels.ops``: the CUDA kernels on the
card, their plain versions on the CPU.

Where the port differs from the JAX program:

- JAX takes and returns one global array. Here each rank is given its own
  query shard (:func:`shard_rows` over the query axes) and returns its
  answers; :func:`gather_query_shards` collects the batch where a caller
  needs it (tests, the example), outside the search.
- The host tier. JAX's front end fetches the merged top-k' rows from a
  process-local store that holds the whole table, with no new collective.
  Here a rank is a process and holds only its clusters' host rows. After
  the provisional merge each rank fetches the merged rows it owns (the
  others become -1, and only the owned rows cross to the card), rescores
  them (``rescore_fetched_rows`` scores each row alone, so a row's score
  is the one it gets among all k'), and a second all-gather of (B_loc, k)
  merges the ranks' answers by passage id: the exact top-k of the global
  merged top-k', JAX's answer. That second collective is what sharding
  the host tier across processes costs.
- Over gloo, the collectives copy CUDA tensors to the host and back
  (``Grid.all_gather``); ids and scores travel as one int32 tensor.
- No ``use_fused`` or ``block_c``: dispatch is by device, as everywhere
  in the port.
- A ``kill_shard`` fault (``faults.SHARD_SEARCH``) is read on each rank
  from its own fault plan, so the plan must be active on every rank; its
  schedule is deterministic, so every rank marks the same shards dead.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import NamedTuple, Sequence

import numpy as np
import torch

from .. import faults
from ..kernels.schedule import _pad_pow2, build_cluster_schedule
from ..launch.mesh import Grid
from .bank import ClusterBank, EmbStore, replicated_field_names
from .clustering import kmeans_step, update_centroids
from .core_model import TopK, search_core_model
from .types import map_tensors
from .lider import (
    LiderParams,
    _cluster_major_first_pass,
    _rescore_provisional,
    _row_gids,
    incluster_search,
    provisional_rows,
    prune_probes,
    rescore_fetched_rows,
)
from .utils import dedup_topk


def _tensors(obj, path: tuple) -> list:
    """``(name, tensor)`` for every tensor in ``obj`` (a tensor, dataclass
    or named tuple), named by field path joined with ``__``."""
    if isinstance(obj, torch.Tensor):
        return [("__".join(path), obj)]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        names = [f.name for f in dataclasses.fields(obj)]
    elif isinstance(obj, tuple) and hasattr(obj, "_fields"):
        names = list(obj._fields)
    else:
        return []
    return [kv for n in names for kv in _tensors(getattr(obj, n), path + (n,))]


def named_leaves(params: LiderParams) -> dict[str, torch.Tensor]:
    """Every tensor leaf of ``params`` by its name in the JAX package's
    checkpoints (``bank__embs``, ``centroid_cm__rmi__root_w``...)."""
    return dict(_tensors(params, ()))


def lider_param_specs(params: LiderParams, cluster_axes: Sequence[str]) -> dict[str, tuple]:
    """The layout of every tensor leaf, by leaf name (:func:`named_leaves`):
    ``(cluster_axes, None, ...)`` for a leaf sharded on its leading axis,
    ``()`` for a replicated one; the tuples a JAX ``PartitionSpec`` of the
    same leaf iterates as.

    Derived from the :class:`~repro_torch.core.bank.ClusterBank` field
    metadata, not from a list of names: every tensor under a bank field
    whose ``cluster_axis`` is 0 is sharded; the fields marked ``None`` (the
    shared LSH, ``next_gid``) and everything outside the bank (the
    centroids and their retriever) are replicated. A host-tier bank's
    ``store`` holds no device tensor and has no entry.
    """
    caxes = tuple(cluster_axes)
    replicated = set(replicated_field_names())
    specs = {}
    for name, t in named_leaves(params).items():
        path = name.split("__")
        sharded = path[0] == "bank" and path[1] not in replicated
        specs[name] = (caxes,) + (None,) * (t.dim() - 1) if sharded else ()
    return specs


def _cluster_slice(grid: Grid, n_clusters: int, caxes) -> tuple[int, int]:
    s = grid.axis_size(caxes)
    if n_clusters % s:
        raise ValueError(f"n_clusters={n_clusters} must divide cluster shards={s}")
    c_loc = n_clusters // s
    my = grid.flat_index(caxes)
    return my * c_loc, (my + 1) * c_loc


def shard_lider_params(
    grid: Grid, params: LiderParams, cluster_axes: Sequence[str] = ("data",)
) -> LiderParams:
    """This rank's shard of ``params``: its clusters' slice of every
    cluster-sharded leaf and a copy of every replicated one, on the grid's
    device. Each slice is taken before it moves, so a rank
    never puts the whole bank on its card, and every leaf is a copy, so the
    shard keeps no reference to ``params``.

    A host-tier bank's :class:`~repro_torch.core.bank.EmbStore` is sliced
    the same way in host memory: the rank keeps its clusters' host rows and
    their gid copy.
    """
    caxes = tuple(cluster_axes)
    dev = grid.device
    bank = params.bank
    lo, hi = _cluster_slice(grid, bank.n_clusters, caxes)
    copy = lambda t: t.to(dev, copy=True)  # noqa: E731
    replicated = set(replicated_field_names())
    changes = {}
    for f in dataclasses.fields(ClusterBank):
        value = getattr(bank, f.name)
        if isinstance(value, EmbStore):
            gids = None if value.gids is None else value.gids[lo:hi].clone()
            changes[f.name] = EmbStore(value.rescore[lo:hi].clone(), gids=gids)
        elif f.name in replicated:
            changes[f.name] = map_tensors(copy, value)
        else:
            changes[f.name] = map_tensors(lambda t: t[lo:hi].to(dev, copy=True), value)
    return LiderParams(
        centroid_cm=map_tensors(copy, params.centroid_cm),
        centroids=copy(params.centroids),
        bank=dataclasses.replace(bank, **changes),
    )


def shard_rows(grid: Grid, x: torch.Tensor, data_axes: Sequence[str] = ("data",)) -> torch.Tensor:
    """This rank's rows of ``x``: the ``flat_index(data_axes)``-th of ``S``
    equal row blocks (``N % S == 0``). The sharded Lloyd step's rows over
    the data axes; the sharded search's queries over its query axes."""
    s = grid.axis_size(data_axes)
    if x.shape[0] % s:
        raise ValueError(f"{x.shape[0]} rows must divide data shards={s}")
    n_loc = x.shape[0] // s
    my = grid.flat_index(data_axes)
    return x[my * n_loc : (my + 1) * n_loc]


def gather_query_shards(grid: Grid, out: TopK, query_axes: Sequence[str] = ("model",)) -> TopK:
    """The whole batch's answers on every rank from each rank's query shard
    (one all-gather over ``query_axes``). Not part of the search: for
    callers that want JAX's global array."""
    qaxes = tuple(query_axes)
    if not qaxes:
        return out
    n = out.ids.shape[-1]
    g = grid.all_gather(_pack(out.ids, out.scores), qaxes)
    g = g.reshape(-1, 2 * n)
    return TopK(ids=g[:, :n].contiguous(), scores=g[:, n:].contiguous().view(torch.float32))


def _pack(ids: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
    """(B, k) int32 ids and float32 scores as one (B, 2k) int32 tensor, so
    one collective carries both, bit for bit."""
    return torch.cat([ids.to(torch.int32), scores.to(torch.float32).view(torch.int32)], dim=-1)


class _Pairs(NamedTuple):
    """One rank's dispatched (query, probe) pairs: ``sel`` (cap,) indexes
    the ``n_pairs = b_loc * P`` pairs of its queries, mine first;
    ``sel_valid`` marks the slots that hold one of this shard's pairs,
    ``sel_cid`` its local cluster (-1 otherwise) and ``q_pairs`` its
    query; ``dropped`` counts my pairs past the capacity (0-d). ``sched``
    is the cluster-major schedule (``block_q`` only)."""

    q_pairs: torch.Tensor
    sel: torch.Tensor
    sel_valid: torch.Tensor
    sel_cid: torch.Tensor
    dropped: torch.Tensor
    b_loc: int
    n_pairs: int
    sched: tuple | None = None


def _scatter_pairs(vals, fill, pr: _Pairs):
    """Per-pair results ``(cap, k)`` back to their (query, probe) rows ->
    ``(b_loc, P * k)``; slots of invalid pairs land on a spare row that is
    cut off."""
    idx = torch.where(pr.sel_valid, pr.sel, pr.n_pairs)
    buf = torch.full((pr.n_pairs + 1, vals.shape[-1]), fill, dtype=vals.dtype, device=vals.device)
    buf[idx] = vals
    return buf[:-1].reshape(pr.b_loc, -1)


def make_sharded_search(
    grid: Grid,
    params_like: LiderParams,
    *,
    k: int,
    n_probe: int,
    r0: int = 4,
    r0_centroid: int = 4,
    capacity_factor: float = 2.0,
    cluster_axes: Sequence[str] = ("data",),
    query_axes: Sequence[str] = ("model",),
    refine: bool = False,
    prune_margin: float | None = None,
    rescore_factor: int = 4,
    block_q: int | None = None,
    sketch_factor: int | None = None,
):
    """The sharded search on this rank: ``search(shard, queries,
    shard_health=None) -> (TopK, dropped)``.

    ``params_like`` is this rank's shard (:func:`shard_lider_params`); its
    cluster count, storage and rescore tier are read. ``queries`` is the
    rank's own (B/Q, d) block of the batch, ``shard_rows(grid, queries,
    query_axes)`` (JAX's ``shard_map`` gives a device its block so), and
    the rank returns its (B/Q, k) answers. ``dropped`` is the capacity-overflow count
    summed over the grid (a 0-d tensor). Every rank of the grid must call
    the search together: it runs collectives.

    ``prune_margin`` prunes routed probes before the dispatch, so pruned
    pairs take no capacity slot. A quantized bank runs its first pass and
    exact rescore shard-locally (``rescore_factor``, ``sketch_factor``).

    A host-tier bank runs in two phases: ``search.stage1`` (route ->
    dispatch -> first pass -> the provisional top-k' merged over the
    cluster shards as global flat rows, k' wide) and the front end (each
    rank fetches and rescores the merged rows it owns; a second all-gather
    merges by passage id; module docstring).

    ``block_q`` (quantized banks only) chooses the dispatch and the first
    pass: the rank routes its queries, copies the routed ids to the host
    (one sync), replays the dispatch in NumPy with the same rule
    (``np.argsort(~mine, kind="stable")``, the same capacity) and builds the schedule of its own
    (cluster shard, query shard) cell, padded to ``_pad_pow2(cap)`` steps;
    the cluster-major first pass runs on it. The rest is the per-query
    spelling's, and so are the results, bit for bit.

    Degraded mode: ``shard_health`` is a bool mask over the cluster shards
    (default all live). A dead shard's answers are masked to (-1, -inf)
    before the all-gather and its drops do not count. ``search.shard_stats``
    holds the last call's ``{"shards_live", "shards_total"}``, and
    ``search.timings`` its seconds in collectives (``gather_s``, read off
    the grid's ``comm_s``: each collective is timed after the rank's own
    device work has finished, so it holds the staging, the exchange and the
    wait for the other ranks) and, for
    ``block_q``, in the host pre-pass (``prepass_s``).
    """
    caxes, qaxes = tuple(cluster_axes), tuple(query_axes)
    if set(caxes) & set(qaxes):
        raise ValueError(f"cluster axes {caxes} and query axes {qaxes} overlap")
    n_cluster_shards = grid.axis_size(caxes)
    reduce_axes = caxes + qaxes
    host_tier = params_like.bank.rescore_tier == "host"
    if block_q is not None and not params_like.bank.quantized:
        raise ValueError(
            "block_q (cluster-major schedule) on the sharded path requires a quantized "
            "(int8/int4) bank: use the per-query spelling (block_q=None) for float banks"
        )
    my = grid.flat_index(caxes)
    # Create the process groups now, on every rank in the same order.
    grid.group(caxes)
    grid.group(reduce_axes)
    search_kw = dict(k=k, r0=r0, refine=refine, rescore_factor=rescore_factor,
                     sketch_factor=sketch_factor)

    def capacity(n_pairs: int) -> int:
        return min(n_pairs, int(math.ceil(n_pairs / n_cluster_shards * capacity_factor)))

    def my_queries(params, queries) -> torch.Tensor:
        return torch.as_tensor(queries, dtype=torch.float32, device=params.centroids.device)

    def route(params, q_loc) -> torch.Tensor:
        routed = search_core_model(params.centroid_cm, params.centroids, q_loc,
                                   k=n_probe, r0=r0_centroid)
        # Pruned probes are -1: never mine on any shard, so they take no slot.
        return prune_probes(routed.ids, routed.scores, prune_margin)

    def device_pairs(params, q_loc) -> _Pairs:
        c_local = params.bank.gids.shape[0]
        cids = route(params, q_loc)
        b_loc, p = cids.shape
        n_pairs = b_loc * p
        flat = cids.reshape(-1).to(torch.int64)
        owner = torch.where(flat >= 0, torch.div(flat, c_local, rounding_mode="floor"), -1)
        mine = owner == my
        # My pairs first, the rest in (query, probe) order: which pairs fit
        # the capacity, and so the drops, follow JAX's stable argsort.
        order = torch.argsort((~mine).to(torch.int32), stable=True)
        sel = order[: capacity(n_pairs)]
        sel_valid = mine[sel]
        sel_cid = torch.where(sel_valid, flat[sel] - my * c_local, -1).to(torch.int32)
        return _Pairs(q_loc[torch.div(sel, p, rounding_mode="floor")], sel, sel_valid, sel_cid,
                      mine.sum() - sel_valid.sum(), b_loc, n_pairs)

    def host_pairs(params, q_loc) -> _Pairs:
        c_local = params.bank.gids.shape[0]
        t0 = time.perf_counter()
        cids = route(params, q_loc).cpu().numpy()  # the host sync
        b_loc, p = cids.shape
        n_pairs = b_loc * p
        cap = capacity(n_pairs)
        flat = cids.reshape(-1)
        owner = np.where(flat >= 0, flat // c_local, -1)
        mine = owner == my
        # The stable argsort of the device dispatch: my pairs first, in
        # (query, probe) order, so the schedule and the pairs agree.
        sel = np.argsort(~mine, kind="stable")[:cap].astype(np.int64)
        sv = mine[sel]
        scl = np.where(sv, flat[sel] - my * c_local, -1).astype(np.int32)
        sched = build_cluster_schedule(scl[:, None], block_q=block_q, pad_to=_pad_pow2(cap))
        timings["prepass_s"] = time.perf_counter() - t0
        dev = q_loc.device
        t = lambda a: torch.from_numpy(np.asarray(a)).to(dev)  # noqa: E731
        return _Pairs(
            q_loc[t(sel // p)], t(sel), t(sv), t(scl),
            t(np.int64(int(mine.sum()) - int(sv.sum()))), b_loc, n_pairs,
            tuple(t(a) for a in (sched.sched_cids, sched.sched_qids, sched.pair_step,
                                 sched.pair_slot)),
        )

    if block_q is None:
        make_pairs = device_pairs

        def first_pass(params, pr):
            """Each pair's provisional top-k' as local flat rows."""
            return provisional_rows(params, pr.q_pairs, pr.sel_cid[:, None], **search_kw)

        def pair_topk(params, pr):
            return incluster_search(params, pr.q_pairs, pr.sel_cid[:, None], **search_kw)
    else:
        make_pairs = host_pairs

        # The entries' bodies, uncaptured: the JAX package runs them inside
        # its one shard_map jit, where they add no trace of their own.
        def first_pass(params, pr):
            return _cluster_major_first_pass.__wrapped__(
                params, pr.q_pairs, pr.sel_cid[:, None], *pr.sched, block_q=block_q, **search_kw
            )

        def pair_topk(params, pr):
            # Device tier: the exact rescore of each pair's provisional rows.
            bank = params.bank
            return _rescore_provisional.__wrapped__(
                bank.gids, bank.rescore_embs, first_pass(params, pr).ids, pr.q_pairs, k=k
            )

    def resolve_health(shard_health) -> np.ndarray:
        """The caller's mask plus any injected shard kill, on the host."""
        if shard_health is None:
            health = np.ones(n_cluster_shards, np.bool_)
        else:
            health = np.array(shard_health, np.bool_).reshape(-1).copy()
            if health.shape[0] != n_cluster_shards:
                raise ValueError(f"shard_health has {health.shape[0]} entries, expected "
                                 f"{n_cluster_shards} cluster shards")
        spec = faults.fire(faults.SHARD_SEARCH)
        if spec is not None and spec.mode == "kill_shard":
            payload = spec.payload or {}
            dead = payload.get("shards")
            if dead is None:
                dead = [payload.get("shard", 0)]
            for s in dead:
                health[int(s) % n_cluster_shards] = False
        return health

    timings = {"gather_s": 0.0, "prepass_s": 0.0}
    comm_from = [0.0]  # the grid's collective seconds when the call began

    def timed(out):
        """``out``, with the call's collective seconds read off the grid."""
        timings["gather_s"] = grid.comm_s - comm_from[0]
        return out

    def merge(ids, scores):
        """The all-gather of (B_loc, kk) over the cluster shards + the merge."""
        b_loc, kk = ids.shape
        g = grid.all_gather(_pack(ids, scores), caxes)  # (S, B_loc, 2kk)
        g = g.transpose(0, 1)  # (B_loc, S, 2kk): shard order kept per query
        return dedup_topk(g[..., :kk].reshape(b_loc, -1),
                          g[..., kk:].contiguous().view(torch.float32).reshape(b_loc, -1), kk)

    def local_topk(ids, scores, pr: _Pairs, alive: bool):
        """Per-pair (cap, kk) results -> each query's top-kk on this shard."""
        l_ids, l_sc = dedup_topk(_scatter_pairs(ids, -1, pr),
                                 _scatter_pairs(scores, float("-inf"), pr), ids.shape[-1])
        if not alive:  # degraded: a dead shard contributes nothing
            l_ids, l_sc = torch.full_like(l_ids, -1), torch.full_like(l_sc, float("-inf"))
        return l_ids, l_sc

    def sum_drops(dropped, alive):
        return grid.all_reduce(dropped.reshape(()).to(torch.int64) * int(alive), reduce_axes)

    def start(fn, params, queries, shard_health):
        health = resolve_health(shard_health)
        fn.shard_stats = {"shards_live": int(health.sum()), "shards_total": n_cluster_shards}
        timings.update(gather_s=0.0, prepass_s=0.0)
        comm_from[0] = grid.comm_s
        q_loc = my_queries(params, queries)
        return bool(health[my]), make_pairs(params, q_loc)

    if host_tier:

        def stage1(params, queries, shard_health=None):
            """Host tier, device phase: -> (merged rows (B_loc, k') as
            global flat rows, code-domain scores, dropped). Rows are offset
            by this shard's first row, so the row dedup of the merge stays
            exact across shards."""
            alive, pr = start(stage1, params, queries, shard_health)
            prov = first_pass(params, pr)
            c_local, lp = params.bank.gids.shape
            g_rows = torch.where(prov.ids >= 0, prov.ids + my * c_local * lp, -1)
            rows, sc = merge(*local_topk(g_rows, prov.scores, pr, alive))
            return timed((rows, sc, sum_drops(pr.dropped, alive)))

        def search(params, queries, shard_health=None):
            rows, _, dropped = stage1(params, queries, shard_health)
            search.shard_stats = stage1.shard_stats
            # The front end: rescore the merged rows this rank owns, then
            # merge the ranks' top-k by passage id (the second all-gather).
            c_local, lp = params.bank.gids.shape
            lo = my * c_local * lp
            owned = (rows >= lo) & (rows < lo + c_local * lp)
            out = _rescore_fetched(params.bank, torch.where(owned, rows - lo, -1),
                                   my_queries(params, queries), k=k)
            ids, sc = merge(out.ids, out.scores)
            return timed((TopK(ids=ids, scores=sc), dropped))

        search.stage1 = stage1
    else:

        def search(params, queries, shard_health=None):
            alive, pr = start(search, params, queries, shard_health)
            pair = pair_topk(params, pr)  # (cap, k)
            ids, sc = merge(*local_topk(pair.ids, pair.scores, pr, alive))
            return timed((TopK(ids=ids, scores=sc), sum_drops(pr.dropped, alive)))

    search.timings = timings
    return search


def _rescore_fetched(bank: ClusterBank, rows: torch.Tensor, queries: torch.Tensor, *, k: int) -> TopK:
    """The host tier's exact rescore of the rows a rank owns: ``rows`` (B,
    k') are this shard's flat rows, -1 where another shard owns the slot.
    Only the owned rows are fetched from the rank's host store and cross to
    the card; the other slots stay zero and report -1, so they never
    surface. Dedup and ties go by passage id, as in the JAX package's front
    end: passage ids are unique across shards, so the ranks' answers merge
    exactly."""
    host_rows = rows.cpu()
    mine = host_rows >= 0
    dev = queries.device
    fetched = torch.zeros(host_rows.shape + (bank.store.shape[-1],), device=dev)
    fetched[mine.to(dev)] = bank.store.fetch(host_rows[mine]).to(dev)
    ids, sc = rescore_fetched_rows(fetched, _row_gids(bank.gids, rows), queries, k=k)
    return TopK(ids=ids, scores=sc)


# ---------------------------------------------------------------------------
# Distributed build: the sharded Lloyd step (Stage 1 at scale)
# ---------------------------------------------------------------------------


def make_sharded_kmeans_step(
    grid: Grid, *, n_clusters: int, data_axes: Sequence[str] = ("data",), chunk: int = 4096
):
    """One Lloyd iteration with the points sharded over ``data_axes``:
    ``step(x_loc, centroids) -> centroids``, where ``x_loc`` are this
    rank's rows (:func:`shard_rows`) and ``centroids`` the same on every
    rank. Each rank runs ``clustering.kmeans_step`` on its rows (the
    ``kmeans_assign`` kernel and the fixed-order Lloyd sums), the float32
    sums and counts are summed over ``data_axes``, and every rank gets the
    same new centroids."""
    daxes = tuple(data_axes)
    grid.group(daxes)

    def step(x_loc: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
        sums, counts, _ = kmeans_step(x_loc, centroids, n_clusters=n_clusters, chunk=chunk)
        sums = grid.all_reduce(sums.to(torch.float32), daxes)
        counts = grid.all_reduce(counts.to(torch.float32), daxes)
        return update_centroids(centroids, sums, counts)

    return step
