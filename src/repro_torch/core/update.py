"""Incremental index maintenance: upsert / delete without a full rebuild.

The port of the JAX package's ``core/update.py``, device tier. The unit of
the offline build is a batch of per-cluster refits, so maintenance edits
the packed rows of the touched clusters and re-runs the same refit on only
those clusters.

**Upsert** routes each new embedding through layer 1 (exact
nearest-centroid by default, the rule Stage 1 applies, so an upserted index
is slot for slot a layer-1-frozen rebuild over the combined corpus;
``route="learned"`` asks the centroids retriever instead), appends into the
free slots of the target clusters, grows the slot axis ``Lp`` in
``pad_multiple`` steps on overflow, and refits the dirty clusters.

**Delete** tombstones: the global ids are cleared from ``bank.gids`` and the
``sorted_pos`` entries that point at dead rows are set to -1, so
verification never surfaces them. A cluster whose tombstone fraction
crosses ``refit_threshold`` is compacted (live rows repacked to the slot
prefix, in order) and refit.

Against the JAX package: no batch padding (JAX pads batches and cluster
lists to powers of two only to bound jit recompiles); slots and gids are
the same. JAX's ``.at[...].set(mode="drop")`` becomes an explicit mask of
in-range targets; every argsort stays stable. Refits run in the build's
fixed-size chunks (``bank.fit_chunks``), so a refit cluster is fitted bit
for bit as a build fits it. Each call returns new tensors for what it
changes and leaves the caller's index as it was.

The host rescore tier is a later slice: its branches raise
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses

import torch

from . import bank as bank_lib
from . import clustering
from .bank import ClusterBank
from .lider import LiderParams, padded_capacity, route_queries

_HOST_TIER = "the host rescore tier is a later port slice"


@dataclasses.dataclass(frozen=True)
class UpdateStats:
    """Host-side accounting for one upsert/delete call."""

    n_added: int = 0
    n_deleted: int = 0
    n_refit: int = 0  # clusters re-fit (dirty or compacted)
    capacity: int = 0  # Lp after the call
    capacity_grew: bool = False  # the slot axis changed shape


def tombstone_fraction(bank: ClusterBank) -> torch.Tensor:
    """(c,) fraction of occupied slots that are dead."""
    used = bank.sizes + bank.tombstones
    return bank.tombstones / torch.clamp(used, min=1)


def _put(old: torch.Tensor, idx: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """A copy of ``old`` with rows ``idx`` of its leading axis set to ``new``."""
    out = old.clone()
    out[idx] = new
    return out


def _scatter_fit(bank: ClusterBank, cids: torch.Tensor, sk, sp, resc, rmi) -> ClusterBank:
    """Write per-cluster fit results back at clusters ``cids``."""
    fields = lambda p: {f.name: getattr(p, f.name) for f in dataclasses.fields(p)
                        if isinstance(getattr(p, f.name), torch.Tensor)}
    return dataclasses.replace(
        bank,
        sorted_keys=_put(bank.sorted_keys, cids, sk),
        sorted_pos=_put(bank.sorted_pos, cids, sp),
        rescale=dataclasses.replace(
            bank.rescale, **{f: _put(v, cids, getattr(resc, f)) for f, v in fields(bank.rescale).items()}
        ),
        rmi=dataclasses.replace(
            bank.rmi, **{f: _put(v, cids, getattr(rmi, f)) for f, v in fields(bank.rmi).items()}
        ),
    )


def _refit_clusters(bank: ClusterBank, cids: torch.Tensor) -> ClusterBank:
    """Re-run the build's fit on clusters ``cids`` ((m,) distinct ids). A
    quantized bank fits its dequantized codes, as the build does."""
    if cids.numel() == 0:
        return bank
    fit = bank_lib.fit_clusters(
        bank.lsh, bank.embs, bank.gids >= 0, n_leaves=bank.rmi.n_leaves,
        scales=bank.emb_scales, code_dtype=bank.code_dtype, cids=cids,
    )
    return _scatter_fit(bank, cids, *fit)


def _append_rows(
    bank: ClusterBank, new_embs: torch.Tensor, assignment: torch.Tensor
) -> ClusterBank:
    """Scatter ``new_embs`` into the free slot prefix of their clusters.

    A point's slot is its cluster's occupied prefix (live + tombstoned)
    plus its rank among this batch's points of that cluster, in input
    order. New global ids continue from ``bank.next_gid`` in input order:
    the ids a layer-1-frozen rebuild over ``concat(old corpus, new_embs)``
    would assign. The caller guarantees capacity (grows first); targets
    outside the table are masked off, as JAX's ``mode="drop"`` drops them.
    """
    c, lp = bank.gids.shape
    n = new_embs.shape[0]
    dev = new_embs.device
    a = assignment.to(torch.int64)
    used = (bank.sizes + bank.tombstones).to(torch.int64)
    counts = torch.bincount(a, minlength=c)[:c]
    order = torch.sort(a, stable=True).indices
    sorted_a = a[order]
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n, device=dev) - starts[sorted_a]
    slot = used[sorted_a] + rank
    keep = (slot < lp) & (sorted_a >= 0) & (sorted_a < c)
    flat_slot = (sorted_a * lp + slot)[keep]
    rows = order[keep]
    stored, scl, res, sk = bank_lib.store_rows(new_embs[rows], bank.storage_dtype)

    def put_rows(table, values):
        flat = table.reshape(c * lp, *table.shape[2:]).clone()
        flat[flat_slot] = values.to(table.dtype)
        return flat.reshape(table.shape)

    extra = {}
    if bank.quantized:
        extra["emb_scales"] = put_rows(bank.emb_scales, scl)
        extra["rescore_embs"] = put_rows(bank.rescore_embs, res)
        if bank.sketches is not None:
            # Sketches are row-local (signs of the raw row), so the append
            # keeps them byte-identical to a rebuild's sketch table.
            extra["sketches"] = put_rows(bank.sketches, sk)
    new_gids = (bank.next_gid.to(torch.int64) + rows).to(torch.int32)
    return dataclasses.replace(
        bank,
        gids=put_rows(bank.gids, new_gids),
        embs=put_rows(bank.embs, stored),
        sizes=bank.sizes + counts.to(torch.int32),
        next_gid=bank.next_gid + int(((a >= 0) & (a < c)).sum()),
        **extra,
    )


def upsert(
    params: LiderParams,
    new_embs,
    *,
    pad_multiple: int = 8,
    route: str = "exact",
    n_probe_route: int = 1,
) -> tuple[LiderParams, UpdateStats]:
    """Add ``new_embs`` (n, d) to the index; refit only the touched clusters.

    ``route="exact"`` assigns by nearest centroid (the Stage-1 rule: keeps
    the rebuild-parity guarantee); ``route="learned"`` asks the centroids
    retriever for the top-1 cluster. Layer 1 (centroids and retriever) is
    never refit. ``stats.capacity_grew`` says whether ``Lp`` changed.
    """
    bank = params.bank
    if bank.store is not None:
        raise NotImplementedError(_HOST_TIER)
    c = bank.n_clusters
    new_embs = torch.as_tensor(new_embs, dtype=torch.float32, device=params.device)
    if route == "exact":
        assignment, _ = clustering.assign_chunked(new_embs, params.centroids)
    elif route == "learned":
        routed = route_queries(params, new_embs, n_probe=n_probe_route)
        assignment = routed.ids[:, 0].to(torch.int32)
    else:
        raise ValueError(f"route must be 'exact' or 'learned', got {route!r}")

    counts = torch.bincount(assignment.to(torch.int64), minlength=c)[:c]
    needed = int((bank.sizes + bank.tombstones + counts).max())
    grew = needed > bank.capacity
    if grew:
        bank = bank_lib.grow_bank(bank, padded_capacity(needed, None, pad_multiple))
    bank = _append_rows(bank, new_embs, assignment)
    dirty = torch.unique(assignment.to(torch.int64))
    dirty = dirty[(dirty >= 0) & (dirty < c)]
    bank = _refit_clusters(bank, dirty)
    stats = UpdateStats(
        n_added=int(new_embs.shape[0]),
        n_refit=int(dirty.numel()),
        capacity=bank.capacity,
        capacity_grew=grew,
    )
    return dataclasses.replace(params, bank=bank), stats


def _tombstone(bank: ClusterBank, dead_gids: torch.Tensor) -> tuple[ClusterBank, torch.Tensor]:
    """Mark global ids dead: clear ``gids`` and the ``sorted_pos`` entries
    that point at them. Returns (bank, newly dead count per cluster)."""
    c, h, lp = bank.sorted_pos.shape
    gids = bank.gids.to(torch.int64)
    sorted_dead = torch.sort(dead_gids.to(torch.int64).reshape(-1)).values
    if sorted_dead.numel() == 0:
        dead = torch.zeros_like(bank.gids, dtype=torch.bool)
    else:
        # Membership by sort + searchsorted, not a (c, Lp, g) compare.
        at = torch.clamp(torch.searchsorted(sorted_dead, gids), max=sorted_dead.numel() - 1)
        dead = (sorted_dead[at] == gids) & (gids >= 0)
    n_dead = dead.sum(-1).to(torch.int32)
    sp = bank.sorted_pos.reshape(c, h * lp)
    dead_at = torch.gather(dead, 1, torch.clamp(sp, min=0).to(torch.int64)) & (sp >= 0)
    bank = dataclasses.replace(
        bank,
        gids=torch.where(dead, -1, bank.gids),
        sorted_pos=torch.where(dead_at, -1, sp).reshape(c, h, lp),
        sizes=bank.sizes - n_dead,
        tombstones=bank.tombstones + n_dead,
    )
    return bank, n_dead


def _compact_clusters(bank: ClusterBank, cids: torch.Tensor) -> ClusterBank:
    """Repack the live rows of clusters ``cids`` to the slot prefix and
    refit them with :func:`_refit_clusters`, the build's fit.

    Live rows keep their relative order (a stable sort), so a compacted
    cluster is row for row what a fresh pack of its survivors gives. The
    stored representation moves as it is (codes stay codes: quantization is
    row-local, so moving a row never re-rounds it); dead slots revert to a
    fresh pack's padding (zero rows, gid -1, scale 1.0, zero sketch words).
    The rows move ``_FIT_CHUNK`` clusters at a time, so the gathered copy
    stays a chunk in size.
    """
    pads = {"embs": 0, "gids": -1, "emb_scales": 1.0, "rescore_embs": 0, "sketches": 0}
    out = {name: getattr(bank, name).clone() for name in pads if getattr(bank, name) is not None}
    for s in range(0, cids.shape[0], bank_lib._FIT_CHUNK):
        idx = cids[s : s + bank_lib._FIT_CHUNK]
        gid_rows = bank.gids[idx]  # (m, Lp)
        order = torch.sort((gid_rows < 0).to(torch.uint8), dim=-1, stable=True).indices
        live = torch.gather(gid_rows, 1, order) >= 0
        for name, table in out.items():
            rows = getattr(bank, name)[idx]
            at, keep = (order[..., None], live[..., None]) if rows.dim() == 3 else (order, live)
            table[idx] = torch.where(keep, torch.take_along_dim(rows, at, dim=1), pads[name])
    bank = dataclasses.replace(bank, **out, tombstones=_put(bank.tombstones, cids, 0))
    return _refit_clusters(bank, cids)


def delete(
    params: LiderParams,
    gids,
    *,
    refit_threshold: float = 0.25,
) -> tuple[LiderParams, UpdateStats]:
    """Tombstone global ids ``gids`` ((g,) int); lazily compact and refit.

    Tombstoned ids are never surfaced (their candidates carry ``out_id =
    -1``, the kernels' padding). Clusters whose dead fraction exceeds
    ``refit_threshold`` are compacted at once; ``0.0`` compacts every
    touched cluster, ``1.0`` defers indefinitely. Capacity never changes.
    """
    if params.bank.store is not None:
        raise NotImplementedError(_HOST_TIER)
    gids = torch.as_tensor(gids, device=params.device)
    bank, n_dead = _tombstone(params.bank, gids)
    frac = tombstone_fraction(bank)
    to_compact = torch.nonzero((frac > refit_threshold) & (bank.tombstones > 0))[:, 0]
    if to_compact.numel():
        bank = _compact_clusters(bank, to_compact)
    stats = UpdateStats(
        n_deleted=int(n_dead.sum()),
        n_refit=int(to_compact.numel()),
        capacity=bank.capacity,
        capacity_grew=False,
    )
    return dataclasses.replace(params, bank=bank), stats
