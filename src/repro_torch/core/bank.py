"""ClusterBank: LIDER's stacked per-cluster index state (device tier) and
the staged build primitives.

    sorted_keys  (c, H, Lp) int64    per-cluster sorted hashkey arrays
    sorted_pos   (c, H, Lp) int32    sorted position -> cluster-local row (-1 = pad)
    embs         (c, Lp, d)          rows grouped by cluster (zero at pads): float32 /
                                     bfloat16, int8 codes, or packed int4 (width d/2)
    gids         (c, Lp)    int32    cluster-local row -> global id (-1 = free)
    sizes        (c,)       int32    live rows per cluster
    tombstones   (c,)       int32    dead rows awaiting compaction
    next_gid     ()         int32    next global passage id to assign

Quantized storage (int8 / int4) adds three tables:

    emb_scales   (c, Lp)    float32  per-row symmetric scales
    rescore_embs (c, Lp, d) float32  the raw rows, for the exact rescore
    sketches     (c, Lp, w) int32    1-bit sign sketches, w = ceil(d/32) words

Build: assign -> pack (capacity slots) + store, a range of clusters at a
time (:func:`pack_bank`), -> hash + sort + fit for all clusters, batched
over clusters (:func:`refit_clusters`) in fixed-size chunks
(:func:`fit_chunks`) that bound the temporaries and give every fit one
shape. The fit hashes the rows as the first pass scores them: the
dequantized codes of a quantized bank. :func:`grow_bank` widens the slot
axis for ``core.update``.

The rescore table of a quantized bank lives on one of two tiers
(``rescore_tier``): ``device``, the ``rescore_embs`` tensor next to the
codes, or ``host``, an :class:`EmbStore` holding it in host memory
(``store``), from which a search fetches only the ``B * k'`` rows its
provisional top-k' names.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from . import clustering, lsh as lsh_lib, rescale as rescale_lib, rmi as rmi_lib
from .. import faults
from ..kernels import quant
from .types import tensor_leaves

STORAGE_DTYPES = ("float32", "bfloat16", "int8", "int4")
QUANTIZED_DTYPES = ("int8", "int4")
RESCORE_TIERS = ("device", "host")
# dataclasses.field metadata key of ClusterBank: the leading cluster axis
# (0) or None for fields every rank holds whole (core.distributed).
CLUSTER_AXIS = "cluster_axis"
_FLOAT_STORAGE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _host(t, dtype) -> torch.Tensor:
    """``t`` (a tensor on any device, or an array) as a contiguous CPU
    tensor of ``dtype``."""
    t = torch.as_tensor(t)
    if t.device.type == "cuda":
        t = t.to(dtype)
        return copy_through_pinned(torch.empty(t.shape, dtype=dtype), t)
    return t.to(dtype=dtype).contiguous()


# Bytes of the pinned buffer that :func:`copy_through_pinned` crosses
# through, a chunk at a time.
_STAGING_BYTES = 1 << 28


def pinned_buffer(n_bytes: int) -> torch.Tensor:
    """A pinned host buffer of ``n_bytes`` bytes for :func:`copy_through_pinned`."""
    return torch.empty((n_bytes,), dtype=torch.uint8, pin_memory=True)


def copy_through_pinned(dst: torch.Tensor, src: torch.Tensor, buf: torch.Tensor | None = None) -> torch.Tensor:
    """``dst.copy_(src)`` between the card and host memory, by chunks of
    the leading axis through the pinned buffer ``buf`` (:func:`pinned_buffer`,
    at least one row of ``src``); returns ``dst``. Each chunk is copied
    synchronously, so no pageable copy of the whole tensor is staged at
    once. Without ``buf``, a tensor over ``_STAGING_BYTES`` gets one for the
    call, and a smaller or 0-d tensor copies whole."""
    row = src[0].numel() * src.element_size() if src.dim() else 0
    if buf is None:
        if src.dim() == 0 or src.numel() * src.element_size() <= _STAGING_BYTES:
            return dst.copy_(src)
        buf = pinned_buffer(max(row, _STAGING_BYTES // row * row))
    rows = buf.numel() // row
    for s in range(0, src.shape[0], rows):
        n = min(rows, src.shape[0] - s)
        b = buf[: n * row].view(src.dtype).view(n, *src.shape[1:])
        b.copy_(src[s : s + n])
        dst[s : s + n].copy_(b)
    return dst


def to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``: a CPU tensor goes to the card through
    :func:`copy_through_pinned`."""
    if t.device == device:
        return t
    if device.type != "cuda" or t.device.type != "cpu":
        return t.to(device)
    return copy_through_pinned(torch.empty(t.shape, dtype=t.dtype, device=device), t.contiguous())


class EmbStore:
    """The host tier of the float32 rescore table.

    Holds the table as a contiguous CPU tensor of shape ``(c, Lp, d)``
    (``rescore``; ``rescore.numpy()`` shares its memory), outside the
    bank's device tensors. A store made with ``rescore=None`` and a
    ``shape`` is abstract: it holds no rows, only what the dry run's
    memory model reads (``shape``, ``nbytes``). A search fetches the rows of its provisional
    top-k' with :meth:`fetch` and moves only those ``B * k' * d`` floats
    to the card.

    ``gids`` is a host copy of the bank's gid table, re-synced after every
    update, for callers that map flat rows to passage ids on the host
    (:meth:`take_gids`). The port's search never reads it: it maps rows
    through the device tier's ``bank.gids``.

    The store is mutable shared state: the index lifecycle
    (``core.update``) writes both tiers in lockstep. Content writes
    (:meth:`write_rows`, :meth:`compact_clusters`) change the table in
    place, so an index that shares the store sees them; growth is
    copy-on-grow (:meth:`grown`), because it changes the flat-row
    arithmetic an older index still uses. ``version`` is bumped on every
    host write, so serving can track the host tier's generations apart
    from the device tier's. ``__eq__`` / ``__hash__`` key on (tier, shape,
    dtype) only: content never changes a store's identity.
    """

    tier = "host"

    def __init__(self, rescore=None, *, gids=None, shape=None):
        if rescore is None:
            # Abstract: a shape and no rows (the dry run's memory model).
            if shape is None:
                raise ValueError("EmbStore needs rescore rows or an explicit shape")
            self.rescore, self.shape = None, tuple(int(s) for s in shape)
        else:
            self.rescore = _host(rescore, torch.float32)
            self.shape = tuple(self.rescore.shape)
        self.dtype = torch.float32
        self.gids = None if gids is None else _host(gids, torch.int32)
        self.version = 0  # bumped on every host-tier content write
        self._txn = None  # undo journal while a transaction is open

    def _key(self):
        return (self.tier, self.shape, str(self.dtype))

    def __eq__(self, other):
        return isinstance(other, EmbStore) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return f"EmbStore({self.tier}, {self.shape}, {self.dtype}, v{self.version})"

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * self.dtype.itemsize

    def _table(self) -> torch.Tensor:
        return self.rescore.view(-1, self.shape[-1])

    # -- host-tier access ---------------------------------------------------
    def fetch(self, rows, *, out: torch.Tensor | None = None) -> torch.Tensor:
        """Gather flat bank rows ``(...)`` -> ``(..., d)`` float32 on the
        CPU, into ``out`` when given (a CPU buffer of at least that many
        rows; the result is a view of it).

        ``rows < 0`` (provisional padding) gather row 0; callers report by
        the row array, so padded gathers never surface (the device tier's
        rescore gathers the same way).
        """
        faults.fire(faults.HOST_FETCH)
        rows = torch.as_tensor(rows).cpu()
        flat = torch.clamp(rows.reshape(-1), min=0)
        shape = tuple(rows.shape) + (self.shape[-1],)
        if out is None:
            return torch.index_select(self._table(), 0, flat).view(shape)
        dst = out.view(-1, self.shape[-1])[: flat.numel()]
        torch.index_select(self._table(), 0, flat, out=dst)
        return dst.view(shape)

    def take_gids(self, rows) -> torch.Tensor:
        """Map flat bank rows -> global passage ids via the synced gid copy."""
        if self.gids is None:
            raise ValueError("EmbStore has no synced gids (call sync_gids)")
        rows = torch.as_tensor(rows).cpu()
        out = self.gids.reshape(-1)[torch.clamp(rows, min=0).to(torch.int64)]
        return torch.where(rows < 0, -1, out)

    # -- transactions -------------------------------------------------------
    # The lifecycle writes the table in place, so an exception in the middle
    # of an update would leave a store of mixed generations. A transaction
    # journals the first-touch pre-image of every in-place write; rollback
    # replays the journal in reverse, restoring the table's bytes, the gid
    # copy and ``version``. Growth returns a new store, so rolling back a
    # grown update is dropping the new index.

    def begin_txn(self) -> None:
        """Open a transaction; later in-place writes are journaled."""
        if self._txn is not None:
            raise RuntimeError("EmbStore transaction already open")
        self._txn = {
            "log": [],
            "gids": None if self.gids is None else self.gids.clone(),
            "version": self.version,
        }

    def commit(self) -> None:
        """Close the transaction, keeping every write."""
        if self._txn is None:
            raise RuntimeError("no open EmbStore transaction")
        self._txn = None

    def rollback(self) -> None:
        """Undo every journaled write since :meth:`begin_txn`, newest first."""
        txn = self._txn
        if txn is None:
            raise RuntimeError("no open EmbStore transaction")
        for kind, key, old in reversed(txn["log"]):
            if kind == "rows":
                self._table()[key] = old
            else:  # "clusters"
                self.rescore[key] = old
        self.gids = txn["gids"]
        self.version = txn["version"]
        self._txn = None

    @property
    def in_txn(self) -> bool:
        return self._txn is not None

    # -- host-tier lifecycle writes (lockstep with the device tier) ---------
    def sync_gids(self, gids) -> None:
        self.gids = _host(gids, torch.int32)

    def write_rows(self, flat_slots, rows) -> None:
        """Write ``rows`` at flat slots ``flat_slots``; slots outside the
        table are dropped."""
        table = self._table()
        flat_slots = torch.as_tensor(flat_slots).cpu().reshape(-1).to(torch.int64)
        rows = _host(rows, torch.float32).reshape(-1, self.shape[-1])
        keep = (flat_slots >= 0) & (flat_slots < table.shape[0])
        sel = flat_slots[keep]
        if self._txn is not None:
            self._txn["log"].append(("rows", sel.clone(), table[sel].clone()))
        table[sel] = rows[keep]
        self.version += 1
        # Fires after the write: an update that fails here leaves the host
        # tier ahead of the device tier, the state a transaction undoes.
        faults.fire(faults.HOST_WRITE)

    def grown(self, new_capacity: int) -> "EmbStore":
        """A new store with the slot axis ``Lp`` grown to ``new_capacity``
        (zero rows and gid -1 in the new slots, as the device tier pads).
        Copy-on-grow: an index that still holds this store keeps fetching
        with its own ``Lp``."""
        lp = self.shape[1]
        if new_capacity < lp:
            raise ValueError(f"cannot shrink capacity {lp} -> {new_capacity}")
        if new_capacity == lp:
            return self
        gids = self.gids
        if gids is not None:
            gids = torch.nn.functional.pad(gids, (0, new_capacity - lp), value=-1)
        out = EmbStore(torch.nn.functional.pad(self.rescore, (0, 0, 0, new_capacity - lp)), gids=gids)
        out.version = self.version + 1
        return out

    def compact_clusters(self, cids, gid_rows) -> None:
        """The host tier's half of ``update._compact_clusters``: a stable
        repack of each cluster's live rows to its slot prefix, zeros after.
        ``gid_rows`` are the clusters' gid rows before compaction (live =
        ``gid >= 0``)."""
        table = self.rescore
        cids = torch.as_tensor(cids).cpu().to(torch.int64)
        gid_rows = torch.as_tensor(gid_rows).cpu()
        if self._txn is not None:
            self._txn["log"].append(("clusters", cids.clone(), table[cids].clone()))
        order = torch.sort((gid_rows < 0).to(torch.uint8), dim=-1, stable=True).indices
        live = torch.gather(gid_rows, 1, order) >= 0
        rows = torch.take_along_dim(table[cids], order[..., None], dim=1)
        table[cids] = torch.where(live[..., None], rows, 0.0)
        self.version += 1


def _f(cluster_axis: int | None, default=dataclasses.MISSING):
    """A bank field with its ``cluster_axis`` metadata (:data:`CLUSTER_AXIS`)."""
    return dataclasses.field(metadata={CLUSTER_AXIS: cluster_axis}, default=default)


@dataclasses.dataclass(frozen=True)
class ClusterBank:
    """The bank's fields carry ``cluster_axis`` metadata, which
    ``core.distributed`` reads to shard an index over ranks: 0 for every
    tensor (or container of tensors) whose leading axis is the cluster
    axis, ``None`` for what every rank holds whole. Where the port's fields
    differ from the JAX package's:

    - ``store`` (the host tier) is a field here and static data there. It
      is ``None``: it is no device tensor, and ``shard_lider_params`` slices
      its host table by cluster itself, in host memory.
    - ``code_dtype`` is a plain string in both: ``None``, nothing to shard.
    - ``lsh`` (one projection for every cluster) and ``next_gid`` (a
      scalar) are ``None``, as in the JAX package.
    """

    lsh: lsh_lib.LSHParams = _f(None)  # shared by every cluster
    rescale: rescale_lib.RescaleParams = _f(0)  # leaves (c, H)
    rmi: rmi_lib.RMIParams = _f(0)  # leaves (c, H) / (c, H, W)
    sorted_keys: torch.Tensor = _f(0)  # (c, H, Lp) int64
    sorted_pos: torch.Tensor = _f(0)  # (c, H, Lp) int32
    embs: torch.Tensor = _f(0)  # (c, Lp, d) storage dtype (d//2 for int4)
    gids: torch.Tensor = _f(0)  # (c, Lp) int32
    sizes: torch.Tensor = _f(0)  # (c,) int32
    tombstones: torch.Tensor = _f(0)  # (c,) int32
    next_gid: torch.Tensor = _f(None)  # () int32, replicated
    emb_scales: torch.Tensor | None = _f(0, None)
    rescore_embs: torch.Tensor | None = _f(0, None)
    sketches: torch.Tensor | None = _f(0, None)
    store: EmbStore | None = _f(None, None)  # the host tier; None on the device tier
    code_dtype: str = _f(None, "int8")

    @property
    def n_clusters(self) -> int:
        return self.gids.shape[0]

    @property
    def capacity(self) -> int:
        return self.gids.shape[1]

    @property
    def dim(self) -> int:
        """Embedding width d, not the stored width (packed int4 holds d//2)."""
        if self.quantized and self.code_dtype == "int4":
            return self.embs.shape[-1] * 2
        return self.embs.shape[-1]

    @property
    def quantized(self) -> bool:
        return self.emb_scales is not None

    @property
    def storage_dtype(self) -> str:
        if self.quantized:
            return self.code_dtype
        return str(self.embs.dtype).removeprefix("torch.")

    @property
    def rescore_tier(self) -> str:
        """Where the float32 rescore table lives: ``device`` or ``host``."""
        return "host" if self.store is not None else "device"

    def nbytes_by_tier(self) -> dict[str, int]:
        """Index bytes by tier: ``device`` (every tensor of the bank, what
        must sit on the card to search) and ``host`` (the host store)."""
        device = sum(t.numel() * t.element_size() for t in tensor_leaves(self))
        host = self.store.nbytes if self.store is not None else 0
        return {"device": int(device), "host": int(host)}

    def float_rows(self) -> torch.Tensor:
        """(c, Lp, d) rows as the first pass scores them: dequantized codes
        for quantized storage, the stored rows otherwise."""
        if self.quantized:
            return quant.dequantize_codes(self.embs, self.emb_scales, self.code_dtype)
        return self.embs


def replicated_field_names() -> tuple[str, ...]:
    """Bank fields whose leaves are replicated (no cluster axis)."""
    return tuple(
        f.name for f in dataclasses.fields(ClusterBank) if f.metadata.get(CLUSTER_AXIS) is None
    )


def fit_sorted_array(
    sorted_keys: torch.Tensor, valid: torch.Tensor, *, n_leaves: int
) -> tuple[rescale_lib.RescaleParams, rmi_lib.RMIParams]:
    """Fit re-scale stats + RMI on sorted hashkey arrays ``(..., L)``; the
    one learned-fit primitive of core models and the bank build."""
    resc = rescale_lib.fit_rescale(sorted_keys, valid)
    scaled = rescale_lib.rescale(resc.unsqueeze(-1), sorted_keys)
    return resc, rmi_lib.fit_rmi(scaled, valid.to(torch.float32), n_leaves=n_leaves)


def refit_clusters(
    lsh: lsh_lib.LSHParams,
    row_embs: torch.Tensor,
    row_valid: torch.Tensor,
    *,
    n_leaves: int,
):
    """Hash + sort + fit a batch of clusters from their packed rows.

    ``row_embs``: (c, Lp, d); ``row_valid``: (c, Lp) bool. Returns
    ``(sorted_keys (c, H, Lp), sorted_pos (c, H, Lp), rescale (c, H),
    rmi (c, H))``.
    """
    keys = lsh_lib.hash_vectors(lsh, row_embs)  # (c, Lp, H)
    keys = lsh_lib.mask_padded(keys, row_valid[..., None]).transpose(-1, -2)
    sorted_keys, order = lsh_lib.sort_hashkeys(keys)
    sorted_pos = torch.where(sorted_keys == lsh_lib.UINT32_PAD, -1, order).to(torch.int32)
    resc, r = fit_sorted_array(sorted_keys, sorted_pos >= 0, n_leaves=n_leaves)
    return sorted_keys, sorted_pos, resc, r


def refit_cluster(lsh, row_embs, row_valid, *, n_leaves: int):
    """:func:`refit_clusters` for ONE cluster: (Lp, d), (Lp,) -> (H, Lp)..."""
    out = refit_clusters(lsh, row_embs[None], row_valid[None], n_leaves=n_leaves)
    sk, sp, resc, r = out
    return sk[0], sp[0], resc.take(0), r.take(0)


def _cat_rescale(parts):
    return rescale_lib.RescaleParams(
        *(torch.cat([getattr(p, f) for p in parts]) for f in ("key_min", "key_max", "length"))
    )


def _cat_rmi(parts):
    fields = ("root_w", "root_b", "leaf_w", "leaf_b", "length", "max_err")
    return rmi_lib.RMIParams(
        **{f: torch.cat([getattr(p, f) for p in parts]) for f in fields},
        n_leaves=parts[0].n_leaves,
    )


# Clusters fitted per batch in :func:`fit_clusters`.
_FIT_CHUNK = 64


def fit_chunks(cids: torch.Tensor):
    """Split cluster ids into batches of exactly ``_FIT_CHUNK``, the last
    padded by repeating its last id; yields ``(ids, n_real)``.

    Every fit then runs at one shape, so its float32 sums take one order
    whichever clusters share a batch: a cluster refit after an update is
    fitted bit for bit as a build fits it.
    """
    for s in range(0, cids.shape[0], _FIT_CHUNK):
        idx = cids[s : s + _FIT_CHUNK]
        n_real = idx.shape[0]
        if n_real < _FIT_CHUNK:
            idx = torch.cat([idx, idx[-1:].expand(_FIT_CHUNK - n_real)])
        yield idx, n_real


def fit_clusters(lsh, rows, row_valid, *, n_leaves, scales=None, code_dtype="int8", cids=None):
    """:func:`refit_clusters` over clusters ``cids`` (default: all) of the
    packed ``rows`` (c, Lp, d) and ``row_valid`` (c, Lp), in
    :func:`fit_chunks` batches, so the (chunk, Lp, H*M) projection is the
    largest temporary. With ``scales``, ``rows`` are codes, dequantized one
    chunk at a time (the fit reads what the first pass scores). Returns
    the four fit outputs for ``cids``, in order."""
    if cids is None:
        cids = torch.arange(rows.shape[0], device=rows.device)
    outs = []
    for idx, n_real in fit_chunks(cids):
        r = rows[idx]
        if scales is not None:
            r = quant.dequantize_codes(r, scales[idx], code_dtype)
        sk, sp, resc, rm = refit_clusters(lsh, r, row_valid[idx], n_leaves=n_leaves)
        head = torch.arange(n_real, device=sk.device)
        outs.append((sk[:n_real], sp[:n_real], resc.take(head), rm.take(head)))
    return (
        torch.cat([o[0] for o in outs]),
        torch.cat([o[1] for o in outs]),
        _cat_rescale([o[2] for o in outs]),
        _cat_rmi([o[3] for o in outs]),
    )


def gather_cluster_rows(embs: torch.Tensor, gids: torch.Tensor) -> torch.Tensor:
    """Pack corpus rows into ``(c, Lp, d)`` per-cluster slots (zero at pads)."""
    rows = embs[gids.to(torch.int64).clamp(min=0)]
    rows.mul_((gids >= 0)[..., None].to(rows.dtype))  # in place: no second copy
    return rows


def store_rows(raw_rows: torch.Tensor, storage_dtype: str):
    """Raw packed float rows -> ``(embs, emb_scales, rescore_embs, sketches)``.

    For int8 / int4 the raw rows are also kept as the float32 rescore table
    and sign-sketched; zero (padded) rows quantize to zero codes with scale
    1.0 and sketch to zero words. Every step is row-local: a build calls this
    a :func:`pack_chunks` range at a time, which bounds its temporaries.
    """
    if storage_dtype in QUANTIZED_DTYPES:
        qfn = quant.quantize_rows if storage_dtype == "int8" else quant.quantize_rows_int4
        codes, scales = qfn(raw_rows)
        return codes, scales, raw_rows, quant.sketch_rows(raw_rows)
    if storage_dtype not in _FLOAT_STORAGE:
        raise ValueError(
            f"storage_dtype must be one of {STORAGE_DTYPES}, got {storage_dtype!r}"
        )
    return raw_rows.to(_FLOAT_STORAGE[storage_dtype]), None, None, None


# Slots :func:`pack_bank` gathers, stores and sketches at a time: bounds
# the pack's temporaries (a chunk of float32 rows and the quantizer's and
# the sketch's wider copies of it) whatever the capacity.
_PACK_ROWS = 1 << 16


def pack_chunks(n_clusters: int, capacity: int) -> list[tuple[int, int]]:
    """``(start, stop)`` ranges of whole clusters, ``_PACK_ROWS`` slots
    each at most (one cluster at least)."""
    per = max(1, _PACK_ROWS // capacity)
    return [(s, min(s + per, n_clusters)) for s in range(0, n_clusters, per)]


def pack_bank(embs: torch.Tensor, gids: torch.Tensor, storage_dtype: str, rescore_tier: str = "device"):
    """Pack -> store for every cluster of ``gids`` ``(c, Lp)``, one
    :func:`pack_chunks` range at a time: :func:`store_rows` of
    :func:`gather_cluster_rows`, bit for bit (each step is row-local), with
    the rescore table a CPU tensor on the host tier.

    The outputs are allocated whole on ``gids``'s device and filled chunk by
    chunk, so a float32 table exists only where it is a leaf: the stored
    rows of a float bank, or the device tier's rescore table. The host
    tier's table is filled in host memory, a chunk at a time. ``embs`` may
    live in host memory (a CPU corpus given to a build on the card): each
    chunk's rows are then gathered there and copied to the card. On the
    card, host memory is crossed through one pinned staging buffer.
    """
    quantized = storage_dtype in QUANTIZED_DTYPES
    if not quantized and storage_dtype not in _FLOAT_STORAGE:
        raise ValueError(f"storage_dtype must be one of {STORAGE_DTYPES}, got {storage_dtype!r}")
    device = gids.device
    c, lp = gids.shape
    d = embs.shape[-1]
    chunks = pack_chunks(c, lp)
    staging = None
    if device.type == "cuda" and (embs.device != device or (quantized and rescore_tier == "host")):
        staging = pinned_buffer((chunks[0][1] - chunks[0][0]) * lp * d * 4)
    if quantized:
        width = d // 2 if storage_dtype == "int4" else d
        stored = torch.empty((c, lp, width), dtype=torch.int8, device=device)
        scales = torch.empty((c, lp), dtype=torch.float32, device=device)
        sketches = torch.empty((c, lp, quant.sketch_width(d)), dtype=torch.int32, device=device)
        rescore = torch.empty((c, lp, d), device=device if rescore_tier == "device" else "cpu")
    else:
        stored = torch.empty((c, lp, d), dtype=_FLOAT_STORAGE[storage_dtype], device=device)
        scales = rescore = sketches = None
    for s, e in chunks:
        g = gids[s:e]
        if embs.device == device:
            raw = gather_cluster_rows(embs, g)
        else:
            idx = g.reshape(-1).to(embs.device, torch.int64).clamp(min=0)
            host = embs[idx] if staging is None else torch.index_select(
                embs, 0, idx, out=staging[: idx.shape[0] * d * 4].view(torch.float32).view(-1, d))
            raw = host.view(e - s, lp, d).to(device)  # synchronous: the buffer is reused
            raw.mul_((g >= 0)[..., None].to(raw.dtype))
        st, sc, rs, sk = store_rows(raw, storage_dtype)
        stored[s:e] = st
        if quantized:
            scales[s:e], sketches[s:e] = sc, sk
            if rescore.device == device:
                rescore[s:e] = rs
            else:
                copy_through_pinned(rescore[s:e], rs, staging)
    return stored, scales, rescore, sketches


def set_rescore_tier(bank: ClusterBank, tier: str) -> ClusterBank:
    """Move the float32 rescore table between tiers.

    ``device -> host`` copies ``rescore_embs`` into an :class:`EmbStore`
    and drops the tensor from the bank (its device memory is freed once no
    index holds it); ``host -> device`` copies the store's table back to
    the device of the codes. Search results are bit-identical across the
    move: the same rows, the same kernel, the same tie-break.
    """
    if tier not in RESCORE_TIERS:
        raise ValueError(f"rescore_tier must be one of {RESCORE_TIERS}, got {tier!r}")
    if tier == bank.rescore_tier:
        return bank
    if not bank.quantized:
        raise ValueError(
            "rescore_tier='host' requires quantized (int8/int4) storage: "
            "float banks have no rescore side table to move off-device"
        )
    if tier == "host":
        store = EmbStore(bank.rescore_embs, gids=bank.gids)
        return dataclasses.replace(bank, rescore_embs=None, store=store)
    rescore = to_device(bank.store.rescore, bank.embs.device)
    return dataclasses.replace(bank, rescore_embs=rescore, store=None)


class CapacityOverflowError(ValueError):
    """A pack dropped passages because ``capacity`` < max cluster size."""

    def __init__(self, n_dropped: int, capacity: int):
        self.n_dropped = n_dropped
        self.capacity = capacity
        super().__init__(
            f"capacity={capacity} drops {n_dropped} overflow passages "
            "(they become permanently unretrievable); raise capacity or "
            "pass allow_drops=True to accept the recall loss"
        )


def build_bank(
    generator: torch.Generator,
    embs: torch.Tensor,
    assignment: torch.Tensor,
    *,
    n_clusters: int,
    capacity: int,
    n_arrays: int,
    key_len: int,
    n_leaves: int,
    allow_drops: bool = False,
    storage_dtype: str = "float32",
    rescore_tier: str = "device",
) -> tuple[ClusterBank, int]:
    """Stage-3 build: pack -> store -> hash/sort -> fit, all clusters, on
    ``assignment``'s device.

    Returns ``(bank, n_dropped)``; a lossy pack raises
    :class:`CapacityOverflowError` unless ``allow_drops=True``.

    The pack (:func:`pack_bank`) goes a chunk of clusters at a time: the
    float32 table is on the device only where it is a leaf, and
    ``rescore_tier="host"`` (quantized storage only) fills the host
    :class:`EmbStore` chunk by chunk, so that tier's build never holds the
    table on the device. ``embs`` may live in host memory, each chunk's rows
    then gathered there.
    """
    if rescore_tier not in RESCORE_TIERS:
        raise ValueError(f"rescore_tier must be one of {RESCORE_TIERS}, got {rescore_tier!r}")
    if rescore_tier == "host" and storage_dtype not in QUANTIZED_DTYPES:
        raise ValueError(
            f"rescore_tier='host' requires quantized storage ({QUANTIZED_DTYPES}): "
            "float banks have no rescore side table to move off-device"
        )
    device = assignment.device
    raw_sizes = torch.bincount(assignment.to(torch.int64), minlength=n_clusters)
    n_dropped = int(torch.clamp(raw_sizes - capacity, min=0).sum())
    if n_dropped and not allow_drops:
        raise CapacityOverflowError(n_dropped, capacity)
    gids, sizes = clustering.group_by_cluster(assignment, n_clusters, capacity)
    stored, emb_scales, rescore, sketches = pack_bank(embs, gids, storage_dtype, rescore_tier)
    lsh = lsh_lib.make_lsh(generator, embs.shape[-1], n_arrays, key_len)
    code_dtype = storage_dtype if storage_dtype in QUANTIZED_DTYPES else "int8"
    sorted_keys, sorted_pos, resc, r = fit_clusters(
        lsh, stored, gids >= 0, n_leaves=n_leaves, scales=emb_scales, code_dtype=code_dtype
    )
    host = rescore is not None and rescore.device != device
    bank = ClusterBank(
        lsh=lsh, rescale=resc, rmi=r, sorted_keys=sorted_keys,
        sorted_pos=sorted_pos, embs=stored, gids=gids, sizes=sizes,
        tombstones=torch.zeros((n_clusters,), dtype=torch.int32, device=device),
        next_gid=torch.tensor(embs.shape[0], dtype=torch.int32, device=device),
        emb_scales=emb_scales, rescore_embs=None if host else rescore, sketches=sketches,
        store=EmbStore(rescore, gids=gids) if host else None,
        code_dtype=code_dtype,
    )
    return set_rescore_tier(bank, rescore_tier), n_dropped


def grow_bank(bank: ClusterBank, new_capacity: int) -> ClusterBank:
    """Grow the per-cluster slot axis ``Lp`` to ``new_capacity``.

    Pads the sorted arrays with the sentinel key and ``sorted_pos`` -1
    (padding sorts last, so sortedness and every fit statistic are kept and
    no refit is needed), ``gids`` with -1, scales with 1.0 and codes, rescore
    rows and sketches with zeros: a grown slot is what a fresh pack pads.
    A host store grows with it, copy-on-grow (:meth:`EmbStore.grown`).
    """
    lp = bank.capacity
    if new_capacity < lp:
        raise ValueError(f"cannot shrink capacity {lp} -> {new_capacity}")
    if new_capacity == lp:
        return bank
    extra = new_capacity - lp

    def slots(t, value=0):  # pad the slot axis: the last of (c, [H,] Lp)
        return None if t is None else torch.nn.functional.pad(t, (0, extra), value=value)

    def rows(t):  # pad the slot axis of (c, Lp, w)
        return None if t is None else torch.nn.functional.pad(t, (0, 0, 0, extra))

    return dataclasses.replace(
        bank,
        store=None if bank.store is None else bank.store.grown(new_capacity),
        sorted_keys=slots(bank.sorted_keys, lsh_lib.UINT32_PAD),
        sorted_pos=slots(bank.sorted_pos, -1),
        embs=rows(bank.embs),
        gids=slots(bank.gids, -1),
        emb_scales=slots(bank.emb_scales, 1.0),
        rescore_embs=rows(bank.rescore_embs),
        sketches=rows(bank.sketches),
    )
