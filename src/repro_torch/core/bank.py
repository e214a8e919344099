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

Build: assign -> pack (capacity slots) -> store -> hash + sort + fit for all
clusters, batched over clusters (:func:`refit_clusters`) in fixed-size
chunks (:func:`fit_chunks`) that bound the temporaries and give every fit
one shape. The fit hashes the rows as the first pass scores them: the
dequantized codes of a quantized bank. :func:`grow_bank` widens the slot
axis for ``core.update``. The host rescore tier (``store``) stays
``None``: it is a later slice.
"""
from __future__ import annotations

import dataclasses

import torch

from . import clustering, lsh as lsh_lib, rescale as rescale_lib, rmi as rmi_lib
from ..kernels import quant

STORAGE_DTYPES = ("float32", "bfloat16", "int8", "int4")
QUANTIZED_DTYPES = ("int8", "int4")
_FLOAT_STORAGE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class ClusterBank:
    lsh: lsh_lib.LSHParams
    rescale: rescale_lib.RescaleParams  # leaves (c, H)
    rmi: rmi_lib.RMIParams  # leaves (c, H) / (c, H, W)
    sorted_keys: torch.Tensor  # (c, H, Lp) int64
    sorted_pos: torch.Tensor  # (c, H, Lp) int32
    embs: torch.Tensor  # (c, Lp, d) storage dtype (d//2 for int4)
    gids: torch.Tensor  # (c, Lp) int32
    sizes: torch.Tensor  # (c,) int32
    tombstones: torch.Tensor  # (c,) int32
    next_gid: torch.Tensor  # () int32
    emb_scales: torch.Tensor | None = None
    rescore_embs: torch.Tensor | None = None
    sketches: torch.Tensor | None = None
    store: object | None = None
    code_dtype: str = "int8"

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
        return "host" if self.store is not None else "device"

    def float_rows(self) -> torch.Tensor:
        """(c, Lp, d) rows as the first pass scores them: dequantized codes
        for quantized storage, the stored rows otherwise."""
        if self.quantized:
            return quant.dequantize_codes(self.embs, self.emb_scales, self.code_dtype)
        return self.embs


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


def _by_chunks(fn, x: torch.Tensor, chunk: int = _FIT_CHUNK):
    """A row-local ``fn`` over ``x`` in chunks of its leading axis, so its
    float temporaries stay a chunk in size; outputs concatenate."""
    parts = [fn(x[s : s + chunk]) for s in range(0, x.shape[0], chunk)]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(p) for p in zip(*parts))
    return torch.cat(parts)


def store_rows(raw_rows: torch.Tensor, storage_dtype: str):
    """Raw packed float rows -> ``(embs, emb_scales, rescore_embs, sketches)``.

    For int8 / int4 the raw rows are also kept as the float32 rescore table
    and sign-sketched; zero (padded) rows quantize to zero codes with scale
    1.0 and sketch to zero words.
    """
    if storage_dtype in QUANTIZED_DTYPES:
        qfn = quant.quantize_rows if storage_dtype == "int8" else quant.quantize_rows_int4
        codes, scales = _by_chunks(qfn, raw_rows)
        return codes, scales, raw_rows, _by_chunks(quant.sketch_rows, raw_rows)
    if storage_dtype not in _FLOAT_STORAGE:
        raise ValueError(
            f"storage_dtype must be one of {STORAGE_DTYPES}, got {storage_dtype!r}"
        )
    return raw_rows.to(_FLOAT_STORAGE[storage_dtype]), None, None, None


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
    """Stage-3 build: pack -> store -> hash/sort -> fit, all clusters.

    Returns ``(bank, n_dropped)``; a lossy pack raises
    :class:`CapacityOverflowError` unless ``allow_drops=True``.
    """
    if rescore_tier != "device":
        raise NotImplementedError("the host rescore tier is a later port slice")
    raw_sizes = torch.bincount(assignment.to(torch.int64), minlength=n_clusters)
    n_dropped = int(torch.clamp(raw_sizes - capacity, min=0).sum())
    if n_dropped and not allow_drops:
        raise CapacityOverflowError(n_dropped, capacity)
    gids, sizes = clustering.group_by_cluster(assignment, n_clusters, capacity)
    stored, emb_scales, rescore_embs, sketches = store_rows(
        gather_cluster_rows(embs, gids), storage_dtype
    )
    lsh = lsh_lib.make_lsh(generator, embs.shape[-1], n_arrays, key_len)
    code_dtype = storage_dtype if storage_dtype in QUANTIZED_DTYPES else "int8"
    sorted_keys, sorted_pos, resc, r = fit_clusters(
        lsh, stored, gids >= 0, n_leaves=n_leaves, scales=emb_scales, code_dtype=code_dtype
    )
    bank = ClusterBank(
        lsh=lsh, rescale=resc, rmi=r, sorted_keys=sorted_keys,
        sorted_pos=sorted_pos, embs=stored, gids=gids, sizes=sizes,
        tombstones=torch.zeros((n_clusters,), dtype=torch.int32, device=embs.device),
        next_gid=torch.tensor(embs.shape[0], dtype=torch.int32, device=embs.device),
        emb_scales=emb_scales, rescore_embs=rescore_embs, sketches=sketches,
        code_dtype=code_dtype,
    )
    return bank, n_dropped


def grow_bank(bank: ClusterBank, new_capacity: int) -> ClusterBank:
    """Grow the per-cluster slot axis ``Lp`` to ``new_capacity``.

    Pads the sorted arrays with the sentinel key and ``sorted_pos`` -1
    (padding sorts last, so sortedness and every fit statistic are kept and
    no refit is needed), ``gids`` with -1, scales with 1.0 and codes, rescore
    rows and sketches with zeros: a grown slot is what a fresh pack pads.
    """
    if bank.store is not None:
        raise NotImplementedError("the host rescore tier is a later port slice")
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
        sorted_keys=slots(bank.sorted_keys, lsh_lib.UINT32_PAD),
        sorted_pos=slots(bank.sorted_pos, -1),
        embs=rows(bank.embs),
        gids=slots(bank.gids, -1),
        emb_scales=slots(bank.emb_scales, 1.0),
        rescore_embs=rows(bank.rescore_embs),
        sketches=rows(bank.sketches),
    )
