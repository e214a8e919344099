"""LIDER index checkpoints in the JAX package's format ``lider_index_v1``.

An index directory holds one ``.npy`` per array leaf, named by its key path
(``bank__rescale__key_min``), and ``index_meta.json`` with the static fields
and a CRC32 (zlib) per leaf. :func:`load_index` verifies every leaf and, if
the index fails verification and an ``index.old`` from an interrupted swap
exists, reads that one instead. Reading never modifies the directory.

:func:`save_index` writes the same format, leaf for leaf and byte for byte
what the JAX package's ``save_index`` writes for the same index, so the JAX
package's ``load_index`` reads it: keys and key bounds go back to uint32,
sign sketches are written as the uint32 views of their int32 bit patterns.
The write is atomic: a temporary directory, then the old index renamed to
``index.old``, the new one renamed in, and ``index.old`` removed. Step
checkpoints (``save`` / ``restore``) are a later slice.

:func:`params_from_numpy` turns a ``{leaf name: array}`` map into
:class:`~repro_torch.core.lider.LiderParams` on a device: uint32 leaves
(hash keys, key bounds) become int64 so the pad sentinel sorts last, except
the sign sketches of a quantized index, which stay 32-bit words (int32 bit
patterns). int8 / int4 indexes bring ``bank__emb_scales``,
``bank__rescore_embs`` and ``bank__sketches`` (recomputed from the rescore
table when a checkpoint predates the sketch tier). Host-tier indexes are a
later slice and raise ``NotImplementedError``.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import zlib

import numpy as np
import torch

from .. import faults
from ..core.bank import QUANTIZED_DTYPES, ClusterBank
from ..core.core_model import CoreModelParams
from ..core.lider import LiderParams
from ..core.lsh import LSHParams
from ..core.rescale import RescaleParams
from ..core.rmi import RMIParams
from ..device import resolve_device
from ..kernels import quant

INDEX_DIRNAME = "index"
INDEX_META = "index_meta.json"
INDEX_FORMAT = "lider_index_v1"


class CheckpointCorruptError(Exception):
    """A checkpoint leaf failed integrity verification."""

    def __init__(self, leaf: str, path: str, reason: str = "crc32 mismatch"):
        super().__init__(f"corrupt checkpoint leaf {leaf!r} at {path}: {reason}")
        self.leaf = leaf
        self.path = path
        self.reason = reason


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


# Leaked temporary directories of an interrupted save (a crash between
# mkdtemp and the rename), swept when a save starts.
_TMP_PREFIXES = (".tmp_ckpt_", ".tmp_index_")
# Leaves that hold uint32 keys in the format and int64 in the port.
_KEY_LEAVES = ("sorted_keys", "key_min", "key_max")


def sweep_orphan_tmp(directory: str) -> int:
    """Remove leaked ``.tmp_ckpt_*`` / ``.tmp_index_*`` directories; returns
    the number removed."""
    if not os.path.isdir(directory):
        return 0
    removed = 0
    for name in os.listdir(directory):
        p = os.path.join(directory, name)
        if name.startswith(_TMP_PREFIXES) and os.path.isdir(p):
            shutil.rmtree(p, ignore_errors=True)
            removed += 1
    return removed


def _apply_write_fault(tmp: str, leaf_names: list[str]):
    """The ``checkpoint_write`` fault site: ``truncate`` / ``torn_write``
    cut one leaf file in the temporary directory to half (payload ``{"leaf":
    name}``, default the last leaf) before the rename, a torn write that
    survives it. Returns the fired spec, if any."""
    spec = faults.fire(faults.CHECKPOINT_WRITE)
    if spec is not None and spec.mode in ("truncate", "torn_write"):
        leaf = (spec.payload or {}).get("leaf") or leaf_names[-1]
        p = os.path.join(tmp, leaf + ".npy")
        size = os.path.getsize(p)
        with open(p, "r+b") as f:
            f.truncate(max(size // 2, 1))
    return spec


def _leaf_array(name: str, t: torch.Tensor) -> tuple[np.ndarray, str | None]:
    """A leaf as the format stores it: ``(array, descr)``, where ``descr``
    overrides the header's type for bfloat16 (``'<V2'``, what numpy writes
    for the JAX package's bfloat16 arrays) and is None otherwise."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "<V2"
    arr = t.numpy()
    if name.split("__")[-1] in _KEY_LEAVES:
        if arr.size and (arr.min() < 0 or arr.max() > 0xFFFFFFFF):
            raise ValueError(f"leaf {name} holds keys outside uint32")
        return arr.astype(np.uint32), None
    if name == "bank__sketches":
        return arr.view(np.uint32), None
    return arr, None


def index_leaves(params: LiderParams):
    """``(name, tensor)`` for every array leaf, in the order (and with the
    names) of the JAX package's tree flattening of its ``LiderParams``."""

    def rescale(prefix, p):
        return [(f"{prefix}__rescale__{f}", getattr(p, f)) for f in ("key_min", "key_max", "length")]

    def rmi(prefix, p):
        return [(f"{prefix}__rmi__{f}", getattr(p, f))
                for f in ("root_w", "root_b", "leaf_w", "leaf_b", "length", "max_err")]

    cm, b = params.centroid_cm, params.bank
    out = [("centroid_cm__lsh__projections", cm.lsh.projections)]
    out += rescale("centroid_cm", cm.rescale) + rmi("centroid_cm", cm.rmi)
    out += [("centroid_cm__sorted_keys", cm.sorted_keys), ("centroid_cm__sorted_ids", cm.sorted_ids),
            ("centroids", params.centroids), ("bank__lsh__projections", b.lsh.projections)]
    out += rescale("bank", b.rescale) + rmi("bank", b.rmi)
    for f in ("sorted_keys", "sorted_pos", "embs", "gids", "sizes", "tombstones", "next_gid",
              "emb_scales", "rescore_embs", "sketches"):
        if getattr(b, f) is not None:
            out.append((f"bank__{f}", getattr(b, f)))
    return out


def _write_leaf(path: str, arr: np.ndarray, descr: str | None) -> None:
    if descr is None:
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": descr, "fortran_order": False, "shape": arr.shape}
        )
        f.write(np.ascontiguousarray(arr).tobytes())


def save_index(directory: str, params: LiderParams) -> str:
    """Atomically write ``params`` under ``directory/index``; returns that
    path.

    An existing index is renamed aside (``index.old``) before the new one
    is renamed in, so no crash leaves zero copies on disk: at worst the new
    index and a recoverable ``index.old``, which :func:`load_index` falls
    back to when the new one fails verification. The ``checkpoint_write``
    fault site fires before the swap (``truncate``, ``torn_write``; the
    latter then raises ``faults.InjectedFault`` inside the swap window).
    """
    if params.bank.store is not None:
        raise NotImplementedError("host-tier indexes are a later port slice")
    os.makedirs(directory, exist_ok=True)
    sweep_orphan_tmp(directory)
    final = os.path.join(directory, INDEX_DIRNAME)
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_index_")
    crcs: dict[str, int] = {}
    for name, t in index_leaves(params):
        arr, descr = _leaf_array(name, t)
        _write_leaf(os.path.join(tmp, name + ".npy"), arr, descr)
        crcs[name] = _crc(arr)
    b, cm = params.bank, params.centroid_cm
    meta = {
        "leaves": crcs,
        "format": INDEX_FORMAT,
        "storage_dtype": b.storage_dtype,
        "rescore_tier": b.rescore_tier,
        "in_lsh": {"n_arrays": b.lsh.n_arrays, "key_len": b.lsh.key_len},
        "in_rmi_n_leaves": b.rmi.n_leaves,
        "centroid_lsh": {"n_arrays": cm.lsh.n_arrays, "key_len": cm.lsh.key_len},
        "centroid_rmi_n_leaves": cm.rmi.n_leaves,
    }
    with open(os.path.join(tmp, INDEX_META), "w") as f:
        json.dump(meta, f)
    spec = _apply_write_fault(tmp, sorted(crcs))
    old = final + ".old"
    if os.path.exists(final):
        if os.path.exists(old):
            shutil.rmtree(old)
        os.rename(final, old)
    os.rename(tmp, final)
    if spec is not None and spec.mode == "torn_write":
        # A crash inside the swap window: the torn new index is in place and
        # index.old survives, the state load_index recovers from.
        raise faults.InjectedFault(faults.CHECKPOINT_WRITE, "torn write: crashed in index.old swap")
    if os.path.exists(old):
        shutil.rmtree(old)
    return final


def _checked_load(d: str, name: str, crc: int | None) -> np.ndarray:
    p = os.path.join(d, name + ".npy")
    try:
        arr = np.load(p)
    except (OSError, ValueError, EOFError) as e:
        if isinstance(e, FileNotFoundError):
            raise
        raise CheckpointCorruptError(name, p, f"unreadable: {e}") from e
    if crc is not None and _crc(arr) != crc:
        raise CheckpointCorruptError(name, p)
    return arr


def read_index_dir(d: str) -> tuple[dict[str, np.ndarray], dict]:
    """Every leaf of one index directory (CRC-verified) plus its meta."""
    with open(os.path.join(d, INDEX_META)) as f:
        meta = json.load(f)
    if meta.get("format") != INDEX_FORMAT:
        raise ValueError(f"not a lider index checkpoint: {d}")
    crcs = meta.get("leaves", {})  # absent on pre-CRC indexes
    names = sorted(
        f[: -len(".npy")] for f in os.listdir(d) if f.endswith(".npy")
    )
    missing = set(crcs) - set(names)
    if missing:
        raise FileNotFoundError(f"index {d} lacks leaves {sorted(missing)}")
    return {n: _checked_load(d, n, crcs.get(n)) for n in names}, meta


def params_from_numpy(
    leaves: dict[str, np.ndarray], meta: dict, device: str | torch.device
) -> LiderParams:
    """Assemble ``LiderParams`` on ``device`` from named numpy leaves."""
    storage = meta.get("storage_dtype", "float32")
    quantized = storage in QUANTIZED_DTYPES
    if meta.get("rescore_tier", "device") != "device":
        raise NotImplementedError("host-tier indexes are a later port slice")

    def leaf(*path: str) -> torch.Tensor:
        arr = leaves["__".join(path)]
        if arr.dtype == np.uint32:
            arr = arr.astype(np.int64)
        if arr.dtype.kind == "V" or str(arr.dtype) == "bfloat16":
            # ml_dtypes bfloat16 arrays: reinterpret the 16-bit payload.
            t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16))
            return t.view(torch.bfloat16).to(device)
        if not arr.flags.c_contiguous:  # (np.ascontiguousarray would make a 0-d leaf 1-d)
            arr = np.ascontiguousarray(arr)
        return torch.from_numpy(arr).to(device)

    def rescale_of(prefix) -> RescaleParams:
        return RescaleParams(
            key_min=leaf(*prefix, "key_min"),
            key_max=leaf(*prefix, "key_max"),
            length=leaf(*prefix, "length"),
        )

    def rmi_of(prefix, n_leaves: int) -> RMIParams:
        return RMIParams(
            root_w=leaf(*prefix, "root_w"),
            root_b=leaf(*prefix, "root_b"),
            leaf_w=leaf(*prefix, "leaf_w"),
            leaf_b=leaf(*prefix, "leaf_b"),
            length=leaf(*prefix, "length"),
            max_err=leaf(*prefix, "max_err"),
            n_leaves=n_leaves,
        )

    def lsh_of(prefix, cfg) -> LSHParams:
        return LSHParams(
            projections=leaf(*prefix, "projections"),
            n_arrays=cfg["n_arrays"],
            key_len=cfg["key_len"],
        )

    centroid_cm = CoreModelParams(
        lsh=lsh_of(("centroid_cm", "lsh"), meta["centroid_lsh"]),
        rescale=rescale_of(("centroid_cm", "rescale")),
        rmi=rmi_of(("centroid_cm", "rmi"), meta["centroid_rmi_n_leaves"]),
        sorted_keys=leaf("centroid_cm", "sorted_keys"),
        sorted_ids=leaf("centroid_cm", "sorted_ids"),
    )
    emb_scales = rescore = sketches = None
    if quantized:
        emb_scales = leaf("bank", "emb_scales")
        rescore = leaf("bank", "rescore_embs")
        if "bank__sketches" in leaves:
            # uint32 words kept as int32 bit patterns (not widened to int64).
            sk = np.ascontiguousarray(leaves["bank__sketches"]).view(np.int32)
            sketches = torch.from_numpy(sk).to(device)
        else:
            # A checkpoint from before the sketch tier: the sketches are a
            # function of the raw rows, which the rescore table holds, so
            # recomputing them is byte-exact.
            sketches = quant.sketch_rows(rescore)
    bank = ClusterBank(
        lsh=lsh_of(("bank", "lsh"), meta["in_lsh"]),
        rescale=rescale_of(("bank", "rescale")),
        rmi=rmi_of(("bank", "rmi"), meta["in_rmi_n_leaves"]),
        sorted_keys=leaf("bank", "sorted_keys"),
        sorted_pos=leaf("bank", "sorted_pos"),
        embs=leaf("bank", "embs"),
        gids=leaf("bank", "gids"),
        sizes=leaf("bank", "sizes"),
        tombstones=leaf("bank", "tombstones"),
        next_gid=leaf("bank", "next_gid"),
        emb_scales=emb_scales,
        rescore_embs=rescore,
        sketches=sketches,
        code_dtype=storage if quantized else "int8",
    )
    return LiderParams(centroid_cm=centroid_cm, centroids=leaf("centroids"), bank=bank)


def load_index(
    directory: str, *, device: str | torch.device | None = None
) -> LiderParams:
    """Load an index saved by the JAX package's ``save_index`` onto
    ``device`` (``None`` = the CUDA device; raises without one).

    ``directory`` is the save root (holding ``index/``) or the index
    directory itself. A leaf that fails its CRC32 raises
    :class:`CheckpointCorruptError`, unless ``index.old`` exists and
    verifies, in which case that one is loaded.
    """
    device = resolve_device(device)
    d = os.path.join(directory, INDEX_DIRNAME)
    if not os.path.isdir(d):
        d = directory
    try:
        leaves, meta = read_index_dir(d)
    except (CheckpointCorruptError, FileNotFoundError):
        old = d + ".old"
        if not os.path.isdir(old):
            raise
        leaves, meta = read_index_dir(old)
    return params_from_numpy(leaves, meta, device)
