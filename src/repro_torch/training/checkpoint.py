"""Read LIDER indexes saved by the JAX package (format ``lider_index_v1``).

An index directory holds one ``.npy`` per array leaf, named by its key path
(``bank__rescale__key_min``), and ``index_meta.json`` with the static fields
and a CRC32 (zlib) per leaf. :func:`load_index` verifies every leaf and, if
the index fails verification and an ``index.old`` from an interrupted swap
exists, reads that one instead. Reading never modifies the directory.

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
import zlib

import numpy as np
import torch

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
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device)

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
