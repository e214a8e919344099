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
``index.old``, the new one renamed in, and ``index.old`` removed.

:func:`params_from_numpy` turns a ``{leaf name: array}`` map into
:class:`~repro_torch.core.lider.LiderParams` on a device: uint32 leaves
(hash keys, key bounds) become int64 so the pad sentinel sorts last, except
the sign sketches of a quantized index, which stay 32-bit words (int32 bit
patterns). int8 / int4 indexes bring ``bank__emb_scales``,
``bank__rescore_embs`` and ``bank__sketches`` (recomputed from the rescore
table when a checkpoint predates the sketch tier).

The format does not depend on the rescore tier: a host-tier index saves its
host table under the same leaf name, ``bank__rescore_embs``, so a save of
either tier loads as either tier (``load_index(rescore_tier=...)``; the
default is the tier it was saved from), in both packages.

Step checkpoints (:func:`save`, :func:`restore`, :class:`CheckpointManager`)
write the JAX package's files too: ``<dir>/step_%08d/`` holding one
``NNNN__<key path>.npy`` per leaf, in the JAX package's flattening order
(dict keys sorted), and a ``manifest.json`` with each leaf's shape, dtype
and CRC32. A step saved by either package restores in the other. A tree is
nested dicts, lists and tuples of tensors, numpy arrays and scalars;
:class:`~repro_torch.core.types.Stacked` leaves (the transformer's layers)
are written as one stacked array. :func:`restore` fills the tensors of its
``like`` tree in place, after every leaf has passed its CRC.

Under an ambient grid (``launch.mesh.use_grid``; the tensors of a sharded
model and its optimizer state carry their specs, ``models.sharding``) every
rank calls these: :func:`save` all-gathers every sharded leaf and rank 0
writes the full leaves once, the same files as a single-device save;
:func:`restore` fills each rank's blocks from the full leaves under the
specs of its ``like``, so a step saved on one grid resumes on another (the
counterpart of the JAX package's ``restore(..., shardings)``).
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
from ..core.bank import QUANTIZED_DTYPES, RESCORE_TIERS, ClusterBank, EmbStore
from ..core.core_model import CoreModelParams
from ..core.lider import LiderParams
from ..core.lsh import LSHParams
from ..core.rescale import RescaleParams
from ..core.rmi import RMIParams
from ..core.types import (
    Stacked,
    numpy_to_tensor,
    tensor_to_numpy,
    tree_flatten_with_path,
    tree_unflatten,
)
from ..device import resolve_device
from ..kernels import quant
from ..launch.mesh import current_grid
from ..models import sharding

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
    names) of the JAX package's tree flattening of its ``LiderParams``; a
    host-tier index's host table comes last, as ``bank__rescore_embs``,
    where the JAX package's ``save_index`` writes it."""

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
    if b.store is not None:
        out.append(("bank__rescore_embs", b.store.rescore))
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
    leaves: dict[str, np.ndarray],
    meta: dict,
    device: str | torch.device,
    rescore_tier: str | None = None,
) -> LiderParams:
    """Assemble ``LiderParams`` on ``device`` from named numpy leaves, the
    rescore table on ``rescore_tier`` (default: the meta's)."""
    storage = meta.get("storage_dtype", "float32")
    quantized = storage in QUANTIZED_DTYPES
    tier = rescore_tier or meta.get("rescore_tier", "device")
    if tier not in RESCORE_TIERS:
        raise ValueError(f"rescore_tier must be one of {RESCORE_TIERS}, got {tier!r}")
    if tier == "host" and not quantized:
        raise ValueError(
            "rescore_tier='host' requires a quantized (int8/int4) index "
            "(float banks have no rescore table)"
        )

    def leaf(*path: str) -> torch.Tensor:
        arr = leaves["__".join(path)]
        if arr.dtype == np.uint32:
            arr = arr.astype(np.int64)
        return numpy_to_tensor(arr).to(device)

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
    emb_scales = rescore = sketches = store = None
    if quantized:
        emb_scales = leaf("bank", "emb_scales")
        if tier == "host":
            store = EmbStore(leaves["bank__rescore_embs"], gids=leaves["bank__gids"])
        else:
            rescore = leaf("bank", "rescore_embs")
        if "bank__sketches" in leaves:
            # uint32 words kept as int32 bit patterns (not widened to int64).
            sk = np.ascontiguousarray(leaves["bank__sketches"]).view(np.int32)
            sketches = torch.from_numpy(sk).to(device)
        else:
            # A checkpoint from before the sketch tier: the sketches are a
            # function of the raw rows, which the rescore table holds, so
            # recomputing them is byte-exact.
            raw = rescore if store is None else store.rescore
            sketches = quant.sketch_rows(raw).to(device)
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
        store=store,
        code_dtype=storage if quantized else "int8",
    )
    return LiderParams(centroid_cm=centroid_cm, centroids=leaf("centroids"), bank=bank)


def load_index(
    directory: str,
    *,
    device: str | torch.device | None = None,
    rescore_tier: str | None = None,
) -> LiderParams:
    """Load an index saved by the JAX package's ``save_index`` (or this
    one's) onto ``device`` (``None`` = the CUDA device; raises without one).

    ``rescore_tier`` puts the rescore table of a quantized index on the
    ``device`` or the ``host`` tier; by default on the tier it was saved
    from. A float index has no host tier (``ValueError``).

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
    return params_from_numpy(leaves, meta, device, rescore_tier)


# ---------------------------------------------------------------------------
# Step checkpoints (training state)
# ---------------------------------------------------------------------------


def _leaf_name(path) -> str:
    return "__".join(str(p) for p in path) or "leaf"


def _step_array(leaf) -> np.ndarray:
    """A tree leaf as the array that is written (bfloat16 as ``'V2'``)."""
    if isinstance(leaf, Stacked):
        return np.stack([tensor_to_numpy(t) for t in leaf.parts])
    if isinstance(leaf, torch.Tensor):
        return tensor_to_numpy(leaf)
    return np.asarray(leaf)


def _gathered(tree, grid):
    """``tree`` with every sharded tensor (or ``Stacked`` part) replaced by
    its full tensor; a collective, in flattening order."""
    full = lambda t: sharding.unshard(t, sharding.spec_of(t), grid) if sharding.spec_of(t) else t
    leaves = []
    for _, leaf in tree_flatten_with_path(tree):
        if isinstance(leaf, Stacked):
            leaf = Stacked([full(t) for t in leaf.parts])
        elif isinstance(leaf, torch.Tensor):
            leaf = full(leaf)
        leaves.append(leaf)
    return tree_unflatten(tree, leaves)


def _once(fn, *args) -> None:
    """``fn(*args)`` once: here, or under an ambient grid on rank 0 while
    every rank waits for it."""
    grid = current_grid()
    if grid is None or grid.rank == 0:
        fn(*args)
    if grid is not None:
        grid.barrier()


def save(directory: str, step: int, tree) -> str:
    """Atomically write ``tree`` under ``directory/step_<step>``: a
    temporary directory renamed into place, so a crash never leaves a
    partial step behind (the ``checkpoint_write`` fault site fires before
    the rename). Under an ambient grid every rank calls it: the sharded
    leaves are gathered, rank 0 writes, and every rank returns once the
    step is in place."""
    grid = current_grid()
    if grid is not None:
        tree = _gathered(tree, grid)
    _once(_write_step, directory, step, tree)
    return os.path.join(directory, f"step_{step:08d}")


def _write_step(directory: str, step: int, tree) -> str:
    final = os.path.join(directory, f"step_{step:08d}")
    os.makedirs(directory, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    manifest = {"step": step, "leaves": []}
    for i, (path, leaf) in enumerate(tree_flatten_with_path(tree)):
        name = f"{i:04d}__{_leaf_name(path)}"
        arr = _step_array(leaf)
        bf16 = arr.dtype.kind == "V"
        _write_leaf(os.path.join(tmp, name + ".npy"),
                    arr.view(np.int16) if bf16 else arr, "<V2" if bf16 else None)
        manifest["leaves"].append({
            "name": name,
            "shape": list(arr.shape),
            "dtype": "bfloat16" if bf16 else str(arr.dtype),
            "crc32": _crc(arr),
        })
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    _apply_write_fault(tmp, [m["name"] for m in manifest["leaves"]])
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _step_dirs(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(
        int(d.split("_")[1])
        for d in os.listdir(directory)
        if d.startswith("step_") and os.path.isdir(os.path.join(directory, d))
    )


def latest_step(directory: str) -> int | None:
    steps = _step_dirs(directory)
    return steps[-1] if steps else None


@torch.no_grad()
def restore(directory: str, step: int, like):
    """Load ``step`` into the structure of ``like``.

    Every leaf is read and CRC32-verified first (checkpoints written before
    CRCs existed skip the check; a mismatch raises
    :class:`CheckpointCorruptError` naming the leaf). Then a tensor or
    ``Stacked`` leaf of ``like`` is filled in place (its shape and dtype
    must match) and returned; any other leaf comes back as the numpy
    array. Under an ambient grid, a sharded tensor of ``like`` takes the
    rank's block of the full leaf under its own spec."""
    grid = current_grid()
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    leaves_like = [leaf for _, leaf in tree_flatten_with_path(like)]
    if len(leaves_like) != len(manifest["leaves"]):
        raise ValueError(f"checkpoint has {len(manifest['leaves'])} leaves, target structure "
                         f"has {len(leaves_like)}")
    arrays = [_checked_load(d, m["name"], m.get("crc32")) for m in manifest["leaves"]]
    out = []
    for meta, arr, leaf in zip(manifest["leaves"], arrays, leaves_like):
        if not isinstance(leaf, (torch.Tensor, Stacked)):
            out.append(arr)
            continue
        t = numpy_to_tensor(arr)
        if grid is not None:
            block = lambda full, target: (sharding.shard(full, sharding.spec_of(target), grid)
                                          if sharding.spec_of(target) else full)
            t = (torch.stack([block(t[i], p) for i, p in enumerate(leaf.parts)])
                 if isinstance(leaf, Stacked) and len(t) == len(leaf.parts) else block(t, leaf))
        if tuple(t.shape) != tuple(leaf.shape) or t.dtype != leaf.dtype:
            raise ValueError(f"leaf {meta['name']}: checkpoint holds {tuple(t.shape)} {t.dtype}, "
                             f"the target {tuple(leaf.shape)} {leaf.dtype}")
        if isinstance(leaf, Stacked):
            for i, part in enumerate(leaf.parts):
                part.copy_(t[i])
        else:
            leaf.copy_(t)
        out.append(leaf)
    return tree_unflatten(like, out)


class CheckpointManager:
    """Keep-last-N manager with preemption-safe atomic saves.

    Construction sweeps orphaned tmp dirs (a crash between mkdtemp and
    rename would otherwise leak them); ``restore_latest`` verifies
    integrity and falls back to the newest step that passes. Under an
    ambient grid every rank builds it and calls it alike; rank 0 alone
    sweeps, writes and drops old steps."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        _once(sweep_orphan_tmp, directory)

    def save(self, step: int, tree) -> str:
        path = save(self.directory, step, tree)
        _once(self._gc)
        return path

    def latest_step(self) -> int | None:
        return latest_step(self.directory)

    def restore_latest(self, like):
        """Restore the newest *verified* step -> ``(step, tree)``, or
        ``(None, None)`` when there is none.

        A step whose manifest or leaves fail verification (torn write, CRC
        mismatch) is skipped and the next-newest is tried; if every step is
        corrupt the newest step's error propagates."""
        last_err = None
        for step in reversed(_step_dirs(self.directory)):
            try:
                return step, restore(self.directory, step, like)
            except (CheckpointCorruptError, OSError, json.JSONDecodeError) as e:
                if last_err is None:
                    last_err = e
        if last_err is not None:
            raise last_err
        return None, None

    def _gc(self):
        for s in _step_dirs(self.directory)[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"))
