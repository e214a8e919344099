"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles, on first
use, into ``build/kernels/lib<name>-<hash>.so`` under the repository root
(listed in ``.gitignore``). The hash is of the source text and of the
shared headers (``csrc/*.cuh``), so an edited source or header builds anew
and a stale library is never loaded. :func:`build_all` starts one ``nvcc``
per source at once. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
)

_loaded: dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()  # a router's threads may ask for a library at once


def sources() -> list[str]:
    """Names of every kernel source under ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start ``nvcc`` on ``csrc/<name>.cu`` into a temporary file, unless
    the library is built; returns ``(out, tmp, process)`` or None."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=f".{name}-", suffix=".so")
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return out, tmp, proc


def _finish(name: str, job) -> None:
    """Wait for one build; the library is renamed into place, so concurrent
    builds never load a half-written file."""
    out, tmp, proc = job
    try:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{err}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    job = _start(name)
    if job is not None:
        _finish(name, job)
    return library_path(name)


def build_all(names: list[str] | None = None) -> dict[str, Path]:
    """Compile every source (or ``names``), one ``nvcc`` each, all at once."""
    names = sources() if names is None else names
    jobs = {n: _start(n) for n in names}
    errors = []
    for n, job in jobs.items():
        if job is None:
            continue
        try:
            _finish(n, job)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return {n: library_path(n) for n in names}


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and ``dlopen`` the kernel library ``name``."""
    lib = _loaded.get(name)
    if lib is None:
        with _load_lock:
            lib = _loaded.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(build(name)))
                _loaded[name] = lib
    return lib


def load_all() -> None:
    """Build every source at once, then load every library: what a
    multi-threaded caller runs first, so no thread builds or loads."""
    build_all()
    for name in sources():
        load_library(name)
