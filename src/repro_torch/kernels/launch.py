"""What every kernel wrapper shares: binding a symbol of a built library
with ``ctypes``, checking a tensor argument, refusing CPU tensors, and
launching on the current stream with the launch's error raised."""
from __future__ import annotations

import ctypes

import torch

from . import build

P = ctypes.c_void_p
I = ctypes.c_int
LL = ctypes.c_longlong


def bind(library: str, symbol: str, argtypes, restype=ctypes.c_int):
    fn = getattr(build.load_library(library), symbol)
    fn.argtypes = argtypes
    fn.restype = restype
    return fn


def check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def on_cuda(name: str, t: torch.Tensor, plain: str) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(
            f"{name} runs on CUDA tensors, got {t.device}; the plain version is "
            f"ref.{plain}"
        )
    return t.device


def launch(name: str, fn, *args, device) -> None:
    """Call a C entry point with the current stream as its last argument;
    it returns the ``cudaError_t`` of the launch, raised here if not 0."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
