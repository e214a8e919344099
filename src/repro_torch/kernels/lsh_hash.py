"""The CUDA hashing kernel (``csrc/lsh_hash.cu``) and its wrapper.

Replaces ``repro/kernels/lsh_hash.py::lsh_hash``: ``(N, d)`` rows times the
``(d, H*M)`` projections in float32, the sign bits, M per array packed
big-endian into ``(N, H)`` keys, without writing the projection. The
product runs on the tensor cores in split TF32 (three TF32 products per
float32 product, within float32 rounding), one launch a call: each block
splits its stage's slice of the projections itself. The source says what
bounds it and how its design answers that. A row's keys depend only on the
row and the projections (a fixed order over d), so an upserted row hashes as
a rebuild hashes it.

The wrapper validates, allocates and launches on the current stream; it
never runs on CPU tensors (``ops`` sends those to ``ref.lsh_hash_ref``)
and raises when the launch fails. ``lsh_hash.launches`` counts launches,
``LAUNCHES_PER_CALL`` a call.
"""
from __future__ import annotations

import torch

from .launch import I, LL, P, bind, check, count, launch, on_cuda, tma_rows

MAX_KEY_LEN = 31  # keys stay non-negative in the kernel's int32 output
LAUNCHES_PER_CALL = 1


def lsh_hash(x: torch.Tensor, proj: torch.Tensor, *, n_arrays: int, key_len: int) -> torch.Tensor:
    """(N, d) float32 or bfloat16 rows, (d, H*M) float32 projections ->
    (N, H) int64 keys (the kernel writes int32; every key is below 2**31)."""
    device = on_cuda("lsh_hash", x, "lsh_hash_ref")
    if not 1 <= key_len <= MAX_KEY_LEN:
        raise ValueError(f"key_len must be in [1, {MAX_KEY_LEN}], got {key_len}")
    if n_arrays < 1:
        raise ValueError(f"n_arrays must be >= 1, got {n_arrays}")
    if x.dim() != 2 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be (N, d) float32 or bfloat16, got {tuple(x.shape)} {x.dtype}")
    n, d = x.shape
    check("x", x, x.dtype, (n, d), device)
    check("proj", proj, torch.float32, (d, n_arrays * key_len), device)
    keys = torch.empty((n, n_arrays), dtype=torch.int32, device=device)
    if n == 0:
        return keys.to(torch.int64)
    # The kernel's tensor maps read 16-byte aligned rows.
    x, ld = tma_rows(x)
    proj, ld_p = tma_rows(proj)
    fn = bind("lsh_hash", "lsh_hash_launch", [P, I, LL, I, LL, P, LL, I, I, P, P])
    launch(
        "lsh_hash", fn, x.data_ptr(), int(x.dtype == torch.bfloat16), n, d, ld,
        proj.data_ptr(), ld_p, n_arrays, key_len, keys.data_ptr(), device=device,
    )
    count(lsh_hash, LAUNCHES_PER_CALL)
    return keys.to(torch.int64)


lsh_hash.launches = 0
