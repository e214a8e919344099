"""ESK-LSH: extended SortingKeys-LSH for cosine similarity (paper Sec. 4).

A hashkey is ``M`` sign bits of random hyperplane projections packed
big-endian, so numeric order of the packed key is the SK-LSH linear order.
The JAX package holds keys as uint32; here they are int64, so the pad
sentinel ``0xFFFFFFFF`` still sorts after every real key (as int32 it
would sort first). Hash bits are signs of a float32 product: values next
to 0 can flip between two summation orders, which the tests measure.
:func:`hash_vectors` runs through ``kernels.ops.lsh_hash_op``: the
``lsh_hash`` CUDA kernel on the card, its plain version on the CPU.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..kernels.ops import lsh_hash_op

UINT32_PAD = 0xFFFFFFFF
MAX_KEY_LEN = 31
_MASK32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class LSHParams:
    """Bank of ``n_arrays`` compound hash functions of ``key_len`` bits each."""

    projections: torch.Tensor  # (dim, n_arrays * key_len) float32
    n_arrays: int
    key_len: int


def make_lsh(
    generator: torch.Generator, dim: int, n_arrays: int, key_len: int
) -> LSHParams:
    if not (1 <= key_len <= MAX_KEY_LEN):
        raise ValueError(f"key_len must be in [1, {MAX_KEY_LEN}], got {key_len}")
    proj = torch.randn(
        (dim, n_arrays * key_len), generator=generator,
        device=generator.device, dtype=torch.float32,
    )
    return LSHParams(projections=proj, n_arrays=n_arrays, key_len=key_len)


def suggest_key_len(n_points: int) -> int:
    """Paper setting ``M = ceil(log2 N)``, clamped to the packable range."""
    return max(4, min(MAX_KEY_LEN, math.ceil(math.log2(max(2, n_points)))))


def hash_vectors(params: LSHParams, x: torch.Tensor) -> torch.Tensor:
    """Hash (..., dim) vectors into (..., H) packed int64 hashkeys (one
    ``lsh_hash_op`` call over the rows flattened to (n, dim))."""
    keys = lsh_hash_op(
        x.reshape(-1, x.shape[-1]), params.projections,
        n_arrays=params.n_arrays, key_len=params.key_len,
    )
    return keys.reshape(*x.shape[:-1], params.n_arrays)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack (..., M) {0,1} bits big-endian into (...,) int64 keys."""
    m = bits.shape[-1]
    weights = torch.pow(2, torch.arange(m - 1, -1, -1, device=bits.device, dtype=torch.int64))
    return torch.sum(bits.to(torch.int64) * weights, dim=-1)


def unpack_bits(keys: torch.Tensor, key_len: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: (...,) keys -> (..., M) int64 bits."""
    shifts = torch.arange(key_len - 1, -1, -1, device=keys.device, dtype=torch.int64)
    return (keys.to(torch.int64)[..., None] >> shifts) & 1


def _shl32(x: torch.Tensor, n) -> torch.Tensor:
    """``x << n`` wrapped to 32 bits, as on uint32 (the keys are int64)."""
    return (x << n) & _MASK32


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of int64 values in [0, 2**32): exact for every such input
    (the last product stays below 2**53)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _MASK32) >> 24


def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of 32-bit values held in int64 (smear, then popcount)."""
    x = x.to(torch.int64) & _MASK32
    for s in (1, 2, 4, 8, 16):
        x = x | (x >> s)
    return 32 - _popcount32(x)


def common_prefix_len(k1: torch.Tensor, k2: torch.Tensor, key_len: int) -> torch.Tensor:
    """Length of the common bit prefix of two compact keys (0..key_len), int32."""
    a1 = _shl32(k1.to(torch.int64), 32 - key_len)
    a2 = _shl32(k2.to(torch.int64), 32 - key_len)
    return torch.clamp(_clz32(a1 ^ a2), max=key_len).to(torch.int32)


def dist_e(
    k1: torch.Tensor, k2: torch.Tensor, key_len: int, window_bits: int = 8
) -> torch.Tensor:
    """Extended hashkey distance (paper Eq. 7), broadcasting elementwise:
    ``KL + KD_e / 2**B``, ``KD_e`` read from the ``B``-bit window right
    after the common prefix (zero-padded past the key end). float32."""
    b = int(window_bits)
    m = int(key_len)
    l = common_prefix_len(k1, k2, m).to(torch.int64)
    kl = (m - l).to(torch.float32)
    a1 = _shl32(k1.to(torch.int64), 32 - m)
    a2 = _shl32(k2.to(torch.int64), 32 - m)
    shift = torch.clamp(l, max=31)
    s1 = _shl32(a1, shift) >> (32 - b)
    s2 = _shl32(a2, shift) >> (32 - b)
    kd = torch.where(l >= m, 0, torch.abs(s1 - s2)).to(torch.float32)
    return kl + kd / float(2**b)


def mask_padded(keys: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Replace keys of padded/dead slots with the sentinel, which sorts last."""
    return torch.where(valid, keys, UINT32_PAD)


def sort_hashkeys(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort along the last axis; stable, like ``jnp.argsort``, so equal keys
    keep their slot order. Returns ``(sorted_keys, order)``."""
    return torch.sort(keys, dim=-1, stable=True)


def query_position(sorted_keys: torch.Tensor, qkey: torch.Tensor) -> torch.Tensor:
    """Insertion position (side='left') of ``qkey`` in each sorted row."""
    return torch.searchsorted(sorted_keys, qkey, side="left")
