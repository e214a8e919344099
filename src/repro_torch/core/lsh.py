"""ESK-LSH: extended SortingKeys-LSH for cosine similarity (paper Sec. 4).

A hashkey is ``M`` sign bits of random hyperplane projections packed
big-endian, so numeric order of the packed key is the SK-LSH linear order.
The JAX package holds keys as uint32; here they are int64, so the pad
sentinel ``0xFFFFFFFF`` still sorts after every real key (as int32 it
would sort first). Hash bits are signs of a float32 product: values next
to 0 can flip between two BLAS libraries, which the tests measure.
"""
from __future__ import annotations

import dataclasses
import math

import torch

UINT32_PAD = 0xFFFFFFFF
MAX_KEY_LEN = 31


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


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack (..., M) {0,1} bits big-endian into int64 keys."""
    m = bits.shape[-1]
    weights = torch.pow(
        2, torch.arange(m - 1, -1, -1, device=bits.device, dtype=torch.int64)
    )
    return torch.sum(bits.to(torch.int64) * weights, dim=-1)


def hash_vectors(params: LSHParams, x: torch.Tensor) -> torch.Tensor:
    """Hash (..., dim) vectors into (..., H) packed int64 hashkeys."""
    proj = x.to(torch.float32) @ params.projections  # (..., H*M)
    bits = (proj >= 0.0).reshape(*x.shape[:-1], params.n_arrays, params.key_len)
    return pack_bits(bits)


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
