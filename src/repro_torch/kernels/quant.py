"""Per-row symmetric int8 / packed int4 quantization and 1-bit sign
sketches: the quantized bank's storage schemes, the query-side
quantization of the kernels, and the plain versions' arithmetic.

The port's copy of the JAX package's ``repro/kernels/quant.py``; codes,
scales and sketches are byte-identical to it (``tests/test_torch_quant.py``).

Scheme: for each row ``x`` (an embedding or a query),

    scale = max(|x|) * float32(1/127)   (1.0 for all-zero rows)
    code  = round_half_even(x / scale) clipped to [-127, 127]   (int8)

int4 is the same at ``float32(1/7)`` and [-7, 7], packed two nibbles a byte
into an int8 carrier of width ``d//2``: element ``2j`` in the low nibble of
byte ``j``, element ``2j+1`` in the high nibble. Shifts run in int32 and
are masked back to bytes, since an int8 ``<<`` wraps.

Sketches: bit ``j`` of word ``w`` is ``x[..., 32*w + j] > 0``. The JAX
package holds the words as uint32; here they are the same 32 bits as
int32, so a kernel reads 4-byte words and XOR/popcount are unchanged.
"""
from __future__ import annotations

import torch

INT8_MAX = 127.0
INT4_MAX = 7.0
SKETCH_WORD_BITS = 32


def _symmetric(x: torch.Tensor, qmax: float) -> tuple[torch.Tensor, torch.Tensor]:
    x = x.to(torch.float32)
    amax = x.abs().amax(dim=-1)
    # The pre-rounded float32 reciprocal, as the JAX package multiplies by
    # it; made on the device (a fill, no copy from the host), so a CUDA
    # graph can capture it.
    recip = torch.full((), 1.0 / qmax, dtype=torch.float32, device=x.device)
    scales = torch.where(amax > 0, amax * recip, torch.ones_like(amax))
    codes = torch.round(x / scales[..., None]).clamp_(-qmax, qmax).to(torch.int8)
    return codes, scales


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(..., d)`` float -> (codes ``(..., d)`` int8, scales ``(...,)`` f32).
    All-zero rows get scale 1.0, so their codes are exactly 0."""
    return _symmetric(x, INT8_MAX)


def dequantize_rows(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_rows` (up to rounding): f32 rows."""
    return codes.to(torch.float32) * scales[..., None].to(torch.float32)


def _to_int8(v: torch.Tensor) -> torch.Tensor:
    """int32 values in [0, 256) -> the int8 with the same low byte."""
    return torch.where(v >= 128, v - 256, v).to(torch.int8)


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """``(..., d)`` int8 codes in [-8, 7] -> ``(..., d//2)`` packed int8."""
    if codes.shape[-1] % 2:
        raise ValueError(f"int4 packing needs an even row width, got d={codes.shape[-1]}")
    c = codes.to(torch.int32)
    lo = c[..., 0::2] & 0x0F
    hi = (c[..., 1::2] << 4) & 0xF0
    return _to_int8(hi | lo)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """``(..., d//2)`` packed int8 -> ``(..., d)`` int8 codes in [-8, 7];
    the exact inverse of :func:`pack_int4`."""
    p = packed.to(torch.int32)
    lo = ((p & 0x0F) ^ 0x08) - 0x08  # sign-extend the low nibble
    hi = p >> 4  # arithmetic: the signed high nibble
    return torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1], -1).to(torch.int8)


def quantize_rows_int4(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(..., d)`` float -> (packed codes ``(..., d//2)`` int8, scales f32)."""
    codes, scales = _symmetric(x, INT4_MAX)
    return pack_int4(codes), scales


def dequantize_rows_int4(packed: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_rows_int4` (up to rounding): f32 rows."""
    return dequantize_rows(unpack_int4(packed), scales)


def dequantize_codes(
    codes: torch.Tensor, scales: torch.Tensor, code_dtype: str = "int8"
) -> torch.Tensor:
    """Dequantize stored bank codes, int8 or packed int4."""
    if code_dtype == "int4":
        return dequantize_rows_int4(codes, scales)
    return dequantize_rows(codes, scales)


def sketch_width(d: int) -> int:
    """Packed words per row: ``ceil(d / 32)``."""
    return -(-d // SKETCH_WORD_BITS)


def sketch_rows(x: torch.Tensor) -> torch.Tensor:
    """``(..., d)`` float -> ``(..., ceil(d/32))`` int32 sign sketches (the
    uint32 words of the JAX package, as bit patterns). All-zero rows and
    the bits past ``d`` pack to zero."""
    d = x.shape[-1]
    w = sketch_width(d)
    bits = (x > 0).to(torch.int64)
    pad = w * SKETCH_WORD_BITS - d
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    bits = bits.reshape(*x.shape[:-1], w, SKETCH_WORD_BITS)
    weights = torch.ones((), dtype=torch.int64, device=x.device) << torch.arange(
        SKETCH_WORD_BITS, device=x.device
    )
    words = (bits * weights).sum(dim=-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def unpack_sketch(words: torch.Tensor, d: int) -> torch.Tensor:
    """``(..., ceil(d/32))`` sketch words -> ``(..., d)`` bool."""
    u = words.to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(SKETCH_WORD_BITS, device=words.device)
    bits = (u[..., None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1], -1)[..., :d].to(torch.bool)


def popcount32(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word (int32 bit patterns) as int64, by a
    SWAR count: torch has no popcount op."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF
