"""The port's quantization helpers (``repro_torch.kernels.quant``) against
the JAX package's ``repro.kernels.quant`` on the same numpy inputs.

Tolerance: none. Codes, scales, packed bytes and sketch words are held
byte-identical (scales compared as bit patterns); sketches are compared as
the same 32 bits (the port's int32 against the JAX package's uint32).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import quant as jquant
from repro_torch.kernels import quant


def _rows(seed, n, d):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x[0] = 0.0  # an all-zero row: scale 1.0, zero codes, zero sketch
    x[1, ::2] = 0.0  # exact zeros inside a row
    x[2] = np.round(x[2] * 4) / 4  # values whose codes sit at .5 ties
    x[3] *= 1e-30  # tiny magnitudes
    return x


def _bits(a) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(a))
    return a.view({1: np.uint8, 4: np.uint32}[a.dtype.itemsize])


@pytest.mark.parametrize("d", [8, 32, 33, 64, 100])
def test_quantize_rows_byte_identical(d):
    x = _rows(d, 40, d)
    codes, scales = quant.quantize_rows(torch.from_numpy(x))
    jc, js = jquant.quantize_rows(jnp.asarray(x))
    assert codes.dtype == torch.int8 and scales.dtype == torch.float32
    np.testing.assert_array_equal(_bits(codes.numpy()), _bits(jc))
    np.testing.assert_array_equal(_bits(scales.numpy()), _bits(js))
    assert scales[0] == 1.0 and (codes[0] == 0).all()
    np.testing.assert_array_equal(
        quant.dequantize_rows(codes, scales).numpy(), np.asarray(jquant.dequantize_rows(jc, js))
    )


@pytest.mark.parametrize("d", [8, 32, 64, 96])
def test_quantize_rows_int4_byte_identical(d):
    x = _rows(d + 1, 40, d)
    packed, scales = quant.quantize_rows_int4(torch.from_numpy(x))
    jp, js = jquant.quantize_rows_int4(jnp.asarray(x))
    assert packed.shape == (40, d // 2) and packed.dtype == torch.int8
    np.testing.assert_array_equal(_bits(packed.numpy()), _bits(jp))
    np.testing.assert_array_equal(_bits(scales.numpy()), _bits(js))
    assert (packed[0] == 0).all() and scales[0] == 1.0
    for code_dtype, (c, s), (jcc, jss) in (
        ("int4", (packed, scales), (jp, js)),
        ("int8", quant.quantize_rows(torch.from_numpy(x)), jquant.quantize_rows(jnp.asarray(x))),
    ):
        np.testing.assert_array_equal(
            quant.dequantize_codes(c, s, code_dtype).numpy(),
            np.asarray(jquant.dequantize_codes(jcc, jss, code_dtype)),
        )


def test_pack_unpack_int4_round_trip_over_all_nibbles():
    vals = np.arange(-8, 8, dtype=np.int8)
    codes = np.stack(np.meshgrid(vals, vals, indexing="ij"), -1).reshape(-1, 2)  # every pair
    codes = np.concatenate([codes, codes[::-1]], axis=1)  # (256, 4)
    packed = quant.pack_int4(torch.from_numpy(codes))
    np.testing.assert_array_equal(_bits(packed.numpy()), _bits(jquant.pack_int4(jnp.asarray(codes))))
    np.testing.assert_array_equal(quant.unpack_int4(packed).numpy(), codes)
    every_byte = np.arange(-128, 128, dtype=np.int8)[None]
    np.testing.assert_array_equal(
        quant.unpack_int4(torch.from_numpy(every_byte)).numpy(),
        np.asarray(jquant.unpack_int4(jnp.asarray(every_byte))),
    )
    with pytest.raises(ValueError, match="even"):
        quant.pack_int4(torch.zeros((2, 3), dtype=torch.int8))


@pytest.mark.parametrize("d", [1, 31, 32, 33, 64, 96, 100])
def test_sketch_rows_and_unpack_byte_identical(d):
    x = _rows(2 * d, 30, d)
    sk = quant.sketch_rows(torch.from_numpy(x))
    jsk = jquant.sketch_rows(jnp.asarray(x))
    assert sk.dtype == torch.int32 and sk.shape == (30, quant.sketch_width(d))
    assert quant.sketch_width(d) == jquant.sketch_width(d)
    np.testing.assert_array_equal(_bits(sk.numpy()), np.asarray(jsk))
    assert (sk[0] == 0).all()
    bits = quant.unpack_sketch(sk, d)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jquant.unpack_sketch(jsk, d)))
    np.testing.assert_array_equal(bits.numpy(), x > 0)


def test_sketch_high_bit_words_and_popcount():
    """Words with bit 31 set are negative as int32 and must round-trip; the
    SWAR popcount counts all 32 bits."""
    x = np.full((3, 64), -1.0, np.float32)
    x[0, 31] = 1.0  # only bit 31 of word 0
    x[1] = 1.0  # every bit
    sk = quant.sketch_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(_bits(sk.numpy()), np.asarray(jquant.sketch_rows(jnp.asarray(x))))
    assert sk[0, 0] == -(2**31) and sk[1, 0] == -1
    np.testing.assert_array_equal(quant.popcount32(sk).sum(-1).numpy(), [1, 64, 0])
    words = np.random.default_rng(0).integers(0, 2**32, 500, dtype=np.uint64).astype(np.uint32)
    got = quant.popcount32(torch.from_numpy(words.view(np.int32))).numpy()
    np.testing.assert_array_equal(got, [bin(int(w)).count("1") for w in words])
