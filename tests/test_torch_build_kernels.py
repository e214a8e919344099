"""The build kernels of the port (``lsh_hash``, ``kmeans_assign``), their
plain versions and their dispatch, held against the JAX package's on the
same numpy inputs.

On the CPU ``ops`` runs the plain versions (``ref.lsh_hash_ref``,
``ref.kmeans_assign_ref``); they are compared with the JAX package's
Pallas kernels in interpret mode and with its plain versions, over the
shapes of ``tests/test_kernels.py``. Tolerances: keys and assignments
exact; k-means distances rtol and atol 1e-4 (``tests/test_kernels.py``).
The CUDA kernels are held to their plain versions by the tests marked
``gpu`` (skipped without a card): a key bit or an assignment may differ
only within float32 rounding of the decision (``repro_torch.testing``).
JAX is imported inside the tests that use it, so this file also collects
on a machine that has only PyTorch.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import clustering, lsh
from repro_torch.kernels import ops, ref
from repro_torch.kernels.kmeans_assign import kmeans_assign
from repro_torch.kernels.lsh_hash import lsh_hash
from repro_torch.testing import (
    F32_ERROR_FACTOR, assignment_flips, lsh_bits_outside_bound, lsh_key_flips, min_dist_error,
)

LSH_SHAPES = [(64, 32, 2, 8), (100, 64, 4, 12), (257, 128, 10, 24), (16, 256, 1, 31), (8, 8, 3, 5)]
KMEANS_SHAPES = [(64, 8, 16), (100, 16, 32), (513, 70, 64), (33, 7, 8)]


def _jax():
    import jax.numpy as jnp
    from repro.kernels import kmeans_assign as jax_kmeans_assign
    from repro.kernels import lsh_hash as jax_lsh_hash
    from repro.kernels import ref as jax_ref

    return jnp, jax_lsh_hash, jax_kmeans_assign, jax_ref


@pytest.mark.parametrize("n,d,h,m", LSH_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lsh_hash_ref_matches_jax(n, d, h, m, dtype):
    """Keys equal, as int64, to the TPU kernel in interpret mode and to the
    JAX plain version; bfloat16 rows widen to float32 exactly."""
    jnp, jax_lsh_hash, _, jax_ref = _jax()
    rng = np.random.default_rng(n + d)
    x = rng.standard_normal((n, d)).astype(np.float32)
    if dtype == "bfloat16":  # values exact in bfloat16
        x = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    p = rng.standard_normal((d, h * m)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    want_kernel = np.asarray(jax_lsh_hash(jx, jnp.asarray(p), n_arrays=h, key_len=m, interpret=True, block_n=64))
    want_ref = np.asarray(jax_ref.lsh_hash_ref(jx, jnp.asarray(p), h, m))
    tx = torch.from_numpy(x).to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    got = ops.lsh_hash_op(tx, torch.from_numpy(p), n_arrays=h, key_len=m)
    assert got.dtype == torch.int64 and got.shape == (n, h)
    np.testing.assert_array_equal(got.numpy(), want_kernel.astype(np.int64))
    np.testing.assert_array_equal(got.numpy(), want_ref.astype(np.int64))


@pytest.mark.parametrize("n,c,d", KMEANS_SHAPES)
def test_kmeans_assign_ref_matches_jax(n, c, d):
    jnp, _, jax_kmeans_assign, jax_ref = _jax()
    rng = np.random.default_rng(n + c)
    x = rng.standard_normal((n, d)).astype(np.float32)
    cen = rng.standard_normal((c, d)).astype(np.float32)
    ji, jd = jax_kmeans_assign(jnp.asarray(x), jnp.asarray(cen), block_n=32, block_c=8, interpret=True)
    ri, rd = jax_ref.kmeans_assign_ref(jnp.asarray(x), jnp.asarray(cen))
    gi, gd = ref.kmeans_assign_ref(torch.from_numpy(x), torch.from_numpy(cen))
    assert gi.dtype == torch.int32 and gd.dtype == torch.float32
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(gd.numpy(), np.asarray(jd), rtol=1e-4, atol=1e-4)
    # The op's chunked CPU path gives the same result.
    oi, od = ops.kmeans_assign_op(torch.from_numpy(x), torch.from_numpy(cen), chunk=50)
    np.testing.assert_array_equal(oi.numpy(), gi.numpy())
    np.testing.assert_allclose(od.numpy(), gd.numpy(), rtol=1e-4, atol=1e-4)


def test_kmeans_assign_ties_go_to_the_first_minimum():
    jnp, _, _, jax_ref = _jax()
    rng = np.random.default_rng(3)
    cen = rng.standard_normal((9, 16)).astype(np.float32)
    cen[6] = cen[2]
    cen[8] = cen[2]
    x = np.concatenate([cen[[2, 6, 8]], rng.standard_normal((5, 16)).astype(np.float32)])
    gi, _ = ops.kmeans_assign_op(torch.from_numpy(x), torch.from_numpy(cen))
    ji, _ = jax_ref.kmeans_assign_ref(jnp.asarray(x), jnp.asarray(cen))
    assert gi[:3].tolist() == [2, 2, 2]
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ji))


def test_hash_vectors_and_assign_chunked_go_through_the_ops(monkeypatch):
    """The core functions reach the kernels only through ``ops``: the bank
    fit's (chunk, Lp, d) rows are flattened to one (n, d) call."""
    calls = []
    real_lsh, real_km = ops.lsh_hash_op, ops.kmeans_assign_op

    def spy_lsh(x, proj, **kw):
        calls.append(("lsh", tuple(x.shape)))
        return real_lsh(x, proj, **kw)

    def spy_km(x, c, **kw):
        calls.append(("km", tuple(x.shape)))
        return real_km(x, c, **kw)

    monkeypatch.setattr(lsh, "lsh_hash_op", spy_lsh)
    monkeypatch.setattr(clustering, "kmeans_assign_op", spy_km)
    g = torch.Generator().manual_seed(0)
    params = lsh.make_lsh(g, 8, 3, 5)
    x = torch.randn((4, 6, 8), generator=g)
    keys = lsh.hash_vectors(params, x)
    assert keys.shape == (4, 6, 3) and calls == [("lsh", (24, 8))]
    want = ref.lsh_hash_ref(x.reshape(24, 8), params.projections, n_arrays=3, key_len=5)
    assert torch.equal(keys.reshape(24, 3), want)
    a, _ = clustering.assign_chunked(x.reshape(24, 8), x[0, :3])
    assert calls[-1] == ("km", (24, 8)) and a.shape == (24,)


def test_cpu_tensors_never_reach_the_build_kernels():
    """The CUDA wrappers refuse CPU tensors (``ops`` sends them to the
    plain versions), and their launch counters do not move."""
    x, p = torch.randn(5, 8), torch.randn(8, 6)
    before = (lsh_hash.launches, kmeans_assign.launches)
    with pytest.raises(ValueError, match="CUDA"):
        lsh_hash(x, p, n_arrays=2, key_len=3)
    with pytest.raises(ValueError, match="CUDA"):
        kmeans_assign(x, p.T.contiguous())
    ops.lsh_hash_op(x, p, n_arrays=2, key_len=3)
    ops.kmeans_assign_op(x, x[:2])
    assert (lsh_hash.launches, kmeans_assign.launches) == before


def test_build_kernel_sources_name_what_they_replace():
    """Each source names the TPU kernel it replaces and calls no library.
    Both compute their products in split TF32 on the tensor cores; that
    precision is held by the key gate and the float64 gate (the gpu tests
    and the chip smoke run), not by the text."""
    from repro_torch.kernels import build

    for name in ("lsh_hash", "kmeans_assign"):
        src = (build.CSRC / f"{name}.cu").read_text()
        assert f"repro/kernels/{name}.py::{name}" in src
        assert f'extern "C" int {name}_launch' in src
        assert "cublas" not in src.lower() and "wmma" not in src
        assert build.library_path(name).name.startswith(f"lib{name}-")


def test_rounding_bound_checks_admit_only_near_ties():
    """``lsh_key_flips`` and ``assignment_flips`` accept a difference only
    within float32 rounding of the decision, and reject any other."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((6, 16)).astype(np.float32))
    p = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
    x[0] = 0.0
    x[0, :2] = torch.tensor([1.0, -1.0])
    p[:2, 0] = 1.0  # row 0, bit 0 of array 0: 1 - 1, a projection of exactly 0
    x[5] = 0.0  # a zero row: every product exactly 0, no bound
    keys = ref.lsh_hash_ref(x, p, n_arrays=2, key_len=4)
    flipped = keys.clone()
    flipped[0, 0] ^= 1 << 3  # the cancelling bit: admitted
    out = lsh_key_flips(x, p, 2, 4, flipped, keys)
    assert out == {"bits": 48, "flips": 1, "near": 1}
    for r, a, bit in ((1, 1, 1), (5, 0, 1 << 3)):  # far from zero; a zero row: refused
        bad = keys.clone()
        bad[r, a] ^= bit
        with pytest.raises(AssertionError, match="outside the rounding bound"):
            lsh_key_flips(x, p, 2, 4, bad, keys)
    cen = x[:3].clone()
    cen[2] = cen[1]  # a row equidistant from centroids 1 and 2
    a, _ = ref.kmeans_assign_ref(x, cen)
    other = a.clone()
    other[1] = 2
    assert assignment_flips(x, cen, other, a) == {"rows": 6, "differ": 1}
    other[0] = 1
    with pytest.raises(AssertionError, match="outside the rounding bound"):
        assignment_flips(x, cen, other, a)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

GPU_LSH = [(1, 8, 1, 1), (37, 33, 3, 31), (515, 768, 10, 16), (300, 768, 10, 10), (4099, 64, 7, 5)]
def _tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to TF32's 10-bit mantissa (nearest, ties away)."""
    bits = t.contiguous().view(torch.int32).to(torch.int64)
    return ((bits + 0x1000) & ~0x1FFF).to(torch.int32).view(torch.float32)


def _split_tf32_dot(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``x @ c.T`` as the CUDA kernel forms it, emulated in float32: each
    operand split into ``big = tf32(v)`` and ``small = tf32(v - big)``,
    then ``small_x big_c + big_x small_c + big_x big_c`` (the small terms
    first; ``small_x small_c`` dropped)."""
    xb, cb = _tf32(x), _tf32(c)
    xs, cs = _tf32(x - xb), _tf32(c - cb)
    return (xs @ cb.T + xb @ cs.T) + xb @ cb.T


# (seed, n, c, d, clustered): the shapes of the parity tests, at full width too.
SPLIT_CASES = [(1, 3000, 70, 768, False), (2, 4099, 1024, 64, False), (3, 2000, 64, 768, True),
               (4, 513, 70, 64, False), (5, 1000, 130, 33, True)]


@pytest.mark.parametrize("seed,n,c,d,clustered", SPLIT_CASES)
def test_split_tf32_product_passes_the_float64_gate(seed, n, c, d, clustered):
    """The gate the card applies to ``kmeans_assign``, rehearsed on the CPU:
    distances from the split-TF32 product (emulated here by rounding to
    TF32 with bit masks) err against float64 within ``F32_ERROR_FACTOR``
    times the plain float32 version's error, while a one-pass TF32 product
    errs beyond it. Clustered cases are unit-norm rows near their
    centroids, where the dot products are large and positive."""
    rng = np.random.default_rng(seed)
    if clustered:
        modes = rng.standard_normal((c, d))
        x = modes[rng.integers(0, c, n)] + 0.35 * rng.standard_normal((n, d))
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        cen = modes / np.linalg.norm(modes, axis=1, keepdims=True)
    else:
        x, cen = rng.standard_normal((n, d)), rng.standard_normal((c, d))
    x = torch.from_numpy(x.astype(np.float32))
    cen = torch.from_numpy(cen.astype(np.float32))
    a, dist = ref.kmeans_assign_ref(x, cen)
    plain = min_dist_error(x, cen, a, dist)
    x_sq, c_sq = (x * x).sum(-1, keepdim=True), (cen * cen).sum(-1)

    def assigned(dot):
        d2 = x_sq - 2.0 * dot + c_sq
        ai = torch.argmin(d2, dim=-1)
        return ai.to(torch.int32), d2.gather(1, ai[:, None])[:, 0]

    split_a, split_d = assigned(_split_tf32_dot(x, cen))
    assignment_flips(x, cen, split_a, a)
    assert 0 < plain
    assert min_dist_error(x, cen, split_a, split_d) <= F32_ERROR_FACTOR * plain
    assert min_dist_error(x, cen, *assigned(_tf32(x) @ _tf32(cen).T)) > F32_ERROR_FACTOR * plain


def test_min_dist_error_tells_float32_from_tf32():
    """The float64 distance check: the plain float32 version errs little,
    a product on TF32-rounded inputs errs more than ``F32_ERROR_FACTOR``
    times that, and a distance moved by 1e-3 is seen."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((3000, 768)).astype(np.float32))
    cen = torch.from_numpy(rng.standard_normal((70, 768)).astype(np.float32))
    a, dist = ref.kmeans_assign_ref(x, cen)
    plain = min_dist_error(x, cen, a, dist, chunk=1000)
    assert 0 < plain < 1e-5
    x_sq, c_sq = (x * x).sum(-1), (cen * cen).sum(-1)
    tf_dot = (_tf32(x) @ _tf32(cen).T).gather(1, a.long()[:, None])[:, 0]
    assert min_dist_error(x, cen, a, x_sq - 2.0 * tf_dot + c_sq[a.long()]) > F32_ERROR_FACTOR * plain
    moved = dist.clone()
    moved[1234] += 1e-3 * float(x_sq[1234] + c_sq[a[1234]])
    assert min_dist_error(x, cen, a, moved) >= 0.99e-3


def _keys_of(acc: torch.Tensor, n_arrays: int, key_len: int) -> torch.Tensor:
    """(N, H*M) projections -> (N, H) keys: sign bits (``>= 0``), packed
    big-endian, as ``ref.lsh_hash_ref`` packs them."""
    bits = (acc >= 0).reshape(acc.shape[0], n_arrays, key_len).to(torch.int64)
    return (bits << torch.arange(key_len - 1, -1, -1)).sum(-1)


@pytest.mark.parametrize("clustered", [False, True], ids=["gaussian", "clustered"])
def test_key_gate_tells_split_tf32_from_one_tf32_product(clustered):
    """The gate the card applies to ``lsh_hash``, rehearsed on the CPU at
    the bank fit's width (d = 768, H = 10, M = 16): keys from the
    split-TF32 product (emulated by rounding to TF32 with bit masks, as
    ``lsh_hash.cu`` forms it) pass ``lsh_key_flips`` on every row, while
    keys from a one-pass TF32 product put bits outside the rounding bound.
    It does so at ~2e-7 a bit, so the rows grow 16,384 at a time until
    the gate refuses the one-pass product: at these seeds both cases need
    65,536 rows (4 chunks); the bound itself is unchanged. Clustered rows
    are unit-norm rows near 64 modes, as the bank's are."""
    d, h, m, chunk = 768, 10, 16, 16384
    rng = np.random.default_rng(11 + clustered)
    p = torch.from_numpy(rng.standard_normal((d, h * m)).astype(np.float32))
    modes = rng.standard_normal((64, d))
    pb = _tf32(p)
    ps = _tf32(p - pb)
    refused = 0
    for i in range(16):
        r = np.random.default_rng([11 + clustered, i])
        if clustered:
            x = modes[r.integers(0, 64, chunk)] + 0.35 * r.standard_normal((chunk, d))
            x /= np.linalg.norm(x, axis=1, keepdims=True)
        else:
            x = r.standard_normal((chunk, d))
        x = torch.from_numpy(x.astype(np.float32))
        want = ref.lsh_hash_ref(x, p, n_arrays=h, key_len=m)
        xb = _tf32(x)
        split = (_tf32(x - xb) @ pb + xb @ ps) + xb @ pb
        lsh_key_flips(x, p, h, m, _keys_of(split, h, m), want)
        refused += lsh_bits_outside_bound(x, p, h, m, _keys_of(xb @ pb, h, m), want)
        if refused:
            break
    assert refused > 0 and i == 3, (refused, i)


def test_kmeans_step_sums_in_index_order_on_the_cpu():
    """On the CPU the Lloyd sums add each cluster's rows in index order
    (``index_add_``): bit for bit a float32 loop over the rows in order,
    and within the parity tolerance of the JAX package's ``segment_sum``
    (rtol 1e-5, atol 1e-5, as ``test_torch_core.py`` holds them); the
    counts are exact. On the card the order is fixed too (a gpu test)."""
    import jax.numpy as jnp
    from repro.core import clustering as jclust

    rng = np.random.default_rng(21)
    x = rng.standard_normal((3000, 48)).astype(np.float32)
    cen = x[rng.choice(3000, 24, replace=False)]
    sums, counts, assign = clustering.kmeans_step(torch.from_numpy(x), torch.from_numpy(cen),
                                                  n_clusters=24)
    loop = np.zeros((24, 48), np.float32)
    for i, a in enumerate(assign.numpy()):
        loop[a] += x[i]
    np.testing.assert_array_equal(sums.numpy(), loop)
    np.testing.assert_array_equal(counts.numpy(), np.bincount(assign.numpy(), minlength=24))
    js, jc, ja = jclust.kmeans_step(jnp.asarray(x), jnp.asarray(cen), n_clusters=24)
    np.testing.assert_array_equal(assign.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    np.testing.assert_allclose(sums.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)


GPU_KMEANS = [(1, 1, 8), (257, 7, 33), (1000, 70, 768), (4099, 1024, 64), (129, 130, 16)]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_lsh_hash_matches_plain_version(dtype):
    """Every key bit equal to the plain version's except within float32
    rounding of 0 (the two sum in other orders)."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(0)
    for n, d, h, m in GPU_LSH:
        x = torch.randn((n, d), generator=g, device=dev).to(dtype)
        p = torch.randn((d, h * m), generator=g, device=dev)
        got = lsh_hash(x, p, n_arrays=h, key_len=m)
        torch.cuda.synchronize()
        want = ref.lsh_hash_ref(x, p, n_arrays=h, key_len=m)
        assert got.dtype == torch.int64 and bool((got >= 0).all())
        lsh_key_flips(x, p, h, m, got, want)


@pytest.mark.gpu
def test_cuda_kmeans_assign_matches_plain_version():
    """Assignments equal to the plain version's except between centroids
    whose float64 distances tie within rounding; distances allclose (rtol
    and atol 1e-4); duplicate centroids resolve to the first index, bit for
    bit. Row 0 is placed on centroid 2: its distance is 0, where
    ``x_sq - 2 x.c + c_sq`` cancels terms of size ~d, so it is held to the
    rounding bound of the expansion and not to atol 1e-4. Distances are
    also held to float64: at most ``F32_ERROR_FACTOR`` times the plain
    version's error, which a TF32 product exceeds."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(1)
    errs = {"kernel": 0.0, "plain": 0.0, "tf32": 0.0}
    for n, c, d in GPU_KMEANS:
        x = torch.randn((n, d), generator=g, device=dev)
        cen = torch.randn((c, d), generator=g, device=dev)
        on_centroid = c >= 7
        if on_centroid:
            cen[5] = cen[2]
            cen[6] = cen[2]
            x[0] = cen[2]
        got_a, got_d = kmeans_assign(x, cen)
        torch.cuda.synchronize()
        want_a, want_d = ref.kmeans_assign_ref(x, cen)
        assignment_flips(x, cen, got_a, want_a)
        old_tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf_a, tf_d = ref.kmeans_assign_ref(x, cen)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old_tf32
        for key, (a, dist) in (("kernel", (got_a, got_d)), ("plain", (want_a, want_d)),
                               ("tf32", (tf_a, tf_d))):
            errs[key] = max(errs[key], min_dist_error(x, cen, a, dist))
        rest = slice(1, None) if on_centroid else slice(None)
        torch.testing.assert_close(got_d[rest], want_d[rest], rtol=1e-4, atol=1e-4)
        if on_centroid:
            assert int(got_a[0]) == 2
            mag = 4 * float((x[0].double() ** 2).sum())  # x_sq + 2|x.c| + c_sq with c = x
            assert abs(float(got_d[0])) <= d * 2.0**-24 * mag
            assert abs(float(want_d[0])) <= d * 2.0**-24 * mag
    # Against float64: float32, not TF32 (which this check must be able to tell apart).
    assert errs["kernel"] <= F32_ERROR_FACTOR * errs["plain"], errs
    assert errs["tf32"] > F32_ERROR_FACTOR * errs["plain"], errs


@pytest.mark.gpu
def test_cuda_build_kernels_are_row_deterministic():
    """A row's key and assignment are the same hashed alone, inside a large
    batch and at another offset: bit for bit."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((5000, 768), generator=g, device=dev)
    p = torch.randn((768, 160), generator=g, device=dev)
    cen = torch.randn((1024, 768), generator=g, device=dev)
    keys = lsh_hash(x, p, n_arrays=10, key_len=16)
    a, dist = kmeans_assign(x, cen)
    for s, e in ((0, 1), (77, 78), (4999, 5000), (3, 4100), (1000, 5000)):
        assert torch.equal(lsh_hash(x[s:e].contiguous(), p, n_arrays=10, key_len=16), keys[s:e])
        sa, sd = kmeans_assign(x[s:e].contiguous(), cen)
        assert torch.equal(sa, a[s:e])
        assert torch.equal(sd.view(torch.int32), dist[s:e].view(torch.int32))


# Off every tile of the kernel's design: 128 rows a block, 128 centroids a
# tile, 32-deep stages of 16-byte (d % 4 == 0, aligned) or 4-byte loads.
EDGE_N = (1, 127, 129, 20000)
EDGE_C = (1, 7, 70, 129, 1024)


def _rows(g, dev, n, d, offset):
    """(n, d) float32 rows; with ``offset`` 1 a contiguous view that starts
    4 bytes past a 16-byte boundary of a larger buffer."""
    flat = torch.randn((n * d + 4,), generator=g, device=dev)
    return flat[offset : offset + n * d].view(n, d)


@pytest.mark.gpu
@pytest.mark.parametrize("d,offset", [(8, 0), (33, 0), (770, 0), (768, 0), (768, 1), (8, 1)])
def test_cuda_kmeans_assign_edges(d, offset):
    """N and c off every tile, d off every stage and load width, rows that
    start off a 16-byte boundary: assignments within the rounding bound of
    the plain version's, distances within ``F32_ERROR_FACTOR`` times its
    float64 error (over the case's shapes), duplicate centroids (in one
    tile and across tiles) resolving to the first index, rows on a
    centroid at distance ~0, and each row's result the same alone, in
    sub-batches and at another offset, bit for bit."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(d + offset)
    errs = {"kernel": 0.0, "plain": 0.0}
    for n in EDGE_N:
        for c in EDGE_C:
            x = _rows(g, dev, n, d, offset)
            if offset:
                assert x.data_ptr() % 16 == 4 and x.is_contiguous()
            cen = torch.randn((c, d), generator=g, device=dev)
            dup = c >= 7
            if dup:  # 5, 6 and the last copy 2; row 0 on it, row 1 (if any) on the last
                cen[5] = cen[2]
                cen[6] = cen[2]
                cen[c - 1] = cen[2]
                x[0] = cen[2]
                if n > 1:
                    x[1] = cen[c - 1]
            got_a, got_d = kmeans_assign(x, cen)
            torch.cuda.synchronize()
            want_a, want_d = ref.kmeans_assign_ref(x, cen)
            assignment_flips(x, cen, got_a, want_a)
            errs["kernel"] = max(errs["kernel"], min_dist_error(x, cen, got_a, got_d))
            errs["plain"] = max(errs["plain"], min_dist_error(x, cen, want_a, want_d))
            if dup:
                on = min(n, 2)
                assert got_a[:on].tolist() == [2] * on
                assert not bool(((got_a == 5) | (got_a == 6) | (got_a == c - 1)).any())
                mag = 4 * float((x[0].double() ** 2).sum())
                assert abs(float(got_d[0])) <= d * 2.0**-24 * mag
            if n >= 129:
                for s, e in ((0, 1), (n - 1, n), (3, 128), (100, n)):
                    alone_a, alone_d = kmeans_assign(x[s:e].contiguous(), cen)
                    assert torch.equal(alone_a, got_a[s:e])
                    assert torch.equal(alone_d.view(torch.int32), got_d[s:e].view(torch.int32))
                moved = torch.cat([x[n // 2 :], x[: n // 2]])  # every row at another position
                ma, md = kmeans_assign(moved, cen)
                assert torch.equal(torch.cat([ma[n - n // 2 :], ma[: n - n // 2]]), got_a)
                back = torch.cat([md[n - n // 2 :], md[: n - n // 2]])
                assert torch.equal(back.view(torch.int32), got_d.view(torch.int32))
    assert errs["kernel"] <= F32_ERROR_FACTOR * errs["plain"], errs


@pytest.mark.gpu
def test_cuda_kmeans_assign_counts_two_launches():
    """A call launches the centroid-norm kernel and the assignment kernel."""
    from repro_torch.kernels import kmeans_assign as km_mod

    dev = _cuda()
    x = torch.randn((300, 64), device=dev)
    before = kmeans_assign.launches
    kmeans_assign(x, x[:10].contiguous())
    assert kmeans_assign.launches - before == km_mod.LAUNCHES_PER_CALL == 2


# The new design's edges: N off the 64-row block and across the layouts'
# switch (16,384 rows), d off the 32-deep stage and the 16-byte rows, keys
# from 1 to 31 bits, arrays that fill a 40-column wgmma or not, one to four
# tiles of whole arrays.
LSH_EDGE_N = (1, 63, 65, 127, 129, 256, 20000)
LSH_EDGE_HM = ((1, 1), (1, 31), (3, 31), (7, 5), (10, 10), (10, 16), (16, 16))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d,offset", [(8, 0), (33, 0), (770, 0), (768, 0), (768, 1)])
def test_cuda_lsh_hash_edges(d, offset, dtype):
    """Every (N, H, M) of the edges at this d: key bits equal to the plain
    version's except within the rounding bound (``lsh_key_flips``), zero
    rows giving all-ones keys, bfloat16 rows hashing exactly as their
    float32 widening, and each row's keys the same alone, in sub-batches
    and at another offset, bit for bit. With ``offset`` 1 the rows start
    one element past a 16-byte boundary."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(d + offset)
    for n in LSH_EDGE_N:
        flat = torch.randn((n * d + 8,), generator=g, device=dev).to(dtype)
        x = flat[offset : offset + n * d].view(n, d)
        if offset:
            assert x.data_ptr() % 16 != 0 and x.is_contiguous()
        x[0] = 0
        if n > 64:
            x[64] = 0
        for h, m in LSH_EDGE_HM:
            p = torch.randn((d, h * m), generator=g, device=dev)
            got = lsh_hash(x, p, n_arrays=h, key_len=m)
            torch.cuda.synchronize()
            assert got.shape == (n, h) and got.dtype == torch.int64
            lsh_key_flips(x, p, h, m, got, ref.lsh_hash_ref(x, p, n_arrays=h, key_len=m))
            assert bool((got[0] == 2**m - 1).all())
            if n > 64:
                assert bool((got[64] == 2**m - 1).all())
            if dtype == torch.bfloat16:
                assert torch.equal(lsh_hash(x.float(), p, n_arrays=h, key_len=m), got)
            if n >= 129:
                for s, e in ((0, 1), (n - 1, n), (3, 128), (100, n)):
                    assert torch.equal(lsh_hash(x[s:e].contiguous(), p, n_arrays=h, key_len=m),
                                       got[s:e])
                moved = torch.cat([x[n // 2 :], x[: n // 2]])
                mk = lsh_hash(moved, p, n_arrays=h, key_len=m)
                assert torch.equal(torch.cat([mk[n - n // 2 :], mk[: n - n // 2]]), got)


@pytest.mark.gpu
def test_cuda_lsh_hash_counts_one_launch():
    """A call is one launch: each block splits its own slice of P."""
    from repro_torch.kernels import lsh_hash as lsh_mod

    dev = _cuda()
    x = torch.randn((300, 64), device=dev)
    before = lsh_hash.launches
    lsh_hash(x, torch.randn((64, 160), device=dev), n_arrays=10, key_len=16)
    assert lsh_hash.launches - before == lsh_mod.LAUNCHES_PER_CALL == 1


@pytest.mark.gpu
def test_cuda_kmeans_step_is_deterministic():
    """Two Lloyd steps on the same inputs on the card give the same sums
    and counts bit for bit (the sums add each cluster's rows in one fixed
    order), and agree with the float64 sums within float32 rounding."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((300_000, 96), generator=g, device=dev)
    cen = x[:1024].clone()
    first = clustering.kmeans_step(x, cen, n_clusters=1024)
    second = clustering.kmeans_step(x, cen, n_clusters=1024)
    torch.cuda.synchronize()
    assert torch.equal(first[2], second[2])
    assert torch.equal(first[0].view(torch.int32), second[0].view(torch.int32))
    assert torch.equal(first[1], second[1])
    idx = first[2].long()
    exact = torch.zeros((1024, 96), dtype=torch.float64, device=dev).index_add_(0, idx, x.double())
    mag = torch.zeros((1024, 96), dtype=torch.float64, device=dev).index_add_(0, idx, x.double().abs())
    n_max = float(torch.bincount(idx, minlength=1024).max())
    assert bool(((first[0].double() - exact).abs() <= n_max * 2.0**-24 * mag).all())
    assert torch.equal(first[1], torch.bincount(idx, minlength=1024).float())
