"""The port's baselines (``repro_torch.core.baselines``) and the LSH key
helpers, against the JAX package.

- The seven cases of the JAX package's ``tests/test_baselines.py`` on the
  port, on the same corpus (the session ``corpus`` fixture: 4,000 x 64, 64
  queries), each index built by the port.
- Each approximate baseline searched on params the JAX package built and the
  port took over (``params_from_numpy``): ids exact, scores to rtol 1e-5 /
  atol 1e-6 (``repro_torch.testing``: float32 sums in another order). PQ's
  encoding of the corpus with JAX's codebooks gives JAX's codes exactly.
- ``pack_bits``, ``unpack_bits``, ``_clz32``, ``common_prefix_len`` and
  ``dist_e`` exactly equal to JAX's on random keys at every key_len from 1
  to 31, with window_bits 1, 8 and 16, including equal keys and keys that
  differ only in the last bit.

JAX is imported inside the tests that use it, so the file also collects
where only PyTorch is installed. The ``gpu`` cases hold the kernels at the baselines' shapes against their
plain versions within float32 rounding of each decision
(``repro_torch.testing``): ``lsh_hash`` at H = 24 arrays of M = 20 bits,
and ``kmeans_assign`` at PQ's sub-spaces (d = 96 column slices of d = 768,
c = 256) and IVF-PQ's coarse lists (c = 1,024).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import lsh
from repro_torch.core.baselines import (
    build_ivfpq,
    build_mplsh,
    build_pq,
    build_sklsh,
    flat_search,
    ivfpq,
    ivfpq_search,
    mplsh,
    mplsh_search,
    pq,
    pq_search,
    sklsh,
    sklsh_search,
)
from repro_torch.core.baselines.pq import _decode, _encode
from repro_torch.core.utils import recall_at_k
from repro_torch.testing import SCORE_ATOL, SCORE_RTOL


def _jax():
    import jax
    import jax.numpy as jnp
    from repro.core import baselines as jb
    from repro.core import lsh as jlsh

    return jax, jnp, jb, jlsh


@pytest.fixture(scope="module")
def tcorpus(corpus):
    x, q, gt = corpus
    return (torch.from_numpy(np.array(x)), torch.from_numpy(np.array(q)),
            torch.from_numpy(np.array(gt)))


def gen(seed):
    return torch.Generator().manual_seed(seed)


def rec(ids, gt) -> float:
    return float(recall_at_k(ids, gt))


# ---------------------------------------------------------------------------
# The cases of tests/test_baselines.py
# ---------------------------------------------------------------------------
def test_flat_is_exact(tcorpus):
    x, q, gt = tcorpus
    np.testing.assert_array_equal(flat_search(x, q, k=10).ids.numpy(), gt.numpy())
    np.testing.assert_array_equal(flat_search(x, q, k=10, chunk=1000).ids.numpy(), gt.numpy())


def test_pq_reconstruction_improves_with_subspaces(tcorpus):
    x, _, _ = tcorpus
    errs = []
    for m in (2, 8):
        p = build_pq(gen(1), x, n_subspaces=m, bits=5, kmeans_iters=6)
        errs.append(float(torch.mean((_decode(p.codebooks, p.codes) - x) ** 2)))
    assert errs[1] < errs[0]


def test_pq_recall_reasonable(tcorpus):
    x, q, gt = tcorpus
    p = build_pq(gen(1), x, n_subspaces=8, bits=6, kmeans_iters=8)
    assert rec(pq_search(p, q, k=10).ids, gt) > 0.05  # far above random (10/4000)


def test_opq_and_pcapq_build(tcorpus):
    x, q, gt = tcorpus
    opq = build_pq(gen(1), x, n_subspaces=8, bits=5, kmeans_iters=5, opq_iters=1)
    assert opq.rotation is not None
    assert rec(pq_search(opq, q, k=10).ids, gt) > 0.05
    ppq = build_pq(gen(1), x, n_subspaces=8, bits=5, kmeans_iters=5, pca_dim=32)
    assert ppq.rotation.shape == (64, 32)
    assert rec(pq_search(ppq, q, k=10).ids, gt) > 0.05


def test_ivfpq_recall_improves_with_probes(corpus, tcorpus):
    """Recall rising with the probes is a property of an index, not of
    every index: PQ's approximate scores of the extra lists can push out a
    true neighbour (the JAX build at ``PRNGKey(0)``: 0.3484 at 2 probes,
    0.3469 at 16; the port's build from generator seed 2: 0.3375 and
    0.3359). So it is held on the index the JAX test holds it on, the JAX
    build at ``PRNGKey(2)``, searched by the port; the port's own build is
    held to the recall floor."""
    jax, _, jb, _ = _jax()
    x, q, gt = tcorpus
    jp = jb.build_ivfpq(jax.random.PRNGKey(2), corpus[0], n_subspaces=8, bits=6, kmeans_iters=8)
    ivf = ivfpq.params_from_numpy(
        {f: np.asarray(getattr(jp, f)) for f in ("centroids", "list_gids", "list_codes", "codebooks")},
        device="cpu")
    r2 = rec(ivfpq_search(ivf, q, k=10, n_probe=2).ids, gt)
    r16 = rec(ivfpq_search(ivf, q, k=10, n_probe=16).ids, gt)
    assert r16 >= r2
    assert r16 > 0.15
    own = build_ivfpq(gen(2), x, n_subspaces=8, bits=6, kmeans_iters=8)
    assert rec(ivfpq_search(own, q, k=10, n_probe=16).ids, gt) > 0.15


def test_sklsh_recall(tcorpus):
    x, q, gt = tcorpus
    sk = build_sklsh(gen(3), x, n_arrays=16)
    assert rec(sklsh_search(sk, x, q, k=10, n_candidates=100).ids, gt) > 0.5


def test_mplsh_recall_and_probing(tcorpus):
    x, q, gt = tcorpus
    mp = build_mplsh(gen(4), x, n_tables=16)
    r1 = rec(mplsh_search(mp, x, q, k=10, n_probes=1).ids, gt)
    r8 = rec(mplsh_search(mp, x, q, k=10, n_probes=8).ids, gt)
    assert r8 >= r1
    assert r8 > 0.6


# ---------------------------------------------------------------------------
# JAX-built params, searched by both packages
# ---------------------------------------------------------------------------
def _pq_leaves(p):
    return {"codebooks": p.codebooks, "codes": p.codes, "rotation": p.rotation}


def _lsh_leaves(p):
    return {"lsh.projections": p.lsh.projections, "sorted_keys": p.sorted_keys,
            "sorted_ids": p.sorted_ids}


def carried():
    """name: (JAX build, its leaves, the port's params_from_numpy, (JAX search,
    port search) pairs)."""
    jax, _, jb, _ = _jax()
    return {
        "pq": (lambda x: jb.build_pq(jax.random.PRNGKey(1), x, n_subspaces=8, bits=6, kmeans_iters=8),
               _pq_leaves, pq.params_from_numpy,
               [(lambda p, x, q: jb.pq_search(p, q, k=10), lambda p, x, q: pq_search(p, q, k=10)),
                (lambda p, x, q: jb.pq_search(p, q, k=10, chunk=1000),
                 lambda p, x, q: pq_search(p, q, k=10, chunk=1000))]),
        "opq": (lambda x: jb.build_pq(jax.random.PRNGKey(1), x, n_subspaces=8, bits=5, kmeans_iters=5,
                                      opq_iters=1),
                _pq_leaves, pq.params_from_numpy,
                [(lambda p, x, q: jb.pq_search(p, q, k=10), lambda p, x, q: pq_search(p, q, k=10))]),
        "pcapq": (lambda x: jb.build_pq(jax.random.PRNGKey(1), x, n_subspaces=8, bits=5,
                                        kmeans_iters=5, pca_dim=32),
                  _pq_leaves, pq.params_from_numpy,
                  [(lambda p, x, q: jb.pq_search(p, q, k=10), lambda p, x, q: pq_search(p, q, k=10))]),
        "ivfpq": (lambda x: jb.build_ivfpq(jax.random.PRNGKey(2), x, n_subspaces=8, bits=6,
                                           kmeans_iters=8),
                  lambda p: {f: getattr(p, f) for f in ("centroids", "list_gids", "list_codes",
                                                         "codebooks")},
                  ivfpq.params_from_numpy,
                  [(lambda p, x, q, n=n: jb.ivfpq_search(p, q, k=10, n_probe=n),
                    lambda p, x, q, n=n: ivfpq_search(p, q, k=10, n_probe=n)) for n in (2, 16)]),
        "sklsh": (lambda x: jb.build_sklsh(jax.random.PRNGKey(3), x, n_arrays=16),
                  _lsh_leaves, sklsh.params_from_numpy,
                  [(lambda p, x, q, t=t: jb.sklsh_search(p, x, q, k=10, n_candidates=t),
                    lambda p, x, q, t=t: sklsh_search(p, x, q, k=10, n_candidates=t))
                   for t in (None, 100)]),
        "mplsh": (lambda x: jb.build_mplsh(jax.random.PRNGKey(4), x, n_tables=16),
                  _lsh_leaves, mplsh.params_from_numpy,
                  [(lambda p, x, q, n=n: jb.mplsh_search(p, x, q, k=10, n_probes=n),
                    lambda p, x, q, n=n: mplsh_search(p, x, q, k=10, n_probes=n)) for n in (1, 8)]),
    }


@pytest.mark.parametrize("name", ["ivfpq", "mplsh", "opq", "pcapq", "pq", "sklsh"])
def test_search_on_jax_built_params_matches_jax(name, corpus, tcorpus):
    """Ids exact, scores to rtol 1e-5 / atol 1e-6, for every search spelling."""
    x, q, _ = corpus
    xt, qt, _ = tcorpus
    build, leaves, from_numpy, searches = carried()[name]
    jp = build(x)
    tp = from_numpy({n: None if v is None else np.asarray(v) for n, v in leaves(jp).items()},
                    device="cpu")
    for jsearch, tsearch in searches:
        want, got = jsearch(jp, x, q), tsearch(tp, xt, qt)
        np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
        np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                                   rtol=SCORE_RTOL, atol=SCORE_ATOL)


def test_pq_encoding_of_jax_codebooks_is_exact(corpus, tcorpus):
    """The nearest-codeword codes (``kmeans_assign_op`` on each column
    slice) equal JAX's codes with JAX's codebooks."""
    jax, _, jb, _ = _jax()
    x, _, _ = corpus
    jp = jb.build_pq(jax.random.PRNGKey(1), x, n_subspaces=8, bits=6, kmeans_iters=8)
    tp = pq.params_from_numpy({"codebooks": np.asarray(jp.codebooks),
                               "codes": np.asarray(jp.codes)}, device="cpu")
    np.testing.assert_array_equal(_encode(tp.codebooks, tcorpus[0]).numpy(), np.asarray(jp.codes))
    assert tp.rotation is None and tp.n_subspaces == 8 and tp.n_codes == 64


# ---------------------------------------------------------------------------
# LSH key helpers
# ---------------------------------------------------------------------------
def _keys(key_len: int, seed: int):
    """Random keys below 2**key_len, with equal pairs and last-bit pairs."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2**key_len, size=512, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2**key_len, size=512, dtype=np.uint64).astype(np.uint32)
    b[:64] = a[:64]  # equal keys
    b[64:128] = a[64:128] ^ np.uint32(1)  # differ only in the last bit
    b[128:136] = a[128:136] ^ np.uint32(1 << (key_len - 1))  # differ in the first bit
    return a, b


@pytest.mark.parametrize("key_len", range(1, 32))
def test_lsh_key_helpers_match_jax(key_len):
    _, jnp, _, jlsh = _jax()
    a, b = _keys(key_len, key_len)
    ta, tb = torch.from_numpy(a.astype(np.int64)), torch.from_numpy(b.astype(np.int64))
    ja, jbk = jnp.asarray(a), jnp.asarray(b)
    np.testing.assert_array_equal(lsh.common_prefix_len(ta, tb, key_len).numpy(),
                                  np.asarray(jlsh.common_prefix_len(ja, jbk, key_len)))
    for window_bits in (1, 8, 16):
        got = lsh.dist_e(ta, tb, key_len, window_bits)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jlsh.dist_e(ja, jbk, key_len, window_bits)))
    bits = lsh.unpack_bits(ta, key_len)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jlsh.unpack_bits(ja, key_len)))
    np.testing.assert_array_equal(lsh.pack_bits(bits).numpy(), a.astype(np.int64))


def test_clz32_matches_jax_over_the_uint32_range():
    _, jnp, _, jlsh = _jax()
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.integers(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32),
        np.array([0, 1, 2**31, 2**32 - 1, 2**31 - 1], np.uint32),
        (np.uint32(1) << np.arange(32, dtype=np.uint32)),
        (np.uint32(1) << np.arange(32, dtype=np.uint32)) - np.uint32(1),
    ])
    got = lsh._clz32(torch.from_numpy(x.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jlsh._clz32(jnp.asarray(x))))


# ---------------------------------------------------------------------------
# On the card: the kernels at the baselines' shapes
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA device")
def test_lsh_hash_at_the_baselines_bank_shape():
    """H = 24 arrays of M = 20 bits (SK-LSH / MP-LSH at 1M rows), d = 768."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.lsh_hash import lsh_hash
    from repro_torch.testing import lsh_key_flips

    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((20000, 768), generator=g, device="cuda")
    p = torch.randn((768, 24 * 20), generator=g, device="cuda")
    got = lsh_hash(x, p, n_arrays=24, key_len=20)
    assert got.shape == (20000, 24) and bool((got >= 0).all()) and bool((got < 2**20).all())
    lsh_key_flips(x, p, 24, 20, got, ref.lsh_hash_ref(x, p, n_arrays=24, key_len=20))


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,h,m", [(30000, 64, 24, 15), (1000, 32, 15, 15), (513, 768, 25, 13)])
def test_lsh_hash_where_a_group_starts_off_16_bytes(n, d, h, m):
    """Tiles of 5 arrays of 15 bits put the second block group's first
    column at 150 (600 bytes): its box of P starts at column 148 and the
    group's columns 2 in (an unaligned box faulted). (30000, 64, 24, 15) is
    ``examples/serve_retrieval_torch.py``'s SK-LSH / MP-LSH corpus hash."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import ref
    from repro_torch.kernels.lsh_hash import lsh_hash
    from repro_torch.testing import lsh_key_flips

    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((n, d), generator=g, device="cuda")
    p = torch.randn((d, h * m), generator=g, device="cuda")
    got = lsh_hash(x, p, n_arrays=h, key_len=m)
    torch.cuda.synchronize()
    lsh_key_flips(x, p, h, m, got, ref.lsh_hash_ref(x, p, n_arrays=h, key_len=m))


@pytest.mark.gpu
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA device")
@pytest.mark.parametrize("case", ["pq_subspace", "ivf_coarse"])
def test_kmeans_assign_at_the_baselines_shapes(case):
    """PQ: rows a d = 96 column slice of (N, 768), c = 256; IVF-PQ: the
    full rows against c = 1,024 lists."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ops import kmeans_assign_op
    from repro_torch.testing import assignment_flips

    g = torch.Generator(device="cuda").manual_seed(1)
    full = torch.randn((20000, 768), generator=g, device="cuda")
    x = full[:, 96 * 3 : 96 * 4] if case == "pq_subspace" else full
    cen = torch.randn((256 if case == "pq_subspace" else 1024, x.shape[1]), generator=g,
                      device="cuda")
    got_a, got_d = kmeans_assign_op(x, cen)
    want_a, want_d = ref.kmeans_assign_ref(x.contiguous(), cen)
    assignment_flips(x.contiguous(), cen, got_a, want_a)
    same = got_a == want_a
    torch.testing.assert_close(got_d[same], want_d[same], rtol=1e-4, atol=1e-4)
