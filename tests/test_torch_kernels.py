"""The port's verification kernel and its plain version, held against the
JAX package's on the same numpy inputs.

On the CPU the port's ``verify_topk_op`` runs its plain version
(``ref.verify_topk_ref``); the CUDA kernel is checked by the test marked
``gpu``, which skips without a card. JAX is imported inside the tests that
use it, so this file also collects on a machine that has only PyTorch.
Tolerances: ids exact (up to swaps of near-equal scores, see
``repro_torch.testing``); scores rtol 1e-5 / atol 1e-6 (float32
accumulation in both, different summation order).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.fused_verify import fused_verify
from repro_torch.testing import SCORE_ATOL, SCORE_RTOL, assert_topk_match


def _jax():
    import jax.numpy as jnp
    from repro.kernels import fused_verify as jax_fused_verify
    from repro.kernels import ref as jax_ref

    return jnp, jax_ref, jax_fused_verify


def _case(seed, n, d, b, c, *, id_lo=-1, dup=False, tie_rows=False):
    rng = np.random.default_rng(seed)
    embs = rng.standard_normal((n, d), dtype=np.float32)
    if tie_rows:  # bit-equal rows -> exact score ties between distinct ids
        embs[7] = embs[2]
        embs[13] = embs[2]
    ids = rng.integers(id_lo, n, (b, c)).astype(np.int32)
    if dup:
        ids[:, c // 2 :] = ids[:, : c - c // 2]
    q = rng.standard_normal((b, d), dtype=np.float32)
    return embs, ids, q


def _port(embs, ids, q, k, dtype, out_ids=None):
    t = torch.from_numpy(embs).to(dtype)
    o = None if out_ids is None else torch.from_numpy(out_ids)
    gi, gs = ops.verify_topk_op(t, torch.from_numpy(ids), torch.from_numpy(q), k=k, out_ids=o)
    return gi.numpy(), gs.numpy()


def _reference(embs, ids, q, k, dtype, out_ids=None):
    jnp, jax_ref, _ = _jax()
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    wi, ws = jax_ref.verify_topk_ref(
        jnp.asarray(embs).astype(jdt), jnp.asarray(ids), jnp.asarray(q), k=k,
        out_ids=None if out_ids is None else jnp.asarray(out_ids),
    )
    return np.asarray(wi), np.asarray(ws, dtype=np.float32)


CASES = {
    # name: (seed, n, d, b, c, k, case kwargs)
    "padding": (0, 40, 32, 3, 17, 5, {}),
    "duplicates": (1, 25, 16, 2, 12, 6, {"id_lo": 0, "dup": True}),
    "ties_to_smallest_id": (2, 20, 16, 2, 30, 8, {"id_lo": 0, "tie_rows": True}),
    "c_not_multiple_of_block": (3, 50, 16, 2, 21, 4, {}),
    "k_above_valid_count": (4, 30, 16, 2, 6, 9, {}),
    "larger": (5, 200, 64, 4, 70, 10, {}),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_matches_jax_reference(name, dtype):
    seed, n, d, b, c, k, kw = CASES[name]
    embs, ids, q = _case(seed, n, d, b, c, **kw)
    if name == "k_above_valid_count":
        ids[:, 3:] = -1
    if name == "ties_to_smallest_id":
        ids[0, :4] = [13, 2, 7, 13]
    gi, gs = _port(embs, ids, q, k, dtype)
    wi, ws = _reference(embs, ids, q, k, dtype)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gs, ws, rtol=SCORE_RTOL, atol=SCORE_ATOL)
    for row in gi:  # every id at most once
        v = row[row >= 0]
        assert len(set(v.tolist())) == len(v)
    if name == "k_above_valid_count":
        assert (gi[:, 3:] == -1).all() and np.isneginf(gs[:, 3:]).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_plain_version_out_ids_mapping(dtype):
    """row_ids gather rows; out_ids name and dedup them (LIDER's shape)."""
    embs, rows, q = _case(6, 40, 16, 3, 10, id_lo=0)
    out_ids = rows + 100
    out_ids[:, 1] = -1
    gi, gs = _port(embs, rows, q, 4, dtype, out_ids=out_ids)
    wi, ws = _reference(embs, rows, q, 4, dtype, out_ids=out_ids)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gs, ws, rtol=SCORE_RTOL, atol=SCORE_ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_plain_version_matches_pallas_kernel_interpret(dtype):
    """At a tiny shape, against the TPU kernel itself in interpret mode:
    padding, duplicates and C (21) not a multiple of block_c (8)."""
    jnp, _, jax_fused_verify = _jax()
    embs, ids, q = _case(7, 30, 16, 2, 21, dup=True)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    wi, ws = jax_fused_verify(
        jnp.asarray(embs).astype(jdt), jnp.asarray(ids), jnp.asarray(q),
        k=6, block_c=8, interpret=True,
    )
    gi, gs = _port(embs, ids, q, 6, dtype)
    np.testing.assert_array_equal(gi, np.asarray(wi))
    np.testing.assert_allclose(gs, np.asarray(ws), rtol=SCORE_RTOL, atol=SCORE_ATOL)


def test_all_invalid_row_returns_padding():
    embs, ids, q = _case(8, 20, 8, 2, 9)
    ids[1] = -1
    gi, gs = _port(embs, ids, q, 4, torch.float32)
    assert (gi[1] == -1).all() and np.isneginf(gs[1]).all()
    assert (gi[0] >= 0).any()


def test_cpu_tensors_never_reach_the_kernel():
    """The CUDA wrapper refuses CPU tensors (ops sends them to the plain
    version), and its launch counter does not move."""
    embs, ids, q = _case(9, 20, 8, 1, 5, id_lo=0)
    before = fused_verify.launches
    with pytest.raises(ValueError, match="CUDA"):
        fused_verify(torch.from_numpy(embs), torch.from_numpy(ids), torch.from_numpy(q), k=2)
    _port(embs, ids, q, 2, torch.float32)
    assert fused_verify.launches == before


def test_quantized_branches_are_not_ported_yet():
    embs, ids, q = _case(10, 20, 8, 1, 5, id_lo=0)
    t = torch.from_numpy(embs)
    with pytest.raises(NotImplementedError, match="next"):
        fused_verify(t, torch.from_numpy(ids), torch.from_numpy(q), k=2, scales=torch.ones(20))
    with pytest.raises(NotImplementedError):
        fused_verify(t, torch.from_numpy(ids), torch.from_numpy(q), k=2, code_dtype="int4")
    with pytest.raises(NotImplementedError, match="quantized"):
        ref.verify_topk_ref(t.to(torch.int8), torch.from_numpy(ids), torch.from_numpy(q), k=2)


def test_kernel_source_names_what_it_replaces():
    from repro_torch.kernels import build

    src = (build.CSRC / "fused_verify.cu").read_text()
    assert "repro/kernels/fused_verify.py::fused_verify" in src
    assert 'extern "C" int fused_verify_launch' in src
    assert build.library_path("fused_verify").name.startswith("libfused_verify-")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_kernel_matches_plain_version(dtype):
    """The CUDA kernel against its plain version on the card: padding,
    duplicates, ties, an all-invalid row, k above the valid count, C not a
    multiple of the merge tile, and d not a multiple of the vector width."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    for seed, (n, d, b, c, k) in enumerate(
        [(40, 32, 3, 17, 5), (25, 16, 2, 12, 6), (200, 64, 4, 700, 10),
         (1000, 20, 5, 300, 7), (100, 768, 3, 1000, 300), (30, 16, 2, 6, 9)]
    ):
        embs, ids, q = _case(seed, n, d, b, c, dup=True, tie_rows=n > 13)
        embs /= np.linalg.norm(embs, axis=1, keepdims=True)  # scores in [-|q|, |q|]
        ids[-1] = -1
        t = torch.from_numpy(embs).to(dev).to(dtype)
        gi, gs = fused_verify(t, torch.from_numpy(ids).to(dev), torch.from_numpy(q).to(dev), k=k)
        torch.cuda.synchronize()
        wi, ws = ref.verify_topk_ref(t, torch.from_numpy(ids).to(dev), torch.from_numpy(q).to(dev), k=k)
        assert_topk_match(gi, gs, wi, ws)
        assert (gi[-1] == -1).all().item()


@pytest.mark.gpu
def test_cuda_search_matches_cpu_search():
    """A small index built on the CPU, moved to the card: the search there
    (the kernel) returns the CPU search's ids (the plain version)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core import lider
    from repro_torch.data import synthetic

    x = synthetic.retrieval_corpus(0, 3000, 64, device="cpu")
    q, _ = synthetic.retrieval_queries(1, x, 32)
    cpu = lider.build_lider(0, x, lider.LiderConfig(n_clusters=16, n_probe=4), device="cpu")
    want = lider.search_lider(cpu, q, k=10, n_probe=4)
    before = fused_verify.launches
    got = lider.search_lider(cpu.to("cuda"), q, k=10, n_probe=4)
    assert fused_verify.launches == before + 2
    assert_topk_match(got.ids, got.scores, want.ids, want.scores)
