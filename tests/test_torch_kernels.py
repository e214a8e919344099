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
    """Named for the refusal it checked before the int8 / packed-int4
    branches existed. It now checks what the quantized wrapper and the plain
    version still refuse: int4 without scales, an unknown code dtype, and
    an integer table passed without its row scales."""
    embs, ids, q = _case(10, 20, 8, 1, 5, id_lo=0)
    t = torch.from_numpy(embs)
    with pytest.raises(ValueError, match="requires scales"):
        fused_verify(t.to(torch.int8), torch.from_numpy(ids), torch.from_numpy(q), k=2, code_dtype="int4")
    with pytest.raises(ValueError, match="code_dtype"):
        fused_verify(t, torch.from_numpy(ids), torch.from_numpy(q), k=2, code_dtype="int2")
    with pytest.raises(ValueError, match="scales"):
        ref.verify_topk_ref(t.to(torch.int8), torch.from_numpy(ids), torch.from_numpy(q), k=2)
    # With its scales the same int8 table is verified on the CPU.
    codes = t.to(torch.int8)
    got = ops.verify_topk_op(codes, torch.from_numpy(ids), torch.from_numpy(q), k=2,
                             scales=torch.ones(20))
    assert got[0].shape == (1, 2)


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


def _query_keys_agree(cpu, gpu, q):
    """The queries' hash keys on the card (``lsh_hash``) against the CPU's
    (its plain version): every flipped bit within the rounding bound.
    Returns the (B,) mask of queries whose keys agree."""
    from repro_torch.testing import query_key_flips, query_keys

    same, _ = query_key_flips(cpu, q, query_keys(gpu, q.to("cuda")).cpu(), query_keys(cpu, q))
    return same


@pytest.mark.gpu
def test_cuda_search_matches_cpu_search():
    """A small index built on the CPU, moved to the card: the search there
    (the kernels) returns the CPU search's ids (the plain versions) for
    every query whose hash keys agree on the two; a query key may differ
    only by bits within float32 rounding of 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core import lider
    from repro_torch.data import synthetic
    from repro_torch.kernels.lsh_hash import lsh_hash

    x = synthetic.retrieval_corpus(0, 3000, 64, device="cpu")
    q, _ = synthetic.retrieval_queries(1, x, 32)
    cpu = lider.build_lider(0, x, lider.LiderConfig(n_clusters=16, n_probe=4), device="cpu")
    gpu = cpu.to("cuda")
    same = _query_keys_agree(cpu, gpu, q)
    want = lider.search_lider(cpu, q, k=10, n_probe=4)
    before = (fused_verify.launches, lsh_hash.launches)
    got = lider.search_lider(gpu, q, k=10, n_probe=4)
    assert (fused_verify.launches, lsh_hash.launches) == (before[0] + 2, before[1] + 2)
    assert_topk_match(got.ids[same.cuda()], got.scores[same.cuda()], want.ids[same], want.scores[same])


def _gpu_quantized_case(seed, n, d, b, c, k):
    """Edge cases on the card: duplicates, bit-equal rows (exact ties), an
    all-zero row, an all-invalid query row, dead leading tiles and k above
    the valid count."""
    embs, ids, q = _case(seed, n, d, b, c, dup=True, tie_rows=n > 13)
    embs[n // 2] = 0.0
    out = ids.copy()
    out[np.random.default_rng(seed).random(out.shape) < 0.3] = -1
    if c > 600:
        out[:, :300] = -1
    out[-1] = -1
    if k >= c:
        out[0, 3:] = -1
    return embs, ids, out, q


GPU_SHAPES = [(40, 32, 3, 17, 5), (200, 64, 4, 700, 10), (1000, 20, 5, 300, 7),
              (100, 768, 3, 1000, 300), (30, 16, 2, 6, 9), (5000, 768, 2, 4000, 400)]


def _bit_equal(got, want):
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("code_dtype", ["int8", "int4"])
def test_cuda_quantized_kernel_matches_plain_version(code_dtype):
    """int8 / packed-int4 ``fused_verify`` against its plain version on the
    card: ids and scores bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import quant

    dev = torch.device("cuda")
    for seed, (n, d, b, c, k) in enumerate(GPU_SHAPES):
        if code_dtype == "int4" and d % 2:
            continue
        embs, ids, out, q = _gpu_quantized_case(seed, n, d, b, c, k)
        qfn = quant.quantize_rows if code_dtype == "int8" else quant.quantize_rows_int4
        codes, scales = qfn(torch.from_numpy(embs).to(dev))
        args = (codes, torch.from_numpy(ids).to(dev), torch.from_numpy(q).to(dev))
        kw = dict(k=k, out_ids=torch.from_numpy(out).to(dev), scales=scales, code_dtype=code_dtype)
        got = fused_verify(*args, **kw)
        torch.cuda.synchronize()
        _bit_equal(got, ref.verify_topk_ref(*args, **kw))
        assert (got[0][-1] == -1).all().item()


@pytest.mark.gpu
def test_cuda_sketch_prefilter_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import quant
    from repro_torch.kernels.fused_verify import sketch_prefilter

    dev = torch.device("cuda")
    for seed, (n, d, b, c, k) in enumerate(GPU_SHAPES + [(3000, 768, 2, 6000, 1600)]):
        embs, ids, out, q = _gpu_quantized_case(seed, n, d, b, c, k)
        sk = quant.sketch_rows(torch.from_numpy(embs).to(dev))
        args = (sk, torch.from_numpy(ids).to(dev), torch.from_numpy(q).to(dev))
        kw = dict(k=k, out_ids=torch.from_numpy(out).to(dev))
        got = sketch_prefilter(*args, **kw)
        torch.cuda.synchronize()
        _bit_equal(got, ref.sketch_topk_ref(*args, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("code_dtype", ["int8", "int4"])
def test_cuda_grouped_kernel_matches_plain_version(code_dtype):
    """``fused_verify_grouped`` on a Zipf schedule with padding steps,
    empty slots, sparse masks, a dead leading tile and staging merges."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import quant
    from repro_torch.kernels.fused_verify import fused_verify_grouped
    from repro_torch.kernels.schedule import build_cluster_schedule

    dev = torch.device("cuda")
    for seed, (c, lp, d, b, p, block_q, kp) in enumerate(
        [(6, 16, 32, 5, 3, 4, 6), (8, 200, 64, 12, 4, 8, 40), (5, 120, 48, 9, 3, 3, 150),
         (4, 1500, 64, 6, 2, 8, 10), (16, 2584, 768, 20, 4, 8, 400)]
    ):
        rng = np.random.default_rng(seed)
        x = torch.from_numpy(rng.standard_normal((c, lp, d)).astype(np.float32)).to(dev)
        x[0, 3] = 0
        x[1, 5] = x[1, 2]
        qfn = quant.quantize_rows if code_dtype == "int8" else quant.quantize_rows_int4
        codes, scales = qfn(x)
        w = 1.0 / np.arange(1, c + 1) ** 1.3
        cids = np.stack([rng.choice(c, size=p, replace=False, p=w / w.sum()) for _ in range(b)])
        sched = build_cluster_schedule(cids.astype(np.int32), block_q=block_q)
        s = sched.sched_cids.shape[0]
        slot = np.full((s, block_q, lp), -1, np.int32)
        st, sl = np.nonzero(sched.sched_qids >= 0)
        slot[st, sl] = sched.sched_cids[st, None] * lp + np.arange(lp)
        slot[rng.random(slot.shape) < 0.4] = -1
        slot[:, :, : min(lp, 40)] = -1
        q = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32)).to(dev)
        args = (codes.contiguous(), scales, q, torch.from_numpy(sched.sched_cids).to(dev),
                torch.from_numpy(sched.sched_qids).to(dev), torch.from_numpy(slot).to(dev))
        got = fused_verify_grouped(*args, kp=kp, code_dtype=code_dtype)
        torch.cuda.synchronize()
        _bit_equal(got, ref.verify_topk_grouped_ref(*args, kp=kp, code_dtype=code_dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("storage_dtype", ["int8", "int4"])
def test_cuda_quantized_search_matches_cpu_search(storage_dtype):
    """A small quantized index built on the CPU, moved to the card: every
    spelling of the search there (kernels) returns the CPU search's ids
    (plain versions) for every query whose hash keys agree on the two (a
    key may differ only within float32 rounding); the first-pass kernels
    score bit-exactly, the float32 rescore to the stated tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core import lider
    from repro_torch.data import synthetic
    from repro_torch.kernels.fused_verify import fused_verify_grouped, sketch_prefilter

    x = synthetic.retrieval_corpus(0, 3000, 64, device="cpu")
    q, _ = synthetic.retrieval_queries(1, x, 32)
    cpu = lider.build_lider(0, x, lider.LiderConfig(n_clusters=16, n_probe=4, storage_dtype=storage_dtype),
                            device="cpu")
    gpu = cpu.to("cuda")
    same = _query_keys_agree(cpu, gpu, q)
    for kw, launches in (({}, (3, 0, 0)), ({"sketch_factor": 4}, (3, 1, 0)),
                         ({"block_q": 8}, (2, 0, 1)), ({"sketch_factor": 4, "block_q": 8}, (2, 1, 1))):
        want = lider.search_lider(cpu, q, k=10, n_probe=4, **kw)
        before = (fused_verify.launches, sketch_prefilter.launches, fused_verify_grouped.launches)
        got = lider.search_lider(gpu, q, k=10, n_probe=4, **kw)
        after = (fused_verify.launches, sketch_prefilter.launches, fused_verify_grouped.launches)
        assert tuple(a - b for a, b in zip(after, before)) == launches, kw
        assert_topk_match(got.ids[same.cuda()], got.scores[same.cuda()], want.ids[same], want.scores[same])

