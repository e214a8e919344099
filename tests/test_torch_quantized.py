"""The port's plain versions of the three quantized-path kernels, and its
cluster-major schedule, against the JAX package on the same numpy inputs.

The JAX side runs its Pallas kernels in interpret mode (``interpret=True``,
as ``tests/test_fused_verify.py`` and ``tests/test_sketch.py`` run them)
and its own plain versions (``repro.kernels.ref``). Tolerance: none. Ids
and scores are bit-exact (exact integer dot products or Hamming counts,
then the same float32 multiplies in the same order), and the schedule
arrays are equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import quant as jquant
from repro.kernels import ref as jref
from repro.kernels import schedule as jschedule
from repro.kernels.fused_verify import fused_verify as jfused_verify
from repro.kernels.fused_verify import fused_verify_grouped as jgrouped
from repro.kernels.fused_verify import sketch_prefilter as jsketch
from repro_torch.kernels import fused_verify as fv
from repro_torch.kernels import ops, quant, ref, schedule


def _t(a):
    return torch.from_numpy(np.array(a))


def _equal(got, want):
    gi, gs = (np.asarray(v) for v in got)
    wi, ws = (np.asarray(v) for v in want)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gs.view(np.uint32), ws.astype(np.float32).view(np.uint32))


def _case(seed, n, d, b, c, *, dup=True, tie_rows=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    if tie_rows:  # bit-equal rows: exact score ties between distinct ids
        x[7] = x[2]
        x[11] = x[2]
    x[5] = 0.0  # an all-zero row
    rows = rng.integers(0, n, (b, c)).astype(np.int32)
    if dup:
        rows[:, c // 2 :] = rows[:, : c - c // 2]
    out = np.where(rng.random((b, c)) < 0.3, -1, rows).astype(np.int32)
    out[-1] = -1  # an all-invalid row
    q = rng.standard_normal((b, d)).astype(np.float32)
    return x, rows, out, q


def _table(x, code_dtype):
    fn = jquant.quantize_rows if code_dtype == "int8" else jquant.quantize_rows_int4
    codes, scales = fn(jnp.asarray(x))
    return np.asarray(codes), np.asarray(scales)


QCASES = {
    # name: (seed, n, d, b, c, k)
    "small": (0, 40, 32, 3, 17, 5),
    "k_above_valid_count": (1, 30, 16, 2, 6, 9),
    "ties_and_duplicates": (2, 24, 32, 3, 60, 12),
    "larger": (3, 200, 64, 4, 90, 20),
}


@pytest.mark.parametrize("code_dtype", ["int8", "int4"])
@pytest.mark.parametrize("name", sorted(QCASES))
def test_quantized_plain_version_matches_jax(name, code_dtype):
    seed, n, d, b, c, k = QCASES[name]
    x, rows, out, q = _case(seed, n, d, b, c)
    codes, scales = _table(x, code_dtype)
    got = ops.verify_topk_op(
        _t(codes), _t(rows), _t(q), k=k, out_ids=_t(out), scales=_t(scales), code_dtype=code_dtype
    )
    want = jref.verify_topk_ref(
        jnp.asarray(codes), jnp.asarray(rows), jnp.asarray(q), k=k, out_ids=jnp.asarray(out),
        scales=jnp.asarray(scales), code_dtype=code_dtype,
    )
    _equal(got, want)
    assert (got[0][-1] == -1).all()


@pytest.mark.parametrize("code_dtype", ["int8", "int4"])
def test_quantized_plain_version_matches_pallas_kernel_interpret(code_dtype):
    """Against the TPU kernel itself (interpret mode): padding, duplicates,
    ties and C (21) not a multiple of block_c (8)."""
    x, rows, out, q = _case(4, 30, 32, 3, 21)
    codes, scales = _table(x, code_dtype)
    want = jfused_verify(
        jnp.asarray(codes), jnp.asarray(rows), jnp.asarray(q), k=6, out_ids=jnp.asarray(out),
        scales=jnp.asarray(scales), block_c=8, code_dtype=code_dtype, interpret=True,
    )
    got = ref.verify_topk_ref(
        _t(codes), _t(rows), _t(q), k=6, out_ids=_t(out), scales=_t(scales), code_dtype=code_dtype
    )
    _equal(got, want)


def test_int_dot_is_exact_past_float32_range():
    """Widths where int8 partial sums pass 2**24 go through float64."""
    rng = np.random.default_rng(5)
    a = rng.integers(-127, 128, (2, 3, 1500)).astype(np.int8)
    b = rng.integers(-127, 128, (2, 4, 1500)).astype(np.int8)
    a[0, 0] = 127
    b[0, 0] = 127  # 1500 * 127**2 > 2**24
    want = np.einsum("bmd,bnd->bmn", a.astype(np.int64), b.astype(np.int64))
    got = ref.int_dot(_t(a), _t(b)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.float32))


@pytest.mark.parametrize("d", [32, 33, 96])
def test_sketch_plain_version_matches_jax(d):
    x, rows, out, q = _case(6 + d, 60, d, 3, 40)
    sk = np.asarray(jquant.sketch_rows(jnp.asarray(x)))
    got = ops.sketch_topk_op(_t(sk.view(np.int32)), _t(rows), _t(q), k=9, out_ids=_t(out))
    want = jref.sketch_topk_ref(
        jnp.asarray(sk), jnp.asarray(rows), jnp.asarray(q), k=9, out_ids=jnp.asarray(out)
    )
    _equal(got, want)
    # Hamming scores are small integers: ties between distinct rows abound.
    assert len(set(got[1][0][got[0][0] >= 0].tolist())) < int((got[0][0] >= 0).sum())


def test_sketch_plain_version_matches_pallas_kernel_interpret():
    x, rows, out, q = _case(7, 50, 64, 2, 21)
    sk = np.asarray(jquant.sketch_rows(jnp.asarray(x)))
    want = jsketch(
        jnp.asarray(sk), jnp.asarray(rows), jnp.asarray(q), k=8, out_ids=jnp.asarray(out),
        block_c=8, interpret=True,
    )
    got = ref.sketch_topk_ref(_t(sk.view(np.int32)), _t(rows), _t(q), k=8, out_ids=_t(out))
    _equal(got, want)


def _zipf_cids(rng, b, p, n_clusters, a=1.3):
    w = 1.0 / np.arange(1, n_clusters + 1) ** a
    w /= w.sum()
    return np.stack(
        [rng.choice(n_clusters, size=p, replace=False, p=w) for _ in range(b)]
    ).astype(np.int32)


@pytest.mark.parametrize(
    "block_q,pad_to,prune", [(4, None, False), (8, None, True), (3, 64, True), (1, None, False)]
)
def test_build_cluster_schedule_equals_jax(block_q, pad_to, prune):
    rng = np.random.default_rng(block_q)
    cids = _zipf_cids(rng, 24, 4, 16)
    cids[3, 1] = -1  # an invalid probe
    pruned = rng.random(cids.shape) < 0.2 if prune else None
    got = schedule.build_cluster_schedule(cids, block_q=block_q, pruned=pruned, pad_to=pad_to)
    want = jschedule.build_cluster_schedule(cids, block_q=block_q, pruned=pruned, pad_to=pad_to)
    for f in ("sched_cids", "sched_qids", "pair_step", "pair_slot"):
        a, w = getattr(got, f), getattr(want, f)
        assert a.dtype == w.dtype
        np.testing.assert_array_equal(a, w)
    assert (got.n_steps, got.n_pairs, got.block_q) == (want.n_steps, want.n_pairs, want.block_q)
    assert got.sharing_ratio == want.sharing_ratio and got.n_padded_steps == want.n_padded_steps
    assert schedule._pad_pow2(37) == jschedule._pad_pow2(37) == 64
    empty = schedule.build_cluster_schedule(np.full((2, 3), -1, np.int32), block_q=4)
    assert empty.n_steps == 0 and empty.n_padded_steps == 1


def _grouped_inputs(code_dtype, seed=17, c=6, lp=16, d=32, b=5, p=3, block_q=4):
    rng = np.random.default_rng(seed)
    embs_f = rng.standard_normal((c, lp, d)).astype(np.float32)
    embs_f[0, 3] = 0.0
    embs_f[1, lp - 1] = embs_f[1, 2]  # a tie inside one cluster
    q = rng.standard_normal((b, d)).astype(np.float32)
    codes, scales = _table(embs_f, code_dtype)
    sched = jschedule.build_cluster_schedule(_zipf_cids(rng, b, p, c), block_q=block_q)
    s = sched.sched_cids.shape[0]
    slot_ids = np.full((s, block_q, lp), -1, np.int32)
    step, slot = np.nonzero(sched.sched_qids >= 0)
    slot_ids[step, slot] = sched.sched_cids[step, None] * lp + np.arange(lp)
    slot_ids[rng.random(slot_ids.shape) < 0.3] = -1  # sparse candidate masks
    return codes, scales, q, sched.sched_cids, sched.sched_qids, slot_ids


@pytest.mark.parametrize("code_dtype", ["int8", "int4"])
def test_grouped_plain_version_matches_pallas_kernel_interpret(code_dtype):
    args = _grouped_inputs(code_dtype)
    want = jgrouped(
        *(jnp.asarray(a) for a in args), kp=6, block_q=4, block_c=8, code_dtype=code_dtype,
        interpret=True,
    )
    got = ops.verify_topk_grouped_op(*(_t(a) for a in args), kp=6, code_dtype=code_dtype)
    assert got[0].shape == (args[3].shape[0], 4, 6)
    _equal(got, want)
    jr = jref.verify_topk_grouped_ref(*(jnp.asarray(a) for a in args), kp=6, code_dtype=code_dtype)
    _equal(got, jr)


@pytest.mark.parametrize("code_dtype", ["int8", "int4"])
def test_grouped_plain_version_kp_above_candidates(code_dtype):
    """kp above a slot's candidate count pads (-1, -inf); empty slots and
    padding steps come back all padding."""
    args = _grouped_inputs(code_dtype, seed=3, lp=8, block_q=3)
    got = ops.verify_topk_grouped_op(*(_t(a) for a in args), kp=8, code_dtype=code_dtype)
    want = jref.verify_topk_grouped_ref(*(jnp.asarray(a) for a in args), kp=8, code_dtype=code_dtype)
    _equal(got, want)
    empty = args[4] < 0
    assert (got[0].numpy()[empty] == -1).all()


def test_wrappers_refuse_cpu_tensors_and_bad_arguments():
    """The CUDA wrappers never take a CPU tensor (``ops`` sends those to the
    plain versions) and their launch counters do not move."""
    x, rows, out, q = _case(8, 20, 32, 1, 5)
    codes, scales = _table(x, "int8")
    sk = _t(np.asarray(jquant.sketch_rows(jnp.asarray(x))).view(np.int32))
    before = (fv.fused_verify.launches, fv.sketch_prefilter.launches, fv.fused_verify_grouped.launches)
    with pytest.raises(ValueError, match="CUDA"):
        fv.fused_verify(_t(codes), _t(rows), _t(q), k=2, scales=_t(scales))
    with pytest.raises(ValueError, match="CUDA"):
        fv.sketch_prefilter(sk, _t(rows), _t(q), k=2)
    args = _grouped_inputs("int8")
    with pytest.raises(ValueError, match="CUDA"):
        fv.fused_verify_grouped(*(_t(a) for a in args), kp=3)
    with pytest.raises(ValueError, match="requires scales"):
        fv.fused_verify(_t(codes), _t(rows), _t(q), k=2, code_dtype="int4")
    with pytest.raises(ValueError, match="code_dtype"):
        fv.fused_verify_grouped(*(_t(a) for a in args), kp=3, code_dtype="int2")
    ops.sketch_topk_op(sk, _t(rows), _t(q), k=2)
    ops.verify_topk_grouped_op(*(_t(a) for a in args), kp=3)
    after = (fv.fused_verify.launches, fv.sketch_prefilter.launches, fv.fused_verify_grouped.launches)
    assert after == before


def test_kernel_sources_name_what_they_replace():
    from repro_torch.kernels import build

    for name, symbol in (
        ("fused_verify", "fused_verify"),
        ("sketch_prefilter", "sketch_prefilter"),
        ("fused_verify_grouped", "fused_verify_grouped"),
    ):
        src = (build.CSRC / f"{name}.cu").read_text()
        assert f"repro/kernels/fused_verify.py::{symbol}" in src
        assert f'extern "C" int {name}_launch' in src
        assert '#include "topk.cuh"' in src
    assert build.sources() == [
        "fused_verify", "fused_verify_grouped", "kmeans_assign", "lsh_hash", "sketch_prefilter"
    ]
    # The shared header is part of every library's hash.
    assert build.library_path("sketch_prefilter") != build.library_path("fused_verify")
