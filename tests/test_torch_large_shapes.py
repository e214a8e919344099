"""The shapes the port's verification kernels used to refuse: k above 4,096
for ``fused_verify`` and ``sketch_prefilter``, and block_q above 16 or k'
above 1,024 for ``fused_verify_grouped``.

On the CPU the port runs its plain versions; here they are held against
the JAX package on the same numpy inputs, its Pallas kernels in interpret
mode and its plain versions (``repro.kernels.ref``). Tolerance: none on the
integer and sketch paths (exact integer dots, the same float32 multiplies);
float32 ids equal up to swaps of near-equal scores and scores to rtol
1e-5 / atol 1e-6 (``repro_torch.testing``; ROADMAP queue 3).
The wrappers' launch plans (the workspace of the per-query kernels, the
scratch and limits of the grouped kernels) are checked against the
shapes they must take, up to the configuration's capacity of 12,288 rows a
cluster. The CUDA kernels meet these shapes in ``test_torch_kernels.py``
(marked ``gpu``) and ``chip_smoke.py``.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import quant as jquant
from repro.kernels import ref as jref
from repro.kernels import schedule as jschedule
from repro_torch.kernels import fused_verify as fv
from repro_torch.kernels import ops, quant
from repro_torch.testing import assert_topk_match

jfv = importlib.import_module("repro.kernels.fused_verify")  # the package exports a function of that name


def _t(a):
    return torch.from_numpy(np.array(a))


def _bit_equal(got, want):
    gi, gs = (np.asarray(v) for v in got)
    wi, ws = (np.asarray(v) for v in want)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gs.view(np.uint32), ws.astype(np.float32).view(np.uint32))


# (b, c, k) -> (n_chunks, chunk, large, list_len, words)
VERIFY_PLANS = {
    "in-cluster": ((256, 80_000, 100), (20, 4_000, False, 100, 256 * 20 * 201)),
    "sketch pass": ((256, 80_000, 1_600), (20, 4_000, False, 1_600, 256 * 20 * 3_201)),
    "largest shared-memory k": ((256, 80_000, 4_096), (20, 4_000, False, 4_096, 256 * 20 * 8_193)),
    "k = 6,400": ((3, 12_000, 6_400), (3, 4_000, True, 4_000, 3 * 3 * 8_001 + 2 * 3 * 6_400)),
    "covering sketch factor": ((256, 80_000, 80_000),
                               (20, 4_000, True, 4_000, 256 * 20 * 8_001 + 2 * 256 * 80_000)),
    "one chunk, k above C": ((4, 3_000, 6_400), (1, 3_000, True, 3_000, 0)),
    "rescore, one chunk": ((256, 400, 100), (1, 400, False, 100, 0)),
}


@pytest.mark.parametrize("name", sorted(VERIFY_PLANS))
def test_verify_plan(name):
    (b, c, k), want = VERIFY_PLANS[name]
    plan = fv.verify_plan(b, c, k)
    assert (plan.n_chunks, plan.chunk, plan.large, plan.list_len, plan.words) == want
    assert plan.large == (k > fv.MAX_SMEM_K)
    # A chunk's list holds every entry the chunk can keep.
    assert plan.list_len >= min(k, plan.chunk)


# (S, block_q, Lp): the grouped calls the wrapper must take. Its scratch
# holds one float32 score per slot id, so it is as large as step_slot_ids
# whatever the block_q, k' or row width; the score kernel's slot group and
# ring are chosen in the C entry point (and checked on the card).
GROUPED_PLANS = {
    "Q8-cm": (2_048, 8, 2_584),
    "Q4-sk-cm": (2_048, 8, 2_584),
    "block_q 24": (512, 24, 2_584),
    "block_q 32, k' = Lp = 12,288": (256, 32, 12_288),
    "block_q 32, int4, Lp 12,288": (256, 32, 12_288),
    "block_q 40: two slot groups": (256, 40, 2_584),
    "block_q 1": (4_096, 1, 16),
    "rows of 2,048 codes: two ring stages a tile": (64, 8, 1_024),
    "rows of 4,096 codes: fewer slots a block": (64, 32, 1_024),
}


@pytest.mark.parametrize("name", sorted(GROUPED_PLANS))
def test_grouped_plan(name):
    s, block_q, lp = GROUPED_PLANS[name]
    assert fv.grouped_scratch(s, block_q, lp) == s * block_q * lp
    assert lp <= fv.MAX_LP


def test_grouped_plan_limits():
    """Lp above MAX_LP (the select kernel's sort buffer) and empty slots or
    clusters are refused; the configuration's capacity is taken."""
    assert fv.grouped_scratch(1, 32, fv.MAX_LP) == 32 * fv.MAX_LP
    assert fv.MAX_LP >= 12_288
    with pytest.raises(ValueError, match="Lp must be at most"):
        fv.grouped_scratch(1, 8, fv.MAX_LP + 1)
    with pytest.raises(ValueError, match=">= 1"):
        fv.grouped_scratch(1, 0, 64)
    with pytest.raises(ValueError, match=">= 1"):
        fv.grouped_scratch(1, 8, 0)


def _verify_case(seed, n, d, b, c):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)  # unit rows, as the tolerance assumes
    x[7] = x[2]  # exact ties between distinct ids
    rows = rng.integers(0, n, (b, c)).astype(np.int32)
    rows[:, c // 2 :] = rows[:, : c - c // 2]  # every row twice
    out = np.where(rng.random((b, c)) < 0.2, -1, rows).astype(np.int32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return x, rows, out, q


@pytest.mark.parametrize("table", ["float32", "int8", "int4", "sketch"])
@pytest.mark.parametrize("k", [4_500, 7_000])
def test_large_k_plain_version_matches_jax(table, k):
    """k above 4,096 (and above the 6,000 distinct valid ids at k = 7,000,
    so the tail is padding): the port's plain version against the JAX
    package's on the same inputs."""
    x, rows, out, q = _verify_case(5, 12_000, 32, 2, 12_000)
    je, jr, jo, jq = (jnp.asarray(a) for a in (x, rows, out, q))
    if table == "sketch":
        got = ops.sketch_topk_op(quant.sketch_rows(_t(x)), _t(rows), _t(q), k=k, out_ids=_t(out))
        want = jref.sketch_topk_ref(jquant.sketch_rows(je), jr, jq, k=k, out_ids=jo)
    elif table == "float32":
        got = ops.verify_topk_op(_t(x), _t(rows), _t(q), k=k, out_ids=_t(out))
        want = jref.verify_topk_ref(je, jr, jq, k=k, out_ids=jo)
    else:
        quantize = jquant.quantize_rows if table == "int8" else jquant.quantize_rows_int4
        codes, scales = (np.asarray(a) for a in quantize(je))
        got = ops.verify_topk_op(_t(codes), _t(rows), _t(q), k=k, out_ids=_t(out),
                                 scales=_t(scales), code_dtype=table)
        want = jref.verify_topk_ref(jnp.asarray(codes), jr, jq, k=k, out_ids=jo,
                                    scales=jnp.asarray(scales), code_dtype=table)
    if table == "float32":
        assert_topk_match(got[0], got[1], _t(want[0]), _t(want[1]))
    else:
        _bit_equal(got, want)
    assert got[0].shape == (2, k)
    if k == 7_000:
        assert (got[0].numpy()[:, 6_500:] == -1).all()


@pytest.mark.parametrize("table", ["int8", "sketch"])
def test_large_k_plain_version_matches_pallas_kernel_interpret(table):
    """k = 4,200 on one query of 4,400 candidates (one Pallas block), against
    the JAX package's Pallas kernel in interpret mode."""
    x, rows, out, q = _verify_case(6, 5_000, 32, 1, 4_400)
    je, jr, jo, jq = (jnp.asarray(a) for a in (x, rows, out, q))
    kw = dict(k=4_200, out_ids=jo, block_c=4_400, interpret=True)
    if table == "sketch":
        want = jfv.sketch_prefilter(jquant.sketch_rows(je), jr, jq, **kw)
        got = ops.sketch_topk_op(quant.sketch_rows(_t(x)), _t(rows), _t(q), k=4_200,
                                 out_ids=_t(out))
    else:
        codes, scales = jquant.quantize_rows(je)
        want = jfv.fused_verify(codes, jr, jq, scales=scales, code_dtype="int8", **kw)
        got = ops.verify_topk_op(_t(np.asarray(codes)), _t(rows), _t(q), k=4_200,
                                 out_ids=_t(out), scales=_t(np.asarray(scales)), code_dtype="int8")
    _bit_equal(got, want)


def _grouped_case(code_dtype, *, seed, c, lp, d, b, p, block_q):
    """A Zipf schedule with padding steps and empty slots, 30% of each
    slot's rows masked, and a duplicated id whose rows are bit-equal (so the
    duplicates carry equal scores, as the contract requires)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((c, lp, d)).astype(np.float32)
    x[1, 5] = x[1, 2]
    q = rng.standard_normal((b, d)).astype(np.float32)
    fn = jquant.quantize_rows if code_dtype == "int8" else jquant.quantize_rows_int4
    codes, scales = (np.asarray(a) for a in fn(jnp.asarray(x)))
    w = 1.0 / np.arange(1, c + 1) ** 1.3
    cids = np.stack([rng.choice(c, size=p, replace=False, p=w / w.sum()) for _ in range(b)])
    sched = jschedule.build_cluster_schedule(cids.astype(np.int32), block_q=block_q)
    s = sched.sched_cids.shape[0]
    slot = np.full((s, block_q, lp), -1, np.int32)
    st, sl = np.nonzero(sched.sched_qids >= 0)
    slot[st, sl] = sched.sched_cids[st, None] * lp + np.arange(lp)
    slot[rng.random(slot.shape) < 0.3] = -1
    one = sched.sched_cids == 1
    slot[one, :, 5] = slot[one, :, 2]
    return codes, scales, q, sched.sched_cids, sched.sched_qids, slot


GROUPED_CASES = {
    # name: (case kwargs, kp)
    "block_q 24": (dict(seed=21, c=5, lp=160, d=32, b=40, p=3, block_q=24), 40),
    "k' 1,100 above 1,024": (dict(seed=22, c=3, lp=1_200, d=16, b=10, p=2, block_q=8), 1_100),
    "block_q 32, k' = Lp": (dict(seed=23, c=3, lp=1_152, d=16, b=40, p=2, block_q=32), 1_152),
}


@pytest.mark.parametrize("code_dtype", ["int8", "int4"])
@pytest.mark.parametrize("name", sorted(GROUPED_CASES))
def test_grouped_plain_version_at_large_shapes_matches_jax(name, code_dtype):
    kw, kp = GROUPED_CASES[name]
    args = _grouped_case(code_dtype, **kw)
    got = ops.verify_topk_grouped_op(*(_t(a) for a in args), kp=kp, code_dtype=code_dtype)
    want = jref.verify_topk_grouped_ref(*(jnp.asarray(a) for a in args), kp=kp,
                                        code_dtype=code_dtype)
    _bit_equal(got, want)
    assert got[0].shape == (args[3].shape[0], kw["block_q"], kp)
    assert (got[0].numpy()[args[4] < 0] == -1).all()  # empty slots and padding steps


@pytest.mark.parametrize("code_dtype", ["int8", "int4"])
def test_grouped_plain_version_at_block_q_24_matches_pallas_kernel_interpret(code_dtype):
    """block_q 24 and k' 48, against the JAX package's Pallas kernel."""
    kw, _ = GROUPED_CASES["block_q 24"]
    args = _grouped_case(code_dtype, **kw)
    want = jfv.fused_verify_grouped(*(jnp.asarray(a) for a in args), kp=48, block_q=24,
                                    block_c=80, code_dtype=code_dtype, interpret=True)
    got = ops.verify_topk_grouped_op(*(_t(a) for a in args), kp=48, code_dtype=code_dtype)
    _bit_equal(got, want)
