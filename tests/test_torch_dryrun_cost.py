"""The dry run's cost record (``launch/dryrun.py::StepCounter``, the kernels'
reports of ``kernels/cost.py``) against XLA's ``cost_analysis()``.

- Four unit steps, the same numpy inputs through ``jax.jit(f).lower(...)
  .compile().cost_analysis()`` and through the port's counter on fake
  tensors: bytes accessed exactly, and the product's FLOPs. XLA counts an
  unfused instruction's operands and result (a gather its whole table; the
  ``relu`` after a product runs as a fusion of its own); an eager op is one
  such instruction.
- The three ``lider-msmarco`` cells on rank 0 of the single-pod grid: their
  FLOPs (all of them the kernels') equal to the kernel calls' formulas from
  the cell's shapes, and their bytes: the kernels' and collectives' reports,
  and every op's around them, each equal to a formula from the cell's
  shapes. JAX's records of the same cells (its package on the CPU, rank 0,
  ``--mesh single``), beside the port's:

  ========================  ============  ==================  =========================
  cell                      JAX flops     JAX bytes accessed  why the port differs
  ========================  ============  ==================  =========================
  serve_online              3.026e8       3.545e9             XLA counts elementwise
                                                              FLOPs, and the whole bank
                                                              table under its verify
                                                              gather; the kernel reads
                                                              the gathered rows only
  serve_bulk                9.720e9       3.736e10            the same
  build_kmeans_step         6.928e9       1.858e9             XLA counts one loop body
                                                              (x ``loop_factor`` 135);
                                                              the port the whole step
  ========================  ============  ==================  =========================
"""
import math

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import ARCHS
from repro_torch import counting
from repro_torch.launch import dryrun, mesh

rng = np.random.default_rng(0)
X = rng.standard_normal((256, 768)).astype(np.float32)
W = rng.standard_normal((768, 160)).astype(np.float32)
B = rng.standard_normal((256, 768)).astype(np.float32)
TABLE = rng.standard_normal((10_000, 768)).astype(np.float32)
IDS = rng.integers(0, 10_000, (256, 20)).astype(np.int32)

UNIT = {  # name -> (inputs, the step in jax.numpy and in torch)
    "matmul": ((X, W), lambda x, w: x @ w, lambda x, w: x @ w),
    "add": ((X, B), lambda a, b: a + b, lambda a, b: a + b),
    "gather": ((TABLE, IDS), lambda t, i: t[i], lambda t, i: t[i]),
    "relu_matmul": ((X, W), None, lambda x, w: torch.relu(x @ w)),
}


@pytest.fixture(scope="module")
def xla():
    """{step: (flops, bytes accessed)} from XLA's cost analysis on the CPU."""
    import jax
    import jax.numpy as jnp

    out = {}
    for name, (inputs, jfn, _) in UNIT.items():
        fn = jfn or (lambda x, w: jax.nn.relu(x @ w))
        c = jax.jit(fn).lower(*map(jnp.asarray, inputs)).compile().cost_analysis()
        c = c[0] if isinstance(c, (list, tuple)) else c
        out[name] = (c["flops"], c["bytes accessed"])
    return out


def _port(step, inputs):
    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(torch.from_numpy(a)) for a in inputs]
        counter = dryrun.StepCounter()
        with counting.counting(counter), counter:
            step(*fake)
    return counter.flops, counter.bytes_accessed


@pytest.mark.parametrize("name", list(UNIT))
def test_unit_steps_match_xla_cost_analysis(xla, name):
    inputs, _, tfn = UNIT[name]
    flops, nbytes = _port(tfn, inputs)
    want_flops, want_bytes = xla[name]
    assert nbytes == want_bytes
    if name in ("matmul", "relu_matmul"):  # the product's; XLA adds the relu's elements
        assert flops == xla["matmul"][0] == 2 * 256 * 768 * 160
    else:
        assert flops == 0  # elementwise ops and gathers: no FLOPs in torch's formulas


# ---------------------------------------------------------------------------
# The lider-msmarco cells
# ---------------------------------------------------------------------------


class _Reports:
    """A counter of the kernels' and collectives' reports alone."""

    def __init__(self):
        self.flops = self.bytes = 0

    def add(self, flops, nbytes):
        self.flops += flops
        self.bytes += nbytes


def _rescale(n: int, m: int) -> int:
    """``rescale`` of n int64 keys against m (broadcast) key_min, key_max and
    length: the bytes of each op's operands and result."""
    return (3 * (16 * n + 8 * m)  # maximum, minimum, sub of the keys
            + 12 * n + 24 * m + 12 * m  # diff to float32; kmax - kmin, to float32
            + 8 * m + 8 * m + 8 * m  # clamp(span); length - 1; clamp(hi)
            + 3 * (8 * n + 4 * m) + 8 * n)  # div, mul, minimum; clamp


def _predict_banked(n: int, m: int, leaves: int) -> int:
    """``rmi.predict_banked`` of n keys, its root and length broadcast from m,
    its leaves gathered from n x leaves."""
    return (16 * m + 2 * (8 * n + 4 * m) + 8 * n + (8 * n + 4 * m)  # hi; root; clamp; min
            + 8 * n + 8 * m + (8 * n + 4 * m) + 8 * n  # * leaves; clamp(length); div; floor
            + 12 * n + 16 * n  # to int64; clamp
            + 2 * (4 * n * leaves + 12 * n)  # the two gathers
            + 24 * n + 8 * n + (8 * n + 4 * m))  # lw * x + lb; clamp; minimum


def _dedup_topk(rows: int, c: int, k: int) -> int:
    """``utils.dedup_topk`` of (rows, c) int32 ids and float32 scores."""
    n, o = rows * c, rows * k
    return (12 * n + 24 * n + 16 * n + 16 * rows + 16 * n  # to int64; sort; gather; pad; cat
            + 17 * n + 9 * n + 3 * n + 4 + (9 * n + 4)  # eq; lt; or; the scalar; where
            + 16 * n + 8 * n + 16 * o + 5 * o  # sort by score; gather; isneginf
            + 8 + (17 * o + 8) + 12 * o)  # the scalar; where; to int32


def _serve_formula(rcfg, batch: int, n_data: int = 16, n_model: int = 16) -> tuple[int, int, int]:
    """FLOPs, reported bytes and every op's bytes of one rank's sharded
    search. Its B / model queries are hashed by the centroid model and
    verified against H_c windows of r0_c n_probe centroids (top n_probe).
    Its capacity of (query, probe) pairs is hashed by the bank and verified
    against H windows of r0 k rows (top k, gids as the output ids). The
    merge's all-gather of (B_loc, 2k) int32 runs over the 16 data ranks, and
    the drops' all-reduce after it. Around the kernels, op by op
    (``distributed.make_sharded_search``): the centroid model's rescale, RMI
    and windows; the dispatch of pairs to this shard; the bank's rescale,
    RMI and windows; the per-pair results scattered back to their queries,
    deduplicated, packed, gathered, deduplicated again."""
    cfg, d, k = rcfg.lider, rcfg.dim, rcfg.k
    b = batch // n_model
    pairs = b * cfg.n_probe
    cap = min(pairs, math.ceil(pairs / n_data * 2.0))
    hc, mc, h, m = cfg.n_arrays_centroid, cfg.key_len_centroid, cfg.n_arrays, cfg.key_len
    w_route = min(cfg.r0_centroid * cfg.n_probe, cfg.n_clusters)
    c_route = hc * w_route
    r = min(cfg.r0 * k, rcfg.capacity)
    c_bank = h * r
    flops = (2 * b * d * hc * mc + 2 * d * b * c_route
             + 2 * cap * d * h * m + 2 * d * cap * c_bank)
    kernels = (b * d * 4 + d * hc * mc * 4 + b * hc * 4  # lsh_hash, centroids
               + b * c_route * (4 * d + 4) + b * d * 4 + b * cfg.n_probe * 8  # fused_verify
               + cap * d * 4 + d * h * m * 4 + cap * h * 4  # lsh_hash, bank
               + cap * c_bank * (4 * d + 4 + 4) + cap * d * 4 + cap * k * 8)  # + out ids
    gather = b * 2 * k * 4
    collectives = gather + n_data * gather + 2 * 8  # all-gather in and out; the drops

    c_loc, lp = cfg.n_clusters // n_data, rcfg.capacity
    n = hc * b  # the centroid model's keys, (H_c, B_loc)
    route = (16 * n + _rescale(n, hc) + _predict_banked(n, hc, cfg.n_leaves_centroid)
             + 8 * n + 12 * n + 32 * n  # round, to int64, sub, clamp
             + 8 * w_route + (8 * n + 8 * w_route + 8 * n * w_route)  # arange; window rows
             + (4 * hc * cfg.n_clusters + 12 * n * w_route)  # gather of the sorted ids
             + 8 * n * w_route)  # (H, B, R) -> (B, H R)
    p = pairs
    dispatch = (12 * p + 9 * p + 16 * p + 8 + (17 * p + 8)  # to int64; ge; div; where
                + 9 * p + 2 * p + 5 * p + 16 * p  # eq; not; to int32; stable sort
                + (p + 9 * cap) + (8 * p + 16 * cap) + 16 * cap  # mine[sel]; flat[sel]; sub
                + 8 + (17 * cap + 8) + 12 * cap + 16 * cap  # where; to int32; div
                + (4 * b * d + 8 * cap + 4 * cap * d)  # q_loc[...]
                + (p + 8) + (cap + 8) + 24)  # the drops
    n = cap * h  # the bank's keys, (cap, 1, H)
    nr = n * r
    take = 2 * (8 * c_loc * h + 8 * cap + 8 * n) + (4 * c_loc * h + 8 * cap + 4 * n)
    take += 3 * (4 * c_loc * h + 8 * cap + 4 * n) + 3 * (4 * c_loc * h * cfg.n_leaves
                                                        + 8 * cap + 4 * n * cfg.n_leaves)
    bank = (12 * cap + 16 * cap + 5 * cap + take  # safe_cid; cvalid; the rescale and RMI rows
            + _rescale(n, n) + _predict_banked(n, n, cfg.n_leaves)
            + 8 * h + 16 * cap + (8 * cap + 8 * h + 8 * n) + 16 * n  # base
            + 8 * n + 12 * n + 32 * n  # round, to int64, sub, clamp
            + 8 * r + (8 * n + 8 * r + 8 * nr) + (8 * n + 16 * nr)  # arange; idx; base + idx
            + (4 * c_loc * h * lp + 12 * nr)  # sorted_pos gathered
            + 5 * nr + (2 * nr + cap) + 16 * cap  # valid; flat rows
            + 12 * nr + 16 * nr + (8 * cap + 16 * nr)  # to int64; clamp; + cluster * Lp
            + (4 * c_loc * lp + 12 * nr)  # gids gathered
            + 4 + (9 * nr + 4) + 12 * nr)  # where; to int32
    scatter = 2 * (8 + (17 * cap + 8) + 4 * (p + 1) * k  # where; full
                   + 8 * (p + 1) * k + 8 * cap + 4 * cap * k)  # index_put_
    merge = 16 * b * k + 2 * 8 * n_data * b * k  # pack; the gathered halves made contiguous
    ops = (route + dispatch + bank + scatter + _dedup_topk(b, cfg.n_probe * k, k) + merge
           + _dedup_topk(b, n_data * k, k) + 16)  # the drops x alive
    return flops, kernels + collectives, kernels + collectives + ops


def _kmeans_formula(rcfg, n_data: int = 16) -> tuple[int, int, int]:
    """FLOPs, reported bytes and every op's bytes of one rank's Lloyd step
    over its N / 16 rows (``distributed.make_sharded_kmeans_step``)."""
    n, c, d = rcfg.corpus_size // n_data, rcfg.lider.n_clusters, rcfg.dim
    kernel = (n * d + c * d) * 4 + n * 8
    collectives = 2 * c * d * 4 + 2 * c * 4
    ops = (12 * n  # the int32 assignment to int64
           + 4 * c * d  # zeros (c, d)
           + 2 * 4 * c * d + 8 * n + 4 * n * d  # sums.index_add_ (sums read and written)
           + 8 * c + 16 * n  # zeros (c,) int64, ones_like(idx)
           + 16 * c + 16 * n  # counts.index_add_
           + 12 * c  # counts to float32
           + 8 * c  # clamp(counts, 1)
           + 8 * c * d + 4 * c  # sums / counts
           + 5 * c  # counts > 0.5
           + c + 12 * c * d)  # where(mask, new, centroids)
    return 2 * n * c * d, kernel + collectives, kernel + collectives + ops


@pytest.fixture(scope="module")
def lider_cells():
    arch = ARCHS["lider-msmarco"]
    out = {}
    with mesh.fake_world(256):
        grid = mesh.make_production_grid(device="cpu")
        for shape in ("serve_online", "serve_bulk", "build_kmeans_step"):
            reports = _Reports()
            with counting.counting(reports):
                rec = dryrun.run_cell("lider-msmarco", shape, grid, "single_pod_16x16",
                                      device=torch.device("cpu"))
            out[shape] = (rec, reports, arch.shape(shape))
    return arch.config, out


@pytest.mark.parametrize("shape", ["serve_online", "serve_bulk", "build_kmeans_step"])
def test_lider_cells_count_the_kernels(lider_cells, shape):
    rcfg, cells = lider_cells
    rec, reports, spec = cells[shape]
    assert rec["status"] == "ok", rec.get("traceback")
    flops, nbytes = rec["cost"]["flops"], rec["cost"]["bytes_accessed"]
    if shape == "build_kmeans_step":
        want_flops, want_reported, want_bytes = _kmeans_formula(rcfg)
    else:
        want_flops, want_reported, want_bytes = _serve_formula(rcfg, spec.dims["batch"])
    assert nbytes == want_bytes
    assert flops == want_flops > 0
    assert (reports.flops, reports.bytes) == (want_flops, want_reported)
