"""The plain reference and its judge: against an index built by hand, where
every window covers its whole array, and against the program's own tiny
index on the CPU, where the program passes and the TF32 control, put in
its place on a tiny cell's timed path, comes out not correct."""
import copy
import json
import time

import pytest
import torch

from pbench import cell, data
from pbench.reference import lider as ref
from pbench.reference import lider_index
from perfbench_tiny import BENCH, make_root

CPU = torch.device("cpu")
LIMITS = json.loads((BENCH / "limits" / "lider-msmarco.json").read_text())
BANDS = dict(band_key=LIMITS["band_key"], band_score=LIMITS["band_score"])
INDEX_BANDS = {k: LIMITS[k] for k in ("band_key", "band_dist", "pos_tol", "tol_centroid")}

HAND_CFG = {"k": 2, "n_probe": 1, "r0": 4, "r0_centroid": 2, "n_arrays": 1, "key_len": 2,
            "n_arrays_centroid": 1, "key_len_centroid": 1, "n_leaves": 1,
            "n_leaves_centroid": 1}


def hand_index():
    """Two clusters of four passages on the first two axes of R^4; every
    window covers a whole array, so routing takes the best centroid and
    verification the best two passages of its cluster."""
    near = lambda axis, tilt: data.l2_normalize(
        torch.eye(4)[axis] + torch.tensor(tilt, dtype=torch.float32))
    tilts = [[0, 0, 0.1, 0], [0, 0, 0.2, 0], [0, 0, 0, 0.3], [0, 0, 0.4, 0.1]]
    corpus = torch.stack([near(0, t) for t in tilts] + [near(1, t) for t in tilts])
    f, z1, z2 = torch.float32, torch.zeros((1,)), torch.zeros((2, 1))
    st = {
        "centroids": torch.eye(4)[:2].clone(),
        "c_sorted_keys": torch.tensor([[0, 1]]), "c_sorted_ids": torch.tensor([[0, 1]]),
        "c_key_min": torch.tensor([0]), "c_key_max": torch.tensor([1]),
        "c_length": torch.tensor([2.0]), "c_root_w": z1, "c_root_b": z1,
        "c_rmi_length": torch.tensor([2.0]), "c_leaf_w": torch.zeros((1, 1)),
        "c_leaf_b": torch.zeros((1, 1)),
        "b_gids": torch.arange(8).reshape(2, 4),
        "b_sorted_pos": torch.arange(4).repeat(2, 1, 1),
        "b_sorted_keys": torch.zeros((2, 1, 4), dtype=torch.int64),
        "b_key_min": torch.zeros((2, 1), dtype=torch.int64),
        "b_key_max": torch.zeros((2, 1), dtype=torch.int64),
        "b_length": torch.full((2, 1), 4.0, dtype=f), "b_root_w": z2, "b_root_b": z2,
        "b_rmi_length": torch.full((2, 1), 4.0, dtype=f),
        "b_leaf_w": torch.zeros((2, 1, 1)), "b_leaf_b": torch.zeros((2, 1, 1)),
    }
    proj_c = ref.draw_projections(1, 4, 1, 1, CPU)
    proj_b = ref.draw_projections(2, 4, 1, 2, CPU)
    q = data.l2_normalize(torch.tensor([[1.0, 0.1, 0.35, 0.2], [0.1, 1.0, 0.05, 0.4]]))
    return st, corpus, q, proj_c, proj_b


def _judge(ids, scores):
    st, corpus, q, pc, pb = hand_index()
    return ref.judge(st, HAND_CFG, q, corpus, pc, pb, torch.tensor(ids),
                     torch.tensor(scores, dtype=torch.float32), **BANDS)


def _best(q, corpus, rows):
    s = (q @ corpus[rows].T)
    v, i = torch.sort(s, descending=True)
    return [rows[j] for j in i[:2].tolist()], v[:2].tolist()


def test_the_exact_answer_passes_and_each_fault_is_caught():
    st, corpus, q, pc, pb = hand_index()
    i0, s0 = _best(q[0], corpus, [0, 1, 2, 3])
    i1, s1 = _best(q[1], corpus, [4, 5, 6, 7])
    good = _judge([i0, i1], [s0, s1])
    assert good["bad"] == 0 and good["score_err"] < 1e-6 and good["topk_gap"] <= 1e-7

    foreign = _judge([[i0[0], 5], i1], [[s0[0], s0[1]], s1])  # a passage of the unprobed cluster
    assert foreign["foreign"] == 1
    third = [r for r in [0, 1, 2, 3] if r not in i0]
    worse = max(third, key=lambda r: float(q[0] @ corpus[r]))
    missed = _judge([[i0[0], worse], i1], [[s0[0], float(q[0] @ corpus[worse])], s1])
    assert missed["bad"] == 0 and missed["topk_gap"] > 1e-3  # a better passage left out
    off = _judge([i0, i1], [[s0[0] + 1e-3, s0[1]], s1])
    assert abs(off["score_err"] - 1e-3) < 1e-6
    dup = _judge([[i0[0], i0[0]], i1], [[s0[0], s0[0]], s1])
    assert dup["bad"] >= 1
    short = _judge([[i0[0], -1], i1], [[s0[0], float("-inf")], s1])
    assert short["short"] == 1


def test_key_alternatives_enumerate_every_ambiguous_bit():
    keys = torch.tensor([[0b101, 0b011]])
    amb = torch.tensor([[[True, False, True], [False, False, False]]])
    rows, arrays, alts = ref.key_alternatives(keys, amb, 3)
    assert rows.tolist() == [0, 0, 0] and arrays.tolist() == [0, 0, 0]
    assert sorted(alts.tolist()) == [0b000, 0b001, 0b100]


def test_verify_work_counts_distinct_rows_by_hand():
    st, corpus, q, pc, pb = hand_index()
    tc = torch.zeros(2, dtype=torch.bool)
    tb = torch.zeros(8, dtype=torch.bool)
    w = ref.verify_work(st, HAND_CFG, q, pc, pb, tc, tb)
    # each query scores both centroids and the four rows of its cluster
    assert w == {"routing_pairs": 4, "incluster_pairs": 8}
    assert int(tc.sum()) == 2 and int(tb.sum()) == 8
    tb2 = torch.zeros_like(tb)
    w = ref.verify_work(st, HAND_CFG, q[:1], pc, pb, torch.zeros_like(tc), tb2)
    assert w["incluster_pairs"] == 4 and tb2.tolist() == [True] * 4 + [False] * 4


def test_distinct_rows_read_below_the_per_pair_count_at_the_full_size():
    # The F32 in-cluster call at 8.8M: B 256, C 80,000 candidates a query,
    # 3,072-byte rows. Distinct rows can never exceed the corpus; the
    # kernel's own cost model counts every (query, candidate) row.
    from pbench import system  # noqa: F401  (puts the program's package on the path)
    from repro_torch.kernels import cost

    b, c, d, n = 256, 80_000, 768, 8_847_360
    per_pair = cost.fused_verify(b, c, d, 100, d * 4, out_ids=True)[1]
    distinct = min(b * c, n) * d * 4 + b * d * 4 + b * 100 * 8
    assert distinct < per_pair / 2
    assert per_pair / 3.35e12 > 16.28e-3  # the per-pair count reads over 100% of 16.28 ms


SEED = 2**31 + 99


def tiny_build(cfg, corpus):
    from pbench import system

    params, _ = system.build(corpus, cfg, SEED + 2)
    return system.index_state(params), params


@pytest.fixture(scope="module")
def tiny():
    from pbench import system
    from perfbench_tiny import CONFIG

    cfg = dict(CONFIG)
    corpus = data.retrieval_corpus(SEED, cfg["corpus_size"], cfg["dim"], device=CPU)
    q = data.retrieval_queries(SEED + 1, corpus, 128)
    st, params = tiny_build(cfg, corpus)
    out = system.searcher(params, cfg)(q)
    pc = ref.draw_projections(SEED + 3, cfg["dim"], cfg["n_arrays_centroid"],
                              cfg["key_len_centroid"], CPU)
    pb = ref.draw_projections(SEED + 4, cfg["dim"], cfg["n_arrays"], cfg["key_len"], CPU)
    return cfg, st, corpus, q, pc, pb, out


def test_program_passes_and_tf32_control_fails(tiny, tmp_path):
    cfg, st, corpus, q, pc, pb, out = tiny
    good = ref.judge(st, cfg, q, corpus, pc, pb, out.ids, out.scores, **BANDS)
    assert good["bad"] == 0 and good["score_err"] < 1e-6 and good["topk_gap"] < 1e-6
    import control

    for loop in ("closed", "open"):
        res = cell.run(f"tiny-{loop}", SEED, 0.3, False, device=CPU, t_start=time.perf_counter(),
                       root=make_root(tmp_path / loop), search_hook=control.tf32_hook)
        assert res["result"]["correct"] is False
        assert res["checks"]["score_err"][0] > LIMITS["score_err"]
        assert res["checks"]["index_faults"][0] == 0  # the control searches the sound index


def test_tf32_readings_of_the_bands_lie_above_the_programs(tiny):
    cfg, st, corpus, q, pc, pb, _ = tiny
    _, sound = lider_index.check_index(st, cfg, corpus, pc, pb, SEED + 2, **INDEX_BANDS)
    bands = {k: v for k, v in INDEX_BANDS.items() if k != "tol_centroid"}
    tf32 = lider_index.tf32_readings(st, cfg, corpus, q, pc, pb, band_score=BANDS["band_score"],
                                     **bands)
    assert sound["key_flip"] < INDEX_BANDS["band_key"] < tf32["key_flip"]
    assert sound["dist_gap"] < INDEX_BANDS["band_dist"] < tf32["dist_gap"]
    assert sound["rmi_dev"] < INDEX_BANDS["pos_tol"]
    assert tf32["score_err"] > BANDS["band_score"]


def test_index_check_passes_the_build_and_catches_corruption(tiny):
    cfg, st, corpus, q, pc, pb, _ = tiny
    check = lambda s, c=cfg: lider_index.check_index(s, c, corpus, pc, pb, SEED + 2,
                                                     **INDEX_BANDS)[0]
    assert sum(check(st).values()) == 0
    swapped = copy.copy(st)
    g = st["b_gids"].clone()
    a, b = g[0, 0].item(), g[1, 0].item()
    g[0, 0], g[1, 0] = b, a  # two passages in each other's cluster
    swapped["b_gids"] = g
    faults = check(swapped)
    assert faults["partition"] > 0 and faults["layout"] > 0
    flipped = copy.copy(st)
    sk = st["b_sorted_keys"].clone()
    sk[3, 1, 0] ^= 1 << 9  # the top bit of one key
    flipped["b_sorted_keys"] = sk
    assert check(flipped)["bank_keys"] > 0
    moved = copy.copy(st)
    moved["b_leaf_b"] = st["b_leaf_b"] + 2.0  # every leaf line two slots off
    assert check(moved)["bank_rmi"] > 0


@pytest.mark.parametrize("iters", [0, 1])
def test_index_check_catches_shortened_kmeans(tiny, iters):
    # A build that left the centroids at their seeded draw, or stopped its
    # Lloyd steps early, is held to the configuration's steps.
    cfg, st, corpus, _, pc, pb, _ = tiny
    check = lambda s: lider_index.check_index(s, cfg, corpus, pc, pb, SEED + 2, **INDEX_BANDS)[1]
    sound = check(st)
    short, _ = tiny_build({**cfg, "kmeans_iters": iters}, corpus)
    got = check(short)
    assert sound["centroids_off"] == 0 and sound["centroid_dist"] < 1e-5
    assert got["centroids_off"] > cfg["n_clusters"] // 2
    assert got["centroids_off"] == sound["centroids_off_if_stopped"][iters]
