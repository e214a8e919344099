"""The benchmark's seeded inputs: the same seed gives the same data, another
seed other data."""
import numpy as np
import torch

from pbench import data

CPU = torch.device("cpu")


def test_corpus_and_queries_repeat_from_a_seed():
    seed = 2**31 + 12345  # seeds may pass 32 signed bits
    a = data.retrieval_corpus(seed, 4096, 32, device=CPU)
    b = data.retrieval_corpus(seed, 4096, 32, device=CPU)
    assert torch.equal(a, b)
    assert torch.allclose(a.norm(dim=1), torch.ones(4096), atol=1e-5)
    assert not torch.equal(a, data.retrieval_corpus(seed + 1, 4096, 32, device=CPU))
    qa = data.retrieval_queries(seed, a, 256)
    assert torch.equal(qa, data.retrieval_queries(seed, b, 256))
    assert not torch.equal(qa, data.retrieval_queries(seed + 1, a, 256))
    # each query lies near a corpus point
    assert (qa @ a.T).max(dim=1).values.min() > 0.8


def test_trace_repeats_from_a_seed():
    kw = dict(n_arrivals=5000, pool_size=4096, mean_rate=1000.0, zipf_a=1.1)
    t1, q1, n1 = data.make_trace(seed=2**31 + 7, **kw)
    t2, q2, n2 = data.make_trace(seed=2**31 + 7, **kw)
    assert np.array_equal(t1, t2) and np.array_equal(q1, q2) and np.array_equal(n1, n2)
    t3, _, _ = data.make_trace(seed=2**31 + 8, **kw)
    assert not np.array_equal(t1, t3)
    assert np.all(np.diff(t1) > 0)
    assert abs(t1[-1] - 5.0) < 0.5  # Poisson at 1,000 a second
    # Zipf: the most popular query is far above the median one
    counts = np.bincount(q1, minlength=4096)
    assert counts[0] > 20 * max(np.median(counts), 1)


def test_burst_pattern_keeps_the_count_and_squeezes_every_other_episode():
    t, _, _ = data.make_trace(seed=3, n_arrivals=1024, pool_size=64, mean_rate=100.0,
                              pattern="burst", burst_factor=4.0, episode_len=64)
    gaps = np.diff(np.concatenate([[0.0], t])).reshape(16, 64).mean(axis=1)
    assert gaps[1::2].mean() < gaps[0::2].mean() / 2
