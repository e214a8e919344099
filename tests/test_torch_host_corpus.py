"""On the card: a build from a corpus in host memory, and the rescore
table's crossings between the card and host memory.

A corpus given to ``build_lider`` on the card as a CPU tensor or a numpy
array stays in host memory: ``bank.pack_bank`` gathers each chunk of
clusters' rows there into its pinned buffer, and on the host tier writes
each chunk of the rescore table back through it
(``bank.copy_through_pinned``). The chunks (``_PACK_ROWS`` slots) do not
divide c, and ``_STAGING_BYTES`` is cut so that ``set_rescore_tier``'s
copies cross through a pinned buffer of two clusters' rows. Every leaf must
equal, bit for bit, the device-tier build from the same corpus on the card
in one chunk. The pack's equality with the JAX package's build is held on
the CPU (``tests/test_torch_lider_quantized.py::test_chunked_build_matches_jax``).
"""
import pytest
import torch

from repro_torch.core import bank, lider
from repro_torch.data import synthetic
from repro_torch.training import checkpoint

CFG = dict(n_clusters=10, n_probe=3, n_arrays=6, key_len=11, n_arrays_centroid=4,
           key_len_centroid=5, n_leaves=5, n_leaves_centroid=4, kmeans_iters=5)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)


def _assert_leaves_equal(got, want) -> None:
    got, want = dict(checkpoint.index_leaves(got)), dict(checkpoint.index_leaves(want))
    assert sorted(got) == sorted(want)
    differ = [n for n in want if got[n].dtype != want[n].dtype or not torch.equal(_bits(got[n]), _bits(want[n]))]
    assert differ == []


@pytest.mark.gpu
@pytest.mark.parametrize("storage_dtype,tier", [
    ("float32", "device"), ("int8", "device"), ("int8", "host"), ("int4", "device"), ("int4", "host"),
])
def test_host_corpus_build_on_the_card(storage_dtype, tier, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = synthetic.retrieval_corpus(6, 3000, 64, device="cpu")
    want = lider.build_lider(0, x.cuda(), lider.LiderConfig(**CFG, storage_dtype=storage_dtype),
                             device="cuda")
    lp = want.capacity
    assert bank.pack_chunks(10, lp) == [(0, 10)]
    monkeypatch.setattr(bank, "_PACK_ROWS", 3 * lp + lp // 2)
    assert [e - s for s, e in bank.pack_chunks(10, lp)] == [3, 3, 3, 1]
    monkeypatch.setattr(bank, "_STAGING_BYTES", 2 * lp * 64 * 4 + 4)
    cfg = lider.LiderConfig(**CFG, storage_dtype=storage_dtype, rescore_tier=tier)
    for corpus in (x, x.numpy()):
        got = lider.build_lider(0, corpus, cfg, device="cuda")
        assert got.bank.rescore_tier == tier and got.bank.embs.is_cuda
        if tier == "host":
            assert got.bank.rescore_embs is None and got.bank.store.rescore.device.type == "cpu"
            _assert_leaves_equal(got, lider.set_rescore_tier(want, "host"))
            got = lider.set_rescore_tier(got, "device")
            assert got.bank.rescore_embs.is_cuda
        _assert_leaves_equal(got, want)
