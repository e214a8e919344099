"""The port's training entry points on the CPU.

- ``repro_torch.launch.train.main([...])`` for the smoke preset of each of
  the five LM architectures (finite loss and grad norm: the train half of
  ``tests/test_arch_smoke.py::test_lm_arch_smoke``), and a run resumed from
  ``--ckpt-dir`` that ends where the uninterrupted run ends, bit for bit.
- The same for each recsys and GNN architecture, started from the JAX
  package's ``build_task`` weights and batches: the first logged loss is
  JAX's loss on that batch (rtol 1e-5).
- The registry: the port's ``ARCHS`` and ``ASSIGNED`` are the JAX
  package's, configs equal; without a card and without ``--device cpu``
  the launcher raises.
- ``examples/train_encoder_e2e_torch.py`` at its ``tiny`` preset end to
  end (the contrastive loss falls, LIDER's recall@10 against Flat), a
  preempted run equal to the uninterrupted one bit for bit, and its
  ``encode`` on JAX-initialised weights equal to the JAX example's
  ``encode`` (rtol 1e-5, and 1e-5 of the largest magnitude near zero).
- On the card (``gpu``-marked): the loss and every gradient of a reduced
  dense and a reduced MoE config with local windows, and of the reduced
  recsys and GNN configs, equal to the CPU's
  (``repro_torch.testing.card_against_cpu``); the prefill and decode
  logits of the two LM configs equal to the CPU's
  (``repro_torch.testing.serve_card_against_cpu``); and a preempted run
  equal to the uninterrupted one bit for bit under deterministic
  algorithms.

JAX is imported inside the tests that compare with it, so the file
collects on the card, where there is no JAX.
"""
import dataclasses
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import testing
from repro_torch.configs import ARCHS, ASSIGNED, get_arch
from repro_torch.launch import train
from repro_torch.models import transformer as tfm
from repro_torch.training import checkpoint as ckpt

LM_ARCHS = sorted(a for a, spec in ARCHS.items() if spec.family == "lm")
NEW_FAMILIES = sorted(a for a, spec in ARCHS.items() if spec.family in ("recsys", "gnn"))
SMOKE = ["--device", "cpu", "--batch", "2", "--seq", "32"]


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads a test: the models here are small, and the test
    workers share the machine's cores (eight threads a worker run these
    files twice as slowly even alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_lm_arch_smoke_trains(arch_id):
    arch = get_arch(arch_id)
    cfg = train.reduced_lm(arch.config)
    assert (cfg.moe is None) == (arch.config.moe is None)
    assert cfg.window == arch.config.window and cfg.dtype == torch.float32
    hist = train.main(["--arch", arch_id, "--steps", "2"] + SMOKE)
    assert [h["step"] for h in hist] == [0, 1]
    for h in hist:
        assert np.isfinite(h["loss"]) and h["loss"] > 0 and np.isfinite(h["grad_norm"])


def test_resume_from_ckpt_dir(tmp_path):
    d = str(tmp_path / "ckpt")
    args = ["--arch", "qwen2.5-3b", "--steps", "6", "--ckpt-dir", d, "--ckpt-every", "2"] + SMOKE
    full = train.main(args)
    assert sorted(os.listdir(d)) == ["step_00000002", "step_00000004", "step_00000006"]
    final = tmp_path / "final"
    shutil.copytree(os.path.join(d, "step_00000006"), final)
    for s in ("step_00000004", "step_00000006"):
        shutil.rmtree(os.path.join(d, s))
    resumed = train.main(args)  # from step 2: steps 2..5 again
    assert resumed[-1] == full[-1]  # the last step's loss, grad norm and lr, exactly
    for name in sorted(os.listdir(final)):
        assert (final / name).read_bytes() == Path(d, "step_00000006", name).read_bytes(), name


def test_registry_matches_jax():
    from repro.configs import ARCHS as JAX_ARCHS
    from repro.configs import ASSIGNED as JAX_ASSIGNED
    from test_torch_gnn import port_cfg as gnn_cfg
    from test_torch_models import port_cfg
    from test_torch_recsys import port_cfg as recsys_cfg

    assert list(ARCHS) == list(JAX_ARCHS) and ASSIGNED == JAX_ASSIGNED
    convert = {"lm": port_cfg, "recsys": recsys_cfg, "gnn": gnn_cfg}
    for a in ARCHS:
        spec, jspec = ARCHS[a], JAX_ARCHS[a]
        shapes = lambda s: [dataclasses.astuple(x) for x in s.shapes]
        assert (spec.family, shapes(spec), spec.skip_shapes, spec.source) == (
            jspec.family, shapes(jspec), jspec.skip_shapes, jspec.source)
        if spec.family in convert:
            assert spec.config == convert[spec.family](jspec.config)
    jl = JAX_ARCHS["lider-msmarco"].config
    pl = ARCHS["lider-msmarco"].config
    assert (pl.corpus_size, pl.dim, pl.capacity, pl.k) == (jl.corpus_size, jl.dim, jl.capacity, jl.k)
    for f in dataclasses.fields(pl.lider):
        if hasattr(jl.lider, f.name):
            assert getattr(pl.lider, f.name) == getattr(jl.lider, f.name), f.name


@pytest.mark.parametrize("arch_id", NEW_FAMILIES)
def test_new_family_trains_from_jax_start(arch_id, monkeypatch):
    """``main`` on the smoke preset, its model holding the weights of JAX's
    ``build_task`` and its batches JAX's: the first step's loss is JAX's
    loss on that batch, and the run's losses and norms are finite."""
    import jax

    from repro.launch.train import build_task as jbuild_task
    from repro_torch.data import synthetic

    jparams, jloss_fn, jbatch_at = jbuild_task(arch_id, "smoke", 8, 32)
    want = float(jloss_fn(jparams, jbatch_at(0)))
    tree = jax.tree.map(np.array, jparams)
    lib = train.recsys_lib if ARCHS[arch_id].family == "recsys" else train.gnn_lib
    as_torch = lambda b: {k: torch.from_numpy(np.array(v)) for k, v in b.items()}
    monkeypatch.setattr(lib, "init", lambda seed, cfg, device=None:
                        lib.params_from_numpy(tree, cfg, device=device))
    monkeypatch.setattr(synthetic, "recsys_batch", lambda seed, step, **kw: as_torch(jbatch_at(step)))
    monkeypatch.setattr(synthetic, "random_graph", lambda *a, **kw: as_torch(jbatch_at(0)))
    hist = train.main(["--arch", arch_id, "--steps", "2"] + SMOKE + ["--batch", "8"])
    assert [h["step"] for h in hist] == [0, 1]
    np.testing.assert_allclose(hist[0]["loss"], want, rtol=1e-5)
    for h in hist:
        assert np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])


def test_no_card_no_cpu_flag_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the launcher runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "qwen2.5-3b", "--steps", "1"])


def test_encoder_example_end_to_end():
    ex = testing.load_example("train_encoder_e2e_torch")
    out = ex.main(["--device", "cpu", "--steps", "40", "--batch", "32", "--corpus", "1024"])
    losses = out["losses"]
    assert len(losses) == 40
    assert np.mean(losses[-10:]) < 0.7 * losses[0]
    assert out["recall_at_k"] >= 0.8 and 0.0 < out["mrr"] <= 1.0


def test_encoder_example_restart_is_exact(tmp_path):
    ex = testing.load_example("train_encoder_e2e_torch")
    kw = dict(steps=12, batch=8, seq=16, device="cpu")
    a, la, _ = ex.train(ex.PRESETS["tiny"], **kw)
    mgr = ex.ckpt_lib.CheckpointManager(str(tmp_path))
    b, lb, restarts = ex.train(ex.PRESETS["tiny"], manager=mgr, checkpoint_every=4, preempt_at=6, **kw)
    assert restarts == 1 and la == lb
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))


def test_encoder_encode_matches_jax():
    import jax
    from test_torch_models import assert_close, port_cfg

    jex = testing.load_example("train_encoder_e2e")
    ex = testing.load_example("train_encoder_e2e_torch")
    jcfg = dataclasses.replace(jex.PRESETS["tiny"], n_layers=2, vocab=256)
    tree = jax.tree.map(np.asarray, jex.tfm.init(jax.random.PRNGKey(0), jcfg))
    model = tfm.params_from_numpy(tree, port_cfg(jcfg), device="cpu")
    tokens = np.random.default_rng(0).integers(0, 256, (6, 16)).astype(np.int32)
    with torch.no_grad():
        got = ex.encode(model, torch.from_numpy(tokens).long()).numpy()
    assert_close(got, np.asarray(jex.encode(tree, jcfg, tokens)), rtol=1e-5, atol=1e-6)
    # and the contrastive loss on the same pairs
    q, p = tokens[:3], tokens[3:]
    want = float(jex.contrastive_loss(tree, jcfg, {"q": q, "p": p}))
    with torch.no_grad():
        got = float(ex.contrastive_loss(model, {"q": torch.from_numpy(q).long(),
                                                "p": torch.from_numpy(p).long()}))
    np.testing.assert_allclose(got, want, rtol=1e-5)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("arch_id", sorted(testing.CARD_IDS))
def test_card_matches_cpu(arch_id):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = testing.card_against_cpu(testing.card_configs()[arch_id])
    assert out["loss_err"] <= 1 and out["grad_err"] <= 1


@pytest.mark.gpu
@pytest.mark.parametrize("arch_id", ["qwen2.5-3b", "llama4-scout-17b-a16e"])
def test_serving_card_matches_cpu(arch_id):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = testing.serve_card_against_cpu(testing.card_configs()[arch_id])
    assert out["prefill_err"] <= 1 and out["decode_err"] <= 1


@pytest.mark.gpu
def test_restart_is_bit_exact_on_the_card(tmp_path, monkeypatch):
    """The encoder example on the card: a run preempted at step 6 and
    restarted from its step-4 checkpoint ends with the uninterrupted run's
    weights and losses, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    ex = testing.load_example("train_encoder_e2e_torch")
    kw = dict(steps=12, batch=16, seq=16, device="cuda")
    torch.use_deterministic_algorithms(True)
    try:
        a, la, _ = ex.train(ex.PRESETS["tiny"], **kw)
        mgr = ckpt.CheckpointManager(str(tmp_path))
        b, lb, restarts = ex.train(ex.PRESETS["tiny"], manager=mgr, checkpoint_every=4,
                                   preempt_at=6, **kw)
    finally:
        torch.use_deterministic_algorithms(False)
    assert restarts == 1 and la == lb
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
