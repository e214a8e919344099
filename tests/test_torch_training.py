"""The port's training substrate (``repro_torch.training``, ``repro_torch.data``)
against the JAX package's.

- The eight cases of ``tests/test_substrates.py`` on the port.
- AdamW and the train step: one ``apply_updates`` and five
  ``make_train_step`` steps equal to JAX's on the same parameters (JAX's,
  carried across by ``params_from_numpy``) and the same numpy batches;
  ``grad_accum=2`` equal to JAX's and to the port's full batch.
- Step checkpoints in both directions: a port save restored by JAX's
  ``restore`` and a JAX save restored by the port, with the same leaf
  names and the same bytes in every file.
- The four ``run_with_restarts`` cases of ``tests/test_faults.py``, with
  JAX's backoff sleeps.

The card's cases (``gpu``-marked) are in ``test_torch_train_cli.py``,
which imports no JAX at the top, so that it collects on the card.

Tolerances as in ``test_torch_models.py``: float32 outputs within rtol
1e-5 and gradients within rtol 1e-4 (each also allowed 1e-5 of the leaf's
largest magnitude for elements near zero); integers exact. After five
train steps the losses stay within rtol 1e-5 and the parameters within the
output tolerance, but for at most 0.1% of a leaf's elements, which may
differ by up to 1% of the summed learning rates: where an element's
gradient is near zero, AdamW's ``mu / sqrt(nu)`` turns the two frameworks'
rounding of that gradient into a visible share of a step (one element in
4,096 of an MLP weight, by ~5e-5, on these inputs).
"""
import json
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jtfm
from repro.training import checkpoint as jckpt
from repro.training import fault_tolerance as jft
from repro.training import optimizer as jopt
from repro.training import train_loop as jloop
from repro_torch.data import pipeline as pipe_lib
from repro_torch.data import synthetic
from repro_torch.models import transformer as tfm
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import fault_tolerance as ft
from repro_torch.training import optimizer as opt_lib
from repro_torch.training import train_loop
from test_torch_models import assert_close, batch_np, few_threads, port_cfg, tree_leaves  # noqa: F401

JCFG = jtfm.LMConfig(
    name="tiny", n_layers=2, d_model=32, n_heads=2, n_kv_heads=1, d_ff=64,
    vocab=64, dtype=jnp.float32,
)
CFG = port_cfg(JCFG)
OUT = dict(rtol=1e-5, atol=1e-6)


def _setup():
    model = tfm.init(0, CFG, device="cpu")
    ocfg = opt_lib.OptimizerConfig(peak_lr=1e-2, warmup_steps=2, decay_steps=40)
    return model, ocfg, opt_lib.init_state(dict(model.named_parameters()))


def _cpu_batch(seed, step, **kw):
    return synthetic.lm_batch(seed, step, device="cpu", **kw)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, cfg=CFG):
    """A reference-layout tree as ``{parameter name: tensor}``."""
    m = tfm.params_from_numpy(tree, cfg, device="cpu")
    return {n: p.detach() for n, p in m.named_parameters()}


def _opt_to_numpy(state):
    tree = lambda flat: tfm.params_to_numpy(_module_of(flat))
    return {"mu": tree(state["mu"]), "nu": tree(state["nu"]), "step": state["step"].numpy()}


def _module_of(flat):
    m = tfm.Transformer(CFG, device="cpu")
    with torch.no_grad():
        for n, p in m.named_parameters():
            p.copy_(flat[n])
    return m


# ---------------------------------------------------------------------------
# tests/test_substrates.py on the port
# ---------------------------------------------------------------------------


def test_training_reduces_loss():
    model, ocfg, state = _setup()
    step = train_loop.make_train_step(tfm.train_loss, ocfg, grad_accum=1)
    pipe = pipe_lib.DataPipeline(
        lambda s: _cpu_batch(0, s % 4, batch=4, seq=16, vocab=64), prefetch=0
    )
    _, _, hist = train_loop.run(step, model, state, pipe, n_steps=25, log_every=1,
                                log_fn=lambda _: None)
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.1


def test_grad_accum_matches_full_batch():
    batch = _cpu_batch(0, 0, batch=8, seq=16, vocab=64)
    out = []
    for ga in (1, 4):
        model, ocfg, state = _setup()
        step = train_loop.make_train_step(tfm.train_loss, ocfg, grad_accum=ga)
        out.append((step(model, state, batch)[2], tfm.params_to_numpy(model)))
    (m1, p1), (m2, p2) = out
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 2e-3
    diffs = jax.tree.map(lambda a, b: float(np.max(np.abs(a - b))), p1, p2)
    assert max(jax.tree.leaves(diffs)) < 2e-3


def test_schedule_shape():
    ocfg = opt_lib.OptimizerConfig(peak_lr=1.0, warmup_steps=10, decay_steps=100, min_lr_ratio=0.1)
    lrs = [float(opt_lib.schedule(ocfg, torch.tensor(s, dtype=torch.int32)))
           for s in (0, 5, 10, 50, 100, 1000)]
    assert lrs[0] == 0.0 and abs(lrs[2] - 1.0) < 1e-6
    assert lrs[3] < 1.0 and abs(lrs[4] - 0.1) < 1e-6 and abs(lrs[5] - 0.1) < 1e-6
    jlrs = [float(jopt.schedule(jopt.OptimizerConfig(peak_lr=1.0, warmup_steps=10, decay_steps=100,
                                                     min_lr_ratio=0.1), jnp.int32(s)))
            for s in (0, 5, 10, 50, 100, 1000)]
    np.testing.assert_allclose(lrs, jlrs, rtol=1e-6)


def test_gradient_compression_close_to_exact():
    batch = _cpu_batch(0, 0, batch=4, seq=16, vocab=64)
    outs = []
    for compress in (False, True):
        model, _, state = _setup()
        tfm.train_loss(model, batch).backward()
        params = dict(model.named_parameters())
        opt_lib.apply_updates(params, {n: p.grad for n, p in params.items()}, state,
                              opt_lib.OptimizerConfig(compress_grads=compress))
        outs.append(tfm.params_to_numpy(model))
    rel = jax.tree.map(lambda a, b: float(np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-9)), *outs)
    assert max(jax.tree.leaves(rel)) < 0.1


def test_checkpoint_roundtrip_and_gc():
    model, _, state = _setup()
    tree = train_loop.state_tree(model, state)
    with tempfile.TemporaryDirectory() as d:
        mgr = ckpt.CheckpointManager(d, keep=2)
        for s in (5, 10, 15):
            mgr.save(s, {"params": tree["params"], "opt": tree["opt_state"]})
        assert mgr.latest_step() == 15
        # keep=2 -> step 5 gone
        assert not os.path.exists(os.path.join(d, "step_00000005"))
        fresh = tfm.init(1, CFG, device="cpu")
        fstate = opt_lib.init_state(dict(fresh.named_parameters()))
        ftree = train_loop.state_tree(fresh, fstate)
        step, restored = mgr.restore_latest({"params": ftree["params"], "opt": ftree["opt_state"]})
        assert step == 15
        for a, b in zip(fresh.parameters(), model.parameters()):
            assert torch.equal(a, b) and a.dtype == b.dtype
        assert restored["params"]["layers"]["wq"].parts[0] is fresh.layers[0].wq  # in place


def test_checkpoint_restore_rejects_wrong_structure():
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, 1, {"a": torch.zeros(2)})
        with pytest.raises(ValueError):
            ckpt.restore(d, 1, {"a": torch.zeros(2), "b": torch.zeros(2)})
        with pytest.raises(ValueError):  # same structure, another shape
            ckpt.restore(d, 1, {"a": torch.zeros(3)})


def test_pipeline_determinism_and_replay():
    make = lambda s: _cpu_batch(7, s, batch=2, seq=8, vocab=32)
    p1 = pipe_lib.DataPipeline(make, prefetch=2)
    first = [next(p1) for _ in range(5)]
    p1.close()
    # replay from step 3 reproduces batches exactly
    p2 = pipe_lib.DataPipeline(make, start_step=3, prefetch=0)
    replay = next(p2)
    assert torch.equal(first[3]["tokens"], replay["tokens"])
    assert not torch.equal(first[2]["tokens"], first[3]["tokens"])


def test_preemption_restart_is_exact():
    calls = {"n": 0}

    def make_state():
        return {"acc": torch.zeros(())}

    def step_fn(st, i):
        calls["n"] += 1
        if calls["n"] == 6:
            raise ft.Preemption()
        return {"acc": st["acc"] + i * i}

    with tempfile.TemporaryDirectory() as d:
        mgr = ckpt.CheckpointManager(d)
        final, restarts = ft.run_with_restarts(
            make_state, step_fn, n_steps=9, manager=mgr, checkpoint_every=2
        )
    assert restarts == 1
    assert float(final["acc"]) == sum(i * i for i in range(9))


# ---------------------------------------------------------------------------
# AdamW and the train step against JAX
# ---------------------------------------------------------------------------


def _jax_start(seed=0):
    params = jtfm.init(jax.random.PRNGKey(seed), JCFG)
    return params, jopt.init_state(params)


def test_apply_updates_matches_jax():
    params, jstate = _jax_start()
    batch = batch_np(3, 4, 16, 64)
    grads = jax.grad(jtfm.train_loss)(params, JCFG, batch)
    # Two steps, so the second runs on non-zero moments and bias correction 2.
    ocfg_j = jopt.OptimizerConfig(peak_lr=1e-2, warmup_steps=1, decay_steps=10, grad_clip=0.5)
    ocfg = opt_lib.OptimizerConfig(peak_lr=1e-2, warmup_steps=1, decay_steps=10, grad_clip=0.5)
    model = tfm.params_from_numpy(_np_tree(params), CFG, device="cpu")
    state = opt_lib.init_state(dict(model.named_parameters()))
    g = _flat(_np_tree(grads))
    for _ in range(2):
        params, jstate, jm = jopt.apply_updates(params, grads, jstate, ocfg_j)
        m = opt_lib.apply_updates(dict(model.named_parameters()), g, state, ocfg)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)
    assert int(state["step"]) == int(jstate["step"]) == 2
    for got, want in ((tfm.params_to_numpy(model), params),
                      (_opt_to_numpy(state)["mu"], jstate["mu"]),
                      (_opt_to_numpy(state)["nu"], jstate["nu"])):
        for (path, a), (_, b) in zip(tree_leaves(got), tree_leaves(_np_tree(want))):
            assert_close(a, b, err_msg=str(path), **OUT)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_steps_match_jax(grad_accum):
    params, jstate = _jax_start(1)
    ocfg_j = jopt.OptimizerConfig(peak_lr=1e-2, warmup_steps=2, decay_steps=40)
    ocfg = opt_lib.OptimizerConfig(peak_lr=1e-2, warmup_steps=2, decay_steps=40)
    jstep = jax.jit(jloop.make_train_step(lambda p, b: jtfm.train_loss(p, JCFG, b), ocfg_j,
                                          grad_accum=grad_accum))
    model = tfm.params_from_numpy(_np_tree(params), CFG, device="cpu")
    state = opt_lib.init_state(dict(model.named_parameters()))
    step = train_loop.make_train_step(tfm.train_loss, ocfg, grad_accum=grad_accum)
    for i in range(5):
        batch = batch_np(10 + i, 4, 16, 64)
        params, jstate, jm = jstep(params, jstate, batch)
        _, _, m = step(model, state, {k: torch.from_numpy(v).long() for k, v in batch.items()})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    lr_sum = sum(float(opt_lib.schedule(ocfg, torch.tensor(s))) for s in range(1, 6))
    for (path, a), (_, b) in zip(tree_leaves(tfm.params_to_numpy(model)),
                                 tree_leaves(_np_tree(params))):
        diff = np.abs(a - b)
        bad = diff > 1e-5 * np.abs(b) + 1e-5 * np.abs(b).max()
        assert bad.mean() <= 1e-3 and np.all(diff[bad] <= 1e-2 * lr_sum), (path, diff.max())
    if grad_accum == 2:  # and the port's two micro-batches against its full batch
        full = tfm.params_from_numpy(_np_tree(_jax_start(1)[0]), CFG, device="cpu")
        fstate = opt_lib.init_state(dict(full.named_parameters()))
        fstep = train_loop.make_train_step(tfm.train_loss, ocfg, grad_accum=1)
        for i in range(5):
            batch = batch_np(10 + i, 4, 16, 64)
            fstep(full, fstate, {k: torch.from_numpy(v).long() for k, v in batch.items()})
        for a, b in zip(full.parameters(), model.parameters()):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# Step checkpoints in both directions
# ---------------------------------------------------------------------------


def _dir_bytes(d):
    return {n: open(os.path.join(d, n), "rb").read() for n in sorted(os.listdir(d))}


def test_checkpoints_read_both_ways(tmp_path):
    params, jstate = _jax_start(2)
    batch = batch_np(4, 4, 16, 64)
    grads = jax.grad(jtfm.train_loss)(params, JCFG, batch)
    params, jstate, _ = jopt.apply_updates(params, grads, jstate, jopt.OptimizerConfig())
    jtree = {"params": params, "opt_state": jstate}
    jckpt.save(str(tmp_path / "jax"), 7, jtree)

    model = tfm.params_from_numpy(_np_tree(params), CFG, device="cpu")
    state = {"mu": _flat(_np_tree(jstate["mu"])), "nu": _flat(_np_tree(jstate["nu"])),
             "step": torch.tensor(int(jstate["step"]), dtype=torch.int32)}
    ckpt.save(str(tmp_path / "port"), 7, train_loop.state_tree(model, state))

    jfiles = _dir_bytes(tmp_path / "jax" / "step_00000007")
    pfiles = _dir_bytes(tmp_path / "port" / "step_00000007")
    assert list(pfiles) == list(jfiles)  # leaf names, in JAX's flattening order
    assert "0000__opt_state__mu__embed.npy" in pfiles and "manifest.json" in pfiles
    for name in jfiles:
        assert pfiles[name] == jfiles[name], name

    # JAX restores the port's save ...
    like = jax.tree.map(jnp.zeros_like, jtree)
    got = jckpt.restore(str(tmp_path / "port"), 7, like)
    for (path, a), (_, b) in zip(tree_leaves(got), tree_leaves(jtree)):
        assert np.array_equal(np.asarray(a), np.asarray(b)) and a.dtype == b.dtype, path
    # ... and the port restores JAX's, in place.
    fresh = tfm.init(5, CFG, device="cpu")
    fstate = opt_lib.init_state(dict(fresh.named_parameters()))
    step, _ = ckpt.CheckpointManager(str(tmp_path / "jax")).restore_latest(
        train_loop.state_tree(fresh, fstate))
    assert step == 7 and int(fstate["step"]) == int(jstate["step"])
    for (path, a), (_, b) in zip(tree_leaves(tfm.params_to_numpy(fresh)), tree_leaves(_np_tree(params))):
        assert np.array_equal(a, b), path
    for (path, a), (_, b) in zip(tree_leaves(_opt_to_numpy(fstate)["nu"]),
                                 tree_leaves(_np_tree(jstate["nu"]))):
        assert np.array_equal(a, b), path


def test_bf16_leaves_write_jax_bytes(tmp_path):
    import ml_dtypes

    x = np.arange(12, dtype=np.float32).reshape(3, 4) / 7
    jckpt.save(str(tmp_path / "jax"), 1, {"w": jnp.asarray(x, jnp.bfloat16)})
    ckpt.save(str(tmp_path / "port"), 1, {"w": torch.from_numpy(x).to(torch.bfloat16)})
    assert (_dir_bytes(tmp_path / "port" / "step_00000001")
            == _dir_bytes(tmp_path / "jax" / "step_00000001"))
    manifest = json.loads(_dir_bytes(tmp_path / "port" / "step_00000001")["manifest.json"])
    assert manifest["leaves"][0]["dtype"] == "bfloat16"
    like = {"w": torch.zeros(3, 4, dtype=torch.bfloat16)}
    ckpt.restore(str(tmp_path / "jax"), 1, like)
    want = x.astype(ml_dtypes.bfloat16).astype(np.float32)
    assert np.array_equal(like["w"].float().numpy(), want)


# ---------------------------------------------------------------------------
# run_with_restarts: tests/test_faults.py's four cases on both packages
# ---------------------------------------------------------------------------


def _counting_step(fail_at, exc, calls):
    def step_fn(state, i):
        calls.append(i)
        if i == fail_at and not any(c == fail_at for c in calls[:-1]):
            raise exc
        return {"x": state["x"] + 1}

    return step_fn


PACKAGES = {"port": (ckpt, ft), "jax": (jckpt, jft)}


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_run_with_restarts_retries_configured_exceptions(tmp_path, pkg):
    ck, f = PACKAGES[pkg]
    calls = []
    state, restarts = f.run_with_restarts(
        lambda: {"x": np.zeros(1, np.float32)},
        _counting_step(5, OSError("flaky storage"), calls),
        n_steps=8, manager=ck.CheckpointManager(str(tmp_path)), checkpoint_every=2,
        retryable=(OSError,),
    )
    assert restarts == 1
    assert float(state["x"][0]) == 8.0
    assert calls.count(4) == 2  # steps 4..5 re-executed after the restart


def test_run_with_restarts_propagates_non_retryable(tmp_path):
    with pytest.raises(ValueError):
        ft.run_with_restarts(
            lambda: {"x": np.zeros(1, np.float32)},
            _counting_step(3, ValueError("real bug"), []),
            n_steps=8, manager=ckpt.CheckpointManager(str(tmp_path)), checkpoint_every=2,
            retryable=(OSError,),
        )


def test_run_with_restarts_backoff_matches_jax(tmp_path, monkeypatch):
    sleeps = []
    # Both packages call time.sleep through their own module's ``time``.
    monkeypatch.setattr("repro_torch.training.fault_tolerance.time.sleep", sleeps.append)

    def run(pkg, sub):
        ck, f = PACKAGES[pkg]
        mgr = ck.CheckpointManager(os.path.join(str(tmp_path), sub))
        calls = []

        def step_fn(state, i):
            calls.append(i)
            if len(calls) in (2, 5):  # two transient failures
                raise f.Preemption()
            return {"x": state["x"] + 1}

        return f.run_with_restarts(
            lambda: {"x": np.zeros(1, np.float32)}, step_fn,
            n_steps=4, manager=mgr, checkpoint_every=2,
            backoff_s=0.1, backoff_mult=2.0, jitter_seed=7,
        )

    schedules = {}
    for pkg in ("port", "jax"):
        sleeps.clear()
        _, restarts = run(pkg, pkg)
        assert restarts == 2
        schedules[pkg] = list(sleeps)
    first = schedules["port"]
    assert len(first) == 2
    assert 0.1 <= first[0] < 0.2 and 0.2 <= first[1] < 0.4
    assert first == schedules["jax"]  # the same seeded jitter, the same sleeps
    sleeps.clear()
    run("port", "again")
    assert sleeps == first


def _corrupt_step(directory, step):
    sd = os.path.join(directory, f"step_{step:08d}")
    leaf = next(n for n in sorted(os.listdir(sd)) if n.endswith(".npy"))
    with open(os.path.join(sd, leaf), "r+b") as f:
        b = f.read(1)
        f.seek(0)
        f.write(bytes([b[0] ^ 0xFF]))


def test_run_with_restarts_falls_back_past_corrupt_newest(tmp_path):
    d = str(tmp_path)
    calls = []

    def step_fn(state, i):
        calls.append(i)
        if i == 5 and calls.count(5) == 1:
            _corrupt_step(d, 4)  # newest checkpoint (step_4) goes bad
            raise ft.Preemption()
        return {"x": state["x"] + 1}

    state, restarts = ft.run_with_restarts(
        lambda: {"x": np.zeros(1, np.float32)}, step_fn,
        n_steps=8, manager=ckpt.CheckpointManager(d), checkpoint_every=2, max_restarts=3,
    )
    assert restarts == 1
    assert float(state["x"][0]) == 8.0
    assert calls.count(2) == 2 and calls.count(4) == 2
    assert len(calls) == 12


def test_crc_fallback_and_injected_truncation(tmp_path):
    from repro_torch import faults

    mgr = ckpt.CheckpointManager(str(tmp_path / "a"), keep=4)
    state = {"w": np.arange(16, dtype=np.float32), "b": np.ones(3, np.float32)}
    mgr.save(1, state)
    mgr.save(2, {"w": state["w"] + 1, "b": state["b"] + 1})
    _corrupt_step(str(tmp_path / "a"), 2)
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.restore(str(tmp_path / "a"), 2, state)
    step, rec = mgr.restore_latest({"w": np.zeros(16, np.float32), "b": np.zeros(3, np.float32)})
    assert step == 1 and np.array_equal(rec["w"], state["w"])

    plan = faults.FaultPlan([faults.FaultSpec("checkpoint_write", mode="truncate", times=(0,))])
    with faults.activate(plan):
        ckpt.save(str(tmp_path / "b"), 1, state)
    assert plan.n_fired == 1
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.restore(str(tmp_path / "b"), 1, state)
