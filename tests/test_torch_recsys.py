"""The port's recsys models (``repro_torch.models.recsys``) against the JAX
package's.

The reduced config of each recsys architecture (``launch.train.
reduced_recsys``), its weights drawn by ``jax.random`` and carried into the
port's module by ``params_from_numpy``, and the reference's own batches
(``repro.data.synthetic.recsys_batch``) fed to both packages as numpy.
Tolerances (float32), as in ``test_torch_models.py``: forward outputs and
losses within rtol 1e-5; gradients within rtol 1e-4, atol 1e-6, each also
allowed 1e-5 of the leaf's largest magnitude near zero; ids exact.

Also: the step files of each model, JAX's read by the port and the port's
by JAX, leaf for leaf and byte for byte; the port's synthetic batches
(shapes, dtypes, ranges, determinism); and the reference's two-tower +
LIDER pipeline (``tests/test_system.py``) run on the port.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.data import synthetic as jsyn
from repro.launch.train import reduced_recsys as jreduced_recsys
from repro.models import recsys as jrecsys
from repro.training import checkpoint as jckpt
from repro.training import optimizer as jopt
from repro_torch.configs import get_arch
from repro_torch.core.types import Stacked, tree_flatten_with_path
from repro_torch.data import synthetic
from repro_torch.launch.train import reduced_recsys
from repro_torch.models import recsys, tree
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as opt_lib
from repro_torch.training import train_loop
from test_torch_models import assert_close

OUT = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
ARCH_OF = {"sasrec": "sasrec", "two_tower": "two-tower-retrieval", "din": "din",
           "xdeepfm": "xdeepfm"}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def port_cfg(jcfg) -> recsys.RecsysConfig:
    """The JAX config as the port's (the dtype as a torch dtype)."""
    vals = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(recsys.RecsysConfig)}
    vals["dtype"] = torch.float32
    return recsys.RecsysConfig(**vals)


def np_tree(t):
    return jax.tree.map(np.array, t)  # writable copies


def flat_np(t) -> list:
    """``(path, array)`` of a tree in flattening order, stacked leaves as
    one array."""
    def arr(v):
        if isinstance(v, Stacked):
            return np.stack([p.detach().numpy() for p in v.parts])
        return v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return [(p, arr(v)) for p, v in tree_flatten_with_path(t)]


def assert_trees(got, want, **tol):
    g, w = flat_np(got), flat_np(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert a.shape == b.shape, path
        assert_close(a, b, err_msg=str(path), **tol)


def torch_batch(b) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def port_grads(model, loss_fn, batch) -> tuple[float, dict]:
    loss = loss_fn(model, torch_batch(batch))
    loss.backward()
    grads = tree.param_tree({n: p.grad for n, p in model.named_parameters()})
    return float(loss.detach()), grads


def carried(kind, seed=0):
    """(JAX config, JAX params as numpy, the port's model holding them)."""
    jcfg = jreduced_recsys(jget_arch(ARCH_OF[kind]).config)
    params = np_tree(jrecsys.INIT[kind](jax.random.PRNGKey(seed), jcfg))
    return jcfg, params, recsys.params_from_numpy(params, port_cfg(jcfg), device="cpu")


def jbatch(kind, jcfg, step=0, batch=16):
    return np_tree(jsyn.recsys_batch(0, step, kind=kind, batch=batch, cfg=jcfg))


# ---------------------------------------------------------------------------
# Configs and parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", sorted(ARCH_OF))
def test_configs_and_reduced_match_jax(kind):
    jcfg = jget_arch(ARCH_OF[kind]).config
    assert get_arch(ARCH_OF[kind]).config == port_cfg(jcfg)
    assert reduced_recsys(port_cfg(jcfg)) == port_cfg(jreduced_recsys(jcfg))


@pytest.mark.parametrize("kind", sorted(ARCH_OF))
def test_params_round_trip_and_init_scales(kind):
    jcfg, params, model = carried(kind)
    back = recsys.params_to_numpy(model)
    g, w = flat_np(back), flat_np(params)
    assert [p for p, _ in g] == [p for p, _ in w]  # the reference's names, lists by index
    for (path, a), (_, b) in zip(g, w):
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    # The port's own draw: the reference's shapes and scales.
    mine = recsys.params_to_numpy(recsys.init(3, port_cfg(jcfg), device="cpu"))
    for (path, a), (_, b) in zip(flat_np(mine), w):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if b.ndim == 1 and np.all(b == b.flat[0]):  # norms (1) and biases (0)
            assert np.array_equal(a, b), path
        elif b.size > 200:
            assert abs(a.std() - b.std()) < 0.15 * b.std(), path


# ---------------------------------------------------------------------------
# Forward, loss and gradients
# ---------------------------------------------------------------------------


def _forward(kind, model, params, jcfg, b):
    """(the port's forward output, JAX's) on batch ``b``."""
    tb = torch_batch(b)
    with torch.no_grad():
        if kind == "sasrec":
            return (recsys.sasrec_forward(model, tb["seq"]),
                    jrecsys.sasrec_forward(params, jcfg, b["seq"]))
        if kind == "two_tower":
            u = recsys.user_embed(model, tb["user_fields"])
            i = recsys.item_embed(model, tb["item_fields"])
            return (torch.cat([u, i], -1), jnp.concatenate([
                jrecsys.user_embed(params, jcfg, b["user_fields"]),
                jrecsys.item_embed(params, jcfg, b["item_fields"])], -1))
        if kind == "din":
            return recsys.din_forward(model, tb), jrecsys.din_forward(params, jcfg, b)
        return recsys.xdeepfm_forward(model, tb), jrecsys.xdeepfm_forward(params, jcfg, b)


@pytest.mark.parametrize("kind", sorted(ARCH_OF))
def test_forward_loss_and_grads(kind):
    jcfg, params, model = carried(kind)
    b = jbatch(kind, jcfg, step=3)
    got, want = _forward(kind, model, params, jcfg, b)
    assert_close(got.numpy(), np.asarray(want), **OUT)
    loss, grads = port_grads(model, recsys.LOSS[kind], b)
    jloss, jgrads = jax.value_and_grad(jrecsys.LOSS[kind])(params, jcfg, b)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    assert_trees(grads, np_tree(jgrads), **GRAD)


def test_two_tower_logq_correction():
    jcfg, params, model = carried("two_tower", seed=1)
    b = jbatch("two_tower", jcfg, step=5)
    b["sampling_logq"] = (np.random.default_rng(0).standard_normal(16) * 2).astype(np.float32)
    loss, grads = port_grads(model, recsys.two_tower_loss, b)
    jloss, jgrads = jax.value_and_grad(jrecsys.two_tower_loss)(params, jcfg, b)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    assert_trees(grads, np_tree(jgrads), **GRAD)


def test_din_padding_and_xdeepfm_cin():
    """DIN's masked pooling on histories with padding (id 0), down to a
    history of only padding; xDeepFM with three CIN layers."""
    jcfg, params, model = carried("din")
    b = jbatch("din", jcfg, step=1)
    b["history"][:, ::3] = 0
    b["history"][0] = 0
    got, want = _forward("din", model, params, jcfg, b)
    assert_close(got.numpy(), np.asarray(want), **OUT)
    jx = dataclasses.replace(jreduced_recsys(jget_arch("xdeepfm").config), cin_dims=(8, 6, 4))
    px = np_tree(jrecsys.xdeepfm_init(jax.random.PRNGKey(4), jx))
    mx = recsys.params_from_numpy(px, port_cfg(jx), device="cpu")
    assert len(list(mx.cin)) == 3
    bx = jbatch("xdeepfm", jx, step=2)
    loss, grads = port_grads(mx, recsys.xdeepfm_loss, bx)
    jloss, jgrads = jax.value_and_grad(jrecsys.xdeepfm_loss)(px, jx, bx)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    assert_trees(grads, np_tree(jgrads), **GRAD)


def test_embedding_bag():
    rng = np.random.default_rng(2)
    table = rng.standard_normal((50, 6)).astype(np.float32)
    ids = rng.integers(0, 50, 30).astype(np.int32)
    seg = np.sort(rng.integers(0, 7, 30)).astype(np.int32)
    got = recsys.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                               torch.from_numpy(seg), 8)
    assert_close(got.numpy(), np.asarray(jrecsys.embedding_bag(table, ids, seg, 8)), **OUT)


def test_two_tower_score_candidates_ids_exact():
    jcfg, params, model = carried("two_tower")
    rng = np.random.default_rng(7)
    users = rng.integers(0, jcfg.field_vocab, (6, jcfg.n_user_fields)).astype(np.int32)
    cands = rng.standard_normal((1000, jcfg.tower_dims[-1])).astype(np.float32)
    cands[500:] = cands[:500]  # every score tied with another: JAX's tie order decides
    scores, ids = recsys.two_tower_score_candidates(model, torch.from_numpy(users),
                                                    torch.from_numpy(cands), 40)
    jscores, jids = jrecsys.two_tower_score_candidates(params, jcfg, users, cands, 40)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert_close(scores.numpy(), np.asarray(jscores), **OUT)
    assert np.all(ids.numpy()[:, 0] < ids.numpy()[:, 1])  # the tied pair in index order


# ---------------------------------------------------------------------------
# Synthetic batches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", sorted(ARCH_OF))
def test_recsys_batch_matches_reference_layout(kind):
    cfg = reduced_recsys(get_arch(ARCH_OF[kind]).config)
    jcfg = jreduced_recsys(jget_arch(ARCH_OF[kind]).config)
    got = synthetic.recsys_batch(0, 4, kind=kind, batch=32, cfg=cfg, device="cpu")
    want = jbatch(kind, jcfg, step=4, batch=32)
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype).removeprefix("torch.") == str(want[k].dtype), k
        lo, hi = int(want[k].min()), int(want[k].max())
        assert lo >= 0 and int(got[k].min()) >= 0
        if want[k].dtype == np.float32:  # labels
            assert set(np.unique(got[k].numpy())) <= {0.0, 1.0}
    again = synthetic.recsys_batch(0, 4, kind=kind, batch=32, cfg=cfg, device="cpu")
    other = synthetic.recsys_batch(0, 5, kind=kind, batch=32, cfg=cfg, device="cpu")
    assert all(torch.equal(got[k], again[k]) for k in got)
    assert not all(torch.equal(got[k], other[k]) for k in got)
    if kind == "sasrec":
        assert int(got["seq"].min()) >= 1 and int(got["seq"].max()) < cfg.item_vocab
    if kind == "two_tower":
        assert int(got["item_fields"][:, 1:].max()) < cfg.field_vocab


# ---------------------------------------------------------------------------
# Step files both ways
# ---------------------------------------------------------------------------


def _dir_bytes(d):
    return {n: open(os.path.join(d, n), "rb").read() for n in sorted(os.listdir(d))}


def step_files_both_ways(tmp_path, jparams, jloss, jb, from_numpy, fresh):
    """One JAX AdamW step, saved by JAX and by the port (the port holding
    JAX's values): the same files, byte for byte; JAX restores the port's
    save and the port (``fresh()``, another draw) restores JAX's, leaf for
    leaf."""
    grads = jax.grad(jloss)(jparams, jb)
    params, jstate, _ = jopt.apply_updates(jparams, grads, jopt.init_state(jparams),
                                           jopt.OptimizerConfig())
    jtree = {"params": params, "opt_state": jstate}
    jckpt.save(str(tmp_path / "jax"), 3, jtree)

    named = lambda t: {n: p.detach() for n, p in from_numpy(np_tree(t)).named_parameters()}
    model = from_numpy(np_tree(params))
    state = {"mu": named(jstate["mu"]), "nu": named(jstate["nu"]),
             "step": torch.tensor(int(jstate["step"]), dtype=torch.int32)}
    ckpt.save(str(tmp_path / "port"), 3, train_loop.state_tree(model, state))
    jfiles = _dir_bytes(tmp_path / "jax" / "step_00000003")
    pfiles = _dir_bytes(tmp_path / "port" / "step_00000003")
    assert list(pfiles) == list(jfiles)
    for name in jfiles:
        assert pfiles[name] == jfiles[name], name

    got = jckpt.restore(str(tmp_path / "port"), 3, jax.tree.map(jnp.zeros_like, jtree))
    for (path, a), (_, b) in zip(flat_np(np_tree(got)), flat_np(np_tree(jtree))):
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    m = fresh()
    fstate = opt_lib.init_state(dict(m.named_parameters()))
    step, _ = ckpt.CheckpointManager(str(tmp_path / "jax")).restore_latest(
        train_loop.state_tree(m, fstate))
    assert step == 3 and int(fstate["step"]) == int(jstate["step"])
    for (path, a), (_, b) in zip(flat_np(tree.to_numpy(m)), flat_np(np_tree(params))):
        assert np.array_equal(a, b), path
    for key in ("mu", "nu"):
        for (path, a), (_, b) in zip(flat_np(tree.param_tree(fstate[key])),
                                     flat_np(np_tree(jstate[key]))):
            assert np.array_equal(a, b), (key, path)
    return pfiles


@pytest.mark.parametrize("kind", sorted(ARCH_OF))
def test_step_files_both_ways(tmp_path, kind):
    jcfg, params, _ = carried(kind)
    cfg = port_cfg(jcfg)
    files = step_files_both_ways(
        tmp_path, params, lambda p, b: jrecsys.LOSS[kind](p, jcfg, b), jbatch(kind, jcfg),
        lambda t: recsys.params_from_numpy(t, cfg, device="cpu"),
        lambda: recsys.init(9, cfg, device="cpu"))
    if kind == "sasrec":  # list items by index, as tree_flatten_with_path names them
        assert any("__params__blocks__1__wq.npy" in n for n in files)
    if kind == "xdeepfm":
        assert any("__params__cin__0.npy" in n for n in files)


# ---------------------------------------------------------------------------
# The paper's deployment: tests/test_system.py's two-tower + LIDER pipeline
# ---------------------------------------------------------------------------


def test_trained_encoder_plus_lider_end_to_end():
    """Train the two towers 60 steps (the loss falls by 0.3), encode every
    item through the item tower, build LIDER over them and search it with
    the user tower's outputs: recall@10 against Flat at least 0.85."""
    from repro_torch.core import lider
    from repro_torch.core.baselines import flat_search
    from repro_torch.core.utils import l2_normalize, recall_at_k

    cfg = recsys.RecsysConfig(name="tt", kind="two_tower", embed_dim=16, item_vocab=512,
                              field_vocab=64, tower_dims=(64, 32), n_user_fields=4,
                              n_item_fields=2)
    model = recsys.init(0, cfg, device="cpu")
    ocfg = opt_lib.OptimizerConfig(peak_lr=3e-3, warmup_steps=5, decay_steps=60)
    state = opt_lib.init_state(dict(model.named_parameters()))
    step = train_loop.make_train_step(recsys.two_tower_loss, ocfg)
    losses = []
    for i in range(60):
        b = synthetic.recsys_batch(0, i, kind="two_tower", batch=64, cfg=cfg, device="cpu")
        model, state, m = step(model, state, b)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.3

    with torch.no_grad():
        items = torch.stack([torch.arange(512, dtype=torch.int32),
                             torch.zeros(512, dtype=torch.int32)], dim=1)
        item_embs = l2_normalize(recsys.item_embed(model, items))
        users = synthetic.recsys_batch(0, 999, kind="two_tower", batch=16, cfg=cfg,
                                       device="cpu")["user_fields"]
        u = l2_normalize(recsys.user_embed(model, users))
    idx_cfg = lider.LiderConfig(n_clusters=16, n_probe=6, n_arrays=4, n_leaves=2, kmeans_iters=8)
    index = lider.build_lider(1, item_embs, idx_cfg, device="cpu")
    got = lider.search_lider(index, u, k=10, n_probe=6, r0=8)
    gt = flat_search(item_embs, u, k=10)
    assert float(recall_at_k(got.ids, gt.ids)) > 0.85


def test_lider_on_two_tower_items_matches_jax(tmp_path):
    """LIDER over two-tower item embeddings at chance, at the routing shape
    of the full-width cell (c = 2,048 clusters, n_probe 20, lider-msmarco's
    LSH settings, d = 256), with 16 items a cluster instead of 1,024: the
    items and users come from the reference's towers at their initial
    weights, the index from the reference's ``build_lider``. The port's
    search of that index returns the reference's ids, so its recall@100
    against the exact top-100 is the reference's; and in the reference, as
    on the card, LIDER keeps only part of what an exact scan of the 20
    clusters whose centroids score highest (IVF-Flat) finds, though its
    in-cluster search here sees every row of the clusters it probes: the
    shortfall is routing's."""
    from repro.core import lider as jlider
    from repro.core.baselines import flat_search as jflat_search
    from repro.core.utils import l2_normalize as jl2
    from repro.training import checkpoint as jckpt_index
    from repro_torch.core import lider
    from repro_torch.testing import assert_topk_match
    from repro_torch.training import checkpoint as ckpt_index

    n, c, k, n_probe = 32_768, 2_048, 100, 20
    jcfg = jrecsys.RecsysConfig(name="tt", kind="two_tower", embed_dim=64, item_vocab=n,
                                field_vocab=64, tower_dims=(256, 256), n_user_fields=4,
                                n_item_fields=2)
    p = jrecsys.two_tower_init(jax.random.PRNGKey(0), jcfg)
    ids = jnp.arange(n, dtype=jnp.int32)
    embs = jl2(jrecsys.item_embed(p, jcfg, jnp.stack([ids, jnp.zeros_like(ids)], 1)))
    users = jsyn.recsys_batch(1, 0, kind="two_tower", batch=256, cfg=jcfg)["user_fields"]
    q = jl2(jrecsys.user_embed(p, jcfg, users))
    icfg = jlider.LiderConfig(n_clusters=c, n_probe=n_probe, n_arrays=10, n_arrays_centroid=10,
                              key_len=16, key_len_centroid=10, n_leaves=5, n_leaves_centroid=10,
                              r0=4, r0_centroid=4, kmeans_iters=20)
    jp = jlider.build_lider(jax.random.PRNGKey(0), embs, icfg)
    assert jp.bank.embs.shape[1] <= 4 * k  # r = min(r0 * k, Lp): every row of a probed cluster
    jckpt_index.save_index(str(tmp_path), jp)
    tp = ckpt_index.load_index(str(tmp_path), device="cpu")

    jo = jlider.search_lider(jp, q, k=k, n_probe=n_probe, r0=4, r0_centroid=4)
    to = lider.search_lider(tp, np.asarray(q), k=k, n_probe=n_probe, r0=4, r0_centroid=4)
    assert_topk_match(to.ids, to.scores, np.asarray(jo.ids), np.asarray(jo.scores))
    gt = np.asarray(jflat_search(embs, q, k=k).ids)

    def recall(found):
        return np.mean([len(set(f) & set(g.tolist())) / k for f, g in zip(found, gt)])

    rec_jax, rec_port = recall(np.asarray(jo.ids).tolist()), recall(to.ids.numpy().tolist())
    assert rec_port == rec_jax
    e, qn, gids = np.asarray(embs), np.asarray(q), np.asarray(jp.bank.gids)
    top = np.argsort(-(qn @ np.asarray(jp.centroids).T), axis=1, kind="stable")[:, :n_probe]
    ivf = []
    for qi, cids in zip(qn, top):
        g = gids[cids].reshape(-1)
        g = g[g >= 0]
        ivf.append(g[np.argsort(-(e[g] @ qi), kind="stable")[:k]].tolist())
    rec_ivf = recall(ivf)
    print(f"recall@{k}: LIDER {rec_jax:.4f} (reference and port), IVF-Flat {rec_ivf:.4f}, "
          f"Lp {jp.bank.embs.shape[1]}")
    assert 0.4 * rec_ivf <= rec_jax < rec_ivf, (rec_jax, rec_ivf)
