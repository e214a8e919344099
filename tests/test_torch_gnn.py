"""The port's GatedGCN (``repro_torch.models.gnn``) against the JAX package's.

The reduced config (``launch.train.reduced_gnn``), JAX-drawn weights
carried by ``params_from_numpy`` (the reference's stacked ``(L, ...)``
layers), and the reference's graphs fed to both packages as numpy.
Tolerances (float32): outputs and losses within rtol 1e-5, gradients
within rtol 1e-4, atol 1e-6 (each with 1e-5 of the leaf's largest
magnitude near zero). The neighbour sampler given the reference's draws
returns the reference's block bit for bit; the port's random graph keeps
the CSR invariants; step files read both ways.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.data import synthetic as jsyn
from repro.launch.train import reduced_gnn as jreduced_gnn
from repro.models import gnn as jgnn
from repro_torch.configs import get_arch
from repro_torch.data import synthetic
from repro_torch.launch.train import reduced_gnn
from repro_torch.models import gnn, tree
from test_torch_models import assert_close
from test_torch_recsys import GRAD, OUT, assert_trees, flat_np, np_tree, port_grads, \
    step_files_both_ways, torch_batch


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def port_cfg(jcfg, **kw) -> gnn.GNNConfig:
    vals = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(gnn.GNNConfig)}
    vals["dtype"] = torch.float32
    vals.update(kw)
    return gnn.GNNConfig(**vals)


JCFG = jreduced_gnn(jget_arch("gatedgcn").config)
JMOL = dataclasses.replace(JCFG, d_edge=4, n_classes=1, readout="graph", d_feat=16)


def carried(jcfg, seed=0):
    params = np_tree(jgnn.init(jax.random.PRNGKey(seed), jcfg))
    return params, gnn.params_from_numpy(params, port_cfg(jcfg), device="cpu")


def node_graph(seed=0, n=128, e=512):
    g = np_tree(jsyn.random_graph(seed, n, e, JCFG.d_feat, JCFG.n_classes))
    return {k: g[k] for k in ("node_feat", "edge_index", "labels")}


def mol_graph(step=0):
    return np_tree(jsyn.molecule_batch(0, step, n_graphs=8, nodes_per=10, edges_per=16,
                                       d_feat=16))


def test_config_and_reduced_match_jax():
    jcfg = jget_arch("gatedgcn").config
    assert get_arch("gatedgcn").config == port_cfg(jcfg)
    assert reduced_gnn(port_cfg(jcfg)) == port_cfg(JCFG)


def test_params_round_trip_layers_stacked():
    params, model = carried(JCFG)
    back = gnn.params_to_numpy(model)
    g, w = flat_np(back), flat_np(params)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    assert back["layers"]["A"].shape == (JCFG.n_layers, JCFG.d_hidden, JCFG.d_hidden)
    mine = gnn.params_to_numpy(gnn.init(1, port_cfg(JCFG), device="cpu"))
    assert np.all(mine["layers"]["bn_h"] == 1)
    assert abs(mine["layers"]["A"].std() - JCFG.d_hidden ** -0.5) < 0.02


@pytest.mark.parametrize("case", ["node", "node_masked_labels", "edge_mask", "graph"])
def test_forward_loss_and_grads(case):
    jcfg = JMOL if case == "graph" else JCFG
    params, model = carried(jcfg, seed=2)
    if case == "graph":
        b = mol_graph(1)
    else:
        b = node_graph(3)
        rng = np.random.default_rng(4)
        if case == "node_masked_labels":
            b["label_mask"] = (rng.random(128) < 0.3).astype(np.float32)
        if case == "edge_mask":
            b["edge_mask"] = (rng.random(512) < 0.8).astype(np.float32)
    with torch.no_grad():
        got = model(torch_batch(b)).numpy()
    want = np.asarray(jgnn.forward(params, jcfg, b))
    assert got.shape == want.shape == ((8, 1) if case == "graph" else (128, jcfg.n_classes))
    assert_close(got, want, **OUT)
    loss, grads = port_grads(model, gnn.train_loss, b)
    jloss, jgrads = jax.value_and_grad(jgnn.train_loss)(params, jcfg, b)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    assert_trees(grads, np_tree(jgrads), **GRAD)


def test_batch_norm_is_population_variance():
    x = np.random.default_rng(0).standard_normal((7, 5)).astype(np.float32)
    s = np.linspace(0.5, 2, 5).astype(np.float32)
    got = gnn._batch_norm(torch.from_numpy(x), torch.from_numpy(s)).numpy()
    assert_close(got, np.asarray(jgnn._batch_norm(x, s)), **OUT)


def jax_draws(key, n_seeds, fanouts):
    """The draws the reference's ``neighbor_sample`` makes from ``key``."""
    out, rng, n = [], key, n_seeds
    for f in fanouts:
        rng, sub = jax.random.split(rng)
        out.append(np.array(jax.random.randint(sub, (n, f), 0, 1 << 30, dtype=jnp.int32)))
        n *= f
    return out


@pytest.mark.parametrize("fanouts", [(4, 3), (5,), (2, 2, 3)])
def test_neighbor_sample_with_reference_draws_is_exact(fanouts):
    g = np_tree(jsyn.random_graph(1, 256, 700, JCFG.d_feat, JCFG.n_classes))
    # Some nodes with no out-edges: they self-loop.
    assert (np.diff(g["indptr"]) == 0).any()
    seeds = np.arange(16, dtype=np.int32) * 7
    key = jax.random.PRNGKey(2)
    want = np_tree(jgnn.neighbor_sample(key, g["indptr"], g["indices"], g["node_feat"],
                                        g["labels"], seeds, fanouts))
    draws = [torch.from_numpy(d) for d in jax_draws(key, 16, fanouts)]
    t = {k: torch.from_numpy(v) for k, v in g.items()}
    got = gnn.neighbor_block(t["indptr"], t["indices"], t["node_feat"], t["labels"],
                             torch.from_numpy(seeds), draws)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].numpy().dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_neighbor_sample_draws_from_a_generator():
    g = synthetic.random_graph(1, 256, 2048, 16, 5, device="cpu")
    gen = torch.Generator().manual_seed(3)
    block = gnn.neighbor_sample(gen, g["indptr"], g["indices"], g["node_feat"], g["labels"],
                                torch.arange(16, dtype=torch.int32), (4, 3))
    assert block["node_feat"].shape[0] == 16 + 64 + 192
    assert tuple(block["edge_index"].shape) == (2, 64 + 192)
    src, dst = block["edge_index"].long()
    nodes = block["block_nodes"].long()
    # every edge joins a sampled neighbour to its parent (or a self-loop)
    indptr, indices = g["indptr"].long(), g["indices"].long()
    for s, d in zip(src.tolist(), dst.tolist()):
        child, parent = int(nodes[s]), int(nodes[d])
        row = indices[indptr[parent]:indptr[parent + 1]]
        assert child in row.tolist() or (row.numel() == 0 and child == parent)
    with torch.no_grad():
        loss = gnn.train_loss(gnn.init(0, port_cfg(JCFG), device="cpu"), block)
    assert np.isfinite(float(loss))
    with pytest.raises(ValueError, match="draws"):
        gnn.neighbor_block(g["indptr"], g["indices"], g["node_feat"], g["labels"],
                           torch.arange(16), [torch.zeros(16, 4, dtype=torch.int32),
                                              torch.zeros(16, 3, dtype=torch.int32)])


def test_random_graph_csr_invariants():
    g = synthetic.random_graph(5, 300, 2000, 8, 4, device="cpu")
    assert g["edge_index"].dtype == torch.int32 and tuple(g["edge_index"].shape) == (2, 2000)
    assert g["indptr"].dtype == torch.int32 and g["indices"].dtype == torch.int32
    assert g["labels"].dtype == torch.int32 and int(g["labels"].max()) < 4
    indptr = g["indptr"].numpy()
    assert indptr[0] == 0 and indptr[-1] == 2000 and np.all(np.diff(indptr) >= 0)
    src, dst = g["edge_index"].numpy()
    order = np.argsort(src, kind="stable")
    np.testing.assert_array_equal(g["indices"].numpy(), dst[order])
    np.testing.assert_array_equal(np.diff(indptr), np.bincount(src, minlength=300))
    again = synthetic.random_graph(5, 300, 2000, 8, 4, device="cpu")
    assert all(torch.equal(g[k], again[k]) for k in g)


def test_molecule_batch_layout():
    got = synthetic.molecule_batch(0, 2, n_graphs=8, nodes_per=10, edges_per=16, d_feat=16,
                                   device="cpu")
    want = mol_graph(2)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if k == "n_graphs":
            assert got[k] == v
            continue
        assert tuple(got[k].shape) == v.shape and got[k].numpy().dtype == v.dtype, k
    src, dst = got["edge_index"].long()
    gids = got["graph_ids"].long()
    assert torch.equal(gids[src], gids[dst])  # edges stay within a graph
    with torch.no_grad():
        loss = gnn.train_loss(gnn.init(0, port_cfg(JMOL), device="cpu"), got)
    assert np.isfinite(float(loss))


def test_step_files_both_ways(tmp_path):
    params, _ = carried(JCFG)
    cfg = port_cfg(JCFG)
    files = step_files_both_ways(
        tmp_path, params, lambda p, b: jgnn.train_loss(p, JCFG, b), node_graph(),
        lambda t: gnn.params_from_numpy(t, cfg, device="cpu"),
        lambda: gnn.init(4, cfg, device="cpu"))
    assert any(n.endswith("__params__layers__A.npy") for n in files)
