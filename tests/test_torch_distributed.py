"""The port's distributed index (``repro_torch.core.distributed`` over
``repro_torch.launch.mesh``) against the JAX package's on the same inputs.

The JAX side runs as ``tests/test_distributed.py`` runs it: a subprocess
with 8 fake CPU devices on a (data=4, model=2) mesh. It builds float32,
int8 (device tier), int8 (host tier) and int4 indexes on that file's
inputs, saves them with its ``save_index``, runs ``make_sharded_search``
in every spelling of :data:`CASES` and ``make_sharded_kmeans_step``, and
writes the outputs. The port's side is one world of 8 gloo ranks on the
CPU on a (4, 2) grid (``mesh.spawn``): each rank loads the JAX-saved
indexes, shards them and makes the same calls. Each fixture runs once for
the file; the cases compare their outputs.

Tolerances: ids, drop counts and shard stats exact; the host tier's
provisional rows and their int8 / int4 / sketch-filtered code-domain
scores bit-equal; float32 scores rtol 1e-5 (the calibration note in
ROADMAP.md); k-means centroids atol 1e-5 (float32 sums in another order).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import faults
from repro_torch.core import distributed as dist_lib
from repro_torch.core import lider
from repro_torch.launch import mesh
from repro_torch.testing import SCORE_ATOL, SCORE_RTOL
from repro_torch.training import checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, P, R0 = 10, 8, 8
GRID = (4, 2)
INDEXES = {
    "f32": {},
    "int8": {"storage_dtype": "int8"},
    "int8_host": {"storage_dtype": "int8", "rescore_tier": "host"},
    "int4": {"storage_dtype": "int4"},
}
HEALTH = [True, False, True, True]
# name -> (index, make_sharded_search options, how it is called). Capacity
# factor 3.0 (no drops) unless given, as in tests/test_distributed.py.
CASES = {
    "f32": ("f32", {}, None),
    "f32_prune": ("f32", {"prune_margin": 0.1}, None),
    "f32_cap05": ("f32", {"capacity_factor": 0.5}, None),
    "f32_health": ("f32", {}, "health"),
    "f32_kill": ("f32", {}, "kill"),
    "int8": ("int8", {}, None),
    "int8_bq8": ("int8", {"block_q": 8}, None),
    "int8_sk2": ("int8", {"sketch_factor": 2}, None),
    "int8_sk2_bq8": ("int8", {"sketch_factor": 2, "block_q": 8}, None),
    "int8_cap05_bq8": ("int8", {"capacity_factor": 0.5, "block_q": 8}, None),
    "host": ("int8_host", {}, None),
    "host_bq8": ("int8_host", {"block_q": 8}, None),
    "host_sk2": ("int8_host", {"sketch_factor": 2}, None),
    "host_sk2_bq8": ("int8_host", {"sketch_factor": 2, "block_q": 8}, None),
    "host_health": ("int8_host", {}, "health"),
    "host_kill_bq8": ("int8_host", {"block_q": 8}, "kill"),
    "int4_sk4": ("int4", {"sketch_factor": 4}, None),
    "int4_sk4_bq8": ("int4", {"sketch_factor": 4, "block_q": 8}, None),
}
# The host-tier cases whose first phase (``search.stage1``: the merged
# provisional rows and their code-domain scores) is compared. JAX exposes
# it on the per-query spelling; the port's cluster-major stage 1 is held to
# that same output.
STAGE1 = {"host": "host", "host_sk2": "host_sk2", "host_bq8": "host", "host_sk2_bq8": "host_sk2",
          "host_health": "host_health"}

JAX_SCRIPT = r'''
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import compat, faults
from repro.core import clustering, distributed, lider
from repro.core.utils import l2_normalize
from repro.training import checkpoint

out_dir = sys.argv[1]
spec = json.loads(sys.argv[2])
mesh = compat.mesh_from_devices(np.array(jax.devices()).reshape(4, 2), ("data", "model"))
kc, kx, kq, kb = jax.random.split(jax.random.PRNGKey(0), 4)
centers = jax.random.normal(kc, (32, 64))
assign = jax.random.randint(kx, (4000,), 0, 32)
x = l2_normalize(centers[assign] + 0.3 * jax.random.normal(kq, (4000, 64)))
q = l2_normalize(x[:64] + 0.05 * jax.random.normal(kb, (64, 64)))
arrays = {"queries": np.asarray(q)}
meta = {"specs": {}, "stats": {}}
params, sharded = {}, {}
for name, extra in spec["indexes"].items():
    cfg = lider.LiderConfig(n_clusters=64, n_probe=8, n_arrays=4, n_leaves=4, kmeans_iters=10, **extra)
    params[name] = lider.build_lider(jax.random.PRNGKey(2), x, cfg)
    checkpoint.save_index(os.path.join(out_dir, name), params[name])
    sharded[name] = distributed.shard_lider_params(mesh, params[name], ("data",))
    specs = distributed.lider_param_specs(params[name], ("data",))
    flat = jax.tree_util.tree_flatten_with_path(params[name])[0]
    leaves = jax.tree.leaves(specs, is_leaf=lambda s: isinstance(s, P))
    meta["specs"][name] = {
        checkpoint._leaf_name(path): [list(e) if isinstance(e, tuple) else e for e in s]
        for (path, _), s in zip(flat, leaves)
    }
def kill():  # a fresh plan for each call: its schedule counts calls
    return faults.FaultPlan([faults.FaultSpec("shard_search", mode="kill_shard",
                                              payload={"shard": 1}, times=(0,))])
for case, (index, opts, call) in spec["cases"].items():
    opts = dict(opts)
    cf = opts.pop("capacity_factor", 3.0)
    search = distributed.make_sharded_search(
        mesh, params[index], k=10, n_probe=8, r0=8, capacity_factor=cf, **opts)
    kw = {"shard_health": np.array(spec["health"])} if call == "health" else {}
    if call == "kill":
        with faults.activate(kill()):
            out, dropped = search(sharded[index], q, **kw)
    else:
        out, dropped = search(sharded[index], q, **kw)
    arrays[case + "__ids"] = np.asarray(out.ids)
    arrays[case + "__scores"] = np.asarray(out.scores)
    arrays[case + "__dropped"] = np.asarray(dropped)
    meta["stats"][case] = search.shard_stats
    if hasattr(search, "stage1"):
        rows, sc, _ = search.stage1(sharded[index], q, **kw)
        arrays[case + "__rows"] = np.asarray(rows)
        arrays[case + "__rows_scores"] = np.asarray(sc)
xk = jax.random.normal(jax.random.PRNGKey(0), (1024, 16))
cen = clustering.init_centroids(jax.random.PRNGKey(1), xk, 16)
step = distributed.make_sharded_kmeans_step(mesh, n_clusters=16)
got = step(jax.device_put(xk, NamedSharding(mesh, P(("data",), None))), cen)
arrays.update(kmeans_x=np.asarray(xk), kmeans_init=np.asarray(cen), kmeans_step=np.asarray(got))
np.savez(os.path.join(out_dir, "jax.npz"), **arrays)
with open(os.path.join(out_dir, "jax.json"), "w") as f:
    json.dump(meta, f)
print("JAX_DONE")
'''


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX package's outputs and its saved indexes (a subprocess with 8
    fake CPU devices)."""
    out = str(tmp_path_factory.mktemp("jax_distributed"))
    spec = json.dumps({"indexes": INDEXES, "cases": CASES, "health": HEALTH})
    proc = subprocess.run(
        [sys.executable, "-c", JAX_SCRIPT, out, spec], capture_output=True, text=True,
        timeout=900, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"), "JAX_PLATFORMS": "cpu"},
    )
    assert proc.returncode == 0 and "JAX_DONE" in proc.stdout, proc.stderr[-3000:]
    with open(os.path.join(out, "jax.json")) as f:
        meta = json.load(f)
    return out, dict(np.load(os.path.join(out, "jax.npz"))), meta


def kill_plan():
    """Shard 1 killed at the first search of the plan (a fresh plan each
    time: its schedule counts the calls made under it)."""
    return faults.FaultPlan([faults.FaultSpec("shard_search", mode="kill_shard",
                                              payload={"shard": 1}, times=(0,))])


def port_rank(world, out_dir, queries, cases, kmeans):
    """One rank of the port's world: the same calls as the JAX script, on
    the rank's own query block."""
    grid = mesh.make_grid(GRID, device=world.device)
    queries = dist_lib.shard_rows(grid, queries, ("model",))
    res = {"specs": {}, "stats": {}, "out": {}}
    params, shards = {}, {}
    for name in INDEXES:
        params[name] = checkpoint.load_index(os.path.join(out_dir, name), device="cpu")
        shards[name] = dist_lib.shard_lider_params(grid, params[name], ("data",))
        res["specs"][name] = dist_lib.lider_param_specs(params[name], ("data",))
    del params
    for case, (index, opts, call) in cases.items():
        opts = dict(opts)
        cf = opts.pop("capacity_factor", 3.0)
        search = dist_lib.make_sharded_search(
            grid, shards[index], k=K, n_probe=P, r0=R0, capacity_factor=cf, **opts)
        kw = {"shard_health": np.array(HEALTH)} if call == "health" else {}
        if call == "kill":
            with faults.activate(kill_plan()):
                out, dropped = search(shards[index], queries, **kw)
        else:
            out, dropped = search(shards[index], queries, **kw)
        full = dist_lib.gather_query_shards(grid, out)
        got = {"ids": full.ids.numpy(), "scores": full.scores.numpy(),
               "dropped": int(dropped), "local": out.ids.numpy()}
        res["stats"][case] = search.shard_stats
        if hasattr(search, "stage1"):
            rows, sc, _ = search.stage1(shards[index], queries, **kw)
            g = dist_lib.gather_query_shards(grid, lider.TopK(ids=rows, scores=sc))
            got["rows"], got["rows_scores"] = g.ids.numpy(), g.scores.numpy()
        res["out"][case] = got
    x, cen = (torch.from_numpy(a) for a in kmeans)
    daxes = mesh.data_axes(grid)
    step = dist_lib.make_sharded_kmeans_step(grid, n_clusters=16, data_axes=daxes)
    res["kmeans"] = step(dist_lib.shard_rows(grid, x, daxes), cen).numpy()
    res["coords"] = grid.coords()
    return res


@pytest.fixture(scope="module")
def port_side(jax_side):
    """Every rank's outputs from one 8-rank gloo world on the CPU."""
    out_dir, arrays, _ = jax_side
    kmeans = (arrays["kmeans_x"], arrays["kmeans_init"])
    return mesh.spawn(8, port_rank, out_dir, arrays["queries"], CASES, kmeans, device="cpu")


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_search_matches_jax(jax_side, port_side, case):
    """ids, drop counts and shard stats exact; scores rtol 1e-5; every rank
    gathers the same batch, and each holds its own query shard."""
    _, arrays, meta = jax_side
    got = port_side[0]["out"][case]
    np.testing.assert_array_equal(got["ids"], arrays[case + "__ids"])
    assert got["dropped"] == int(arrays[case + "__dropped"])
    assert port_side[0]["stats"][case] == meta["stats"][case]
    np.testing.assert_allclose(got["scores"], arrays[case + "__scores"], rtol=SCORE_RTOL,
                               atol=SCORE_ATOL)
    for rank in port_side:
        np.testing.assert_array_equal(rank["out"][case]["ids"], got["ids"])
        qi = rank["coords"]["model"]
        b_loc = got["ids"].shape[0] // GRID[1]
        np.testing.assert_array_equal(rank["out"][case]["local"],
                                      got["ids"][qi * b_loc : (qi + 1) * b_loc])


def test_capacity_drops_and_well_formed_ids(port_side):
    """Capacity 0.5 drops pairs and still returns ids of the corpus; 3.0
    drops none."""
    out = port_side[0]["out"]
    for case in ("f32_cap05", "int8_cap05_bq8"):
        assert out[case]["dropped"] > 0
        ids = out[case]["ids"]
        assert ((ids >= -1) & (ids < 4000)).all() and (ids >= 0).any()
    assert out["f32"]["dropped"] == 0 and out["int8_bq8"]["dropped"] == 0


@pytest.mark.parametrize("case", list(STAGE1))
def test_host_tier_first_phase_bit_equal(jax_side, port_side, case):
    """The host tier's merged provisional rows and code-domain scores (int8,
    and behind the sketch pass) equal JAX's per-query stage 1 bit for bit,
    from either spelling."""
    _, arrays, _ = jax_side
    want = STAGE1[case]
    got = port_side[0]["out"][case]
    np.testing.assert_array_equal(got["rows"], arrays[want + "__rows"])
    np.testing.assert_array_equal(got["rows_scores"].view(np.int32),
                                  arrays[want + "__rows_scores"].view(np.int32))


@pytest.mark.parametrize("pair", [("int8_bq8", "int8"), ("int8_sk2_bq8", "int8_sk2"),
                                  ("host_bq8", "host"), ("host_sk2_bq8", "host_sk2"),
                                  ("int4_sk4_bq8", "int4_sk4")])
def test_grouped_equals_per_query_bit_for_bit(port_side, pair):
    out = port_side[0]["out"]
    a, b = pair
    np.testing.assert_array_equal(out[a]["ids"], out[b]["ids"])
    np.testing.assert_array_equal(out[a]["scores"].view(np.int32), out[b]["scores"].view(np.int32))


@pytest.mark.parametrize("full,part,kill", [("f32", "f32_health", "f32_kill"),
                                            ("host_bq8", "host_health", "host_kill_bq8")])
def test_degraded_shard_serves_partial_results(jax_side, port_side, full, part, kill):
    """Shard 1 dead: none of its passages is served, every live-shard answer
    of the full search survives, and the injected kill gives the mask's
    answers bit for bit; 3 of 4 shards live."""
    out_dir, _, _ = jax_side
    index = CASES[part][0]
    gids = checkpoint.load_index(os.path.join(out_dir, index), device="cpu").bank.gids.numpy()
    dead = set(gids[16:32].ravel().tolist()) - {-1}
    out = port_side[0]["out"]
    fids, pids = out[full]["ids"], out[part]["ids"]
    assert not set(pids.ravel().tolist()) & dead
    assert set(fids.ravel().tolist()) & dead
    for f, p in zip(fids, pids):
        assert set(f[f >= 0]) - dead <= set(p[p >= 0])
    np.testing.assert_array_equal(out[kill]["ids"], pids)
    np.testing.assert_array_equal(out[kill]["scores"].view(np.int32), out[part]["scores"].view(np.int32))
    assert port_side[0]["stats"][kill] == {"shards_live": 3, "shards_total": 4}


def test_sharded_kmeans_step_matches_jax(jax_side, port_side):
    _, arrays, _ = jax_side
    for rank in port_side:
        np.testing.assert_allclose(rank["kmeans"], arrays["kmeans_step"], atol=1e-5, rtol=0)


@pytest.mark.parametrize("index", list(INDEXES))
def test_param_specs_match_jax(jax_side, port_side, index):
    """The layout of every leaf, by leaf name, derived from the bank's field
    metadata, equals JAX's PartitionSpecs."""
    _, _, meta = jax_side

    def entry(e):  # JAX writes a one-axis tuple as the axis name itself
        e = list(e) if isinstance(e, (tuple, list)) else e
        return e[0] if isinstance(e, list) and len(e) == 1 else e

    got = {n: [entry(e) for e in s] for n, s in port_side[0]["specs"][index].items()}
    assert got == {n: [entry(e) for e in s] for n, s in meta["specs"][index].items()}
    sharded = {n for n, s in got.items() if s}
    assert "bank__embs" in sharded and "bank__gids" in sharded
    assert not {"bank__lsh__projections", "bank__next_gid", "centroids"} & sharded


def one_rank(world, out_dir, queries):
    grid = mesh.make_grid((1, 1), device=world.device)
    out = {}
    for index, kw in (("f32", {}), ("int8_host", {"block_q": 8})):
        params = checkpoint.load_index(os.path.join(out_dir, index), device="cpu")
        shard = dist_lib.shard_lider_params(grid, params)
        search = dist_lib.make_sharded_search(grid, shard, k=K, n_probe=P, r0=R0, **kw)
        got, dropped = search(shard, queries)
        want = lider.search_lider(params, queries, k=K, n_probe=P, r0=R0, **kw)
        out[index] = (got.ids.numpy(), want.ids.numpy(), got.scores.numpy(),
                      want.scores.numpy(), int(dropped))
    return out


def test_one_rank_world_equals_search_lider(jax_side):
    """A one-rank grid is the single-device search: the float32 index, and
    the host-tier int8 index cluster-major."""
    out_dir, arrays, _ = jax_side
    (res,) = mesh.spawn(1, one_rank, out_dir, arrays["queries"], device="cpu")
    for got_ids, want_ids, got_sc, want_sc, dropped in res.values():
        assert dropped == 0
        np.testing.assert_array_equal(got_ids, want_ids)
        np.testing.assert_array_equal(got_sc, want_sc)


def test_example_runs_on_cpu():
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "distributed_search_demo_torch.py"),
         "--device", "cpu"],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")},
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout
    assert "grid: {'data': 4, 'model': 2}" in lines
    assert "capacity drops=0" in lines
    assert "distributed == single-device result overlap: 1.0000" in lines


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _card_corpus():
    from repro_torch.data import synthetic

    x = synthetic.retrieval_corpus(0, 8192, 64, device="cpu")
    q, _ = synthetic.retrieval_queries(1, x, 64)
    return x, q


def card_rank(world, params, queries, x, cen):
    """Two ranks on the card: the per-query float32 search and the sharded
    Lloyd step."""
    grid = mesh.make_grid((2, 1), device=world.device)
    shard = dist_lib.shard_lider_params(grid, params)
    search = dist_lib.make_sharded_search(grid, shard, k=K, n_probe=P, r0=R0)
    out, dropped = search(shard, queries)
    step = dist_lib.make_sharded_kmeans_step(grid, n_clusters=cen.shape[0])
    x_loc = dist_lib.shard_rows(grid, x).to(world.device)
    new = step(x_loc, cen.to(world.device))
    return out.ids.cpu().numpy(), out.scores.cpu().numpy(), int(dropped), new.cpu().numpy()


@pytest.mark.gpu
def test_two_ranks_on_the_card_equal_single_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, q = _card_corpus()
    cfg = lider.LiderConfig(n_clusters=64, n_probe=P, n_arrays=4, n_leaves=4, kmeans_iters=5)
    params = lider.build_lider(0, x.cuda(), cfg, device="cuda")
    want = lider.search_lider(params, q, k=K, n_probe=P, r0=R0)
    res = mesh.spawn(2, card_rank, params, q.numpy(), x, params.centroids.cpu())
    ids, sc, dropped, _ = res[0]
    assert dropped == 0
    np.testing.assert_array_equal(ids, want.ids.cpu().numpy())
    np.testing.assert_allclose(sc, want.scores.cpu().numpy(), rtol=SCORE_RTOL, atol=SCORE_ATOL)


@pytest.mark.gpu
def test_sharded_lloyd_step_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core import clustering

    x, q = _card_corpus()
    cfg = lider.LiderConfig(n_clusters=64, n_probe=P, n_arrays=4, n_leaves=4, kmeans_iters=5)
    params = lider.build_lider(0, x.cuda(), cfg, device="cuda")
    cen = params.centroids
    sums, counts, _ = clustering.kmeans_step(x.cuda(), cen, n_clusters=64)
    want = clustering.update_centroids(cen, sums, counts).cpu().numpy()
    res = mesh.spawn(2, card_rank, params, q.numpy(), x, cen.cpu())
    for r in res:
        np.testing.assert_allclose(r[3], want, atol=1e-5, rtol=0)
