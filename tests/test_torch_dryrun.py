"""The dry run (``repro_torch.launch.{steps,dryrun}`` and the production
grid of ``launch/mesh.py``) against the JAX package's, and the repairs it
needed.

- Every (arch x shape) cell on both production grids: the port's bundles
  on rank 0 of fake 256- and 512-rank worlds, built without running a
  step, against the JAX bundles on ``make_production_mesh`` (one
  subprocess a mesh with ``xla_force_host_platform_device_count``, as
  ``tests/test_distributed.py`` runs JAX): per-rank argument bytes (the
  sum of ``NamedSharding.shard_shape`` over the arguments) equal, up to
  three departures pinned to the byte (``launch/steps.py``: the GNN's
  whole node arrays on the full-batch cells, the int64 hash keys of the
  retrieval cells, the decode cache's host ``length``); ``model_flops``
  rtol 1e-12, ``loop_factor`` and the skipped cells equal;
  ``lider_tier_memory`` equal dict for dict up to the keys' bytes.
- A fake 2x2 world against a real 2x2 gloo world on the CPU at one small
  LM train cell and one small retrieval search cell: rank 0's collective
  counts and bytes by kind, argument bytes and output shapes equal. In the
  real world also each recsys kind's ``retrieval_cand`` step: its top 100
  over every rank's candidates against one device's.
- A train step's two micro-batches scaled to four == four run.
- The LM dry run's two depths carried to the layer count equal a run at
  that depth, exactly.
- The uneven head split (``models/transformer.py::_heads``): LMs whose
  heads do not split over ``model`` (3 / 1, 4 / 1 and 6 / 3 query / kv
  heads over the 2 model ranks of the same 2x2 gloo world: every path of
  ``_heads``) against the single device:
  loss rtol 1e-5, gradients rtol 1e-4 (atol 1e-6 with a floor of 1e-5 of
  the leaf's largest), prefill and decode logits on both cache layouts
  rtol 1e-5 (``test_torch_sharding.py``'s tolerances); and what the split
  sends, to the call and the byte.
- The kernels' shape-only branches for fake tensors against the plain
  versions' outputs (shapes, dtypes).
- ``dryrun.main`` on one cell per family, and its exit code on a failure.
"""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import threading
import types

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import counting
from repro_torch.configs import ARCHS
from repro_torch.configs.base import ArchSpec, ShapeSpec
from repro_torch.configs.lider_msmarco import RetrievalArchConfig
from repro_torch.core import distributed as dist_lib
from repro_torch.core import lider
from repro_torch.kernels import ops, quant
from repro_torch.launch import dryrun, mesh, steps
from repro_torch.models import sharding, transformer as tfm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = [(a, s.name) for a, arch in ARCHS.items() for s in arch.shapes]
MESHES = (256, 512)
OUT = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)

_JAX_SCRIPT = """
import json, math, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=%d"
import jax, numpy as np
from repro import compat
from repro.configs import ARCHS
from repro.launch.mesh import make_production_mesh
from repro.launch.steps import make_bundle

mesh = make_production_mesh(multi_pod=%d == 512)
out = {}
with compat.set_mesh(mesh):
    for arch_id, arch in ARCHS.items():
        for shape in arch.shapes:
            key = arch_id + ":" + shape.name
            if shape.name in arch.skip_shapes:
                out[key] = {"skipped": True}
                continue
            b = make_bundle(arch, shape, mesh)
            leaves = jax.tree_util.tree_leaves(b.args)
            shardings = jax.tree_util.tree_leaves(
                b.in_shardings, is_leaf=lambda x: isinstance(x, jax.sharding.Sharding))
            assert len(leaves) == len(shardings), key
            arg = sum(math.prod(s.shard_shape(l.shape)) * np.dtype(l.dtype).itemsize
                      for l, s in zip(leaves, shardings))
            out[key] = {"skipped": False, "arg_bytes": int(arg), "model_flops": b.model_flops,
                        "loop_factor": b.loop_factor, "tier_memory": b.tier_memory}
print(json.dumps(out))
"""


def _port_cells(n: int) -> dict:
    """{cell: record} from the port's bundles on rank 0 of a fake world of
    ``n`` ranks, built without running a step."""
    cells = {}
    with mesh.fake_world(n):
        grid = mesh.make_production_grid(multi_pod=n == 512, device=dryrun.dry_device())
        for arch_id, shape_name in CELLS:
            arch = ARCHS[arch_id]
            if shape_name in arch.skip_shapes:
                cells[f"{arch_id}:{shape_name}"] = {"skipped": True}
                continue
            with FakeTensorMode():
                b = steps.make_bundle(arch, arch.shape(shape_name), grid, device=dryrun.dry_device())
                cells[f"{arch_id}:{shape_name}"] = {
                    "skipped": False, "arg_bytes": steps.nbytes(steps.arg_tensors(b.args)),
                    "model_flops": b.model_flops, "loop_factor": b.loop_factor,
                    "tier_memory": b.tier_memory, "departure": _departure(arch, shape_name, n)}
    return cells


@pytest.fixture(scope="module")
def cells():
    """({n: JAX's {cell: record}}, {n: the port's}): the JAX package in one
    subprocess a mesh, both started before the port's bundles are built."""
    env = {**os.environ, "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu"}
    procs = {n: subprocess.Popen([sys.executable, "-c", textwrap.dedent(_JAX_SCRIPT % (n, n))],
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                 env=env, cwd=ROOT) for n in MESHES}
    port = {n: _port_cells(n) for n in MESHES}
    ref = {}
    for n, p in procs.items():
        stdout, stderr = p.communicate(timeout=600)
        assert p.returncode == 0, stderr[-3000:]
        ref[n] = json.loads(stdout.strip().splitlines()[-1])
    return ref, port


def _departure(arch, shape_name: str, n: int) -> int:
    """The bytes a rank holds past the reference's device (module docstring)."""
    shape = arch.shape(shape_name)
    if arch.family == "gnn" and shape_name in ("full_graph_sm", "ogb_products"):
        d = shape.dims
        nodes = -(-d["n_nodes"] // 1024) * 1024
        whole = nodes * d["d_feat"] * 4 + nodes * 4 + nodes * 4  # node_feat, labels, label_mask
        return whole - whole // 16  # the reference's node arrays split over model (16)
    if arch.family == "retrieval" and shape.kind != "build":
        cfg, s = arch.config.lider, n // 16
        c_loc = cfg.n_clusters // s
        bank = c_loc * cfg.n_arrays * arch.config.capacity + 2 * c_loc * cfg.n_arrays
        centroid = cfg.n_arrays_centroid * cfg.n_clusters + 2 * cfg.n_arrays_centroid
        return 4 * (bank + centroid)  # int64 keys, key_min, key_max against uint32
    if arch.family == "lm" and shape.kind == "decode":
        return -4  # the cache's length: a host int against a 4-byte device scalar
    return 0


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("cell", [f"{a}:{s}" for a, s in CELLS])
def test_cells_match_reference(cells, n, cell):
    want, got = cells[0][n][cell], cells[1][n][cell]
    assert got["skipped"] == want["skipped"]
    if want["skipped"]:
        return
    assert got["arg_bytes"] == want["arg_bytes"] + got["departure"]
    np.testing.assert_allclose(got["model_flops"], want["model_flops"], rtol=1e-12)
    assert got["loop_factor"] == want["loop_factor"]
    assert (got["tier_memory"] is None) == (want["tier_memory"] is None)
    if want["tier_memory"] is not None:
        rcfg = ARCHS[cell.split(":")[0]].config
        keys = 4 * (rcfg.lider.n_clusters * rcfg.lider.n_arrays * (rcfg.capacity + 2))
        for name, tiers in want["tier_memory"].items():
            extra = keys if name != "sketch_table" else 0
            assert got["tier_memory"][name] == {"device": tiers["device"] + extra,
                                                "host": tiers["host"]}, name


# ---------------------------------------------------------------------------
# A fake world against a real gloo world
# ---------------------------------------------------------------------------

SMALL_LM = tfm.LMConfig(name="small", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                        vocab=256, qkv_bias=True, dtype=torch.float32, loss_chunk=16)
SMALL_LM_ARCH = ArchSpec("small-lm", "lm", SMALL_LM,
                         (ShapeSpec("train", "train", {"seq_len": 32, "global_batch": 8}),))
SMALL_RET = RetrievalArchConfig(
    lider=lider.LiderConfig(n_clusters=8, n_probe=4, n_arrays=4, n_arrays_centroid=4, key_len=8,
                            key_len_centroid=4, n_leaves=4, n_leaves_centroid=4, capacity=256),
    corpus_size=1024, dim=32, capacity=256, k=10)
SMALL_RET_ARCH = ArchSpec("small-lider", "retrieval", SMALL_RET,
                          (ShapeSpec("serve", "retrieval_serve", {"batch": 8}),))


def _fill(args, seed: int) -> None:
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for t in steps.arg_tensors(args):
            if t.is_floating_point():
                t.copy_(torch.randn(t.shape, generator=g) * 0.02)
            else:
                t.zero_()


def _small_index():
    x = torch.nn.functional.normalize(torch.randn(1024, 32, generator=torch.Generator().manual_seed(0)),
                                      dim=-1)
    return lider.build_lider(0, x, SMALL_RET.lider, device="cpu"), x


def _shapes(out) -> list:
    return [tuple(t.shape) for t in steps.arg_tensors(out)]


def _cell_reading(grid, arch, shape, device, *, real_index=None) -> dict:
    """Build one cell's bundle on the grid, run it under the dry run's
    counter and read rank 0's collectives, FLOPs and bytes accessed,
    argument bytes and output shapes."""
    b = steps.make_bundle(arch, shape, grid, device=device)
    if real_index is not None:
        params, x = real_index
        b.args = (dist_lib.shard_lider_params(grid, params, ("data",)),
                  x[: shape.dims["batch"]].reshape(2, -1, x.shape[1])[grid.coords()["model"]])
    elif device.type == "cpu" and not any(isinstance(t, torch._subclasses.FakeTensor)
                                          for t in steps.arg_tensors(b.args)):
        _fill(b.args, grid.rank)
    arg_bytes = steps.nbytes(steps.arg_tensors(b.args))
    grid.comm_by_kind.clear()
    counter = dryrun.StepCounter()
    with mesh.use_grid(grid), counting.counting(counter), counter:
        out = b.fn(*b.args)
    return {"comm": {k: dict(v) for k, v in grid.comm_by_kind.items()}, "arg_bytes": arg_bytes,
            "shapes": _shapes(out), "cost": (counter.flops, counter.bytes_accessed)}


CAND = ShapeSpec("retrieval_cand", "retrieval", {"batch": 1, "n_candidates": 402})


def _single_scores(kind: str, model, args: tuple, cands: torch.Tensor) -> torch.Tensor:
    """Every candidate's score on one device (no grid), as the step scores
    its own: ``args`` the step's query arguments, ``cands`` every
    candidate."""
    from repro_torch.models import recsys

    if kind == "two_tower":
        return cands @ recsys.user_embed(model, args[0])[0]
    if kind == "sasrec":
        h = recsys.sasrec_forward(model, args[0])[:, -1]
        return recsys.embedding_lookup(model.item_emb, cands) @ h[0]
    if kind == "din":
        hist = args[0].expand(cands.shape[0], -1)
        return recsys.din_forward(model, {"history": hist, "target": cands})
    return recsys.xdeepfm_forward(model, {"fields": cands})


def candidate_tops(grid) -> dict:
    """Each recsys kind's ``retrieval_cand`` step on the grid, and the top
    100 of every candidate scored on one device from the same weights (the
    rank's blocks unsharded) and the same candidates (every data rank's
    block gathered). 402 candidates: 201 a data rank, which xDeepFM's rows
    pad to split over model."""
    from repro_torch.core.utils import stable_topk
    from repro_torch.launch.train import reduced_recsys
    from repro_torch.models import recsys

    out = {}
    d_idx = grid.flat_index(("data",))
    for kind, arch_id in (("sasrec", "sasrec"), ("two_tower", "two-tower-retrieval"),
                          ("din", "din"), ("xdeepfm", "xdeepfm")):
        cfg = reduced_recsys(ARCHS[arch_id].config)
        arch = dataclasses.replace(ARCHS[arch_id], config=cfg)
        b = steps.make_bundle(arch, CAND, grid, device="cpu")
        model, *query, cands = b.args
        _fill((model, *query), 0)  # the same on every rank
        g = torch.Generator().manual_seed(1 + d_idx)  # each data rank its candidates
        with torch.no_grad():
            if cands.is_floating_point():
                cands.copy_(torch.randn(cands.shape, generator=g))
            else:
                cands.copy_(torch.randint(0, 256, cands.shape, generator=g))
            for t in query:
                t.copy_(torch.randint(1, 256, t.shape, generator=torch.Generator().manual_seed(7)))
        with mesh.use_grid(grid):
            scores, ids = b.fn(*b.args)
        full = sharding.unshard_named(dict(model.named_parameters()), grid)
        every = sharding.unshard(cands, (("data",),), grid)
        single = recsys.MODELS[kind](cfg, torch.device("cpu"))
        single.load_state_dict(full)
        with torch.no_grad():
            want = stable_topk(_single_scores(kind, single, tuple(query), every).float(), 100)
        out[kind] = (scores.numpy(), ids.numpy(), want[0].numpy(), want[1].numpy())
    return out


def real_world_rank(world):
    """One rank of the real 2x2 gloo world: both small cells, the recsys
    candidates' global top-k, then the uneven head splits (below)."""
    grid = mesh.make_grid((2, 2), device="cpu")
    dev = torch.device("cpu")
    return {"lm": _cell_reading(grid, SMALL_LM_ARCH, SMALL_LM_ARCH.shapes[0], dev),
            "lider": _cell_reading(grid, SMALL_RET_ARCH, SMALL_RET_ARCH.shapes[0], dev,
                                   real_index=_small_index()),
            "candidates": candidate_tops(grid),
            "uneven": uneven_cases(grid)}


@pytest.mark.parametrize("kind", ["sasrec", "two_tower", "din", "xdeepfm"])
def test_candidate_top_k_is_global(real_world, kind):
    """The ``retrieval_cand`` step's top 100 over every rank's candidates
    == one device's over all of them: scores rtol 1e-5, ids equal up to
    swaps of near-equal scores (the candidates repeat ids, and a rank's
    product of fewer rows may round the last place otherwise)."""
    from repro_torch.testing import assert_topk_match

    for rank in real_world:
        scores, ids, want_scores, want_ids = rank["candidates"][kind]
        np.testing.assert_allclose(scores, want_scores, rtol=1e-5, atol=1e-6)
        assert_topk_match(ids[None], scores[None], want_ids[None], want_scores[None])


@pytest.fixture(scope="module")
def real_world():
    return mesh.spawn(4, real_world_rank, device="cpu")


@pytest.fixture(scope="module")
def worlds(real_world):
    real = real_world
    with mesh.fake_world(4):
        grid = mesh.make_grid((2, 2), device="cpu")
        with FakeTensorMode():
            fake = {"lm": _cell_reading(grid, SMALL_LM_ARCH, SMALL_LM_ARCH.shapes[0],
                                        torch.device("cpu")),
                    "lider": _cell_reading(grid, SMALL_RET_ARCH, SMALL_RET_ARCH.shapes[0],
                                           torch.device("cpu"))}
    return real, fake


@pytest.mark.parametrize("cell", ["lm", "lider"])
def test_fake_world_equals_real_world(worlds, cell):
    real, fake = worlds
    want, got = real[0][cell], fake[cell]
    assert got["comm"] == want["comm"] and got["comm"]
    # The same ops dispatch; the search's kernels report the same cost from
    # their plain versions (real) and their shape-only branches (fake).
    assert got["cost"] == want["cost"] and min(got["cost"]) > 0
    assert got["arg_bytes"] == want["arg_bytes"]
    assert got["shapes"] == want["shapes"]


def test_lm_depths_carry_to_the_layer_count():
    """The dry run's two runs (depths 1 and 2) carried to 3 layers == a
    run of the 3-layer model: memory, FLOPs, bytes accessed and
    collectives exactly."""
    cfg = dataclasses.replace(SMALL_LM, n_layers=3)
    arch = dataclasses.replace(SMALL_LM_ARCH, config=cfg)
    shape = arch.shapes[0]
    with mesh.fake_world(4):
        grid = mesh.make_grid((2, 2), device="cpu")
        with FakeTensorMode():
            full = dryrun.run_bundle(steps.make_bundle(arch, shape, grid, device="cpu"), grid)
        carried = dryrun.measure(arch, shape, grid, device="cpu")
    assert carried.pop("depth") == {"run": [1, 2], "layers": 3}
    assert {k: carried[k] for k in full} == full
    assert full["collectives"]["all-gather"]["count"] > 0
    assert full["cost"]["bytes_accessed"] > 0 and full["cost"]["flops"] > 0


@pytest.mark.parametrize("cell", ["lm", "lider"])
def test_real_tensors_count_as_fake_ones(cell):
    """``dryrun.measure(fake=False)``, as ``chip_smoke.py`` runs it on the
    card: the small LM train cell on real uninitialised tensors and the
    small search cell on a real index, on rank 0 of a fake 2x2 world, count
    the FLOPs, bytes and collectives of the fake run exactly (the same ops
    dispatch; the kernels run their plain versions and report the same
    cost as their shape-only branches)."""
    arch = SMALL_LM_ARCH if cell == "lm" else SMALL_RET_ARCH
    shape = arch.shapes[0]
    with mesh.fake_world(4):
        grid = mesh.make_grid((2, 2), device="cpu")
        fake = dryrun.measure(arch, shape, grid, device="cpu")
        args = None
        if cell == "lider":
            params, x = _small_index()
            args = (dist_lib.shard_lider_params(grid, params, ("data",)),
                    x[: shape.dims["batch"]].reshape(2, -1, x.shape[1])[0])
        real = dryrun.measure(arch, shape, grid, device="cpu", fake=False, args=args)
    assert real["cost"] == fake["cost"] and min(real["cost"].values()) > 0
    assert real["collectives"] == fake["collectives"]


def _one_layer_step(grid):
    """The small LM train cell at one layer and one micro-batch, built on
    fake tensors on ``grid``."""
    arch = dataclasses.replace(SMALL_LM_ARCH, config=dataclasses.replace(SMALL_LM, n_layers=1))
    return steps.make_bundle(arch, arch.shapes[0], grid, device="cpu", grad_accum=1)


def test_step_counter_flops_equal_flop_counter_mode():
    """``StepCounter.flops`` (``torch.utils.flop_counter``'s formulas op by
    op) == ``FlopCounterMode``'s total over the same run: a small LM train
    step on rank 0 of a fake 2x2 world, attention and the checkpointed
    layer's recompute included (no kernel runs there)."""
    from torch.utils.flop_counter import FlopCounterMode

    with mesh.fake_world(4):
        grid = mesh.make_grid((2, 2), device="cpu")
        with FakeTensorMode():
            b = _one_layer_step(grid)
            counter = dryrun.StepCounter()
            with (mesh.use_grid(grid), FlopCounterMode(display=False) as ref,
                  counting.counting(counter), counter):
                b.fn(*b.args)
    assert counter.flops == ref.get_total_flops() > 0


def _backward_on_a_thread(monkeypatch):
    """``Tensor.backward`` run on a thread of its own under the caller's
    dispatch modes, as autograd runs a card's backward on its device
    thread."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    backward = torch.Tensor.backward

    def on_a_thread(self, *a, **kw):
        modes, errors = _get_current_dispatch_mode_stack(), []

        def body():
            try:
                with contextlib.ExitStack() as stack:
                    for m in modes:
                        stack.enter_context(m)
                    backward(self, *a, **kw)
            except BaseException as e:  # noqa: BLE001 - raised on the caller's thread
                errors.append(e)

        t = threading.Thread(target=body)
        t.start()
        t.join()
        if errors:
            raise errors[0]

    monkeypatch.setattr(torch.Tensor, "backward", on_a_thread)


def test_backward_on_another_thread_counts_the_same(monkeypatch):
    """A report reaches the counter from any thread, and hiding is a
    thread's own. So a small LM train step (rank 0 of a fake 2x2 world, its
    backward's collectives included) counts the same FLOPs, bytes and
    collectives with its backward run on another thread."""
    seen = []
    with counting.counting(types.SimpleNamespace(add=lambda *c: seen.append(c))):
        with counting.hidden():
            t = threading.Thread(target=counting.report, args=(1, 2))
            t.start()
            t.join()
            counting.report(3, 4)  # hidden here: the wrapper around it reports
        counting.report(5, 6)
    assert seen == [(1, 2), (5, 6)]

    def run():
        with mesh.fake_world(4):
            grid = mesh.make_grid((2, 2), device="cpu")
            with FakeTensorMode():
                return dryrun.run_bundle(_one_layer_step(grid), grid)

    here = run()
    _backward_on_a_thread(monkeypatch)
    there = run()
    assert there["cost"] == here["cost"] and there["collectives"] == here["collectives"]
    assert here["collectives"]["all-reduce"]["count"] > 0


def test_micro_batches_scale_to_the_step():
    """A train step of 4 micro-batches run as the dry run runs it (3 of
    them, the second's counts repeated) == the step run in full: FLOPs,
    bytes accessed, collectives and the peak, exactly."""
    cfg = dataclasses.replace(SMALL_LM, n_layers=1)
    arch = dataclasses.replace(SMALL_LM_ARCH, config=cfg)
    shape = arch.shapes[0]  # 8 rows over 2 data ranks: 4 micro-batches of 1
    with mesh.fake_world(4):
        grid = mesh.make_grid((2, 2), device="cpu")
        with FakeTensorMode():
            two = steps.make_bundle(arch, shape, grid, device="cpu")
            assert (two.accum, two.accum_run) == (4, 3)
            scaled = dryrun.run_bundle(two, grid)
            full = steps.make_bundle(arch, shape, grid, device="cpu")
            full.fn = steps._train_fn(tfm.train_loss, 4, 4, full.micro_hooks)
            grid.comm_by_kind.clear()
            whole = dryrun.run_bundle(full, grid)
    assert scaled == whole
    assert whole["cost"]["bytes_accessed"] > 0


# ---------------------------------------------------------------------------
# The uneven head split
# ---------------------------------------------------------------------------

UNEVEN = {  # query / kv heads over the 2 model ranks of the 2x2 grid
    "q_kv_gathered": (3, 1),  # 3 % 2: the q columns are gathered too
    "kv_gathered": (4, 1),  # whole query heads, GQA's kv gathered
    "kv_by_index": (6, 3),  # a rank's 3 query heads read kv heads (0, 0, 1): one a head
}


def _uneven_cfg(hq: int, hkv: int) -> tfm.LMConfig:
    return tfm.LMConfig(name=f"u{hq}-{hkv}", n_layers=2, d_model=8 * hq, n_heads=hq,
                        n_kv_heads=hkv, d_head=8, d_ff=64, vocab=128, qkv_bias=True,
                        dtype=torch.float32, loss_chunk=16)


def _uneven_inputs(name: str):
    cfg = _uneven_cfg(*UNEVEN[name])
    model = tfm.init(3, cfg, device="cpu")
    named = {n: p.detach().clone() for n, p in model.named_parameters()}
    rng = np.random.default_rng(4)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (8, 33)))
    return cfg, named, tokens


def _decode_run(model, tokens, *, seq_sharded: bool) -> list:
    lg, cache = tfm.prefill(model, tokens[:, :16], max_len=32, seq_sharded=seq_sharded)
    out = [lg]
    for i in range(3):
        lg, cache = tfm.decode_step(model, cache, tokens[:, 16 + i : 17 + i])
        out.append(lg)
    return out


def uneven_cases(grid) -> dict:
    """On a rank of the grid: each UNEVEN model's loss, gathered gradients
    and decode logits (both cache layouts, gathered)."""
    res = {}
    for name in UNEVEN:
        cfg, named, tokens = _uneven_inputs(name)
        model = sharding.shard_module(tfm.Transformer(cfg, device="meta"),
                                      tfm.param_specs(cfg, grid.axis_names), grid, source=named,
                                      device="cpu")
        batch = sharding.shard_batch({"tokens": tokens[:, :32], "targets": tokens[:, 1:]}, grid)
        with mesh.use_grid(grid):
            loss = tfm.train_loss(model, batch)
            loss.backward()
        grads = {n: sharding.unshard(p.grad, sharding.spec_of(p), grid).numpy()
                 for n, p in model.named_parameters()}
        dec = {}
        for ss in (False, True):
            rows = tokens if ss else sharding.shard_batch({"t": tokens}, grid)["t"]
            with torch.no_grad(), mesh.use_grid(grid):
                lgs = _decode_run(model, rows[:1] if ss else rows, seq_sharded=ss)
            spec = (None, None) if ss else (("data",), None)
            dec[ss] = [sharding.unshard(t, spec, grid).numpy() for t in lgs]
        res[name] = (float(loss.detach()), grads, dec)
    return res


def _assert_close(got, want, *, rtol, atol, err_msg=""):
    floor = max(atol, 1e-5 * float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=floor, err_msg=err_msg)


@pytest.mark.parametrize("name", list(UNEVEN))
def test_uneven_heads_match_single_device(real_world, name):
    cfg, named, tokens = _uneven_inputs(name)
    assert not tfm._layout(cfg, _FakeGrid(2)).whole_heads
    model = tfm.Transformer(cfg, device="cpu")
    model.load_state_dict(named)
    loss = tfm.train_loss(model, {"tokens": tokens[:, :32], "targets": tokens[:, 1:]})
    loss.backward()
    with torch.no_grad():
        dec = {ss: [t.numpy() for t in _decode_run(model, tokens[:1] if ss else tokens,
                                                   seq_sharded=ss)] for ss in (False, True)}
    for rank in real_world:
        got_loss, grads, got_dec = rank["uneven"][name]
        np.testing.assert_allclose(got_loss, float(loss.detach()), rtol=1e-5)
        for ss in (False, True):
            for g, w in zip(got_dec[ss], dec[ss]):
                _assert_close(g, w, **OUT)
    for n, p in model.named_parameters():
        _assert_close(real_world[0]["uneven"][name][1][n], p.grad.numpy(), err_msg=n, **GRAD)


def test_uneven_heads_cost_their_gathers():
    """What the uneven split sends, per layer of a train step, pinned: GQA's
    2 kv heads over 16 model ranks against the same model with 16 kv heads
    (whole), on a (1, 16) grid (no data axis, so no FSDP traffic): 4 more
    all-gathers (k and v, forward and the checkpointed recompute) of the
    rank's B x S x (2 d_head / 16) columns and 2 more all-reduces (their
    gradients) of B x S x 2 d_head, float32 here (PERF.md's cost)."""
    cfg = tfm.LMConfig(name="gqa", n_layers=1, d_model=128, n_heads=16, n_kv_heads=2, d_head=8,
                       d_ff=64, vocab=256, dtype=torch.float32, loss_chunk=16)
    shape = ShapeSpec("train", "train", {"seq_len": 16, "global_batch": 2})
    got = {}
    with mesh.fake_world(16):
        grid = mesh.make_grid((1, 16), device="cpu")
        for kv in (2, 16):
            c = dataclasses.replace(cfg, n_kv_heads=kv)
            arch = ArchSpec("gqa", "lm", c, (shape,))
            got[kv] = dryrun.measure(arch, shape, grid, device="cpu", grad_accum=1)["collectives"]
    b, s, cols = 2, 16, 2 * 8
    none = {"count": 0, "bytes": 0}
    diff = {k: {f: got[2][k][f] - got[16].get(k, none)[f] for f in none} for k in got[2]}
    assert diff == {"all-gather": {"count": 4, "bytes": 4 * b * s * cols // 16 * 4},
                    "all-reduce": {"count": 2, "bytes": 2 * b * s * cols * 4}}


class _FakeGrid:
    axis_names = ("data", "model")

    def __init__(self, model: int):
        self.m = model

    def axis_size(self, axes):
        return self.m if tuple(axes) == ("model",) else 1


# ---------------------------------------------------------------------------
# The kernels' shape-only branches
# ---------------------------------------------------------------------------


def _kernel_cases():
    g = torch.Generator().manual_seed(0)
    f = lambda *s: torch.randn(s, generator=g)  # noqa: E731
    rows = torch.randint(0, 50, (4, 6), generator=g, dtype=torch.int32)
    q = f(4, 32)
    codes, scales = quant.quantize_rows(f(50, 32))
    packed = quant.pack_int4(torch.clamp(codes, -8, 7))
    sk = quant.sketch_rows(f(50, 32))
    c3, s3 = codes.reshape(5, 10, 32), scales.reshape(5, 10)
    p3 = packed.reshape(5, 10, 16)
    cids = torch.tensor([0, 3, 4], dtype=torch.int32)
    qids = torch.randint(-1, 4, (3, 2), generator=g, dtype=torch.int32)
    slots = torch.randint(-1, 50, (3, 2, 10), generator=g, dtype=torch.int32)
    return {
        "verify_f32_k_above_c": (ops.verify_topk_op, (f(50, 32), rows, q), dict(k=9)),
        "verify_int8": (ops.verify_topk_op, (codes, rows, q), dict(k=3, scales=scales)),
        "verify_int4": (ops.verify_topk_op, (packed, rows, q),
                        dict(k=8, scales=scales, code_dtype="int4")),
        "sketch_k_above_c": (ops.sketch_topk_op, (sk, rows, q), dict(k=10)),
        "grouped_int8": (ops.verify_topk_grouped_op, (c3, s3, q, cids, qids, slots), dict(kp=4)),
        "grouped_int4_kp_above_lp": (ops.verify_topk_grouped_op, (p3, s3, q, cids, qids, slots),
                                     dict(kp=12, code_dtype="int4")),
        "lsh_hash": (ops.lsh_hash_op, (f(7, 32), f(32, 12)), dict(n_arrays=3, key_len=4)),
        "kmeans_assign": (ops.kmeans_assign_op, (f(9, 32), f(5, 32)), {}),
    }


@pytest.mark.parametrize("case", list(_kernel_cases()))
def test_kernel_shape_branch_matches_plain_version(case):
    fn, args, kw = _kernel_cases()[case]
    want = fn(*args, **kw)
    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(a) for a in args]
        got = fn(*fake, **kw)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert [(tuple(t.shape), t.dtype) for t in got] == [(tuple(t.shape), t.dtype) for t in want]
    assert all(isinstance(t, torch._subclasses.FakeTensor) for t in got)
    with torch.device("meta"):
        meta = fn(*[a.to("meta") for a in args], **kw)
    meta = meta if isinstance(meta, tuple) else (meta,)
    assert [(tuple(t.shape), t.dtype, t.device.type) for t in meta] == \
        [(tuple(t.shape), t.dtype, "meta") for t in want]


# Each case's (flops, bytes), by hand from its shapes: 4 queries of d = 32
# against 6 candidates each; rows 4d bytes (f32), d + 4 (int8 and its scale),
# d / 2 + 4 (int4), one 32-bit word (sketch); ids and queries 4 bytes an
# element, a top-k output 8 bytes a slot. Grouped: S = 3 steps of block_q =
# 2 slots over Lp = 10 rows. Hash: 7 x 32 rows through 32 x 12 projections
# to 7 x 3 keys. k-means: 9 x 32 rows against 5 centroids.
_IDS_Q = 4 * 6 * 4 + 4 * 32 * 4
KERNEL_COSTS = {
    "verify_f32_k_above_c": (2 * 32 * 24, 24 * 128 + _IDS_Q + 4 * 9 * 8),
    "verify_int8": (2 * 32 * 24, 24 * 36 + _IDS_Q + 4 * 3 * 8),
    "verify_int4": (2 * 32 * 24, 24 * 20 + _IDS_Q + 4 * 8 * 8),
    "sketch_k_above_c": (2 * 1 * 24, 24 * 4 + _IDS_Q + 4 * 10 * 8),
    "grouped_int8": (2 * 32 * 3 * 2 * 10,
                     3 * 10 * 36 + 3 * 2 * 10 * 4 + (3 + 6) * 4 + 4 * 32 * 4 + 3 * 2 * 4 * 8),
    "grouped_int4_kp_above_lp": (2 * 32 * 3 * 2 * 10,
                                 3 * 10 * 20 + 3 * 2 * 10 * 4 + (3 + 6) * 4 + 4 * 32 * 4
                                 + 3 * 2 * 12 * 8),
    "lsh_hash": (2 * 7 * 32 * 12, 7 * 32 * 4 + 32 * 12 * 4 + 7 * 3 * 4),
    "kmeans_assign": (2 * 9 * 5 * 32, (9 * 32 + 5 * 32) * 4 + 9 * 8),
}


@pytest.mark.parametrize("case", list(_kernel_cases()))
def test_kernel_reports_its_cost(case):
    """Under the dry run's counter a wrapper's call counts its kernel's
    (flops, bytes), the hand-computed ones, and none of its own ops: on
    the plain CPU branch and on the shape-only branch (fake tensors)."""
    fn, args, kw = _kernel_cases()[case]

    def counted(*a):
        counter = dryrun.StepCounter()
        with counting.counting(counter), counter:
            fn(*a, **kw)
        return counter.flops, counter.bytes_accessed

    assert counted(*args) == KERNEL_COSTS[case]
    with FakeTensorMode() as mode:
        assert counted(*[mode.from_tensor(a) for a in args]) == KERNEL_COSTS[case]
    calls = []
    with counting.counting(types.SimpleNamespace(add=lambda *c: calls.append(c))):
        with counting.hidden():  # inside another wrapper: the outer one reports
            fn(*args, **kw)
    assert calls == []


# ---------------------------------------------------------------------------
# The grid in a fake world, and the CLI
# ---------------------------------------------------------------------------


def test_production_grid_needs_its_world():
    with mesh.fake_world(64):
        with pytest.raises(RuntimeError, match="256 ranks"):
            mesh.make_production_grid()
    with pytest.raises(ValueError):
        with mesh.fake_world(256):
            grid = mesh.make_production_grid(device="cpu")
            assert grid.shape == {"data": 16, "model": 16} and grid.rank == 0
            raise ValueError("the world goes down with the error")
    assert not torch.distributed.is_initialized()
    with mesh.fake_world(512):
        grid = mesh.make_production_grid(multi_pod=True, device="cpu")
        assert grid.shape == {"pod": 2, "data": 16, "model": 16}
        with FakeTensorMode():
            x = torch.empty(3, 5)
            out = grid.all_gather(x, ("model",))
            grid.all_reduce(out, ("pod", "data"))
        assert tuple(out.shape) == (16, 3, 5)
        assert grid.comm_by_kind == {"all-gather": {"count": 1, "bytes": 60},
                                     "all-reduce": {"count": 1, "bytes": 960}}
        assert grid.comm_bytes == 1020


CLI_CELLS = [("qwen2.5-3b", "decode_32k"), ("gatedgcn", "molecule"), ("sasrec", "serve_p99"),
             ("lider-msmarco", "serve_online")]


@pytest.mark.parametrize("arch,shape", CLI_CELLS)
def test_dryrun_main_writes_a_record(tmp_path, arch, shape):
    out = tmp_path / "d.json"
    dryrun.main(["--mesh", "single", "--arch", arch, "--shape", shape, "--out", str(out)])
    (rec,) = json.loads(out.read_text())
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["n_devices"] == 256 and rec["mesh"] == "single_pod_16x16"
    m = rec["memory"]
    assert 0 < m["argument_bytes"] <= m["peak_bytes"] and m["fits"]
    assert m["temp_bytes"] == m["peak_bytes"] - m["argument_bytes"]
    assert rec["cost"]["bytes_accessed"] > 0 and rec["cost"]["flops"] > 0 and rec["model_flops"] > 0
    assert set(rec["collectives"]) <= {"all-gather", "all-reduce"}
    assert (arch == "lider-msmarco") == ("tier_memory" in rec)


def test_dryrun_main_exits_1_on_a_failure(tmp_path, monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("injected")

    monkeypatch.setitem(steps.FAMILY_BUILDERS, "recsys", broken)
    out = tmp_path / "d.json"
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--mesh", "single", "--arch", "din", "--shape", "train_batch",
                     "--out", str(out)])
    assert e.value.code == 1
    (rec,) = json.loads(out.read_text())
    assert rec["status"] == "failed" and "injected" in rec["traceback"]
