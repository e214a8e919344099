"""The models' half of the distributed path (``repro_torch.models.sharding``
and the families' sharded forms) against the JAX package and the port's
own single-device models.

The JAX side runs single-device in this process: GSPMD's answer on a mesh
is the single-device one (``tests/test_distributed.py`` holds the sharded
embedding lookup and LM loss to it), so the port's sharded answers are held
to the same values. The port's side is one world of 8 gloo ranks on the
CPU on a (data=4, model=2) grid (``mesh.spawn``) that runs every case, and
one world on an (8, 1) grid that resumes a checkpoint saved on the first.
Weights and batches are JAX's (``params_from_numpy``), as numpy.

Tolerances: the sharded lookup's forward bit-equal to the plain take, its
table gradient within atol 1e-5 (JAX's test); losses rtol 1e-5, and the
LM loss also within JAX's own 1e-3 of JAX's; gradients as in
``test_torch_models.py`` (rtol 1e-4, atol 1e-6, a floor of 1e-5 of the
leaf's largest magnitude); decode logits rtol 1e-5; after AdamW steps at
peak lr 1e-3 the parameters under the rule of ``test_torch_training.py``
(at most 0.1% of a leaf's elements may differ by up to 1% of the summed
learning rate). At 1e-2 the rule's share breaks for float32 itself (the
single rank against float64), and the sharded run is held to that
departure instead.
Reductions across ranks add float32 partials in another order than one
device, which is why the losses are not bit-equal.

The MoE cases take ``reduced_lm`` of qwen3-moe-235b-a22b and
llama4-scout-17b-a16e with 2 kv heads (the reduced configs have 1, which
does not split whole over 2 model ranks) and float32
master weights (qwen3-moe's are bfloat16, whose gradients would hold the
comparison to bfloat16's rounding). JAX is
imported inside the functions that need it, so the file collects on the
card, where its ``gpu`` cases run 4 gloo ranks.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.launch import mesh
from repro_torch.models import gnn, recsys, sharding, transformer as tfm, tree
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as opt_lib
from repro_torch.training import train_loop

GRID = (4, 2)
AXES = ("data", "model")
OUT = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
LM_CONFIGS = ("minitron-4b", "qwen2.5-3b", "qwen2-72b", "qwen3-moe-235b-a22b",
              "llama4-scout-17b-a16e")
MOE = ("qwen3-moe-235b-a22b", "llama4-scout-17b-a16e")
RECSYS = {"sasrec": "sasrec", "two_tower": "two-tower-retrieval", "din": "din",
          "xdeepfm": "xdeepfm"}
GNN = ("node", "molecule")
OPT = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=40)
HIGH = dict(OPT, peak_lr=1e-2)  # where the AdamW rule's share breaks for float32 itself
CLIP = dict(OPT, grad_clip=1e-5)  # clips every step; AdamW's eps then sees the scale
STEPS, RESUME_AT = 3, 2


def assert_close(got, want, *, rtol, atol, err_msg=""):
    want = np.asarray(want)
    floor = max(atol, 1e-5 * float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=floor, err_msg=err_msg)


def adamw_rule(got: dict, want: dict, lr_sum: float):
    """Parameters after AdamW steps: within 1e-5, but for at most 0.1% of
    a leaf's elements, which may differ by up to 1% of the summed lr."""
    assert set(got) == set(want)
    for n in want:
        a, b = got[n], want[n]
        diff = np.abs(a - b)
        bad = diff > 1e-5 * np.abs(b) + 1e-5 * np.abs(b).max()
        assert bad.mean() <= 1e-3 and np.all(diff[bad] <= 1e-2 * lr_sum), (n, diff.max())


def lr_sum(cfg: opt_lib.OptimizerConfig, steps: int) -> float:
    return sum(float(opt_lib.schedule(cfg, torch.tensor(s))) for s in range(1, steps + 1))


def named_np(model) -> dict:
    return {n: p.detach().cpu().numpy().copy() for n, p in model.named_parameters()}


def tb(b: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


# ---------------------------------------------------------------------------
# Configs and inputs (JAX's; built in the test process, sent to the ranks)
# ---------------------------------------------------------------------------


def _jax():
    import jax  # noqa: F401  (JAX stays out of the ranks and off the card)

    return jax


def lm_jcfg(name: str):
    """(JAX config) of a case: ``dense`` is tests/test_distributed.py's
    LM; the MoE cases are ``reduced_lm`` with 2 kv heads."""
    import jax.numpy as jnp
    from repro.configs import get_arch as jget_arch
    from repro.launch.train import reduced_lm as jreduced_lm
    from repro.models import transformer as jtfm

    if name == "dense":
        return jtfm.LMConfig(name="t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                             d_ff=128, vocab=256, dtype=jnp.float32)
    return dataclasses.replace(jreduced_lm(jget_arch(name).config), n_kv_heads=2,
                               param_dtype=jnp.float32)


def port_lm_cfg(jcfg) -> tfm.LMConfig:
    import jax.numpy as jnp

    vals = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(tfm.LMConfig)}
    dt = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
    vals["dtype"], vals["param_dtype"] = dt[jcfg.dtype], dt[jcfg.param_dtype]
    if jcfg.moe:
        vals["moe"] = tfm.MoEConfig(**dataclasses.asdict(jcfg.moe))
    return tfm.LMConfig(**vals)


def np_tree(t):
    jax = _jax()
    return jax.tree.map(np.array, t)


def recsys_case(kind: str):
    import jax
    from repro.configs import get_arch as jget_arch
    from repro.data import synthetic as jsyn
    from repro.launch.train import reduced_recsys as jreduced_recsys
    from repro.models import recsys as jrecsys

    jcfg = jreduced_recsys(jget_arch(RECSYS[kind]).config)
    params = np_tree(jrecsys.INIT[kind](jax.random.PRNGKey(0), jcfg))
    b = np_tree(jsyn.recsys_batch(0, 3, kind=kind, batch=16, cfg=jcfg))
    if kind == "two_tower":
        b["sampling_logq"] = (np.random.default_rng(0).standard_normal(16) * 2).astype(np.float32)
    vals = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(recsys.RecsysConfig)}
    vals["dtype"] = torch.float32
    return jcfg, recsys.RecsysConfig(**vals), params, b


def gnn_case(kind: str):
    import jax
    from repro.configs import get_arch as jget_arch
    from repro.data import synthetic as jsyn
    from repro.launch.train import reduced_gnn as jreduced_gnn
    from repro.models import gnn as jgnn

    jcfg = jreduced_gnn(jget_arch("gatedgcn").config)
    if kind == "node":
        g = np_tree(jsyn.random_graph(0, 128, 512, jcfg.d_feat, jcfg.n_classes))
        g = {k: g[k] for k in ("node_feat", "edge_index", "labels")}
    else:
        jcfg = dataclasses.replace(jcfg, d_edge=4, n_classes=1, readout="graph", d_feat=16)
        g = np_tree(jsyn.molecule_batch(0, 0, n_graphs=8, nodes_per=10, edges_per=16, d_feat=16))
    params = np_tree(jgnn.init(jax.random.PRNGKey(0), jcfg))
    vals = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(gnn.GNNConfig)}
    vals["dtype"] = torch.float32
    return jcfg, gnn.GNNConfig(**vals), params, g


def lm_batch(seed: int, b: int = 8, s: int = 32, vocab: int = 256) -> dict:
    from repro.data import synthetic as jsyn

    return {k: np.asarray(v).astype(np.int64)
            for k, v in jsyn.lm_batch(seed, 0, batch=b, seq=s, vocab=vocab).items()}


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------


def _grads(model, grid) -> dict:
    return {n: sharding.unshard(p.grad, sharding.spec_of(p), grid).numpy()
            for n, p in model.named_parameters()}


def _gathered(model, grid) -> dict:
    return {n: t.detach().numpy() for n, t in sharding.unshard_named(
        dict(model.named_parameters()), grid).items()}


def _lm_model(case, grid, *, fsdp=True):
    cfg, tree_np = case
    model = tfm.params_from_numpy(tree_np, cfg, device="cpu")
    return sharding.shard_module(model, tfm.param_specs(cfg, grid.axis_names, fsdp=fsdp), grid)


def _decode(model, grid, tokens, *, seq_sharded: bool, steps: int = 3) -> list:
    """Prefill 16 tokens into a 32-position cache, then ``steps`` decode
    steps; the logits of every step, gathered."""
    rows = tokens if seq_sharded else sharding.shard_batch({"t": tokens}, grid)["t"]
    with torch.no_grad(), mesh.use_grid(grid):
        lg, cache = tfm.prefill(model, rows[:, :16], max_len=32, seq_sharded=seq_sharded)
        out = [lg]
        for i in range(steps):
            lg, cache = tfm.decode_step(model, cache, rows[:, 16 + i : 17 + i])
            out.append(lg)
        spec = (None, None) if seq_sharded else (("data",), None)
        shapes = (tuple(cache["k"].shape), grid.coords())
    return [sharding.unshard(t, spec, grid).numpy() for t in out], shapes


def sharded_rank(world, inputs, ckpt_dir):
    """One of the 8 ranks on the (4, 2) grid: every case."""
    grid = mesh.make_grid(GRID, device="cpu")
    res = {"coords": grid.coords()}

    # The sharded embedding lookup (tests/test_distributed.py's case): the
    # table's rows over model, the ids' rows over data (as JAX's shard_map
    # splits them), each rank summing the squares of its rows.
    table = torch.from_numpy(inputs["emb"]["table"])
    ids = sharding.shard_batch({"ids": torch.from_numpy(inputs["emb"]["ids"])}, grid)["ids"]
    spec = sharding.resolve_spec(("model", None), grid.axis_names)
    local = sharding.tag(sharding.shard(table, spec, grid).requires_grad_(True), spec)
    with mesh.use_grid(grid):
        got = recsys.embedding_lookup(local, ids)
        torch.sum(got**2).backward()
    res["emb"] = (sharding.unshard(got.detach(), (("data",), None, None), grid).numpy(),
                  sharding.unshard(local.grad, spec, grid).numpy())

    # LM losses, aux losses and gradients (dense, seq-sharded and MoE).
    res["lm"] = {}
    for name, case in inputs["lm"].items():
        model = _lm_model(case, grid)
        batch = sharding.shard_batch(tb(inputs["lm_batch"][name]), grid)
        with mesh.use_grid(grid):
            hidden, aux = model(batch["tokens"])
            loss = tfm.lm_loss(model, hidden, batch["targets"]) + 0.01 * aux
            loss.backward()
        res["lm"][name] = (float(loss.detach()), float(aux.detach()), _grads(model, grid))

    # Decode, both cache layouts.
    model = _lm_model(inputs["lm"]["dense"], grid)
    tokens = torch.from_numpy(inputs["decode_tokens"])
    res["decode"] = {ss: _decode(model, grid, tokens[:1] if ss else tokens, seq_sharded=ss)
                     for ss in (False, True)}

    # Train steps: AdamW on the rank's blocks (fsdp and pure TP), with
    # clipping, and at peak lr 1e-2; then a checkpoint of the fsdp run.
    res["train"] = {}
    for name, ocfg, fsdp in (("fsdp", OPT, True), ("tp", OPT, False), ("clip", CLIP, True),
                             ("high", HIGH, True)):
        model = _lm_model(inputs["lm"]["dense"], grid, fsdp=fsdp)
        state = opt_lib.init_state(dict(model.named_parameters()))
        step = train_loop.make_train_step(tfm.train_loss, opt_lib.OptimizerConfig(**ocfg))
        metrics = []
        n = RESUME_AT if name == "fsdp" else STEPS
        with mesh.use_grid(grid):
            for i in range(n):
                _, _, m = step(model, state, sharding.shard_batch(tb(inputs["train_batches"][i]), grid))
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
            owned = {n_: (p.numel(), state["mu"][n_].numel()) for n_, p in model.named_parameters()}
            res["train"][name] = (metrics, _gathered(model, grid), owned)
            if name == "fsdp":
                mgr = ckpt.CheckpointManager(ckpt_dir)
                mgr.save(RESUME_AT, train_loop.state_tree(model, state))

    # Recsys: loss and gradients; two-tower also with a shard-local softmax.
    res["recsys"] = {}
    for kind, (cfg, params, b) in inputs["recsys"].items():
        model = recsys.params_from_numpy(params, cfg, device="cpu")
        sharding.shard_module(model, recsys.param_specs(model), grid)
        with mesh.use_grid(grid):
            loss = recsys.LOSS[kind](model, sharding.shard_batch(tb(b), grid))
            loss.backward()
        out = {"loss": float(loss.detach()), "grads": _grads(model, grid)}
        if kind == "two_tower":
            with torch.no_grad():
                out["local_softmax"] = _shard_local_two_tower(model, grid, tb(b))
        res["recsys"][kind] = out

    # GNN: edges over every axis.
    res["gnn"] = {}
    for kind, (cfg, params, g) in inputs["gnn"].items():
        model = gnn.params_from_numpy(params, cfg, device="cpu")
        with mesh.use_grid(grid):
            loss = gnn.train_loss(model, gnn.shard_edges(tb(g), grid))
            loss.backward()
        res["gnn"][kind] = (float(loss.detach()),
                            {n: p.grad.numpy() for n, p in model.named_parameters()})
    return res


def _shard_local_two_tower(model, grid, batch) -> float:
    """The two-tower loss if each data rank scored only its own items (the
    wrong loss: fewer negatives), averaged over the data ranks."""
    local = sharding.shard_batch(batch, grid)
    with mesh.use_grid(grid):
        u = recsys.user_embed(model, local["user_fields"])
        i = recsys.item_embed(model, local["item_fields"])
    logits = (u @ i.T) / 0.05 - local["sampling_logq"][None, :]
    loss = -torch.mean(torch.diagonal(torch.log_softmax(logits, dim=-1)))
    return float(grid.all_reduce(loss, ("data",)) / grid.axis_size(("data",)))


def resume_rank(world, inputs, ckpt_dir):
    """One of the 8 ranks on an (8, 1) grid: restore the (4, 2) run's
    checkpoint into this grid's blocks and take the remaining steps."""
    grid = mesh.make_grid((8, 1), device="cpu")
    model = _lm_model(inputs["lm"]["dense"], grid)
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    state = opt_lib.init_state(dict(model.named_parameters()))
    step = train_loop.make_train_step(tfm.train_loss, opt_lib.OptimizerConfig(**OPT))
    metrics = []
    with mesh.use_grid(grid):
        mgr = ckpt.CheckpointManager(ckpt_dir)
        step_at, _ = mgr.restore_latest(train_loop.state_tree(model, state))
        for i in range(step_at, step_at + RESUME_AT):
            _, _, m = step(model, state, sharding.shard_batch(tb(inputs["train_batches"][i]), grid))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return step_at, metrics, _gathered(model, grid), int(state["step"])


# ---------------------------------------------------------------------------
# Fixtures
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def inputs():
    jax = _jax()
    from repro.models import transformer as jtfm

    rng = np.random.default_rng(0)
    out = {"emb": {"table": rng.standard_normal((64, 8)).astype(np.float32),
                   "ids": rng.integers(0, 64, (16, 3)).astype(np.int64)},
           "lm": {}, "lm_batch": {}, "jcfg": {}}
    for name in ("dense", "seq", *MOE):
        jcfg = lm_jcfg("dense" if name == "seq" else name)
        cfg = port_lm_cfg(jcfg)
        if name == "seq":
            cfg = dataclasses.replace(cfg, seq_shard_activations=True)
        params = np_tree(jtfm.init(jax.random.PRNGKey(0), jcfg))
        out["lm"][name] = (cfg, params)
        out["jcfg"][name] = jcfg
        out["lm_batch"][name] = lm_batch(1, vocab=jcfg.vocab)
    out["decode_tokens"] = lm_batch(2, b=8, s=20)["tokens"]
    out["train_batches"] = [lm_batch(10 + i) for i in range(STEPS + RESUME_AT)]
    out["recsys"] = {}
    out["jrecsys"] = {}
    for kind in RECSYS:
        jcfg, cfg, params, b = recsys_case(kind)
        out["recsys"][kind] = (cfg, params, b)
        out["jrecsys"][kind] = jcfg
    out["gnn"], out["jgnn"] = {}, {}
    for kind in GNN:
        jcfg, cfg, params, g = gnn_case(kind)
        out["gnn"][kind] = (cfg, params, g)
        out["jgnn"][kind] = jcfg
    return out


def _rank_inputs(inputs) -> dict:
    return {k: v for k, v in inputs.items() if not k.startswith("j")}


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("sharded_ckpt"))


@pytest.fixture(scope="module")
def port_side(inputs, ckpt_dir):
    return mesh.spawn(8, sharded_rank, _rank_inputs(inputs), ckpt_dir, device="cpu")


@pytest.fixture(scope="module")
def resumed(inputs, ckpt_dir, port_side):
    return mesh.spawn(8, resume_rank, _rank_inputs(inputs), ckpt_dir, device="cpu")


def single_train(inputs, ocfg: dict, steps: int, *, dtype=torch.float32):
    """The single-rank port's run of the dense LM: (metrics, parameters,
    as float32). ``dtype`` float64 keeps the weights, the optimizer and the
    products in float64 (attention and the norms still compute in float32,
    as the layers cast them)."""
    cfg, params = inputs["lm"]["dense"]
    if dtype != torch.float32:
        cfg = dataclasses.replace(cfg, dtype=dtype, param_dtype=dtype)
        params = _jax().tree.map(lambda a: a.astype(np.float64) if a.dtype == np.float32 else a,
                                 params)
    model = tfm.params_from_numpy(params, cfg, device="cpu")
    state = opt_lib.init_state(dict(model.named_parameters()))
    step = train_loop.make_train_step(tfm.train_loss, opt_lib.OptimizerConfig(**ocfg))
    metrics = []
    for i in range(steps):
        _, _, m = step(model, state, tb(inputs["train_batches"][i]))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return metrics, {n: p.astype(np.float32) for n, p in named_np(model).items()}


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------


def _entries(spec) -> list:
    """A spec's entries with a one-axis tuple written as the axis name."""
    out = []
    for e in spec:
        e = list(e) if isinstance(e, (tuple, list)) else e
        out.append(e[0] if isinstance(e, list) and len(e) == 1 else e)
    return out


def _flat_specs(t, prefix=()) -> dict:
    if isinstance(t, dict):
        return {k: v for key in t for k, v in _flat_specs(t[key], prefix + (key,)).items()}
    if isinstance(t, list):
        return {k: v for i, x in enumerate(t) for k, v in _flat_specs(x, prefix + (i,)).items()}
    return {"/".join(map(str, prefix)): _entries(t)}


def _flat_jax_specs(t) -> dict:
    jax = _jax()
    from jax.sharding import PartitionSpec as P

    flat = jax.tree_util.tree_flatten_with_path(t, is_leaf=lambda x: isinstance(x, P))[0]
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): _entries(s)
            for path, s in flat}


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("arch", LM_CONFIGS)
def test_param_specs_match_jax(arch, fsdp):
    """Entry for entry the reference's, its stacked layers' leading None
    dropped; on (data, model) and (pod, data, model) axes."""
    from repro.configs import get_arch as jget_arch
    from repro.models import transformer as jtfm

    jcfg = jget_arch(arch).config
    cfg = port_lm_cfg(jcfg)
    for names in (AXES, ("pod",) + AXES):
        want = _flat_jax_specs(jtfm.param_specs(jcfg, names, fsdp=fsdp))
        got = _flat_specs(tfm.param_specs(cfg, names, fsdp=fsdp))
        want = {k: (v[1:] if k.startswith("layers/") else v) for k, v in want.items()}
        assert got == want
        # Every parameter of the module has a spec of its rank.
        model = tfm.Transformer(dataclasses.replace(cfg, n_layers=1), device="meta")
        for n, p in model.named_parameters():
            assert len(sharding.spec_lookup(tfm.param_specs(cfg, names, fsdp=fsdp), n)) == p.dim(), n


@pytest.mark.parametrize("seq_sharded", [False, True])
@pytest.mark.parametrize("arch", LM_CONFIGS)
def test_cache_specs_match_jax(arch, seq_sharded):
    from repro.configs import get_arch as jget_arch
    from repro.models import transformer as jtfm

    jcfg = jget_arch(arch).config
    for names in (AXES, ("pod",) + AXES, ("data",)):
        want = _flat_jax_specs(jtfm.cache_specs(jcfg, names, seq_sharded=seq_sharded))
        got = _flat_specs(tfm.cache_specs(port_lm_cfg(jcfg), names, seq_sharded=seq_sharded))
        assert got == want


@pytest.mark.parametrize("kind", sorted(RECSYS))
def test_recsys_param_specs_match_jax(kind):
    from repro.models import recsys as jrecsys

    jcfg, cfg, params, _ = recsys_case(kind)
    want = _flat_jax_specs(jrecsys.param_specs(params))
    got = _flat_specs(recsys.param_specs(recsys.params_from_numpy(params, cfg, device="cpu")))
    assert got == want
    assert any(v and v[0] == "model" for v in got.values())


@pytest.mark.parametrize("names", [AXES, ("pod",) + AXES, ("data",), ("model",)])
def test_resolve_spec_matches_jax(names):
    from repro.models import sharding as jsharding

    entries = [None, "dp", "tp", "all", "data", "model", "pod"]
    for e in entries:
        want = _entries(jsharding.resolve_spec([e], names))
        assert _entries(sharding.resolve_spec([e], names)) == want, e
        for logical in ("dp", "tp", "all"):
            assert sharding.physical_axes(logical, names) == jsharding.physical_axes(logical, names)


def test_shard_and_unshard_are_numpy_slicing():
    """A rank's block is exactly numpy's slice of the reference's leaf, by
    the row-major flat index over a tuple of axes."""

    class FakeGrid:
        axis_names = ("pod", "data", "model")
        shape = {"pod": 2, "data": 2, "model": 2}

        def __init__(self, coords):
            self.c = coords

        def axis_size(self, axes):
            return int(np.prod([self.shape[a] for a in axes]))

        def flat_index(self, axes):
            return int(np.ravel_multi_index([self.c[a] for a in axes], [self.shape[a] for a in axes]))

    full = np.arange(8 * 12, dtype=np.float32).reshape(8, 12)
    spec = sharding.resolve_spec((("pod", "data"), "model"), FakeGrid.axis_names)
    for p in range(2):
        for d in range(2):
            for m in range(2):
                g = FakeGrid({"pod": p, "data": d, "model": m})
                got = sharding.shard(torch.from_numpy(full), spec, g).numpy()
                i = p * 2 + d
                assert np.array_equal(got, full[i * 2 : (i + 1) * 2, m * 6 : (m + 1) * 6])


def test_n_kv_heads_must_split():
    """What must split over ``model`` is the kv heads' columns: heads that
    do not split whole are laid out all the same (gathered in the
    attention; ``test_torch_dryrun.py`` holds such models to one device),
    and columns that do not split raise."""
    cfg = port_lm_cfg(lm_jcfg("dense"))
    cfg = dataclasses.replace(cfg, n_kv_heads=1)

    class G:
        axis_names = AXES

        def __init__(self, model):
            self.model = model

        def axis_size(self, axes):
            return self.model if tuple(axes) == ("model",) else 1

        def flat_index(self, axes):
            return 0

    assert not tfm._layout(cfg, G(2)).whole_heads
    spec = sharding.resolve_spec(tfm.param_specs(cfg, AXES, fsdp=False)["layers"]["wk"], AXES)
    wk = (cfg.d_model, cfg.n_kv_heads * cfg.head_dim)
    assert sharding.block_shape(wk, spec, G(2)) == (cfg.d_model, cfg.head_dim // 2)
    with pytest.raises(ValueError, match="does not split"):
        sharding.block_slices(wk, spec, G(3))


# ---------------------------------------------------------------------------
# The sharded models against JAX
# ---------------------------------------------------------------------------


def test_sharded_embedding_lookup_equals_take(inputs, port_side):
    """tests/test_distributed.py's case: forward bit-equal, gradient atol 1e-5."""
    import jax
    import jax.numpy as jnp

    table, ids = inputs["emb"]["table"], inputs["emb"]["ids"]
    g_plain = np.asarray(jax.grad(lambda t: jnp.sum(t[ids] ** 2))(table))
    for rank in port_side:
        got, grad = rank["emb"]
        assert np.array_equal(got, table[ids])
        np.testing.assert_allclose(grad, g_plain, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", ["dense", "seq", *MOE])
def test_lm_loss_and_grads_match_jax(inputs, port_side, name):
    """The sharded loss (with the MoE aux loss) within JAX's 1e-3 of JAX's
    loss and rtol 1e-5 of it and of the port's single-rank loss; the aux
    loss rtol 1e-5; every gathered gradient against JAX's."""
    import jax
    from repro.models import transformer as jtfm

    jcfg = inputs["jcfg"][name]
    cfg, params = inputs["lm"][name]
    batch = inputs["lm_batch"][name]

    def jloss(p):
        hidden, aux = jtfm.forward(p, jcfg, batch["tokens"])
        return jtfm.lm_loss(p, jcfg, hidden, batch["targets"]) + 0.01 * aux, aux

    (want, jaux), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    single = tfm.params_from_numpy(params, dataclasses.replace(cfg, seq_shard_activations=False),
                                   device="cpu")
    with torch.no_grad():
        hidden, aux1 = single(tb(batch)["tokens"])
        one = float(tfm.lm_loss(single, hidden, tb(batch)["targets"]) + 0.01 * aux1)
    jgrads = np_tree(jgrads)
    for rank in port_side:
        loss, aux, grads = rank["lm"][name]
        assert abs(loss - float(want)) < 1e-3
        np.testing.assert_allclose(loss, float(want), rtol=1e-5)
        np.testing.assert_allclose(loss, one, rtol=1e-5)
        np.testing.assert_allclose(aux, float(jaux), rtol=1e-5, atol=1e-7)
    for n, g in port_side[0]["lm"][name][2].items():
        assert_close(g, tree.lookup(jgrads, n), err_msg=n, **GRAD)


@pytest.mark.parametrize("seq_sharded", [False, True])
def test_decode_matches_jax(inputs, port_side, seq_sharded):
    """Prefill 16 tokens, then 3 decode steps: the logits of each against
    JAX's single-device prefill / decode_step (its cache padded to 32
    positions), rtol 1e-5; each rank's cache block has cache_specs' shape."""
    import jax.numpy as jnp
    from repro.models import transformer as jtfm

    jcfg = inputs["jcfg"]["dense"]
    _, params = inputs["lm"]["dense"]
    tokens = inputs["decode_tokens"][:1] if seq_sharded else inputs["decode_tokens"]
    lg, cache = jtfm.prefill(params, jcfg, tokens[:, :16])
    pad = lambda t: jnp.pad(t, ((0, 0), (0, 0), (0, 16), (0, 0), (0, 0)))
    cache = {"k": pad(cache["k"]), "v": pad(cache["v"]), "length": cache["length"]}
    want = [np.asarray(lg)]
    for i in range(3):
        lg, cache = jtfm.decode_step(params, jcfg, cache, tokens[:, 16 + i : 17 + i])
        want.append(np.asarray(lg))
    b = tokens.shape[0]
    for rank in port_side:
        got, (shape, coords) = rank["decode"][seq_sharded]
        for g, w in zip(got, want):
            assert_close(g, w, **OUT)
        n_seq = 8 if seq_sharded else 2
        assert shape == (jcfg.n_layers, b if seq_sharded else b // 4, 32 // n_seq,
                         jcfg.n_kv_heads, jcfg.head_dim)


@pytest.mark.parametrize("kind", sorted(RECSYS))
def test_recsys_loss_and_grads_match_jax(inputs, port_side, kind):
    import jax
    from repro.models import recsys as jrecsys

    jcfg = inputs["jrecsys"][kind]
    _, params, b = inputs["recsys"][kind]
    jloss, jgrads = jax.value_and_grad(jrecsys.LOSS[kind])(params, jcfg, b)
    jgrads = np_tree(jgrads)
    for rank in port_side:
        np.testing.assert_allclose(rank["recsys"][kind]["loss"], float(jloss), rtol=1e-5)
    for n, g in port_side[0]["recsys"][kind]["grads"].items():
        assert_close(g, tree.lookup(jgrads, n), err_msg=n, **GRAD)


def test_two_tower_softmax_is_global(inputs, port_side):
    """The sharded two-tower loss is the global in-batch softmax's; a
    shard-local softmax (each data rank's own items only) is not."""
    import jax
    from repro.models import recsys as jrecsys

    _, params, b = inputs["recsys"]["two_tower"]
    want = float(jax.jit(jrecsys.two_tower_loss, static_argnums=1)(
        params, inputs["jrecsys"]["two_tower"], b))
    out = port_side[0]["recsys"]["two_tower"]
    np.testing.assert_allclose(out["loss"], want, rtol=1e-5)
    assert abs(out["local_softmax"] - want) > 1e-2 * abs(want)


@pytest.mark.parametrize("kind", GNN)
def test_gnn_loss_and_grads_match_jax(inputs, port_side, kind):
    """Edges over all 8 ranks; the edges' batch statistics over all of
    them: loss rtol 1e-5 and gradients against JAX's, on every rank."""
    import jax
    from repro.models import gnn as jgnn

    jcfg = inputs["jgnn"][kind]
    _, params, g = inputs["gnn"][kind]
    jloss, jgrads = jax.value_and_grad(jgnn.train_loss)(params, jcfg, g)
    jgrads = np_tree(jgrads)
    for rank in port_side:
        loss, grads = rank["gnn"][kind]
        np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
        for n, gr in grads.items():
            assert_close(gr, tree.lookup(jgrads, n), err_msg=n, **GRAD)


# ---------------------------------------------------------------------------
# Training, clipping and checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["fsdp", "tp", "clip"])
def test_train_steps_match_single_rank(inputs, port_side, name):
    """Sharded AdamW steps (fsdp and pure TP specs; and with every step
    clipped) against the single-rank port: loss and grad norm rtol 1e-5
    at step 1, 1e-3 absolute after; the parameters under the AdamW rule;
    each rank's parameter and moment elements its spec's share."""
    ocfg = CLIP if name == "clip" else OPT
    steps = RESUME_AT if name == "fsdp" else STEPS
    want_m, want_p = single_train(inputs, ocfg, steps)
    if name == "clip":
        assert all(gn > 1e3 * ocfg["grad_clip"] for _, gn in want_m)
    cfg = inputs["lm"]["dense"][0]
    specs = tfm.param_specs(cfg, AXES, fsdp=name != "tp")
    for rank in port_side:
        metrics, params, owned = rank["train"][name]
        np.testing.assert_allclose(metrics[0], want_m[0], rtol=1e-5)
        np.testing.assert_allclose(metrics, want_m, atol=1e-3)
        adamw_rule(params, want_p, lr_sum(opt_lib.OptimizerConfig(**ocfg), steps))
        for n, (n_param, n_mu) in owned.items():
            parts = int(np.prod([GRID[AXES.index(a)] for a in sharding.spec_axes(
                sharding.resolve_spec(sharding.spec_lookup(specs, n), AXES))]))
            assert n_param == n_mu == want_p[n].size // parts, n


def _past_floor(got: dict, want: dict) -> dict:
    """Per leaf, the elements beyond the AdamW rule's floor (1e-5 of the
    element and of the leaf's largest magnitude)."""
    return {n: int(np.sum(np.abs(got[n] - w) > 1e-5 * np.abs(w) + 1e-5 * np.abs(w).max()))
            for n, w in want.items()}


def test_train_steps_at_lr_1e2_depart_no_more_than_float32_itself(inputs, port_side):
    """At peak lr 1e-2 the AdamW rule's share (0.1% of a leaf) breaks on
    the embedding for float32 itself: the single-rank float32 run against
    the same run with float64 weights and products moves 76 of its 16,384
    elements past the floor, where the sharded run against the single rank
    moves 41 (2 or 4 micro-batches, permuted rows or a data-only grid move
    0 or 1: the tensor-parallel forward's sums reorder more). The other cases
    run at 1e-3 for that reason. Here the sharded run's departure from the
    single rank is held to the single rank's own departure from float64:
    no more elements past the floor, in all and on the embedding, and every
    element within 1% of the summed lr (the rule's magnitude)."""
    ocfg = HIGH
    _, want_p = single_train(inputs, ocfg, STEPS)
    _, exact = single_train(inputs, ocfg, STEPS, dtype=torch.float64)
    own = _past_floor(want_p, exact)
    lrs = lr_sum(opt_lib.OptimizerConfig(**ocfg), STEPS)
    assert own["embed"] > 1e-3 * want_p["embed"].size  # the share breaks without any rank
    for rank in port_side:
        _, params, _ = rank["train"]["high"]
        moved = _past_floor(params, want_p)
        assert sum(moved.values()) <= sum(own.values()), (moved, own)
        assert moved["embed"] <= own["embed"], (moved["embed"], own["embed"])
        for n, w in want_p.items():
            assert np.abs(params[n] - w).max() <= 1e-2 * lrs, n


def test_sharded_global_norm_counts_each_leaf_once(inputs, port_side):
    """The grad norm the sharded steps report is the single-device one, to
    rtol 1e-5 (a rank-local or double-counted norm is off by a factor)."""
    want_m, _ = single_train(inputs, OPT, 1)
    for name in ("fsdp", "tp", "clip"):
        np.testing.assert_allclose(port_side[0]["train"][name][0][0][1], want_m[0][1], rtol=1e-5)


def test_checkpoint_from_grid_reads_in_jax(inputs, port_side, ckpt_dir):
    """The step saved from the (4, 2) grid holds the full leaves: JAX's
    restore reads it into the single-device tree, equal to the gathered
    parameters bit for bit."""
    import jax
    from repro.models import transformer as jtfm
    from repro.training import checkpoint as jckpt
    from repro.training import optimizer as jopt

    jcfg = inputs["jcfg"]["dense"]
    params = jtfm.init(jax.random.PRNGKey(0), jcfg)
    like = {"params": params, "opt_state": jopt.init_state(params)}
    got = jckpt.restore(ckpt_dir, RESUME_AT, like)
    gathered = port_side[0]["train"]["fsdp"][1]
    jp = np_tree(got["params"])
    for n, a in gathered.items():
        assert np.array_equal(a, tree.lookup(jp, n)), n
    assert int(got["opt_state"]["step"]) == RESUME_AT


def test_restore_onto_another_grid_continues(inputs, resumed):
    """Restored onto an (8, 1) grid: 2 + 2 steps equal 4 single-rank steps
    under the AdamW rule, with the step-3 and step-4 losses within 1e-3."""
    want_m, want_p = single_train(inputs, OPT, 2 * RESUME_AT)
    for step_at, metrics, params, step in resumed:
        assert step_at == RESUME_AT and step == 2 * RESUME_AT
        np.testing.assert_allclose(metrics, want_m[RESUME_AT:], atol=1e-3)
        adamw_rule(params, want_p, lr_sum(opt_lib.OptimizerConfig(**OPT), 2 * RESUME_AT))


# ---------------------------------------------------------------------------
# Model FLOPs
# ---------------------------------------------------------------------------


def test_model_flops_match_jax():
    """``launch.flops.model_flops`` == JAX's for every (arch, shape) that
    is not skipped, and tests/test_perf_variants.py's 6ND check."""
    from repro.configs import ARCHS as JARCHS
    from repro.launch.flops import model_flops as jmodel_flops
    from repro_torch.configs import ARCHS, get_arch
    from repro_torch.launch.flops import model_flops

    n = 0
    for arch_id, arch in ARCHS.items():
        for shape in arch.shapes:
            if shape.name in arch.skip_shapes:
                continue
            f = model_flops(arch, shape)
            assert f > 0 and f == jmodel_flops(JARCHS[arch_id], JARCHS[arch_id].shape(shape.name)), \
                (arch_id, shape.name)
            n += 1
    assert n > 30
    arch = get_arch("qwen2.5-3b")
    assert model_flops(arch, arch.shape("train_4k")) >= 6 * arch.config.flops_params() * 256 * 4096


# ---------------------------------------------------------------------------
# On the card: 4 gloo ranks sharing it
# ---------------------------------------------------------------------------


def _card_moe_cfg() -> tfm.LMConfig:
    return tfm.LMConfig(name="moe", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
                        vocab=512, d_head=32, dtype=torch.float32,
                        moe=tfm.MoEConfig(n_experts=4, top_k=2, d_ff_expert=64, n_shared=1))


def _card_gnn_cfg() -> gnn.GNNConfig:
    return gnn.GNNConfig(name="g", n_layers=3, d_hidden=32, d_feat=16, d_edge=4, n_classes=1,
                         readout="graph")


def _card_inputs():
    """Tokens, and 32 molecules of 16 edges each. The graph has edge
    features: without them every edge starts from the same state, the
    first layer's batch norm removes ``C``'s term exactly, and that
    gradient-free leaf moves by AdamW-normalised rounding noise on both
    sides, which no parameter tolerance can hold."""
    from repro_torch.data import synthetic

    gen = np.random.default_rng(0)
    tok = gen.integers(0, 512, (4, 65)).astype(np.int64)
    graph = synthetic.molecule_batch(0, 0, n_graphs=32, nodes_per=10, edges_per=16, d_feat=16,
                                     device="cpu")
    return {"tokens": tok[:, :-1], "targets": tok[:, 1:]}, graph


def _to(v, dev):
    return v.to(dev) if isinstance(v, torch.Tensor) else v


def card_rank(world, moe_tree, gnn_tree):
    """Two train steps of each model on a (2, 2) grid of 4 ranks on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    grid = mesh.make_grid((2, 2), device=world.device)
    lm_batch_np, graph = _card_inputs()
    out = {}
    cfg = _card_moe_cfg()
    model = tfm.params_from_numpy(moe_tree, cfg, device=world.device)
    sharding.shard_module(model, tfm.param_specs(cfg, grid.axis_names), grid)
    state = opt_lib.init_state(dict(model.named_parameters()))
    step = train_loop.make_train_step(tfm.train_loss, opt_lib.OptimizerConfig(**OPT))
    batch = sharding.shard_batch({k: torch.from_numpy(v).to(world.device)
                                  for k, v in lm_batch_np.items()}, grid)
    gmodel = gnn.params_from_numpy(gnn_tree, _card_gnn_cfg(), device=world.device)
    gstate = opt_lib.init_state(dict(gmodel.named_parameters()))
    gstep = train_loop.make_train_step(gnn.train_loss, opt_lib.OptimizerConfig(**OPT))
    g = gnn.shard_edges({k: _to(v, world.device) for k, v in graph.items()}, grid)
    with mesh.use_grid(grid):
        out["moe"] = [float(step(model, state, batch)[2]["loss"]) for _ in range(2)]
        out["gnn"] = [float(gstep(gmodel, gstate, g)[2]["loss"]) for _ in range(2)]
    out["moe_params"] = {n: t.detach().cpu().numpy() for n, t in sharding.unshard_named(
        dict(model.named_parameters()), grid).items()}
    out["gnn_params"] = named_np(gmodel)
    return out


@pytest.mark.gpu
def test_moe_and_gnn_sharded_steps_on_the_card():
    """4 gloo ranks on the card (data 2, model 2): two AdamW steps of a
    reduced MoE LM and of the GNN against the single-rank run on the card
    (TF32 off): losses rtol 1e-5 then 1e-3 absolute, parameters under the
    AdamW rule."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    lm_batch_np, graph = _card_inputs()
    moe = tfm.init(0, _card_moe_cfg(), device=dev)
    g = gnn.init(0, _card_gnn_cfg(), device=dev)
    moe_tree, gnn_tree = tfm.params_to_numpy(moe), gnn.params_to_numpy(g)
    want = {}
    for key, model, loss_fn, batch in (
        ("moe", moe, tfm.train_loss, {k: torch.from_numpy(v).to(dev) for k, v in lm_batch_np.items()}),
        ("gnn", g, gnn.train_loss, {k: _to(v, dev) for k, v in graph.items()}),
    ):
        state = opt_lib.init_state(dict(model.named_parameters()))
        step = train_loop.make_train_step(loss_fn, opt_lib.OptimizerConfig(**OPT))
        want[key] = [float(step(model, state, batch)[2]["loss"]) for _ in range(2)]
        want[key + "_params"] = named_np(model)
    (r0, *_) = mesh.spawn(4, card_rank, moe_tree, gnn_tree, device=dev, backend="gloo")
    for key in ("moe", "gnn"):
        np.testing.assert_allclose(r0[key][0], want[key][0], rtol=1e-5)
        np.testing.assert_allclose(r0[key], want[key], atol=1e-3)
        adamw_rule(r0[key + "_params"], want[key + "_params"],
                   lr_sum(opt_lib.OptimizerConfig(**OPT), 2))


def test_shard_from_source_is_numpy_slicing_of_the_tree():
    """``shard_module`` of a meta-device model from the reference's numpy
    tree gives each rank exactly numpy's slice of each leaf, and the same
    blocks as ``params_from_numpy`` then ``shard_module``."""
    jax = _jax()
    from repro.models import transformer as jtfm

    class FakeGrid:
        axis_names = AXES
        shape = dict(zip(AXES, GRID))

        def __init__(self, coords):
            self.c = coords

        def axis_size(self, axes):
            return int(np.prod([self.shape[a] for a in axes]))

        def flat_index(self, axes):
            return int(np.ravel_multi_index([self.c[a] for a in axes], [self.shape[a] for a in axes]))

        def group(self, axes):
            return None

    jcfg = lm_jcfg(MOE[1])
    cfg = port_lm_cfg(jcfg)
    t = np_tree(jtfm.init(jax.random.PRNGKey(0), jcfg))
    specs = tfm.param_specs(cfg, AXES)
    for coords in ({"data": 0, "model": 1}, {"data": 3, "model": 0}):
        g = FakeGrid(coords)
        a = sharding.shard_module(tfm.Transformer(cfg, device="meta"), specs, g, source=t,
                                  device="cpu")
        b = sharding.shard_module(tfm.params_from_numpy(t, cfg, device="cpu"), specs, g)
        for (n, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
            leaf = tree.lookup(t, n)
            sl = sharding.block_slices(leaf.shape, sharding.spec_of(pa), g)
            assert np.array_equal(pa.detach().numpy(), leaf[sl]), n
            assert np.array_equal(pb.detach().numpy(), leaf[sl]), n
            assert sharding.spec_of(pa) == sharding.spec_of(pb)
