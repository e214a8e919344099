"""The port's transformer (``repro_torch.models``) against the JAX package's.

Inputs are made with numpy from a seed and fed to both packages; the JAX
model's parameters, drawn by ``jax.random``, are carried into the port's
module by ``params_from_numpy``. Tolerances (float32): outputs and losses
within rtol 1e-5; gradients within rtol 1e-4, atol 1e-6; integer and
structural outputs (expert choices, windows, the carried tree) exact. The
model's hidden states and gradients are also allowed 1e-5 of the leaf's
largest magnitude, for the elements near zero: a few layers of float32
products summed in other orders leave up to ~2e-6 of it there (~8e-6 on
the MoE config's embedding gradient, whose entries reach 4). One bfloat16
forward, on a dense config, element by element within rtol 2e-2 and 2e-2
of the output's largest magnitude, and nearer JAX's bfloat16 forward than
its float32 one. The float32 floor (1e-5 of the largest magnitude) does
not apply: it is under a thousandth of a bfloat16 ulp there, and two
computations that round to bfloat16 at different points put a fifth of
the elements more than rtol 2e-2 plus that floor apart, the worst by two
ulps of the largest magnitude. The config is dense because under bfloat16 near-tied router
choices flip between any two computations (JAX's own bfloat16 MoE forward
is 13% from its float32 one on these inputs).

LM serving: ``decode_attention`` (windows, per-row lengths), and for the
reduced config of each of the five LMs (and the MoE-with-windows config)
the prefill and decode logits and the KV cache against JAX's within rtol
1e-5, and decode after prefill equal to the model's own full forward.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro_torch.core.types import Stacked
from repro_torch.models import layers
from repro_torch.models import transformer as tfm
from repro_torch.models.tree import param_tree

OUT = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
T = torch.from_numpy


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads a test: the models here are small, and the test
    workers share the machine's cores (eight threads a worker run these
    files twice as slowly even alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def port_cfg(jcfg, **kw) -> tfm.LMConfig:
    """The JAX config as the port's (dtypes as torch dtypes)."""
    dt = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
    fields = {f.name for f in dataclasses.fields(tfm.LMConfig)}
    vals = {f: getattr(jcfg, f) for f in fields}
    vals["dtype"], vals["param_dtype"] = dt[jcfg.dtype], dt[jcfg.param_dtype]
    if jcfg.moe:
        vals["moe"] = tfm.MoEConfig(**dataclasses.asdict(jcfg.moe))
    vals.update(kw)
    return tfm.LMConfig(**vals)


def jax_tree(jcfg, seed=0, *, random_bias=False):
    tree = jax.tree.map(np.asarray, jtfm.init(jax.random.PRNGKey(seed), jcfg))
    if random_bias:  # the reference initialises them to zero
        rng = _rng(seed + 100)
        for b in ("bq", "bk", "bv"):
            tree["layers"][b] = _normal(rng, *tree["layers"][b].shape, scale=0.1)
    return tree


def batch_np(seed, b, s, vocab):
    tok = _rng(seed).integers(0, vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": tok[:, :-1], "targets": tok[:, 1:]}


def tree_leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def assert_close(got, want, *, rtol, atol, err_msg=""):
    """Within ``rtol``, and ``atol`` or 1e-5 of ``want``'s largest
    magnitude, whichever is larger."""
    want = np.asarray(want)
    floor = max(atol, 1e-5 * float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=floor, err_msg=err_msg)


def _assert_trees(got, want, **tol):
    got_l, want_l = tree_leaves(got), tree_leaves(want)
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    for (path, g), (_, w) in zip(got_l, want_l):
        assert_close(g, w, err_msg=str(path), **tol)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def test_norms_and_cast():
    rng = _rng(0)
    x, sc, bi = _normal(rng, 3, 5, 16), _normal(rng, 16), _normal(rng, 16)
    np.testing.assert_allclose(layers.rms_norm(T(x), T(sc)).numpy(),
                               np.asarray(jlayers.rms_norm(x, sc)), **OUT)
    np.testing.assert_allclose(layers.layer_norm(T(x), T(bi), T(sc)).numpy(),
                               np.asarray(jlayers.layer_norm(x, bi, sc)), **OUT)
    tree = {"w": T(x), "router": T(sc), "moe": {"router": T(bi), "w_up": T(sc)},
            "ids": torch.arange(3)}
    out = layers.cast_floats(tree, torch.bfloat16)
    assert out["w"].dtype == torch.bfloat16 and out["moe"]["w_up"].dtype == torch.bfloat16
    assert out["router"].dtype == torch.float32 and out["moe"]["router"].dtype == torch.float32
    assert out["ids"].dtype == torch.int64
    # the same leaves cast as JAX's cast_floats casts
    jout = jlayers.cast_floats(jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree), jnp.bfloat16)
    same = jax.tree.map(lambda a, b: (a.dtype == torch.bfloat16) == (b.dtype == jnp.bfloat16),
                        out, jout, is_leaf=lambda t: isinstance(t, torch.Tensor))
    assert all(jax.tree.leaves(same))


def test_rope():
    rng = _rng(1)
    x = _normal(rng, 2, 12, 3, 16)
    pos = np.broadcast_to(np.arange(12), (2, 12)).astype(np.int32) + 5
    np.testing.assert_allclose(layers.rope(T(x), T(pos), theta=500.0).numpy(),
                               np.asarray(jlayers.rope(x, pos, theta=500.0)), **OUT)


@pytest.mark.parametrize("groups", [1, 2, 4])
@pytest.mark.parametrize("window,q_chunk,kv_chunk", [
    (None, 32, 32),  # one tile
    (None, 8, 16),  # several q and kv chunks
    (6, 8, 4),  # a local window across chunks: some kv tiles wholly masked
    (3, 32, 32),
])
def test_flash_attention(groups, window, q_chunk, kv_chunk):
    rng = _rng(2 + groups)
    hkv = 2
    q = _normal(rng, 2, 32, hkv * groups, 8)
    k, v = _normal(rng, 2, 32, hkv, 8), _normal(rng, 2, 32, hkv, 8)
    kw = dict(causal=True, window=window, q_chunk=q_chunk, kv_chunk=kv_chunk)
    got = layers.flash_attention(T(q), T(k), T(v), **kw).numpy()
    want = np.asarray(jlayers.flash_attention(q, k, v, **kw))
    np.testing.assert_allclose(got, want, **OUT)


def test_flash_attention_not_causal():
    rng = _rng(9)
    q, k, v = (_normal(rng, 1, 16, 2, 8) for _ in range(3))
    kw = dict(causal=False, q_chunk=4, kv_chunk=8)
    np.testing.assert_allclose(layers.flash_attention(T(q), T(k), T(v), **kw).numpy(),
                               np.asarray(jlayers.flash_attention(q, k, v, **kw)), **OUT)


def _mlp(rng, d, ff, lead=()):
    return {"w_gate": _normal(rng, *lead, d, ff, scale=0.3),
            "w_up": _normal(rng, *lead, d, ff, scale=0.3),
            "w_down": _normal(rng, *lead, ff, d, scale=0.3)}


def test_swiglu_mlp():
    rng = _rng(3)
    p, x = _mlp(rng, 16, 32), _normal(rng, 2, 5, 16)
    got = layers.swiglu_mlp({k: T(v) for k, v in p.items()}, T(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jlayers.swiglu_mlp(p, x)), **OUT)


def _moe_case(seed, e, top_k, cf, *, ties):
    rng = _rng(seed)
    d, ff, s = 8, 16, 12
    p = _mlp(rng, d, ff, (e,))
    p["router"] = _normal(rng, d, e)
    x = _normal(rng, 2, s, d)
    if ties:
        p["router"][:, 1] = p["router"][:, 3]  # experts 1 and 3 tie on every token
        x[0, :4] = 0.0  # four tokens whose logits all tie (zero)
    return p, x


@pytest.mark.parametrize("e,top_k,cf,ties", [
    (4, 2, 1.25, False),
    (4, 2, 1.25, True),  # router ties: the lower expert id first
    (4, 2, 0.5, True),  # capacity 3 of 24 pairs: dropped pairs to the spill row
    (8, 1, 0.3, False),  # top-1, heavy drops
    (4, 3, 1.0, True),  # three pairs a token: the combine order matters
])
def test_moe_mlp(e, top_k, cf, ties):
    p, x = _moe_case(e + top_k, e, top_k, cf, ties=ties)
    got, aux = layers.moe_mlp({k: T(v) for k, v in p.items()}, T(x), top_k=top_k,
                              capacity_factor=cf)
    want, jaux = jlayers.moe_mlp(p, x, top_k=top_k, capacity_factor=cf)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    # The expert choices themselves are exact (JAX's top_k tie order).
    probs = np.asarray(jax.nn.softmax(jnp.einsum("bsd,de->bse", x, p["router"]), axis=-1))
    _, jexp = jax.lax.top_k(probs, top_k)
    from repro_torch.core.utils import stable_topk
    _, exp = stable_topk(torch.softmax(torch.einsum("bsd,de->bse", T(x), T(p["router"])), -1), top_k)
    if ties:
        assert np.array_equal(np.asarray(jexp)[0, :4], np.tile(np.arange(top_k), (4, 1)))
    np.testing.assert_array_equal(exp.numpy(), np.asarray(jexp))


def test_moe_mlp_grads():
    p, x = _moe_case(11, 4, 2, 0.75, ties=True)
    pt = {k: T(v).requires_grad_() for k, v in p.items()}
    xt = T(x).requires_grad_()
    out, aux = layers.moe_mlp(pt, xt, top_k=2, capacity_factor=0.75)
    (out.square().sum() + aux).backward()

    def f(p, x):
        o, a = jlayers.moe_mlp(p, x, top_k=2, capacity_factor=0.75)
        return jnp.sum(jnp.square(o)) + a

    gp, gx = jax.grad(f, argnums=(0, 1))(p, x)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **GRAD)
    for k in p:
        np.testing.assert_allclose(pt[k].grad.numpy(), np.asarray(gp[k]), err_msg=k, **GRAD)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

DENSE = jtfm.LMConfig(name="dense", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                      vocab=64, dtype=jnp.float32, loss_chunk=8)
QKV_BIAS = dataclasses.replace(DENSE, name="qkv", qkv_bias=True, n_kv_heads=1, d_head=16)
MOE_WINDOWS = jtfm.LMConfig(
    name="moe", n_layers=4, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64, vocab=64,
    moe=jtfm.MoEConfig(n_experts=4, top_k=2, d_ff_expert=16, n_shared=1, capacity_factor=1.0),
    window=8, local_ratio=2, dtype=jnp.float32, loss_chunk=16,
)
CASES = {"dense": (DENSE, False), "qkv_bias": (QKV_BIAS, True), "moe_windows": (MOE_WINDOWS, False)}


def _carried(name):
    jcfg, bias = CASES[name]
    tree = jax_tree(jcfg, random_bias=bias)
    return jcfg, tree, tfm.params_from_numpy(tree, port_cfg(jcfg), device="cpu")


@pytest.mark.parametrize("name", sorted(CASES))
def test_params_round_trip(name):
    jcfg, tree, model = _carried(name)
    back = tfm.params_to_numpy(model)
    got_l, want_l = tree_leaves(back), tree_leaves(tree)
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    for (path, g), (_, w) in zip(got_l, want_l):
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert np.array_equal(g, w), path
    # The layout: every layer leaf is a stack of the per-layer tensors.
    pt = param_tree(dict(model.named_parameters()))
    assert isinstance(pt["layers"]["wq"], Stacked) and pt["layers"]["wq"].shape == tree["layers"]["wq"].shape
    assert pt["layers"]["wq"].parts[1] is model.layers[1].wq


def test_layer_windows():
    for jcfg in (DENSE, MOE_WINDOWS):
        np.testing.assert_array_equal(tfm.layer_windows(port_cfg(jcfg), 32).numpy(),
                                      np.asarray(jtfm.layer_windows(jcfg, 32)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_loss_and_grads(name):
    jcfg, tree, model = _carried(name)
    batch = batch_np(5, 2, 32, jcfg.vocab)
    hidden, aux = model(T(batch["tokens"]).long())
    jhidden, jaux = jtfm.forward(tree, jcfg, batch["tokens"])
    assert_close(hidden.detach().numpy(), jhidden, **OUT)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5, atol=1e-7)

    loss = tfm.train_loss(model, {k: T(v).long() for k, v in batch.items()})
    jloss, jgrads = jax.value_and_grad(jtfm.train_loss)(tree, jcfg, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    got = jax.tree.map(lambda s: np.stack([g.numpy() for g in s.parts]) if isinstance(s, Stacked)
                       else s.numpy(), param_tree(grads),
                       is_leaf=lambda s: isinstance(s, (Stacked, torch.Tensor)))
    _assert_trees(got, jax.tree.map(np.asarray, jgrads), **GRAD)


def test_lm_loss_chunks():
    jcfg, tree, model = _carried("dense")
    rng = _rng(6)
    hidden = _normal(rng, 2, 32, jcfg.d_model)
    targets = rng.integers(0, jcfg.vocab, (2, 32)).astype(np.int64)
    for chunk in (4, 32):
        m = tfm.params_from_numpy(tree, port_cfg(jcfg, loss_chunk=chunk), device="cpu")
        got = float(tfm.lm_loss(m, T(hidden), T(targets)))
        want = float(jtfm.lm_loss(tree, dataclasses.replace(jcfg, loss_chunk=chunk), hidden,
                                  targets.astype(np.int32)))
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_bf16_forward():
    """Element by element within 2e-2 of JAX's bfloat16 forward, and nearer
    to it than to JAX's float32 forward on the same weights: a port that
    computed in float32 and cast its output would be nearer the latter."""
    jcfg = dataclasses.replace(QKV_BIAS, dtype=jnp.bfloat16)
    tree = jax_tree(jcfg, random_bias=True)
    model = tfm.params_from_numpy(tree, port_cfg(jcfg), device="cpu")
    batch = batch_np(8, 2, 32, jcfg.vocab)
    with torch.no_grad():
        hidden, _ = model(T(batch["tokens"]).long())
    assert hidden.dtype == torch.bfloat16
    got = hidden.float().numpy()
    jhidden = np.asarray(jtfm.forward(tree, jcfg, batch["tokens"])[0].astype(jnp.float32))
    np.testing.assert_allclose(got, jhidden, rtol=2e-2, atol=2e-2 * float(np.abs(jhidden).max()))
    j32 = np.asarray(jtfm.forward(tree, QKV_BIAS, batch["tokens"])[0])
    assert np.linalg.norm(got - jhidden) < np.linalg.norm(got - j32)


def test_init_draws_reference_scales():
    cfg = port_cfg(MOE_WINDOWS, d_model=64, d_ff=128)
    m = tfm.init(3, cfg, device="cpu")
    assert torch.all(m.layers[0].ln_attn == 1) and torch.all(m.ln_final == 1)
    assert abs(float(m.embed.std()) - 0.02) < 0.002
    assert abs(float(m.layers[0].wq.std()) - 64 ** -0.5) < 0.01
    # Expert weights scale by their leading dim, the expert count (the
    # reference's ``_dense`` reads shape[0]).
    assert abs(float(m.layers[0].moe["w_gate"].std()) - 4 ** -0.5) < 0.05
    assert m.layers[0].moe["router"].dtype == torch.float32
    again = tfm.init(3, cfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(m.parameters(), again.parameters()))


def test_moe_sequence_chunks(monkeypatch):
    """Sequences longer than ``MOE_SEQ_CHUNK`` dispatch chunk by chunk in
    both packages (the limit lowered to 8 so that a 32-token batch splits)."""
    monkeypatch.setattr(jtfm, "MOE_SEQ_CHUNK", 8)
    monkeypatch.setattr(tfm, "MOE_SEQ_CHUNK", 8)
    jcfg, tree, model = _carried("moe_windows")
    batch = batch_np(12, 2, 32, jcfg.vocab)
    loss = tfm.train_loss(model, {k: T(v).long() for k, v in batch.items()})
    jloss = jtfm.train_loss(tree, jcfg, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    monkeypatch.setattr(tfm, "MOE_SEQ_CHUNK", 8192)  # one dispatch: another loss
    assert float(tfm.train_loss(model, {k: T(v).long() for k, v in batch.items()})) != float(loss)


# ---------------------------------------------------------------------------
# LM serving: prefill, decode and the KV cache
# ---------------------------------------------------------------------------


def _serve_cases():
    from repro.configs import ARCHS as JAX_ARCHS
    from repro.launch.train import reduced_lm as jreduced_lm

    cases = {a: jreduced_lm(s.config) for a, s in JAX_ARCHS.items() if s.family == "lm"}
    cases["moe_windows"] = MOE_WINDOWS  # window 8 fires within the 20 positions
    return cases


SERVE = _serve_cases()


@pytest.mark.parametrize("length", [5, 12])
@pytest.mark.parametrize("window", [None, 4])
def test_decode_attention(length, window):
    rng = _rng(length)
    q = _normal(rng, 3, 1, 4, 8)
    ck, cv = _normal(rng, 3, 16, 2, 8), _normal(rng, 3, 16, 2, 8)
    lengths = np.array([length, 1, 16], dtype=np.int32)  # per-row lengths too
    for ln in (length, lengths):
        got = layers.decode_attention(T(q), T(ck), T(cv), length=T(np.asarray(ln)), window=window)
        want = jlayers.decode_attention(q, ck, cv, length=ln, window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT)


@pytest.mark.parametrize("name", sorted(SERVE))
def test_prefill_and_decode_match_jax(name):
    """Prefill of 16 tokens and one decode step: the logits and the cache
    contents against JAX's (whose cache is padded by 16, as
    ``tests/test_arch_smoke.py`` pads it)."""
    jcfg = SERVE[name]
    tree = jax_tree(jcfg, random_bias=jcfg.qkv_bias)
    for b in ("bq", "bk", "bv") if jcfg.qkv_bias else ():
        tree["layers"][b] = tree["layers"][b].astype(np.asarray(tree["layers"]["wq"]).dtype)
    model = tfm.params_from_numpy(tree, port_cfg(jcfg), device="cpu")
    tokens = batch_np(21, 2, 32, jcfg.vocab)["tokens"]
    logits, cache = tfm.prefill(model, T(tokens[:, :16]).long(), max_len=32)
    jlogits, jcache = jtfm.prefill(tree, jcfg, tokens[:, :16])
    assert logits.dtype == torch.float32 and cache["length"] == 16
    assert_close(logits.numpy(), jlogits, **OUT)
    for kv in ("k", "v"):
        assert_close(cache[kv][:, :, :16].numpy(), jcache[kv], err_msg=kv, **OUT)
        assert not cache[kv][:, :, 16:].any()
    pad = ((0, 0), (0, 0), (0, 16), (0, 0), (0, 0))
    jcache = {"k": jnp.pad(jcache["k"], pad), "v": jnp.pad(jcache["v"], pad),
              "length": jcache["length"]}
    logits2, cache = tfm.decode_step(model, cache, T(tokens[:, 16:17]).long())
    jlogits2, jcache = jtfm.decode_step(tree, jcfg, jcache, tokens[:, 16:17])
    assert cache["length"] == int(jcache["length"]) == 17
    assert_close(logits2.numpy(), jlogits2, **OUT)
    for kv in ("k", "v"):
        assert_close(cache[kv].numpy(), jcache[kv], err_msg=kv, **OUT)


@pytest.mark.parametrize("name", sorted(SERVE))
def test_decode_after_prefill_equals_forward(name):
    """Prefill of 12 tokens then 8 decode steps, teacher-forced: each
    step's logits equal the full forward's at that position, and the cache
    holds the forward's keys and values. MoE configs run with capacity for
    every (token, choice) pair: the reference's expert capacity grows with
    the sequence, so where pairs are dropped a prefix of 12 tokens and the
    whole 20 route differently in both packages."""
    jcfg = SERVE[name]
    if jcfg.moe:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=1e3))
    model = tfm.params_from_numpy(jax_tree(jcfg, seed=1), port_cfg(jcfg), device="cpu")
    tokens = T(batch_np(22, 2, 20, jcfg.vocab)["tokens"]).long()
    logits, cache = tfm.prefill(model, tokens[:, :12], max_len=20)
    steps = [logits]
    for i in range(12, 20):
        steps.append(tfm.decode_step(model, cache, tokens[:, i : i + 1])[0])
    with pytest.raises(ValueError, match="full"):
        tfm.decode_step(model, cache, tokens[:, :1])
    with torch.no_grad():
        hidden, _ = model(tokens)
        want = (hidden[:, 11:] @ model.lm_head.to(model.cfg.dtype)).float()
    assert_close(torch.stack(steps[:-1], 1).numpy(), want[:, :-1].numpy(), **OUT)
    with torch.no_grad():
        _, (ks, vs), _ = model(tokens, collect_cache=True)
    assert_close(cache["k"][:, :, :19].numpy(), ks[:, :, :19].numpy(), **OUT)
    assert_close(cache["v"][:, :, :19].numpy(), vs[:, :, :19].numpy(), **OUT)
