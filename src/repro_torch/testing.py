"""Comparison helpers for holding the port against a reference.

Float scores from two implementations differ in summation order, so two
distinct ids whose scores are within float32 rounding of each other may
come out in either order. :func:`topk_mismatches` admits exactly those
swaps and nothing else.

Hash keys and k-means assignments are decided by the sign of a float32 sum
or by the smaller of two, so two summation orders may disagree where the
exact value is within rounding of the decision. :func:`lsh_key_flips` and
:func:`assignment_flips` admit a difference only there: where the float64
value lies within ``d * 2**-24`` times the sum of the magnitudes of its
terms (the worst-case float32 error of a d-term sum in any order).
That bound refuses a one-pass TF32 product only rarely (about 2e-7 of the
bits at d = 768; :func:`lsh_bits_outside_bound` counts them), so k-means
distances are also held to float64 (:func:`min_dist_error`), at most
``F32_ERROR_FACTOR`` times the plain float32 version's error.

A model's loss and gradients computed twice (:func:`card_against_cpu`) are
held within ``LOSS_RTOL`` and ``GRAD_RTOL`` / ``GRAD_ATOL``, each element
also allowed ``NEAR_ZERO`` of its leaf's largest magnitude.

:func:`uncaptured` runs the query path's entries as their plain bodies: the
search a captured one is held against, and the one a patch of the kernel
wrappers reaches (a graph's replay calls no Python).
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
from pathlib import Path
from unittest import mock

import numpy as np
import torch

# Both sides accumulate in float32 and differ only in summation order.
SCORE_RTOL = 1e-5
SCORE_ATOL = 1e-6


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu()
        if str(x.dtype) == "torch.bfloat16":
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def topk_mismatches(ids_a, sc_a, ids_b, sc_b, *, rtol=SCORE_RTOL, atol=SCORE_ATOL):
    """Compare two (..., k) top-k results.

    Returns ``(n_swapped, problems)``: the count of positions whose ids
    differ only by a swap of near-equal scores, and a list of positions
    that differ otherwise (empty when the results agree). Scores must
    match position by position within the tolerance; an id that differs
    must sit in the other list at a score within the tolerance of its own,
    or, when it fell off the other list, tie with that list's last score.
    """
    ia, ib = _np(ids_a).reshape(-1, _np(ids_a).shape[-1]), _np(ids_b).reshape(-1, _np(ids_b).shape[-1])
    sa, sb = _np(sc_a).reshape(ia.shape), _np(sc_b).reshape(ib.shape)
    problems: list[tuple[int, int]] = []
    swapped = 0

    def close(x, y):
        if np.isneginf(x) or np.isneginf(y):
            return bool(np.isneginf(x) and np.isneginf(y))
        return abs(float(x) - float(y)) <= atol + rtol * abs(float(y))

    for r in range(ia.shape[0]):
        pos_a = {int(v): j for j, v in enumerate(ia[r]) if v >= 0}
        pos_b = {int(v): j for j, v in enumerate(ib[r]) if v >= 0}
        for j in range(ia.shape[1]):
            if not close(sa[r, j], sb[r, j]):
                problems.append((r, j))
                continue
            if ia[r, j] == ib[r, j]:
                continue
            ok = True
            for ids_here, pos_other, sc_other, sc_here in (
                (ia[r, j], pos_b, sb[r], sa[r, j]),
                (ib[r, j], pos_a, sa[r], sb[r, j]),
            ):
                if ids_here < 0:
                    ok = False
                elif int(ids_here) in pos_other:
                    ok &= close(sc_here, sc_other[pos_other[int(ids_here)]])
                else:
                    ok &= close(sc_here, sc_other[-1])
            if ok:
                swapped += 1
            else:
                problems.append((r, j))
    return swapped, problems


def assert_topk_match(ids_a, sc_a, ids_b, sc_b, *, rtol=SCORE_RTOL, atol=SCORE_ATOL):
    """Raise ``AssertionError`` unless the two top-k results agree up to
    swaps of near-equal scores; returns the number of such swaps."""
    swapped, problems = topk_mismatches(ids_a, sc_a, ids_b, sc_b, rtol=rtol, atol=atol)
    if problems:
        r, j = problems[0]
        raise AssertionError(
            f"{len(problems)} top-k positions differ beyond score ties; first at "
            f"row {r}, slot {j}: ids {_np(ids_a).reshape(-1, _np(ids_a).shape[-1])[r][:j + 3]} "
            f"vs {_np(ids_b).reshape(-1, _np(ids_b).shape[-1])[r][:j + 3]}"
        )
    return swapped


def _rounding_bound(d: int) -> float:
    return d * 2.0**-24


def _key_bits(x, proj, key_len: int, got, want):
    """(flipped, near) bit masks of two (N, H) key tensors: bits that
    differ, and bits whose float64 projection lies within the rounding
    bound of 0; and the float64 projections."""
    xd = x.detach().to(torch.float64)
    pd = proj.detach().to(device=xd.device, dtype=torch.float64)
    shifts = torch.arange(key_len - 1, -1, -1, device=xd.device)

    def bits(k):
        k = k.detach().to(device=xd.device, dtype=torch.int64)
        return ((k[..., None] >> shifts) & 1).reshape(k.shape[0], -1)

    flips = bits(got) != bits(want)
    acc = xd @ pd
    # An all-zero product (a zero pad row) sums exactly in any order: no
    # bound, so it is not a near-tie.
    bound = _rounding_bound(x.shape[1]) * (xd.abs() @ pd.abs())
    return flips, (acc.abs() <= bound) & (bound > 0), acc


def lsh_key_flips(x, proj, n_arrays: int, key_len: int, got, want) -> dict:
    """Compare two (N, H) key tensors for rows ``x`` and projections
    ``proj``; raise ``AssertionError`` on any bit that differs where the
    float64 projection is not within the rounding bound of 0. Returns
    ``{"bits", "flips", "near"}``: bits compared, bits that differ, and
    bits whose projection lies within the bound (where a flip is allowed)."""
    flips, near, acc = _key_bits(x, proj, key_len, got, want)
    bad = flips & ~near
    if bool(bad.any()):
        r, j = (int(v) for v in bad.nonzero()[0])
        raise AssertionError(
            f"{int(bad.sum())} key bits differ outside the rounding bound; first at row "
            f"{r}, bit {j}: projection {float(acc[r, j]):.3e}"
        )
    return {"bits": flips.numel(), "flips": int(flips.sum()), "near": int(near.sum())}


def lsh_bits_outside_bound(x, proj, n_arrays: int, key_len: int, got, want) -> int:
    """How many bits of ``got`` differ from ``want`` where the float64
    projection is not within the rounding bound of 0: what
    :func:`lsh_key_flips` refuses, counted (say, for a TF32 product, to
    show that the check can refuse one)."""
    flips, near, _ = _key_bits(x, proj, key_len, got, want)
    return int((flips & ~near).sum())


def assignment_flips(x, centroids, got, want) -> dict:
    """Compare two (N,) nearest-centroid assignments of rows ``x``; raise
    ``AssertionError`` on any row where they differ and the float64
    distances to the two chosen centroids are further apart than the sum of
    their rounding bounds. Returns ``{"rows", "differ"}``."""
    got = got.detach().to(torch.int64)
    want = want.detach().to(device=got.device, dtype=torch.int64)
    rows = (got != want).nonzero()[:, 0]
    if rows.numel():
        xd = x.detach()[rows].to(device=got.device, dtype=torch.float64)
        cd = centroids.detach().to(device=got.device, dtype=torch.float64)
        a, b = cd[got[rows]], cd[want[rows]]
        bnd = _rounding_bound(x.shape[1])

        def dist_and_bound(c):
            dist = ((xd - c) ** 2).sum(-1)
            mag = (xd * xd).sum(-1) + 2 * (xd * c).abs().sum(-1) + (c * c).sum(-1)
            return dist, bnd * mag

        (da, ba), (db, bb) = dist_and_bound(a), dist_and_bound(b)
        bad = (da - db).abs() > ba + bb
        if bool(bad.any()):
            i = int(bad.nonzero()[0, 0])
            raise AssertionError(
                f"{int(bad.sum())} assignments differ outside the rounding bound; first at "
                f"row {int(rows[i])}: centroid {int(got[rows[i]])} at {float(da[i]):.6e} vs "
                f"{int(want[rows[i]])} at {float(db[i]):.6e}"
            )
    return {"rows": got.numel(), "differ": int(rows.numel())}


# The plain float32 version's error against float64 times this is the
# most a float32 kernel may err: a fixed-order FMA chain over d errs several
# times more than a blocked library sum, while a product on TF32 inputs
# (10-bit mantissas) errs ~2**13 times more per term than float32.
F32_ERROR_FACTOR = 16


def min_dist_error(x, centroids, assign, min_d, *, chunk: int = 65536) -> float:
    """Largest error of ``min_d`` (N,) against the float64 squared distance
    from each row of ``x`` to its ``assign``ed centroid, relative to
    ``|x|^2 + |c|^2``, the size of the terms that cancel in ``x_sq - 2 x.c
    + c_sq``. Rows go ``chunk`` at a time."""
    cd = centroids.detach().to(torch.float64)
    worst = 0.0
    for s in range(0, x.shape[0], chunk):
        xd = x[s : s + chunk].detach().to(device=cd.device, dtype=torch.float64)
        c = cd[assign[s : s + chunk].to(device=cd.device, dtype=torch.int64)]
        exact = ((xd - c) ** 2).sum(-1)
        size = (xd * xd).sum(-1) + (c * c).sum(-1)
        err = (min_d[s : s + chunk].to(device=cd.device, dtype=torch.float64) - exact).abs()
        worst = max(worst, float((err / size.clamp(min=1e-300)).max()))
    return worst


def query_keys(params, queries) -> torch.Tensor:
    """The hash keys a search computes for each query: the centroid
    model's then the bank's, ``(B, H_c + H)`` int64."""
    from .core import lsh

    return torch.cat([
        lsh.hash_vectors(params.centroid_cm.lsh, queries),
        lsh.hash_vectors(params.bank.lsh, queries),
    ], dim=1)


def query_key_flips(params, queries, got, want) -> tuple[torch.Tensor, dict]:
    """Compare two :func:`query_keys` results of one index (say the card's
    kernel and the plain version), each flipped bit held to the rounding
    bound (:func:`lsh_key_flips`). Returns ``(same, report)``: the (B,) mask
    of queries whose keys all agree (their searches must then agree too)
    and ``{"bits", "flips", "near"}`` summed over both models."""
    hc = params.centroid_cm.lsh.n_arrays
    report = {"bits": 0, "flips": 0, "near": 0}
    for lp, cols in ((params.centroid_cm.lsh, slice(0, hc)), (params.bank.lsh, slice(hc, None))):
        r = lsh_key_flips(queries, lp.projections, lp.n_arrays, lp.key_len, got[:, cols], want[:, cols])
        report = {k: report[k] + r[k] for k in report}
    same = (got.cpu() == want.cpu()).all(dim=1)
    return same, report


# Losses and gradients of one model run twice (on the card and on the CPU,
# or in the two packages): float32 sums in other orders.
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
# Elements near zero are held to this share of the leaf's largest magnitude.
NEAR_ZERO = 1e-5


def scaled_error(got, want, *, rtol: float, atol: float) -> float:
    """max |got - want| / (atol + rtol |want| + NEAR_ZERO max|want|): at
    most 1 where ``got`` is within tolerance of ``want``."""
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    floor = max(atol, NEAR_ZERO * float(np.abs(want).max(initial=0.0)))
    return float(np.max(np.abs(got - want) / (floor + rtol * np.abs(want)), initial=0.0))


def loss_and_grads(model, loss_fn, batch) -> tuple[float, dict[str, torch.Tensor]]:
    """One forward and backward -> (loss, {parameter name: gradient on the
    host})."""
    for p in model.parameters():
        p.grad = None
    loss = loss_fn(model, batch)
    loss.backward()
    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters() if p.grad is not None}
    for p in model.parameters():
        p.grad = None
    return float(loss.detach()), grads


# The architectures whose reduced configs :func:`card_against_cpu` runs.
CARD_IDS = ("qwen2.5-3b", "llama4-scout-17b-a16e", "gatedgcn", "sasrec", "two-tower-retrieval",
            "din", "xdeepfm")


def card_configs() -> dict:
    """The configs :func:`card_against_cpu` is run on: ``reduced_lm`` of
    qwen2.5-3b (dense, qkv bias), and of llama4-scout-17b-a16e (MoE) with
    its local windows made to fire: four layers, window 16 on layers 0-2
    (layer 3 global), at sequence 64; and the reduced config of the GNN and
    of each recsys model (``reduced_gnn``, ``reduced_recsys``)."""
    from .configs import get_arch
    from .launch.train import reduced_gnn, reduced_lm, reduced_recsys

    reduce = {"lm": reduced_lm, "gnn": reduced_gnn, "recsys": reduced_recsys}
    out = {a: reduce[get_arch(a).family](get_arch(a).config) for a in CARD_IDS}
    out["llama4-scout-17b-a16e"] = dataclasses.replace(out["llama4-scout-17b-a16e"], n_layers=4,
                                                        window=16)
    return out


@contextlib.contextmanager
def uncaptured():
    """Within the block, ``core.lider``'s seven query-path entries are their
    ``__wrapped__`` bodies: nothing is captured, replayed or counted, and
    every kernel call runs through the Python wrappers."""
    from .core import graphs, lider

    with contextlib.ExitStack() as stack:
        for name in lider._QUERY_PATH_GRAPHS:
            entry = getattr(lider, name)
            if isinstance(entry, graphs.QueryPathEntry):
                stack.enter_context(mock.patch.object(lider, name, entry.__wrapped__))
        yield


def load_example(name: str):
    """The module of the repo's ``examples/<name>.py`` (the examples are
    scripts, not a package)."""
    path = Path(__file__).resolve().parents[2] / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _task(cfg, batch: int | None, seq: int, seed: int):
    """(model library, loss function, batch on the CPU) for a config of any
    family; ``batch`` None takes the family's default (2 sequences of
    ``seq`` tokens, 16 recsys rows, a graph of 128 nodes and 512 edges)."""
    from .data import synthetic
    from .models import gnn, recsys
    from .models import transformer as tfm

    if isinstance(cfg, tfm.LMConfig):
        b = synthetic.lm_batch(seed, 0, batch=batch or 2, seq=seq, vocab=cfg.vocab, device="cpu")
        return tfm, tfm.train_loss, b
    if isinstance(cfg, recsys.RecsysConfig):
        b = synthetic.recsys_batch(seed, 0, kind=cfg.kind, batch=batch or 16, cfg=cfg, device="cpu")
        return recsys, recsys.LOSS[cfg.kind], b
    n = batch or 128
    g = synthetic.random_graph(seed, n, 4 * n, cfg.d_feat, cfg.n_classes, device="cpu")
    return gnn, gnn.train_loss, {k: g[k] for k in ("node_feat", "edge_index", "labels")}


def _float32_on_card(cfg) -> None:
    if cfg.dtype != torch.float32 or getattr(cfg, "param_dtype", torch.float32) != torch.float32:
        raise ValueError("the card-against-CPU check runs in float32")
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 products are on: the card would not compute in float32")


def card_against_cpu(cfg, *, batch: int | None = None, seq: int = 64, seed: int = 0) -> dict:
    """The model's loss and every gradient on the card against the same
    step on the CPU, float32 with TF32 off, for a config of any family
    (LM, recsys, GNN): one set of weights (drawn on the CPU, copied to the
    card) and one batch. Raises unless the loss is within ``LOSS_RTOL``
    and every gradient within ``GRAD_RTOL`` / ``GRAD_ATOL`` (plus
    ``NEAR_ZERO``); returns the errors, each in units of its tolerance."""
    _float32_on_card(cfg)
    lib, loss_fn, b = _task(cfg, batch, seq, seed)
    cpu = lib.init(seed, cfg, device="cpu")
    card = lib.params_from_numpy(lib.params_to_numpy(cpu), cfg, device="cuda")
    loss_c, grads_c = loss_and_grads(cpu, loss_fn, b)
    on_card = {k: v.cuda() if isinstance(v, torch.Tensor) else v for k, v in b.items()}
    loss_g, grads_g = loss_and_grads(card, loss_fn, on_card)
    if set(grads_c) != set(grads_g):
        raise AssertionError(f"gradients of other parameters: {sorted(set(grads_c) ^ set(grads_g))}")
    loss_err = abs(loss_g - loss_c) / (LOSS_RTOL * abs(loss_c))
    grad_err = {n: scaled_error(grads_g[n], grads_c[n], rtol=GRAD_RTOL, atol=GRAD_ATOL)
                for n in grads_c}
    worst = max(grad_err, key=grad_err.get)
    if loss_err > 1 or grad_err[worst] > 1:
        raise AssertionError(f"{cfg.name}: loss {loss_g} on the card, {loss_c} on the CPU; "
                             f"gradient {worst} at {grad_err[worst]:.3g} of its tolerance")
    return {"loss": loss_c, "loss_err": loss_err, "grad_err": grad_err[worst], "worst": worst,
            "n_grads": len(grad_err)}


# LM serving on the card against the CPU: float32 logits, rtol 1e-5.
LOGIT_RTOL, LOGIT_ATOL = 1e-5, 1e-6


def serve_card_against_cpu(cfg, *, batch: int = 2, prompt: int = 16, seed: int = 0) -> dict:
    """The logits of a prefill of ``prompt`` tokens and of one decode step
    after it, on the card against the CPU (float32, TF32 off, one set of
    weights). Raises unless both are within ``LOGIT_RTOL`` / ``LOGIT_ATOL``
    (plus ``NEAR_ZERO``); returns the errors in units of the tolerance."""
    from .data.synthetic import lm_batch
    from .models import transformer as tfm

    _float32_on_card(cfg)
    cpu = tfm.init(seed, cfg, device="cpu")
    card = tfm.params_from_numpy(tfm.params_to_numpy(cpu), cfg, device="cuda")
    tokens = lm_batch(seed, 0, batch=batch, seq=prompt + 1, vocab=cfg.vocab, device="cpu")["tokens"]
    out = {}
    for name, model, t in (("cpu", cpu, tokens), ("card", card, tokens.cuda())):
        logits, cache = tfm.prefill(model, t[:, :prompt], max_len=prompt + 1)
        step, _ = tfm.decode_step(model, cache, t[:, prompt : prompt + 1])
        out[name] = (logits.cpu(), step.cpu())
    errs = {f"{which}_err": scaled_error(out["card"][i], out["cpu"][i], rtol=LOGIT_RTOL,
                                         atol=LOGIT_ATOL)
            for i, which in enumerate(("prefill", "decode"))}
    if max(errs.values()) > 1:
        raise AssertionError(f"{cfg.name}: serving logits on the card differ from the CPU's: {errs}")
    return errs
