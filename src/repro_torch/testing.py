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
"""
from __future__ import annotations

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
