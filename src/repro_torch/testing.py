"""Comparison helpers for holding the port against a reference.

Float scores from two implementations differ in summation order, so two
distinct ids whose scores are within float32 rounding of each other may
come out in either order. :func:`topk_mismatches` admits exactly those
swaps and nothing else.
"""
from __future__ import annotations

import numpy as np

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
