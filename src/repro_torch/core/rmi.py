"""Simplified recursive-model index (paper Sec. 5.2): a linear root that
splits ``[0, L)`` into ``n_leaves`` ranges and one linear model per leaf,
fitted in closed form with centered weighted least squares.

Every function works on a batch of arrays at once (leading dims), in place
of the JAX package's ``vmap``. Sums are float32 segment sums, so fitted
parameters agree with the JAX package to float32 tolerance, not bit for bit;
on the card they are masked reductions, not atomics, so one shape always
sums in one order.
"""
from __future__ import annotations

import dataclasses

import torch

_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class RMIParams:
    root_w: torch.Tensor  # (...,) f32
    root_b: torch.Tensor  # (...,) f32
    leaf_w: torch.Tensor  # (..., n_leaves) f32
    leaf_b: torch.Tensor  # (..., n_leaves) f32
    length: torch.Tensor  # (...,) f32 — number of valid slots
    max_err: torch.Tensor  # (..., n_leaves) f32 — max |pred - true| at fit time
    n_leaves: int

    def take(self, idx: torch.Tensor) -> "RMIParams":
        """Per-index models out of a stacked bank: leading axis gathered."""
        return RMIParams(
            root_w=self.root_w[idx], root_b=self.root_b[idx],
            leaf_w=self.leaf_w[idx], leaf_b=self.leaf_b[idx],
            length=self.length[idx], max_err=self.max_err[idx],
            n_leaves=self.n_leaves,
        )


def _wls(x, y, w):
    """Weighted least squares over the last axis, centered moments."""
    n = w.sum(-1, keepdim=True)
    mx = (w * x).sum(-1, keepdim=True) / torch.clamp(n, min=_EPS)
    my = (w * y).sum(-1, keepdim=True) / torch.clamp(n, min=_EPS)
    cov = (w * (x - mx) * (y - my)).sum(-1, keepdim=True)
    var = (w * (x - mx) ** 2).sum(-1, keepdim=True)
    slope = torch.where(var > _EPS, cov / torch.clamp(var, min=_EPS), 0.0)
    return slope, my - slope * mx


def _leaf_of(root_w, root_b, x, length, n_leaves):
    hi = torch.clamp(length - 1.0, min=0.0)
    pred = torch.minimum(torch.clamp(root_w * x + root_b, min=0.0), hi)
    leaf = torch.floor(pred * n_leaves / torch.clamp(length, min=1.0))
    return torch.clamp(leaf.to(torch.int64), 0, n_leaves - 1)


def _segment_sum(vals, seg, n_leaves):
    """Per-leaf sums over the last axis, ``(..., L) -> (..., n_leaves)``.

    On the CPU a ``scatter_add_``, which adds in index order, the order of
    the JAX package's ``segment_sum`` there: a masked reduction sums in
    another order and puts a leaf weight of
    ``tests/test_torch_core.py::test_core_model_build_matches_jax`` outside
    its tolerance. On the card ``scatter_add_`` adds in the order its
    atomics land, which changes from run to run, so there the sums are
    masked reductions: one order for every call of one shape, so a refit
    reproduces a build's fit bit for bit.
    """
    if vals.device.type == "cpu":
        out = torch.zeros(*vals.shape[:-1], n_leaves, dtype=vals.dtype, device=vals.device)
        return out.scatter_add_(-1, seg, vals)
    leaves = torch.arange(n_leaves, device=seg.device)[:, None]
    return torch.where(seg.unsqueeze(-2) == leaves, vals.unsqueeze(-2), 0.0).sum(-1)


def fit_rmi(keys: torch.Tensor, weights: torch.Tensor, n_leaves: int) -> RMIParams:
    """Fit 2-layer linear RMIs on sorted (re-scaled) key arrays ``(..., Lp)``.

    ``weights``: (..., Lp) {0,1} mask; labels are positions 0..n_valid-1
    because padding sorts last.
    """
    lp = keys.shape[-1]
    w = weights.to(torch.float32)
    y = torch.arange(lp, dtype=torch.float32, device=keys.device).expand_as(keys)
    length = w.sum(-1, keepdim=True)

    root_w, root_b = _wls(keys, y, w)
    leaf = _leaf_of(root_w, root_b, keys, length, n_leaves)

    n_l = _segment_sum(w, leaf, n_leaves)
    mx_l = _segment_sum(w * keys, leaf, n_leaves) / torch.clamp(n_l, min=_EPS)
    my_l = _segment_sum(w * y, leaf, n_leaves) / torch.clamp(n_l, min=_EPS)
    dx = keys - torch.gather(mx_l, -1, leaf)
    dy = y - torch.gather(my_l, -1, leaf)
    cov_l = _segment_sum(w * dx * dy, leaf, n_leaves)
    var_l = _segment_sum(w * dx * dx, leaf, n_leaves)
    slope_l = torch.where(var_l > _EPS, cov_l / torch.clamp(var_l, min=_EPS), 0.0)
    inter_l = my_l - slope_l * mx_l
    empty = n_l < 0.5  # empty leaves fall back to the root model
    leaf_w = torch.where(empty, root_w, slope_l)
    leaf_b = torch.where(empty, root_b, inter_l)

    hi = torch.clamp(length - 1.0, min=0.0)
    pred = torch.gather(leaf_w, -1, leaf) * keys + torch.gather(leaf_b, -1, leaf)
    pred = torch.minimum(torch.clamp(pred, min=0.0), hi)
    err = torch.abs(pred - y) * w
    max_err = torch.full_like(n_l, float("-inf")).scatter_reduce_(
        -1, leaf, err, reduce="amax", include_self=True
    )
    max_err = torch.where(torch.isfinite(max_err), max_err, 0.0)
    return RMIParams(
        root_w=root_w[..., 0],
        root_b=root_b[..., 0],
        leaf_w=leaf_w,
        leaf_b=leaf_b,
        length=length[..., 0],
        max_err=max_err,
        n_leaves=n_leaves,
    )


def predict_banked(params: RMIParams, x: torch.Tensor) -> torch.Tensor:
    """Predict positions (float32, clipped to [0, length-1]) for scaled keys.

    ``root_w``/``root_b``/``length`` broadcast against ``x`` and
    ``leaf_w``/``leaf_b`` against ``x.shape + (n_leaves,)``. Rounds as the
    JAX package does: ``w * x + b`` as a multiply then an add.
    """
    hi = torch.clamp(params.length - 1.0, min=0.0)
    pred = torch.minimum(torch.clamp(params.root_w * x + params.root_b, min=0.0), hi)
    leaf = torch.floor(pred * params.n_leaves / torch.clamp(params.length, min=1.0))
    leaf = torch.clamp(leaf.to(torch.int64), 0, params.n_leaves - 1)
    shape = x.shape + (params.n_leaves,)
    lw = torch.gather(params.leaf_w.expand(shape), -1, leaf[..., None])[..., 0]
    lb = torch.gather(params.leaf_b.expand(shape), -1, leaf[..., None])[..., 0]
    return torch.minimum(torch.clamp(lw * x + lb, min=0.0), hi)


def predict(params: RMIParams, x: torch.Tensor) -> torch.Tensor:
    """Per-array prediction: params of shape (H,)/(H, W), ``x`` (H, B)."""
    expanded = RMIParams(
        root_w=params.root_w[:, None], root_b=params.root_b[:, None],
        leaf_w=params.leaf_w[:, None, :], leaf_b=params.leaf_b[:, None, :],
        length=params.length[:, None], max_err=params.max_err,
        n_leaves=params.n_leaves,
    )
    return predict_banked(expanded, x)
