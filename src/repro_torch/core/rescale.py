"""Key re-scaling (paper Sec. 5.1): min-max normalise packed keys onto the
position range ``[0, length - 1]``.

Keys are int64 here (uint32 in the JAX package): their differences are
exact, and the conversion to float32 rounds exactly as the uint32 one does.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class RescaleParams:
    """Per-array min/max statistics + the target range length. Shapes are
    the caller's batch shape: ``(H,)`` for a core model, ``(c, H)`` for the
    cluster bank."""

    key_min: torch.Tensor  # int64
    key_max: torch.Tensor  # int64
    length: torch.Tensor  # float32 — number of valid slots

    def take(self, idx: torch.Tensor) -> "RescaleParams":
        """Per-index stats out of a stacked bank: leading axis gathered."""
        return RescaleParams(self.key_min[idx], self.key_max[idx], self.length[idx])

    def unsqueeze(self, dim: int) -> "RescaleParams":
        return RescaleParams(
            self.key_min.unsqueeze(dim),
            self.key_max.unsqueeze(dim),
            self.length.unsqueeze(dim),
        )


def fit_rescale(
    sorted_keys: torch.Tensor, valid: torch.Tensor | None = None
) -> RescaleParams:
    """Fit min/max over sorted key arrays ``(..., L)`` (mask-aware; valid
    entries sort first because padding carries the sentinel)."""
    kmin = sorted_keys[..., 0]
    if valid is None:
        kmax = sorted_keys[..., -1]
        length = torch.full_like(kmin, sorted_keys.shape[-1], dtype=torch.float32)
    else:
        n = valid.to(torch.int64).sum(dim=-1)
        last = torch.clamp(n - 1, min=0)
        kmax = torch.gather(sorted_keys, -1, last[..., None])[..., 0]
        length = n.to(torch.float32)
    return RescaleParams(key_min=kmin, key_max=kmax, length=length)


def rescale(params: RescaleParams, keys: torch.Tensor) -> torch.Tensor:
    """int64 keys -> float32 RMI keys in [0, length-1] (clipped). ``params``
    broadcast against ``keys``."""
    kmin, kmax = params.key_min, params.key_max
    clipped = torch.minimum(torch.maximum(keys, kmin), kmax)
    diff = (clipped - kmin).to(torch.float32)
    span = torch.clamp((kmax - kmin).to(torch.float32), min=1.0)
    hi = torch.clamp(params.length - 1.0, min=0.0)
    return torch.minimum(torch.clamp(diff / span * hi, min=0.0), hi)
