"""Device policy shared by every entry point of the port."""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensor


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the CUDA device; the CPU only when asked for by name.

    There is no silent fall-back: with no card and no explicit device this
    raises, so a run that was meant for the card never measures the CPU.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def is_fake(t: torch.Tensor) -> bool:
    """Whether ``t`` holds no values: a ``FakeTensor`` (shapes, dtypes and
    a device only, as the dry run builds its steps) or a meta tensor."""
    return isinstance(t, FakeTensor) or t.device.type == "meta"
