#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s ``models_sharded`` phase alone on the card.

    python3 scripts/models_sharded_only.py

The device phase (the card's name and power limit), the kernel build, then
the models' half of the distributed path: four gloo ranks sharing the card
as a (data=2, model=2) grid against this process's single-rank run (about
2.5 minutes on an H100). It needs a CUDA card and fails without one.
"""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

if __name__ == "__main__":
    t0 = time.perf_counter()
    d = cs.phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cs.phase_build()
    cs.phase_models_sharded(dev, d["smi"])
    print(f"models_sharded alone: {time.perf_counter() - t0:.1f} s with the build", flush=True)
