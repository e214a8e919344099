#!/usr/bin/env python3
"""Time the distributed search's collectives with and without the device
syncs that bound them, in turns, each in a fresh process:

    python3 scripts/ab_distributed.py

Each turn builds the distributed phase's corpus (``chip_smoke.SMALL_N``
passages), queries and float32 centroids at full ``lider-msmarco`` width
(seed 0), then runs ``chip_smoke.py``'s
distributed phase alone: four gloo ranks on the card, every point on the
2x2 grid, F32 on the 4x1 grid, the sharded Lloyd step, a one-rank NCCL
world, with every gate of the phase. The turns go on, off, off, on. "on"
is the search as it ships: ``search.timings["gather_s"]`` runs from a sync
of the rank's device to a sync after each collective. "off" makes those
syncs (``launch/mesh.py``'s, around every collective) no-ops in every
rank (the switch travels in the environment, so the spawned ranks, which
import this module again, take it too); its
``gather_s`` then also holds the rank's own kernels still queued when the
collective starts. Prints the card's name and power limit and each turn's
phase lines (world wall a batch, rank 0's collectives). Needs a CUDA card.
"""
from __future__ import annotations

import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
SWITCH = "LIDER_AB_COLLECTIVE_SYNC"

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)

if os.environ.get(SWITCH) == "off":
    import repro_torch.launch.mesh as _mesh

    _mesh._sync = lambda device: None


def turn() -> None:
    import torch
    from repro_torch.configs.lider_msmarco import CONFIG
    from repro_torch.core import lider
    from repro_torch.core.baselines import flat_search
    from repro_torch.data import synthetic

    d = cs.phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cs.phase_build()
    corpus = synthetic.retrieval_corpus(cs.SEED, cs.SMALL_N, CONFIG.dim, device=dev)
    queries, _ = synthetic.retrieval_queries(cs.SEED + 1, corpus, cs.N_BATCHES * cs.BATCH)
    p = lider.build_lider(cs.SEED, corpus, CONFIG.lider, device=dev)
    gt = flat_search(corpus, queries, k=CONFIG.k)
    main = {"corpus": corpus, "queries": queries, "centroids": p.centroids, "gt": gt.ids}
    del p
    cs.phase_distributed(dev, main, d["smi"])


def main() -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    keep = re.compile(r"on the 2x2 grid: world wall|4x1 grid|NCCL world|Lloyd step over|phase [0-9.]+ s")
    rc = 0
    for i, mode in enumerate(("on", "off", "off", "on"), 1):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, __file__, "--turn"], cwd=ROOT, capture_output=True,
                             text=True, env={**os.environ, SWITCH: mode})
        print(f"turn {i}, syncs {mode}: exit {res.returncode} in {time.perf_counter() - t0:.1f} s"
              + ("" if mode == "on" else " (gather_s also holds rank 0's queued kernels)"), flush=True)
        for line in res.stdout.splitlines():
            if keep.search(line):
                line = re.sub(r" \(all [^)]*\)", "", line)
                print("  " + line.split("; launches per rank")[0], flush=True)
        if res.returncode:
            print(res.stdout[-3000:] + res.stderr[-3000:], flush=True)
            rc = 1
    return rc


if __name__ == "__main__":
    if sys.argv[1:] == ["--turn"]:
        turn()
    else:
        sys.exit(main())
