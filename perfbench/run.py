#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once, on the CUDA device, and print its
result as the last line of standard output:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``--trace 0`` measures the cell's end-to-end metrics; ``--trace 1`` profiles
a stretch of the window and reports its per-layer metrics. Each run checks a
seeded sample of its answers against the plain reference and prints each
number compared beside its limit, as the last lines of standard error and
under ``checks`` in the result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))

import pbench  # noqa: E402

pbench.process_settings()

import torch  # noqa: E402

from pbench import cell  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    chips = cell.load_spec(args.workload)["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        cell.log(f"needs {chips} CUDA device(s), found {n}")
        return 2
    torch.cuda.set_device(0)
    out = cell.run(args.workload, args.seed, args.seconds, bool(args.trace),
                   device=torch.device("cuda", 0), t_start=T_START)
    found = cell.forbidden_modules()
    if found:
        cell.log(f"the run imported {', '.join(found)}")
        return 3
    cell.log(json.dumps(out["info"], default=str))
    for name, (value, limit) in out["checks"].items():
        cell.log(f"check {name} {value!r} limit {limit!r}")
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
