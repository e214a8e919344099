#!/usr/bin/env python3
"""The control of a cell: the plain reference, with every product in TF32
(inputs rounded to 10 mantissa bits, as a tensor core reads float32), put
in the program's place on the cell's timed path through ``cell.run``'s
search hook. It searches the index the program built, and the run judges
its answers as it judges the program's, so the result line has to read
``correct`` false.

    python3 perfbench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

Prints, a seed, the run's result line with its checks, and the readings
of the index check's bands for decisions made in TF32 over the same index
(``reference.lider_index.tf32_readings``). The benchmark's own runs never
run the control.
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

from pbench import cell, data  # noqa: E402

CHUNK = 1 << 18


def tf32_hook(search, env):
    """Replace the timed search by the reference in TF32 over the run's
    corpus, which it rounds to TF32 in place."""
    from pbench import system

    ref, cfg, st, corpus = env["reference"], env["config"], env["state"], env["corpus"]
    for s in range(0, corpus.shape[0], CHUNK):
        corpus[s:s + CHUNK] = ref.round_tf32(corpus[s:s + CHUNK])
    d, dev = cfg["dim"], corpus.device
    proj_c = ref.draw_projections(env["build_seed"] + 1, d, cfg["n_arrays_centroid"],
                                  cfg["key_len_centroid"], dev)
    proj_b = ref.draw_projections(env["build_seed"] + 2, d, cfg["n_arrays"], cfg["key_len"], dev)
    block = max(1, int(env["limits"]["judge_bytes"] // (corpus.shape[0] * 10)))

    def control(*args, **kw):
        q = args[0] if len(args) == 1 else args[1]
        ids, scores = ref.control_answers(st, cfg, q, corpus, proj_c, proj_b, block=block)
        return system.TopK(ids.to(torch.int32), scores)
    return control


def band_readings(env: dict, seed: int, device: torch.device) -> dict:
    """The control's readings of the index check's bands, over the run's
    corpus (made again from the seed) and the first queries of its pool,
    and the count of centroids off for a k-means from another draw."""
    cfg, lim = env["config"], env["limits"]
    ref = env["reference"]
    idx = cell.ref_index(ref)
    corpus = data.retrieval_corpus(seed + cell.CORPUS, cfg["corpus_size"], cfg["dim"],
                                   spread=cfg["spread"], device=device)
    q = data.retrieval_queries(seed + cell.POOL, corpus, 4096, noise=cfg["query_noise"])
    d, b_seed = cfg["dim"], env["build_seed"]
    proj_c = ref.draw_projections(b_seed + 1, d, cfg["n_arrays_centroid"],
                                  cfg["key_len_centroid"], device)
    proj_b = ref.draw_projections(b_seed + 2, d, cfg["n_arrays"], cfg["key_len"], device)
    rd = idx.tf32_readings(env["state"], cfg, corpus, q, proj_c, proj_b,
                           band_key=lim["band_key"], band_score=lim["band_score"],
                           band_dist=lim["band_dist"], pos_tol=lim["pos_tol"])
    # a build whose k-means started from another draw
    other = idx.kmeans_refit(corpus, cfg["n_clusters"], cfg["kmeans_iters"], b_seed + 1)
    rd["centroids_off_other_draw"] = idx.centroid_readings(
        env["state"]["centroids"], other, lim["tol_centroid"])["centroids_off"]
    return rd


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        cell.log("needs a CUDA device")
        return 2
    dev = torch.device("cuda", 0)
    t0 = T_START
    for seed in args.seeds:
        seen = {}

        def hook(search, env):
            seen.update({k: v for k, v in env.items() if k != "corpus"})
            return tf32_hook(search, env)

        out = cell.run(args.workload, seed, args.seconds, False, device=dev, t_start=t0,
                       search_hook=hook)
        t1 = time.perf_counter()
        readings = band_readings(seen, seed, dev)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": out["result"]["correct"], "checks": out["result"]["checks"],
                          "index_faults": out["info"]["index_faults"],
                          "tf32_readings": readings, "judged": out["info"]["judged"],
                          "readings_s": time.perf_counter() - t1}), flush=True)
        del seen, out
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
