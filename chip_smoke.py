#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of LIDER on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing its lines; any failure exits non-zero:

1. device    — the card's name and power limit (``nvidia-smi``); no CUDA
               device is an error, never a fall-back to the CPU.
2. build     — ``nvcc`` builds every kernel source under ``csrc/``, one
               process per source, all at once; ``cuobjdump -res-usage``
               prints the registers and stack frame of every kernel.
3. parity    — each kernel against its plain version on edge cases
               (duplicates, dead tiles, an all-invalid row, k above the
               valid count, heavy score ties): ``fused_verify`` on float32,
               bfloat16, int8 and packed-int4 tables, ``sketch_prefilter``,
               ``fused_verify_grouped`` on schedules with padding steps,
               empty slots and an id repeated on bit-equal rows, at block_q
               up to 32 and k' up to Lp = 12,288. Quantized and sketch
               kernels must be bit-equal (ids and scores). Then the cases
               that reach the per-query kernels' (query, chunk) split: one
               id repeated across every chunk, a chunk of only invalid ids,
               ties at the k-th score straddling chunk boundaries, C not a
               multiple of the chunk, k = C, k = 6,400 (the large-k path,
               over three chunks and within one), and a LIDER-like
               candidate layout at full width (bit-equal on int8, int4 and
               sketch tables). Then a small quantized index: a covering
               ``sketch_factor`` and the cluster-major schedule give the
               unfiltered search, bit for bit. Then the build kernels:
               ``lsh_hash`` (N off the 64-row block and on both sides of the
               layouts' switch, d in {8, 33, 768, 770}, H=1, M in {1, 10, 16,
               31}; bfloat16 rows, which must hash exactly as their float32
               widening) and ``kmeans_assign`` (N, c and d off its tiles,
               rows off a 16-byte boundary, duplicate centroids in one tile
               and across tiles) within float32
               rounding of their plain versions, k-means distances within
               16 times the plain version's error against float64 (a TF32
               product, run to show the check can fail, must exceed it),
               duplicate-centroid ties exact, and each row's key and
               assignment the same alone, in a large batch and at another
               offset. Then the baselines' shapes: ``lsh_hash`` at H = 24
               arrays of M = 20 bits, ``kmeans_assign`` on a d = 96 column
               slice against c = 256 and at c = 1,024, d = 768.
4. main      — the ``lider-msmarco`` configuration at the reference's size
               (8,847,360 x 768 synthetic corpus, float32 bank, capacity
               None: Lp from the largest cluster, ``REDUCED``): the corpus,
               the queries and Flat's exact top-100. ``build_lider``
               through both build kernels, three times. The first build of
               the process is the main path's (its launches counted, its
               stages timed, run under ``cProfile``; its first call of each
               kernel role kept, then held against its plain version and
               timed at full size as the shapes phase does, while only the
               corpus is on the card); it is freed but for its k-means
               result. A second build times every build-kernel call on its
               own, beside its plain version and the cuBLAS product. A
               third, warm build is searched; its k-means centroids and
               assignments must equal the first's, bit for bit (the Lloyd
               sums add each cluster's rows in one fixed order); then the
               Lloyd sums at full size, timed beside ``index_add_``. Then 4
               batches of 256 queries through ``search_lider`` at k=100,
               recall@100 against Flat, the first 8 queries against the
               same search with every kernel swapped for its plain version
               (query keys compared first), launches per batch (2
               ``fused_verify``, 2 ``lsh_hash``), and a ``torch.profiler``
               trace of one more batch. Last the corpus goes to host
               memory: the later phases at this size build from it. Every
               phase at this size prints its peak device memory beside
               PERF.md's prediction (``PREDICTED_PEAK_GB``), its index's
               bytes and the corpus's.
5. shapes    — each kernel call of the main path (the build's and one
               search batch's), on the arguments it was given, held against
               the plain version over the whole call and timed with CUDA
               events beside its bound and its kernels' device time (and,
               for the build kernels, beside the cuBLAS product alone and
               the float32 bound; a hash call also with the bits a cuBLAS
               TF32 product puts outside the rounding bound; for
               ``fused_verify`` and ``sketch_prefilter``, beside the
               per-query floor: the distinct (query, row) pairs read once
               each, and for a
               multi-chunk call its chunks alone, without the final
               merges; for ``fused_verify_grouped``, beside the per-step
               floor: each real step's live rows and ids read once). Then
               the in-cluster shape on traffic without repeated rows
               (float32, int8, sketch), timed the same way. Then the
               reference's ``serve_bulk`` shape: one batch of 8,192 queries
               through ``search_lider``, captured (a first run, the
               capture, replays), whose ids must equal the same queries' in
               batches of 256 (scores bit for bit, else within rtol 1e-5;
               the line says which), timed, with its peak and its graph's
               pool, and each of its kernel calls timed as above.
6. quantized — the float index is freed, then the int8 and the int4 index
               are built in turn from the corpus in host memory (each
               rescore table and its gids == the float index's, by a
               checksum of its words), and 4 x 256 queries run on
               each quantized operating point (Q8, Q8-cm on int8; Q4-sk,
               Q4-sk-cm on int4): recall@100, each kernel's launches per
               batch, Q8-cm == Q8 and Q4-sk-cm == Q4-sk bit for bit, the
               first 8 queries against the all-plain search, the schedule's
               sharing, the shapes phase on each path's kernel calls, and a
               trace of one Q8, one Q8-cm and one Q4-sk-cm batch. Then the
               shapes the kernels once refused, at full width: Q8-cm at
               block_q 32, and Q8 and Q8-cm at k' = 1,100, == the per-query
               search bit for bit; the covering sketch factor (m = C =
               80,000) == the unfiltered Q4 search bit for bit; each of
               their grouped and sketch calls timed; on int8, Q8 at the
               ``serve_bulk`` shape as in the shapes phase.
7. serve     — the int8 and int4 indexes again, one at a time, built on the
               host rescore tier (``configs.lider_msmarco.HOST_TIER``) from
               the corpus in host memory, so the build never holds the
               float32 table on the card, and copied to the device tier and
               back (the device memory the host tier frees must equal the
               table): Q8, Q8-cm, Q4-sk and Q4-sk-cm over 4 x 256 queries ==
               the device tier, ids and scores bit for bit, with the device
               tier's launches per batch; on int8 the captured host-tier Q8
               batch (7b) and the rescore over fetched rows timed as a
               ``fused_verify`` call, its launches counted around one
               ``host_rescore``. The paths below keep the 1,048,576-row
               corpus (``SMALL_N``, their earlier size; each prints its cut with
               the seconds and bytes that force it): one host-tier Q8 batch
               of the int8 index built on that corpus split into its stages
               (first pass, rows to the host, the gather by
               ``torch.index_select`` and by numpy ``take``, bit-equal, H2D
               from pinned and pageable memory, rescore). Then
               ``RetrievalEngine`` (``configs.lider_msmarco.SERVING``): a
               closed loop of 16 x 256 queries on host-tier
               Q8 (every answer == ``search_lider`` on its batch, bit for
               bit; some gather began while the device still ran the
               next batch's first pass, read from that pass's CUDA event;
               AQT, batch and request p50 /
               p99, fetch ms, gather and H2D GB/s), the same on host-tier
               Q8-cm and on device-tier Q8; an open loop of 2,048 Zipf
               arrivals at half the closed loop's queries/s (answers ==
               ``search_lider``, latency p50 / p99); an index over 99% of
               the corpus on the host tier taking an upsert of the other 1%
               in ``apply_updates`` (no growth, ``recompiles`` 0, the host
               generation bumped, 4 batches after it == a device-tier copy
               given the same upsert); a failed host fetch retried (answers
               unchanged) and exhausted retries (answers ==
               ``compressed_only_topk``, degraded); a host-tier checkpoint
               at full width loaded on both tiers (every leaf and the
               search identical).
7b. graphs   — the compiled query path (``core.graphs``: the seven
               ``jax.jit`` entries of the reference as CUDA graphs), at the
               end of the main, quantized and serve phases: F32, Q8, Q8-cm,
               Q4-sk, Q4-sk-cm (the cm points on the engine's padded
               schedule) and host-tier Q8 over 16 x 256 queries, captured
               against each entry's ``__wrapped__`` body in turns (plain,
               captured, captured, plain): ids and scores bit for bit,
               launches per batch the same, the signature counter
               (``query_path_cache_size``) flat; batch medians both ways, a
               profiled batch of each for the device's busy share, the
               bytes the graphs' pools hold. The serve phase's engines print
               their graphs' bytes, and the update under serving the time to
               capture the warmed graphs again on the new leaves (captured
               == uncaptured after it). One line sums the phase up.
               ``recording`` and ``all_plain`` run the entries uncaptured.
8. fabric    — a ``QueryRouter`` over two replicas of the serve phase's
               host-tier int8 index (replica 1 a ``clone_params``: device
               leaves shared, host store copied), each engine on its own
               stream: 16 x 256 queries == one engine == ``search_lider``
               bit for bit, with the launches of 16 batches counted across
               the pool threads; router and one engine's queries/s,
               request p50 / p99 and availability side by side; a
               ``replica_kill`` mid-trace, a straggler hedged at the 0.95
               quantile, and a rolling 1% upsert under traffic (every
               answer == a fresh search at its generation).
9. cli       — ``repro_torch.launch.serve.main`` in this process at d = 768,
               N = 1,048,576, 4,096 queries, k = 100: LIDER int8 on the
               host tier through two replicas with a rolling upsert and an
               autotuned point, LIDER int4 with the sketch pass and the
               cluster-major schedule, then Flat, PQ, IVF-PQ, SK-LSH and
               MP-LSH. Every query answered, recall@100 over the floor
               (Flat 1.0), launches counted (exact for the baselines); the
               baselines' ``lsh_hash`` and ``kmeans_assign`` calls held
               against their plain versions and timed beside their bounds;
               IVF-PQ's two k-means, Lloyd step by Lloyd step, by stage.
10. lifecycle — ``configs.lider_msmarco.LIFECYCLE`` at full width on the
               1,048,576-row corpus, its float32 build's centroids frozen and the capacity fixed from the full
               assignment: build on 80%, upsert 20% in 4 batches, equal bit
               for bit to a rebuild over 100% (bank and search ids); delete
               5% with eager compaction, equal to a rebuild over the
               survivors, deleted ids never surfacing; ``save_index`` then
               ``load_index``, every leaf and the search ids identical;
               small int8 and int4 indexes through upsert == rebuild.
10b. examples — ``examples/quickstart_torch.py``,
               ``serve_retrieval_torch.py`` and ``chaos_demo_torch.py`` at
               their default sizes on the card, in process: recall over the
               floor; every arrival answered on every backend; the rollback
               bit-identical, the outage degraded and recovered.
11. distributed — the distributed index (``core.distributed``) at full
               width on the 1,048,576-row corpus: float32, int8 and int4 indexes built in this process,
               four gloo ranks spawned on the card as a (data=2, model=2)
               grid, each taking its clusters' shard of every index from
               this process's tensors through CUDA IPC (every leaf
               ``torch.equal`` to its slice). Over 4 x 256 queries on F32,
               Q8, Q8-cm, host-tier Q8, Q4-sk and Q4-sk-cm: launches per
               rank a batch, the drop count == the host's count from the
               routed ids; F32 ids == ``search_lider``'s; host-tier Q8
               scores == ``search_lider``'s bit for bit, ids up to swaps of
               exactly tied scores (stage 1 == ``host_first_pass`` bit for
               bit); the other quantized points == the single-device
               per-pair answer (scores rtol 1e-5), cm == per-query bit for
               bit; each rank's verification calls on one batch against
               their plain versions, rank 0's timed beside their bounds.
               F32 at capacity factor 0.5 drops (== the host's count), ids
               well formed. F32 on a (4, 1) grid == ``search_lider``, with a
               dead shard (none of its passages served, every live answer
               kept) and a ``kill_shard`` fault (== the mask bit for bit,
               3 of 4 shards live); the sharded Lloyd step over 4 data
               ranks == ``kmeans_step`` (atol 1e-5). Then a one-rank NCCL
               world: the F32 search and the Lloyd step. Times are the
               world's, barrier to barrier: four ranks time-share the card,
               so they are not scaling numbers.
11b. models_sharded — the models' half of the distributed path: four
               gloo ranks on the card as a (data=2, model=2) grid, each
               item against this process's single-rank run from the same
               weights (TF32 off). (a) qwen2.5-3b's widths at 4 of its 36
               layers, float32, seq 1,024, global batch 8, 3 AdamW steps
               with FSDP over data and TP over model: step 1's loss and
               grad norm rtol 1e-5, then 1e-3; every rank's blocks under
               the AdamW rule; its parameter and moment bytes its spec's
               share. (b) Its decode on pure-TP weights: prefill 512 at
               batch 4, 32 steps (batch over data, sequence over model),
               then batch 1 for 8 steps (sequence over all four ranks):
               logits within 1e-4 of the largest, argmax equal. (c)
               two-tower at its published widths, tables over model, batch
               16,384 over data, 10 steps: the sharded lookup == F.embedding
               bit for bit and its table gradient atol 1e-5; losses rtol
               1e-5 then 1e-3; every item encoded by the sharded model,
               LIDER built alike on each rank, 512 users searched by the
               sharded search (launches per rank, == ``search_lider``,
               recall >= 0.4 of IVF-Flat's). (d) One LM step in a one-rank
               NCCL world. Step walls barrier to barrier, collective
               seconds device sync to device sync, peak memory per rank
               and model FLOP/s (``launch.flops``): four ranks share one
               card, so these are not scaling numbers.
12. train    — the training path. (a) The loss and every gradient of
               ``reduced_lm`` of qwen2.5-3b and of llama4-scout-17b-a16e
               (MoE, local windows firing) on the card == the same step on
               the CPU (float32, TF32 off; ``testing.card_against_cpu``).
               (b) qwen2.5-3b at its published widths through
               ``repro_torch.launch.train.main`` (batch 1 x 512, 4 steps):
               step ms, tokens/s, model FLOP/s against the bf16 peak, peak
               device memory beside the reckoning (16 B a parameter); loss
               and grad norm finite. (c) ``examples/train_encoder_e2e_torch``
               at its 100m preset: 300 steps at batch 64 x 32 uninterrupted
               (a checkpoint at step 150), and a run under
               ``run_with_restarts`` that starts from that checkpoint, is
               preempted at step 150 and restarts (checkpoints every 50);
               the final weights and the losses of steps 150-299 equal bit
               for bit under deterministic algorithms (without their NaN
               fill of new memory); the loss falls to half;
               262,144 passages and their queries encoded,
               LIDER built through ``kmeans_assign`` and ``lsh_hash``
               (launches as the code predicts), searched at k=10 in batches
               of 4,096 through ``fused_verify`` (launches per batch),
               recall@10 against Flat over its floor, MRR of the true
               passage, the first 8 queries == the all-plain search, and
               each recorded kernel call held against its plain version and
               timed.
13. models   — the recsys and GNN families and LM serving. (a) The loss
               and every gradient of the reduced gatedgcn, sasrec,
               two-tower-retrieval, din and xdeepfm configs on the card ==
               the CPU (``testing.card_against_cpu``), and the prefill and
               decode logits of the reduced qwen2.5-3b and llama4-scout ==
               the CPU (``testing.serve_card_against_cpu``). (d) qwen2.5-3b
               at full width (the train phase's model), batch 8: a prompt
               of 512, 32 decode steps from the KV cache, each step's logits
               against the teacher-forced forward (argmax at >= 99% of the
               positions, the largest difference <= 2e-2 of the largest
               logit); prefill ms, decode ms a step, tokens/s, peak memory.
               (b) two-tower-retrieval at its published widths: 50 steps of
               ``launch.train``'s ``build_task`` and ``train_loop`` at batch
               16,384 (cut from 65,536), all 2,097,152 items encoded, LIDER
               (``lider-msmarco``'s settings, c = 2,048, float32) built
               through ``kmeans_assign`` and ``lsh_hash`` (launches as the
               code predicts; ``LiderConfig.capacity`` set, and reported,
               only if the bank would pass 40 GB), 4,096 users searched in
               batches of 512 at k = 100 through ``fused_verify`` (launches
               per batch), ``two_tower_score_candidates`` == ``flat_search``,
               recall@100 of LIDER against that exact top-100 over the
               floor, the first 64 users == the all-plain search, each
               recorded kernel call held against its plain version and
               timed. (c) gatedgcn at the ``minibatch_lg`` dims: a random
               graph of 232,965 nodes and 114,615,892 edges, 10 steps on
               blocks of 1,024 seeds at fanout (15, 10) (shapes checked,
               the first block's every edge found in the graph); ms a step,
               peak memory.
14. dryrun   — ``python -m repro_torch.launch.dryrun``'s single-pod sweep
               (39 ok, 4 skipped, bytes accessed counted in each), then
               three cells this run measured rebuilt by the dry run: their
               peaks, argument and collective bytes against the readings,
               and the same steps run again under the dry run's counters on
               the card's real tensors, FLOPs, bytes accessed and
               collectives equal to the fake run's (and, for the two LM
               cells, to the dry run on fake CPU tensors, whose backward
               runs on the calling thread), each beside its roofline time
               and the measured step; each kernel's shape-only output and
               reported (FLOPs, bytes) == its launch's at every distinct
               main-path shape, == the build kernels' count and >= the
               verification kernels' count of distinct valid rows.
15. kernels  — one JSON line with an entry per kernel (the build kernels'
               calls include the baselines', the encoder's and the
               two-tower's shapes, and the verification kernels' the
               encoder's, the two-tower's, the distributed ranks'
               per-pair and per-cell shapes, and the sharded two-tower
               search's).

The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import copy
import cProfile
import dataclasses
import gc
import json
import math
import os
import pstats
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path
from unittest import mock

import numpy as np

# cuBLAS's deterministic setting (the train phase turns on deterministic
# algorithms, which require it): 8 buffers of 4 MiB, PyTorch's default
# workspace on sm_90 anyway.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_OPS = {  # per second: f32 CUDA cores; tf32, bf16 and int8 tensor cores (dense)
    torch.float32: 67e12, "tf32": 495e12, torch.bfloat16: 989e12, torch.int8: 1979e12,
}
RECALL_FLOOR = 0.5  # only catches garbage
# Where no index of the configuration can reach RECALL_FLOOR, LIDER's recall
# at its n_probe must keep this share of IVF-Flat's over as many clusters
# (an exact scan of the clusters whose centroids score highest): the
# two-tower items (0.513 on an H100, PERF.md) and lider-msmarco at
# 8,847,360 passages, where the in-cluster window R = r0 * k covers 4.6% of
# a mean cluster of 8,640 rows, against 39% of 1,024 at 1,048,576. With
# routing out of the way the JAX package's own recall falls so with the
# cluster size, and the port's equals it (tests/test_torch_recall_scale.py).
LIDER_OF_IVF = 0.4
N_BATCHES, BATCH, SEED = 4, 256, 0
BULK = 8192  # queries a batch of the reference's serve_bulk shape (configs.lider_msmarco.ARCH)
# The corpus of the paths that keep their earlier size: at 8,847,360 rows
# their time, memory or disk would break the run (each prints its cut).
SMALL_N = 1_048_576
RUN_LIMIT_S = 1200
# Peak device memory of each phase at 8,847,360 x 768, Lp 12,776, in GB
# (1e9 bytes): PERF.md's prediction, from the byte counts of the tensors
# each phase holds at its peak.
PREDICTED_PEAK_GB = {
    "data": 54.54,  # the corpus, its noise, then its normalised copy
    "main": 74.09,  # first build: corpus + f32 table + two fit chunks (one recorded) + keys
    "shapes": 66.62,  # f32 index + a bfloat16 copy of its table + plain chunks
    "bulk F32": 66.58,  # f32 index + the 8,192-query graph (32 x 773.8 MB)
    "int8": 58.82,  # build: table + codes + sketches + a dequantized fit chunk + keys
    "bulk Q8": 77.93,  # int8 index + the 8,192-query graph
    "int4": 54.74,
    "serve int8": 57.15,  # the device-tier copy of the host-tier index + its graphs
    "serve int4": 51.96,
}
KERNELS = {  # wrapper -> (CUDA source, the TPU kernel it replaces)
    "fused_verify": ("src/repro_torch/kernels/csrc/fused_verify.cu",
                     "src/repro/kernels/fused_verify.py:82"),
    "sketch_prefilter": ("src/repro_torch/kernels/csrc/sketch_prefilter.cu",
                         "src/repro/kernels/fused_verify.py:346"),
    "fused_verify_grouped": ("src/repro_torch/kernels/csrc/fused_verify_grouped.cu",
                             "src/repro/kernels/fused_verify.py:541"),
    "lsh_hash": ("src/repro_torch/kernels/csrc/lsh_hash.cu",
                 "src/repro/kernels/lsh_hash.py:27"),
    "kmeans_assign": ("src/repro_torch/kernels/csrc/kmeans_assign.cu",
                      "src/repro/kernels/kmeans_assign.py:27"),
}
BUILD_KERNELS = ("lsh_hash", "kmeans_assign")
# Kernel calls per search batch, in KERNELS order: (fused_verify,
# sketch_prefilter, fused_verify_grouped, lsh_hash, kmeans_assign). Every
# search hashes its queries twice: the centroid model's keys in routing,
# then the bank's in candidate generation. A grouped call is counted as its
# two launches, its score kernel and then its select kernel; a hash call is
# ``lsh_hash.LAUNCHES_PER_CALL`` launches (:func:`per_batch`).
PER_BATCH = {
    "F32": (2, 0, 0, 2, 0),
    "Q8": (3, 0, 0, 2, 0), "Q8-cm": (2, 0, 2, 2, 0),
    "Q4-sk": (3, 1, 0, 2, 0), "Q4-sk-cm": (2, 1, 2, 2, 0),
}


def per_batch(point: str) -> tuple:
    """Launches per search batch of an operating point: ``PER_BATCH`` with
    each hash call counted as ``lsh_hash.LAUNCHES_PER_CALL`` launches."""
    from repro_torch.kernels.lsh_hash import LAUNCHES_PER_CALL

    fv, sk, gr, lsh, km = PER_BATCH[point]
    return (fv, sk, gr, lsh * LAUNCHES_PER_CALL, km)


def hash_launches(calls: int) -> int:
    from repro_torch.kernels.lsh_hash import LAUNCHES_PER_CALL

    return calls * LAUNCHES_PER_CALL


def per_build(cfg, *, kmeans: bool = True) -> tuple:
    """Launches of one ``build_lider``, from the code: k-means runs
    ``kmeans_iters`` Lloyd steps and one final assignment (one
    ``kmeans_assign`` call each, of ``LAUNCHES_PER_CALL`` launches: the
    centroid norms, then the assignment; a build with given centroids
    assigns once); the bank fit hashes ``bank._FIT_CHUNK`` clusters per
    ``lsh_hash`` call, and the centroid model hashes the centroids once
    (``lsh_hash.LAUNCHES_PER_CALL`` launches a call)."""
    from repro_torch.core import bank
    from repro_torch.kernels.kmeans_assign import LAUNCHES_PER_CALL

    n_fit = math.ceil(cfg.n_clusters / bank._FIT_CHUNK)
    return (0, 0, 0, hash_launches(n_fit + 1),
            LAUNCHES_PER_CALL * (cfg.kmeans_iters + 1 if kmeans else 1))


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def clock(done: str, t_start: float) -> None:
    log("time", f"{done} done at {time.perf_counter() - t_start:.1f} s of the run")


def cuda_ms(fn, reps: int) -> float:
    fn()  # warm
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_modules() -> dict:
    from repro_torch.kernels import fused_verify as fv, kmeans_assign as km, lsh_hash as lh

    return {"fused_verify": fv, "sketch_prefilter": fv, "fused_verify_grouped": fv,
            "lsh_hash": lh, "kmeans_assign": km}


def wrappers():
    return {name: getattr(mod, name) for name, mod in kernel_modules().items()}


def reset_counts() -> None:
    for fn in wrappers().values():
        fn.launches = 0


def read_counts() -> tuple[int, ...]:
    return tuple(fn.launches for fn in wrappers().values())


def fmt_counts(counts) -> str:
    return ", ".join(f"{n} {c}" for n, c in zip(KERNELS, counts))


def plain_fns():
    """The plain versions under the wrappers' signatures."""
    from repro_torch.kernels import ref

    def fused_verify(embs, row_ids, queries, *, k, out_ids=None, scales=None, code_dtype="int8"):
        return ref.verify_topk_ref(embs, row_ids, queries, k=k, out_ids=out_ids, scales=scales,
                                   code_dtype=code_dtype)

    def sketch_prefilter(sketches, row_ids, queries, *, k, out_ids=None):
        return ref.sketch_topk_ref(sketches, row_ids, queries, k=k, out_ids=out_ids)

    def fused_verify_grouped(embs, row_scales, queries, sched_cids, sched_qids, step_slot_ids,
                             *, kp, code_dtype="int8"):
        return ref.verify_topk_grouped_ref(embs, row_scales, queries, sched_cids, sched_qids,
                                           step_slot_ids, kp=kp, code_dtype=code_dtype)

    def lsh_hash(x, proj, *, n_arrays, key_len):
        return ref.lsh_hash_ref(x, proj, n_arrays=n_arrays, key_len=key_len)

    def kmeans_assign(x, centroids, chunk=65536):
        parts = [ref.kmeans_assign_ref(x[s : s + chunk], centroids)
                 for s in range(0, x.shape[0], chunk)]
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])

    return {"fused_verify": fused_verify, "sketch_prefilter": sketch_prefilter,
            "fused_verify_grouped": fused_verify_grouped, "lsh_hash": lsh_hash,
            "kmeans_assign": kmeans_assign}


def all_plain():
    """Patch every kernel wrapper with its plain version (ops looks them up
    on their modules at each call), and run the query path's entries as
    their plain bodies (a graph's replay would call no wrapper)."""
    from repro_torch.testing import uncaptured

    stack = contextlib.ExitStack()
    stack.enter_context(uncaptured())
    plain = plain_fns()
    for name, mod in kernel_modules().items():
        stack.enter_context(mock.patch.object(mod, name, plain[name]))
    return stack


def recording(calls: list, keep=None):
    """Patch ops' view of the wrappers so each kernel call is recorded,
    (name, args, kwargs) (only where ``keep(name, args, kwargs)``, when
    given), and then launched by the real wrapper (whose counter stays
    under its own name). The query path's entries run as their plain bodies
    meanwhile, so each call reaches ops (a graph's replay would not)."""
    from repro_torch.kernels import ops
    from repro_torch.testing import uncaptured

    real = wrappers()

    def rec(name):
        def f(*args, **kw):
            if keep is None or keep(name, args, kw):
                calls.append((name, args, kw))
            return real[name](*args, **kw)
        return f

    stack = contextlib.ExitStack()
    stack.enter_context(uncaptured())
    for attr, names in (("_fv", ("fused_verify", "sketch_prefilter", "fused_verify_grouped")),
                        ("_lsh", ("lsh_hash",)), ("_km", ("kmeans_assign",))):
        stack.enter_context(mock.patch.object(
            ops, attr, types.SimpleNamespace(**{n: rec(n) for n in names})))
    return stack


def against_plain(params, search, qs) -> str:
    """The queries through the search and through the same search with
    every kernel swapped for its plain version. The query keys are
    compared first: a key bit may differ only within float32 rounding of
    0, and every query whose keys agree must return the same ids (up to
    swaps of near-equal scores) and scores within rtol 1e-5."""
    from repro_torch.testing import assert_topk_match, query_key_flips, query_keys

    with all_plain():
        plain = search(qs)
        plain_keys = query_keys(params, qs)
    kern = search(qs)
    same, rep = query_key_flips(params, qs, query_keys(params, qs), plain_keys)
    same = same.to(kern.ids.device)
    swaps = assert_topk_match(kern.ids[same], kern.scores[same], plain.ids[same], plain.scores[same])
    return (f"keys equal on {int(same.sum())} of {qs.shape[0]} ({rep['flips']} of "
            f"{rep['bits']} key bits flipped, each within the rounding bound; {rep['near']} "
            f"near-ties); on those, ids == the all-plain search ({swaps} near-tie swaps admitted)")


def bit_equal(got, want) -> bool:
    return torch.equal(got[0], want[0]) and torch.equal(
        got[1].contiguous().view(torch.int32), want[1].contiguous().view(torch.int32)
    )


def compare(kernel_out, plain_out) -> tuple[float, int]:
    """Ids equal up to swaps of near-equal scores; returns (max |score
    error| over finite scores, swaps admitted)."""
    from repro_torch.testing import assert_topk_match

    gi, gs = kernel_out
    wi, ws = plain_out
    swaps = assert_topk_match(gi, gs, wi, ws)
    fin = torch.isfinite(ws)
    if not torch.equal(torch.isneginf(gs), torch.isneginf(ws)):
        raise AssertionError("padding slots differ between kernel and plain version")
    err = float((gs[fin] - ws[fin]).abs().max()) if bool(fin.any()) else 0.0
    return err, swaps


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log("device", f"{kind}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"count {torch.cuda.device_count()}")
    print(smi, flush=True)
    log("device", host_memory_line("at the start") + "; free disk: " + ", ".join(
        f"{where} {shutil.disk_usage(where).free / 1e9:.2f} GB" for where in (ROOT, tempfile.gettempdir())))
    if torch.backends.cuda.matmul.allow_tf32:
        raise SystemExit("chip_smoke: float32 matmuls must not run in TF32 here")
    return {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count(), "smi": smi}


def phase_build() -> float:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    libs = build.build_all()
    secs = time.perf_counter() - t0
    log("build", f"{len(libs)} kernel libraries built in {secs:.2f} s (one nvcc each, in "
        f"parallel): {', '.join(p.name for p in libs.values())}")
    for name in KERNELS:
        log("build", f"cuobjdump -res-usage {name}: {res_usage(libs[name])}")
    return secs


def res_usage(lib: Path) -> str:
    """Registers and stack frame of each kernel in a built library, from
    ``cuobjdump -res-usage`` (names demangled by ``c++filt`` where it is
    installed)."""
    from repro_torch.kernels import build

    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    if not tool.exists():
        return "not measured (no cuobjdump)"
    lines = subprocess.run([str(tool), "-res-usage", str(lib)], capture_output=True,
                           text=True).stdout.splitlines()
    rows = []
    for i, line in enumerate(lines[:-1]):
        if "Function " in line and "REG:" in lines[i + 1]:
            fn = line.split("Function ", 1)[1].rstrip(":").strip()
            use = dict(kv.split(":", 1) for kv in lines[i + 1].split() if ":" in kv)
            rows.append((fn, use.get("REG"), use.get("STACK")))
    if shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows), capture_output=True,
                               text=True).stdout.splitlines()
        rows = [(n.replace("(anonymous namespace)::", "").split("(")[0].removeprefix("void "), r, st)
                for n, (_, r, st) in zip(names, rows)]
    return "; ".join(f"{fn} {r} registers, stack {st} B" for fn, r, st in sorted(rows))


def _edge_case(g, dev, n, d, b, c, k):
    """Rows with exact ties and a zero row, candidates each twice, 30%
    invalid, dead leading tiles, an all-invalid row, k above the valid
    count."""
    from repro_torch.core.utils import l2_normalize

    embs = l2_normalize(torch.randn((n, d), generator=g, device=dev))
    if n > 13:
        embs[7] = embs[2]
        embs[13] = embs[2]
    embs[n // 2] = 0
    rows = torch.randint(0, n, (b, c), generator=g, device=dev, dtype=torch.int32)
    rows[:, c // 2 :] = rows[:, : c - c // 2]
    out = rows.clone()
    out[torch.rand((b, c), generator=g, device=dev) < 0.3] = -1
    if c > 1024:
        out[:, :512] = -1
    out[-1] = -1
    if k >= c:
        out[0, 3:] = -1
    q = l2_normalize(torch.randn((b, d), generator=g, device=dev))
    return embs, rows, out, q


def phase_parity(dev) -> float:
    from repro_torch.kernels import quant, ref
    from repro_torch.kernels.fused_verify import fused_verify, fused_verify_grouped, sketch_prefilter
    from repro_torch.kernels.schedule import build_cluster_schedule

    g = torch.Generator(device=dev).manual_seed(SEED)
    worst = 0.0
    cases = [  # (n, d, b, c, k)
        (40, 32, 3, 17, 5), (25, 16, 2, 12, 6), (200, 64, 4, 700, 10),
        (1000, 20, 5, 300, 7), (100, 768, 3, 1000, 300), (30, 16, 2, 6, 9),
        (5000, 768, 4, 4000, 100), (20000, 768, 3, 6000, 400),
    ]
    n_bit = 0
    for n, d, b, c, k in cases:
        embs, rows, out, q = _edge_case(g, dev, n, d, b, c, k)
        for dtype in (torch.float32, torch.bfloat16):
            t = embs.to(dtype)
            got = fused_verify(t, rows, q, k=k, out_ids=out)
            torch.cuda.synchronize()
            err, _ = compare(got, ref.verify_topk_ref(t, rows, q, k=k, out_ids=out))
            if not bool((got[0][-1] == -1).all()):
                raise AssertionError("all-invalid row returned ids")
            worst = max(worst, err)
        for code in ("int8", "int4"):
            if code == "int4" and d % 2:
                continue
            codes, scales = (quant.quantize_rows if code == "int8" else quant.quantize_rows_int4)(embs)
            kw = dict(k=k, out_ids=out, scales=scales, code_dtype=code)
            got = fused_verify(codes, rows, q, **kw)
            torch.cuda.synchronize()
            if not bit_equal(got, ref.verify_topk_ref(codes, rows, q, **kw)):
                raise AssertionError(f"fused_verify {code} differs from its plain version at "
                                     f"{(n, d, b, c, k)}")
            n_bit += 1
        sk = quant.sketch_rows(embs)
        for kk in (k, min(4 * k, 1600)):
            got = sketch_prefilter(sk, rows, q, k=kk, out_ids=out)
            torch.cuda.synchronize()
            if not bit_equal(got, ref.sketch_topk_ref(sk, rows, q, k=kk, out_ids=out)):
                raise AssertionError(f"sketch_prefilter differs from its plain version at "
                                     f"{(n, d, b, c, kk)}")
            n_bit += 1
    log("parity", f"fused_verify float32 + bfloat16 x {len(cases)} shapes: ids equal, max "
        f"|score err| {worst:.3g} (unit-norm rows; rtol 1e-5 / atol 1e-6); fused_verify "
        f"int8 + int4 and sketch_prefilter (k up to 1600): {n_bit} cases bit-equal (ids and "
        "scores) to the plain version")

    n_g = 0
    for c, lp, d, b, p, block_q, kp, pairs in GROUPED_CASES:
        x = torch.randn((c, lp, d), generator=g, device=dev)
        x[0, 3] = 0
        x[1, 5] = x[1, 2]
        if pairs:
            x[:, 1::2] = x[:, 0::2]
        w = torch.arange(1, c + 1, device=dev, dtype=torch.float32) ** -1.3
        cids = torch.stack([torch.multinomial(w, p, generator=g) for _ in range(b)]).int().cpu().numpy()
        n_steps = build_cluster_schedule(cids, block_q=block_q).n_steps
        sched = build_cluster_schedule(cids, block_q=block_q, pad_to=n_steps + 3)
        sc_, sq_ = (torch.from_numpy(a).to(dev) for a in (sched.sched_cids, sched.sched_qids))
        slot = torch.where((sq_ >= 0)[:, :, None], sc_[:, None, None] * lp
                           + torch.arange(lp, device=dev, dtype=torch.int32), -1)
        slot[torch.rand(slot.shape, generator=g, device=dev) < 0.4] = -1
        slot[:, :, : min(lp, 40)] = -1  # a dead leading tile
        if lp > 5:  # rows 2 and 5 of cluster 1 are bit-equal: one id on both
            slot[sc_ == 1, :, 5] = slot[sc_ == 1, :, 2]
        if pairs:  # every id on two bit-equal rows
            slot[:, :, 1::2] = slot[:, :, 0::2]
        slot = slot.to(torch.int32).contiguous()
        q = torch.randn((b, d), generator=g, device=dev)
        for code in ("int8", "int4") if d % 2 == 0 else ("int8",):
            codes, scales = (quant.quantize_rows if code == "int8" else quant.quantize_rows_int4)(x)
            args = (codes.contiguous(), scales, q, sc_, sq_, slot)
            got = fused_verify_grouped(*args, kp=kp, code_dtype=code)
            torch.cuda.synchronize()
            want = plain_chunked("fused_verify_grouped", args, {"kp": kp, "code_dtype": code}, 64)
            if not bit_equal(got, want):
                raise AssertionError(f"fused_verify_grouped {code} differs from its plain version "
                                     f"at {(c, lp, d, b, p, block_q, kp)}")
            n_g += 1
    log("parity", f"fused_verify_grouped int8 + int4: {n_g} schedules (padding steps, empty "
        "slots, sparse masks, dead tiles, an id on two bit-equal rows or every id on two; "
        "(block_q, k') in " + ", ".join(f"({bq}, {kp})" for *_, bq, kp, _ in GROUPED_CASES)
        + ") bit-equal to the plain version")
    worst = max(worst, phase_parity_chunks(dev))
    phase_parity_search(dev)
    return max(worst, phase_parity_build(dev))


GROUPED_CASES = [  # (c, Lp, d, B, probes, block_q, k', every id on two rows)
    (6, 16, 32, 5, 3, 4, 6, False), (8, 200, 64, 12, 4, 8, 40, False),
    (5, 120, 48, 9, 3, 3, 150, False), (4, 1500, 64, 6, 2, 8, 10, False),
    (64, 2584, 768, 96, 6, 8, 400, False), (24, 2584, 768, 32, 4, 8, 1100, False),
    (24, 2584, 768, 96, 4, 24, 400, False), (24, 2584, 768, 128, 4, 32, 2048, False),
    (4, 12288, 64, 16, 2, 32, 12288, False), (24, 2584, 768, 32, 4, 8, 400, True),
    (5, 118, 33, 9, 3, 3, 150, False),  # rows of 33 bytes, Lp off a multiple of 4 (int8 only)
    (4, 256, 4096, 40, 2, 32, 100, False),  # wide rows: int8 24 slots a block, 4 ring stages
]


def _chunk_case(g, dev, kind: str, n: int, b: int, c: int):
    """Unit-norm rows (d=768) and candidates that reach the (query, chunk)
    split of ``fused_verify`` and ``sketch_prefilter``."""
    from repro_torch.core.utils import l2_normalize
    from repro_torch.kernels.fused_verify import split_candidates

    embs = l2_normalize(torch.randn((n, 768), generator=g, device=dev))
    rows = torch.randint(0, n, (b, c), generator=g, device=dev, dtype=torch.int32)
    out = rows.clone()
    _, chunk = split_candidates(c)
    if kind == "one id in every chunk":
        rows[:, ::97] = 5
        out = rows.clone()
    elif kind == "a chunk of only invalid ids":
        out[:, chunk : 2 * chunk] = -1
    elif kind == "ties at the k-th score across chunks":
        embs = embs[torch.arange(n, device=dev) % 300]  # ~n/300 ids share each score
    elif kind == "LIDER-like windows":  # 10 windows of 400 over each probed cluster
        lp, size = 2584, 1024
        cid = torch.randint(0, n // lp, (b, c // 4000), generator=g, device=dev)
        pos = torch.randint(0, size, (b, c), generator=g, device=dev)
        rows = (cid.repeat_interleave(4000, dim=1) * lp + pos).to(torch.int32)
        out = rows.clone()
        out[torch.rand((b, c), generator=g, device=dev) < 0.05] = -1
    q = l2_normalize(torch.randn((b, 768), generator=g, device=dev))
    return embs, rows.contiguous(), out.contiguous(), q


CHUNK_CASES = [  # (kind, n, b, c, k); the chunks are split_candidates(c)
    ("one id in every chunk", 20_000, 3, 12_000, 100),
    ("a chunk of only invalid ids", 20_000, 3, 12_000, 400),
    ("ties at the k-th score across chunks", 20_000, 3, 9_001, 100),
    ("C not a multiple of the chunk", 20_000, 3, 80_003, 400),
    ("k = C", 20_000, 3, 4_096, 4_096),
    ("k = C", 20_000, 3, 3_000, 3_000),
    ("k above a chunk's distinct rows", 3_000, 3, 9_000, 4_096),
    ("k above the shared-memory list", 20_000, 3, 12_000, 6_400),
    ("k above C, one chunk", 20_000, 3, 3_000, 6_400),
    ("LIDER-like windows", 1_048_576, 8, 80_000, 400),
]


def phase_parity_chunks(dev) -> float:
    """The per-query kernels' (query, chunk) split against the plain
    versions: quantized and sketch tables bit-equal, float32 ids equal."""
    from repro_torch.kernels import quant, ref
    from repro_torch.kernels.fused_verify import fused_verify, sketch_prefilter, split_candidates

    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    worst, n_bit = 0.0, 0
    for kind, n, b, c, k in CHUNK_CASES:
        embs, rows, out, q = _chunk_case(g, dev, kind, n, b, c)
        got = fused_verify(embs, rows, q, k=k, out_ids=out)
        torch.cuda.synchronize()
        worst = max(worst, compare(got, ref.verify_topk_ref(embs, rows, q, k=k, out_ids=out))[0])
        for code in ("int8", "int4"):
            codes, scales = (quant.quantize_rows if code == "int8" else quant.quantize_rows_int4)(embs)
            kw = dict(k=k, out_ids=out, scales=scales, code_dtype=code)
            got = fused_verify(codes, rows, q, **kw)
            torch.cuda.synchronize()
            if not bit_equal(got, ref.verify_topk_ref(codes, rows, q, **kw)):
                raise AssertionError(f"fused_verify {code} differs from its plain version: {kind}")
            n_bit += 1
        sk = quant.sketch_rows(embs)
        got = sketch_prefilter(sk, rows, q, k=k, out_ids=out)
        torch.cuda.synchronize()
        if not bit_equal(got, ref.sketch_topk_ref(sk, rows, q, k=k, out_ids=out)):
            raise AssertionError(f"sketch_prefilter differs from its plain version: {kind}")
        n_bit += 1
        del embs, rows, out, q
    log("parity", f"(query, chunk) split: {len(CHUNK_CASES)} cases ("
        + "; ".join(f"{kind} C={c} k={k} in {split_candidates(c)[0]} chunks"
                    for kind, _, _, c, k in CHUNK_CASES)
        + f"): int8, int4 and sketch {n_bit} calls bit-equal to the plain version, float32 ids "
        f"equal (max |score err| {worst:.3g})")
    return worst


def phase_parity_search(dev) -> None:
    """A small quantized index on the card: a sketch factor covering every
    candidate, and the cluster-major schedule, give the unfiltered search
    bit for bit. The quantized phase checks the covering factor again at
    full width (m = C = 80,000)."""
    from repro_torch.core import lider
    from repro_torch.data import synthetic

    x = synthetic.retrieval_corpus(SEED + 5, 20_000, 768, device=dev)
    q, _ = synthetic.retrieval_queries(SEED + 6, x, 64)
    for sd in ("int8", "int4"):
        p = lider.build_lider(SEED, x, lider.LiderConfig(n_clusters=64, n_probe=4, storage_dtype=sd),
                              device=dev)
        kw = dict(k=10, n_probe=4, r0=4)  # C = 4 * 10 * 40 = 1600 candidates, k' = 40
        base = lider.search_lider(p, q, **kw)
        for extra in ({"sketch_factor": 40}, {"block_q": 8}, {"sketch_factor": 40, "block_q": 8}):
            got = lider.search_lider(p, q, **kw, **extra)
            if not bit_equal((got.ids, got.scores), (base.ids, base.scores)):
                raise AssertionError(f"{sd} search with {extra} differs from the unfiltered search")
        with all_plain():
            plain = lider.search_lider(p, q, **kw, sketch_factor=2, block_q=8)
        kern = lider.search_lider(p, q, **kw, sketch_factor=2, block_q=8)
        compare((kern.ids, kern.scores), (plain.ids, plain.scores))
        del p
    log("parity", "small int8 and int4 indexes (20,000 x 768, c=64): covering sketch_factor "
        "(40 x k' = every candidate), block_q=8 and both == the unfiltered search, bit for bit; "
        "sketch_factor=2 + block_q=8 equal to the all-plain search")


LSH_CASES = [  # (n, d, H, M, row dtype): N off the 64-row block and on both sides of the
    # layouts' switch at 16,384 rows, d off the 32-deep stage and 16-byte rows, H=1, M in {1, 16, 31}
    (1, 8, 1, 1, torch.float32), (37, 33, 3, 31, torch.float32), (1000, 768, 10, 16, torch.float32),
    (4099, 768, 10, 16, torch.bfloat16), (513, 33, 1, 16, torch.bfloat16),
    (300, 768, 10, 10, torch.float32), (2000, 8, 7, 31, torch.float32), (65, 768, 1, 1, torch.bfloat16),
    (256, 768, 10, 16, torch.float32), (129, 768, 3, 31, torch.float32),
    (17000, 768, 10, 10, torch.float32), (20000, 770, 16, 16, torch.bfloat16),
    # a block group's columns starting off 16 bytes (its box of P starts before them):
    # serve_retrieval's SK-LSH corpus hash, and H*M = 15 x 15 in bfloat16
    (30000, 64, 24, 15, torch.float32), (1000, 32, 15, 15, torch.bfloat16),
]
KMEANS_CASES = [  # (n, c, d, offset): N, c and d off every tile and stage; rows 4 bytes off 16
    (1, 1, 8, 0), (257, 7, 33, 0), (1000, 70, 768, 0), (4099, 1, 768, 0), (129, 70, 8, 0),
    (3001, 7, 768, 0), (127, 129, 770, 0), (4099, 1024, 768, 1), (129, 130, 33, 1),
]


def phase_parity_build(dev) -> float:
    """``lsh_hash`` and ``kmeans_assign`` against their plain versions: a
    key bit or an assignment may differ only within float32 rounding of
    the decision (the two sum in other orders); duplicate centroids resolve
    to the first index; each row's result is the same wherever it sits."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.kmeans_assign import kmeans_assign
    from repro_torch.kernels.lsh_hash import lsh_hash
    from repro_torch.testing import assignment_flips, lsh_key_flips

    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    tot = {"bits": 0, "flips": 0, "near": 0}
    for n, d, h, m, dtype in LSH_CASES:
        x = torch.randn((n, d), generator=g, device=dev).to(dtype)
        p = torch.randn((d, h * m), generator=g, device=dev)
        got = lsh_hash(x, p, n_arrays=h, key_len=m)
        torch.cuda.synchronize()
        if got.shape != (n, h) or not bool((got >= 0).all()) or not bool((got < 2**m).all()):
            raise AssertionError(f"lsh_hash keys out of range at {(n, d, h, m)}")
        r = lsh_key_flips(x, p, h, m, got, ref.lsh_hash_ref(x, p, n_arrays=h, key_len=m))
        tot = {k: tot[k] + r[k] for k in tot}
        if dtype == torch.bfloat16 and not torch.equal(lsh_hash(x.float(), p, n_arrays=h, key_len=m), got):
            raise AssertionError(f"bfloat16 rows hash unlike their float32 widening at {(n, d, h, m)}")
    log("parity", f"lsh_hash x {len(LSH_CASES)} cases (float32 + bfloat16 rows): {tot['flips']} of "
        f"{tot['bits']} key bits differ from the plain version ({tot['flips'] / tot['bits'] * 1e6:.2f} "
        f"per million), each within the rounding bound; {tot['near']} bits are near-ties "
        f"({tot['near'] / tot['bits'] * 1e6:.2f} per million); bfloat16 rows hash exactly as their "
        "float32 widening")

    rows = differ = 0
    worst = 0.0
    errs = {"kernel": 0.0, "plain": 0.0, "tf32": 0.0}
    for n, c, d, offset in KMEANS_CASES:
        x = torch.randn((n * d + 4,), generator=g, device=dev)[offset : offset + n * d].view(n, d)
        cen = torch.randn((c, d), generator=g, device=dev)
        dup = c >= 7
        if dup:  # centroids 5, 6 and the last copy 2; row 0 sits on them, row 1 next to them
            cen[5] = cen[2]
            cen[6] = cen[2]
            cen[c - 1] = cen[2]
            x[0] = cen[2]
            x[1] = cen[2] + 1e-3 * torch.randn((d,), generator=g, device=dev)
        got_a, got_d = kmeans_assign(x, cen)
        torch.cuda.synchronize()
        want_a, want_d = plain_fns()["kmeans_assign"](x, cen)
        r = assignment_flips(x, cen, got_a, want_a)
        rows, differ = rows + r["rows"], differ + r["differ"]
        e = min_dist_errors(x, cen, (got_a, got_d), (want_a, want_d))
        errs = {k: max(errs[k], e[k]) for k in errs}
        rest = slice(2, None) if dup else slice(None)
        torch.testing.assert_close(got_d[rest], want_d[rest], rtol=1e-4, atol=1e-4)
        worst = max(worst, float((got_d[rest] - want_d[rest]).abs().max()) if n > 2 else 0.0)
        if dup:
            if got_a[:2].tolist() != [2, 2] or bool(((got_a == 5) | (got_a == 6) | (got_a == c - 1)).any()):
                raise AssertionError("duplicate centroids did not resolve to the first index")
            bnd = d * 2.0**-24 * 4 * float((x[0].double() ** 2).sum())
            if abs(float(got_d[0])) > bnd:  # a distance of 0 computed by cancellation
                raise AssertionError(f"row on a centroid at distance {float(got_d[0])}, bound {bnd}")
    log("parity", f"kmeans_assign x {len(KMEANS_CASES)} cases: {differ} of {rows} assignments "
        f"differ from the plain version ({differ / rows * 1e6:.2f} per million), each a near-tie "
        f"within the rounding bound; min distances allclose (rtol = atol = 1e-4, max |err| "
        f"{worst:.3g}); {hold_min_dist(errs, 'parity')}; duplicate centroids resolve to the first "
        "index")

    x = torch.randn((20000, 768), generator=g, device=dev)
    p = torch.randn((768, 160), generator=g, device=dev)
    cen = torch.randn((1024, 768), generator=g, device=dev)
    keys = lsh_hash(x, p, n_arrays=10, key_len=16)
    a, dd = kmeans_assign(x, cen)
    for s, e in ((0, 1), (12345, 12346), (19999, 20000), (3, 4100), (7000, 20000)):
        sk = lsh_hash(x[s:e].contiguous(), p, n_arrays=10, key_len=16)
        sa, sd = kmeans_assign(x[s:e].contiguous(), cen)
        if not (torch.equal(sk, keys[s:e]) and torch.equal(sa, a[s:e])
                and torch.equal(sd.view(torch.int32), dd[s:e].view(torch.int32))):
            raise AssertionError(f"rows {s}:{e} hash or assign differently from the same rows in a batch")
    log("parity", "row determinism: rows of a 20,000 x 768 batch hashed and assigned alone, at "
        "other offsets and in sub-batches: keys, assignments and distances identical bit for bit")
    return max(worst, phase_parity_baselines(g, x))


def phase_parity_baselines(g, x) -> float:
    """The build kernels at the baselines' shapes, against their plain
    versions with the rounding-bound checks: ``lsh_hash`` at the SK-LSH and
    MP-LSH banks (H = 24 arrays of M = 20 bits, ``suggest_key_len`` at 1M
    rows), ``kmeans_assign`` at PQ's sub-spaces (a d = 96 column slice of the
    768-d rows, c = 256, through ``kmeans_assign_op`` as ``pq._encode``
    calls it) and at IVF-PQ's coarse lists (c = 1,024 = sqrt(N) at 1M)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.lsh_hash import lsh_hash
    from repro_torch.kernels.ops import kmeans_assign_op
    from repro_torch.testing import assignment_flips, lsh_key_flips

    dev = x.device
    p = torch.randn((x.shape[1], 24 * 20), generator=g, device=dev)
    keys = lsh_hash(x, p, n_arrays=24, key_len=20)
    torch.cuda.synchronize()
    if keys.shape != (x.shape[0], 24) or not bool(((keys >= 0) & (keys < 2**20)).all()):
        raise AssertionError("lsh_hash keys out of range at H=24, M=20")
    r = lsh_key_flips(x, p, 24, 20, keys, ref.lsh_hash_ref(x, p, n_arrays=24, key_len=20))
    msg = [f"lsh_hash at H=24, M=20 (N={x.shape[0]}, d={x.shape[1]}): {r['flips']} of {r['bits']} "
           f"key bits differ, each within the rounding bound ({r['near']} near-ties)"]
    worst = 0.0
    for what, xs, c in (("PQ sub-space (column slice 288:384, d=96)", x[:, 288:384], 256),
                        ("IVF-PQ coarse lists (d=768)", x, 1024)):
        cen = torch.randn((c, xs.shape[1]), generator=g, device=dev)
        got = kmeans_assign_op(xs, cen)
        torch.cuda.synchronize()
        xc = xs.contiguous()
        want = plain_fns()["kmeans_assign"](xc, cen)
        rep = assignment_flips(xc, cen, got[0], want[0])
        torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-4)
        worst = max(worst, float((got[1] - want[1]).abs().max()))
        msg.append(f"kmeans_assign at {what}, c={c}: {rep['differ']} of {rep['rows']} assignments "
                   f"differ, each a near-tie; "
                   + hold_min_dist(min_dist_errors(xc, cen, got, want), f"parity {what}"))
    log("parity", "the baselines' shapes: " + "; ".join(msg))
    return worst


@contextlib.contextmanager
def tf32_products():
    """Let cuBLAS run float32 products on TF32 inputs, to show that the
    float64 distance check tells a TF32 product from a float32 one."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def min_dist_errors(x, cen, got, want) -> dict:
    """Largest relative error against float64 of the (assignment, distance)
    pairs ``got`` (the kernel's) and ``want`` (the plain version's), and of
    the plain version run on TF32 products."""
    from repro_torch.testing import min_dist_error

    with tf32_products():
        tf = plain_fns()["kmeans_assign"](x, cen)
    return {"kernel": min_dist_error(x, cen, *got), "plain": min_dist_error(x, cen, *want),
            "tf32": min_dist_error(x, cen, *tf)}


def hold_min_dist(errs: dict, where: str) -> str:
    """The kernel's distances may err at most ``F32_ERROR_FACTOR`` times the
    plain version's error against float64, and the TF32 product must err
    more than that, or the check could not catch one."""
    from repro_torch.testing import F32_ERROR_FACTOR as f

    lim = f * errs["plain"]
    if errs["kernel"] > lim:
        raise AssertionError(f"{where}: kmeans_assign distances err {errs['kernel']:.3g} against "
                             f"float64, over {f} x the plain version's {errs['plain']:.3g}")
    if errs["tf32"] <= lim:
        raise AssertionError(f"{where}: a TF32 product errs {errs['tf32']:.3g}, within the limit "
                             f"{lim:.3g}: the check cannot tell TF32 from float32")
    return (f"min distances against float64: kernel max rel err {errs['kernel']:.3g}, plain "
            f"{errs['plain']:.3g} (limit {f} x plain = {lim:.3g}), a TF32 product {errs['tf32']:.3g}")


def index_nbytes(params) -> int:
    """Bytes of an index's tensors (on the card; a host tier's table is not
    one of them)."""
    from repro_torch.core.types import tensor_leaves

    return sum(t.nbytes for t in tensor_leaves(params))


def peak_line(key: str, peak: int, index_bytes: int, corpus_bytes: int, where: str) -> str:
    """A phase's peak device memory beside its prediction
    (``PREDICTED_PEAK_GB``, PERF.md's), the bytes of its index on the card
    and of the corpus (``where`` it lives)."""
    pred = PREDICTED_PEAK_GB[key]
    return (f"{key}: peak device memory (max_memory_allocated) {peak / 1e9:.2f} GB, predicted "
            f"{pred:.2f} GB ({peak / 1e9 / pred - 1:+.1%}); the index's tensors on the card "
            f"{index_bytes / 1e9:.3f} GB; the corpus {corpus_bytes / 1e9:.3f} GB, in {where}")


def host_memory() -> dict:
    """Bytes by key of ``/proc/meminfo`` and of this process's
    ``/proc/self/status``."""
    info = {}
    for path in ("/proc/meminfo", "/proc/self/status"):
        for line in Path(path).read_text().splitlines():
            key, _, value = line.partition(":")
            if value.strip().endswith("kB"):
                info[key] = int(value.split()[0]) * 1024
    return info


def host_memory_line(when: str) -> str:
    """The host's memory and this process's resident set, in GB."""
    info = host_memory()
    return (f"host memory, {when}: {info['MemTotal'] / 1e9:.2f} GB in all, "
            f"{info['MemAvailable'] / 1e9:.2f} GB available; this process {info['VmRSS'] / 1e9:.2f} GB "
            "resident")


def table_fingerprint(table: torch.Tensor) -> tuple[int, int]:
    """Two checksums of a ``(c, Lp, d)`` float32 table's 32-bit words, on
    its device: their sum, and their sum each times its position within a
    cluster's rows mod 65,521, plus one (int64, wrapping), eight clusters at
    a time."""
    words = table.view(torch.int32)
    weight = (torch.arange(words[0].numel(), device=table.device) % 65_521 + 1).view(words[0].shape)
    total = torch.zeros((), dtype=torch.int64, device=table.device)
    weighted = torch.zeros_like(total)
    for s in range(0, words.shape[0], 8):
        w = words[s : s + 8].to(torch.int64)
        total += w.sum()
        weighted += (w * weight).sum()
    return int(total), int(weighted)


def same_table(what: str, bank, table) -> None:
    """The rescore table and the gids of a quantized ``bank`` against the
    float32 main index's (``table``: its fingerprint and gids): the same
    rows in the same slots, or a raise."""
    fingerprint, gids = table
    got = table_fingerprint(bank.rescore_embs)
    if got != fingerprint or not torch.equal(bank.gids, gids):
        raise AssertionError(f"{what}: the rescore table (fingerprint {got}) or its gids differ "
                             f"from the float32 index's (fingerprint {fingerprint})")
    log("serve" if what.startswith("serve") else "quantized",
        f"{what}: rescore table and gids == the float32 main index's (fingerprint {got})")


def phase_bulk(phase: str, name: str, params, search, queries, per: tuple, corpus_bytes: int,
               reps: int = 3) -> dict:
    """The reference's ``serve_bulk`` shape: ``queries`` (``BULK`` of them)
    in one batch through ``search`` (``search_lider``), captured as the query
    path always is: a first run, the capture, then replays. The ids must
    equal the same queries' in batches of ``BATCH``; the scores bit for bit,
    or else within rtol 1e-5 (the line says which held). The launches of
    the first run are one batch's; then the replays timed by CUDA events,
    the phase's peak device memory and the graph's pool. Last, each kernel
    call of one batch timed beside its bound, as the shapes phase does.
    The graphs of ``params`` are freed first, and the bulk graph after."""
    from repro_torch.core import graphs
    from repro_torch.core.types import tensor_leaves

    small = [search(q) for q in queries.split(BATCH)]
    want = (torch.cat([o.ids for o in small]), torch.cat([o.scores for o in small]))
    del small
    stream = torch.cuda.current_stream()
    graphs.release(stream, tensor_leaves(params))
    free()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    first, t_first = host_ms(lambda: search(queries))
    counts = read_counts()
    if counts != per:
        raise AssertionError(f"{phase} {name} bulk: the first run launched {counts}, expected {per}")
    pool = graphs.held_bytes(stream)
    lat = []
    for _ in range(reps):
        got, ms = event_ms(lambda: search(queries))
        lat.append(ms)
        if not bit_equal((got.ids, got.scores), (first.ids, first.scores)):
            raise AssertionError(f"{phase} {name} bulk: a replay differs from the first run")
    peak = torch.cuda.max_memory_allocated()
    if not torch.equal(first.ids, want[0]):
        rows = int((first.ids != want[0]).any(1).sum())
        raise AssertionError(f"{phase} {name} bulk: {rows} of {queries.shape[0]} queries' ids differ "
                             f"from the same queries in batches of {BATCH}")
    if bit_equal((first.ids, first.scores), want):
        scores = "scores bit for bit"
    else:
        torch.testing.assert_close(first.scores, want[1], rtol=1e-5, atol=0)
        scores = (f"scores within rtol 1e-5 (not bit for bit; max |diff| "
                  f"{float((first.scores - want[1]).abs().max()):.3g})")
    med = statistics.median(lat)
    log(phase, f"{name} at the serve_bulk shape: {queries.shape[0]} queries in one batch == the same "
        f"queries in batches of {BATCH}: ids equal, {scores}; first run (eager, then the capture) "
        f"{t_first:.1f} ms, launches {fmt_counts(counts)}; replayed batch median {med:.3f} ms (CUDA "
        f"events; all {', '.join(f'{v:.3f}' for v in lat)}), {queries.shape[0] / med * 1e3:.0f} "
        f"queries/s; the graph's pool {pool / 1e9:.3f} GB; "
        + peak_line(f"bulk {name}", peak, index_nbytes(params), corpus_bytes, "host memory"))
    graphs.release(stream, tensor_leaves(params))
    free()
    calls = []
    with recording(calls):
        search(queries)
    torch.cuda.synchronize()
    timed = []
    first_fv = next(c for c in calls if c[0] != "lsh_hash")
    hash_roles = iter(("query hash (centroids)", "query hash (bank)"))
    for call in calls:
        cname, args, kw = call
        if cname == "lsh_hash":
            res = time_build_call(f"{name} bulk", next(hash_roles), cname, args, kw, reps=10)
        else:
            role, _, chunk = _role(cname, args, kw, first=call is first_fv)
            if role == "rescore" and args[1].shape[1] > 10_000:  # a float table's in-cluster call
                role, chunk = "in-cluster", 8
            res = time_call(f"{name} bulk", role, cname, args, kw, reps=3, chunk=chunk)
        res["launches_per_batch"] = per[list(KERNELS).index(cname)]
        timed.append(res)
    del calls
    free()
    return {"ms": med, "first_ms": t_first, "pool_bytes": pool, "peak_gb": peak / 1e9,
            "scores_bit_equal": scores == "scores bit for bit", "calls": timed}


def phase_small(dev) -> dict:
    """The ``SMALL_N``-row corpus of the paths that keep their earlier size:
    the corpus, 4 x 256 queries, Flat's exact top-k, and the centroids and
    index bytes of its float32 build."""
    from repro_torch.configs.lider_msmarco import CONFIG
    from repro_torch.core import lider
    from repro_torch.core.baselines import flat_search
    from repro_torch.data import synthetic

    corpus = synthetic.retrieval_corpus(SEED, SMALL_N, CONFIG.dim, device=dev)
    queries, _ = synthetic.retrieval_queries(SEED + 1, corpus, N_BATCHES * BATCH)
    params = lider.build_lider(SEED, corpus, CONFIG.lider, device=dev)
    return {"corpus": corpus, "queries": queries, "gt": flat_search(corpus, queries, k=CONFIG.k).ids,
            "centroids": params.centroids, "index_bytes": index_nbytes(params)}


def cut_line(phase: str, secs: float, scale: float, t_run: float, why: str) -> str:
    """Why ``phase`` ran on the ``SMALL_N``-row corpus: its seconds here,
    times ``scale`` (the float32 index's bytes at the reference's size over
    its bytes at ``SMALL_N``) beside the run's time so far and limit, and
    ``why`` (what this run measured that the larger size would break)."""
    from repro_torch.configs.lider_msmarco import CONFIG

    return (f"cut: {phase} ran on the {SMALL_N:,}-row corpus, not {CONFIG.corpus_size:,}: "
            f"{secs:.1f} s here, ~{secs * scale:.0f} s at {scale:.2f}x the tables, with the run at "
            f"{t_run:.0f} s of its {RUN_LIMIT_S} s limit; {why}")


def reference_capacity(dev, corpus, assignment, cfg) -> str:
    """The reference's capacity on the build's assignment: the clusters it
    would overflow, the passages it would drop, and ``build_bank`` at it
    raising ``CapacityOverflowError`` (before any pack) as the reference's
    does. Fails where ``cfg.capacity`` is None and the reference's capacity
    drops nothing: the cut in ``REDUCED`` would then not be forced."""
    from repro_torch.configs.lider_msmarco import ARCH
    from repro_torch.core import bank

    cap = ARCH.config.capacity
    sizes = assignment.to(torch.int64).bincount(minlength=cfg.n_clusters)
    over, drops = int((sizes > cap).sum()), int((sizes - cap).clamp(min=0).sum())
    if cfg.capacity is not None:
        return f"the reference's capacity {cap} is the configuration's"
    if not drops:
        raise AssertionError(f"capacity None, but the reference's {cap} drops nothing here")
    try:
        bank.build_bank(torch.Generator(device=dev), corpus, assignment, n_clusters=cfg.n_clusters,
                        capacity=cap, n_arrays=cfg.n_arrays, key_len=cfg.key_len,
                        n_leaves=cfg.n_leaves)
    except bank.CapacityOverflowError as e:
        if e.n_dropped != drops:
            raise AssertionError(f"build_bank at capacity {cap} counts {e.n_dropped} drops, not {drops}")
    else:
        raise AssertionError(f"build_bank at capacity {cap} did not raise")
    return (f"the reference's capacity {cap} overflows {over} clusters and would drop {drops} "
            "passages: build_bank at it raises CapacityOverflowError, so the cell takes capacity None")


def phase_main(dev) -> dict:
    """The main phase at the reference's size; see the module docstring.
    Returns the readings and, for the later 8.8M phases, the queries, the
    exact top-k, the searched index and the corpus in host memory."""
    from repro_torch.configs.lider_msmarco import CONFIG, REDUCED
    from repro_torch.core import bank, lider
    from repro_torch.core.baselines import flat_search
    from repro_torch.core.utils import recall_at_k
    from repro_torch.data import synthetic

    cfg = CONFIG.lider
    log("main", f"lider-msmarco: N={CONFIG.corpus_size} d={CONFIG.dim} c={cfg.n_clusters} "
        f"n_probe={cfg.n_probe} H={cfg.n_arrays} M={cfg.key_len} k={CONFIG.k}; cuts: "
        + "; ".join(REDUCED))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    corpus = synthetic.retrieval_corpus(SEED, CONFIG.corpus_size, CONFIG.dim, device=dev)
    queries, _ = synthetic.retrieval_queries(SEED + 1, corpus, N_BATCHES * BATCH)
    bulk_queries, _ = synthetic.retrieval_queries(SEED + 31, corpus, BULK)
    graph_queries, _ = synthetic.retrieval_queries(SEED + 21, corpus, GRAPH_BATCHES * BATCH)
    torch.cuda.synchronize()
    t_data = time.perf_counter() - t0
    peak_data = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    gt = flat_search(corpus, queries, k=CONFIG.k)
    torch.cuda.synchronize()
    t_flat = time.perf_counter() - t0
    log("main", f"data: corpus {corpus.nbytes / 1e9:.3f} GB made on the card in {t_data:.2f} s "
        f"(peak {peak_data / 1e9:.2f} GB, predicted {PREDICTED_PEAK_GB['data']} GB: the rows, their "
        f"noise and the normalised copy); Flat's exact top-{CONFIG.k} of the {N_BATCHES * BATCH} "
        f"queries {t_flat:.2f} s")

    # 1. The main path's build: counted, staged, profiled; its first call of
    # each kernel role is kept and checked at its full size while only the
    # corpus is on the card. Only its k-means result is kept after that.
    torch.cuda.reset_peak_memory_stats()
    build_calls = []
    first = build_counted("main", dev, corpus, cfg, calls=build_calls, profile=True)
    km, stats = first.km, first.stats
    index_bytes = index_nbytes(first.params)
    peak_build = torch.cuda.max_memory_allocated()
    if stats.n_dropped:
        raise AssertionError(f"the build dropped {stats.n_dropped} passages")
    first.params = None
    free()
    build_shapes = phase_shapes_build(build_calls, cfg.n_clusters)
    checks = shape_checks(build_calls)
    del build_calls
    free()
    # 2. A build whose every kernel call is timed alone; 3. the warm build,
    # searched below: its k-means result must equal the first's bit for bit.
    timed = time_every_build_call(dev, corpus, cfg)
    free()
    warm = build_counted("main", dev, corpus, cfg)
    params = warm.params
    table = (table_fingerprint(params.bank.embs), params.bank.gids.clone())
    log("main", same_builds(km, warm.km))
    log("main", lloyd_sums(corpus, km.assignment, cfg.n_clusters))
    log("main", f"capacity Lp={stats.capacity} (largest cluster {int(km.assignment.bincount().max())});"
        f" indexed {stats.n_indexed}, dropped {stats.n_dropped}; peak device memory of the first "
        f"build {peak_build / 1e9:.2f} GB; " + reference_capacity(dev, corpus, km.assignment, cfg))
    log("main", f"first build_lider of the process {first.secs:.2f} s ({fmt_stages(first)}); warm "
        f"build {warm.secs:.2f} s ({fmt_stages(warm)})")
    log("main", f"first build under cProfile, the functions with most time of their own: {first.top}")
    for name in BUILD_KERNELS:
        mine = [t for t in timed if t["kernel"] == name]
        log("main", f"a build with every call timed alone: {len(mine)} {name} calls, kernel "
            f"{sum(t['ms'] for t in mine):.3f} ms in all, plain version "
            f"{sum(t['plain_ms'] for t in mine):.3f} ms, cuBLAS product alone "
            f"{sum(t['product_ms'] for t in mine):.3f} ms, bound {sum(t['bound_ms'] for t in mine):.3f} ms"
            f" (one float32 product on the CUDA cores: {sum(t['f32_bound_ms'] for t in mine):.3f} ms)")
    del warm, km

    k, n_probe = CONFIG.k, cfg.n_probe
    search = lambda q: lider.search_lider(
        params, q, k=k, n_probe=n_probe, r0=cfg.r0, r0_centroid=cfg.r0_centroid
    )
    batches = [queries[i * BATCH : (i + 1) * BATCH] for i in range(N_BATCHES)]
    # Warm-up, before the counts are reset: it records the arguments of the
    # batch's kernel calls, which phase_shapes times and checks.
    kernel_calls = []
    with recording(kernel_calls):
        search(batches[0])
    torch.cuda.synchronize()
    order = [c[0] for c in kernel_calls]
    if order != ["lsh_hash", "fused_verify"] * 2:
        raise AssertionError(f"one search batch made kernel calls {order}")
    search(batches[0])  # the signature's first run and capture, before the timed batches
    torch.cuda.synchronize()

    reset_counts()
    outs, lat_ms, wall_ms = [], [], []
    for qb in batches:
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        s.record()
        outs.append(search(qb))
        e.record()
        torch.cuda.synchronize()
        wall_ms.append((time.perf_counter() - h0) * 1e3)
        lat_ms.append(s.elapsed_time(e))
    counts = read_counts()
    want = tuple(N_BATCHES * v for v in per_batch("F32"))
    if counts != want:
        raise AssertionError(f"kernel launches {counts}, expected {want}")
    ids = torch.cat([o.ids for o in outs])
    scores = torch.cat([o.scores for o in outs])
    if ids.shape != (N_BATCHES * BATCH, k) or not bool(torch.isfinite(scores).all()):
        raise AssertionError(f"bad result: shape {tuple(ids.shape)}, finite {bool(torch.isfinite(scores).all())}")
    rec = float(recall_at_k(ids, gt.ids))
    med = statistics.median(lat_ms)
    log("main", f"{N_BATCHES} x {BATCH} queries at k={k}: launches {fmt_counts(counts)} "
        f"({per_batch('F32')} per batch, as the code predicts); per-batch latency median "
        f"{med:.3f} ms (CUDA events; all {', '.join(f'{v:.3f}' for v in lat_ms)}), host wall "
        f"median {statistics.median(wall_ms):.3f} ms, {BATCH / med * 1e3:.0f} queries/s")
    ivf = ivf_recall(params, queries, gt.ids, cfg, k)
    log("main", f"recall@{k} vs Flat = {rec:.4f}; IVF-Flat (an exact scan of the {n_probe} clusters "
        f"whose centroids score highest) {ivf['ivf']:.4f}, so LIDER keeps {rec / ivf['ivf']:.3f} of "
        f"it (floor {LIDER_OF_IVF}); an exact scan of the {n_probe} clusters LIDER routes to "
        f"{ivf['routed']:.4f}")
    if rec < LIDER_OF_IVF * ivf["ivf"]:
        raise AssertionError(f"recall@{k} {rec} below {LIDER_OF_IVF} of IVF-Flat's {ivf['ivf']}")

    log("main", "first 8 queries: " + against_plain(params, search, batches[0][:8]))
    phase_trace("trace F32", search, batches[1], med)
    graph_batches = list(graph_queries.split(BATCH))
    f32_graphs = graph_point("graphs", "F32", search, graph_batches, per_batch("F32"))
    log("main", peak_line("main", torch.cuda.max_memory_allocated(), index_bytes, corpus.nbytes,
                          "the card"))
    # The later phases at this size need the corpus only to build from: it
    # goes to host memory, and the card keeps the index.
    host_corpus, t_move = host_ms(lambda: bank.copy_through_pinned(
        torch.empty(corpus.shape, dtype=corpus.dtype), corpus))
    del corpus
    free()
    log("main", f"corpus to host memory in {t_move / 1e3:.2f} s (through a pinned buffer); on the "
        f"card: {torch.cuda.memory_allocated() / 1e9:.3f} GB")
    return {
        "kernel_calls": kernel_calls, "build_shapes": build_shapes, "build_checks": checks,
        "launches": counts, "build_launches": first.counts, "build_timed": timed, "recall": rec,
        "latency_ms": med, "peak_gb": peak_build / 1e9, "host_corpus": host_corpus,
        "queries": queries, "bulk_queries": bulk_queries, "gt": gt.ids, "params": params,
        "graph_batches": graph_batches, "graphs": {"F32": f32_graphs}, "search": search,
        "table": table, "index_bytes": index_bytes, "ivf_recall": ivf["ivf"],
    }


def build_counted(phase: str, dev, corpus, cfg, *, calls=None, profile=False, seed=SEED, **kw):
    """``build_lider`` with the launch counts reset just before it and
    checked just after against :func:`per_build`. Returns a namespace: the
    index (``params``, ``stats``), its wall ``secs``, ``stages`` (the
    synchronized seconds of the k-means or the assignment, the bank build,
    the centroid model, and the ``rest`` of the wall), ``counts`` (the
    launches read) and, with ``profile``, ``top``: the functions with the
    most time of their own under ``cProfile``. ``calls`` receives the first
    call of each build-kernel role (k-means step, bank fit, centroid fit)."""
    from repro_torch.core import bank as bank_lib
    from repro_torch.core import lider

    stages, outs = {}, {}

    def timed(mod, attr, key):
        real = getattr(mod, attr)

        def f(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(*a, **k)
            torch.cuda.synchronize()
            stages[key] = stages.get(key, 0.0) + time.perf_counter() - t0
            outs[key] = out
            return out
        return mock.patch.object(mod, attr, f)

    seen = set()

    def keep(name, args, kw_):
        role = build_role(name, args, cfg.n_clusters)
        if role is None or role in seen:
            return False
        seen.add(role)
        return True

    kmeans = kw.get("centroids") is None
    prof = cProfile.Profile() if profile else None
    with contextlib.ExitStack() as stack:
        stack.enter_context(timed(lider, "assign_points", "k-means" if kmeans else "assignment"))
        stack.enter_context(timed(bank_lib, "build_bank", "bank"))
        stack.enter_context(timed(lider, "build_core_model", "centroid model"))
        if calls is not None:
            stack.enter_context(recording(calls, keep))
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if prof is not None:
            prof.enable()
        params, stats = lider.build_lider(seed, corpus, cfg, return_stats=True, device=dev, **kw)
        torch.cuda.synchronize()
        if prof is not None:
            prof.disable()
        secs = time.perf_counter() - t0
        counts = read_counts()
    stages["rest"] = secs - sum(stages.values())
    want = per_build(cfg, kmeans=kmeans)
    if counts != want:
        raise AssertionError(f"{phase}: one build launched {counts}, expected {want}")
    log(phase, (f"one build_lider launched {fmt_counts(counts)}, as the code predicts "
                f"({cfg.kmeans_iters} Lloyd steps + 1 final assignment; ceil({cfg.n_clusters} / "
                "64) bank-fit chunks + 1 centroid-model fit)" if kmeans else
                f"one build_lider (given centroids) launched {fmt_counts(counts)}, as the code "
                "predicts") + f"; indexed {stats.n_indexed}, dropped {stats.n_dropped}")
    return types.SimpleNamespace(params=params, stats=stats, secs=secs, stages=stages,
                                 counts=counts, top=top_functions(prof) if prof else None,
                                 km=outs["k-means" if kmeans else "assignment"])


def same_builds(a, b) -> str:
    """Two builds of the same corpus and seed must reach the same k-means
    result, bit for bit (a kernel fault or a Lloyd sum in atomic order
    would show here); raises otherwise."""
    same_c = same_bits(a.centroids, b.centroids)
    rows = int((a.assignment != b.assignment).sum())
    if same_c and rows == 0:
        return "first and warm build: k-means centroids and assignments identical bit for bit"
    diff = (a.centroids - b.centroids).abs()
    raise AssertionError(
        f"first and warm build differ: {int((diff > 0).any(1).sum())} of {diff.shape[0]} "
        f"centroids (max |diff| {float(diff.max()):.3g}), {rows} of {a.assignment.numel()} "
        "assignments")


def lloyd_sums(x, assignment, n_clusters: int) -> str:
    """The Lloyd step's sums at the main path's shape (the corpus and the
    first build's final assignment): ``clustering.cluster_sums``, which
    adds each cluster's rows in one fixed order (two calls must be equal
    bit for bit), timed beside ``index_add_``, which adds in atomic order
    (two calls compared)."""
    from repro_torch.core import clustering

    idx = assignment.to(torch.int64)
    fixed = lambda: clustering.cluster_sums(x, idx, n_clusters)
    atomic = lambda: torch.zeros((n_clusters, x.shape[1]), dtype=x.dtype,
                                 device=x.device).index_add_(0, idx, x)
    if not same_bits(fixed(), fixed()):
        raise AssertionError("two calls of cluster_sums on the same inputs differ")
    a, b = atomic(), atomic()
    differ = int((a != b).any(1).sum())
    del a, b
    fixed_ms, atomic_ms = cuda_ms(fixed, 5), cuda_ms(atomic, 5)
    return (f"Lloyd sums at N={x.shape[0]}, d={x.shape[1]}, c={n_clusters} (CUDA events, mean of "
            f"5): cluster_sums (index_put_, fixed order) {fixed_ms:.3f} ms, two calls equal bit for "
            f"bit; index_add_ (atomic order) {atomic_ms:.3f} ms, two calls differ in {differ} of "
            f"{n_clusters} clusters")


def fmt_stages(build) -> str:
    return ", ".join(f"{k} {v:.3f} s ({v / build.secs:.1%})" for k, v in build.stages.items())


def top_functions(prof: cProfile.Profile, n: int = 6) -> str:
    rows = sorted(pstats.Stats(prof).stats.items(), key=lambda kv: -kv[1][2])[:n]
    return "; ".join(f"{Path(f).name}:{line}({fn}) {tt:.3f} s own, {ct:.3f} s in all, {nc} calls"
                     for (f, line, fn), (_, nc, tt, ct, _) in rows)


def kernel_pattern(name: str):
    """Device kernels of a wrapper, by name (the grouped call's two kernels
    count as one, and so do ``kmeans_assign``'s norm and assignment
    kernels)."""
    return re.compile(rf"\b{name}(_score|_select|_norms)?_kernel\b")


def device_ms(name: str, run, wrapper, n: int = 5, tries: int = 3) -> float | None:
    """Milliseconds the card spends in ``name``'s kernels per call of
    ``run``, from a ``torch.profiler`` trace of ``n`` calls: the kernel time
    without the host's time to launch it. The trace must hold one device
    event for each launch that ``wrapper``'s count records over those
    calls; one that holds another number is taken again, up to ``tries``
    traces, and then the figure is None (not measured)."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    pat = kernel_pattern(name)
    for _ in range(tries):
        before = wrapper.launches
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                run()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and pat.search(e.name)]
        if us and len(us) == wrapper.launches - before:
            return sum(us) / n / 1e3
    return None


def event_ms(fn):
    """``(fn(), its milliseconds by CUDA events)``: one call, synchronized
    on both sides."""
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    out = fn()
    e.record()
    torch.cuda.synchronize()
    return out, s.elapsed_time(e)


def time_every_build_call(dev, corpus, cfg) -> list[dict]:
    """One more main-path build in which every ``lsh_hash`` and
    ``kmeans_assign`` call is timed on its own with CUDA events, then its
    plain version and the cuBLAS product alone on the same arguments: one
    dict per call, with the call's bound. Two builds ran before, so every
    kernel and library is loaded."""
    from repro_torch.core import lider
    from repro_torch.kernels import ops

    real, plain = wrappers(), plain_fns()
    rows = []

    def timed(name):
        def f(*args, **kw):
            before = real[name].launches
            out, ms = event_ms(lambda: real[name](*args, **kw))
            launches = real[name].launches - before
            _, plain_ms = event_ms(lambda: plain[name](*args, **kw))
            product, bound_ms, bound_by, shape = build_call_model(name, args, kw)
            _, product_ms = event_ms(product)
            rows.append({"kernel": name, "launches": launches, "ms": ms, "plain_ms": plain_ms,
                         "product_ms": product_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                         "f32_bound_ms": shape["f32_bound_ms"]})
            return out
        return f

    with contextlib.ExitStack() as stack:
        for attr, name in (("_lsh", "lsh_hash"), ("_km", "kmeans_assign")):
            stack.enter_context(mock.patch.object(ops, attr, types.SimpleNamespace(**{name: timed(name)})))
        _, stats = lider.build_lider(SEED, corpus, cfg, device=dev, return_stats=True)
    log("main", f"the build with every call timed: indexed {stats.n_indexed}, dropped "
        f"{stats.n_dropped}")
    return rows


def build_role(name: str, args, n_clusters: int) -> str | None:
    if name == "kmeans_assign":
        return "k-means step"
    if name == "lsh_hash":
        return "centroid fit" if args[0].shape[0] == n_clusters else "bank fit"
    return None


def phase_trace(phase: str, search, qb, batch_ms: float) -> None:
    """Where one batch's time goes: a ``torch.profiler`` trace of one warm
    search call, run after the launch counts were read. The profiler slows
    the host, so the idle share is taken against ``batch_ms``, the
    unprofiled batch latency, not against the traced call's own wall."""
    from torch.profiler import ProfilerActivity, profile

    search(qb)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        search(qb)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        log(phase, "device time not measured: the profiler recorded no device events")
        return None
    by_name: dict[str, float] = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    per_kernel = {n: sum(v for name, v in by_name.items() if kernel_pattern(n).search(name))
                  for n in KERNELS}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    log(phase, f"one profiled batch: device busy {busy / 1e3:.3f} ms over {len(dev)} "
        f"device ops, {busy / 1e3 / batch_ms:.1%} of the unprofiled batch latency "
        f"{batch_ms:.3f} ms (idle {1 - busy / 1e3 / batch_ms:.1%}; traced wall "
        f"{wall_us / 1e3:.3f} ms); "
        + "; ".join(f"{n} {v / 1e3:.3f} ms ({v / busy:.1%})" for n, v in per_kernel.items() if v)
        + "; top: " + "; ".join(f"{n[:60]} {v / 1e3:.3f} ms" for n, v in top))
    return busy / 1e3 / batch_ms


GRAPH_BATCHES = 16  # batches of BATCH queries the graphs phase runs each way, per turn


def padded_cm_search(params, op):
    """A cluster-major point spelled as the serving engine's staged stage 1
    runs it: the schedule padded to its worst case (``stats_out``), so
    every batch of one size has one signature, then the rescore from the
    resident table."""
    from repro_torch.configs.lider_msmarco import CONFIG
    from repro_torch.core import lider

    cfg, k = CONFIG.lider, CONFIG.k
    kw = op.search_kwargs()
    block_q = kw.pop("block_q")

    def search(q):
        prov, _ = lider.host_first_pass_cluster_major(
            params, q, k=k, n_probe=cfg.n_probe, r0=cfg.r0, r0_centroid=cfg.r0_centroid,
            block_q=block_q, stats_out={}, **kw)
        return lider._rescore_provisional(params.bank.gids, params.bank.rescore_embs, prov.ids,
                                          q, k=k)

    return search


def graph_point(phase: str, name: str, search, batches, per: tuple) -> dict:
    """One operating point through its CUDA graphs (``core.graphs``) against
    its plain bodies (``testing.uncaptured``, each entry's ``__wrapped__``),
    over ``batches``, in turns (plain, captured, captured, plain), after a
    first run and a capture: ids and scores bit-equal batch for batch, the
    launches of each turn ``len(batches) * per``, the signature counter
    flat over the captured turns; batch medians by CUDA events and on the
    host clock, then one profiled batch of each for the device's busy
    share, and the graphs the captured turns replayed, with the bytes their
    pools hold."""
    from repro_torch.core import graphs, lider
    from repro_torch.testing import uncaptured

    def turn(captured: bool):
        outs, lat, wall = [], [], []
        with contextlib.nullcontext() if captured else uncaptured():
            reset_counts()
            for qb in batches:
                s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                h0 = time.perf_counter()
                s.record()
                outs.append(search(qb))
                e.record()
                torch.cuda.synchronize()
                wall.append((time.perf_counter() - h0) * 1e3)
                lat.append(s.elapsed_time(e))
            counts = read_counts()
        return outs, lat, wall, counts

    with uncaptured():
        search(batches[0])
    _, t_first = host_ms(lambda: search(batches[0]))  # a first run, then the capture
    n0 = lider.query_path_cache_size()
    replays0 = {id(g): g.replays for g in graphs.live_graphs()}
    want = tuple(len(batches) * v for v in per)
    lat = {False: [], True: []}
    wall = {False: [], True: []}
    outs = {}
    for captured in (False, True, True, False):
        o, la, wa, counts = turn(captured)
        how = "captured" if captured else "uncaptured"
        if counts != want:
            raise AssertionError(f"{name} {how}: launches {counts}, expected {want}")
        if lider.query_path_cache_size() != n0:
            raise AssertionError(f"{name} {how}: the signature counter moved from {n0} to "
                                 f"{lider.query_path_cache_size()}")
        outs.setdefault(captured, o)
        lat[captured] += la
        wall[captured] += wa
    for i, (a, b) in enumerate(zip(outs[False], outs[True])):
        if not bit_equal(a, b):
            raise AssertionError(f"{name}: batch {i} captured differs from uncaptured")
    med = {c: statistics.median(v) for c, v in lat.items()}
    med_wall = {c: statistics.median(v) for c, v in wall.items()}
    with uncaptured():
        busy_plain = phase_trace(f"{phase} {name} uncaptured", search, batches[1], med[False])
    busy_graph = phase_trace(f"{phase} {name} captured", search, batches[1], med[True])
    used = [g for g in graphs.live_graphs() if g.replays > replays0.get(id(g), 0)]
    held, n_used = sum(g.nbytes for g in used), len(used)
    log(phase, f"{name}: {len(batches)} x {batches[0].shape[0]} queries captured == uncaptured, ids "
        f"and scores bit for bit, each way twice in turns; launches per batch {fmt_counts(per)} "
        f"both ways; signature counter {n0}, flat over the captured batches; batch median (CUDA "
        f"events) uncaptured {med[False]:.3f} ms, captured {med[True]:.3f} ms ({med[False] / med[True]:.2f}x); "
        f"host wall median uncaptured {med_wall[False]:.3f} ms, captured {med_wall[True]:.3f} ms; "
        f"first call {t_first:.1f} ms; the captured batches replayed {n_used} graphs holding "
        f"{held / 1e6:.1f} MB of pools")
    return {"eager_ms": med[False], "graph_ms": med[True], "busy_eager": busy_plain,
            "busy_graph": busy_graph, "graph_bytes": held}


def verify_counts(name: str, args, kw) -> tuple:
    """What a ``fused_verify`` or ``sketch_prefilter`` call must move:
    ``(distinct valid rows, distinct valid (query, row) pairs, bytes of a
    row (with its scale on quantized tables), bytes of the id arrays,
    queries and outputs, operations per pair, the peak rate of their
    type)``. Operations: 2d per pair for a dot product, 2w per pair for a
    w-word XOR + popcount."""
    table, row_ids, q = args
    out = kw.get("out_ids")
    out = row_ids if out is None else out
    b, k = q.shape[0], kw["k"]
    # 256 queries at a time: a batch of 8,192 has 655 M candidates.
    seen = torch.zeros(table.shape[0], dtype=torch.bool, device=row_ids.device)
    pairs = 0
    for s in range(0, b, 256):
        rows, valid = row_ids[s : s + 256].to(torch.int64), out[s : s + 256] >= 0
        seen[rows[valid]] = True
        pairs += int(torch.unique(
            (torch.arange(rows.shape[0], device=rows.device)[:, None] * table.shape[0] + rows)[valid]).numel())
    distinct = int(seen.sum())
    if name == "sketch_prefilter":
        row_bytes, per_pair, peak = table.shape[1] * 4, 2 * table.shape[1], PEAK_OPS[torch.int8]
    elif kw.get("scales") is not None:
        row_bytes, per_pair, peak = table.shape[1] + 4, 2 * q.shape[1], PEAK_OPS[torch.int8]
    else:
        row_bytes = table.shape[1] * table.element_size()
        per_pair, peak = 2 * q.shape[1], PEAK_OPS[table.dtype]
    id_bytes = row_ids.numel() * 4 * (1 if out.data_ptr() == row_ids.data_ptr() else 2)
    return distinct, pairs, row_bytes, id_bytes + q.numel() * 4 + b * k * 8, per_pair, peak


def value_counts(name: str, args, kw) -> tuple[int, int, float]:
    """``(bytes, operations, the peak rate of their type)`` a verification
    call must move and do. Rows count once per distinct valid row (with
    their scale on quantized tables), id arrays and queries once.
    Operations: 2d per distinct (query, candidate row) pair for a dot
    product, 2w per pair for a w-word XOR + popcount; for the grouped
    kernel 2d per (slot, candidate row) of the schedule.

    These counts read the call's values (distinct valid rows, live slots),
    which the kernel table's bounds are made of. The dry run's cost
    (``kernels/cost.py``) has shapes only, so it counts every candidate as
    valid and distinct, the work of the plain version and the reference:
    never less than this (``phase_dryrun`` holds it so)."""
    if name == "fused_verify_grouped":
        embs, _, q, sched_cids, sched_qids, slot_ids = args
        c, lp, d_store = embs.shape
        s_steps, block_q, _ = slot_ids.shape
        real = (sched_qids >= 0).any(dim=1)
        live = (slot_ids >= 0).any(dim=1) & real[:, None]  # (S, Lp) rows any slot needs
        keys = sched_cids.to(torch.int64)[:, None] * lp + torch.arange(lp, device=embs.device)
        rows = int(torch.unique(keys[live]).numel())
        n_bytes = (rows * (d_store + 4) + int(real.sum()) * block_q * lp * 4
                   + (sched_cids.numel() + sched_qids.numel()) * 4 + q.numel() * 4
                   + s_steps * block_q * kw["kp"] * 8)
        ops, peak = 2 * q.shape[1] * int((slot_ids >= 0).sum()), PEAK_OPS[torch.int8]
    else:
        distinct, pairs, row_bytes, other_bytes, per_pair, peak = verify_counts(name, args, kw)
        n_bytes, ops = distinct * row_bytes + other_bytes, per_pair * pairs
    return n_bytes, ops, peak


def bound(name: str, args, kw) -> tuple[float, str]:
    """Least time for the call: each input read once and each output
    written once over the memory rate, or the operations over the peak rate
    of their type, whichever is larger (:func:`value_counts`)."""
    n_bytes, ops, peak = value_counts(name, args, kw)
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def per_query_floor(name: str, args, kw) -> tuple[int, float]:
    """``(pairs, ms)``: the distinct valid (query, row) pairs of a
    ``fused_verify`` or ``sketch_prefilter`` call, and the least time of a
    kernel that loads each pair's row once: those rows' bytes with the id
    arrays, queries and outputs, over the memory rate. ``bound`` counts each
    row once per call, which only a cluster-major schedule approaches."""
    _, pairs, row_bytes, other_bytes, _, _ = verify_counts(name, args, kw)
    return pairs, (pairs * row_bytes + other_bytes) / PEAK_BYTES_PER_S * 1e3


def per_step_floor(args) -> float:
    """Milliseconds a ``fused_verify_grouped`` call must take at least to
    read, for each real step (some slot has a query), its live rows (rows
    some slot has as a candidate) with their scales, and its slot ids, over
    the memory rate: the floor of a kernel that loads each step's rows once
    (``bound`` counts each distinct row once per call)."""
    embs, _, _, _, sched_qids, slot_ids = args
    real = (sched_qids >= 0).any(dim=1)
    live = int(((slot_ids >= 0).any(dim=1) & real[:, None]).sum())
    n_bytes = live * (embs.shape[2] + 4) + int(real.sum()) * slot_ids.shape[1] * slot_ids.shape[2] * 4
    return n_bytes / PEAK_BYTES_PER_S * 1e3


def chunks_alone(args, kw):
    """A multi-chunk call's candidates recast as one chunk per query row,
    (B * n_chunks, chunk) with each query repeated: the same chunk work
    without the final merge of each query's partial lists. None where the
    call is one chunk, C is not a whole number of chunks, or k exceeds a
    chunk (each recast row would write k outputs)."""
    from repro_torch.kernels.fused_verify import split_candidates

    table, rows, q = args
    out = kw.get("out_ids")
    out = rows if out is None else out
    b, c = rows.shape
    n_chunks, chunk = split_candidates(c)
    if n_chunks == 1 or c != n_chunks * chunk or kw["k"] > chunk:
        return None
    return ((table, rows.reshape(b * n_chunks, chunk), q.repeat_interleave(n_chunks, dim=0)),
            dict(kw, out_ids=out.reshape(b * n_chunks, chunk)))


def plain_chunked(name: str, args, kw, chunk: int):
    """The plain version over the whole call, ``chunk`` query rows (or
    schedule steps) at a time, so its materialization fits the card."""
    plain = plain_fns()[name]
    if name == "fused_verify_grouped":
        embs, rs, q, sc, sq, ss = args
        parts = [plain(embs, rs, q, sc[i : i + chunk], sq[i : i + chunk], ss[i : i + chunk], **kw)
                 for i in range(0, sc.shape[0], chunk)]
    else:
        table, rows, q = args
        out = kw.get("out_ids")
        out = rows if out is None else out
        parts = [plain(table, rows[i : i + chunk], q[i : i + chunk],
                       **dict(kw, out_ids=out[i : i + chunk]))
                 for i in range(0, rows.shape[0], chunk)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def describe(name: str, args, kw) -> dict:
    if name == "fused_verify_grouped":
        embs, _, q, sc, sq, ss = args
        return {"table": kw.get("code_dtype", "int8"), "S": sc.shape[0], "block_q": sq.shape[1],
                "Lp": ss.shape[2], "N": embs.shape[0] * embs.shape[1], "d": q.shape[1],
                "B": q.shape[0], "k": kw["kp"]}
    from repro_torch.kernels.fused_verify import split_candidates

    table, rows, q = args
    kind = ("sketch" if name == "sketch_prefilter" else
            kw.get("code_dtype", "int8") if kw.get("scales") is not None else
            str(table.dtype).removeprefix("torch."))
    return {"table": kind, "B": rows.shape[0], "C": rows.shape[1], "N": table.shape[0],
            "d": q.shape[1], "k": kw["k"], "chunks": split_candidates(rows.shape[1])[0]}


def time_call(path: str, role: str, name: str, args, kw, *, reps: int, chunk: int) -> dict:
    """One recorded kernel call: checked against the plain version over the
    whole call (bit-equal on quantized and sketch tables), then the kernel
    and the plain version timed with CUDA events, beside the bound."""
    run = lambda: wrappers()[name](*args, **kw)
    got = run()
    torch.cuda.synchronize()
    plain = lambda: plain_chunked(name, args, kw, chunk)
    want = plain()
    exact = name != "fused_verify" or kw.get("scales") is not None
    if exact:
        if not bit_equal(got, want):
            raise AssertionError(f"{path} {role}: {name} differs from its plain version")
        err, swaps = 0.0, 0
    else:
        err, swaps = compare(got, want)
    ms = cuda_ms(run, reps)
    dev_ms = device_ms(name, run, wrappers()[name])
    _, plain_ms = event_ms(plain)  # warm: the call that made ``want`` ran first
    bound_ms, bound_by = bound(name, args, kw)
    res = {"kernel": name, "path": path, "call": role, **describe(name, args, kw), "ms": ms,
           "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "max_abs_err": err, "swaps_admitted": swaps, "bit_equal": exact}
    floor = ""
    if name == "fused_verify_grouped":
        floor_ms = per_step_floor(args)
        floor = f", per-step floor {floor_ms:.4f} ms ({floor_ms / ms:.1%} of it)"
    else:
        pairs, floor_ms = per_query_floor(name, args, kw)
        floor = (f", per-query floor {floor_ms:.4f} ms ({pairs} distinct (query, row) pairs, "
                 f"{floor_ms / ms:.1%} of it)")
        alone = chunks_alone(args, kw)
        if alone is not None:
            res["chunks_ms"] = cuda_ms(lambda: wrappers()[name](*alone[0], **alone[1]), reps)
            floor += (f"; its chunks alone {res['chunks_ms']:.4f} ms, so the final merges cost "
                      f"~{ms - res['chunks_ms']:.4f} ms")
    shape = ", ".join(f"{k}={v}" for k, v in describe(name, args, kw).items())
    log("shapes", f"{path} {role}: {name} [{shape}]: "
        + ("ids and scores bit-equal to" if exact else f"ids equal ({swaps} near-tie swaps), max "
           f"|score err| {err:.3g} vs") + f" the plain version over the whole call (chunks of "
        f"{chunk}); kernel {ms:.4f} ms (its kernels' device time "
        + ("not measured" if dev_ms is None else f"{dev_ms:.4f} ms") + f"), plain {plain_ms:.3f} ms, "
        f"bound {bound_ms:.4f} ms "
        f"({bound_by}, {bound_ms / ms:.1%} of it){floor}; no single PyTorch call computes "
        "gather + dedup top-k, so no library time")
    return res


def phase_shapes_f32(main) -> list[dict]:
    """The float main path's two calls, float32 and (the same arguments on
    a bfloat16 copy of the table) bfloat16."""
    res = []
    fv_calls = [c for c in main["kernel_calls"] if c[0] == "fused_verify"]
    for dtype in (torch.float32, torch.bfloat16):
        for role, (name, args, kw), reps, chunk in zip(
            ("routing", "in-cluster"), fv_calls, (20, 5), (256, 8)
        ):
            if dtype == torch.bfloat16:
                args = (args[0].to(torch.bfloat16), *args[1:])
            path = "F32" if dtype == torch.float32 else "BF16 table"
            res.append(time_call(path, role, name, args, kw, reps=reps, chunk=chunk))
            del args
    return res


def phase_shapes_distinct(dev) -> None:
    """The in-cluster calls' shape (B=256, C=80,000, N=1,048,576, d=768) on
    traffic without repeats: rows drawn uniformly over N, so a chunk of
    4,000 candidates holds ~3,990 distinct rows where a LIDER chunk holds
    ~730, which fills the kernels' 4,096-slot hash set to ~97%. Each kernel
    is held to its plain version and timed beside its per-query floor,
    which here is about every candidate's row."""
    from repro_torch.core.utils import l2_normalize
    from repro_torch.kernels import quant

    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    n, c, path = 1_048_576, 80_000, "distinct rows"
    embs = l2_normalize(torch.randn((n, 768), generator=g, device=dev))
    rows = torch.randint(0, n, (BATCH, c), generator=g, device=dev, dtype=torch.int32)
    q = l2_normalize(torch.randn((BATCH, 768), generator=g, device=dev))
    time_call(path, "float32", "fused_verify", (embs, rows, q), {"k": 100}, reps=3, chunk=8)
    codes, scales = quant.quantize_rows(embs)
    time_call(path, "int8", "fused_verify", (codes, rows, q),
              {"k": 400, "scales": scales, "code_dtype": "int8"}, reps=5, chunk=8)
    del codes, scales
    time_call(path, "sketch", "sketch_prefilter", (quant.sketch_rows(embs), rows, q), {"k": 1600},
              reps=5, chunk=8)


def build_counts(name: str, args, kw) -> tuple[int, int]:
    """``(operations, bytes)`` of one ``lsh_hash`` or ``kmeans_assign`` call,
    the dry run's (``kernels/cost.py``): a build call's every row is valid
    and distinct, so the kernel table's count and the dry run's are one."""
    from repro_torch.kernels import cost

    x, other = args[0], args[1]
    if name == "lsh_hash":
        return cost.lsh_hash(*x.shape, kw["n_arrays"], kw["key_len"], x.element_size())
    return cost.kmeans_assign(x.shape[0], *other.shape)


def build_call_model(name: str, args, kw):
    """``(the cuBLAS product alone, bound ms, bound_by, shape)`` of one
    ``lsh_hash`` or ``kmeans_assign`` call. Bound: the operations the
    kernel's design must do over their peak, or the bytes (rows and P or
    the centroids read once, the int32 keys or the assignment and distance
    written once), whichever is larger. Both kernels run three TF32
    products (split TF32) on the tensor cores, 2 d per output each;
    ``shape["f32_bound_ms"]`` gives one float32 product on the CUDA cores
    beside it. The operations and bytes are :func:`build_counts`."""
    x = args[0]
    n, d = x.shape
    ops, n_bytes = build_counts(name, args, kw)
    if name == "lsh_hash":
        proj = args[1]
        product = lambda: x.to(torch.float32) @ proj
        shape = {"N": n, "d": d, "H": kw["n_arrays"], "M": kw["key_len"],
                 "rows": str(x.dtype).removeprefix("torch.")}
    else:
        cen = args[1]
        product = lambda: x @ cen.T
        shape = {"N": n, "c": cen.shape[0], "d": d}
    t_ops = 3 * ops / PEAK_OPS["tf32"]
    shape["f32_bound_ms"] = max(n_bytes / PEAK_BYTES_PER_S, ops / PEAK_OPS[torch.float32]) * 1e3
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    return product, max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), shape


def time_build_call(path: str, role: str, name: str, args, kw, *, reps: int) -> dict:
    """One recorded ``lsh_hash`` or ``kmeans_assign`` call: held against
    the plain version over the whole call (key bits and assignments may
    differ only within float32 rounding; distances allclose at rtol = atol
    = 1e-4 and within ``F32_ERROR_FACTOR`` times the plain version's error
    against float64), then the kernel, the plain version and the cuBLAS
    product alone (``x @ P``, ``x @ c.T``: no single PyTorch call computes
    hash or assignment, so there is no library time) timed with CUDA
    events, per call, beside the call's bound (:func:`build_call_model`).
    Beside a hash call's flips: how many bits the plain version run on a
    cuBLAS TF32 product puts outside the rounding bound (printed, not
    held: the bound refuses one-pass TF32 at ~2e-7 a bit, so a small call
    may show none; ``tests/test_torch_build_kernels.py`` holds the check
    to refusing it)."""
    from repro_torch.testing import assignment_flips, lsh_bits_outside_bound, lsh_key_flips

    run = lambda: wrappers()[name](*args, **kw)
    plain = lambda: plain_fns()[name](*args, **kw)
    got = run()
    torch.cuda.synchronize()
    want = plain()
    x = args[0]
    product, bound_ms, bound_by, shape = build_call_model(name, args, kw)
    if name == "lsh_hash":
        h, m = kw["n_arrays"], kw["key_len"]
        rep = lsh_key_flips(x, args[1], h, m, got, want)
        with tf32_products():
            tf = plain()
        tf_out = lsh_bits_outside_bound(x, args[1], h, m, tf, want)
        del tf
        err = 0.0
        check = (f"{rep['flips']} of {rep['bits']} key bits differ from the plain version "
                 f"({rep['flips'] / rep['bits'] * 1e6:.2f} per million), each within the rounding "
                 f"bound; {rep['near']} near-ties ({rep['near'] / rep['bits'] * 1e6:.2f} per "
                 f"million); a TF32 product puts {tf_out} bits outside the bound")
        extra = {"bits": rep["bits"], "flips": rep["flips"], "near_ties": rep["near"],
                 "tf32_bits_outside_bound": tf_out}
    else:
        cen = args[1]
        rep = assignment_flips(x, cen, got[0], want[0])
        torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-4)
        err = float((got[1] - want[1]).abs().max())
        errs = min_dist_errors(x, cen, got, want)
        check = (f"{rep['differ']} of {rep['rows']} assignments differ from the plain version "
                 f"({rep['differ'] / rep['rows'] * 1e6:.2f} per million), each a near-tie within the "
                 f"rounding bound; distances allclose (max |err| {err:.3g}); "
                 + hold_min_dist(errs, f"{path} {role}"))
        extra = {"rows_differ": rep["differ"], "f64_rel_err": errs}
    del got, want
    ms = cuda_ms(run, reps)
    dev_ms = device_ms(name, run, wrappers()[name])
    _, plain_ms = event_ms(plain)  # warm: the call that made ``want`` ran first
    product_ms = cuda_ms(product, reps)
    f32 = f", one float32 product on the CUDA cores {shape.pop('f32_bound_ms'):.4f} ms"
    dims = ", ".join(f"{k}={v}" for k, v in shape.items())
    log("shapes", f"{path} {role}: {name} [{dims}]: "
        f"{check}; per call: kernel {ms:.4f} ms (device time of its kernels "
        f"{'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'}), plain {plain_ms:.3f} ms, "
        f"cuBLAS product alone {product_ms:.4f} ms ({ms / product_ms:.2f} x), bound "
        f"{bound_ms:.4f} ms ({bound_by}, {bound_ms / ms:.1%} of it){f32}")
    return {"kernel": name, "path": path, "call": role, **shape, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "product_ms": product_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err": err, **extra}


def phase_shapes_build(calls, n_clusters: int) -> list[dict]:
    """The build's first call of each role (the k-means step over all N,
    one bank-fit chunk, the centroid-model fit)."""
    reps = {"k-means step": 5, "bank fit": 20, "centroid fit": 50}
    res = []
    for name, args, kw in calls:
        role = build_role(name, args, n_clusters)
        res.append(time_build_call("build", role, name, args, kw, reps=reps[role]))
    return res


def phase_shapes_hashes(main) -> list[dict]:
    """One search batch's two query hashes."""
    hashes = [c for c in main["kernel_calls"] if c[0] == "lsh_hash"]
    return [time_build_call("F32", role, name, args, kw, reps=50)
            for role, (name, args, kw) in zip(("query hash (centroids)", "query hash (bank)"), hashes)]


def _role(name: str, args, kw, first: bool) -> tuple[str, int, int]:
    """(role in the path, timing reps, plain-version chunk) of one recorded
    call; a search's first call is its routing."""
    if name == "sketch_prefilter":
        return "sketch pre-filter", 5, 8
    if name == "fused_verify_grouped":
        return "grouped first pass", 10, 32
    if kw.get("scales") is not None:
        return "first pass", 5, 8 if args[1].shape[1] > 10_000 else 64
    return ("routing" if first else "rescore"), 20, 256


def phase_quantized(dev, main, storage: str, points) -> dict:
    """Build the ``storage`` index at full width, drive each operating point
    in ``points`` over 4 x 256 queries, check it, and time its calls."""
    from repro_torch.configs.lider_msmarco import CONFIG
    from repro_torch.core import graphs, lider
    from repro_torch.core.types import tensor_leaves
    from repro_torch.core.utils import recall_at_k
    from repro_torch.kernels.schedule import build_cluster_schedule

    cfg = CONFIG.lider
    k = CONFIG.k
    torch.cuda.reset_peak_memory_stats()
    corpus = main["host_corpus"]
    built = build_counted("quantized", dev, corpus, points[0].lider_config(cfg))
    params, stats, t_build = built.params, built.stats, built.secs
    b = params.bank
    if stats.n_dropped:
        raise AssertionError(f"{storage}: the build dropped {stats.n_dropped} passages")
    log("quantized", f"{storage} index from the corpus in host memory: build_lider {t_build:.2f} s "
        f"({fmt_stages(built)}); Lp={stats.capacity}, dropped {stats.n_dropped}; codes "
        f"{tuple(b.embs.shape)} {b.embs.dtype}, rescore {tuple(b.rescore_embs.shape)}, sketches "
        f"{tuple(b.sketches.shape)} {b.sketches.dtype}; peak device memory of the build "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del built
    same_table(f"quantized {storage}", b, main["table"])
    batches = [main["queries"][i * BATCH : (i + 1) * BATCH] for i in range(N_BATCHES)]
    out = {"build_s": t_build, "paths": {}, "calls": [], "index_bytes": index_nbytes(params)}
    results = {}
    for op in points:
        search = lambda q, op=op: lider.search_lider(
            params, q, k=k, n_probe=cfg.n_probe, r0=cfg.r0, r0_centroid=cfg.r0_centroid,
            **op.search_kwargs(),
        )
        calls = []
        with recording(calls):
            search(batches[0])
        search(batches[0])  # a first run and capture (cm: batch 0's schedule length)
        torch.cuda.synchronize()
        out.setdefault("shape_checks", []).extend(shape_checks(calls))
        reset_counts()
        outs, lat_ms = [], []
        for qb in batches:
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            outs.append(search(qb))
            e.record()
            torch.cuda.synchronize()
            lat_ms.append(s.elapsed_time(e))
        counts = read_counts()
        want = tuple(N_BATCHES * v for v in per_batch(op.name))
        if counts != want:
            raise AssertionError(f"{op.name}: kernel launches {counts}, expected {want}")
        ids = torch.cat([o.ids for o in outs])
        scores = torch.cat([o.scores for o in outs])
        if ids.shape != (N_BATCHES * BATCH, k) or not bool(torch.isfinite(scores).all()):
            raise AssertionError(f"{op.name}: bad result shape {tuple(ids.shape)}")
        rec = float(recall_at_k(ids, main["gt"]))
        med = statistics.median(lat_ms)
        log("quantized", f"{op.name} ({storage}, {op.search_kwargs()}): launches per batch "
            f"{fmt_counts(c // N_BATCHES for c in counts)} (as the code predicts); recall@{k} vs Flat "
            f"{rec:.4f} (float32 bank {main['recall']:.4f}; floor {LIDER_OF_IVF} of IVF-Flat's "
            f"{main['ivf_recall']:.4f}); batch latency "
            f"median {med:.3f} ms (all {', '.join(f'{v:.3f}' for v in lat_ms)}), "
            f"{BATCH / med * 1e3:.0f} queries/s")
        if rec < LIDER_OF_IVF * main["ivf_recall"]:
            raise AssertionError(f"{op.name}: recall@{k} {rec} below {LIDER_OF_IVF} of IVF-Flat's "
                                 f"{main['ivf_recall']}")
        log("quantized", f"{op.name}: first 8 queries: "
            + against_plain(params, search, batches[0][:8]))
        results[op.name] = (ids, scores)
        out["paths"][op.name] = {"recall": rec, "latency_ms": med, "launches": counts,
                                 "calls": calls, "search": search}
        if op.block_q is not None:
            cids, _ = lider._route_pruned(params, batches[0], n_probe=cfg.n_probe,
                                          r0_centroid=cfg.r0_centroid)
            sched = build_cluster_schedule(cids.cpu().numpy(), block_q=op.block_q)
            log("quantized", f"{op.name} schedule of batch 0: n_pairs {sched.n_pairs}, n_steps "
                f"{sched.n_steps} (padded {sched.n_padded_steps}), sharing ratio "
                f"{sched.sharing_ratio:.3f} pairs per cluster read")
            base = [p.name for p in points if p.block_q is None and p.sketch_factor == op.sketch_factor][0]
            if not bit_equal(results[op.name], results[base]):
                raise AssertionError(f"{op.name} differs from {base}")
            log("quantized", f"{op.name} == {base} over all {N_BATCHES * BATCH} queries, ids and "
                "scores bit for bit")
    out["calls"] += phase_wide(params, storage, batches, results, out["paths"])
    for op in points:
        path = out["paths"][op.name]
        calls = path.pop("calls")
        hash_roles = iter(("query hash (centroids)", "query hash (bank)"))
        first = next(c for c in calls if c[0] != "lsh_hash")  # the routing call
        for call in calls:
            name, args, kw = call
            if name == "lsh_hash":
                res = time_build_call(op.name, next(hash_roles), name, args, kw, reps=50)
            else:
                role, reps, chunk = _role(name, args, kw, first=call is first)
                res = time_call(op.name, role, name, args, kw, reps=reps, chunk=chunk)
            res["launches_per_batch"] = per_batch(op.name)[list(KERNELS).index(name)]
            out["calls"].append(res)
    for name in ("Q8", "Q8-cm") if storage == "int8" else ("Q4-sk-cm",):
        traced = out["paths"][name]
        phase_trace(f"trace {name}", traced["search"], batches[1], traced["latency_ms"])
    # The graphs captured so far (one a cm schedule length) would crowd the
    # graph points' own at this size.
    graphs.release(torch.cuda.current_stream(), tensor_leaves(params))
    free()
    out["graphs"] = {
        op.name: graph_point("graphs", op.name, padded_cm_search(params, op) if op.block_q
                             else out["paths"][op.name]["search"], main["graph_batches"],
                             per_batch(op.name))
        for op in points
    }
    log("quantized", peak_line(storage, torch.cuda.max_memory_allocated(), index_nbytes(params),
                               corpus.nbytes, "host memory"))
    if storage == "int8":
        out["bulk"] = phase_bulk("quantized", "Q8", params, out["paths"]["Q8"]["search"],
                                 main["bulk_queries"], per_batch("Q8"), corpus.nbytes)
    for p in out["paths"].values():
        p.pop("search")
    del params, b
    return out


def phase_wide(params, storage: str, batches, results: dict, paths: dict) -> list[dict]:
    """The shapes the kernels once refused, on the full-width index, each
    search over all ``batches`` and held bit for bit. int8: Q8-cm at
    block_q 32 == Q8, and Q8-cm == Q8 at rescore_factor 11 (k' = 1,100).
    int4: the covering sketch factor (m = C, every candidate of the first
    pass) == the unfiltered Q4 search. The first batch's grouped or sketch
    call of each is timed as the shapes phase times a call."""
    from repro_torch.configs.lider_msmarco import CONFIG
    from repro_torch.core import lider

    cfg, k = CONFIG.lider, CONFIG.k

    def run(**kw):
        """The search over every batch, the first batch's grouped and sketch
        calls, and each kernel's launches per batch, counted in this run."""
        calls = []
        keep = lambda name, a, kw_: name in ("fused_verify_grouped", "sketch_prefilter")
        torch.cuda.synchronize()
        reset_counts()
        with recording(calls, keep):
            outs = [lider.search_lider(params, batches[0], k=k, n_probe=cfg.n_probe, r0=cfg.r0,
                                       r0_centroid=cfg.r0_centroid, **kw)]
        outs += [lider.search_lider(params, qb, k=k, n_probe=cfg.n_probe, r0=cfg.r0,
                                    r0_centroid=cfg.r0_centroid, **kw) for qb in batches[1:]]
        torch.cuda.synchronize()
        counts = dict(zip(KERNELS, read_counts()))
        per_batch = {}
        for name in ("fused_verify_grouped", "sketch_prefilter"):
            # Every batch makes batch 0's calls; a grouped call is two launches.
            want = sum(c[0] == name for c in calls) * (2 if name == "fused_verify_grouped" else 1)
            if counts[name] != want * len(batches):
                raise AssertionError(f"{kw}: {name} launched {counts[name]} times over "
                                     f"{len(batches)} batches, expected {want * len(batches)}")
            per_batch[name] = counts[name] // len(batches)
        return (torch.cat([o.ids for o in outs]), torch.cat([o.scores for o in outs])), calls, per_batch

    def held(name, got, want, base):
        if not bit_equal(got, want):
            raise AssertionError(f"{name} differs from {base}")
        log("quantized", f"{name} == {base} over all {len(batches) * BATCH} queries, ids and "
            "scores bit for bit")

    timed = []
    if storage == "int8":
        got, calls, per_batch = run(block_q=32)
        held("Q8-cm at block_q 32", got, results["Q8"], "Q8")
        timed += [("Q8-cm block_q 32", "grouped first pass", c, per_batch) for c in calls]
        want, _, _ = run(rescore_factor=11)
        got, calls, per_batch = run(rescore_factor=11, block_q=8)
        held("Q8-cm at rescore_factor 11 (k' 1,100)", got, want, "Q8 at rescore_factor 11")
        timed += [("Q8-cm k' 1,100", "grouped first pass", c, per_batch) for c in calls]
    else:
        calls = paths["Q4-sk"]["calls"]
        n_cand = next(c for c in calls if c[0] == "sketch_prefilter")[1][1].shape[1]
        kp = next(c for c in calls if c[0] == "fused_verify" and c[2].get("scales") is not None)[2]["k"]
        factor = -(-n_cand // kp)
        want, _, _ = run()
        got, calls, per_batch = run(sketch_factor=factor)
        held(f"Q4 with the covering sketch_factor {factor} (m = C = {n_cand})", got, want,
             "the unfiltered Q4 search")
        timed += [("Q4 covering sketch", "sketch pre-filter", c, per_batch) for c in calls]
    res = []
    for path, role, (name, args, kw), per_batch in timed:
        res.append(time_call(path, role, name, args, kw, reps=3 if name == "sketch_prefilter" else 10,
                             chunk=8 if name == "sketch_prefilter" else 32))
        res[-1]["launches_per_batch"] = per_batch[name]
    return res


def host_ms(fn) -> tuple:
    """(result, milliseconds) of ``fn`` on the host clock, the device
    synchronised on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def serve_search(params, q, **kw):
    from repro_torch.configs.lider_msmarco import CONFIG
    from repro_torch.core import lider

    cfg = CONFIG.lider
    return lider.search_lider(params, q, k=CONFIG.k, n_probe=cfg.n_probe, r0=cfg.r0,
                              r0_centroid=cfg.r0_centroid, **kw)


def serve_batches(params, queries, **kw):
    """``search_lider`` over ``queries`` in batches of ``BATCH``, on the host:
    the reference answers the engine is held to."""
    outs = [serve_search(params, queries[i : i + BATCH], **kw) for i in range(0, queries.shape[0], BATCH)]
    return torch.cat([o.ids for o in outs]).cpu(), torch.cat([o.scores for o in outs]).cpu()


def make_engine(params, **kw):
    """The ``SERVING`` engine (lider backend, updatable) over ``params``;
    keyword arguments go to the backend, ``engine_kw`` to the engine."""
    from repro_torch.configs.lider_msmarco import CONFIG, SERVING
    from repro_torch.serving import RetrievalEngine, make_backend

    engine_kw = kw.pop("engine_kw", {})
    cfg = CONFIG.lider
    backend = make_backend("lider", None, updatable=True, n_probe=cfg.n_probe, r0=cfg.r0, **kw)
    return RetrievalEngine(backend, batch_size=SERVING.batch, k=CONFIG.k, dim=CONFIG.dim,
                           params=params, scheduler=SERVING.scheduler, **engine_kw)


def run_engine(eng, pool_np, rids=None):
    """Submit every row of ``pool_np`` (unless ``rids`` were submitted
    already), drain, and return the answers as (ids, scores, results)."""
    if rids is None:
        rids = [eng.submit(v) for v in pool_np]
        eng.drain()
    out = [eng.result(r) for r in rids]
    if not all(hasattr(r, "ids") for r in out):
        raise AssertionError("an engine request was not answered")
    return (torch.from_numpy(np.stack([r.ids for r in out])),
            torch.from_numpy(np.stack([r.scores for r in out])), out)


def engine_line(name: str, eng) -> str:
    s = eng.stats
    fetch = (f"; host fetch {s.host_fetch_us / max(s.n_host_fetches, 1) / 1e3:.3f} ms a batch "
             f"({s.n_host_fetches} fetches; overlap dispatched-before {s.overlap_fraction:.3f}, measured "
             f"{s.measured_overlap_fraction:.3f}), gather "
             f"{s.gather_gb_per_s:.2f} GB/s, H2D {s.h2d_gb_per_s:.2f} GB/s" if s.n_host_fetches else "")
    return (f"{name}: {s.n_queries} queries in {s.n_batches} batches; AQT {s.aqt * 1e6:.3f} us, "
            f"{1 / max(s.aqt, 1e-12):.0f} queries/s; batch latency (dispatch to answers) p50 "
            f"{s.batch_latency_quantile(0.5) * 1e3:.3f} ms, p99 {s.batch_latency_quantile(0.99) * 1e3:.3f} "
            f"ms; request latency p50 {s.latency_quantile(0.5) * 1e3:.3f} ms, p99 "
            f"{s.latency_quantile(0.99) * 1e3:.3f} ms (window of the last "
            f"{len(s.recent_latency_s)})" + fetch)


def stage_split(ph, qb) -> dict:
    """Where one host-tier Q8 batch's time goes, each stage alone and
    synchronised (medians of 5): the first pass, the provisional rows'
    copy to the host, the host gather (``torch.index_select``, and numpy's
    ``take`` on the same rows, bit-equal), the rows' copy to the card from
    pinned and from pageable memory, and the rescore."""
    from repro_torch.configs.lider_msmarco import CONFIG
    from repro_torch.core import lider

    store = ph.bank.store
    d = store.shape[-1]
    prov, _ = serve_search_stage1(ph, qb)
    rows = prov.ids.cpu()
    n = rows.numel()
    pinned = torch.empty((n, d), dtype=torch.float32, pin_memory=True)
    table_np = store.rescore.numpy().reshape(-1, d)
    rows_np = np.maximum(rows.numpy().reshape(-1), 0)
    out_np = np.empty((n, d), np.float32)
    times = {key: [] for key in ("stage1", "rows_d2h", "gather_torch", "gather_numpy",
                                 "h2d_pinned", "h2d_pageable", "rescore")}
    for _ in range(5):
        (prov, _), t = host_ms(lambda: serve_search_stage1(ph, qb))
        times["stage1"].append(t)
        rows, t = host_ms(lambda: prov.ids.cpu())
        times["rows_d2h"].append(t)
        fetched, t = host_ms(lambda: store.fetch(rows, out=pinned))
        times["gather_torch"].append(t)
        _, t = host_ms(lambda: np.take(table_np, rows_np, axis=0, out=out_np))
        times["gather_numpy"].append(t)
        dev_rows, t = host_ms(lambda: fetched.to(qb.device, non_blocking=True))
        times["h2d_pinned"].append(t)
        _, t = host_ms(lambda: torch.from_numpy(out_np).to(qb.device))
        times["h2d_pageable"].append(t)
        _, t = host_ms(lambda: lider.host_rescore(ph.bank.gids, dev_rows, prov.ids, qb, k=CONFIG.k))
        times["rescore"].append(t)
    if not np.array_equal(out_np, fetched.reshape(n, d).numpy()):
        raise AssertionError("numpy take and torch.index_select gathered different rows")
    med = {key: statistics.median(v) for key, v in times.items()}
    nbytes = n * d * 4
    med["bytes"] = nbytes
    log("serve", f"one host-tier Q8 batch, each stage alone (synchronised, median of 5): first pass "
        f"{med['stage1']:.3f} ms; provisional rows to the host {med['rows_d2h']:.3f} ms; gather of "
        f"{n} rows ({nbytes / 1e6:.1f} MB) by torch.index_select {med['gather_torch']:.3f} ms "
        f"({nbytes / med['gather_torch'] / 1e6:.2f} GB/s), by numpy take {med['gather_numpy']:.3f} ms "
        f"({nbytes / med['gather_numpy'] / 1e6:.2f} GB/s; bit-equal); H2D from pinned "
        f"{med['h2d_pinned']:.3f} ms ({nbytes / med['h2d_pinned'] / 1e6:.2f} GB/s), from pageable "
        f"{med['h2d_pageable']:.3f} ms ({nbytes / med['h2d_pageable'] / 1e6:.2f} GB/s); rescore "
        f"{med['rescore']:.3f} ms; sum {sum(med[s] for s in ('stage1', 'rows_d2h', 'gather_torch', 'h2d_pinned', 'rescore')):.3f} ms")
    return med


def serve_search_stage1(ph, qb):
    from repro_torch.configs.lider_msmarco import CONFIG
    from repro_torch.core import lider

    cfg = CONFIG.lider
    return lider.host_first_pass(ph, qb, k=CONFIG.k, n_probe=cfg.n_probe, r0=cfg.r0,
                                 r0_centroid=cfg.r0_centroid)


def phase_serve_tiers(dev, main) -> dict:
    """The host rescore tier at the reference's size: the int8 and the int4
    index built on the host tier from the corpus in host memory, each
    moved to the device tier and searched there, then moved back (the move
    frees the float32 table's bytes of the card exactly), the four
    ``HOST_TIER`` points on the moved index == the device tier bit for bit;
    on int8 the captured host-tier Q8 batch, its stages and the rescore over
    fetched rows timed. One host table at a time: two and the corpus would
    pass the host's memory."""
    from repro_torch.configs.lider_msmarco import CONFIG, HOST_TIER
    from repro_torch.core import graphs, lider
    from repro_torch.core.types import tensor_leaves

    cfg, k = CONFIG.lider, CONFIG.k
    batches = [main["queries"][i * BATCH : (i + 1) * BATCH] for i in range(N_BATCHES)]
    out = {"tiers": {}}
    corpus = main["host_corpus"]
    for storage in ("int8", "int4"):
        points = [p for p in HOST_TIER if p.storage_dtype == storage]
        free()
        torch.cuda.reset_peak_memory_stats()
        log("serve", host_memory_line(f"{storage} host tier, before the build"))
        (ph, stats), t_build = host_ms(lambda: lider.build_lider(
            SEED, corpus, points[0].lider_config(cfg), device=dev, return_stats=True))
        if ph.bank.rescore_tier != "host":
            raise AssertionError(f"{storage}: the HOST_TIER build is on the {ph.bank.rescore_tier} tier")
        peak = torch.cuda.max_memory_allocated()
        m_host = torch.cuda.memory_allocated()
        log("serve", host_memory_line(f"{storage} host tier, built"))
        pd, t_dev = host_ms(lambda: lider.set_rescore_tier(ph, "device"))
        same_table(f"serve {storage} (host tier, built from the corpus in host memory)",
                   pd.bank, main["table"])
        del ph  # moved back below: two host tables and the corpus would pass the host's memory
        dev_results = {}
        for op in points:
            outs = [serve_search(pd, qb, **op.search_kwargs()) for qb in batches]
            dev_results[op.name] = (torch.cat([o.ids for o in outs]), torch.cat([o.scores for o in outs]))
        del outs
        before = pd.bank.nbytes_by_tier()
        index_bytes = index_nbytes(pd)
        graphs.release(torch.cuda.current_stream(), tensor_leaves(pd))
        free()
        m_dev = torch.cuda.memory_allocated()
        ph, t_move = host_ms(lambda: lider.set_rescore_tier(pd, "host"))
        del pd
        free()
        m1 = torch.cuda.memory_allocated()
        after = ph.bank.nbytes_by_tier()
        if m_dev - m1 != after["host"]:
            raise AssertionError(f"{storage}: the host tier freed {m_dev - m1} bytes of the card, "
                                 f"the float32 table is {after['host']}")
        log("serve", f"{storage} index built on the host tier in {t_build / 1e3:.2f} s (indexed "
            f"{stats.n_indexed}, dropped {stats.n_dropped}; then {m_host / 1e9:.3f} GB "
            f"allocated); set_rescore_tier(device) {t_dev / 1e3:.2f} s; after its searches, their "
            f"graphs freed: {m_dev / 1e9:.3f} GB allocated; set_rescore_tier(host) "
            f"{t_move / 1e3:.2f} s, the device-tier index dropped and empty_cache: {m1 / 1e9:.3f} "
            f"GB (the host tier frees {m_dev - m1} bytes == the host table's {after['host']}); "
            f"nbytes_by_tier {before} -> {after}")
        out["tiers"][storage] = {"nbytes_device": before, "nbytes_host": after,
                                 "freed_gb": (m_dev - m1) / 1e9, "to_device_s": t_dev / 1e3,
                                 "move_s": t_move / 1e3, "build_s": t_build / 1e3,
                                 "build_peak_gb": peak / 1e9}
        for op in points:
            serve_search(ph, batches[0], **op.search_kwargs())  # warm
            reset_counts()
            outs, lat = [], []
            for qb in batches:
                o, t = host_ms(lambda: serve_search(ph, qb, **op.search_kwargs()))
                outs.append(o)
                lat.append(t)
            counts = read_counts()
            want = tuple(N_BATCHES * v for v in per_batch(op.name))
            if counts != want:
                raise AssertionError(f"host-tier {op.name}: launches {counts}, expected {want}")
            got = (torch.cat([o.ids for o in outs]), torch.cat([o.scores for o in outs]))
            if not bit_equal(got, dev_results[op.name]):
                raise AssertionError(f"host-tier {op.name} differs from the device tier")
            med = statistics.median(lat)
            out["tiers"][op.name] = {"latency_ms": med}
            log("serve", f"host-tier {op.name}: {N_BATCHES} x {BATCH} queries == the device tier, "
                f"ids and scores bit for bit; launches per batch {fmt_counts(c // N_BATCHES for c in counts)}"
                f" (the device tier's); batch latency (host clock, synchronised) median {med:.3f} ms "
                f"(all {', '.join(f'{v:.3f}' for v in lat)}), {BATCH / med * 1e3:.0f} queries/s")
        if storage == "int8":
            out.update(host_q8_stages(ph, main, batches))
        log("serve", peak_line(f"serve {storage}", torch.cuda.max_memory_allocated(), index_bytes,
                               corpus.nbytes, "host memory"))
        del ph
    free()
    return out


def host_q8_stages(ph8, main, batches) -> dict:
    """On the host-tier int8 index: the captured host-tier Q8 batch
    (``graph_point``), one batch split into its stages, and the rescore
    over fetched rows timed as a kernel call, its launches counted around
    one ``host_rescore``."""
    from repro_torch.configs.lider_msmarco import CONFIG, HOST_TIER
    from repro_torch.core import lider

    k, dev = CONFIG.k, batches[0].device
    out = {"graphs": graph_point("graphs", "host Q8", lambda q: serve_search(ph8, q),
                                 main["graph_batches"], per_batch("Q8"))}
    out["split"] = stage_split(ph8, batches[0])
    calls = []
    with recording(calls, lambda name, a, kw_: name == "fused_verify" and kw_.get("scales") is None):
        serve_search(ph8, batches[0])
    torch.cuda.synchronize()
    name, args, kw_ = calls[-1]
    n_fetched = BATCH * HOST_TIER[0].rescore_factor * k  # B * k' rows (Q8)
    if args[0].shape[0] != n_fetched:
        raise AssertionError(f"the rescore's table has {args[0].shape[0]} rows, not B * k' = {n_fetched}")
    out["rescore_call"] = time_call("Q8 host", "rescore (fetched rows)", name, args, kw_, reps=20,
                                    chunk=256)
    prov, _ = serve_search_stage1(ph8, batches[0])
    fetched = lider.host_fetch(ph8, prov.ids).to(dev)
    torch.cuda.synchronize()
    reset_counts()
    lider.host_rescore(ph8.bank.gids, fetched, prov.ids, batches[0], k=k)
    torch.cuda.synchronize()
    counts = read_counts()
    fv = counts[list(KERNELS).index("fused_verify")]
    if fv == 0 or sum(counts) != fv:
        raise AssertionError(f"host_rescore launched {fmt_counts(counts)}")
    out["rescore_call"]["launches_per_batch"] = fv
    log("serve", f"host_rescore of one batch launches {fmt_counts(counts)}")
    return out


def phase_serve(dev, main) -> dict:
    """The serving engine on the int8 index of ``main``'s corpus (the
    1,048,576-row one, :func:`phase_small`), built on the host tier: one
    batch's stages, the engine closed and open loop, an update under
    serving, faults, a host-tier checkpoint."""
    from repro_torch import faults
    from repro_torch.configs.lider_msmarco import CONFIG, HOST_TIER, SERVING
    from repro_torch.core import clustering, lider, update
    from repro_torch.data import synthetic
    from repro_torch.serving import DegradePolicy, make_trace, run_open_loop
    from repro_torch.testing import uncaptured
    from repro_torch.training import checkpoint

    cfg, k = CONFIG.lider, CONFIG.k
    ph8 = lider.build_lider(SEED, main["corpus"], HOST_TIER[0].lider_config(cfg), device=dev)
    out = {"split": stage_split(ph8, main["queries"][:BATCH])}

    # 2. The engine, closed loop: 16 x 256 queries, then drain.
    n_closed = SERVING.closed_loop_batches * SERVING.batch
    pool, _ = synthetic.retrieval_queries(SEED + 11, main["corpus"], SERVING.open_loop_pool)
    pool_np = pool.cpu().numpy()
    closed = pool[:n_closed]
    want_ids, want_sc = serve_batches(ph8, closed)

    def closed_loop(params, name, **kw):
        eng = make_engine(params, **kw)
        _, t_warm = host_ms(eng.warmup)
        reset_counts()
        ids, sc, _ = run_engine(eng, pool_np[:n_closed])
        counts = read_counts()
        wid, wsc = (want_ids, want_sc) if not kw else serve_batches(params, closed, **kw)
        if not (torch.equal(ids, wid) and torch.equal(sc.view(torch.int32), wsc.view(torch.int32))):
            raise AssertionError(f"{name}: engine answers differ from search_lider")
        if min(counts[0], counts[3]) == 0:
            raise AssertionError(f"{name}: launches {counts}")
        log("serve", engine_line(name, eng) + f"; warmup {t_warm / 1e3:.2f} s (captures its graphs: "
            f"{eng.graph_bytes / 1e6:.1f} MB of pools); launches {fmt_counts(counts)}; every answer "
            "== search_lider on its batch, ids and scores bit for bit")
        return eng

    eng = closed_loop(ph8, "engine, closed loop, host-tier Q8")
    s = eng.stats
    # Overlap, measured: a fetch counts when, as its gather began, the
    # device was still running the next batch's first pass. A drain that
    # waited on the stream, or copied the rows back blocking, counts none.
    if s.n_fetches_under_device_work == 0:
        raise AssertionError(f"no host fetch ran under device work ({s.n_overlapped_fetches} of "
                             f"{s.n_host_fetches} had a next batch dispatched)")
    split = out["split"]
    serial = sum(split[key] for key in ("stage1", "rows_d2h", "gather_torch", "h2d_pinned", "rescore"))
    log("serve", f"overlap, closed loop host-tier Q8: {s.n_fetches_under_device_work} of "
        f"{s.n_host_fetches} gathers began under the next batch's first pass (measured "
        f"{s.measured_overlap_fraction:.3f}; dispatched-before {s.overlap_fraction:.3f}); "
        f"{s.aqt * SERVING.batch * 1e3:.3f} ms a batch (AQT x {SERVING.batch}) against the "
        f"serial stages' {serial:.3f} ms")
    out["closed_host"] = {"aqt_us": s.aqt * 1e6, "qps": 1 / s.aqt, "overlap": s.overlap_fraction,
                          "measured_overlap": s.measured_overlap_fraction,
                          "batch_ms": s.aqt * SERVING.batch * 1e3, "serial_ms": serial,
                          "batch_p50_ms": s.batch_latency_quantile(0.5) * 1e3,
                          "batch_p99_ms": s.batch_latency_quantile(0.99) * 1e3,
                          "fetch_ms": s.host_fetch_us / s.n_host_fetches / 1e3,
                          "gather_gbps": s.gather_gb_per_s, "h2d_gbps": s.h2d_gb_per_s}
    closed_qps = 1 / s.aqt
    eng_cm = closed_loop(ph8, "engine, closed loop, host-tier Q8-cm", block_q=8)
    if eng_cm.stats.n_host_fetches == 0:
        raise AssertionError("host-tier Q8-cm did not fetch")
    del eng_cm
    pd8 = lider.set_rescore_tier(ph8, "device")
    eng_d = closed_loop(pd8, "engine, closed loop, device-tier Q8")
    s = eng_d.stats
    out["closed_device"] = {"aqt_us": s.aqt * 1e6, "qps": 1 / s.aqt,
                            "batch_p50_ms": s.batch_latency_quantile(0.5) * 1e3,
                            "batch_p99_ms": s.batch_latency_quantile(0.99) * 1e3}
    del eng_d, pd8
    gc.collect()
    torch.cuda.empty_cache()

    # 3. The engine, open loop: Zipf arrivals at half the closed loop's rate.
    rate = SERVING.open_loop_rate_fraction * closed_qps
    trace = make_trace(seed=0, n_arrivals=SERVING.open_loop_arrivals, pool_size=SERVING.open_loop_pool,
                       mean_rate=rate, pattern=SERVING.open_loop_pattern)
    pool_ids, pool_sc = serve_batches(ph8, pool)
    eng = make_engine(ph8)
    eng.warmup()
    t0 = time.perf_counter()
    rids = run_open_loop(eng, trace, pool_np)
    wall = time.perf_counter() - t0
    ids, sc, res = run_engine(eng, None, rids)
    qidx = torch.tensor([a.query_idx for a in trace])
    if not (torch.equal(ids, pool_ids[qidx]) and torch.equal(sc.view(torch.int32), pool_sc[qidx].view(torch.int32))):
        raise AssertionError("open loop: engine answers differ from search_lider")
    lat = np.array([r.latency_s for r in res]) * 1e3
    out["open"] = {"rate_qps": rate, "p50_ms": float(np.quantile(lat, 0.5)),
                   "p99_ms": float(np.quantile(lat, 0.99)), "batches": eng.stats.n_batches,
                   "overlap": eng.stats.overlap_fraction,
                   "measured_overlap": eng.stats.measured_overlap_fraction, "wall_s": wall}
    log("serve", f"engine, open loop, host-tier Q8: {len(trace)} Zipf arrivals over a "
        f"{SERVING.open_loop_pool}-query pool at {rate:.0f} queries/s (half the closed loop's), "
        f"{wall:.2f} s; request latency p50 {out['open']['p50_ms']:.3f} ms, p99 "
        f"{out['open']['p99_ms']:.3f} ms over all {len(res)}; {eng.stats.n_batches} batches "
        f"(padding {eng.stats.padding_fraction:.3f}), overlap {eng.stats.overlap_fraction:.3f}; "
        "every answer == search_lider on its query, ids and scores bit for bit")
    del eng, pool_ids, pool_sc

    # 4. An update under serving: an index over 99% of the corpus on the
    # host tier takes an upsert of the other 1% in apply_updates.
    corpus, cen = main["corpus"], main["centroids"]
    n = corpus.shape[0]
    n_base = int(n * (1 - SERVING.held_out_fraction))
    assign, _ = clustering.assign_chunked(corpus, cen)
    cap = lider.padded_capacity(
        int(torch.bincount(assign.long(), minlength=cfg.n_clusters).max()), None, cfg.pad_multiple)
    fcfg = dataclasses.replace(cfg, storage_dtype="int8", capacity=cap)
    pd99 = lider.build_lider(SEED, corpus[:n_base], fcfg, centroids=cen, device=dev)
    eng = make_engine(lider.set_rescore_tier(pd99, "host"))
    eng.warmup()
    run_engine(eng, pool_np[:BATCH])
    upsert = lambda p: update.upsert(p, corpus[n_base:], pad_multiple=cfg.pad_multiple, route="exact")
    grew, t_up = host_ms(lambda: eng.apply_updates(upsert))
    if grew or eng.recompiles != 0 or eng.host_generation != 1 or eng.device_generation != 1:
        raise AssertionError(f"update under serving: grew {grew}, recompiles {eng.recompiles}, "
                             f"generations host {eng.host_generation} device {eng.device_generation}")
    reset_counts()
    ids, sc, _ = run_engine(eng, main["queries"].cpu().numpy())
    counts = read_counts()
    pd_up, _ = upsert(pd99)
    want = serve_batches(pd_up, main["queries"])
    with uncaptured():
        want_plain = serve_batches(pd_up, main["queries"])
    if not bit_equal((ids, sc), want) or not bit_equal(want, want_plain):
        raise AssertionError("after the update, the host-tier engine differs from the device tier")
    out["update"] = {"apply_s": t_up / 1e3, "n_upserted": n - n_base,
                     "recapture_s": eng.recapture_s, "graph_bytes": eng.graph_bytes}
    log("serve", f"update under serving: int8 index over {n_base} passages (capacity Lp={cap} from "
        f"the full assignment) on the host tier; apply_updates(upsert of the other {n - n_base}) "
        f"{t_up / 1e3:.3f} s: no growth, recompiles 0, host generation 1, device generation 1; "
        f"its graphs captured again on the new leaves before they were served in "
        f"{eng.recapture_s:.3f} s ({eng.graph_bytes / 1e6:.1f} MB of pools after the superseded "
        f"ones were freed); {N_BATCHES} batches served after it == a device-tier copy given the "
        f"same upsert, captured and uncaptured, ids and scores bit for bit; launches "
        f"{fmt_counts(counts)}")
    del eng, pd99, pd_up
    gc.collect()
    torch.cuda.empty_cache()

    # 5. Faults: one failed host fetch is retried; exhausted retries answer
    # compressed-only.
    qb = pool[:BATCH]
    for times_, degraded in (((0,), False), ((0, 1, 2), True)):
        plan = faults.FaultPlan([faults.FaultSpec("host_fetch", mode="error", times=times_)])
        eng = make_engine(ph8, engine_kw=dict(
            fault_plan=plan, policy=DegradePolicy(fetch_retries=2, fetch_backoff_s=0.0)))
        eng.warmup()
        ids, sc, res = run_engine(eng, pool_np[:BATCH])
        if degraded:
            prov, _ = serve_search_stage1(ph8, qb)
            want = lider.compressed_only_topk(ph8.bank.gids, prov, k=k)
            want = (want.ids.cpu(), want.scores.cpu())
        else:
            want = (want_ids[:BATCH], want_sc[:BATCH])
        if not (all(r.degraded == degraded for r in res) and bit_equal((ids, sc), want)):
            raise AssertionError(f"fault plan {times_}: answers differ")
        log("serve", f"faults: host fetch failing at calls {times_}: {eng.stats.n_fetch_retries} "
            f"retries, {eng.stats.n_fetch_failures} failures; answers "
            + ("compressed-only (degraded) == compressed_only_topk" if degraded else
               "unchanged == search_lider") + ", ids and scores bit for bit")
        del eng

    # 6. A host-tier checkpoint at full width, loaded on both tiers.
    d = ROOT / "build" / "serve_index"
    shutil.rmtree(d, ignore_errors=True)
    _, t_save = host_ms(lambda: checkpoint.save_index(str(d), ph8))
    size = sum(f.stat().st_size for f in (d / "index").iterdir())
    want = dict(checkpoint.index_leaves(ph8))
    want_search = serve_batches(ph8, main["queries"])
    loads = {}
    for tier in ("host", "device"):
        loaded, t_load = host_ms(lambda: checkpoint.load_index(str(d), device=dev, rescore_tier=tier))
        got = dict(checkpoint.index_leaves(loaded))
        bad = [n_ for n_ in want if n_ not in got or not same_bits(want[n_].to(got[n_].device), got[n_])]
        if bad or set(got) != set(want) or loaded.bank.rescore_tier != tier:
            raise AssertionError(f"host-tier checkpoint loaded on the {tier} tier: leaves {bad} differ")
        if not bit_equal(serve_batches(loaded, main["queries"]), want_search):
            raise AssertionError(f"host-tier checkpoint loaded on the {tier} tier: search differs")
        loads[tier] = t_load / 1e3
        del loaded, got
        gc.collect()
        torch.cuda.empty_cache()
    shutil.rmtree(d, ignore_errors=True)
    out["checkpoint"] = {"save_s": t_save / 1e3, "load_s": loads, "gb": size / 1e9}
    log("serve", f"host-tier int8 checkpoint: save_index {t_save / 1e3:.2f} s "
        f"({size / 1e9:.2f} GB on disk); load_index as host {loads['host']:.2f} s, as device "
        f"{loads['device']:.2f} s; all {len(want)} leaves identical and search ids and scores "
        "identical on both tiers")
    # The fabric phase serves the same index and queries.
    out["fabric_input"] = {"index": ph8, "pool": pool, "want": (want_ids, want_sc)}
    return out


def serve_closed(server, pool_np, *, max_dispatches=None):
    """Submit every row of ``pool_np``, drain the server (an engine or a
    router) until nothing is queued, and collect: (answers, wall seconds)."""
    t0 = time.perf_counter()
    rids = [server.submit(v) for v in pool_np]
    while server.pending_requests:
        server.drain(max_dispatches=max_dispatches)
    wall = time.perf_counter() - t0
    return [server.result(r) for r in rids], wall


def answers_equal(res, want, rows=None) -> bool:
    """Every answer is a ``QueryResult`` whose ids and scores equal row i
    of ``want`` (or row ``rows[i]``), bit for bit."""
    from repro_torch.serving import QueryResult

    if not all(isinstance(r, QueryResult) for r in res):
        return False
    ids = torch.from_numpy(np.stack([r.ids for r in res]))
    sc = torch.from_numpy(np.stack([r.scores for r in res]))
    wi, ws = want
    if rows is not None:
        wi, ws = wi[rows], ws[rows]
    return bit_equal((ids, sc), (wi, ws))


def fleet_line(name: str, res, wall: float, stats) -> str:
    lat = np.array([r.latency_s for r in res if hasattr(r, "latency_s")]) * 1e3
    return (f"{name}: {len(res)} queries in {wall:.3f} s, {len(res) / wall:.0f} queries/s; request "
            f"latency p50 {np.quantile(lat, 0.5):.3f} ms, p99 {np.quantile(lat, 0.99):.3f} ms; "
            f"availability {getattr(stats, 'availability', 1.0):.4f}")


def phase_fabric(dev, main, fabric_input) -> dict:
    """The replica fabric at full width: a ``QueryRouter`` over two replicas
    of the serve phase's host-tier int8 index (replica 1 a ``clone_params``:
    device leaves shared, the host store copied) on one card, each replica
    on its engine's own stream. Gates: the closed loop through the router ==
    one engine == ``search_lider``, bit for bit, with the launches of that
    many batches counted across the pool threads; a replica killed
    mid-trace (every request answered or shed, answers bit-equal, the
    killed replica never serving again); a straggling replica hedged (some
    hedge wins, answers bit-equal); a rolling 1% upsert through
    ``RouterControl.apply_updates`` (nothing shed, every answer == a fresh
    search at its generation, launches per batch as the device tier's)."""
    from repro_torch import faults
    from repro_torch.configs.lider_msmarco import CONFIG, SERVING
    from repro_torch.core import clustering, lider, update
    from repro_torch.serving import QueryRouter, RouterConfig, Shed, clone_params

    ph8, pool, want = fabric_input["index"], fabric_input["pool"], fabric_input["want"]
    n_closed = SERVING.closed_loop_batches * SERVING.batch
    pool_np = pool[:n_closed].cpu().numpy()
    q8 = per_batch("Q8")
    out = {}
    gc.collect()
    clone, t_clone = host_ms(lambda: clone_params(ph8))
    if clone.bank.store is ph8.bank.store or clone.bank.gids is not ph8.bank.gids:
        raise AssertionError("clone_params must copy the host store and share the device leaves")
    log("fabric", f"clone_params of the host-tier int8 index: {t_clone / 1e3:.2f} s, "
        f"{clone.bank.store.nbytes / 1e9:.3f} GB of host memory copied, device leaves shared")
    e0, e1 = make_engine(ph8), make_engine(clone)

    def router(**kw):
        r = QueryRouter([e0, e1], scheduler=SERVING.scheduler, **kw)
        r.warmup()
        return r

    # 1. One engine, then the router (no hedging: every batch dispatched
    # once), over the same closed loop; launches counted across the threads.
    single = make_engine(ph8)
    single.warmup()
    reset_counts()
    res, wall = serve_closed(single, pool_np)
    counts1 = read_counts()
    if not answers_equal(res, want):
        raise AssertionError("fabric: one engine's answers differ from search_lider")
    line1 = fleet_line("one engine (pipelined drain)", res, wall, None)
    out["single"] = {"qps": len(res) / wall, "wall_s": wall}
    out["single"].update(p50_ms=single.stats.latency_quantile(0.5) * 1e3,
                         p99_ms=single.stats.latency_quantile(0.99) * 1e3)
    del single
    r = router(config=RouterConfig(hedge_quantile=None))
    reset_counts()
    res, wall = serve_closed(r, pool_np)
    counts = read_counts()
    r.close()
    n_b = SERVING.closed_loop_batches
    if counts != counts1 or counts != tuple(n_b * v for v in q8):
        raise AssertionError(f"fabric: router launches {counts}, one engine {counts1}, expected "
                             f"{tuple(n_b * v for v in q8)}")
    if not answers_equal(res, want) or {a.replica for a in res} != {"r0", "r1"}:
        raise AssertionError("fabric: the router's answers differ from one engine's")
    rs = r.stats
    out["router"] = {"qps": len(res) / wall, "wall_s": wall, "p50_ms": rs.latency_quantile(0.5) * 1e3,
                     "p99_ms": rs.latency_quantile(0.99) * 1e3, "availability": rs.availability}
    log("fabric", line1 + f"; launches {fmt_counts(counts1)}")
    log("fabric", fleet_line("router over 2 replicas (no hedging)", res, wall, rs)
        + f"; launches {fmt_counts(counts)} across the pool threads ({n_b} x {q8}, as one engine); "
        f"every answer == one engine's == search_lider, ids and scores bit for bit; batches per "
        f"replica r0 {r.replicas.get('r0').n_dispatches}, r1 {r.replicas.get('r1').n_dispatches}")

    # 2. A replica killed mid-trace (at the fourth drain call, one batch a call).
    plan = faults.FaultPlan([faults.FaultSpec("replica_kill", mode="kill_replica", times=(3,),
                                              payload={"replica": "r1"})])
    r = router(fault_plan=plan)
    res, wall = serve_closed(r, pool_np, max_dispatches=1)
    r.close()
    r1 = r.replicas.get("r1")
    answered = [i for i, a in enumerate(res) if not isinstance(a, Shed)]
    late = [i for i in answered if res[i].replica == "r1" and i >= 3 * SERVING.batch]
    if (r.stats.n_replica_kills != 1 or not (r1.killed and r1.state == "dead") or late
            or not all(hasattr(a, "ids") or isinstance(a, Shed) for a in res)
            or not answers_equal([res[i] for i in answered], want, answered)):
        raise AssertionError(f"fabric: replica kill: kills {r.stats.n_replica_kills}, r1 state "
                             f"{r1.state}, answers by r1 after the kill {len(late)}")
    out["kill"] = {"answered": len(answered), "shed": len(res) - len(answered),
                   "availability": r.stats.availability}
    log("fabric", f"replica_kill of r1 at the 4th drain call: {len(answered)} of {len(res)} "
        f"requests answered, {len(res) - len(answered)} shed structurally; failovers "
        f"{r.stats.n_failovers}; every answer bit-equal; r1 dead, never reprobed, served nothing "
        f"after the kill; " + fleet_line("router", res, wall, r.stats))

    # 3. A straggling replica, hedged at the 0.95 quantile of batch times,
    # with the deadline's floor at half the straggle, so that only a
    # straggled dispatch is hedged. At the default floor the quantile of the
    # first dozen batches is about their largest, so a batch only a little
    # slow was hedged too; when that hedge went to r0 inside the straggle
    # window, r0 straggled as the hedge, lost, and stayed busy while the
    # rest of the window went to r1: no straggled primary, no hedge won.
    plan = faults.FaultPlan([faults.FaultSpec(
        "replica_dispatch", mode="straggle", times=tuple(range(16, 26)), delay_s=0.3,
        payload={"replica": "r0"})])
    r = router(config=RouterConfig(hedge_quantile=0.95, hedge_floor_s=0.15), fault_plan=plan)
    res, wall = serve_closed(r, np.concatenate([pool_np, pool_np]))
    r.close()
    rs = r.stats
    if rs.n_hedge_wins < 1 or not answers_equal(res, (torch.cat([want[0]] * 2), torch.cat([want[1]] * 2))):
        raise AssertionError(f"fabric: straggle: hedges {rs.n_hedges}, wins {rs.n_hedge_wins}")
    out["hedge"] = {"hedges": rs.n_hedges, "wins": rs.n_hedge_wins, "losses": rs.n_hedge_losses,
                    "p99_ms": rs.latency_quantile(0.99) * 1e3}
    log("fabric", f"straggle of 0.3 s on r0 at dispatches 16-25, hedge_quantile 0.95, floor 0.15 s: "
        f"{rs.n_hedges} hedges, {rs.n_hedge_wins} won, {rs.n_hedge_losses} lost; every answer "
        "bit-equal; " + fleet_line("router", res, wall, rs))
    del e0, e1, r, clone, ph8, fabric_input["index"]
    gc.collect()
    torch.cuda.empty_cache()

    # 4. A rolling 1% upsert under traffic (the serve phase's update scenario).
    cfg = CONFIG.lider
    corpus, cen = main["corpus"], main["centroids"]
    n = corpus.shape[0]
    n_base = int(n * (1 - SERVING.held_out_fraction))
    assign, _ = clustering.assign_chunked(corpus, cen)
    cap = lider.padded_capacity(
        int(torch.bincount(assign.long(), minlength=cfg.n_clusters).max()), None, cfg.pad_multiple)
    pd99 = lider.build_lider(SEED, corpus[:n_base], dataclasses.replace(
        cfg, storage_dtype="int8", capacity=cap), centroids=cen, device=dev)
    upsert = lambda p: update.upsert(p, corpus[n_base:], pad_multiple=cfg.pad_multiple, route="exact")
    pool_t = pool[:n_closed]
    gens = {0: serve_batches(pd99, pool_t)}
    pd_up, _ = upsert(pd99)
    gens[1] = serve_batches(pd_up, pool_t)
    del pd_up
    ph99 = lider.set_rescore_tier(pd99, "host")
    del pd99
    r = QueryRouter([make_engine(ph99), make_engine(clone_params(ph99))],
                    config=RouterConfig(hedge_quantile=None), scheduler=SERVING.scheduler)
    r.warmup()
    half = n_closed // 2
    rids = [r.submit(v) for v in pool_np[:half]]
    t0 = time.perf_counter()
    r.control.apply_updates(upsert, block=False)
    rids += [r.submit(v) for v in pool_np[half:]]
    while r.pending_requests:
        r.drain()
    r.control.wait(timeout=600.0)
    t_roll = time.perf_counter() - t0
    res = [r.result(i) for i in rids]
    by_gen = {g: [i for i, a in enumerate(res) if getattr(a, "generation", None) == g] for g in gens}
    ok = (all(hasattr(a, "ids") for a in res) and r.stats.n_shed == 0
          and sum(len(v) for v in by_gen.values()) == len(res)
          and all(answers_equal([res[i] for i in v], gens[g], v) for g, v in by_gen.items() if v))
    if (not ok or r.stats.n_rolls_completed != 1 or r.stats.n_roll_replicas_updated != 2
            or r.generation_window() != (1, 1) or r.stats.n_wrong_generation):
        raise AssertionError(f"fabric: rolling update: {r.stats_dict()}")
    reset_counts()
    res2, _ = serve_closed(r, pool_np)
    counts = read_counts()
    r.close()
    if counts != tuple(n_b * v for v in q8) or not answers_equal(res2, gens[1]):
        raise AssertionError(f"fabric: after the roll, launches {counts} or answers differ")
    out["roll"] = {"seconds": t_roll, "gen0": len(by_gen[0]), "gen1": len(by_gen[1])}
    log("fabric", f"rolling upsert of {n - n_base} passages under traffic in {t_roll:.3f} s: "
        f"{len(by_gen[0])} answers at generation 0 and {len(by_gen[1])} at generation 1, each == "
        f"a fresh search_lider at its generation, ids and scores bit for bit; none shed, wrong "
        f"generation 0, window (1, 1); after it {n_b} batches launched {fmt_counts(counts)} "
        f"({q8} a batch, the device tier's)")
    del r, ph99
    gc.collect()
    torch.cuda.empty_cache()
    return out


# The serve CLI's runs at the lider-msmarco widths, in the order run.
CLI_COMMON = ["--corpus-size", "1048576", "--dim", "768", "--n-clusters", "1024", "--n-probe", "20",
              "--batch-size", "256", "--k", "100", "--queries", "4096"]
CLI_RUNS = [  # (name, backend flags, recall@100 floor)
    ("lider-int8-host-x2", ["--backend", "lider", "--storage-dtype", "int8", "--rescore-tier", "host",
                            "--replicas", "2", "--rolling-update", "--update-fraction", "0.01",
                            "--recall-target", "0.6"], RECALL_FLOOR),
    ("lider-int4-sk-cm", ["--backend", "lider", "--storage-dtype", "int4", "--sketch-factor", "4",
                          "--block-q", "8"], RECALL_FLOOR),
    ("flat", ["--backend", "flat"], 1.0),
    # The baselines' floor only catches garbage: random answers give k/N = 1e-4.
    ("pq", ["--backend", "pq"], 0.01),
    ("ivfpq", ["--backend", "ivfpq"], 0.01),
    ("sklsh", ["--backend", "sklsh"], 0.01),
    ("mplsh", ["--backend", "mplsh"], 0.01),
]


def cli_launches(name: str) -> tuple | None:
    """Launches of a baseline's CLI run, from the code (KERNELS order):
    PQ trains 8 sub-space codebooks (15 Lloyd steps and a final assignment
    each) and encodes 8 sub-spaces; IVF-PQ adds the coarse k-means (16
    calls); SK-LSH and MP-LSH hash the corpus once, the warm-up batch once
    and each of the 16 batches once. ``kmeans_assign`` is two launches a
    call. None: a LIDER run, whose reached kernels must be non-zero."""
    from repro_torch.kernels.kmeans_assign import LAUNCHES_PER_CALL as KM

    pq_calls = 8 * 16 + 8
    return {"flat": (0, 0, 0, 0, 0), "pq": (0, 0, 0, 0, KM * pq_calls),
            "ivfpq": (0, 0, 0, 0, KM * (16 + pq_calls)),
            "sklsh": (0, 0, 0, hash_launches(18), 0),
            "mplsh": (0, 0, 0, hash_launches(18), 0)}.get(name)


def cli_role(name: str, args, kw, backend: str) -> str | None:
    """The role of a build-kernel call of a baseline run, for the shapes
    timed after it (None: not kept)."""
    if backend == "pq" and name == "kmeans_assign":
        return "PQ sub-space k-means step"
    if backend == "ivfpq" and name == "kmeans_assign":
        # The residual sub-spaces have 2**8 codewords; the coarse lists sqrt(N).
        return "IVF-PQ residual sub-space step" if args[1].shape[0] == 256 else "IVF-PQ coarse k-means step"
    if backend == "sklsh" and name == "lsh_hash":  # MP-LSH hashes at the same shapes
        return f"SK-LSH {'corpus hash' if args[0].shape[0] > 4096 else 'query hash'}"
    return None


def lloyd_stages(g, x, n_clusters: int, iters: int = 15) -> dict:
    """``clustering.kmeans``'s Lloyd steps one by one, each stage
    synchronised and timed on the host clock (ms): the assignment
    (``kmeans_assign``), the fixed-order sums, the counts, the update; and
    each step's largest cluster (the fixed-order sums add a cluster's rows
    one after another)."""
    from repro_torch.core import clustering

    cen = clustering.init_centroids(g, x, n_clusters)
    rows = {"assign": [], "sums": [], "counts": [], "update": [], "largest": []}
    for _ in range(iters + 1):
        (a, _), t = host_ms(lambda: clustering.assign_chunked(x, cen))
        rows["assign"].append(t)
        idx = a.to(torch.int64)
        sums, t = host_ms(lambda: clustering.cluster_sums(x, idx, n_clusters))
        rows["sums"].append(t)
        counts, t = host_ms(lambda: torch.bincount(idx, minlength=n_clusters).to(torch.float32))
        rows["counts"].append(t)
        rows["largest"].append(int(counts.max()))
        cen, t = host_ms(lambda: clustering.update_centroids(cen, sums, counts))
        rows["update"].append(t)
    return rows


def ivfpq_build_split(corpus) -> dict:
    """Where IVF-PQ's build goes (the CLI's corpus, seed 0): the coarse
    k-means (c = 1,024, d = 768) and one residual sub-space k-means (c =
    256, the first d = 96 column slice), stage by stage."""
    from repro_torch.core import clustering

    g = torch.Generator(device=corpus.device).manual_seed(SEED)
    km = clustering.kmeans(g, corpus, 1024, iters=15)
    res = corpus - km.centroids[km.assignment.to(torch.int64)]
    out = {}
    for name, x, c in (("coarse k-means (c=1024, d=768)", corpus, 1024),
                       ("residual sub-space k-means (c=256, d=96 column slice)", res[:, :96], 256)):
        rows = lloyd_stages(g, x, c)
        tot = {k: sum(v) for k, v in rows.items() if k != "largest"}
        log("cli", f"IVF-PQ build, {name}: 16 Lloyd steps {sum(tot.values()):.1f} ms: assignment "
            f"{tot['assign']:.1f}, fixed-order sums {tot['sums']:.1f}, counts {tot['counts']:.1f}, "
            f"update {tot['update']:.1f} ms; largest cluster by step "
            f"{', '.join(str(v) for v in rows['largest'])} of {x.shape[0]} rows")
        out[name] = {**tot, "largest": rows["largest"]}
    return out


def phase_cli(dev, corpus) -> dict:
    """``repro_torch.launch.serve.main`` in this process at the
    lider-msmarco widths: LIDER on the host tier through a router over two
    replicas with a rolling 1% upsert and an autotuned point; LIDER int4
    with the sketch pass and the cluster-major schedule; then Flat, PQ,
    IVF-PQ, SK-LSH and MP-LSH, all at N = 1,048,576. Gates: every run
    answers every query, recall@100 over its floor (Flat: 1.0), launches
    counted per run (exact for the baselines). The first call of each of
    the baselines' kernel shapes is kept, then held against its plain
    version and timed beside its bound (:func:`time_build_call`)."""
    from repro_torch.launch import serve

    out, shapes = {}, []
    for name, flags, floor in CLI_RUNS:
        backend = flags[1]
        seen, calls = set(), []

        def keep(kname, args, kw, backend=backend):
            role = cli_role(kname, args, kw, backend)
            if role is None or role in seen:
                return False
            seen.add(role)
            return True

        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        with recording(calls, keep):
            rec = serve.main(CLI_COMMON + flags)
        wall = time.perf_counter() - t0
        counts = read_counts()
        want = cli_launches(name)
        reached = [k for k, c in zip(KERNELS, counts) if c]
        if rec["n_answered"] != 4096 or rec["n_shed"] or rec["recall_at_k"] < floor:
            raise AssertionError(f"cli {name}: answered {rec['n_answered']}, shed {rec['n_shed']}, "
                                 f"recall {rec['recall_at_k']} (floor {floor})")
        if floor == 1.0 and rec["recall_at_k"] != 1.0:
            raise AssertionError(f"cli {name}: recall {rec['recall_at_k']}, not 1.0")
        if want is not None and counts != want:
            raise AssertionError(f"cli {name}: launches {counts}, expected {want}")
        if want is None and not ({"fused_verify", "lsh_hash", "kmeans_assign"} <= set(reached)):
            raise AssertionError(f"cli {name}: kernels reached {reached}")
        if name == "lider-int4-sk-cm" and not {"sketch_prefilter", "fused_verify_grouped"} <= set(reached):
            raise AssertionError(f"cli {name}: kernels reached {reached}")
        router = rec["router"]
        extra = ""
        if router is not None:
            if (router["availability"] != 1.0 or router["n_roll_replicas_updated"] != 2
                    or router["generation_window"] != [1, 1] or router["n_wrong_generation"]):
                raise AssertionError(f"cli {name}: router {router}")
            extra = (f"; router availability {router['availability']:.4f}, request p50 "
                     f"{router['p50_s'] * 1e3:.3f} ms, p99 {router['p99_s'] * 1e3:.3f} ms, rolling "
                     f"upsert over {router['n_roll_replicas_updated']} replicas, generation window "
                     f"{router['generation_window']}")
        if rec["selected"] is not None:
            sel = rec["selected"]
            extra += (f"; autotuned n_probe {sel['n_probe']}, prune_margin {sel['prune_margin']} "
                      f"(held-out recall {sel['recall']:.4f}, AQT {sel['aqt_s'] * 1e6:.1f} us)")
        out[name] = {"build_s": rec["build_s"], "aqt_us": rec["aqt_s"] * 1e6,
                     "recall": rec["recall_at_k"], "wall_s": wall, "launches": counts,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        log("cli", f"{name}: build {rec['build_s']:.2f} s, {rec['n_queries']} queries, AQT "
            f"{rec['aqt_s'] * 1e6:.3f} us, recall@100 vs Flat {rec['recall_at_k']:.4f} (floor "
            f"{floor}); whole run {wall:.1f} s, peak device memory "
            f"{out[name]['peak_gib']:.2f} GiB; launches {fmt_counts(counts)}"
            + (" (as the code predicts)" if want is not None else "") + extra)
        for kname, args, kw in calls:
            role = cli_role(kname, args, kw, backend)
            shapes.append(time_build_call(f"cli {name}", role, kname, args, kw, reps=5))
        del rec, calls
    out["shapes"] = shapes
    out["ivfpq_split"] = ivfpq_build_split(corpus)
    return out


LIFE_BANK = ("sorted_keys", "sorted_pos", "gids", "sizes", "embs", "next_gid")
QUANT_BANK = ("emb_scales", "rescore_embs", "sketches")


def same_bits(a, b) -> bool:
    if a is None or b is None:
        return a is b
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        view = {4: torch.int32, 2: torch.int16}[a.element_size()]
        a, b = a.view(view), b.view(view)
    return torch.equal(a, b)


def mismatched(a, b, fields) -> list[str]:
    return [f for f in fields if not same_bits(getattr(a, f), getattr(b, f))]


def fit_leaves_equal(a, b) -> tuple[int, int]:
    """(fit leaves bit-equal, fit leaves) of two banks: rescale and RMI."""
    pairs = [(getattr(a.rescale, f), getattr(b.rescale, f)) for f in ("key_min", "key_max", "length")]
    pairs += [(getattr(a.rmi, f), getattr(b.rmi, f))
              for f in ("root_w", "root_b", "leaf_w", "leaf_b", "length", "max_err")]
    return sum(same_bits(x, y) for x, y in pairs), len(pairs)


def search_all(params, queries, cfg, k):
    from repro_torch.core import lider

    outs = [lider.search_lider(params, queries[i : i + BATCH], k=k, n_probe=cfg.n_probe,
                               r0=cfg.r0, r0_centroid=cfg.r0_centroid)
            for i in range(0, queries.shape[0], BATCH)]
    return torch.cat([o.ids for o in outs]), torch.cat([o.scores for o in outs])


def phase_lifecycle(dev, main) -> dict:
    """``LIFECYCLE`` at full width: upsert == frozen rebuild, compaction ==
    rebuild over the survivors, deleted ids absent, save/load identical."""
    from repro_torch.configs.lider_msmarco import CONFIG, LIFECYCLE as L
    from repro_torch.core import bank as bank_lib
    from repro_torch.core import clustering, lider, update
    from repro_torch.kernels.kmeans_assign import LAUNCHES_PER_CALL
    from repro_torch.training import checkpoint

    cfg, k = CONFIG.lider, CONFIG.k
    corpus, queries, cen = main["corpus"], main["queries"], main["centroids"]
    n = corpus.shape[0]
    chunks = lambda m: math.ceil(m / bank_lib._FIT_CHUNK)
    torch.cuda.reset_peak_memory_stats()
    assign, _ = clustering.assign_chunked(corpus, cen)
    cap = lider.padded_capacity(
        int(torch.bincount(assign.long(), minlength=cfg.n_clusters).max()), None, cfg.pad_multiple)
    fcfg = dataclasses.replace(cfg, capacity=cap)
    n_base = int(n * (1 - L.update_fraction))
    log("lifecycle", f"{L}: corpus {n} x {corpus.shape[1]}, main-path centroids frozen, capacity "
        f"Lp={cap} from the full assignment; base {n_base} passages")
    base = build_counted("lifecycle", dev, corpus[:n_base], fcfg, centroids=cen)
    up, t_base = base.params, base.secs
    del base

    rates, t_up = [], []
    for i, part in enumerate(torch.tensor_split(corpus[n_base:], L.upsert_batches)):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        up, st = update.upsert(up, part, pad_multiple=cfg.pad_multiple, route=L.route)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = read_counts()
        want = (0, 0, 0, hash_launches(chunks(st.n_refit)), LAUNCHES_PER_CALL)
        if counts != want or st.capacity_grew or st.n_added != part.shape[0]:
            raise AssertionError(f"upsert batch {i}: launches {counts} (expected {want}), {st}")
        t_up.append(dt)
        rates.append(part.shape[0] / dt)
        log("lifecycle", f"upsert batch {i}: {part.shape[0]} passages in {dt:.3f} s = "
            f"{rates[-1]:.0f} passages/s; {st.n_refit} clusters refit; launches {fmt_counts(counts)}")
    rebuilt = build_counted("lifecycle", dev, corpus, fcfg, centroids=cen)
    full, t_full = rebuilt.params, rebuilt.secs
    del rebuilt
    bad = mismatched(up.bank, full.bank, LIFE_BANK)
    if bad:
        raise AssertionError(f"upserted bank differs from the frozen rebuild in {bad}")
    fit_eq = fit_leaves_equal(up.bank, full.bank)
    ids_up, sc_up = search_all(up, queries, cfg, k)
    ids_full, sc_full = search_all(full, queries, cfg, k)
    if not torch.equal(ids_up, ids_full):
        raise AssertionError(f"search ids differ on {int((ids_up != ids_full).any(1).sum())} queries")
    log("lifecycle", f"base build {t_base:.2f} s, upserts {sum(t_up):.3f} s in all, frozen rebuild "
        f"over 100% {t_full:.2f} s: bank {', '.join(LIFE_BANK)} equal bit for bit; fit leaves "
        f"(rescale, RMI) {fit_eq[0]} of {fit_eq[1]} bit-equal; search ids on {ids_up.shape[0]} "
        f"queries equal (scores bit-equal: {same_bits(sc_up, sc_full)})")
    del full

    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    dead = torch.sort(torch.randperm(n, generator=g, device=dev)[: int(n * L.delete_fraction)]).values
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    deleted, dst = update.delete(up, dead, refit_threshold=L.refit_threshold)
    torch.cuda.synchronize()
    t_delete = time.perf_counter() - t0
    counts = read_counts()
    if counts != (0, 0, 0, hash_launches(chunks(dst.n_refit)), 0) or dst.n_deleted != dead.numel():
        raise AssertionError(f"delete: launches {counts}, {dst}")
    del up
    ids_del, _ = search_all(deleted, queries, cfg, k)
    if bool(torch.isin(ids_del, dead.to(ids_del.dtype)).any()):
        raise AssertionError("a deleted id surfaced")
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    alive[dead] = False
    surv = torch.nonzero(alive)[:, 0]
    rebuilt = build_counted("lifecycle", dev, corpus[surv], fcfg, centroids=cen).params
    rb = rebuilt.bank
    mapped = torch.where(rb.gids >= 0, surv[rb.gids.clamp(min=0).long()].to(torch.int32), -1)
    # Rows compare by value: a fresh pack zeroes its pad slots by a multiply
    # (-0.0 where corpus row 0 is negative), compaction by a select (+0.0),
    # as in the JAX package; every other field compares bit for bit.
    bad = [f for f in ("sorted_keys", "sorted_pos", "sizes")
           if not same_bits(getattr(deleted.bank, f), getattr(rb, f))]
    bad += [] if torch.equal(deleted.bank.embs, rb.embs) else ["embs"]
    if bad or not torch.equal(deleted.bank.gids, mapped) or int(deleted.bank.tombstones.sum()):
        raise AssertionError(f"compacted bank differs from the rebuild over the survivors: {bad}")
    ids_rb, _ = search_all(rebuilt, queries, cfg, k)
    ids_rb = torch.where(ids_rb >= 0, surv[ids_rb.clamp(min=0).long()].to(torch.int32), -1)
    if not torch.equal(ids_del, ids_rb):
        raise AssertionError("search after compaction differs from the rebuild over the survivors")
    fit_eq = fit_leaves_equal(deleted.bank, rb)
    log("lifecycle", f"delete {dead.numel()} ids ({L.delete_fraction:.0%}, refit_threshold "
        f"{L.refit_threshold}): {t_delete:.3f} s with {dst.n_refit} clusters compacted and refit; "
        f"launches {fmt_counts(counts)}; no deleted id in {ids_del.shape[0]} searches; bank equals "
        f"a frozen rebuild over the {surv.numel()} survivors (keys, positions, sizes bit for bit, "
        f"rows in value, gids mapped back; fit leaves "
        f"{fit_eq[0]} of {fit_eq[1]} bit-equal), search ids equal")
    del rebuilt, rb

    d = ROOT / "build" / "lifecycle_index"
    shutil.rmtree(d, ignore_errors=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.save_index(str(d), deleted)
    t_save = time.perf_counter() - t0
    size = sum(f.stat().st_size for f in (d / "index").iterdir())
    t0 = time.perf_counter()
    loaded = checkpoint.load_index(str(d), device=dev)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    leaves = checkpoint.index_leaves(deleted)
    bad = [name for (name, a), (_, b) in zip(leaves, checkpoint.index_leaves(loaded))
           if not same_bits(a, b)]
    ids_ld, _ = search_all(loaded, queries, cfg, k)
    if bad or not torch.equal(ids_ld, ids_del):
        raise AssertionError(f"save/load changed leaves {bad} or the search ids")
    shutil.rmtree(d, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log("lifecycle", f"save_index {t_save:.2f} s ({size / 1e9:.2f} GB on disk), load_index "
        f"{t_load:.2f} s: all {len(leaves)} leaves identical, search ids identical; peak device "
        f"memory of the phase {peak:.2f} GiB")
    del loaded, deleted
    small = phase_lifecycle_small(dev)
    return {"upsert_per_s": rates, "upsert_s": t_up, "delete_s": t_delete, "save_s": t_save,
            "load_s": t_load, "peak_gib": peak, "small": small, "save_gb": size / 1e9}


def phase_lifecycle_small(dev) -> list[str]:
    """Small int8 and int4 indexes (20,000 x 768, c=64): build(80%) +
    upsert(20%, two batches) == a frozen rebuild over 100%, bit for bit."""
    from repro_torch.core import clustering, lider, update
    from repro_torch.data import synthetic

    x = synthetic.retrieval_corpus(SEED + 5, 20_000, 768, device=dev)
    q, _ = synthetic.retrieval_queries(SEED + 6, x, 64)
    n_base = 16_000
    km = clustering.kmeans(torch.Generator(device=dev).manual_seed(SEED), x[:n_base], 64, iters=10)
    assign, _ = clustering.assign_chunked(x, km.centroids)
    cap = lider.padded_capacity(int(torch.bincount(assign.long(), minlength=64).max()), None, 8)
    done = []
    for sd in ("int8", "int4"):
        cfg = lider.LiderConfig(n_clusters=64, n_probe=4, capacity=cap, storage_dtype=sd)
        up = lider.build_lider(SEED, x[:n_base], cfg, centroids=km.centroids, device=dev)
        for part in torch.tensor_split(x[n_base:], 2):
            up, _ = update.upsert(up, part)
        full = lider.build_lider(SEED, x, cfg, centroids=km.centroids, device=dev)
        bad = mismatched(up.bank, full.bank, LIFE_BANK + QUANT_BANK)
        a = lider.search_lider(up, q, k=10, n_probe=4)
        b = lider.search_lider(full, q, k=10, n_probe=4)
        if bad or not torch.equal(a.ids, b.ids):
            raise AssertionError(f"{sd}: upsert differs from the rebuild in {bad} or the search ids")
        done.append(sd)
    log("lifecycle", "small int8 and int4 indexes (20,000 x 768, c=64): build(80%) + upsert(20%, "
        "2 batches) == the frozen rebuild over 100%: codes, scales, rescore rows, sketches, keys, "
        "positions, gids bit for bit; search ids equal")
    return done


# The train phase. Its floors are fixed before the first run on the card:
# the encoder's recall@10 against Flat catches garbage only (as
# RECALL_FLOOR), and the contrastive loss must fall to half its first value
# (the mean of the last 30 steps).
# ---------------------------------------------------------------------------
# distributed: the cluster-sharded index over ranks sharing the card
# ---------------------------------------------------------------------------

# The (data, model) grid of four gloo ranks, the second grid of the float32
# search, the capacity factors (the JAX package's default; a tight one that
# drops pairs), the shard killed in degraded mode, the plain version's chunk
# of per-pair query rows (a 64 x 4,000 x 768 float32 gather is 0.8 GB a rank) or of
# grouped schedule steps.
DIST = types.SimpleNamespace(grid=(2, 2), grid4=(4, 1), capacity_factor=2.0, tight=0.5,
                             dead=1, plain_chunk={"fused_verify_grouped": 32}, plain_rows=64)


def dist_points() -> list:
    """``(name, storage, search options, tier)`` of the distributed phase's
    points: the main path's float32 search, and ``QUANTIZED``'s four points
    with host-tier Q8 (the three-stage search) beside them."""
    from repro_torch.configs.lider_msmarco import QUANTIZED

    q = {p.name: p for p in QUANTIZED}
    return ([("F32", "float32", {}, "device")]
            + [(n, q[n].storage_dtype, q[n].search_kwargs(), "device") for n in ("Q8", "Q8-cm")]
            + [("Q8-host", "int8", q["Q8"].search_kwargs(), "host")]
            + [(n, q[n].storage_dtype, q[n].search_kwargs(), "device") for n in ("Q4-sk", "Q4-sk-cm")])


def expected_drops(cids: np.ndarray, shape, capacity_factor: float, n_clusters: int) -> int:
    """The drop count of one routed batch on a grid, from the routed ids on
    the host with the dispatch's rule: each (cluster shard, query shard)
    cell keeps ``min(n_pairs, ceil(n_pairs / S * factor))`` of its pairs,
    its own first."""
    s, qs = shape
    b, p = cids.shape
    b_loc = b // qs
    n_pairs = b_loc * p
    cap = min(n_pairs, int(math.ceil(n_pairs / s * capacity_factor)))
    c_loc = n_clusters // s
    total = 0
    for qi in range(qs):
        flat = cids[qi * b_loc : (qi + 1) * b_loc].reshape(-1)
        owner = np.where(flat >= 0, flat // c_loc, -1)
        for my in range(s):
            total += max(0, int((owner == my).sum()) - cap)
    return total


def pairwise_reference(params, q, cids, opts: dict, k: int, r0: int):
    """The sharded search's answer computed on one device, with no drops:
    each (query, probe) pair searched alone (its own first pass and rescore
    on a quantized bank), then each query's pairs merged. On a quantized
    bank this is not ``search_lider``'s answer, which keeps one top-k'
    over all of a query's probes."""
    from repro_torch.core import lider
    from repro_torch.core.utils import dedup_topk

    b, p = cids.shape
    kw = {key: v for key, v in opts.items() if key in ("rescore_factor", "sketch_factor")}
    pair = lider.incluster_search(params, q.repeat_interleave(p, dim=0), cids.reshape(-1, 1),
                                  k=k, r0=r0, **kw)
    return dedup_topk(pair.ids.reshape(b, -1), pair.scores.reshape(b, -1), k)


def rank_search(grid, search, shard, batches, *, health=None, plan=None) -> dict:
    """Four batches through a sharded search, barrier to barrier: each
    batch's world wall (rank 0's clock), the rank's seconds in collectives
    and in the host pre-pass, and the gathered answers."""
    from repro_torch import faults
    from repro_torch.core import distributed as D

    res = {"wall_ms": [], "gather_ms": [], "prepass_ms": [], "ids": [], "scores": [], "dropped": []}
    outs = []
    with faults.activate(plan) if plan is not None else contextlib.nullcontext():
        for qb in batches:
            torch.cuda.synchronize()
            grid.barrier()
            t0 = time.perf_counter()
            out, dropped = search(shard, qb, shard_health=health)
            torch.cuda.synchronize()
            grid.barrier()
            res["wall_ms"].append((time.perf_counter() - t0) * 1e3)
            res["gather_ms"].append(search.timings["gather_s"] * 1e3)
            res["prepass_ms"].append(search.timings["prepass_s"] * 1e3)
            outs.append((out, int(dropped)))
            res["stats"] = dict(search.shard_stats)
    for out, dropped in outs:  # outside the timed batches
        full = D.gather_query_shards(grid, out)
        res["ids"].append(full.ids.cpu())
        res["scores"].append(full.scores.cpu())
        res["dropped"].append(dropped)
    res["ids"], res["scores"] = torch.cat(res["ids"]).numpy(), torch.cat(res["scores"]).numpy()
    return res


def rank_calls(grid, name: str, search, shard, qb, *, time_them: bool,
               path: str | None = None) -> tuple[list, list]:
    """One batch with every kernel call recorded; each verification call
    held against its plain version over the whole call on this rank
    (bit-equal on quantized and sketch tables, float32 ids equal up to
    near-tie swaps); rank 0 then times each, alone on the card while the
    others wait. Returns (this rank's check lines, rank 0's timed calls)."""
    calls = []
    with recording(calls, keep=lambda n, a, kw: n != "lsh_hash"):
        search(shard, qb)
    torch.cuda.synchronize()
    checks = []
    first = True
    for kname, args, kw in calls:
        role = dist_role(kname, args, kw, first)
        first = False
        got = wrappers()[kname](*args, **kw)
        want = plain_chunked(kname, args, kw, DIST.plain_chunk.get(kname, DIST.plain_rows))
        if kname != "fused_verify" or kw.get("scales") is not None:
            if not bit_equal(got, want):
                raise AssertionError(f"rank {grid.rank} {name} {role}: {kname} differs from its plain version")
            checks.append(f"{role} bit-equal")
        else:
            err, swaps = compare(got, want)
            checks.append(f"{role} err {err:.2g} ({swaps} swaps)")
        del got, want
    torch.cuda.synchronize()
    grid.barrier()
    timed = []
    if time_them:
        first = True
        for kname, args, kw in calls:
            role = dist_role(kname, args, kw, first)
            first = False
            res = time_call(path or f"distributed {name} {DIST.grid[0]}x{DIST.grid[1]} rank 0", role, kname,
                            args, kw, reps=5,
                            chunk=DIST.plain_chunk.get(kname, DIST.plain_rows))
            res["launches_per_batch"] = per_batch(name.removesuffix("-host"))[list(KERNELS).index(kname)]
            timed.append(res)
    grid.barrier()
    return checks, timed


def dist_role(name: str, args, kw, first: bool) -> str:
    """A rank's call: its queries' routing, or one of the per-pair passes."""
    if name == "sketch_prefilter":
        return "per-pair sketch pre-filter"
    if name == "fused_verify_grouped":
        return "cell's grouped first pass"
    if kw.get("scales") is not None:
        return "per-pair first pass"
    if first:
        return "routing of the rank's queries"
    return "per-pair in-cluster" if args[1].shape[1] > 1_000 else "rescore"


def search_reading(grid, search, shard, qb) -> dict:
    """One batch of a sharded search read as the dry run predicts it: the
    rank's collectives by kind, the bytes of its shard's leaves, its peak
    device memory over the batch past what was allocated before it
    (``temp_bytes``), and the batch's milliseconds from a device sync to a
    device sync (the four ranks share the card)."""
    from repro_torch.core import distributed as D

    torch.cuda.synchronize()
    grid.barrier()
    kinds = copy.deepcopy(grid.comm_by_kind)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    search(shard, qb)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    temp = torch.cuda.max_memory_allocated() - base
    grid.barrier()
    return {"comm": comm_since(grid, kinds), "temp_bytes": temp, "ms": ms,
            "shard_bytes": sum(t.numel() * t.element_size() for t in D.named_leaves(shard).values())}


def dist_cell(ds: dict):
    """(arch, shape) of the F32 sharded search as the dry run rebuilds it:
    ``lider-msmarco`` at the capacity and key lengths of the distributed
    phase's index (``ds``), a batch of BATCH on the DIST grid."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.lider_msmarco import CONFIG, RetrievalArchConfig

    rcfg = RetrievalArchConfig(
        lider=dataclasses.replace(CONFIG.lider, key_len=ds["key_len"],
                                  key_len_centroid=ds["key_len_centroid"]),
        corpus_size=CONFIG.corpus_size, dim=CONFIG.dim, capacity=ds["capacity"], k=CONFIG.k)
    return (dataclasses.replace(get_arch("lider-msmarco"), config=rcfg),
            ShapeSpec("serve_2x2", "retrieval_serve", {"batch": BATCH}))


def real_search_counts(dev, ds: dict, params, qb) -> dict:
    """The dry run's counters over the F32 sharded search on the card's
    real tensors: rank 0 of a fake 2x2 world (its collectives hand a rank
    its own block back) on rank 0's shard of ``params`` and its block of
    the batch ``qb``, the query path's entries as their plain bodies."""
    from repro_torch.core import distributed as D
    from repro_torch.launch import dryrun, mesh
    from repro_torch.testing import uncaptured

    arch, shape = dist_cell(ds)
    with mesh.fake_world(DIST.grid[0] * DIST.grid[1]):
        grid = mesh.make_grid(DIST.grid, device=dev)
        shard = D.shard_lider_params(grid, params, ("data",))
        with uncaptured():
            rec = dryrun.measure(arch, shape, grid, device=dev, fake=False,
                                 args=(shard, D.shard_rows(grid, qb, ("model",))),
                                 capacity_factor=DIST.capacity_factor)
    del shard
    return {"cost": rec["cost"], "comm": rec["collectives"]}


def dist_rank(world, payload) -> dict:
    """One of the four gloo ranks sharing the card: each index's shard on
    the 2 x 2 grid (checked against the parent's slice, leaf by leaf),
    every point over 4 x 256 queries, then the float32 search on the 4 x 1
    grid with a dead shard and a killed one, a tight capacity, and the
    sharded Lloyd step."""
    from repro_torch import faults
    from repro_torch.configs.lider_msmarco import CONFIG
    from repro_torch.core import distributed as D
    from repro_torch.core import lider
    from repro_torch.launch import mesh

    cfg, k = CONFIG.lider, CONFIG.k
    g22 = mesh.make_grid(DIST.grid, device=world.device)
    g41 = mesh.make_grid(DIST.grid4, device=world.device)
    batches = [payload["queries"][i * BATCH : (i + 1) * BATCH] for i in range(N_BATCHES)]
    # Each rank is given its own query block of every batch.
    b22, b41 = ([D.shard_rows(g, qb, ("model",)) for qb in batches] for g in (g22, g41))
    kw = dict(k=k, n_probe=cfg.n_probe, r0=cfg.r0, r0_centroid=cfg.r0_centroid)
    out = {"points": {}, "rank": world.rank}
    lead = world.rank == 0

    def sharded(grid, storage):
        params = payload["indexes"][storage]
        t0 = time.perf_counter()
        shard = D.shard_lider_params(grid, params, ("data",))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        # The parent's own tensors (CUDA IPC), sliced as the shard must be.
        specs = D.lider_param_specs(params, ("data",))
        c_loc = params.bank.n_clusters // grid.shape["data"]
        my = grid.flat_index(("data",))
        want = {n: t[my * c_loc : (my + 1) * c_loc] if specs[n] else t
                for n, t in D.named_leaves(params).items()}
        got = D.named_leaves(shard)
        bad = [n for n in want if n not in got or not torch.equal(got[n], want[n])]
        if bad or set(got) != set(want):
            raise AssertionError(f"rank {world.rank}: shard of {storage} on {grid.shape} differs "
                                 f"from the parent's slice in {bad or set(got) ^ set(want)}")
        return shard, secs

    by_storage: dict[str, list] = {}
    for point in dist_points():
        by_storage.setdefault(point[1], []).append(point)
    for storage, points in by_storage.items():
        shard, secs = sharded(g22, storage)
        out.setdefault("shard_s", {})[storage] = secs
        out.setdefault("shard_gb", {})[storage] = shard.bank.nbytes_by_tier()["device"] / 1e9
        for name, _, opts, tier in points:
            s = lider.set_rescore_tier(shard, "host") if tier == "host" else shard
            search = D.make_sharded_search(g22, s, capacity_factor=DIST.capacity_factor, **kw, **opts)
            checks, timed = rank_calls(g22, name, search, s, b22[0], time_them=lead)
            reset_counts()
            res = rank_search(g22, search, s, b22)
            res["launches"] = read_counts()
            res["checks"], res["timed"] = checks, timed
            if name == "F32":
                res["dryrun"] = search_reading(g22, search, s, b22[0])
            if tier == "host":
                rows, scores = [], []
                for qb in b22:
                    r, sc, _ = search.stage1(s, qb)
                    full = D.gather_query_shards(g22, lider.TopK(ids=r, scores=sc))
                    rows.append(full.ids.cpu())
                    scores.append(full.scores.cpu())
                res["rows"], res["rows_scores"] = torch.cat(rows).numpy(), torch.cat(scores).numpy()
            out["points"][name] = res
            del s, search
        if storage == "float32":
            tight = D.make_sharded_search(g22, shard, capacity_factor=DIST.tight, **kw)
            out["tight"] = rank_search(g22, tight, shard, b22)
        del shard
        gc.collect()
        torch.cuda.empty_cache()

    # The float32 search on four cluster shards: whole, with shard DIST.dead
    # marked dead, and with it killed by the fault plan (every batch).
    shard, secs = sharded(g41, "float32")
    search = D.make_sharded_search(g41, shard, capacity_factor=DIST.capacity_factor, **kw)
    reset_counts()
    out["grid4"] = rank_search(g41, search, shard, b41)
    out["grid4"]["launches"] = read_counts()
    health = np.ones(DIST.grid4[0], bool)
    health[DIST.dead] = False
    out["health"] = rank_search(g41, search, shard, b41, health=health)
    plan = faults.FaultPlan([faults.FaultSpec("shard_search", mode="kill_shard",
                                              payload={"shard": DIST.dead},
                                              times=tuple(range(N_BATCHES)))])
    out["kill"] = rank_search(g41, search, shard, b41, plan=plan)
    del shard, search
    gc.collect()
    torch.cuda.empty_cache()

    # The sharded Lloyd step: this rank's quarter of the corpus.
    step = D.make_sharded_kmeans_step(g41, n_clusters=cfg.n_clusters)
    x_loc = D.shard_rows(g41, payload["corpus"]).clone()
    cen = payload["centroids"].clone()
    new = step(x_loc, cen)  # warm
    torch.cuda.synchronize()
    g41.barrier()
    reset_counts()
    t0 = time.perf_counter()
    new = step(x_loc, cen)
    torch.cuda.synchronize()
    g41.barrier()
    out["lloyd"] = {"ms": (time.perf_counter() - t0) * 1e3, "launches": read_counts(),
                    "centroids": new.cpu().numpy() if lead else None}
    payload.clear()  # drop this rank's handles on the parent's tensors
    gc.collect()
    return out


def nccl_rank(world, payload) -> dict:
    """The one-rank NCCL world: the float32 search and the Lloyd step, so
    the collectives run on CUDA tensors through NCCL."""
    from repro_torch.configs.lider_msmarco import CONFIG
    from repro_torch.core import distributed as D
    from repro_torch.launch import mesh

    cfg, k = CONFIG.lider, CONFIG.k
    grid = mesh.make_grid((1, 1), device=world.device)
    batches = [payload["queries"][i * BATCH : (i + 1) * BATCH] for i in range(N_BATCHES)]
    shard = D.shard_lider_params(grid, payload["params"], ("data",))
    search = D.make_sharded_search(grid, shard, k=k, n_probe=cfg.n_probe, r0=cfg.r0,
                                   r0_centroid=cfg.r0_centroid, capacity_factor=DIST.capacity_factor)
    search(shard, batches[0])
    reset_counts()
    res = rank_search(grid, search, shard, batches)
    res["launches"] = read_counts()
    del shard, search
    step = D.make_sharded_kmeans_step(grid, n_clusters=cfg.n_clusters)
    res["lloyd"] = step(payload["corpus"], payload["centroids"]).cpu().numpy()
    res["backend"] = grid.backend
    payload.clear()
    gc.collect()
    return res


def phase_distributed(dev, main, smi: str) -> dict:
    """The distributed index at full ``lider-msmarco`` width (ROADMAP 1.3):
    four gloo ranks on the card as a (data=2, model=2) grid run every
    point, each against the single-device search; the float32 search again
    on a (4, 1) grid, whole, degraded and with a killed shard; the sharded
    Lloyd step; then a one-rank NCCL world."""
    from repro_torch.configs.lider_msmarco import CONFIG, QUANTIZED
    from repro_torch.core import clustering, lider
    from repro_torch.launch import mesh
    from repro_torch.testing import assert_topk_match

    cfg, k = CONFIG.lider, CONFIG.k
    t_phase = time.perf_counter()
    corpus, queries, cen = main["corpus"], main["queries"], main["centroids"]
    batches = [queries[i * BATCH : (i + 1) * BATCH] for i in range(N_BATCHES)]
    q = {p.name: p for p in QUANTIZED}
    configs = {"float32": cfg, "int8": q["Q8"].lider_config(cfg), "int4": q["Q4-sk"].lider_config(cfg)}
    indexes = {}
    for storage, c in configs.items():
        indexes[storage] = lider.build_lider(SEED, corpus, c, device=dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t_phase
    n_clusters = cfg.n_clusters
    search_kw = dict(k=k, n_probe=cfg.n_probe, r0=cfg.r0, r0_centroid=cfg.r0_centroid)

    # Single-device answers, per point, on the parent's indexes.
    cids = {st: [lider._route_pruned(p, qb, n_probe=cfg.n_probe, r0_centroid=cfg.r0_centroid)[0]
                 for qb in batches] for st, p in indexes.items()}
    single, pairwise, prov = {}, {}, None
    for name, storage, opts, tier in dist_points():
        p = indexes[storage]
        outs = [lider.search_lider(p, qb, **search_kw, **opts) for qb in batches]
        single[name] = (torch.cat([o.ids for o in outs]).cpu().numpy(),
                        torch.cat([o.scores for o in outs]).cpu().numpy())
        if storage != "float32" and tier == "device":
            ref = [pairwise_reference(p, qb, c, opts, k, cfg.r0)
                   for qb, c in zip(batches, cids[storage])]
            pairwise[name] = (torch.cat([r[0] for r in ref]).cpu().numpy(),
                              torch.cat([r[1] for r in ref]).cpu().numpy())
        if tier == "host":
            firsts = [lider.host_first_pass(p, qb, **search_kw, rescore_factor=opts["rescore_factor"])[0]
                      for qb in batches]
            prov = (torch.cat([f.ids for f in firsts]).cpu().numpy(),
                    torch.cat([f.scores for f in firsts]).cpu().numpy())
    cids_np = {st: [c.cpu().numpy() for c in cs] for st, cs in cids.items()}
    sums_lloyd, counts_lloyd, _ = clustering.kmeans_step(corpus, cen, n_clusters=n_clusters)
    lloyd_want = clustering.update_centroids(cen, sums_lloyd, counts_lloyd).cpu().numpy()
    del sums_lloyd, counts_lloyd
    torch.cuda.synchronize()
    log("distributed", f"parent: float32, int8 and int4 indexes at {corpus.shape[0]} x "
        f"{CONFIG.dim}, c={n_clusters}, built in {t_build:.2f} s; single-device answers, the "
        f"per-pair answers ready at "
        f"{time.perf_counter() - t_phase:.1f} s")

    payload = {"indexes": indexes, "queries": queries, "corpus": corpus, "centroids": cen}
    t0 = time.perf_counter()
    ranks = mesh.spawn(4, dist_rank, payload, device=dev, backend="gloo")
    t_world = time.perf_counter() - t0
    r0 = ranks[0]
    log("distributed", f"4 gloo ranks on one card ({smi}): the world ran {t_world:.1f} s (spawn "
        f"included); every rank's shard of every index equals the parent's slice, leaf by leaf "
        f"(torch.equal on the card); shard times "
        + ", ".join(f"{st} {v:.2f} s ({r0['shard_gb'][st]:.2f} GB a rank)"
                    for st, v in r0["shard_s"].items())
        + ". Four ranks share one card and gloo stages every collective through the host: these "
          "times are not scaling numbers")
    timed_calls = []
    for name, storage, opts, tier in dist_points():
        pts = [r["points"][name] for r in ranks]
        res = pts[0]
        want_launch = tuple(N_BATCHES * v for v in per_batch(name.removesuffix("-host")))
        for r, pr in zip(ranks, pts):
            if tuple(pr["launches"]) != want_launch:
                raise AssertionError(f"{name}: rank {r['rank']} launched {pr['launches']}, "
                                     f"expected {want_launch}")
        drops = [expected_drops(c, DIST.grid, DIST.capacity_factor, n_clusters)
                 for c in cids_np[storage]]
        if res["dropped"] != drops:
            raise AssertionError(f"{name}: dropped {res['dropped']}, the host's count {drops}")
        ids, scores = res["ids"], res["scores"]
        s_ids, s_sc = single[name]
        agree = float((ids == s_ids).all(axis=1).mean())
        lines = []
        if name == "F32":
            if not np.array_equal(ids, s_ids):
                raise AssertionError(f"{name}: sharded ids differ from search_lider in "
                                     f"{int((ids != s_ids).any(axis=1).sum())} rows")
            np.testing.assert_allclose(scores, s_sc, rtol=1e-5, atol=1e-6)
            lines.append(f"ids == search_lider's row for row, scores within rtol 1e-5 (bit-equal: "
                         f"{np.array_equal(scores.view(np.int32), s_sc.view(np.int32))})")
        elif tier == "host":
            # The merged top-k' is search_lider's and each row is rescored
            # alone, so the scores are bit-equal; the rescore breaks exact
            # score ties by passage id (JAX's distributed front end), the
            # single-device search by bank row, so only exactly tied ids
            # may swap.
            if not np.array_equal(scores.view(np.int32), s_sc.view(np.int32)):
                raise AssertionError(f"{name}: scores are not search_lider's bit for bit")
            swaps = assert_topk_match(ids, scores, s_ids, s_sc, rtol=0.0, atol=0.0)
            lines.append(f"scores == search_lider's bit for bit, ids equal up to {swaps} swaps of "
                         f"exactly tied scores ({int((ids != s_ids).any(axis=1).sum())} rows differ)")
        else:
            p_ids, p_sc = pairwise[name]
            if not np.array_equal(ids, p_ids):
                raise AssertionError(f"{name}: sharded ids differ from the per-pair answer in "
                                     f"{int((ids != p_ids).any(axis=1).sum())} rows")
            np.testing.assert_allclose(scores, p_sc, rtol=1e-5, atol=1e-6)
            lines.append(f"ids == the single-device per-pair answer row for row, scores within rtol "
                         f"1e-5 (bit-equal: {np.array_equal(scores.view(np.int32), p_sc.view(np.int32))}); "
                         f"rows equal to search_lider's (which keeps one top-k' a query, not one a "
                         f"pair): {agree:.4f}")
        if tier == "host":
            if not (np.array_equal(res["rows"], prov[0])
                    and np.array_equal(res["rows_scores"].view(np.int32), prov[1].view(np.int32))):
                raise AssertionError(f"{name}: the merged provisional rows differ from host_first_pass")
            lines.append("stage 1 (merged provisional rows, int8 scores) == host_first_pass bit for bit")
            dev_ids = ranks[0]["points"]["Q8"]["ids"]
            lines.append(f"rows equal to the sharded device-tier Q8 (a rescore a pair): "
                         f"{float((ids == dev_ids).all(axis=1).mean()):.4f}")
        if name.endswith("-cm"):
            base = ranks[0]["points"][name.removesuffix("-cm")]
            if not (np.array_equal(ids, base["ids"])
                    and np.array_equal(scores.view(np.int32), base["scores"].view(np.int32))):
                raise AssertionError(f"{name} differs from the per-query sharded search")
            lines.append(f"== {name.removesuffix('-cm')} sharded bit for bit; host pre-pass "
                         f"median {statistics.median(res['prepass_ms']):.3f} ms")
        rec = float(recall_of(ids, main["gt"]))
        log("distributed", f"{name} ({storage}, {tier} tier, {opts}) on the 2x2 grid: world wall "
            f"per batch median {statistics.median(res['wall_ms']):.3f} ms (all "
            f"{', '.join(f'{v:.3f}' for v in res['wall_ms'])}; four ranks time-share one card, not "
            f"a scaling number), all-gather + drop sum per batch median "
            f"{statistics.median(res['gather_ms']):.3f} ms (rank 0, from the end of its own "
            f"kernels: the host staging, the exchange and the wait for the slowest rank); launches per rank {fmt_counts(c // N_BATCHES for c in res['launches'])} "
            f"a batch (as the code predicts, on each of the 4 ranks); dropped {res['dropped']} "
            f"(== the host's count); recall@{k} {rec:.4f}; " + "; ".join(lines))
        log("distributed", f"{name}: each rank's calls against the plain version: "
            + " | ".join(f"rank {r['rank']}: " + ", ".join(r["points"][name]["checks"]) for r in ranks))
        for c in res["timed"]:
            timed_calls.append(c)

    tight = r0["tight"]
    drops = [expected_drops(c, DIST.grid, DIST.tight, n_clusters) for c in cids_np["float32"]]
    ids = tight["ids"]
    if tight["dropped"] != drops or min(drops) <= 0:
        raise AssertionError(f"capacity {DIST.tight}: dropped {tight['dropped']}, host count {drops}")
    if not (((ids >= -1) & (ids < corpus.shape[0])).all() and (ids >= 0).any()):
        raise AssertionError(f"capacity {DIST.tight}: ids out of range")
    log("distributed", f"F32 at capacity factor {DIST.tight} on the 2x2 grid: dropped "
        f"{tight['dropped']} pairs a batch (== the host's count from the routed ids), ids well "
        f"formed ({int((tight['ids'] < 0).all(axis=1).sum())} queries lost every pair: a cell "
        f"keeps its first pairs in query order); recall@{k} {float(recall_of(ids, main['gt'])):.4f} against "
        f"{float(recall_of(single['F32'][0], main['gt'])):.4f} without drops")

    g4, hl, kl = r0["grid4"], r0["health"], r0["kill"]
    s_ids, s_sc = single["F32"]
    if not np.array_equal(g4["ids"], s_ids):
        raise AssertionError("F32 on the 4x1 grid differs from search_lider")
    np.testing.assert_allclose(g4["scores"], s_sc, rtol=1e-5, atol=1e-6)
    for r in ranks:
        if tuple(r["grid4"]["launches"]) != tuple(N_BATCHES * v for v in per_batch("F32")):
            raise AssertionError(f"4x1 grid: rank {r['rank']} launched {r['grid4']['launches']}")
    c_loc = n_clusters // DIST.grid4[0]
    dead = set(indexes["float32"].bank.gids[DIST.dead * c_loc : (DIST.dead + 1) * c_loc]
               .reshape(-1).cpu().tolist()) - {-1}
    served = set(hl["ids"].reshape(-1).tolist())
    if served & dead or not set(g4["ids"].reshape(-1).tolist()) & dead:
        raise AssertionError("degraded: a dead shard's passage was served (or none was in the full answer)")
    for f, p in zip(g4["ids"], hl["ids"]):
        if not set(f[f >= 0].tolist()) - dead <= set(p[p >= 0].tolist()):
            raise AssertionError("degraded: a live shard's answer of the full search was lost")
    if not (np.array_equal(kl["ids"], hl["ids"])
            and np.array_equal(kl["scores"].view(np.int32), hl["scores"].view(np.int32))):
        raise AssertionError("kill_shard differs from the health mask")
    want_stats = {"shards_live": DIST.grid4[0] - 1, "shards_total": DIST.grid4[0]}
    if hl["stats"] != want_stats or kl["stats"] != want_stats:
        raise AssertionError(f"shard_stats {hl['stats']} / {kl['stats']}")
    log("distributed", f"F32 on the 4x1 grid: ids == search_lider's, scores within rtol 1e-5; "
        f"world wall per batch median {statistics.median(g4['wall_ms']):.3f} ms, all-gather "
        f"median {statistics.median(g4['gather_ms']):.3f} ms; shard {DIST.dead} dead: none of its "
        f"{len(dead)} passages served, every live-shard answer of the full search kept, recall@{k} "
        f"{float(recall_of(hl['ids'], main['gt'])):.4f}; kill_shard == the mask bit for bit; "
        f"shard_stats {hl['stats']}")

    got = r0["lloyd"]["centroids"]
    err = float(np.abs(got - lloyd_want).max())
    if err > 1e-5:
        raise AssertionError(f"sharded Lloyd step differs from kmeans_step by {err}")
    log("distributed", f"sharded Lloyd step over 4 data ranks (N {corpus.shape[0]}, c "
        f"{n_clusters}, d {CONFIG.dim}): max |difference| {err:.3g} from the single-device "
        f"kmeans_step + update_centroids (atol 1e-5); {r0['lloyd']['ms']:.3f} ms (world wall); "
        f"launches per rank {fmt_counts(r0['lloyd']['launches'])}")
    f32 = indexes["float32"]
    dry = {"search": [r["points"]["F32"]["dryrun"] for r in ranks],
           "capacity": f32.bank.capacity, "key_len": f32.bank.lsh.key_len,
           "key_len_centroid": f32.centroid_cm.lsh.key_len}
    dry["real"] = real_search_counts(dev, dry, f32, batches[0])
    del ranks, payload, f32
    torch.cuda.ipc_collect()

    t0 = time.perf_counter()
    (nc,) = mesh.spawn(1, nccl_rank, {"params": indexes["float32"], "queries": queries,
                                      "corpus": corpus, "centroids": cen},
                       device=dev, backend="nccl")
    t_nccl = time.perf_counter() - t0
    if nc["backend"] != "nccl" or not np.array_equal(nc["ids"], s_ids):
        raise AssertionError("the one-rank NCCL world differs from search_lider")
    np.testing.assert_allclose(nc["scores"], s_sc, rtol=1e-5, atol=1e-6)
    if tuple(nc["launches"]) != tuple(N_BATCHES * v for v in per_batch("F32")):
        raise AssertionError(f"NCCL world launched {nc['launches']}")
    err_n = float(np.abs(nc["lloyd"] - lloyd_want).max())
    if err_n > 1e-5:
        raise AssertionError(f"NCCL Lloyd step differs by {err_n}")
    log("distributed", f"one-rank NCCL world ({t_nccl:.1f} s, spawn included): F32 ids == "
        f"search_lider's, world wall per batch median {statistics.median(nc['wall_ms']):.3f} ms, "
        f"collectives median {statistics.median(nc['gather_ms']):.3f} ms; Lloyd step max "
        f"|difference| {err_n:.3g}")
    del indexes
    gc.collect()
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()
    log("distributed", f"phase {time.perf_counter() - t_phase:.1f} s")
    return {"calls": timed_calls, "dryrun": dry}


# ---------------------------------------------------------------------------
# models_sharded: the models' half of the distributed path (ROADMAP 1.3b)
# ---------------------------------------------------------------------------

# qwen2.5-3b at its published widths cut to 4 of its 36 layers (every FSDP
# gather and gradient sum goes through the host under gloo: four ranks share
# the card), float32 compute, seq 1,024, global batch 8, 3 AdamW steps with
# OptimizerConfig()'s defaults; decode: prefill 512 at batch 4, 32 steps,
# then batch 1 for 8 steps on the sequence over all four ranks.
# two-tower-retrieval at its published widths: batch 16,384 (train_batch's
# 65,536 cut, as in the models phase), 10 steps, 512 users searched.
SHARDED = types.SimpleNamespace(
    grid=(2, 2), lm_arch="qwen2.5-3b", layers=4, seq=1024, batch=8, steps=3,
    prompt=512, decode_batch=4, decode_steps=32, long_steps=8,
    tt_arch="two-tower-retrieval", tt_batch=16_384, tt_steps=10, encode_chunk=262_144,
    n_clusters=2048, users=512, k=100,
)


def sharded_configs():
    """(the LM config, the two-tower config) of the phase."""
    from repro_torch.configs import get_arch

    lm = dataclasses.replace(get_arch(SHARDED.lm_arch).config, n_layers=SHARDED.layers,
                             dtype=torch.float32)
    return lm, get_arch(SHARDED.tt_arch).config


# The trained blocks after 3 steps are held to the AdamW rule of
# tests/test_torch_training.py (at most 0.1% of a leaf's elements beyond
# 1e-5 of it, those within 1% of the summed lr) with departures read off
# this phase's control, the single rank with its batch in 2 micro-batches
# (the same float32 sums in another order) against 1, which breaks the 1%
# clause too. Past 1% of the summed lr:
# - an element whose gradient vanishes (the reference's clipped gradient,
#   its rms over the steps from AdamW's nu, below AdamW's eps) takes the
#   step g / (|g| + eps), which scales g's float32 rounding by up to
#   1 / eps: two runs that round g apart can move it by its whole
#   normalised step. Any number may, none past ADAMW_WORST summed lrs;
# - of the others, ADAMW_FLIPS a leaf, twice the control's most.
# The control is held to the same limits; the readings per leaf are in
# PERF.md.
ADAMW_FLIPS = 4
ADAMW_WORST = 0.3
ADAMW_KEEP = 4096  # flagged elements a block reports at most (more fail the count anyway)


def adamw_reading(got: torch.Tensor, want: torch.Tensor, lr_sum: float, offset=None) -> dict:
    """One leaf (or a rank's block of it, whose first element sits at
    ``offset`` in the full leaf) after AdamW steps against the reference:
    the share of its elements beyond 1e-5 of the leaf, and the elements
    also beyond 1% of the summed lr ("flagged": their indexes in the full
    leaf and differences in summed lrs). A leaf that started at zero (the
    qkv biases) is nothing but its few normalised updates, so the relative
    floor is below its gradients' rounding (the key bias's exact gradient
    is even zero: softmax ignores a shift shared by every key); its share
    is None and every element past 1% of the summed lr is flagged."""
    diff = (got.float() - want.float()).abs()
    zero_start = float(want.abs().max()) <= 10 * lr_sum
    share = None
    flag = diff > 1e-2 * lr_sum
    if not zero_start:
        bad = diff > 1e-5 * want.abs() + 1e-5 * want.abs().max()
        share = float(bad.float().mean())
        flag &= bad
    idx = torch.nonzero(flag)[:ADAMW_KEEP]
    return {"share": share, "zero_start": zero_start, "count": int(flag.sum()),
            "idx": idx.cpu().numpy() + (0 if offset is None else np.asarray(offset)),
            "diff": (diff[tuple(idx.T)] / lr_sum).cpu().numpy()}


def adamw_verdict(readings: list, grad_rms, eps: float) -> tuple[dict, list]:
    """``readings``: (leaf name, :func:`adamw_reading`) of every block ->
    ({leaf: {flat index tuple: (difference in summed lrs, the gradient
    vanishes)}}, problems). ``grad_rms(leaf, indexes)`` gives the
    reference's gradient rms at the flagged elements. A leaf whole on
    several ranks is read on each; its flagged elements count once."""
    flags, zero, problems = {}, {}, []
    for name, r in readings:
        if r["share"] is not None and r["share"] > 1e-3:
            problems.append(f"{name}: {r['share']:.2e} of a block beyond 1e-5")
        if r["count"] > len(r["idx"]):
            problems.append(f"{name}: {r['count']} elements of a block past 1% of the summed lr")
        flags.setdefault(name, {}).update(zip(map(tuple, r["idx"].tolist()), r["diff"].tolist()))
        zero[name] = r["zero_start"]
    for name, f in flags.items():
        if not f:
            continue
        vanish = (grad_rms(name, list(f)) < eps).tolist()
        f = flags[name] = {i: (d, v) for (i, d), v in zip(f.items(), vanish)}
        counted = sum(not v for _, v in f.values())
        worst = max(d for d, _ in f.values())
        limit = 0 if zero[name] else ADAMW_FLIPS
        if (len(f) if zero[name] else counted) > limit or worst > ADAMW_WORST:
            problems.append(f"{name}: {len(f)} elements past 1% of the summed lr, {counted} of them "
                            f"with a gradient (limit {limit}), the largest {worst:.3f} summed lr "
                            f"(limit {ADAMW_WORST})")
    return flags, problems


def _tokens(seed: int, batch: int, seq: int, vocab: int, dev) -> dict:
    from repro_torch.data import synthetic

    return synthetic.lm_batch(seed, 0, batch=batch, seq=seq, vocab=vocab, device=dev)


def _decode_run(model, prompt, feed, steps: int, max_len: int, seq_sharded=None):
    """Prefill then ``steps`` decode steps fed ``feed``'s tokens (the same
    on both sides): (logits of every step stacked, ms a step). Under a grid
    ``seq_sharded`` picks the cache layout."""
    from repro_torch.models import transformer as tfm

    kw = {} if seq_sharded is None else {"seq_sharded": seq_sharded}
    with torch.no_grad():
        lg, cache = tfm.prefill(model, prompt, max_len=max_len, **kw)
        out = [lg]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            lg, cache = tfm.decode_step(model, cache, feed[:, i : i + 1])
            out.append(lg)
        torch.cuda.synchronize()
    return torch.stack(out), (time.perf_counter() - t0) / steps * 1e3


def _timed_steps(step, model, state, batches, grid=None) -> list[dict]:
    """Each step barrier to barrier (rank 0's clock), run under ``grid``,
    with its loss, grad norm and the rank's collective seconds (device sync
    to device sync, ``Grid.comm_s``)."""
    from repro_torch.launch import mesh

    out = []
    for b in batches:
        torch.cuda.synchronize()
        if grid is not None:
            grid.barrier()
            s0 = grid.comm_s
            b0 = grid.comm_bytes
            k0 = copy.deepcopy(grid.comm_by_kind)
        t0 = time.perf_counter()
        with mesh.use_grid(grid):
            _, _, m = step(model, state, b)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        if grid is not None:
            grid.barrier()
        out.append({"s": time.perf_counter() - t0, "loss": loss, "grad_norm": gnorm,
                    "comm_s": grid.comm_s - s0 if grid is not None else 0.0,
                    "comm_gb": (grid.comm_bytes - b0) / 1e9 if grid is not None else 0.0,
                    "comm_kinds": comm_since(grid, k0) if grid is not None else {}})
    return out


def comm_since(grid, before: dict) -> dict:
    """The grid's collective calls and bytes by kind since ``before`` (a
    copy of ``grid.comm_by_kind``)."""
    return {k: {f: v[f] - before.get(k, {}).get(f, 0) for f in ("count", "bytes")}
            for k, v in grid.comm_by_kind.items()
            if v["count"] != before.get(k, {}).get("count", 0)}


def sharded_rank(world, payload) -> dict:
    """One of the four gloo ranks sharing the card, a (data=2, model=2)
    grid: the LM's decode (pure-TP layout) and training (FSDP + TP), each
    against the parent's single-rank run; then two-tower at its published
    widths, its items encoded, indexed with LIDER and searched sharded."""
    from repro_torch.configs.lider_msmarco import CONFIG
    from repro_torch.core import distributed as D
    from repro_torch.core import lider
    from repro_torch.core.baselines import flat_search
    from repro_torch.core.utils import l2_normalize, recall_at_k
    from repro_torch.data import synthetic
    from repro_torch.launch import mesh
    from repro_torch.models import recsys, sharding
    from repro_torch.models import transformer as tfm
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training import train_loop

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = world.device
    lm_cfg, tt_cfg = sharded_configs()
    grid = mesh.make_grid(SHARDED.grid, device=dev)
    sharding.warm_groups(grid)
    names = grid.axis_names
    d_idx = grid.flat_index(("data",))
    n_data = grid.axis_size(("data",))
    res = {"rank": world.rank, "coords": grid.coords()}
    lead = world.rank == 0

    def sharded_lm(fsdp: bool):
        return sharding.shard_module(tfm.Transformer(lm_cfg, device="meta"),
                                     tfm.param_specs(lm_cfg, names, fsdp=fsdp), grid,
                                     source=payload["lm_init"], device=dev)

    # (b) Decode, on the pure-TP layout: an FSDP layout would all-gather
    # every layer's weights through the host at every token.
    model = sharded_lm(fsdp=False)
    rows = lambda t: t[d_idx * (t.shape[0] // n_data) : (d_idx + 1) * (t.shape[0] // n_data)]
    dec = payload["decode"]
    with mesh.use_grid(grid):
        grid.barrier()
        got, ms = _decode_run(model, rows(dec["prompt"]), rows(dec["feed"]), SHARDED.decode_steps,
                              SHARDED.prompt + SHARDED.decode_steps, seq_sharded=False)
        want = rows(dec["want"].transpose(0, 1)).transpose(0, 1)
        long_got, long_ms = _decode_run(model, dec["long_prompt"], dec["long_feed"],
                                        SHARDED.long_steps, SHARDED.prompt + SHARDED.long_steps,
                                        seq_sharded=True)
    res["decode"] = {}
    for name, g, w, step_ms in (("batched", got, want, ms), ("long", long_got, dec["long_want"], long_ms)):
        res["decode"][name] = {
            "rel": float((g - w).abs().max() / w.abs().max()),
            "argmax_equal": bool(torch.equal(g.argmax(-1), w.argmax(-1))),
            "ms": step_ms,
        }
    del model, got, long_got
    gc.collect()
    torch.cuda.empty_cache()

    # (a) Training: FSDP over data, TP over model, 3 AdamW steps.
    torch.cuda.reset_peak_memory_stats()
    model = sharded_lm(fsdp=True)
    state = opt_lib.init_state(dict(model.named_parameters()))
    step = train_loop.make_train_step(tfm.train_loss, opt_lib.OptimizerConfig())
    batches = [sharding.shard_batch(b, grid) for b in payload["lm_batches"]]
    res["train"] = _timed_steps(step, model, state, batches, grid)
    res["train_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    res["train_peak_bytes"] = torch.cuda.max_memory_allocated()
    lr_sum = sum(float(opt_lib.schedule(opt_lib.OptimizerConfig(), torch.tensor(s)))
                 for s in range(1, SHARDED.steps + 1))
    leaves, owned, want_bytes = [], 0, 0
    for n, p in model.named_parameters():
        full = payload["lm_final"][n]
        ref = sharding.shard(full, sharding.spec_of(p), grid)
        lo = [sl.start or 0 for sl in sharding.block_slices(full.shape, sharding.spec_of(p), grid)]
        leaves.append((n, adamw_reading(p.detach(), ref, lr_sum, lo)))
        owned += p.numel() * p.element_size() + sum(
            state[k][n].numel() * state[k][n].element_size() for k in ("mu", "nu"))
        want_bytes += 3 * ref.numel() * 4  # the param and two float32 moments
    res["adamw"] = leaves
    res["state_bytes"] = (owned, want_bytes)
    del model, state, step, batches
    gc.collect()
    torch.cuda.empty_cache()

    # (c) two-tower at its published widths: tables over model, batch over data.
    torch.cuda.reset_peak_memory_stats()
    tt_init = payload["tt_init"]
    tt = recsys.TwoTower(tt_cfg, torch.device("meta"))
    sharding.shard_module(tt, recsys.param_specs(tt), grid, source=tt_init, device=dev)
    look = payload["lookup"]
    ids = rows(look["ids"])
    table = tt.item_emb
    with mesh.use_grid(grid):
        out_rows = recsys.embedding_lookup(table, ids)
        torch.sum(out_rows**2).backward()
    spec = sharding.spec_of(table)
    res["lookup"] = {
        "bit_equal": bool(torch.equal(out_rows.detach(), rows(look["rows"]))),
        "grad_err": float((table.grad - sharding.shard(look["grad"], spec, grid)).abs().max()),
    }
    table.grad = None
    del out_rows
    state = opt_lib.init_state(dict(tt.named_parameters()))
    opt_cfg = opt_lib.OptimizerConfig(warmup_steps=1, decay_steps=SHARDED.tt_steps)
    step = train_loop.make_train_step(recsys.two_tower_loss, opt_cfg)
    batches = [sharding.shard_batch(
        synthetic.recsys_batch(SEED, i, kind="two_tower", batch=SHARDED.tt_batch, cfg=tt_cfg,
                               device=dev), grid) for i in range(SHARDED.tt_steps)]
    res["tt_train"] = _timed_steps(step, tt, state, batches, grid)
    res["tt_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del state, step, batches
    gc.collect()
    torch.cuda.empty_cache()

    # Every item encoded by the sharded model (each data rank half the
    # items, the lookups summed over model), gathered over data.
    n = tt_cfg.item_vocab
    per = n // n_data
    torch.cuda.synchronize()
    grid.barrier()
    t0 = time.perf_counter()
    mine = []
    with torch.no_grad(), mesh.use_grid(grid):
        for s in range(d_idx * per, (d_idx + 1) * per, SHARDED.encode_chunk):
            i = torch.arange(s, min(s + SHARDED.encode_chunk, (d_idx + 1) * per), dtype=torch.int32,
                             device=dev)
            mine.append(l2_normalize(recsys.item_embed(tt, torch.stack([i, torch.zeros_like(i)], 1))))
        embs = sharding.unshard(torch.cat(mine), (("data",), None), grid)
        users = synthetic.recsys_batch(SEED, 10**6, kind="two_tower", batch=SHARDED.users,
                                       cfg=tt_cfg, device=dev)["user_fields"]
        q = l2_normalize(recsys.user_embed(tt, users))
    del mine
    torch.cuda.synchronize()
    grid.barrier()
    res["encode_s"] = time.perf_counter() - t0
    del tt
    gc.collect()
    torch.cuda.empty_cache()

    # LIDER over the items, built alike on every rank (the build is
    # deterministic: each rank's index must equal rank 0's), then the
    # sharded search of the users on the same grid.
    icfg = dataclasses.replace(CONFIG.lider, n_clusters=SHARDED.n_clusters)
    t0 = time.perf_counter()
    params = lider.build_lider(SEED, embs, icfg, device=dev)
    torch.cuda.synchronize()
    res["build_s"] = time.perf_counter() - t0
    digest = torch.stack([params.centroids.double().sum(), params.bank.gids.double().sum(),
                          (params.bank.gids.double() * torch.arange(
                              params.bank.gids.numel(), device=dev).reshape(
                              params.bank.gids.shape).double()).sum()])
    res["same_index"] = bool(torch.equal(grid.all_gather(digest, names),
                                         digest.expand(grid.size, 3)))
    shard = D.shard_lider_params(grid, params, ("data",))
    search = D.make_sharded_search(grid, shard, k=SHARDED.k, n_probe=icfg.n_probe, r0=icfg.r0,
                                   r0_centroid=icfg.r0_centroid, capacity_factor=2.0)
    q_me = D.shard_rows(grid, q, ("model",))  # this rank's query block
    search(shard, q_me)  # warm
    torch.cuda.synchronize()
    grid.barrier()
    reset_counts()
    t0 = time.perf_counter()
    out, dropped = search(shard, q_me)
    torch.cuda.synchronize()
    grid.barrier()
    res["search_ms"] = (time.perf_counter() - t0) * 1e3
    res["search_launches"] = read_counts()
    res["dropped"] = int(dropped)
    full = D.gather_query_shards(grid, out)
    res["checks"], res["calls"] = rank_calls(grid, "F32", search, shard, q_me, time_them=lead,
                                             path="models_sharded two-tower 2x2 rank 0")
    # The search's two query hashes (the centroids' keys, the bank's),
    # recorded on every rank and timed on rank 0 alone.
    hashes = []
    with recording(hashes, keep=lambda n, a, kw: n == "lsh_hash"):
        search(shard, q_me)
    torch.cuda.synchronize()
    grid.barrier()
    res["hash_calls"] = [time_build_call("models_sharded two-tower 2x2 rank 0", role, n, a, kw,
                                         reps=50)
                         for role, (n, a, kw) in zip(("query hash (centroids)", "query hash (bank)"),
                                                     hashes)] if lead else []
    grid.barrier()
    if lead:
        gt = flat_search(embs, q, k=SHARDED.k).ids
        exact_c = torch.topk(q @ params.centroids.T, icfg.n_probe, dim=-1).indices
        single = lider.search_lider(params, q, k=SHARDED.k, n_probe=icfg.n_probe, r0=icfg.r0,
                                    r0_centroid=icfg.r0_centroid)
        res["recall"] = float(recall_at_k(full.ids, gt))
        res["ivf_recall"] = float(recall_at_k(exact_scan_ids(params, q, exact_c, SHARDED.k), gt))
        res["equals_single"] = bool(torch.equal(full.ids, single.ids))
        res["n_probe"] = icfg.n_probe
        res["bank_gb"] = params.bank.nbytes_by_tier()["device"] / 1e9
    payload.clear()  # drop this rank's handles on the parent's tensors
    gc.collect()
    return res


def nccl_lm_rank(world, payload) -> dict:
    """The one-rank NCCL world: one LM train step through the same code, so
    the sharded layers' collectives run on CUDA tensors through NCCL."""
    from repro_torch.launch import mesh
    from repro_torch.models import sharding
    from repro_torch.models import transformer as tfm
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training import train_loop

    torch.backends.cuda.matmul.allow_tf32 = False
    lm_cfg, _ = sharded_configs()
    grid = mesh.make_grid((1, 1), device=world.device)
    model = sharding.shard_module(tfm.Transformer(lm_cfg, device="meta"),
                                  tfm.param_specs(lm_cfg, grid.axis_names), grid,
                                  source=payload["lm_init"], device=world.device)
    state = opt_lib.init_state(dict(model.named_parameters()))
    step = train_loop.make_train_step(tfm.train_loss, opt_lib.OptimizerConfig())
    (m,) = _timed_steps(step, model, state, payload["lm_batches"][:1], grid)
    # On one rank the sharded layers skip their collectives (every axis has
    # one rank); the grid's own ops run here on CUDA tensors through NCCL.
    x = torch.arange(6, dtype=torch.float32, device=world.device).reshape(2, 3)
    ops = (torch.equal(grid.all_reduce(x, ("data",)), x)
           and torch.equal(grid.all_reduce(x, ("model",), op="max"), x)
           and torch.equal(grid.all_gather(x.to(torch.bfloat16), ("data", "model"))[0],
                           x.to(torch.bfloat16)))
    payload.clear()
    return {"backend": grid.backend, "ops": bool(ops), **m}


def phase_models_sharded(dev, smi: str) -> dict:
    """The models' half of the distributed path on four gloo ranks sharing
    the card as a (data=2, model=2) grid, each item against the parent's
    single-rank run from the same weights: (a) qwen2.5-3b's widths at 4
    layers trained with FSDP + TP, (b) its decode on both cache layouts,
    (c) two-tower at its published widths trained with vocabulary-split
    tables, its items indexed with LIDER and searched by the sharded
    search; (d) one LM step in a one-rank NCCL world."""
    from repro_torch.launch import flops as flops_lib
    from repro_torch.launch import mesh
    from repro_torch.models import recsys
    from repro_torch.models import transformer as tfm
    from repro_torch.data import synthetic
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training import train_loop

    t_phase = time.perf_counter()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # both sides in float32 products
    lm_cfg, tt_cfg = sharded_configs()
    sh = SHARDED
    note = (f"four gloo ranks share one card ({smi}) and every collective goes through the "
            "host: not scaling numbers")

    # The LM: one init, carried as the reference's numpy tree.
    tree_np = tfm.params_to_numpy(tfm.init(SEED, lm_cfg, device=dev))
    gc.collect()
    torch.cuda.empty_cache()
    ref = tfm.params_from_numpy(tree_np, lm_cfg, device=dev)
    del tree_np
    lm_init = {n: p.detach().clone() for n, p in ref.named_parameters()}
    n_lm = sum(p.numel() for p in lm_init.values())
    v = lm_cfg.vocab
    prompt = _tokens(SEED + 1, sh.decode_batch, sh.prompt, v, dev)["tokens"]
    feed = _tokens(SEED + 2, sh.decode_batch, sh.decode_steps, v, dev)["tokens"]
    want, ref_ms = _decode_run(ref, prompt, feed, sh.decode_steps, sh.prompt + sh.decode_steps)
    long_prompt, long_feed = prompt[:1], feed[:1, : sh.long_steps]
    long_want, long_ref_ms = _decode_run(ref, long_prompt, long_feed, sh.long_steps,
                                         sh.prompt + sh.long_steps)
    lm_batches = [_tokens(SEED + 10 + i, sh.batch, sh.seq, v, dev) for i in range(sh.steps)]
    state = opt_lib.init_state(dict(ref.named_parameters()))
    torch.cuda.reset_peak_memory_stats()
    ref_steps = _timed_steps(train_loop.make_train_step(tfm.train_loss, opt_lib.OptimizerConfig()),
                             ref, state, lm_batches)
    ref_peak = torch.cuda.max_memory_allocated() / 2**30
    lm_final = {n: p.detach() for n, p in ref.named_parameters()}
    ref_nu = state["nu"]  # the second moments, to read the flagged elements' gradients by
    del state
    for p in ref.parameters():
        p.grad = None
    gc.collect()
    torch.cuda.empty_cache()
    # The control: the single rank again with its batch in 2 micro-batches,
    # which adds the same float32 sums in another order.
    twin = tfm.Transformer(lm_cfg, device=dev)
    with torch.no_grad():
        for n, p in twin.named_parameters():
            p.copy_(lm_init[n])
    state = opt_lib.init_state(dict(twin.named_parameters()))
    _timed_steps(train_loop.make_train_step(tfm.train_loss, opt_lib.OptimizerConfig(),
                                            grad_accum=2), twin, state, lm_batches)
    lr_sum = sum(float(opt_lib.schedule(opt_lib.OptimizerConfig(), torch.tensor(s)))
                 for s in range(1, sh.steps + 1))
    control = [(n, adamw_reading(p.detach(), lm_final[n], lr_sum))
               for n, p in twin.named_parameters()]
    del twin, state
    gc.collect()
    torch.cuda.empty_cache()

    # two-tower: one init, the single-rank run, and the lookup's reference.
    tt_ref = recsys.init(SEED, tt_cfg, device=dev)
    tt_init = {n: p.detach().clone() for n, p in tt_ref.named_parameters()}
    ids = synthetic.recsys_batch(SEED, 0, kind="two_tower", batch=sh.tt_batch, cfg=tt_cfg,
                                 device=dev)["item_fields"][:, 0]
    table = tt_init["item_emb"].clone().requires_grad_(True)
    rows = torch.nn.functional.embedding(ids, table)
    torch.sum(rows**2).backward()
    lookup = {"ids": ids, "rows": rows.detach(), "grad": table.grad}
    del table, rows
    state = opt_lib.init_state(dict(tt_ref.named_parameters()))
    opt_cfg = opt_lib.OptimizerConfig(warmup_steps=1, decay_steps=sh.tt_steps)
    tt_batches = [synthetic.recsys_batch(SEED, i, kind="two_tower", batch=sh.tt_batch, cfg=tt_cfg,
                                         device=dev) for i in range(sh.tt_steps)]
    tt_steps = _timed_steps(train_loop.make_train_step(recsys.two_tower_loss, opt_cfg), tt_ref,
                            state, tt_batches)
    n_tt = sum(p.numel() for p in tt_ref.parameters())
    del tt_ref, state, tt_batches
    gc.collect()
    torch.cuda.empty_cache()
    t_ref = time.perf_counter() - t_phase
    log("models_sharded", f"parent (single rank): {SHARDED.lm_arch} at {sh.layers} of 36 layers "
        f"({n_lm / 1e6:.1f} M parameters, float32 compute, TF32 off), decode {ref_ms:.2f} ms a step "
        f"at batch {sh.decode_batch}, training steps "
        + ", ".join(f"{s['s'] * 1e3:.1f}" for s in ref_steps)
        + f" ms (peak {ref_peak:.2f} GiB); two-tower ({n_tt / 1e6:.1f} M parameters) steps median "
        f"{statistics.median(s['s'] for s in tt_steps) * 1e3:.2f} ms; {t_ref:.1f} s with init; {smi}")

    payload = {
        "lm_init": lm_init, "lm_final": lm_final, "lm_batches": lm_batches,
        "decode": {"prompt": prompt, "feed": feed, "want": want, "long_prompt": long_prompt,
                   "long_feed": long_feed, "long_want": long_want},
        "tt_init": tt_init, "lookup": lookup,
    }
    t0 = time.perf_counter()
    ranks = mesh.spawn(4, sharded_rank, payload, device=dev, backend="gloo")
    t_world = time.perf_counter() - t0
    r0 = ranks[0]

    # (b) decode
    for name, steps, b, lay, rms in (
        ("batched", sh.decode_steps, sh.decode_batch, "batch over data, sequence over model "
         "(cache_specs seq_sharded=False)", ref_ms),
        ("long", sh.long_steps, 1, "the sequence over all four ranks (seq_sharded=True)", long_ref_ms),
    ):
        worst = max(r["decode"][name]["rel"] for r in ranks)
        argmax = all(r["decode"][name]["argmax_equal"] for r in ranks)
        log("models_sharded", f"(b) decode {name}: prefill {sh.prompt} then {steps} steps at batch "
            f"{b}, cache {lay}, pure-TP weights: largest |difference| {worst:.3g} of the largest "
            f"logit against the single rank (bound {DECODE_REL_F32}), argmax equal at every step: "
            f"{argmax}; {r0['decode'][name]['ms']:.2f} ms a step on rank 0 (single rank "
            f"{rms:.2f} ms); {note}")
        if worst > DECODE_REL_F32 or not argmax:
            raise AssertionError(f"sharded decode ({name}): rel {worst}, argmax equal {argmax}")

    # (a) training
    tokens = sh.batch * sh.seq
    fl = flops_lib.lm_flops(lm_cfg, tokens, train=True, seq_len=sh.seq)
    for i, s in enumerate(r0["train"]):
        peaks = ", ".join(f"{r['train_peak_gib']:.2f}" for r in ranks)
        comm = ", ".join(f"{r['train'][i]['comm_s']:.2f}" for r in ranks)
        log("models_sharded", f"(a) {SHARDED.lm_arch} widths, {sh.layers} layers, FSDP over data + "
            f"TP over model, step {i + 1}: wall {s['s']:.2f} s barrier to barrier (single rank "
            f"{ref_steps[i]['s']:.2f} s), collectives {comm} s a rank (device sync to device "
            f"sync; {r0['train'][i]['comm_gb']:.2f} GB sent in by rank 0), loss {s['loss']:.6f} "
            f"(single {ref_steps[i]['loss']:.6f}), grad norm {s['grad_norm']:.6g} (single "
            f"{ref_steps[i]['grad_norm']:.6g}); model FLOP/s {fl / s['s'] / 1e12:.2f} T (launch."
            f"flops.lm_flops, {tokens} tokens); peak memory a rank {peaks} GiB; {note}")
    for r in ranks:
        got = r["train"]
        np.testing.assert_allclose([got[0]["loss"], got[0]["grad_norm"]],
                                   [ref_steps[0]["loss"], ref_steps[0]["grad_norm"]], rtol=1e-5)
        np.testing.assert_allclose([s["loss"] for s in got], [s["loss"] for s in ref_steps], atol=1e-3,
                                   rtol=0)
        owned, want_b = r["state_bytes"]
        if owned != want_b:
            raise AssertionError(f"rank {r['rank']}: holds {owned} bytes of parameters and moments, "
                                 f"its spec's share is {want_b}")
    # The reference's clipped gradient's rms over the steps, as AdamW saw
    # it: the square root of its bias-corrected second moment.
    ocfg = opt_lib.OptimizerConfig()
    grad_rms = lambda n, idx: torch.sqrt(ref_nu[n][tuple(torch.tensor(idx).T)]
                                         / (1 - ocfg.b2**sh.steps))
    flags, problems = adamw_verdict([leaf for r in ranks for leaf in r["adamw"]], grad_rms, ocfg.eps)
    c_flags, c_problems = adamw_verdict(control, grad_rms, ocfg.eps)
    tell = lambda f: (f"{len(f)} ({sum(v for _, v in f.values())} vanishing, largest "
                      f"{max((d for d, _ in f.values()), default=0.0):.3f})")
    per_leaf = [f"{n} {tell(flags.get(n, {}))} against {tell(c_flags.get(n, {}))}"
                for n in lm_final if flags.get(n) or c_flags.get(n)]
    worst_share = max(leaf[1]["share"] or 0.0 for r in ranks for leaf in r["adamw"])
    log("models_sharded", f"(a) step 1's loss and grad norm within rtol 1e-5 of the single rank, "
        f"steps 2-3 within 1e-3; after {sh.steps} steps the AdamW rule on every rank's blocks "
        f"(largest share beyond 1e-5 of a block {worst_share:.2e}, limit 1e-3), at most "
        f"{ADAMW_FLIPS} elements with a gradient a leaf past 1% of the summed lr, none past "
        f"{ADAMW_WORST} summed lr (the zero-start qkv biases none), the control (the single rank with 2 "
        f"micro-batches against 1) held alike: {sum(map(len, flags.values()))} elements past 1% of "
        f"the summed lr against the control's {sum(map(len, c_flags.values()))}; per leaf, sharded "
        f"against control, with those whose gradient vanishes (rms below AdamW's eps): "
        + "; ".join(per_leaf) + f"; each rank holds "
        f"{r0['state_bytes'][0] / 1e9:.3f} GB of parameters and moments, its spec's share of "
        f"{3 * 4 * n_lm / 1e9:.3f} GB; {smi}")
    if problems or c_problems:
        raise AssertionError(f"parameters after {sh.steps} steps beyond the AdamW rule: sharded "
                             f"{problems[:4]}, control {c_problems[:4]}")
    del ref_nu

    # (c) two-tower
    for r in ranks:
        if not r["lookup"]["bit_equal"] or r["lookup"]["grad_err"] > 1e-5:
            raise AssertionError(f"rank {r['rank']}: sharded lookup {r['lookup']}")
        got = [s["loss"] for s in r["tt_train"]]
        np.testing.assert_allclose(got[0], tt_steps[0]["loss"], rtol=1e-5)
        np.testing.assert_allclose(got, [s["loss"] for s in tt_steps], atol=1e-3, rtol=0)
    tt_fl = flops_lib.recsys_flops(tt_cfg, flops_lib.recsys_param_shapes(tt_cfg), sh.tt_batch,
                                   kind_shape="train")
    walls = [s["s"] for s in r0["tt_train"]]
    med = statistics.median(walls[1:])
    log("models_sharded", f"(c) {SHARDED.tt_arch} at its published widths, tables over model, "
        f"batch {sh.tt_batch} over data: the sharded lookup == F.embedding bit for bit on every "
        f"rank, table gradient within {max(r['lookup']['grad_err'] for r in ranks):.3g} (atol "
        f"1e-5); {sh.tt_steps} steps, losses {r0['tt_train'][0]['loss']:.6f} -> "
        f"{r0['tt_train'][-1]['loss']:.6f} (single rank {tt_steps[0]['loss']:.6f} -> "
        f"{tt_steps[-1]['loss']:.6f}; step 1 rtol 1e-5, then 1e-3); wall median {med * 1e3:.1f} ms "
        f"a step (single rank {statistics.median(s['s'] for s in tt_steps[1:]) * 1e3:.2f} ms), "
        f"collectives median {statistics.median(s['comm_s'] for s in r0['tt_train'][1:]):.3f} s a "
        f"step on rank 0 ({r0['tt_train'][1]['comm_gb']:.2f} GB sent in), model FLOP/s "
        f"{tt_fl / med / 1e12:.2f} T; peak memory a rank "
        + ", ".join(f"{r['tt_peak_gib']:.2f}" for r in ranks) + f" GiB; {note}")
    want_launch = per_batch("F32")
    for r in ranks:
        if tuple(r["search_launches"]) != want_launch:
            raise AssertionError(f"rank {r['rank']}: the sharded search launched "
                                 f"{r['search_launches']}, expected {want_launch}")
        if not r["same_index"]:
            raise AssertionError(f"rank {r['rank']}: its LIDER index differs from the others'")
    rec, ivf = r0["recall"], r0["ivf_recall"]
    log("models_sharded", f"(c) the {tt_cfg.item_vocab} items encoded by the sharded model in "
        f"{r0['encode_s']:.2f} s and indexed with LIDER on each rank alike (c = {sh.n_clusters}, "
        f"{r0['build_s']:.2f} s on rank 0 with four builds sharing the card; bank "
        f"{r0['bank_gb']:.2f} GB); {sh.users} users through make_sharded_search on the same grid "
        f"in {r0['search_ms']:.2f} ms, dropped {r0['dropped']}, launches per rank "
        f"{fmt_counts(r0['search_launches'])} (as the code predicts, on each of the 4 ranks); ids "
        f"== search_lider's on rank 0's index: {r0['equals_single']}; recall@{sh.k} {rec:.4f} at "
        f"n_probe {r0['n_probe']} against IVF-Flat's {ivf:.4f} ({rec / ivf:.3f} of it, floor "
        f"{LIDER_OF_IVF}); {note}; each rank's verification calls against the plain version: "
        + " | ".join(f"rank {r['rank']}: " + ", ".join(r["checks"]) for r in ranks))
    if rec < LIDER_OF_IVF * ivf or not r0["equals_single"]:
        raise AssertionError(f"two-tower sharded: recall {rec} against IVF-Flat {ivf}, ids == "
                             f"single {r0['equals_single']}")
    dry = {"train": [r["train"] for r in ranks], "peak_bytes": [r["train_peak_bytes"] for r in ranks]}
    del ranks, payload, lookup
    torch.cuda.ipc_collect()
    gc.collect()
    torch.cuda.empty_cache()

    # (d) a one-rank NCCL world.
    t0 = time.perf_counter()
    (nc,) = mesh.spawn(1, nccl_lm_rank, {"lm_init": lm_init, "lm_batches": lm_batches},
                       device=dev, backend="nccl")
    t_nccl = time.perf_counter() - t0
    if nc["backend"] != "nccl" or not nc["ops"]:
        raise AssertionError(f"the one-rank world ran {nc['backend']}, its sum, max and gather "
                             f"ops returned their input: {nc['ops']}")
    np.testing.assert_allclose([nc["loss"], nc["grad_norm"]],
                               [ref_steps[0]["loss"], ref_steps[0]["grad_norm"]], rtol=1e-5)
    log("models_sharded", f"(d) one-rank NCCL world ({t_nccl:.1f} s, spawn included): one LM step "
        f"through the sharded layers, loss {nc['loss']:.6f} and grad norm {nc['grad_norm']:.6g} "
        f"within rtol 1e-5 of the single rank; {nc['s']:.2f} s (the process's first step), "
        f"collectives {nc['comm_s']:.3f} s; {smi}")
    del lm_init, lm_final, ref, lm_batches, want, long_want
    torch.cuda.ipc_collect()
    gc.collect()
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = tf32
    log("models_sharded", f"phase {time.perf_counter() - t_phase:.1f} s (the 4-rank world "
        f"{t_world:.1f} s, spawn included); {smi}")
    return {"train": r0["train"], "tt_train": r0["tt_train"], "recall": rec, "ivf_recall": ivf,
            "calls": r0["calls"], "hash_calls": r0["hash_calls"],
            "dryrun": dry}


def recall_of(ids: np.ndarray, gt) -> float:
    from repro_torch.core.utils import recall_at_k

    return float(recall_at_k(torch.from_numpy(ids), gt.cpu()))


QWEN_FULL = ["--arch", "qwen2.5-3b", "--preset", "full", "--batch", "1", "--seq", "512",
             "--steps", "4", "--device", "cuda"]
ENCODER = types.SimpleNamespace(size="100m", steps=300, batch=64, seq=32, ckpt_every=50,
                                preempt_at=150, corpus=262_144, k=10, search_batch=4096)
ENCODER_RECALL_FLOOR = 0.5
LOSS_FALL = 0.5


def lm_param_count(cfg) -> int:
    """Parameters of the LM, from its config."""
    from repro_torch.models import transformer as tfm

    return sum(p.numel() for p in tfm.Transformer(cfg, device="meta").parameters())


def phase_train_full(smi: str) -> dict:
    """(b) qwen2.5-3b at its published widths through ``launch.train.main``:
    each step timed (synchronized on both sides), the peak device memory
    beside the reckoning made before the run."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import train as train_cli
    from repro_torch.training import train_loop

    cfg = get_arch("qwen2.5-3b").config
    n = lm_param_count(cfg)
    reckon = 16 * n  # float32 params, grads, mu and nu
    steps, kept = [], []
    real = train_loop.make_train_step
    real_task = train_cli.build_task

    def keep_model(*a, **k):
        out = real_task(*a, **k)
        kept.append(out[0])
        return out

    def timed_step(*a, **k):
        step = real(*a, **k)

        def f(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(*args, **kw)
            torch.cuda.synchronize()
            m = out[2]
            steps.append((time.perf_counter() - t0, float(m["loss"]), float(m["grad_norm"])))
            return out
        return f

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with mock.patch.object(train_loop, "make_train_step", timed_step), \
            mock.patch.object(train_cli, "build_task", keep_model):
        train_cli.main(QWEN_FULL)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    tokens = 1 * 512
    flops = 6 * cfg.flops_params() * tokens
    for i, (sec, loss, gnorm) in enumerate(steps):
        log("train", f"qwen2.5-3b full width, step {i}: {sec * 1e3:.1f} ms, {tokens / sec:.0f} "
            f"tokens/s, loss {loss:.4f}, grad norm {gnorm:.4g}, model FLOP/s {flops / sec / 1e12:.1f} T "
            f"= {flops / sec / PEAK_OPS[torch.bfloat16]:.2%} of the bf16 peak ({smi})")
    if len(steps) != 4 or not all(math.isfinite(v) for _, l, g in steps for v in (l, g)):
        raise AssertionError(f"qwen2.5-3b: {len(steps)} steps, losses and norms {steps}")
    log("train", f"qwen2.5-3b: {n / 1e9:.3f} B parameters ({cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}, {str(cfg.dtype).removeprefix('torch.')} compute); peak device memory {peak / 2**30:.2f} GiB against the "
        f"reckoning's {reckon / 2**30:.2f} GiB of float32 params, grads, mu and nu "
        f"(+{(peak - reckon) / 2**30:.2f} GiB of activations and temporaries), of "
        f"{total / 2**30:.2f} GiB; whole run {wall:.1f} s with init")
    if peak >= total:
        raise AssertionError("qwen2.5-3b: the peak reached the card's memory")
    med = statistics.median(s for s, _, _ in steps[1:])
    return {"step_ms": med * 1e3, "peak_gib": peak / 2**30, "peak_bytes": peak,
            "reckon_gib": reckon / 2**30,
            "tokens_per_s": tokens / med, "mfu": flops / med / PEAK_OPS[torch.bfloat16],
            "model": kept[0]}


def timed_manager(directory: str):
    """A ``CheckpointManager`` whose ``secs`` and ``saves`` sum its saves."""
    from repro_torch.training import checkpoint as ckpt_lib

    mgr = ckpt_lib.CheckpointManager(directory)
    mgr.secs, mgr.saves, save = 0.0, 0, mgr.save

    def timed(step, tree):
        t0 = time.perf_counter()
        out = save(step, tree)
        mgr.secs += time.perf_counter() - t0
        mgr.saves += 1
        return out

    mgr.save = timed
    return mgr


def phase_train_encoder(dev, smi: str) -> dict:
    """(c) The encoder example at its 100m preset, trained twice under
    deterministic algorithms: an uninterrupted run that checkpoints at step
    150, and a run that starts from that checkpoint alone, is preempted
    there, restarts from it and runs to the end, checkpointing every 50
    steps. Both end with the same weights, and steps 150-299 with the same
    losses, bit for bit; the loss falls. Then 262,144 passages and their
    queries are encoded, LIDER built and searched through the kernels
    (launches counted, the first 8 queries against the all-plain search,
    each recorded kernel call held against its plain version and timed)."""
    from repro_torch import testing
    from repro_torch.core import lider
    from repro_torch.core.baselines import flat_search
    from repro_torch.core.utils import recall_at_k

    ex = testing.load_example("train_encoder_e2e_torch")
    cfg = ex.PRESETS[ENCODER.size]
    kw = dict(steps=ENCODER.steps, batch=ENCODER.batch, seq=ENCODER.seq, device=dev)
    at = ENCODER.preempt_at
    ckdir = ROOT / "build" / "encoder_ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    # Deterministic algorithms, without their NaN fill of every new
    # allocation (it guards reads of uninitialized memory, which no op here
    # makes; a read would show as a difference between the two runs).
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        whole = timed_manager(str(ckdir / "whole"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a, la, ra = ex.train(cfg, manager=whole, checkpoint_every=at, **kw)
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0 - whole.secs
        (ckdir / "restarted").mkdir()
        os.rename(ckdir / "whole" / f"step_{at:08d}", ckdir / "restarted" / f"step_{at:08d}")
        restarted = timed_manager(str(ckdir / "restarted"))
        t0 = time.perf_counter()
        b, lb, rb = ex.train(cfg, manager=restarted, checkpoint_every=ENCODER.ckpt_every,
                             preempt_at=at, **kw)
        torch.cuda.synchronize()
        t_restart = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = True
        shutil.rmtree(ckdir, ignore_errors=True)
    same = all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    if (ra, rb) != (0, 1) or len(la) != ENCODER.steps or lb != la[at:] or not same:
        raise AssertionError(f"encoder: restarts {ra}, {rb}; {len(la)} and {len(lb)} losses, "
                             f"steps {at}-{ENCODER.steps - 1} equal {lb == la[at:]}; final "
                             f"weights equal {same}")
    del a
    n_params = sum(p.numel() for p in b.parameters())
    tokens = 2 * ENCODER.batch * ENCODER.seq
    step_ms = t_plain / ENCODER.steps * 1e3
    tail = statistics.mean(la[-30:])
    log("train", f"encoder {cfg.name} ({n_params / 1e6:.1f} M parameters, "
        f"{str(cfg.dtype).removeprefix('torch.')} compute): "
        f"{ENCODER.steps} steps at batch {ENCODER.batch} x seq {ENCODER.seq} in {t_plain:.1f} s "
        f"({step_ms:.2f} ms a step, {tokens / step_ms * 1e3:.0f} tokens/s; {smi}) and "
        f"{whole.saves} checkpoints in {whole.secs:.1f} s; restarted from its step-{at} "
        f"checkpoint, preempted there, restored again and run to step {ENCODER.steps} with "
        f"checkpoints every {ENCODER.ckpt_every} steps: {t_restart:.1f} s ({restarted.saves} "
        f"saves {restarted.secs:.1f} s); final weights and the losses of steps {at}-"
        f"{ENCODER.steps - 1} equal bit for bit; loss {la[0]:.4f} at step 0, mean of the last "
        f"30 {tail:.4f} (must be at most {LOSS_FALL} x the first)")
    if not tail <= LOSS_FALL * la[0]:
        raise AssertionError(f"encoder: the loss did not fall ({la[0]} -> {tail})")

    n = ENCODER.corpus
    kq, kp = ex.paired_batch(ex.PASSAGE_SEED, 0, batch=n, seq=ENCODER.seq, vocab=cfg.vocab,
                             device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    corpus, queries = ex.encode_all(b, kp), ex.encode_all(b, kq)
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t0
    del b, kq, kp
    icfg = ex.index_config(n)
    build_calls = []
    built = build_counted("train", dev, corpus, icfg, calls=build_calls, seed=2)
    params = built.params
    log("train", f"encoded {n} passages and {n} queries in {t_enc:.2f} s "
        f"({2 * n / t_enc:.0f} sequences/s); LIDER build (c={icfg.n_clusters}, H={icfg.n_arrays}, "
        f"W_i={icfg.n_leaves}, {icfg.kmeans_iters} Lloyd steps) {built.secs:.2f} s "
        f"({fmt_stages(built)}); capacity Lp={built.stats.capacity}")

    k = ENCODER.k
    search = lambda q: lider.search_lider(params, q, k=k, n_probe=10, r0=4)
    nb = ENCODER.search_batch
    batches = [queries[i : i + nb] for i in range(0, n, nb)]
    kernel_calls = []
    with recording(kernel_calls):
        search(batches[0])
    torch.cuda.synchronize()
    if [c[0] for c in kernel_calls] != ["lsh_hash", "fused_verify"] * 2:
        raise AssertionError(f"encoder: one search batch made kernel calls {[c[0] for c in kernel_calls]}")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = torch.cat([search(qb).ids for qb in batches])
    torch.cuda.synchronize()
    t_search = time.perf_counter() - t0
    counts = read_counts()
    want = tuple(len(batches) * v for v in per_batch("F32"))
    if counts != want:
        raise AssertionError(f"encoder search: kernel launches {counts}, expected {want}")
    gt = torch.cat([flat_search(corpus, qb, k=k).ids for qb in batches])
    rec, mrr = float(recall_at_k(ids, gt)), ex.mrr(ids)
    log("train", f"{n} queries in {len(batches)} batches of {nb} at k={k}, n_probe 10, r0 4: "
        f"{t_search:.2f} s ({n / t_search:.0f} queries/s); launches {fmt_counts(counts)} "
        f"({per_batch('F32')} per batch, as the code predicts); recall@{k} vs Flat {rec:.4f} "
        f"(floor {ENCODER_RECALL_FLOOR}); MRR@{k} of the true passage {mrr:.4f}")
    if rec < ENCODER_RECALL_FLOOR:
        raise AssertionError(f"encoder: recall@{k} {rec} below {ENCODER_RECALL_FLOOR}")
    log("train", "first 8 queries: " + against_plain(params, search, batches[0][:8]))

    calls = []
    reps = {"k-means step": 5, "bank fit": 20, "centroid fit": 50}
    for name, args, kw_ in build_calls:
        role = build_role(name, args, icfg.n_clusters)
        calls.append(time_build_call("encoder", role, name, args, kw_, reps=reps[role]))
    for role, (name, args, kw_), (reps_, chunk) in zip(
        ("query hash (centroids)", "routing", "query hash (bank)", "in-cluster"), kernel_calls,
        ((50, 0), (20, 256), (50, 0), (5, 8)),
    ):
        if name == "lsh_hash":
            calls.append(time_build_call("encoder", role, name, args, kw_, reps=reps_))
        else:
            calls.append(time_call("encoder", role, name, args, kw_, reps=reps_, chunk=chunk))
    return {"calls": calls, "recall": rec, "mrr": mrr, "step_ms": step_ms, "encode_s": t_enc,
            "build_s": built.secs, "build_launches": built.counts, "search_launches": counts}


def phase_train(dev, smi: str) -> dict:
    """(a) the card against the CPU, (b) qwen2.5-3b at full width, (c) the
    100m encoder, its restart, its index and its search."""
    from repro_torch import testing
    from repro_torch.configs import get_arch

    t0 = time.perf_counter()
    log("train", f"device memory held at the start: {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    for arch_id, cfg in testing.card_configs().items():
        if get_arch(arch_id).family != "lm":
            continue  # the models phase's
        out = testing.card_against_cpu(cfg, batch=2, seq=64)
        log("train", f"card == CPU on reduced {arch_id} (float32, TF32 off, {cfg.n_layers} layers, "
            f"window {cfg.window}, MoE {cfg.moe is not None}): loss {out['loss']:.6f} within "
            f"{out['loss_err']:.3f} of its tolerance, {out['n_grads']} gradients, the worst "
            f"({out['worst']}) at {out['grad_err']:.3f} of its tolerance")
    full = phase_train_full(smi)
    enc = phase_train_encoder(dev, smi)
    log("train", f"train phase {time.perf_counter() - t0:.1f} s")
    return {"full": full, **enc}


# The models phase: the recsys and GNN families and LM serving.
#
# LIDER's recall@100 over the two-tower items against their exact top-100
# must reach RECALL_FLOOR (catches garbage only) at RECALL_PROBES probes.
# At the main path's 20 probes no index can reach it on these items: two
# towers trained on the reference's random (user, item) pairs stay at
# chance (loss ln B), their item embeddings have no cluster structure
# (the largest of 2,048 clusters holds 1.16 x the mean), and an exact scan
# of the 20 clusters whose centroids score highest (IVF-Flat) reaches
# 0.15. There LIDER must keep LIDER_OF_IVF of IVF-Flat's recall; the exact
# scan of the clusters LIDER routes to is logged beside it.
#
# The decode logits must agree with the teacher-forced forward on the
# argmax at DECODE_ARGMAX of the positions and within DECODE_REL_F32 of
# the largest logit in float32 compute. In bfloat16 compute they must stay
# within DECODE_REL, and where the argmax differs the forward's top two
# logits must lie within NEAR_TIE of the largest logit of each other (a
# near-tie that one bfloat16 rounding order flips and another does not).
TWO_TOWER = types.SimpleNamespace(
    batch=16_384,  # the train_batch shape's 65,536 cut: its in-batch logits are 17.2 GB a copy
    steps=50, encode_chunk=262_144, n_clusters=2048, users=4096, user_batch=512, k=100,
    plain_users=64, plain_batch=16,
)
GNN_LG = types.SimpleNamespace(shape="minibatch_lg", steps=10)
LM_SERVE = types.SimpleNamespace(batch=8, prompt=512, steps=32)  # decode_32k's 128 x 32,768 cut
DECODE_ARGMAX, DECODE_REL = 0.99, 2e-2
# Set from the readings on an H100 (PERF.md, PR 22): float32 compute's
# largest difference 5.1e-6 to 5.8e-6; in bfloat16 compute the top-2 gap
# was at most 0.0074 where the argmax flipped and 0.034 at the median
# position.
DECODE_REL_F32 = 1e-4
NEAR_TIE = 0.015
RECALL_PROBES = 256  # c / 8


def phase_models_card(smi: str) -> None:
    """(a) The reduced config of each recsys and GNN architecture, card ==
    CPU (float32, TF32 off), and the reduced LMs' prefill and decode
    logits, card == CPU."""
    from repro_torch import testing
    from repro_torch.configs import get_arch

    for arch_id, cfg in testing.card_configs().items():
        if get_arch(arch_id).family == "lm":
            out = testing.serve_card_against_cpu(cfg)
            log("models", f"card == CPU, LM serving on reduced {arch_id} (float32, TF32 off, "
                f"{cfg.n_layers} layers, window {cfg.window}): prefill of 16 tokens at "
                f"{out['prefill_err']:.3f} and one decode step at {out['decode_err']:.3f} of the "
                "tolerance (rtol 1e-5)")
            continue
        out = testing.card_against_cpu(cfg)
        log("models", f"card == CPU on reduced {arch_id} (float32, TF32 off): loss "
            f"{out['loss']:.6f} within {out['loss_err']:.3f} of its tolerance, {out['n_grads']} "
            f"gradients, the worst ({out['worst']}) at {out['grad_err']:.3f} of its tolerance")


@contextlib.contextmanager
def compute_dtype(model, dtype):
    """The transformer computing in ``dtype`` (its float32 master weights
    cast to it, as they are to the config's dtype)."""
    cfgs = [model.cfg] + [blk.cfg for blk in model.layers]
    new = dataclasses.replace(model.cfg, dtype=dtype)
    model.cfg = new
    for blk in model.layers:
        blk.cfg = new
    try:
        yield model
    finally:
        model.cfg = cfgs[0]
        for blk, c in zip(model.layers, cfgs[1:]):
            blk.cfg = c


def decode_against_forward(model, tokens, prompt: int) -> dict:
    """Prefill of ``prompt`` tokens, then one decode step a token to the
    end of ``tokens``, timed; each step's logits beside the teacher-forced
    forward's at the same position (the forward's attention takes whole
    512-token chunks: the tokens padded to the next multiple of 512, which
    causal attention keeps from every earlier position)."""
    from repro_torch.models import transformer as tfm

    total = tokens.shape[1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = tfm.prefill(model, tokens[:, :prompt], max_len=total)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    steps, secs = [logits], []
    for i in range(prompt, total):
        t0 = time.perf_counter()
        out, cache = tfm.decode_step(model, cache, tokens[:, i : i + 1])
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        steps.append(out)
    got = torch.stack(steps, 1)  # positions prompt-1 .. total-1
    padded = torch.nn.functional.pad(tokens, (0, -total % 512))
    with torch.no_grad():
        hidden, _ = model(padded)
        want = (hidden[:, prompt - 1 : total] @ model.lm_head.to(model.cfg.dtype)).float()
    del hidden
    top2 = want.topk(2, dim=-1).values
    gap = (top2[..., 0] - top2[..., 1]) / want.abs().amax(-1)
    differ = got.argmax(-1) != want.argmax(-1)
    near = float((gap <= NEAR_TIE).float().mean())
    return {"prefill_s": t_prefill, "secs": secs, "agree": 1 - float(differ.float().mean()),
            "rel": float((got - want).abs().max() / want.abs().max()),
            "differ": int(differ.sum()), "at_prefill": int(differ[:, 0].sum()),
            "gap_differ": float(gap[differ].max()) if bool(differ.any()) else 0.0,
            "gap_median": float(gap.median()), "near_tie": near, "cache": cache}


def decode_profile(model, cache, token) -> str:
    """One decode step under ``torch.profiler``: the card's busy time by
    kernel (the five largest) beside the step's wall time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import transformer as tfm

    cache = dict(cache, length=cache["length"] - 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tfm.decode_step(model, cache, token)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by: dict = {}
    for e in ev:
        by[e.name] = by.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by.values())
    top = sorted(by.items(), key=lambda kv: -kv[1])[:5]
    return (f"one decode step under the profiler: {wall * 1e3:.2f} ms wall, {len(ev)} kernels, "
            f"{busy / 1e3:.2f} ms of device time ({busy / 1e3 / (wall * 1e3):.1%} busy); largest: "
            + "; ".join(f"{n[:60]} {us / 1e3:.2f} ms" for n, us in top))


def phase_models_serve(dev, smi: str, model) -> dict:
    """(d) qwen2.5-3b at its published widths (the train phase's model):
    a prompt of 512 tokens for a batch of 8, then 32 decode steps from the
    KV cache (length 544), each step's logits held against the
    teacher-forced forward of the same 544 tokens, in the model's bfloat16
    compute; then the same in float32 compute on the same weights."""
    from repro_torch.models import transformer as tfm

    cfg, n = model.cfg, LM_SERVE
    total = n.prompt + n.steps
    g = torch.Generator(device=dev).manual_seed(SEED)
    tokens = torch.randint(0, cfg.vocab, (n.batch, total), generator=g, device=dev)
    model.requires_grad_(False)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tfm.prefill(model, tokens[:, : n.prompt])  # warm-up: the timed prefill is the second
    r = decode_against_forward(model, tokens, n.prompt)
    peak = torch.cuda.max_memory_allocated()
    prof = decode_profile(model, r.pop("cache"), tokens[:, -1:])
    with compute_dtype(model, torch.float32):
        r32 = decode_against_forward(model, tokens, n.prompt)
    r32.pop("cache")
    step_ms = statistics.median(r["secs"]) * 1e3
    t_prefill = r["prefill_s"]
    desc = lambda x: (f"argmax equal at {x['agree']:.2%} ({x['differ']} positions differ, "
                      f"{x['at_prefill']} of them the prefill's; the forward's top-2 gap there at "
                      f"most {x['gap_differ']:.3g} of the largest logit, median gap over all "
                      f"{x['gap_median']:.3g}; {x['near_tie']:.2%} of the positions within "
                      f"{NEAR_TIE}), largest difference {x['rel']:.4g} of the largest logit")
    log("models", f"qwen2.5-3b serving at full width (bf16 compute; {smi}): prefill of "
        f"{n.batch} x {n.prompt} tokens {t_prefill * 1e3:.1f} ms ({n.batch * n.prompt / t_prefill:.0f} "
        f"tokens/s), {n.steps} decode steps from a cache of {total}: median {step_ms:.2f} ms a step "
        f"({n.batch / step_ms * 1e3:.0f} tokens/s; first {r['secs'][0] * 1e3:.2f} ms); peak device "
        f"memory {peak / 2**30:.2f} GiB; against the teacher-forced forward of the {total} tokens "
        f"at the {n.steps + 1} positions: {desc(r)} (gates: difference at most {DECODE_REL}, the "
        f"top-2 gap where the argmax differs at most {NEAR_TIE}); {prof}")
    log("models", f"the same in float32 compute: prefill {r32['prefill_s'] * 1e3:.1f} ms, decode "
        f"median {statistics.median(r32['secs']) * 1e3:.2f} ms a step; {desc(r32)} (gates: "
        f"argmax {DECODE_ARGMAX:.0%}, difference {DECODE_REL_F32})")
    if not (r32["agree"] >= DECODE_ARGMAX and r32["rel"] <= DECODE_REL_F32):
        raise AssertionError(f"qwen2.5-3b decode, float32: argmax agreement {r32['agree']}, "
                             f"difference {r32['rel']}")
    if not (r["rel"] <= DECODE_REL and r["gap_differ"] <= NEAR_TIE):
        raise AssertionError(f"qwen2.5-3b decode, bfloat16: difference {r['rel']}; an argmax "
                             f"differs where the forward's top-2 gap is {r['gap_differ']}")
    return {"prefill_ms": t_prefill * 1e3, "decode_ms": step_ms, "peak_gib": peak / 2**30,
            "argmax_agree": r["agree"], "rel_diff": r["rel"], "f32": r32}


def phase_models_two_tower(dev, smi: str) -> dict:
    """(b) two-tower-retrieval at its published widths: trained through
    ``launch.train``'s ``build_task`` and ``train_loop``, every item encoded
    through the item tower, LIDER built over the items and searched with
    the user tower's outputs through the kernels."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.lider_msmarco import CONFIG
    from repro_torch.core import lider
    from repro_torch.core.baselines import flat_search
    from repro_torch.core.utils import l2_normalize, recall_at_k
    from repro_torch.data import pipeline as pipe_lib
    from repro_torch.data import synthetic
    from repro_torch.launch import train as train_cli
    from repro_torch.models import recsys
    from repro_torch.testing import assert_topk_match
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training import train_loop

    tt = TWO_TOWER
    cfg = get_arch("two-tower-retrieval").config
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    model, loss_fn, batch_at = train_cli.build_task("two-tower-retrieval", "full", tt.batch, 0,
                                                    device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    opt_cfg = opt_lib.OptimizerConfig(warmup_steps=max(tt.steps // 10, 1), decay_steps=tt.steps)
    opt_state = opt_lib.init_state(dict(model.named_parameters()))
    real = train_loop.make_train_step(loss_fn, opt_cfg)
    secs, losses = [], []

    def step(*a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*a)
        losses.append(float(out[2]["loss"]))
        secs.append(time.perf_counter() - t0)
        return out

    pipe = pipe_lib.DataPipeline(batch_at, prefetch=2)
    try:
        train_loop.run(step, model, opt_state, pipe, n_steps=tt.steps, log_every=0)
    finally:
        pipe.close()
    peak_train = torch.cuda.max_memory_allocated() - held
    del opt_state
    gc.collect()
    torch.cuda.empty_cache()
    step_ms = statistics.median(secs[1:]) * 1e3
    log("models", f"two-tower-retrieval at its published widths ({n_params / 1e6:.1f} M "
        f"parameters: embed {cfg.embed_dim}, towers {cfg.tower_dims}, item_vocab {cfg.item_vocab}, "
        f"field_vocab {cfg.field_vocab} x {cfg.n_user_fields} user fields): {tt.steps} steps at "
        f"batch {tt.batch} (cut from 65,536), median {step_ms:.2f} ms a step (first "
        f"{secs[0] * 1e3:.1f} ms; {tt.batch / step_ms * 1e3:.0f} examples/s; {smi}); loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; peak device memory {peak_train / 2**30:.2f} GiB "
        f"(reckoned ~{16 * n_params / 1e9:.1f} GB of weights, gradients and AdamW moments)")
    if not all(math.isfinite(v) for v in losses) or len(losses) != tt.steps:
        raise AssertionError(f"two-tower: {len(losses)} losses, {losses}")

    n = cfg.item_vocab
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        embs = torch.empty((n, cfg.tower_dims[-1]), device=dev)
        for s in range(0, n, tt.encode_chunk):
            ids = torch.arange(s, min(s + tt.encode_chunk, n), dtype=torch.int32, device=dev)
            items = torch.stack([ids, torch.zeros_like(ids)], dim=1)
            embs[s : s + ids.shape[0]] = l2_normalize(recsys.item_embed(model, items))
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t0

    icfg = dataclasses.replace(CONFIG.lider, n_clusters=tt.n_clusters)
    build_calls = []
    built = build_counted("models", dev, embs, icfg, calls=build_calls, seed=SEED)
    params = built.params
    sizes = torch.bincount(built.km.assignment.to(torch.int64), minlength=icfg.n_clusters)
    log("models", f"encoded {n} items in {t_enc:.2f} s ({n / t_enc:.0f} items/s); LIDER build "
        f"(c={icfg.n_clusters}, {icfg.kmeans_iters} Lloyd steps, float32) {built.secs:.2f} s "
        f"({fmt_stages(built)}); largest cluster {int(sizes.max())}, Lp {built.stats.capacity}, "
        f"bank {icfg.n_clusters * built.stats.capacity * embs.shape[1] * 4 / 1e9:.2f} GB, "
        f"{built.stats.n_dropped} items dropped; " + lloyd_sums(embs, built.km.assignment,
                                                               icfg.n_clusters)
        + f"; k-means {built.stages.get('k-means', 0.0) / icfg.kmeans_iters * 1e3:.1f} ms a Lloyd "
        "step with its assignment")

    users = synthetic.recsys_batch(SEED, 10**6, kind="two_tower", batch=tt.users, cfg=cfg,
                                   device=dev)["user_fields"]
    ub = [users[i : i + tt.user_batch] for i in range(0, tt.users, tt.user_batch)]
    with torch.no_grad():
        qs = [l2_normalize(recsys.user_embed(model, u)) for u in ub]
    k = tt.k
    search = lambda q: lider.search_lider(params, q, k=k, n_probe=icfg.n_probe, r0=icfg.r0,
                                          r0_centroid=icfg.r0_centroid)
    kernel_calls = []
    with recording(kernel_calls):
        search(qs[0])
    torch.cuda.synchronize()
    if [c[0] for c in kernel_calls] != ["lsh_hash", "fused_verify"] * 2:
        raise AssertionError(f"two-tower: one search batch made kernel calls {[c[0] for c in kernel_calls]}")
    reset_counts()
    torch.cuda.synchronize()
    batch_s = []
    outs = []
    for q in qs:
        t0 = time.perf_counter()
        outs.append(search(q))
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t0)
    counts = read_counts()
    want = tuple(len(qs) * v for v in per_batch("F32"))
    if counts != want:
        raise AssertionError(f"two-tower search: kernel launches {counts}, expected {want}")
    ids = torch.cat([o.ids for o in outs])
    gts, swaps = [], 0
    for u, q in zip(ub, qs):
        sc, cand = recsys.two_tower_score_candidates(model, u, embs, k)
        flat = flat_search(embs, q, k=k)
        swaps += assert_topk_match(cand, sc, flat.ids, flat.scores)
        gts.append(flat.ids)
        del sc, cand
    gt = torch.cat(gts)
    rec = float(recall_at_k(ids, gt))
    # The gap to IVF-Flat split in two: the exact scan of the clusters
    # LIDER's centroid layer routes to (what routing keeps) and LIDER's
    # own search of them (what the in-cluster layer keeps of that).
    q_all = torch.cat(qs)
    exact_c = torch.topk(q_all @ params.centroids.T, icfg.n_probe, dim=-1).indices
    routed_c = torch.cat([lider.route_queries(params, q, n_probe=icfg.n_probe,
                                              r0=icfg.r0_centroid).ids for q in qs])
    if bool((routed_c < 0).any()):
        raise AssertionError("two-tower: routing returned fewer clusters than n_probe")
    ivf = float(recall_at_k(exact_scan_ids(params, q_all, exact_c, k), gt))
    routed = float(recall_at_k(exact_scan_ids(params, q_all, routed_c, k), gt))
    overlap = float((routed_c[:, :, None] == exact_c[:, None, :]).any(-1).float().mean())
    wider = {}
    for p in (4 * icfg.n_probe, RECALL_PROBES):
        got = torch.cat([lider.search_lider(params, q, k=k, n_probe=p, r0=icfg.r0,
                                            r0_centroid=icfg.r0_centroid).ids for q in qs])
        wider[p] = float(recall_at_k(got, gt))
    ms = statistics.median(batch_s) * 1e3
    log("models", f"{tt.users} users in {len(qs)} batches of {tt.user_batch} at k={k}, n_probe "
        f"{icfg.n_probe}: median {ms:.2f} ms a batch ({tt.user_batch / ms * 1e3:.0f} queries/s); "
        f"launches {fmt_counts(counts)} ({per_batch('F32')} per batch, as the code predicts); "
        f"two_tower_score_candidates == flat_search over the {n} items ({swaps} near-tie swaps); "
        f"recall@{k} of LIDER against that exact top-{k}: {rec:.4f} at n_probe {icfg.n_probe} "
        f"(IVF-Flat, an exact scan of the {icfg.n_probe} clusters whose centroids score highest: "
        f"{ivf:.4f}, so LIDER keeps {rec / ivf:.3f} of it, floor {LIDER_OF_IVF}; an exact scan of "
        f"the {icfg.n_probe} clusters LIDER routes to: {routed:.4f}, {overlap:.2%} of them among "
        "the highest-scoring), " + ", ".join(f"{r:.4f} at n_probe {p}" for p, r in wider.items())
        + f" (floor {RECALL_FLOOR} at n_probe {RECALL_PROBES})")
    if rec < LIDER_OF_IVF * ivf:
        raise AssertionError(f"two-tower: recall@{k} {rec} at n_probe {icfg.n_probe} below "
                             f"{LIDER_OF_IVF} of IVF-Flat's {ivf}")
    if wider[RECALL_PROBES] < RECALL_FLOOR:
        raise AssertionError(f"two-tower: recall@{k} {wider[RECALL_PROBES]} at n_probe "
                             f"{RECALL_PROBES} below {RECALL_FLOOR}")
    pq = torch.cat(qs)[: tt.plain_users]
    for i in range(0, tt.plain_users, tt.plain_batch):
        msg = against_plain(params, search, pq[i : i + tt.plain_batch])
    log("models", f"the first {tt.plain_users} users in batches of {tt.plain_batch} against the "
        f"all-plain search: each batch's keys compared, ids equal, scores within rtol 1e-5 (last "
        f"batch: {msg})")

    calls = []
    reps = {"k-means step": 5, "bank fit": 20, "centroid fit": 50}
    for name, args, kw_ in build_calls:
        role = build_role(name, args, icfg.n_clusters)
        calls.append(time_build_call("models", role, name, args, kw_, reps=reps[role]))
    for role, (name, args, kw_), (reps_, chunk) in zip(
        ("query hash (centroids)", "routing", "query hash (bank)", "in-cluster"), kernel_calls,
        ((50, 0), (20, 256), (50, 0), (5, 8)),
    ):
        if name == "lsh_hash":
            calls.append(time_build_call("models", role, name, args, kw_, reps=reps_))
        else:
            calls.append(time_call("models", role, name, args, kw_, reps=reps_, chunk=chunk))
    return {"calls": calls, "recall": rec, "recall_wide": wider, "ivf_recall": ivf,
            "routed_recall": routed, "routed_overlap": overlap,
            "step_ms": step_ms, "encode_s": t_enc,
            "build_s": built.secs, "batch_ms": ms, "peak_train_gib": peak_train / 2**30,
            "build_launches": built.counts, "search_launches": counts}


def ivf_recall(params, queries, gt, cfg, k: int) -> dict:
    """Recall@k against ``gt`` of an exact scan of each query's
    ``cfg.n_probe`` clusters: those whose centroids score highest
    (IVF-Flat, ``ivf``) and those LIDER's centroid layer routes to
    (``routed``), two queries at a time (a query's clusters are 1 GB of
    rows at the reference's size)."""
    from repro_torch.core import lider
    from repro_torch.core.utils import recall_at_k

    exact_c = torch.topk(queries @ params.centroids.T, cfg.n_probe, dim=-1).indices
    routed_c = torch.cat([lider.route_queries(params, q, n_probe=cfg.n_probe,
                                              r0=cfg.r0_centroid).ids for q in queries.split(BATCH)])
    return {name: float(recall_at_k(exact_scan_ids(params, queries, c, k, chunk=2), gt))
            for name, c in (("ivf", exact_c), ("routed", routed_c))}


def exact_scan_ids(params, q, cids, k: int, chunk: int = 64) -> torch.Tensor:
    """The top ``k`` ids of an exact scan of each query's clusters ``cids``
    (B, P) over the index's own rows, ``chunk`` queries at a time. With the
    clusters whose centroids score highest, this is IVF-Flat."""
    bank = params.bank
    out = []
    for s in range(0, q.shape[0], chunk):
        qc, cc = q[s : s + chunk], cids[s : s + chunk]
        gids = bank.gids[cc].reshape(qc.shape[0], -1)  # (B, P * Lp)
        sc = torch.einsum("bpld,bd->bpl", bank.embs[cc], qc).reshape(qc.shape[0], -1)
        sc = torch.where(gids >= 0, sc, float("-inf"))
        out.append(torch.gather(gids, 1, torch.topk(sc, k, dim=-1).indices))
    return torch.cat(out)


def phase_models_gnn(dev, smi: str) -> dict:
    """(c) gatedgcn at the ``minibatch_lg`` dims: a random graph of
    232,965 nodes and 114,615,892 edges on the card, 1,024 seeds sampled
    with fanout (15, 10), 16 layers of 70, 10 training steps on fresh
    blocks. Each block's shape is checked, and the first block's every edge
    against the graph: a sampled neighbour joined to its parent, or a
    self-loop at a node of degree 0."""
    from repro_torch.configs import get_arch
    from repro_torch.data import synthetic
    from repro_torch.models import gnn
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training import train_loop

    arch = get_arch("gatedgcn")
    dims = arch.shape(GNN_LG.shape).dims
    nn_, ne = dims["n_nodes"], dims["n_edges"]
    b, fan = dims["batch_nodes"], dims["fanout"]
    cfg = dataclasses.replace(arch.config, d_feat=dims["d_feat"], n_classes=dims["n_classes"])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graph = synthetic.random_graph(SEED, nn_, ne, cfg.d_feat, cfg.n_classes, device=dev)
    torch.cuda.synchronize()
    t_graph = time.perf_counter() - t0
    model = gnn.init(SEED, cfg, device=dev)
    opt_state = opt_lib.init_state(dict(model.named_parameters()))
    step = train_loop.make_train_step(gnn.train_loss, opt_lib.OptimizerConfig(
        warmup_steps=1, decay_steps=GNN_LG.steps))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n_block = b * (1 + fan[0] + fan[0] * fan[1])
    n_edges = b * (fan[0] + fan[0] * fan[1])
    sample_s, step_s, losses = [], [], []
    for i in range(GNN_LG.steps):
        t0 = time.perf_counter()
        seeds = torch.randperm(nn_, generator=gen, device=dev)[:b].to(torch.int32)
        block = gnn.neighbor_sample(gen, graph["indptr"], graph["indices"], graph["node_feat"],
                                    graph["labels"], seeds, fan)
        torch.cuda.synchronize()
        sample_s.append(time.perf_counter() - t0)
        if block["node_feat"].shape[0] != n_block or tuple(block["edge_index"].shape) != (2, n_edges):
            raise AssertionError(f"gatedgcn block: {block['node_feat'].shape[0]} nodes, edges "
                                 f"{tuple(block['edge_index'].shape)}; expected {n_block}, {n_edges}")
        if i == 0:
            bad = block_edges_outside(graph, block)
            if bad:
                raise AssertionError(f"gatedgcn block: {bad} edges join no neighbour to its parent")
        batch = {k: block[k] for k in ("node_feat", "edge_index", "labels", "label_mask")}
        t0 = time.perf_counter()
        model, opt_state, m = step(model, opt_state, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    step_ms = statistics.median(step_s[1:]) * 1e3
    log("models", f"gatedgcn at minibatch_lg ({cfg.n_layers} layers x {cfg.d_hidden}, d_feat "
        f"{cfg.d_feat}, {cfg.n_classes} classes; {smi}): random graph of {nn_} nodes and {ne} edges "
        f"with its CSR in {t_graph:.2f} s; blocks of {b} seeds at fanout {fan}: {n_block} nodes "
        f"({b} + {b * fan[0]} + {b * fan[0] * fan[1]}) and {n_edges} edges, every edge of the first a sampled "
        f"neighbour to its parent or a self-loop at degree 0; sampling median "
        f"{statistics.median(sample_s) * 1e3:.2f} ms; {GNN_LG.steps} steps: median {step_ms:.2f} ms "
        f"a step (first {step_s[0] * 1e3:.1f} ms), loss {losses[0]:.4f} -> {losses[-1]:.4f}; peak "
        f"device memory {peak / 2**30:.2f} GiB")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"gatedgcn: losses {losses}")
    return {"step_ms": step_ms, "peak_gib": peak / 2**30}


def block_edges_outside(graph, block) -> int:
    """Edges of a sampled block that are neither a (parent -> child) edge
    of the graph, child a neighbour of parent in its CSR row, nor a
    self-loop at a node of degree 0."""
    n = graph["indptr"].shape[0] - 1
    src, dst = graph["edge_index"].to(torch.int64)
    keys = torch.sort(src * n + dst).values
    del src, dst
    nodes = block["block_nodes"].to(torch.int64)
    child, parent = nodes[block["edge_index"][0].long()], nodes[block["edge_index"][1].long()]
    want = parent * n + child
    pos = torch.searchsorted(keys, want).clamp(max=keys.shape[0] - 1)
    found = keys[pos] == want
    deg = (graph["indptr"][1:] - graph["indptr"][:-1]).to(torch.int64)
    loop = (deg[parent] == 0) & (child == parent)
    return int((~(found | loop)).sum())


def phase_models(dev, smi: str, qwen) -> dict:
    """(a) card against CPU, (d) LM serving at full width, (b) the
    two-tower + LIDER path at full width, (c) gatedgcn at minibatch_lg."""
    t0 = time.perf_counter()
    phase_models_card(smi)
    serve = phase_models_serve(dev, smi, qwen)
    del qwen
    gc.collect()
    torch.cuda.empty_cache()
    tt = phase_models_two_tower(dev, smi)
    gc.collect()
    torch.cuda.empty_cache()
    g = phase_models_gnn(dev, smi)
    log("models", f"models phase {time.perf_counter() - t0:.1f} s")
    return {"serve": serve, "gnn": g, **tt}


# ---------------------------------------------------------------------------
# dryrun: the dry run on the production grid, and its predictions against
# this run's own readings
# ---------------------------------------------------------------------------

# A prediction's peak (and, where given, its temporaries: the peak less
# the arguments) must come within this share of the measured one; its
# argument and collective bytes must equal the measured ones.
DRY_PEAK_REL = 0.10


def shape_checks(calls) -> list[dict]:
    """Each recorded kernel call of a distinct shape run again, by its
    ``ops`` entry on the real arguments (a launch outside every counted
    window) and on ``FakeTensor`` copies of them (the dry run's shape-only
    branch): their outputs' shapes, dtypes and devices, and the
    ``(flops, bytes)`` each reports to the dry run's counter, beside the
    kernel table's count of the same call (``least``: :func:`value_counts`
    of the call's values for a verification kernel, :func:`build_counts`
    for a build kernel)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch import counting
    from repro_torch.kernels import ops

    def reported(fn, *a, **k):
        tally = []
        with counting.counting(types.SimpleNamespace(add=lambda *c: tally.append(c))):
            res = fn(*a, **k)
        return res, [sum(c[0] for c in tally), sum(c[1] for c in tally)]

    op = {"fused_verify": ops.verify_topk_op, "sketch_prefilter": ops.sketch_topk_op,
          "fused_verify_grouped": ops.verify_topk_grouped_op, "lsh_hash": ops.lsh_hash_op,
          "kmeans_assign": ops.kmeans_assign_op}
    sig = lambda out: [(tuple(t.shape), str(t.dtype).removeprefix("torch."), t.device.type)  # noqa: E731
                       for t in (out if isinstance(out, tuple) else (out,))]
    desc = lambda v: tuple(v.shape) + (str(v.dtype),) if isinstance(v, torch.Tensor) else v  # noqa: E731
    seen, out = set(), []
    for name, args, kw in calls:
        key = (name, tuple(desc(a) for a in args), tuple(sorted((k, desc(v)) for k, v in kw.items())))
        if key in seen:
            continue
        seen.add(key)
        res, real_cost = reported(op[name], *args, **kw)
        real = sig(res)
        with FakeTensorMode() as mode:
            fake = lambda v: mode.from_tensor(v) if isinstance(v, torch.Tensor) else v  # noqa: E731
            res, fake_cost = reported(op[name], *[fake(a) for a in args],
                                      **{k: fake(v) for k, v in kw.items()})
            got = sig(res)
        if name in ("lsh_hash", "kmeans_assign"):
            least = list(build_counts(name, args, kw))
        else:
            n_bytes, n_ops, _ = value_counts(name, args, kw)
            least = [n_ops, n_bytes]
        out.append({"kernel": name, "args": [desc(a) for a in args], "real": real, "fake": got,
                    "real_cost": real_cost, "fake_cost": fake_cost, "least": least})
    torch.cuda.synchronize()
    return out


def _dry_line(what: str, pred: dict, meas: dict) -> tuple[str, list[str]]:
    """A prediction against a reading: ``pred`` and ``meas`` may hold
    ``peak`` and ``temp`` (held within DRY_PEAK_REL), ``args`` and
    ``comm`` (held equal) -> (the printed line, what missed)."""
    parts, missed = [], []
    for key, label in (("peak", "peak"), ("temp", "temporaries")):
        if key in pred:
            rel = pred[key] / meas[key] - 1
            parts.append(f"{label} predicted {pred[key] / 2**30:.4f} GiB, measured "
                         f"{meas[key] / 2**30:.4f} GiB ({rel:+.2%}; limit +-{DRY_PEAK_REL:.0%})")
            if abs(rel) > DRY_PEAK_REL:
                missed.append(label)
    if "args" in pred:
        parts.append(f"argument bytes predicted {pred['args']}, measured {meas['args']}")
        if pred["args"] != meas["args"]:
            missed.append("argument bytes")
    if "comm" in pred:
        fmt = lambda c: ", ".join(f"{k} {v['count']} calls {v['bytes']} B"  # noqa: E731
                                  for k, v in sorted(c.items())) or "none"
        parts.append(f"collectives predicted {fmt(pred['comm'])}; measured {fmt(meas['comm'])}")
        if pred["comm"] != meas["comm"]:
            missed.append("collectives")
    return f"{what}: " + "; ".join(parts) + (f" -> MISSED {missed}" if missed else " -> met"), missed


def _counts_line(what: str, rec: dict, real: dict, step_ms=None, cpu=None) -> tuple[str, list[str]]:
    """A cell's dry-run counts (``rec``, fake tensors) against the same step
    run on the card's real tensors (``real``: ``cost`` and ``comm``) and,
    where given, the dry run on fake CPU tensors (``cpu``, the same keys),
    FLOPs, bytes accessed and collectives held equal; beside them the
    counts' roofline time, max(FLOPs / the bf16 peak, bytes / the memory
    rate), and the step this run measured, where given (printed, not
    held)."""
    c, rc = rec["cost"], real["cost"]
    t_ops, t_bytes = c["flops"] / PEAK_OPS[torch.bfloat16], c["bytes_accessed"] / PEAK_BYTES_PER_S
    others = [("on the card's real tensors", real)] + ([("on fake CPU tensors", cpu)] if cpu else [])
    same = all(o["cost"] == c and o["comm"] == rec["collectives"] for _, o in others)
    line = (f"{what}: counted {c['flops']:.0f} FLOPs, {c['bytes_accessed']:.0f} bytes accessed; "
            + "; ".join(f"{label} {o['cost']['flops']:.0f}, {o['cost']['bytes_accessed']:.0f}, "
                        f"collectives {'equal' if o['comm'] == rec['collectives'] else o['comm']}"
                        for label, o in others)
            + "; roofline "
            f"max(FLOPs / 989e12, bytes / 3.35e12) = {max(t_ops, t_bytes) * 1e3:.4f} ms (by "
            f"{'FLOPs' if t_ops >= t_bytes else 'bytes'})"
            + ("" if step_ms is None else f", measured step {step_ms:.3f} ms"))
    return line + (" -> met" if same else " -> MISSED"), [] if same else [f"{what}: counts"]


def dry_lm_cells(dev) -> dict:
    """The two LM cells the dryrun phase rebuilds, each run by the dry run
    on fake tensors and again on the card's real ones: ``{"full": qwen2.5-3b
    at full width, 1 x 512, one rank; "sharded": its widths at SHARDED.layers
    layers on the SHARDED grid, rank 0 of a fake world}``, each ``(record,
    {"cost", "comm"} on real tensors, {"cost", "comm"} of the same dry run on
    fake CPU tensors)``. The CPU run's backward runs on the calling thread,
    the card's on autograd's device thread: their counts agree only if the
    collectives of that thread's backward report to the counter."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun, mesh

    qwen = get_arch("qwen2.5-3b")
    lm_cfg, _ = sharded_configs()
    cells = {"full": ((1, 1), ShapeSpec("train_1x512", "train", {"seq_len": 512, "global_batch": 1}),
                      {}),
             "sharded": (SHARDED.grid, ShapeSpec("train_sharded", "train", {
                 "seq_len": SHARDED.seq, "global_batch": SHARDED.batch}), {"cfg": lm_cfg})}
    out = {}
    for key, (shape_2d, shape, knobs) in cells.items():
        with mesh.fake_world(shape_2d[0] * shape_2d[1]):
            grid = mesh.make_grid(shape_2d, device=dev)
            rec = dryrun.measure(qwen, shape, grid, grad_accum=1, **knobs)
            real = dryrun.measure(qwen, shape, grid, grad_accum=1, fake=False, **knobs)
            cpu = dryrun.measure(qwen, shape, mesh.make_grid(shape_2d, device="cpu"),
                                 device="cpu", grad_accum=1, **knobs)
        out[key] = (rec, {"cost": real["cost"], "comm": real["collectives"]},
                    {"cost": cpu["cost"], "comm": cpu["collectives"]})
        del real
        torch.cuda.empty_cache()
    return out


def phase_dryrun(smi: str, readings: dict, checks: list[dict]) -> dict:
    """(i) The dry run of every cell on the single-pod production grid
    (rank 0 of a fake 256-rank world, worker processes side by side); (ii)
    the dry run's predictions for three cells this run measured, rebuilt
    with the same configuration, and the same three steps run again under
    the dry run's counters on the card's real tensors (FLOPs, bytes and
    collectives equal to the fake run's; the LM cells' also to the fake
    CPU run's); (iii) each kernel's shape-only output and reported cost
    against the real kernel's at the main path's shapes, and the cost
    against the kernel table's count of the call."""
    from repro_torch.launch import dryrun, mesh, steps

    t_phase = time.perf_counter()
    props = torch.cuda.get_device_properties(0)
    name = torch.cuda.get_device_name(0)
    log("dryrun", f"{name}: {props.total_memory} bytes of device memory; the dry run's card "
        f"({dryrun.CARD_NAME}) {dryrun.CARD_BYTES}")
    if (name, props.total_memory) != (dryrun.CARD_NAME, dryrun.CARD_BYTES):
        # The sweep's ``fits`` is judged against that card's memory.
        raise AssertionError(f"the dry run assumes a {dryrun.CARD_NAME} of {dryrun.CARD_BYTES} "
                             f"bytes; this card is a {name} of {props.total_memory}")

    # (i) The sweep.
    jobs = len(os.sched_getaffinity(0))
    t0 = time.perf_counter()
    recs = dryrun.sweep(["single"], emit=lambda line: log("dryrun", line))
    t_sweep = time.perf_counter() - t0
    n = {st: sum(r["status"] == st for r in recs) for st in ("ok", "skipped", "failed")}
    log("dryrun", f"single-pod sweep ({jobs} worker processes, fake {dryrun.dry_device().type} "
        f"tensors): {n['ok']} ok, {n['skipped']} skipped, {n['failed']} failed in {t_sweep:.1f} s")
    if n["failed"] or n["ok"] != 39 or n["skipped"] != 4:
        raise AssertionError(f"dry run: {n}; failed: "
                             + "; ".join(r["error"] for r in recs if r["status"] == "failed"))
    unread = [f"{r['arch']} x {r['shape']}" for r in recs if r["status"] == "ok"
              and not r["cost"]["bytes_accessed"] > 0]
    if unread:
        raise AssertionError(f"dry run: no bytes accessed counted in {unread}")

    # (ii) Predictions against this run's readings; the counts on real tensors.
    dev = dryrun.dry_device()
    lines, missed = [], []
    lm = dry_lm_cells(dev)
    what = "qwen2.5-3b full width, 1 x 512, one rank (train phase)"
    rec, real, cpu = lm["full"]
    line, miss = _dry_line(what, {"peak": rec["memory"]["peak_bytes"]},
                           {"peak": readings["train_full"]["peak_bytes"]})
    lines.append(line)
    missed += miss
    line, miss = _counts_line(what, rec, real, readings["train_full"]["step_ms"], cpu)
    lines.append(line)
    missed += miss

    sh = readings["models_sharded"]
    rec, real, cpu = lm["sharded"]
    for r, (steps_r, peak) in enumerate(zip(sh["train"], sh["peak_bytes"])):
        if any(s["comm_kinds"] != steps_r[0]["comm_kinds"] for s in steps_r):
            raise AssertionError(f"models_sharded rank {r}: the steps' collectives differ")
        line, miss = _dry_line(
            f"qwen2.5-3b widths at {SHARDED.layers} layers, 2x2 grid, rank {r} (models_sharded), "
            "a step", {"peak": rec["memory"]["peak_bytes"], "comm": rec["collectives"]},
            {"peak": peak, "comm": steps_r[0]["comm_kinds"]})
        lines.append(line)
        missed += miss
    line, miss = _counts_line(
        f"qwen2.5-3b widths at {SHARDED.layers} layers, 2x2 grid, rank 0 (models_sharded)", rec,
        real, statistics.median(s["s"] for s in sh["train"][0]) * 1e3, cpu)
    lines.append(line)
    missed += miss

    ds = readings["distributed"]
    arch, shape = dist_cell(ds)
    rcfg = arch.config
    with mesh.fake_world(4):
        grid = mesh.make_grid(DIST.grid, device=dev)
        rec = dryrun.measure(arch, shape, grid, capacity_factor=DIST.capacity_factor)
        from torch._subclasses.fake_tensor import FakeTensorMode
        with FakeTensorMode():
            bundle = steps.make_bundle(arch, shape, grid, device=dev,
                                       capacity_factor=DIST.capacity_factor)
            shard_bytes = steps.nbytes(steps.arg_tensors(bundle.args[0]))
            q_bytes = steps.nbytes(steps.arg_tensors(bundle.args[1]))
    what = (f"F32 sharded search, 2x2 grid, c {rcfg.lider.n_clusters}, Lp {rcfg.capacity}, rank "
            "{} (distributed), a batch of 256")
    for r, got in enumerate(ds["search"]):
        line, miss = _dry_line(
            what.format(r),
            {"args": shard_bytes, "comm": rec["collectives"], "peak": rec["memory"]["peak_bytes"],
             "temp": rec["memory"]["temp_bytes"]},
            {"args": got["shard_bytes"], "comm": got["comm"],
             "peak": got["temp_bytes"] + got["shard_bytes"] + q_bytes, "temp": got["temp_bytes"]})
        lines.append(line)
        missed += miss
    line, miss = _counts_line(what.format(0), rec, ds["real"], ds["search"][0]["ms"])
    lines.append(line)
    missed += miss
    for line in lines:
        log("dryrun", f"{line} ({smi})")

    # (iii) The shape-only branches against the kernels.
    kinds = sorted({c["kernel"] for c in checks})
    def cost_ok(c) -> bool:  # one cost from both branches, never below the table's count
        build = c["kernel"] in ("lsh_hash", "kmeans_assign")
        return c["real_cost"] == c["fake_cost"] and all(
            got == want if build else got >= want for got, want in zip(c["fake_cost"], c["least"]))

    bad = [c for c in checks if c["real"] != c["fake"] or not cost_ok(c)]
    log("dryrun", f"shape-only outputs and reported (FLOPs, bytes) == the kernels' at "
        f"{len(checks)} distinct main-path shapes of {', '.join(kinds)}, each cost == the "
        f"build kernels' and >= the verification kernels' count of distinct valid rows: "
        f"{not bad}")
    if bad or set(kinds) != set(KERNELS):
        raise AssertionError(f"dry run shape branches: {bad or set(KERNELS) - set(kinds)}")
    if missed:
        raise AssertionError(f"dry run predictions missed: {missed}")
    log("dryrun", f"phase {time.perf_counter() - t_phase:.1f} s (sweep {t_sweep:.1f} s); {smi}")
    return {"sweep": recs, "sweep_s": t_sweep}


def entry(name: str, calls: list[dict], launches: int, main_calls: list[dict]) -> dict:
    """One kernel's JSON entry: ``ms``, ``plain_ms`` and ``bound_ms`` sum
    the kernel's calls in one batch of the path that ``launches`` counts."""
    source, replaces = KERNELS[name]
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches,
        "max_abs_err": max(v["max_abs_err"] for v in calls),
        "ms": sum(v["ms"] for v in main_calls),
        "plain_ms": sum(v["plain_ms"] for v in main_calls),
        "bound_ms": sum(v["bound_ms"] for v in main_calls),
        "bound_by": max(main_calls, key=lambda v: v["bound_ms"])["bound_by"],
        "library_ms": None,
        "calls": calls,
    }


def build_entry(name: str, calls: list[dict], launches: int, timed: list[dict]) -> dict:
    """A build kernel's JSON entry over one main-path build: ``launches``
    is the count read around the main path's (first) build; ``ms``,
    ``plain_ms``, ``product_ms`` and ``bound_ms`` sum every call of the
    build that times each call alone (:func:`time_every_build_call`),
    which must launch as often as the main path's build."""
    source, replaces = KERNELS[name]
    mine = [t for t in timed if t["kernel"] == name]
    if sum(t["launches"] for t in mine) != launches:
        raise AssertionError(f"{name}: the timed build made {sum(t['launches'] for t in mine)} "
                             f"launches in {len(mine)} calls, the main build {launches}")
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches,
        "max_abs_err": max(v["max_abs_err"] for v in calls),
        "ms": sum(t["ms"] for t in mine),
        "plain_ms": sum(t["plain_ms"] for t in mine),
        "bound_ms": sum(t["bound_ms"] for t in mine),
        "bound_by": max(mine, key=lambda t: t["bound_ms"])["bound_by"],
        "library_ms": None,
        "product_ms": sum(t["product_ms"] for t in mine),
        "calls": calls,
    }


def graph_summary(f32: dict, q8: dict, q4: dict, tiers: dict, serve: dict, smi: str) -> None:
    """One line: each point's batch medians uncaptured and captured, the
    device's busy share both ways, and the graphs' memory; the host-tier
    engine's re-capture after an update."""
    pts = {**f32, **q8, **q4, "host Q8": tiers["graphs"]}
    log("graphs", f"on {smi}: " + "; ".join(
        f"{n} {g['eager_ms']:.3f} -> {g['graph_ms']:.3f} ms, busy "
        + (f"{g['busy_eager']:.1%} -> {g['busy_graph']:.1%}" if g["busy_graph"] is not None
           else "not measured")
        + f", {g['graph_bytes'] / 1e6:.1f} MB" for n, g in pts.items())
        + f"; host-tier engine after a 1% upsert: re-capture {serve['update']['recapture_s']:.3f} s, "
        f"{serve['update']['graph_bytes'] / 1e6:.1f} MB of pools")


def phase_examples() -> dict:
    """The three serving examples at their default sizes, on the card, in
    this process (``testing.load_example``): quickstart's recall over the
    floor; serve_retrieval answering every arrival on every backend;
    chaos_demo's rollback bit-identical, its outage degraded and recovered."""
    from repro_torch.testing import load_example

    out = {}
    for name in ("quickstart_torch", "serve_retrieval_torch", "chaos_demo_torch"):
        t0 = time.perf_counter()
        out[name] = load_example(name).main([])
        log("examples", f"examples/{name}.py at its defaults: {time.perf_counter() - t0:.1f} s")
    q = out["quickstart_torch"]
    if q["device"] != "cuda:0" or q["recall"] < RECALL_FLOOR:
        raise AssertionError(f"quickstart: {q}")
    served = out["serve_retrieval_torch"]
    if set(served) != {"lider", "flat", "ivfpq", "sklsh", "mplsh"} or any(
            r["answered"] != 1024 for r in served.values()) or served["flat"]["recall_at_10"] != 1.0:
        raise AssertionError(f"serve_retrieval: {served}")
    c = out["chaos_demo_torch"]
    if not (c["rollback_identical"] and c["rollbacks"] == 1 and c["generation"] == 1
            and c["n_degraded"] > 0 and c["recovered"]):
        raise AssertionError(f"chaos_demo: {c}")
    log("examples", f"quickstart recall@10 {q['recall']:.4f}, AQT {q['aqt_s'] * 1e3:.4f} ms; "
        "serve_retrieval every 1,024 arrivals answered on each backend (recall@10 "
        + ", ".join(f"{n} {r['recall_at_10']:.4f}" for n, r in served.items())
        + f"; lider's engine {served['lider']['graph_bytes'] / 1e6:.1f} MB of graph pools); "
        f"chaos_demo rollback bit-identical, {c['n_degraded']} queries degraded in the outage, "
        f"recovered; the committed update recaptured in {c['recapture_s']:.3f} s "
        f"(recompiles {c['recompiles']})")
    return out


def free() -> None:
    """Between phases: drop dead objects, the graphs of freed indexes, and
    the allocator's cache."""
    from repro_torch.core import graphs

    gc.collect()
    graphs.purge()
    torch.cuda.empty_cache()


def main() -> int:
    from repro_torch.configs.lider_msmarco import CONFIG, QUANTIZED

    t_start = time.perf_counter()
    device = phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # Segments that grow in place for the phases at the reference's size:
    # there the 8,192-query graph is captured beside a 53 GB index, and with
    # fixed segments the allocator's split blocks left 12.7 GiB reserved but
    # unallocated, so the capture ran out of memory (an H100 run of this
    # script, PERF.md).
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    phase_build()
    phase_parity(dev)
    clock("parity", t_start)
    main_res = phase_main(dev)
    clock("main", t_start)
    torch.cuda.reset_peak_memory_stats()
    f32_calls = phase_shapes_f32(main_res)
    hash_calls = phase_shapes_hashes(main_res)
    phase_shapes_distinct(dev)
    checks = main_res.pop("build_checks") + shape_checks(main_res.pop("kernel_calls"))
    log("shapes", peak_line("shapes", torch.cuda.max_memory_allocated(), index_nbytes(main_res["params"]),
                            main_res["host_corpus"].nbytes, "host memory"))
    corpus_bytes = main_res["host_corpus"].nbytes
    main_res["bulk"] = phase_bulk("main", "F32", main_res.pop("params"), main_res.pop("search"),
                                  main_res["bulk_queries"], per_batch("F32"), corpus_bytes)
    free()
    clock("shapes and bulk F32", t_start)
    q8 = phase_quantized(dev, main_res, "int8", [p for p in QUANTIZED if p.storage_dtype == "int8"])
    free()
    q4 = phase_quantized(dev, main_res, "int4", [p for p in QUANTIZED if p.storage_dtype == "int4"])
    free()
    clock("quantized", t_start)
    tiers = phase_serve_tiers(dev, main_res)
    main_res.pop("host_corpus")
    free()
    clock("serve tiers", t_start)
    # CUDA IPC (the distributed phase hands its ranks the parent's tensors)
    # cannot share expandable segments on this host's kernel (no
    # pidfd_open): the paths below allocate fixed segments, as before.
    torch.cuda.memory._set_allocator_settings("expandable_segments:False")

    # The paths that keep their earlier size, each with its cut.
    small = phase_small(dev)
    scale = main_res["index_bytes"] / small["index_bytes"]
    t0 = time.perf_counter()
    serve = phase_serve(dev, small)
    log("serve", cut_line(
        "the engine loops and the host-tier checkpoint", time.perf_counter() - t0, scale,
        time.perf_counter() - t_start,
        f"the checkpoint ({serve['checkpoint']['gb']:.2f} GB here) would be "
        f"~{serve['checkpoint']['gb'] * scale:.0f} GB on disk"))
    t0 = time.perf_counter()
    clock("serve engine", t_start)
    phase_fabric(dev, small, serve.pop("fabric_input"))
    host_table = tiers["tiers"]["int8"]["nbytes_host"]["host"]
    log("fabric", cut_line(
        "the replica fabric", time.perf_counter() - t0, scale, time.perf_counter() - t_start,
        f"its second replica copies the host store: two host tables of {host_table / 1e9:.2f} GB at "
        f"the reference's size beside the corpus's {corpus_bytes / 1e9:.2f} GB would hold "
        f"{(2 * host_table + corpus_bytes) / 1e9:.1f} GB of the host's {host_memory()['MemTotal'] / 1e9:.1f}"))
    graph_summary(main_res["graphs"], q8["graphs"], q4["graphs"], tiers, serve, device["smi"])
    free()
    t0 = time.perf_counter()
    cli = phase_cli(dev, small["corpus"])
    log("cli", cut_line("the serve CLI's seven backends", time.perf_counter() - t0, scale,
                        time.perf_counter() - t_start, "each backend builds its own index"))
    clock("cli", t_start)
    free()
    t0 = time.perf_counter()
    life = phase_lifecycle(dev, small)
    log("lifecycle", cut_line(
        "the lifecycle", time.perf_counter() - t0, scale, time.perf_counter() - t_start,
        f"its save ({life['save_gb']:.2f} GB here) would be ~{life['save_gb'] * scale:.0f} GB on disk"))
    free()
    clock("lifecycle", t_start)
    phase_examples()
    free()
    clock("examples", t_start)
    t0 = time.perf_counter()
    dist = phase_distributed(dev, small, device["smi"])
    three = main_res["index_bytes"] + q8["index_bytes"] + q4["index_bytes"]
    log("distributed", cut_line(
        "the distributed index", time.perf_counter() - t0, scale, time.perf_counter() - t_start,
        f"it shares the float32, int8 and int4 indexes with its ranks at once: "
        f"{three / 1e9:.1f} GB at the reference's size, on a card of "
        f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.1f} GB"))
    del small
    free()
    clock("distributed", t_start)
    sharded = phase_models_sharded(dev, device["smi"])
    free()
    clock("models_sharded", t_start)
    train = phase_train(dev, device["smi"])
    clock("train", t_start)
    models = phase_models(dev, device["smi"], train["full"].pop("model"))
    free()
    clock("models", t_start)
    phase_dryrun(device["smi"], {"train_full": train["full"], "models_sharded": sharded["dryrun"],
                                 "distributed": dist["dryrun"]},
                 checks + q8["shape_checks"] + q4["shape_checks"])
    enc = lambda name: [c for c in train["calls"] + models["calls"] if c["kernel"] == name]
    qcalls = (q8["calls"] + q4["calls"] + main_res["bulk"]["calls"] + q8["bulk"]["calls"]
              + dist["calls"] + sharded["calls"])
    by = lambda name, path=None: [c for c in qcalls if c["kernel"] == name and (path is None or c["path"] == path)]
    cfg = CONFIG.lider
    counts, timed = main_res["build_launches"], main_res["build_timed"]
    build_calls = main_res["build_shapes"] + hash_calls
    kernels = [
        # fused_verify: the float main path (routing + in-cluster per batch).
        entry("fused_verify", f32_calls + by("fused_verify") + [tiers["rescore_call"]]
              + enc("fused_verify"), main_res["launches"][0], f32_calls[:2]),
        # sketch_prefilter: the Q4-sk path (one call per batch).
        entry("sketch_prefilter", by("sketch_prefilter"),
              q4["paths"]["Q4-sk"]["launches"][1], by("sketch_prefilter", "Q4-sk")),
        # fused_verify_grouped: the Q8-cm path (one call per batch).
        entry("fused_verify_grouped", by("fused_verify_grouped"),
              q8["paths"]["Q8-cm"]["launches"][2], by("fused_verify_grouped", "Q8-cm")),
        # lsh_hash: the main build (bank-fit chunks + the centroid model).
        # The calls list also holds the baselines' shapes (the cli phase).
        build_entry("lsh_hash", [c for c in build_calls if c["kernel"] == "lsh_hash"] + by("lsh_hash")
                    + [c for c in cli["shapes"] if c["kernel"] == "lsh_hash"] + enc("lsh_hash")
                    + sharded["hash_calls"],
                    counts[3], timed),
        # kmeans_assign: the main build's k-means (Lloyd steps + the final assignment).
        build_entry("kmeans_assign", [c for c in build_calls if c["kernel"] == "kmeans_assign"]
                    + [c for c in cli["shapes"] if c["kernel"] == "kmeans_assign"]
                    + enc("kmeans_assign"), counts[4], timed),
    ]
    log("kernels", f"whole run {time.perf_counter() - t_start:.1f} s ({cfg.n_clusters} clusters: "
        f"{counts[3]} lsh_hash and {counts[4]} kmeans_assign launches in the main build)")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {k: device[k] for k in ("platform", "kind", "count")}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
