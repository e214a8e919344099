"""Cluster-major schedule construction for multi-query batched verification.

The port's copy of the JAX package's ``repro/kernels/schedule.py`` (pure
NumPy host bookkeeping, kept here so the port imports nothing of the JAX
package); the arrays it builds equal the JAX package's exactly
(``tests/test_torch_quantized.py``).

The per-query first pass reads every probed cluster's rows once per
(query, probe) pair. The cluster-major schedule groups a batch's (query,
probe) pairs BY CLUSTER into steps of up to ``block_q`` query slots, so
each step reads one cluster's rows once for the whole query tile
(``fused_verify.fused_verify_grouped``).

Determinism contract: pairs are ordered by (cluster asc, query asc, probe
asc) and packed greedily into ``block_q``-slot steps, so the schedule
depends only on the routed probe lists.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def _pad_pow2(m: int, lo: int = 1) -> int:
    """Next power of two >= max(m, lo)."""
    return max(lo, 1 << (max(m, 1) - 1).bit_length())


@dataclasses.dataclass(frozen=True)
class ClusterSchedule:
    """The cluster->query-tile schedule for one routed batch.

    ``sched_cids``: (S,) int32, the cluster each step reads (padding steps
    carry cluster 0 with an all-empty tile; the kernel skips them).
    ``sched_qids``: (S, block_q) int32, query index per tile slot (-1 pad).
    ``pair_step`` / ``pair_slot``: (B, P) int32, where each (query, probe)
    pair landed, -1 for pairs excluded from the schedule (pruned probes).
    ``n_steps``: real (unpadded) step count; ``n_pairs``: scheduled pairs.
    """

    sched_cids: np.ndarray
    sched_qids: np.ndarray
    pair_step: np.ndarray
    pair_slot: np.ndarray
    block_q: int
    n_steps: int
    n_pairs: int

    @property
    def n_padded_steps(self) -> int:
        return int(self.sched_cids.shape[0])

    @property
    def sharing_ratio(self) -> float:
        """Cluster reads saved against the per-query schedule:
        ``n_pairs / n_steps`` (1.0 means no sharing)."""
        return self.n_pairs / max(self.n_steps, 1)


def build_cluster_schedule(
    cids: np.ndarray,
    *,
    block_q: int,
    pruned: np.ndarray | None = None,
    pad_to: int | None = None,
) -> ClusterSchedule:
    """Group a batch's routed (query, probe) pairs by cluster into steps.

    ``cids``: (B, P) int32 routed cluster ids (< 0 = invalid probe).
    ``pruned``: optional (B, P) bool; True excludes the pair.
    ``pad_to`` replaces the power-of-two step padding with a fixed padded
    step count (values below the real step count fall back to the
    power-of-two policy). Padding steps are empty, so results are unchanged.
    """
    cids = np.asarray(cids, np.int32)
    b, p = cids.shape
    keep = cids >= 0
    if pruned is not None:
        keep &= ~np.asarray(pruned, bool)
    qid, pid = np.nonzero(keep)  # row-major: (query asc, probe asc)
    pcid = cids[qid, pid]
    # A stable sort by cluster keeps (query asc, probe asc) within a cluster.
    order = np.argsort(pcid, kind="stable")
    qid, pid, pcid = qid[order], pid[order], pcid[order]
    n_pairs = int(pcid.shape[0])

    if n_pairs:
        starts = np.r_[True, pcid[1:] != pcid[:-1]]
        group_start = np.maximum.accumulate(np.where(starts, np.arange(n_pairs), 0))
        within = np.arange(n_pairs) - group_start
        step_of_group = within // block_q
        slot = (within % block_q).astype(np.int32)
        step_key = starts | (np.r_[False, step_of_group[1:] != step_of_group[:-1]])
        step = (np.cumsum(step_key) - 1).astype(np.int32)
        n_steps = int(step[-1]) + 1
    else:
        slot = step = np.zeros((0,), np.int32)
        n_steps = 0

    s_padded = _pad_pow2(n_steps)
    if pad_to is not None and pad_to >= n_steps:
        s_padded = max(int(pad_to), 1)
    sched_cids = np.zeros((s_padded,), np.int32)
    sched_qids = np.full((s_padded, block_q), -1, np.int32)
    if n_pairs:
        sched_cids[step] = pcid
        sched_qids[step, slot] = qid
    pair_step = np.full((b, p), -1, np.int32)
    pair_slot = np.full((b, p), -1, np.int32)
    if n_pairs:
        pair_step[qid, pid] = step
        pair_slot[qid, pid] = slot
    return ClusterSchedule(
        sched_cids=sched_cids,
        sched_qids=sched_qids,
        pair_step=pair_step,
        pair_slot=pair_slot,
        block_q=int(block_q),
        n_steps=n_steps,
        n_pairs=n_pairs,
    )
