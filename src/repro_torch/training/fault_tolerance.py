"""Fault tolerance: restart-on-failure harness + determinism contracts.

The port of the JAX package's ``training/fault_tolerance.py``: the same
restart loop, the same backoff and the same seeded jitter.

At 1000+ nodes the recovery model is: (a) any step may die (preemption, ICI
flap, host OOM); (b) training must resume from the last checkpoint with a
*bitwise-identical* data stream; (c) replacement nodes may change the device
count (elastic).

This module supplies the harness half:
- ``run_with_restarts``: drives a step loop, catches any exception in its
  ``retryable`` tuple (``Preemption`` by default; add e.g. ``OSError`` for
  flaky storage), restores from the CheckpointManager and replays — the data
  pipeline is step-indexed so replay is exact. Restarts back off
  exponentially with deterministic (seeded) jitter so a thundering herd of
  restarting workers decorrelates the same way on every replay.
- capacity-padded static shapes (LIDER clusters, MoE buffers) are the
  straggler story: every device executes the same program on the same byte
  count per step, so there is no data-dependent long pole; the remaining
  stragglers (hardware) are handled by restart.
"""
from __future__ import annotations

import random
import time
from typing import Callable

from .checkpoint import CheckpointManager


class Preemption(Exception):
    """Injected/observed node loss."""


def run_with_restarts(
    make_state: Callable[[], dict],
    step_fn: Callable[[dict, int], dict],
    *,
    n_steps: int,
    manager: CheckpointManager,
    checkpoint_every: int = 10,
    max_restarts: int = 10,
    on_restart: Callable[[int], None] | None = None,
    retryable: tuple[type[BaseException], ...] = (Preemption,),
    backoff_s: float = 0.0,
    backoff_mult: float = 2.0,
    max_backoff_s: float = 30.0,
    jitter_seed: int = 0,
):
    """Run ``step_fn(state, step) -> state`` to ``n_steps`` with restart
    recovery. ``make_state`` builds the step-0 state (params, opt, rng...).

    Only exceptions in ``retryable`` trigger a restart — anything else
    (a real bug) propagates immediately. Each restart sleeps
    ``backoff_s * backoff_mult**(restart-1)`` (capped at ``max_backoff_s``)
    scaled by a deterministic jitter in [1, 2) drawn from ``jitter_seed``.

    Returns (final_state, n_restarts). Restore picks the newest *verified*
    checkpoint (corrupt steps are skipped — see
    ``CheckpointManager.restore_latest``) and steps re-execute from there
    (the step index keys the data pipeline, so replayed batches are
    identical).
    """
    restarts = 0
    rng = random.Random(jitter_seed)
    while True:
        state0 = make_state()
        step, state = manager.restore_latest(state0)
        if step is None:
            state, start = state0, 0
        else:
            start = step
        try:
            for i in range(start, n_steps):
                state = step_fn(state, i)
                if (i + 1) % checkpoint_every == 0:
                    manager.save(i + 1, state)
            if n_steps % checkpoint_every != 0:
                manager.save(n_steps, state)
            return state, restarts
        except retryable:
            restarts += 1
            if restarts > max_restarts:
                raise
            if backoff_s > 0:
                delay = min(
                    backoff_s * backoff_mult ** (restarts - 1), max_backoff_s
                )
                time.sleep(delay * (1.0 + rng.random()))
            if on_restart:
                on_restart(restarts)
