"""End to end on the PyTorch port: train a text encoder with an in-batch
contrastive loss, encode a passage corpus, index it with LIDER and search it
(the port of ``examples/train_encoder_e2e.py``).

    PYTHONPATH=src python examples/train_encoder_e2e_torch.py                 # on the card
    PYTHONPATH=src python examples/train_encoder_e2e_torch.py --device cpu    # tiny, on the CPU
    PYTHONPATH=src python examples/train_encoder_e2e_torch.py --size 100m --steps 300 --corpus 262144

The encoder is the port's transformer (``repro_torch.models.transformer``),
mean-pooled and l2-normalised. The data are synthetic pairs: a query and its
passage draw their tokens from one of 256 topics' vocabulary slices, so
retrieval quality is measurable (MRR of the true passage). Batches are a
pure function of (seed, step), drawn by a ``torch.Generator`` on the
device. :func:`train` can also run under ``run_with_restarts`` with a
``CheckpointManager`` (``manager=``, ``checkpoint_every=``), and inject one
``Preemption`` (``preempt_at=``) to exercise the restart.

The index is built by ``repro_torch.core.lider.build_lider`` (on the card:
the ``kmeans_assign`` and ``lsh_hash`` kernels) and searched by
``search_lider`` (``fused_verify``), and the answers are checked against
``flat_search``. :func:`main` takes the arguments as a list and returns a
summary dict.
"""
from __future__ import annotations

import argparse
import time
from typing import Sequence

import torch

from repro_torch.core import lider
from repro_torch.core.baselines import flat_search
from repro_torch.core.utils import l2_normalize, recall_at_k
from repro_torch.data.synthetic import step_seed
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.training import checkpoint as ckpt_lib
from repro_torch.training import fault_tolerance as ft
from repro_torch.training import optimizer as opt_lib
from repro_torch.training import train_loop

PRESETS = {
    # 0.9M parameters: the CPU demo
    "tiny": tfm.LMConfig(name="enc-tiny", n_layers=2, d_model=128, n_heads=4,
                         n_kv_heads=4, d_ff=256, vocab=2048, dtype=torch.float32),
    # 160M parameters, 113M of them in the 12 layers: "a ~100M model for a
    # few hundred steps"
    "100m": tfm.LMConfig(name="enc-100m", n_layers=12, d_model=768, n_heads=12,
                         n_kv_heads=12, d_ff=3072, vocab=30_522, dtype=torch.bfloat16),
}
TEMPERATURE = 0.05
PASSAGE_SEED = 99  # the encoded corpus and its queries
BATCH_SEED = 1  # the training pairs


def encode(model: tfm.Transformer, tokens: torch.Tensor) -> torch.Tensor:
    """Mean-pool the hidden states -> unit-norm float32 embeddings."""
    hidden, _ = model(tokens)
    return l2_normalize(torch.mean(hidden.float(), dim=1))


@torch.no_grad()
def encode_all(model: tfm.Transformer, tokens: torch.Tensor, chunk: int = 8192) -> torch.Tensor:
    """:func:`encode` over many sequences, ``chunk`` at a time."""
    return torch.cat([encode(model, tokens[i : i + chunk]) for i in range(0, tokens.shape[0], chunk)])


def paired_batch(seed: int, step: int, *, batch: int, seq: int, vocab: int, n_topics: int = 256,
                 device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Query/passage token pairs sharing a latent topic's vocabulary slice."""
    device = resolve_device(device)
    g = torch.Generator(device=device).manual_seed(step_seed(seed, step))
    topic = torch.randint(0, n_topics, (batch, 1), generator=g, device=device)
    span = max(vocab // n_topics, 4)
    q = topic * span + torch.randint(0, span, (batch, seq), generator=g, device=device)
    p = topic * span + torch.randint(0, span, (batch, seq), generator=g, device=device)
    return q % vocab, p % vocab


def contrastive_loss(model: tfm.Transformer, batch: dict) -> torch.Tensor:
    """In-batch softmax cross-entropy at temperature 0.05: query i's
    positive is passage i. Queries and passages go through the encoder as
    one batch (half the launches of two; each row's values are its own)."""
    n = batch["q"].shape[0]
    q, p = encode(model, torch.cat([batch["q"], batch["p"]])).split(n)
    logp = torch.log_softmax((q @ p.T) / TEMPERATURE, dim=-1)
    return -torch.mean(torch.diagonal(logp))


def train(cfg: tfm.LMConfig, *, steps: int, batch: int, seq: int, device=None, seed: int = 0,
          manager: ckpt_lib.CheckpointManager | None = None, checkpoint_every: int = 50,
          preempt_at: int | None = None, log_every: int = 0, log_fn=print):
    """Train the encoder -> ``(model, losses, restarts)``; ``losses`` are
    those of the steps this call ran, in step order.

    With a ``manager`` the loop runs under ``run_with_restarts``, and the
    checkpointed state is ``{"params", "opt_state"}`` in the reference's
    layout, viewing the live tensors (a restore fills them in place): a
    manager holding a step starts there. ``preempt_at`` raises one
    ``Preemption`` before that step."""
    device = resolve_device(device)
    model = tfm.init(seed, cfg, device=device)
    state = opt_lib.init_state(dict(model.named_parameters()))
    ocfg = opt_lib.OptimizerConfig(peak_lr=1e-3, warmup_steps=steps // 10, decay_steps=steps)
    step = train_loop.make_train_step(contrastive_loss, ocfg)
    losses: dict[int, torch.Tensor] = {}
    fired: list[int] = []

    def step_fn(tree, i):
        if i == preempt_at and not fired:
            fired.append(i)
            raise ft.Preemption(f"injected before step {i}")
        q, p = paired_batch(BATCH_SEED, i, batch=batch, seq=seq, vocab=cfg.vocab, device=device)
        losses[i] = step(model, state, {"q": q, "p": p})[2]["loss"]
        if log_every and (i % log_every == 0 or i == steps - 1):
            log_fn(f"step {i:4d}  contrastive loss {float(losses[i]):.4f}")
        return tree

    def make_state():
        model.reset_parameters(torch.Generator(device=device).manual_seed(seed))
        for t in (*state["mu"].values(), *state["nu"].values(), state["step"]):
            t.zero_()
        return train_loop.state_tree(model, state)

    restarts = 0
    if manager is None:
        for i in range(steps):
            step_fn(None, i)
    else:
        _, restarts = ft.run_with_restarts(make_state, step_fn, n_steps=steps, manager=manager,
                                           checkpoint_every=checkpoint_every)
    return model, torch.stack([losses[i] for i in sorted(losses)]).tolist(), restarts


def index_config(n_passages: int) -> lider.LiderConfig:
    """The reference example's index: c = N / 256 clusters, 10 probes."""
    return lider.LiderConfig(n_clusters=max(16, n_passages // 256), n_probe=10, n_arrays=8,
                             n_leaves=4, kmeans_iters=10)


def search_all(index, corpus, queries, *, k: int, batch: int = 4096):
    """LIDER and Flat top-k of every query, ``batch`` queries at a time ->
    (LIDER ids, Flat ids)."""
    got, want = [], []
    for i in range(0, queries.shape[0], batch):
        qb = queries[i : i + batch]
        got.append(lider.search_lider(index, qb, k=k, n_probe=10, r0=4).ids)
        want.append(flat_search(corpus, qb, k=k).ids)
    return torch.cat(got), torch.cat(want)


def mrr(ids: torch.Tensor) -> float:
    """Mean reciprocal rank of query i's own passage i within its top k."""
    hit = ids.to(torch.int64) == torch.arange(ids.shape[0], device=ids.device)[:, None]
    rank = torch.argmax(hit.to(torch.int8), dim=1)
    return float(torch.where(hit.any(dim=1), 1.0 / (rank + 1), 0.0).mean())


def main(argv: Sequence[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", choices=list(PRESETS), default="tiny")
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--corpus", type=int, default=4096)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    args = ap.parse_args(argv)
    cfg = PRESETS[args.size]
    device = resolve_device(args.device)

    t0 = time.perf_counter()
    model, losses, _ = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                             device=device, log_every=max(args.steps // 10, 1))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"encoder: {cfg.name}, {n_params / 1e6:.1f}M params; training "
          f"{time.perf_counter() - t0:.1f} s")

    # Encode the corpus (passages) and its queries: query i's passage is i.
    kq, kp = paired_batch(PASSAGE_SEED, 0, batch=args.corpus, seq=args.seq, vocab=cfg.vocab,
                          device=device)
    corpus, queries = encode_all(model, kp), encode_all(model, kq)
    t0 = time.perf_counter()
    index = lider.build_lider(2, corpus, index_config(args.corpus), device=device)
    print(f"LIDER build over {args.corpus} passages: {time.perf_counter() - t0:.1f} s")
    ids, gt = search_all(index, corpus, queries, k=args.k)
    rec, rr = float(recall_at_k(ids, gt)), mrr(ids)
    print(f"serving: recall@{args.k} vs Flat = {rec:.4f}, MRR@{args.k} (true passage) = {rr:.4f}")
    return {"losses": losses, "n_params": n_params, "recall_at_k": rec, "mrr": rr}


if __name__ == "__main__":
    main()
