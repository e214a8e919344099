"""Where a training step's time goes on the card.

    python3 scripts/train_profile.py            # the 100m encoder and qwen2.5-3b
    python3 scripts/train_profile.py encoder

For the encoder example's ``100m`` preset (batch 64 x 32) and for
qwen2.5-3b at its published widths (batch 1 x 512, bf16 compute): the
step's host wall (synchronized) split into forward + backward and AdamW,
with PyTorch's deterministic algorithms off and on (and on without the
NaN fill of new allocations, ``fill_uninitialized_memory``); then a
``torch.profiler`` trace of one step: the device's busy share of the wall,
the kernels with the most device time, and the host ops with the most
time of their own. Needs a CUDA card.
"""
from __future__ import annotations

import os
import statistics
import sys
import time
from pathlib import Path

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def sync_s(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def split_step(model, state, ocfg, loss_fn, batch_at, reps: int) -> dict:
    """Median seconds of forward + backward, of AdamW, and of the step."""
    from repro_torch.training import optimizer as opt_lib

    params = dict(model.named_parameters())
    fb, opt = [], []
    for i in range(reps + 1):
        batch = batch_at(i)

        def fwd_bwd():
            for p in params.values():
                p.grad = None
            loss_fn(model, batch).backward()

        t_fb = sync_s(fwd_bwd)
        grads = {n: p.grad for n, p in params.items()}
        t_opt = sync_s(lambda: opt_lib.apply_updates(params, grads, state, ocfg))
        if i:  # the first is the warm-up
            fb.append(t_fb)
            opt.append(t_opt)
    return {"fwd_bwd_ms": statistics.median(fb) * 1e3, "adamw_ms": statistics.median(opt) * 1e3}


def trace(step, label: str, top: int = 12) -> None:
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e6
    print(f"{label}: traced step {wall * 1e3:.1f} ms wall, device busy {busy * 1e3:.1f} ms "
          f"({busy / wall:.1%}) over {len(dev)} device ops", flush=True)
    by_name: dict[str, float] = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  device {us / 1e3:9.3f} ms  {name[:110]}", flush=True)
    rows = sorted(prof.key_averages(), key=lambda r: -r.self_cpu_time_total)[:top]
    for r in rows:
        print(f"  host   {r.self_cpu_time_total / 1e3:9.3f} ms self, {r.count:6d} calls  {r.key[:80]}",
              flush=True)


def encoder() -> None:
    from repro_torch.models import transformer as tfm
    from repro_torch.testing import load_example
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training import train_loop

    ex = load_example("train_encoder_e2e_torch")
    cfg, dev = ex.PRESETS["100m"], torch.device("cuda")
    batch_at = lambda i: dict(zip("qp", ex.paired_batch(1, i, batch=64, seq=32, vocab=cfg.vocab,
                                                        device=dev)))
    for mode in ("off", "on", "on, no fill"):
        torch.use_deterministic_algorithms(mode != "off")
        torch.utils.deterministic.fill_uninitialized_memory = mode != "on, no fill"
        model = tfm.init(0, cfg, device=dev)
        state = opt_lib.init_state(dict(model.named_parameters()))
        ocfg = opt_lib.OptimizerConfig(peak_lr=1e-3, warmup_steps=30, decay_steps=300)
        res = split_step(model, state, ocfg, ex.contrastive_loss, batch_at, reps=5)
        step = train_loop.make_train_step(ex.contrastive_loss, ocfg)
        t = statistics.median(sync_s(lambda: step(model, state, batch_at(i))) for i in range(5))
        print(f"encoder 100m, deterministic {mode}: step {t * 1e3:.1f} ms; forward + backward "
              f"{res['fwd_bwd_ms']:.1f} ms, AdamW {res['adamw_ms']:.1f} ms", flush=True)
        if mode == "on":
            trace(lambda: step(model, state, batch_at(0)), "encoder 100m, deterministic on")
        del model, state
    torch.use_deterministic_algorithms(False)
    torch.utils.deterministic.fill_uninitialized_memory = True


def qwen() -> None:
    from repro_torch.configs import get_arch
    from repro_torch.data import synthetic
    from repro_torch.models import transformer as tfm
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training import train_loop

    cfg, dev = get_arch("qwen2.5-3b").config, torch.device("cuda")
    model = tfm.init(0, cfg, device=dev)
    state = opt_lib.init_state(dict(model.named_parameters()))
    ocfg = opt_lib.OptimizerConfig(warmup_steps=1, decay_steps=10)
    batch_at = lambda i: synthetic.lm_batch(0, i, batch=1, seq=512, vocab=cfg.vocab, device=dev)
    res = split_step(model, state, ocfg, tfm.train_loss, batch_at, reps=3)
    print(f"qwen2.5-3b full: forward + backward {res['fwd_bwd_ms']:.1f} ms, AdamW "
          f"{res['adamw_ms']:.1f} ms", flush=True)
    step = train_loop.make_train_step(tfm.train_loss, ocfg)
    trace(lambda: step(model, state, batch_at(0)), "qwen2.5-3b full")


if __name__ == "__main__":
    if not torch.cuda.is_available():
        raise SystemExit("train_profile: needs a CUDA card")
    what = sys.argv[1:] or ["encoder", "qwen"]
    print(torch.cuda.get_device_name(0), flush=True)
    for w in what:
        {"encoder": encoder, "qwen": qwen}[w]()
