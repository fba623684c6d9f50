"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Trains the selected dense decoder (its reduced smoke variant, or the full
published config with ``--full-config``) on the synthetic corpus with
AdamW, remat on, f32 parameters.  Runs on the CUDA card unless
``--device cpu`` is given; weights are random, drawn on the device from
``--seed``, and the corpus is the JAX launcher's (seed 0).  Prints one
line per logged step as the JAX launcher does, then a summary line: step
wall time (p50), training tok/s over the steps' wall time, the peak
device memory and the launches of the flash-attention kernel.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.kernels import ops
from repro_torch.models import init_params
from repro_torch.models.common import count_params
from repro_torch.serving.engine import resolve_device
from repro_torch.training.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.training.data import DataConfig, SyntheticCorpus
from repro_torch.training.optimizer import AdamWConfig, init_opt_state
from repro_torch.training.train_step import make_train_step


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--full-config", action="store_true",
                    help="the full (published) config instead of the "
                         "reduced smoke variant")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--resume", default="")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default) raises when no card is present")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    return ap.parse_args(argv)


def run(args) -> dict:
    """Train as the arguments say; returns the run's record: per-step
    losses and wall seconds, training tok/s, peak device GB (None on the
    CPU) and the flash-attention launches."""
    device = resolve_device(args.device)
    cfg = (get_config if args.full_config else get_smoke_config)(args.arch)
    print(f"# arch={cfg.name} family={cfg.family} layers={cfg.num_layers} "
          f"d_model={cfg.d_model} device={device}", flush=True)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, gen, torch.float32)
    print(f"# params: {count_params(params) / 1e6:.2f}M", flush=True)

    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                          total_steps=args.steps)
    opt = init_opt_state(opt_cfg, params)
    start = 0
    if args.resume:
        params, opt, start = load_checkpoint(args.resume, params, opt)
        print(f"# resumed from {args.resume} at step {start}", flush=True)

    step_fn = make_train_step(cfg, opt_cfg, remat=True)
    data = SyntheticCorpus(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        batch_size=args.batch)).batches()
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    launches0 = ops.LAUNCHES["flash_attention"]
    losses, step_s = [], []
    t0 = time.time()
    for step in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in next(data).items()}
        sync()
        ts = time.perf_counter()
        params, opt, stats = step_fn(params, opt, batch)
        sync()
        step_s.append(time.perf_counter() - ts)
        losses.append(float(stats["loss"]))
        if step % args.log_every == 0 or step == args.steps - 1:
            tps = (step - start + 1) * args.batch * args.seq \
                / max(time.time() - t0, 1e-9)
            print(f"step {step:5d}  loss {losses[-1]:.4f}  "
                  f"ce {float(stats['ce']):.4f}  "
                  f"gnorm {float(stats['grad_norm']):.3f}  "
                  f"tok/s {tps:.0f}", flush=True)
    out = dict(losses=losses, step_s=step_s,
               tok_s=len(step_s) * args.batch * args.seq
               / max(sum(step_s), 1e-9),
               peak_gb=(torch.cuda.max_memory_allocated(device) / 1e9 if cuda
                        else None),
               flash_attention_launches=(ops.LAUNCHES["flash_attention"]
                                         - launches0))
    if step_s:
        peak = ("not measured (cpu)" if out["peak_gb"] is None
                else f"{out['peak_gb']:.2f}")
        print(f"# steps={len(step_s)} step_ms_p50="
              f"{1e3 * float(np.median(step_s)):.1f} "
              f"train_tok_s={out['tok_s']:.0f} peak_device_GB={peak} "
              f"flash_attention_launches={out['flash_attention_launches']}",
              flush=True)
    if args.checkpoint:
        save_checkpoint(args.checkpoint, params, opt, args.steps,
                        meta={"arch": cfg.name})
        print(f"# saved {args.checkpoint}", flush=True)
    return out


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
