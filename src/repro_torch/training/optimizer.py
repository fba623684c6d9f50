"""AdamW in plain PyTorch (no torch.optim), with a configurable state type.

The JAX package's optimizer carried across: the same warmup-cosine
schedule, global-norm clipping, bias correction and decoupled weight
decay, computed in f32 in the same order.  Parameters and gradients are
nested dicts of tensors (the model's parameter tree); ``apply_updates``
writes the new parameters and moments into the given tensors in place
(JAX returns new arrays), so a step holds no second copy of the model.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.models.common import tree_leaves


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    state_dtype: torch.dtype = torch.float32


class OptState(NamedTuple):
    step: torch.Tensor      # int32 scalar on the CPU
    m: Any
    v: Any


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup then cosine decay to 10%, in f32."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.55 + 0.45 * torch.cos(math.pi * prog)
    return cfg.lr * warm * cos


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def init_opt_state(cfg: AdamWConfig, params) -> OptState:
    zeros = lambda p: torch.zeros(p.shape, dtype=cfg.state_dtype,
                                  device=p.device)
    return OptState(step=torch.zeros((), dtype=torch.int32),
                    m=_map(zeros, params), v=_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(x.float().square().sum()
                          for x in tree_leaves(tree)))


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state: OptState):
    """One AdamW step; returns (params, new_state, stats) with the
    parameter and moment tensors updated in place."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    stepf = step.float()
    b1c = float(1.0 - torch.tensor(cfg.b1) ** stepf)
    b2c = float(1.0 - torch.tensor(cfg.b2) ** stepf)
    lr_f = float(lr)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.m), tree_leaves(state.v)):
        g = g.float() * scale
        m32 = m.float() * cfg.b1 + g * (1 - cfg.b1)
        v32 = v.float() * cfg.b2 + g.square() * (1 - cfg.b2)
        u = (m32 / b1c) / (torch.sqrt(v32 / b2c) + cfg.eps)
        u = u + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr_f * u)
        m.copy_(m32)
        v.copy_(v32)
    return params, OptState(step, state.m, state.v), {"grad_norm": gnorm,
                                                      "lr": lr}
