"""Shared model primitives: init helpers and the RMS norm."""
from __future__ import annotations

import torch


def dense_init(gen: torch.Generator, shape, fan_in: int, dtype, device):
    """Normal x 1/sqrt(fan_in), drawn on ``device`` from ``gen`` (which
    must live on that device) and cast to ``dtype`` tensor by tensor."""
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return x.mul_(1.0 / fan_in ** 0.5).to(dtype)   # in place: one f32 copy


def embed_init(gen: torch.Generator, shape, dtype, device):
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (x * 0.02).to(dtype)


def rms_norm(x, weight, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dt)
