"""Rotary position embeddings (standard RoPE).  M-RoPE is not ported."""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None):
    """Inverse frequencies, shape [head_dim//2] (float32)."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: [B, S, H, hd]; positions: [B, S] int."""
    inv = rope_freqs(x.shape[-1], theta, x.device)                # [hd/2]
    ang = positions.float()[..., None] * inv                      # [B, S, hd/2]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
