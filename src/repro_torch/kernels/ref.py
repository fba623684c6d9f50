"""Naive PyTorch oracles for the attention and SSD kernels.

Deliberately naive (full score matrices, repeated KV heads): the ground
truth the kernels and their plain versions are tested against, never the
execution path.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def naive_attention(q, k, v, *, causal=True, window=0, q_offset=None,
                    lengths=None):
    """q: [B, Sq, H, hd]; k/v: [B, Sk, Hk, hd] -> [B, Sq, H, hd]."""
    B, Sq, H, hd = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    dev = q.device
    if q_offset is None:
        q_offset = torch.zeros((B,), dtype=torch.int32, device=dev)
    if lengths is None:
        lengths = torch.full((B,), Sk, dtype=torch.int32, device=dev)
    kr = k.repeat_interleave(G, dim=2)                            # [B, Sk, H, hd]
    vr = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr.float()) / (hd ** 0.5)
    q_pos = q_offset[:, None] + torch.arange(Sq, device=dev)[None, :]   # [B, Sq]
    k_pos = torch.arange(Sk, device=dev)[None, :]                        # [1, Sk]
    valid = k_pos[:, None, :] < lengths[:, None, None]                 # [B, Sq, Sk]
    if causal:
        valid = valid & (k_pos[:, None, :] <= q_pos[:, :, None])
        if window > 0:
            valid = valid & (k_pos[:, None, :] > q_pos[:, :, None] - window)
    s = torch.where(valid[:, None, :, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vr.float())
    return out.to(q.dtype)


def naive_decode_attention(q, k_cache, v_cache, lengths, *, window=0):
    """q: [B, 1, H, hd]; caches [B, S, Hk, hd]; lengths incl. current."""
    return naive_attention(q, k_cache, v_cache, causal=True, window=window,
                           q_offset=lengths - 1, lengths=lengths)


def naive_ssd(x, dt, Bm, Cm, A, D, h0=None):
    """Step-by-step SSD recurrence (the definition, O(S) sequential).

    x: [B, S, nh, hd]; dt: [B, S, nh] (post-softplus); Bm/Cm: [B, S, N];
    A: [nh] (negative); D: [nh].  Returns (y [B, S, nh, hd], h_final)."""
    B_, S, nh, hd = x.shape
    N = Bm.shape[-1]
    h = (torch.zeros((B_, nh, hd, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    xf, Bf, Cf = x.float(), Bm.float(), Cm.float()
    ys = []
    for t in range(S):
        a = torch.exp(dt[:, t] * A[None, :])                      # [B, nh]
        h = h * a[:, :, None, None] + torch.einsum(
            "bh,bhd,bn->bhdn", dt[:, t], xf[:, t], Bf[:, t])
        ys.append(torch.einsum("bhdn,bn->bhd", h, Cf[:, t]))
    y = torch.stack(ys, dim=1) + xf * D[None, None, :, None]
    return y.to(x.dtype), h
