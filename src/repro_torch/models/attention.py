"""Attention for the serving forwards.

``blocked_attention`` is the forward-only plain path (the JAX package's
XLA reference): an online softmax over KV blocks that never builds the
full [Sq, Sk] score matrix.  The slab serving dispatchers
``prefill_attention`` and ``decode_attention`` go through the kernel
wrappers in ``repro_torch.kernels.ops``: the CUDA kernels on CUDA
tensors, their plain versions on CPU tensors.  Paths this slice does not
port (sliding-window decode on CUDA, int8 KV) raise instead of falling
back.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops

NEG_INF = -1e30


def blocked_attention(q, k, v, *, q_offset=None, lengths=None,
                      causal: bool = True, window: int = 0,
                      block_size: int = 512):
    """q: [B, Sq, H, hd]; k/v: [B, Sk, Hk, hd]; q_offset: [B] absolute
    position of q[:, 0]; lengths: [B] valid keys -> [B, Sq, H, hd]."""
    B, Sq, H, hd = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    dev = q.device
    if q_offset is None:
        q_offset = torch.zeros((B,), dtype=torch.int32, device=dev)
    if lengths is None:
        lengths = torch.full((B,), Sk, dtype=torch.int32, device=dev)
    block = min(block_size, Sk)
    qg = (q * (1.0 / hd ** 0.5)).float().reshape(B, Sq, Hk, G, hd)
    q_pos = q_offset.long()[:, None] + torch.arange(Sq, device=dev)[None, :]
    lens = lengths.long()
    m = torch.full((B, Hk, G, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hk, G, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hk, G, Sq, hd), dtype=torch.float32, device=dev)
    for start in range(0, Sk, block):
        k_blk = k[:, start:start + block].float()
        v_blk = v[:, start:start + block].float()
        key_pos = torch.arange(start, start + k_blk.shape[1], device=dev)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_blk)
        valid = key_pos[None, None, :] < lens[:, None, None]
        if causal:
            valid = valid & (key_pos[None, None, :] <= q_pos[:, :, None])
            if window > 0:
                valid = valid & (key_pos[None, None, :]
                                 > q_pos[:, :, None] - window)
        s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, v_blk)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]              # [B,Hk,G,Sq,hd]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)


def prefill_attention(q, k_cache, v_cache, *, q_offset, lengths,
                      window: int = 0, slot_idx=None):
    """Serving prefill/resume attention: a [M, Sq] query chunk against
    the resident slab cache [B, S_max] (chunk rows already written).
    ``slot_idx`` [M] names each row's cache row (None: row m)."""
    return ops.flash_prefill(q, k_cache, v_cache, q_offset.int(),
                             lengths.int(), window=window,
                             slot_idx=None if slot_idx is None
                             else slot_idx.int())


def decode_attention(q, k_cache, v_cache, lengths, *, window: int = 0,
                     block_size: int = 2048):
    """Single-token decode against the slab cache. q: [B, 1, H, hd];
    caches [B, S, Hk, hd]; lengths [B] valid keys incl. the current one.

    With ``window > 0`` only the last ``window`` cache entries are read
    (per-row slice, then the blocked plain path) — on CPU tensors only:
    the windowed decode kernel is not ported."""
    S = k_cache.shape[1]
    if window > 0 and window < S:
        if q.is_cuda:
            raise NotImplementedError(
                "sliding-window decode has no CUDA kernel yet")
        B = q.shape[0]
        starts = torch.clamp(lengths.long() - window, min=0)
        idx = starts[:, None] + torch.arange(window, device=q.device)[None, :]
        rows = torch.arange(B, device=q.device)[:, None]
        rel_len = lengths.long() - starts
        return blocked_attention(q, k_cache[rows, idx], v_cache[rows, idx],
                                 q_offset=rel_len - 1, lengths=rel_len,
                                 causal=True, window=0,
                                 block_size=min(block_size, window))
    return ops.flash_decode(q, k_cache, v_cache, lengths.int())
