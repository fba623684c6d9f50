"""Cache-aware chunk-prefill attention: a [M, Sq] query chunk against the
resident slab KV cache [B, S_max].

The CUDA kernel (``csrc/prefill_attention.cu``) replaces the TPU kernel
``repro.kernels.prefill_attention.flash_prefill_bhsd``; its header says
what bounds it on the H100 and what the design does about that.  Both
versions here take the model layout: q [M, Sq, H, hd], caches
[B, S_max, Hk, hd] read in place, per-row ``q_offset``/``lengths`` [M]
int32 and an optional ``slot_idx`` [M] int32 naming each row's cache
row (default: row m reads cache row m).  Every query row must have at
least one unmasked key (``q_offset + i < lengths``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30

_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
             + [ctypes.c_longlong] * 12 + [ctypes.c_float, ctypes.c_void_p])


def prefill_attention_plain(q, k_cache, v_cache, q_offset, lengths, *,
                            window: int = 0, slot_idx=None):
    """The plain PyTorch version: a masked softmax in f32 over the valid
    slice of each row's cache stripe (GQA by grouping query heads)."""
    M, Sq, H, hd = q.shape
    S, Hk = k_cache.shape[1], k_cache.shape[2]
    G = H // Hk
    dev = q.device
    L = min(int(lengths.max()), S) if M else 0
    rows = (slot_idx.long() if slot_idx is not None
            else torch.arange(M, device=dev))
    k = k_cache[rows, :L].float()                                 # [M, L, Hk, hd]
    v = v_cache[rows, :L].float()
    qg = q.float().reshape(M, Sq, Hk, G, hd) * (1.0 / hd ** 0.5)
    s = torch.einsum("mqhgd,mkhd->mhgqk", qg, k)
    q_pos = q_offset.long()[:, None] + torch.arange(Sq, device=dev)[None, :]
    k_pos = torch.arange(L, device=dev)[None, None, :]
    valid = ((k_pos < lengths.long()[:, None, None])
             & (k_pos <= q_pos[:, :, None]))                     # [M, Sq, L]
    if window > 0:
        valid = valid & (k_pos > q_pos[:, :, None] - window)
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("mhgqk,mkhd->mqhgd", p, v)
    return out.reshape(M, Sq, H, hd).to(q.dtype)


def prefill_attention_cuda(q, k_cache, v_cache, q_offset, lengths, *,
                           window: int = 0, slot_idx=None):
    """Launch the CUDA kernel on the current stream.  The caller
    (``ops.flash_prefill``) has checked devices, types and layouts."""
    lib = _build.load("prefill_attention")
    fn = lib.flash_prefill
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    M, Sq, H, hd = q.shape
    S, Hk = k_cache.shape[1], k_cache.shape[2]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            slot_idx.data_ptr() if slot_idx is not None else None,
            q_offset.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            0 if q.dtype == torch.float32 else 1, M, Sq, Hk, H // Hk, S, hd,
            int(window), *q.stride()[:3], *k_cache.stride()[:3],
            *v_cache.stride()[:3], *out.stride()[:3], 1.0 / hd ** 0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_prefill kernel launch failed: CUDA error {rc}")
    return out
