"""Flash-decode attention: one query token per sequence against the slab
KV cache.

The CUDA kernel (``csrc/decode_attention.cu``) replaces the TPU kernel
``repro.kernels.decode_attention.flash_decode_bhgd``; its header says
what bounds it on the H100 and what the design does about that.  Both
versions here take the model layout: q [B, 1, H, hd], caches
[B, S_max, Hk, hd] read in place, ``lengths`` [B] int32 (valid keys,
the current token included).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
MAX_GROUP = 8          # query heads per KV head the kernel takes

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 10 + [ctypes.c_float, ctypes.c_void_p])


def decode_attention_plain(q, k_cache, v_cache, lengths):
    """The plain PyTorch version: a masked softmax in f32 over the valid
    slice, the G query heads of a KV head grouped together."""
    B, _, H, hd = q.shape
    S, Hk = k_cache.shape[1], k_cache.shape[2]
    G = H // Hk
    L = min(int(lengths.max()), S) if B else 0
    k = k_cache[:, :L].float()                                    # [B, L, Hk, hd]
    v = v_cache[:, :L].float()
    qg = q[:, 0].float().reshape(B, Hk, G, hd) * (1.0 / hd ** 0.5)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k)
    valid = (torch.arange(L, device=q.device)[None, :]
             < lengths.long()[:, None])                           # [B, L]
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v)
    return out.reshape(B, 1, H, hd).to(q.dtype)


def decode_attention_cuda(q, k_cache, v_cache, lengths):
    """Launch the CUDA kernel on the current stream.  The caller
    (``ops.flash_decode``) has checked devices, types and layouts."""
    lib = _build.load("decode_attention")
    fn = lib.flash_decode
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    B, _, H, hd = q.shape
    S, Hk = k_cache.shape[1], k_cache.shape[2]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lengths.data_ptr(), out.data_ptr(),
            0 if q.dtype == torch.float32 else 1, B, Hk, H // Hk, S, hd,
            q.stride(0), q.stride(2), *k_cache.stride()[:3],
            *v_cache.stride()[:3], out.stride(0), out.stride(2),
            1.0 / hd ** 0.5, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error {rc}")
    return out
