"""Flash attention over whole sequences, with no cache: the attention
forward of training and of the cold whole-prompt forward.

The CUDA kernel (``csrc/flash_attention.cu``) replaces the TPU kernel
``repro.kernels.flash_attention.flash_attention_bhsd``; the source's
header says what bounds it on the H100 and what the design does about
that.  Both versions here take the model layout: q [B, Sq, H, hd], k/v
[B, Sk, Hk, hd] (query head h reads KV head h // (H // Hk)), and return
``(o, m, l)``: the output [B, Sq, H, hd] in q's type and each row's
softmax statistics [B, H, Sq] in f32, m the max of the scaled scores and
l the sum of exp(s - m), which the backward reads.  ``causal`` masks
keys after the query row and ``window`` > 0 (causal only) those at or
before row - window; the plain version also masks keys at or past
``sk_valid`` (0: all Sk), as the TPU kernel masks its padding.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
# q, k, v, out, m, l; dtype, B, Sq, H, G, Sk, hd, causal, window; the
# first three strides of q, k, v and out; scale; stream
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
             + [ctypes.c_longlong] * 12 + [ctypes.c_float, ctypes.c_void_p])


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          sk_valid: int = 0, block_size: int = 512):
    """The plain PyTorch version: the TPU kernel's online softmax in f32
    (q cast to f32, then scaled by 1/sqrt(hd)) over key blocks of
    ``block_size``, the G query heads of a KV head grouped together."""
    B, Sq, H, hd = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    sk_valid = sk_valid or Sk
    dev = q.device
    qg = q.float().reshape(B, Sq, Hk, G, hd) * (1.0 / hd ** 0.5)
    q_pos = torch.arange(Sq, device=dev)[:, None]
    m = torch.full((B, Hk, G, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hk, G, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hk, G, Sq, hd), dtype=torch.float32, device=dev)
    for start in range(0, Sk, block_size):
        k_blk = k[:, start:start + block_size].float()
        v_blk = v[:, start:start + block_size].float()
        k_pos = torch.arange(start, start + k_blk.shape[1], device=dev)[None]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_blk)
        valid = k_pos < sk_valid                                  # [1, blk]
        if causal:
            valid = valid & (k_pos <= q_pos)                      # [Sq, blk]
            if window > 0:
                valid = valid & (k_pos > q_pos - window)
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p,
                                                   v_blk)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]        # [B,Hk,G,Sq,hd]
    o = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)
    return o, m.reshape(B, H, Sq), l.reshape(B, H, Sq)


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0):
    """Launch the kernel (``ops.flash_attention``, which has checked
    devices, types and layouts) on the current stream."""
    B, Sq, H, hd = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    m = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    ptrs = [q, k, v, out, m, l]
    strides = [st for t in (q, k, v, out) for st in t.stride()[:3]]
    fn = _build.entry("flash_attention", "flash_attention", _ARGTYPES)
    rc = fn(*[t.data_ptr() for t in ptrs],
            0 if q.dtype == torch.float32 else 1, B, Sq, H, H // Hk,
            Sk, hd, int(causal), window, *strides,
            1.0 / hd ** 0.5, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error "
                           f"{rc}")
    return out, m, l
