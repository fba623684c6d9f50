"""Flash-decode attention: one query token per sequence against the slab
KV cache, or through block tables against the paged KV arena.

The CUDA kernels (``csrc/decode_attention.cu``) replace the TPU kernels
``repro.kernels.decode_attention.flash_decode_bhgd`` (slab) and
``flash_decode_paged_bhgd`` (paged); the source's header says what
bounds them on the H100 and what the design does about that.  All
versions here take the model layout: q [B, 1, H, hd], ``lengths`` [B]
int32 (valid keys, the current token included), and either slab caches
[B, S_max, Hk, hd] or one layer's page arenas [P_phys, page, Hk, hd]
with ``block_tables`` [B, P_max] int32 physical page ids, all read in
place.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
MAX_GROUP = 8          # query heads per KV head the kernel takes

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 10 + [ctypes.c_float, ctypes.c_void_p])
_PAGED_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 10
                   + [ctypes.c_float, ctypes.c_void_p])


def paged_gather(arena, block_tables):
    """Linearise a page arena through block tables: arena
    [P_phys, page, Hk, x], block_tables [B, P_max] -> [B, P_max * page,
    Hk, x].  Rows past a session's valid length land on scratch or stale
    pages and are masked by ``lengths``, like the slab's unwritten rows."""
    g = arena[block_tables.long()]                  # [B, P_max, page, ...]
    B, pm, ps = g.shape[:3]
    return g.reshape((B, pm * ps) + tuple(g.shape[3:]))


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


def decode_attention_paged_plain(q, k_arena, v_arena, lengths, block_tables):
    """The paged plain version: the session's pages gathered into a
    linear view, then the slab plain version."""
    return decode_attention_plain(q, paged_gather(k_arena, block_tables),
                                  paged_gather(v_arena, block_tables),
                                  lengths)


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


def decode_attention_paged_cuda(q, k_arena, v_arena, lengths, block_tables):
    """Launch the paged CUDA kernel on the current stream.  The caller
    (``ops.flash_decode_paged``) has checked devices, types, layouts and
    that the page size is a power of two."""
    lib = _build.load("decode_attention")
    fn = lib.flash_decode_paged
    fn.argtypes, fn.restype = _PAGED_ARGTYPES, ctypes.c_int
    B, _, H, hd = q.shape
    page, Hk = k_arena.shape[1], k_arena.shape[2]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    rc = fn(q.data_ptr(), k_arena.data_ptr(), v_arena.data_ptr(),
            lengths.data_ptr(), block_tables.data_ptr(), out.data_ptr(),
            0 if q.dtype == torch.float32 else 1, B, Hk, H // Hk,
            block_tables.shape[1], page.bit_length() - 1, hd,
            q.stride(0), q.stride(2), *k_arena.stride()[:3],
            *v_arena.stride()[:3], out.stride(0), out.stride(2),
            1.0 / hd ** 0.5, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_decode_paged kernel launch failed: CUDA error {rc}")
    return out
