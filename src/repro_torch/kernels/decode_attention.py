"""Flash-decode attention: one query token per sequence against the slab
KV cache, or through block tables against the paged KV arena, each in
the model's type or in int8 with scales.

The CUDA kernels (``csrc/decode_attention.cu``) replace the TPU kernels
``repro.kernels.decode_attention.flash_decode_bhgd`` (slab) and
``flash_decode_paged_bhgd`` (paged); their int8 entries replace the XLA
int8 branches of ``repro.models.attention.decode_attention`` and
``decode_attention_paged``, which have no TPU kernel.  The source's
header says what bounds them on the H100 and what the design does about
that.  All versions here take the model layout: q [B, 1, H, hd],
``lengths`` [B] int32 (valid keys, the current token included), and
either slab caches [B, S_max, Hk, hd] or one layer's page arenas
[P_phys, page, Hk, hd] with ``block_tables`` [B, P_max] int32 physical
page ids, all read in place.  An int8 cache has scales [..., Hk, 1] in
q's type beside its values; a key or value is ``f32(int8) * f32(scale)``.
``window`` > 0 is a sliding window: only keys
[max(0, lengths - window), lengths) are attended (the XLA window branch
of ``repro.models.attention.decode_attention``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
MAX_GROUP = 8          # query heads per KV head the kernel takes

def paged_gather(arena, block_tables):
    """Linearise a page arena through block tables: arena
    [P_phys, page, Hk, x], block_tables [B, P_max] -> [B, P_max * page,
    Hk, x].  Rows past a session's valid length land on scratch or stale
    pages and are masked by ``lengths``, like the slab's unwritten rows."""
    g = arena[block_tables.long()]                  # [B, P_max, page, ...]
    B, pm, ps = g.shape[:3]
    return g.reshape((B, pm * ps) + tuple(g.shape[3:]))


def _masked_decode(q, k, v, lengths, window: int):
    """The masked softmax in f32 of the plain versions: q [B, 1, H, hd]
    against the first L cache rows k/v [B, L, Hk, hd] (f32), the G query
    heads of a KV head grouped together; keys below ``lengths - window``
    masked when ``window`` > 0."""
    B, _, H, hd = q.shape
    L, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    qg = q[:, 0].float().reshape(B, Hk, G, hd) * (1.0 / hd ** 0.5)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k)
    pos = torch.arange(L, device=q.device)[None, :]
    valid = pos < lengths.long()[:, None]                         # [B, L]
    if window > 0:
        valid = valid & (pos >= lengths.long()[:, None] - window)
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v)
    return out.reshape(B, 1, H, hd).to(q.dtype)


def _valid_len(q, k_cache, lengths) -> int:
    return min(int(lengths.max()), k_cache.shape[1]) if q.shape[0] else 0


def decode_attention_plain(q, k_cache, v_cache, lengths, window: int = 0):
    """The plain PyTorch version: a masked softmax in f32 over the valid
    slice, the G query heads of a KV head grouped together."""
    L = _valid_len(q, k_cache, lengths)
    return _masked_decode(q, k_cache[:, :L].float(), v_cache[:, :L].float(),
                          lengths, window)


def decode_attention_quant_plain(q, k_q, k_s, v_q, v_s, lengths,
                                 window: int = 0):
    """The int8 plain version: the valid slice dequantised as
    ``f32(int8) * f32(scale)``, then the masked softmax."""
    L = _valid_len(q, k_q, lengths)
    return _masked_decode(q, k_q[:, :L].float() * k_s[:, :L].float(),
                          v_q[:, :L].float() * v_s[:, :L].float(), lengths,
                          window)


def decode_attention_paged_plain(q, k_arena, v_arena, lengths, block_tables,
                                 window: int = 0):
    """The paged plain version: the session's pages gathered into a
    linear view, then the slab plain version."""
    return decode_attention_plain(q, paged_gather(k_arena, block_tables),
                                  paged_gather(v_arena, block_tables),
                                  lengths, window)


def decode_attention_paged_quant_plain(q, k_q, k_s, v_q, v_s, lengths,
                                       block_tables, window: int = 0):
    """The int8 paged plain version: values and scales gathered through
    the tables, then the int8 slab plain version."""
    bt = block_tables
    return decode_attention_quant_plain(
        q, paged_gather(k_q, bt), paged_gather(k_s, bt),
        paged_gather(v_q, bt), paged_gather(v_s, bt), lengths, window)


def _launch(entry: str, q, leaves, index, ints):
    """Call ``entry`` of ``csrc/decode_attention.cu`` on the current
    stream: the pointers of q, the cache leaves, the index tensors and
    the output, q's type, ``ints`` (the window last), the (row, head)
    strides of q, the (row, position, head) strides of each leaf, the
    (row, head) strides of the output, the softmax scale and the stream.
    The caller (``ops``) has checked devices, types and layouts."""
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    ptrs = [q, *leaves, *index, out]
    strides = [q.stride(0), q.stride(2),
               *[st for t in leaves for st in t.stride()[:3]],
               out.stride(0), out.stride(2)]
    fn = getattr(_build.load("decode_attention"), entry)
    fn.argtypes = ([ctypes.c_void_p] * len(ptrs)
                   + [ctypes.c_int] * (1 + len(ints))
                   + [ctypes.c_longlong] * len(strides)
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    rc = fn(*[t.data_ptr() for t in ptrs],
            0 if q.dtype == torch.float32 else 1, *ints, *strides,
            1.0 / q.shape[3] ** 0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc}")
    return out


def decode_attention_cuda(q, k_cache, v_cache, lengths, window: int = 0):
    """Launch the slab kernel (``ops.flash_decode``)."""
    B, _, H, hd = q.shape
    S, Hk = k_cache.shape[1], k_cache.shape[2]
    return _launch("flash_decode", q, (k_cache, v_cache), (lengths,),
                   (B, Hk, H // Hk, S, hd, window))


def decode_attention_paged_cuda(q, k_arena, v_arena, lengths, block_tables,
                                window: int = 0):
    """Launch the paged kernel (``ops.flash_decode_paged``; the page size
    is a power of two)."""
    B, _, H, hd = q.shape
    page, Hk = k_arena.shape[1], k_arena.shape[2]
    return _launch("flash_decode_paged", q, (k_arena, v_arena),
                   (lengths, block_tables),
                   (B, Hk, H // Hk, block_tables.shape[1],
                    page.bit_length() - 1, hd, window))


def decode_attention_quant_cuda(q, k_q, k_s, v_q, v_s, lengths,
                                window: int = 0):
    """Launch the int8 slab kernel (``ops.flash_decode_quant``)."""
    B, _, H, hd = q.shape
    S, Hk = k_q.shape[1], k_q.shape[2]
    return _launch("flash_decode_quant", q, (k_q, k_s, v_q, v_s),
                   (lengths,), (B, Hk, H // Hk, S, hd, window))


def decode_attention_paged_quant_cuda(q, k_q, k_s, v_q, v_s, lengths,
                                      block_tables, window: int = 0):
    """Launch the int8 paged kernel (``ops.flash_decode_paged_quant``;
    the page size is a power of two)."""
    B, _, H, hd = q.shape
    page, Hk = k_q.shape[1], k_q.shape[2]
    return _launch("flash_decode_paged_quant", q, (k_q, k_s, v_q, v_s),
                   (lengths, block_tables),
                   (B, Hk, H // Hk, block_tables.shape[1],
                    page.bit_length() - 1, hd, window))
