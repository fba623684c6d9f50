"""Cache-aware chunk-prefill attention: a [M, Sq] query chunk against the
resident slab KV cache [B, S_max], or through block tables against the
paged KV arena, each in the model's type or in int8 with scales.

The CUDA kernels (``csrc/prefill_attention.cu``) replace the TPU kernels
``repro.kernels.prefill_attention.flash_prefill_bhsd`` (slab),
``flash_prefill_paged_bhsd`` (paged), ``flash_prefill_quant_bhsd`` and
``flash_prefill_paged_quant_bhsd`` (their int8 forms); the source's
header says what bounds them on the H100 and what the design does about
that.  All versions here take the model layout: q [M, Sq, H, hd] and
per-row ``q_offset``/``lengths`` [M] int32, with either slab caches
[B, S_max, Hk, hd] and an optional ``slot_idx`` [M] int32 naming each
row's cache row (default: row m reads cache row m), or one layer's page
arenas [P_phys, page, Hk, hd] with ``block_tables`` [M, P_max] int32
(row m's table).  An int8 cache has int8 values and scales
[..., Hk, 1] in q's type beside them; a key or value is
``f32(int8) * f32(scale)``.  Caches are read in place.  Every query row
must have at least one unmasked key (``q_offset + i < lengths``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import paged_gather

NEG_INF = -1e30

def _masked_prefill(q, k, v, q_offset, lengths, window: int):
    """The masked softmax in f32 of the plain versions: q [M, Sq, H, hd]
    against each row's first L cache rows k/v [M, L, Hk, hd] (f32), GQA
    by grouping query heads."""
    M, Sq, H, hd = q.shape
    L, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    dev = q.device
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


def _valid_rows(q, k_cache, lengths, slot_idx):
    """(cache rows [M], valid extent L) the plain versions read."""
    M = q.shape[0]
    L = min(int(lengths.max()), k_cache.shape[1]) if M else 0
    rows = (slot_idx.long() if slot_idx is not None
            else torch.arange(M, device=q.device))
    return rows, L


def prefill_attention_plain(q, k_cache, v_cache, q_offset, lengths, *,
                            window: int = 0, slot_idx=None):
    """The plain PyTorch version: a masked softmax in f32 over the valid
    slice of each row's cache stripe (GQA by grouping query heads)."""
    rows, L = _valid_rows(q, k_cache, lengths, slot_idx)
    return _masked_prefill(q, k_cache[rows, :L].float(),
                           v_cache[rows, :L].float(), q_offset, lengths,
                           window)


def prefill_attention_quant_plain(q, k_q, k_s, v_q, v_s, q_offset, lengths,
                                  *, window: int = 0, slot_idx=None):
    """The int8 plain version: the valid slice dequantised as
    ``f32(int8) * f32(scale)``, then the masked softmax."""
    rows, L = _valid_rows(q, k_q, lengths, slot_idx)
    k = k_q[rows, :L].float() * k_s[rows, :L].float()
    v = v_q[rows, :L].float() * v_s[rows, :L].float()
    return _masked_prefill(q, k, v, q_offset, lengths, window)


def prefill_attention_paged_plain(q, k_arena, v_arena, q_offset, lengths,
                                  block_tables, window: int = 0):
    """The paged plain version: each row's pages gathered into a linear
    view, then the slab plain version."""
    return prefill_attention_plain(q, paged_gather(k_arena, block_tables),
                                   paged_gather(v_arena, block_tables),
                                   q_offset, lengths, window=window)


def prefill_attention_paged_quant_plain(q, k_q, k_s, v_q, v_s, q_offset,
                                        lengths, block_tables,
                                        window: int = 0):
    """The int8 paged plain version: values and scales gathered through
    the tables, then the int8 slab plain version."""
    bt = block_tables
    return prefill_attention_quant_plain(
        q, paged_gather(k_q, bt), paged_gather(k_s, bt),
        paged_gather(v_q, bt), paged_gather(v_s, bt), q_offset, lengths,
        window=window)


def _launch(entry: str, q, leaves, index, ints):
    """Call ``entry`` of ``csrc/prefill_attention.cu`` on the current
    stream: the pointers of q, the cache leaves, the index tensors (None:
    a null pointer) and the output, q's type, ``ints``, the (row,
    position, head) strides of q, each leaf and the output, the softmax
    scale and the stream.  The caller (``ops``) has checked devices,
    types and layouts."""
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    ptrs = [q, *leaves, *index, out]
    strides = [st for t in (q, *leaves, out) for st in t.stride()[:3]]
    fn = getattr(_build.load("prefill_attention"), entry)
    fn.argtypes = ([ctypes.c_void_p] * len(ptrs)
                   + [ctypes.c_int] * (1 + len(ints))
                   + [ctypes.c_longlong] * len(strides)
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    rc = fn(*[None if t is None else t.data_ptr() for t in ptrs],
            0 if q.dtype == torch.float32 else 1, *ints, *strides,
            1.0 / q.shape[3] ** 0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc}")
    return out


def prefill_attention_cuda(q, k_cache, v_cache, q_offset, lengths, *,
                           window: int = 0, slot_idx=None):
    """Launch the slab kernel (``ops.flash_prefill``)."""
    M, Sq, H, hd = q.shape
    S, Hk = k_cache.shape[1], k_cache.shape[2]
    return _launch("flash_prefill", q, (k_cache, v_cache),
                   (slot_idx, q_offset, lengths),
                   (M, Sq, Hk, H // Hk, S, hd, int(window)))


def prefill_attention_paged_cuda(q, k_arena, v_arena, q_offset, lengths,
                                 block_tables, window: int = 0):
    """Launch the paged kernel (``ops.flash_prefill_paged``; the page
    size is a power of two)."""
    M, Sq, H, hd = q.shape
    page, Hk = k_arena.shape[1], k_arena.shape[2]
    return _launch("flash_prefill_paged", q, (k_arena, v_arena),
                   (block_tables, q_offset, lengths),
                   (M, Sq, Hk, H // Hk, block_tables.shape[1],
                    page.bit_length() - 1, hd, int(window)))


def prefill_attention_quant_cuda(q, k_q, k_s, v_q, v_s, q_offset, lengths,
                                 *, window: int = 0, slot_idx=None):
    """Launch the int8 slab kernel (``ops.flash_prefill_quant``)."""
    M, Sq, H, hd = q.shape
    S, Hk = k_q.shape[1], k_q.shape[2]
    return _launch("flash_prefill_quant", q, (k_q, k_s, v_q, v_s),
                   (slot_idx, q_offset, lengths),
                   (M, Sq, Hk, H // Hk, S, hd, int(window)))


def prefill_attention_paged_quant_cuda(q, k_q, k_s, v_q, v_s, q_offset,
                                       lengths, block_tables,
                                       window: int = 0):
    """Launch the int8 paged kernel (``ops.flash_prefill_paged_quant``;
    the page size is a power of two)."""
    M, Sq, H, hd = q.shape
    page, Hk = k_q.shape[1], k_q.shape[2]
    return _launch("flash_prefill_paged_quant", q, (k_q, k_s, v_q, v_s),
                   (block_tables, q_offset, lengths),
                   (M, Sq, Hk, H // Hk, block_tables.shape[1],
                    page.bit_length() - 1, hd, int(window)))
