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

The kernels split each row's keys over fixed chunks of ``DECODE_CHUNK``
keys, one block per (chunk, KV head, head group of ``MAX_GROUP`` query
heads, row), and a second kernel merges a row's chunks in chunk order.
The plan (``decode_chunks``), the chunks' partial softmax states
(``decode_partials_plain``) and the merge (``decode_merge_plain``) are
written out here in plain PyTorch, for the tests and ``chip_smoke.py``.
The partials have the layout of the bf16 prefill's split merge
(``prefill_attention.merge_partials_plain``), which computes the same
function; the decode merge is its own because it reads ``lengths`` to
take only a row's live chunks, and adds them one row at a time in chunk
order, so that its result does not depend on the batch (a sum over the
chunk axis of the whole batch, on the CPU, rounds differently with the
batch's size).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
MAX_GROUP = 8          # query heads of one block (one head group)
DECODE_CHUNK = 256     # keys per block: a multiple of the 32-key tile


def decode_chunks(cap: int, chunk: int = DECODE_CHUNK) -> int:
    """How many key chunks the kernels cut a row into: ceil(cap /
    chunk), from the cache's static capacity ``cap`` (S_max, or P_max *
    page) alone; reading ``lengths`` would wait on the stream."""
    return -(-cap // chunk)


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


def decode_partials_plain(q, k, v, lengths, window: int = 0,
                          chunk: int = DECODE_CHUNK):
    """What the kernels write to their scratch, in plain PyTorch: for each
    chunk c and row b, the softmax state of the row's live keys in
    [c * chunk, (c + 1) * chunk), each head's unnormalised f32
    accumulator and (m, l), m in log2 units.  q [B, 1, H, hd]; k/v a slab
    cache [B, S, Hk, hd] (paged: gathered with ``paged_gather``; int8:
    dequantised).  Returns part_o [n, B, 1, H, hd] and part_ml [n, B, 1,
    H, 2] with n = ``decode_chunks(S, chunk)``; a chunk with no live key
    is (0, -1e30, 0).  Each (row, chunk) is computed on its own, so a row's
    partials do not depend on the batch or the capacity."""
    B, _, H, hd = q.shape
    S, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    n = decode_chunks(S, chunk)
    c2 = math.log2(math.e) / math.sqrt(hd)
    part_o = torch.zeros((n, B, 1, H, hd), dtype=torch.float32,
                         device=q.device)
    part_ml = torch.zeros((n, B, 1, H, 2), dtype=torch.float32,
                          device=q.device)
    part_ml[..., 0] = NEG_INF
    for b in range(B):
        L = min(int(lengths[b]), S)
        lo = max(0, L - window) if window > 0 else 0
        qg = q[b, 0].float().reshape(Hk, G, hd)
        for c in range(lo // chunk, -(-L // chunk)):
            keys = slice(max(lo, c * chunk), min(L, (c + 1) * chunk))
            s = torch.einsum("hgd,khd->hgk", qg, k[b, keys].float()) * c2
            m = s.max(dim=-1).values
            p = torch.exp2(s - m[..., None])
            o = torch.einsum("hgk,khd->hgd", p, v[b, keys].float())
            part_o[c, b, 0] = o.reshape(H, hd)
            part_ml[c, b, 0, :, 0] = m.reshape(H)
            part_ml[c, b, 0, :, 1] = p.sum(dim=-1).reshape(H)
    return part_o, part_ml


def decode_merge_plain(part_o, part_ml, lengths, cap: int, dtype,
                       window: int = 0, chunk: int = DECODE_CHUNK):
    """The plain form of the merge kernel: for each row b, its live chunks
    [lo // chunk, (L - 1) // chunk] (L = min(lengths[b], cap), lo the
    window's first key) in chunk order; with mx their largest m and w_c =
    2^(m_c - mx), sum_c w_c acc_c / max(sum_c w_c l_c, 1e-30) -> [B, 1, H,
    hd] in ``dtype``.  A row with no live key gets zeros."""
    B = part_o.shape[1]
    out = torch.zeros(part_o.shape[1:], dtype=torch.float32,
                      device=part_o.device)
    for b in range(B):
        L = min(int(lengths[b]), cap)
        lo = max(0, L - window) if window > 0 else 0
        if L <= lo:
            continue
        live = range(lo // chunk, (L - 1) // chunk + 1)
        m = part_ml[:, b, 0, :, 0]
        mx = m[live.start:live.stop].max(dim=0).values
        acc = torch.zeros_like(out[b, 0])
        den = torch.zeros_like(mx)
        for c in live:
            w = torch.exp2(m[c] - mx)
            den = den + w * part_ml[c, b, 0, :, 1]
            acc = acc + w[:, None] * part_o[c, b, 0]
        out[b, 0] = acc * (1.0 / den.clamp_min(1e-30))[:, None]
    return out.to(dtype)


_FNS = {}


def _entry(name: str, n_ptrs: int, n_ints: int, n_strides: int, scale: bool):
    """The C entry ``name`` of ``csrc/decode_attention.cu`` with its
    argument types set (once: a call then converts its arguments only)."""
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(_build.load("decode_attention"), name)
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                       + [ctypes.c_longlong] * n_strides
                       + [ctypes.c_float] * scale + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def _call(name: str, ptrs, ints, strides, scale, stream) -> None:
    fn = _entry(name, len(ptrs), len(ints), len(strides), scale is not None)
    rc = fn(*[t.data_ptr() for t in ptrs], *ints, *strides,
            *(() if scale is None else (scale,)), stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _launch(entry: str, q, leaves, index, ints, cap: int, chunk: int):
    """Call ``entry`` of ``csrc/decode_attention.cu`` on the current
    stream (the chunk kernel, then the merge): the pointers of q, the
    cache leaves, the index tensors, the output and the f32 scratch of
    the partials; q's type, ``ints`` (the window last), ``chunk``; the
    (row, head) strides of q, the (row, position, head) strides of each
    leaf, the (row, head) strides of the output, the softmax scale and
    the stream.  The caller (``ops``) has checked devices, types and
    layouts."""
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    # one f32 buffer: the accumulators [n, B, H, hd], then (m, l) [n, B, H, 2]
    rows = decode_chunks(cap, chunk) * q.shape[0] * q.shape[2]
    buf = q.new_empty(rows * (q.shape[3] + 2), dtype=torch.float32)
    strides = [q.stride(0), q.stride(2),
               *[st for t in leaves for st in t.stride()[:3]],
               out.stride(0), out.stride(2)]
    _call(entry, [q, *leaves, *index, out, buf, buf[rows * q.shape[3]:]],
          (0 if q.dtype == torch.float32 else 1, *ints, chunk), strides,
          1.0 / q.shape[3] ** 0.5,
          torch.cuda.current_stream(q.device).cuda_stream)
    return out


def decode_merge_cuda(part_o, part_ml, lengths, cap: int, dtype,
                      window: int = 0, chunk: int = DECODE_CHUNK):
    """Launch the merge kernel alone (``decode_merge_plain`` on the card)
    on partials in ``decode_partials_plain``'s layout (CUDA f32,
    contiguous) for a cache of ``cap`` rows.  For the tests and
    ``chip_smoke.py``: the decode entries launch it themselves."""
    _, B, _, H, hd = part_o.shape
    out = part_o.new_empty((B, 1, H, hd), dtype=dtype)
    _call("decode_merge", [part_o, part_ml, lengths, out],
          (0 if dtype == torch.float32 else 1, B, H, hd, cap, window, chunk),
          (out.stride(0), out.stride(2)), None,
          torch.cuda.current_stream(part_o.device).cuda_stream)
    return out


def decode_attention_cuda(q, k_cache, v_cache, lengths, window: int = 0,
                          chunk: int = DECODE_CHUNK):
    """Launch the slab kernel (``ops.flash_decode``)."""
    B, _, H, hd = q.shape
    S, Hk = k_cache.shape[1], k_cache.shape[2]
    return _launch("flash_decode", q, (k_cache, v_cache), (lengths,),
                   (B, Hk, H // Hk, S, hd, window), S, chunk)


def decode_attention_paged_cuda(q, k_arena, v_arena, lengths, block_tables,
                                window: int = 0, chunk: int = DECODE_CHUNK):
    """Launch the paged kernel (``ops.flash_decode_paged``; the page size
    is a power of two)."""
    B, _, H, hd = q.shape
    page, Hk = k_arena.shape[1], k_arena.shape[2]
    pmax = block_tables.shape[1]
    return _launch("flash_decode_paged", q, (k_arena, v_arena),
                   (lengths, block_tables),
                   (B, Hk, H // Hk, pmax, page.bit_length() - 1, hd, window),
                   pmax * page, chunk)


def decode_attention_quant_cuda(q, k_q, k_s, v_q, v_s, lengths,
                                window: int = 0, chunk: int = DECODE_CHUNK):
    """Launch the int8 slab kernel (``ops.flash_decode_quant``)."""
    B, _, H, hd = q.shape
    S, Hk = k_q.shape[1], k_q.shape[2]
    return _launch("flash_decode_quant", q, (k_q, k_s, v_q, v_s),
                   (lengths,), (B, Hk, H // Hk, S, hd, window), S, chunk)


def decode_attention_paged_quant_cuda(q, k_q, k_s, v_q, v_s, lengths,
                                      block_tables, window: int = 0,
                                      chunk: int = DECODE_CHUNK):
    """Launch the int8 paged kernel (``ops.flash_decode_paged_quant``;
    the page size is a power of two)."""
    B, _, H, hd = q.shape
    page, Hk = k_q.shape[1], k_q.shape[2]
    pmax = block_tables.shape[1]
    return _launch("flash_decode_paged_quant", q, (k_q, k_s, v_q, v_s),
                   (lengths, block_tables),
                   (B, Hk, H // Hk, pmax, page.bit_length() - 1, hd, window),
                   pmax * page, chunk)
