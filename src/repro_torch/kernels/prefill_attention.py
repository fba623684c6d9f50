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

Which body runs a call follows q's type, for all four entries: with bf16
q the products run on the tensor cores (the model-type entries on bf16
tiles; the int8 entries on int8 tiles converted to bf16 in shared memory,
the scales applied to the scores and to P outside the products), each
block's live key range split into a static number of shares merged by a
second kernel; with f32 q they run on the CUDA cores in f32, unsplit.
The plan (``tile_bounds``, ``split_share``, ``prefill_splits``) and the
merge (``merge_partials_plain``) are written out here in plain Python,
for the tests and ``chip_smoke.py``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import paged_gather

NEG_INF = -1e30
TILE_ROWS = 64      # folded (query position, head) rows of one block
KEY_TILE = 64       # keys per tile of the bf16 (tensor-core) kernel
MAX_SPLITS = 16     # the kernel's limit on key-range splits


def tile_bounds(q_offset: int, length: int, i_lo: int, i_hi: int,
                window: int, key_tile: int = KEY_TILE):
    """(first, live): the key tiles a block reads for the query positions
    [i_lo, i_hi) of a row at ``q_offset`` with ``length`` valid keys,
    tiles first .. first + live - 1, as the kernel computes them: keys
    below the length and at or before the tile's last query, and with a
    window none wholly below it (``_tile_bounds`` of the TPU kernel, with
    the query tile clipped at the chunk's end)."""
    limit = min(length, q_offset + i_hi)
    last = (limit + key_tile - 1) // key_tile - 1
    first = (min(max(q_offset + i_lo - window + 1, 0) // key_tile, last)
             if window > 0 else 0)
    return first, (last - first + 1 if last >= 0 else 0)


def split_share(first: int, live: int, splits: int, s: int):
    """Split ``s``'s consecutive share [lo, hi) of the live tiles."""
    return first + live * s // splits, first + live * (s + 1) // splits


def prefill_splits(M: int, Sq: int, Hk: int, G: int, cap: int,
                   sm_count: int) -> int:
    """How many shares the bf16 kernel splits each block's key range
    into: as many as keep the blocks within two per SM (the kernel's
    residency: one wave, no tail of a second), no more than the cache's
    ``cap`` rows hold tiles, at most ``MAX_SPLITS``.  Static shapes only:
    reading ``lengths`` would wait on the stream."""
    blocks = -(-Sq // (TILE_ROWS // G)) * Hk * M
    return max(1, min(2 * sm_count // max(blocks, 1), -(-cap // KEY_TILE),
                      MAX_SPLITS))


def merge_partials_plain(part_o, part_ml, dtype):
    """The plain form of the bf16 kernel's merge: part_o [splits, M, Sq,
    H, hd] unnormalised f32 accumulators and part_ml [splits, M, Sq, H, 2]
    their (m, l), m in log2 units -> [M, Sq, H, hd] in ``dtype``: with
    mx = max_s m_s and w_s = 2^(m_s - mx), sum_s w_s acc_s /
    max(sum_s w_s l_s, 1e-30).  An empty split has m = -1e30, l = 0."""
    m, l = part_ml[..., 0], part_ml[..., 1]
    w = torch.exp2(m - m.max(dim=0).values)
    num = (w[..., None] * part_o).sum(dim=0)
    den = (w * l).sum(dim=0).clamp_min(1e-30)
    return (num / den[..., None]).to(dtype)


def check_tma_layout(t, name: str) -> None:
    """The layout TMA reads a cache value leaf in (bf16, or int8 values;
    never the int8 scales, which are read by plain loads): a unit stride
    on hd, a 16-byte-aligned base and every other stride a multiple of 16
    bytes.  Raises ``ValueError`` otherwise; reads only the tensor's
    metadata."""
    es = t.element_size()
    if (t.stride(-1) != 1 or t.data_ptr() % 16
            or any(st * es % 16 for st in t.stride()[:-1])):
        raise ValueError(f"{name}: cache rows need a unit stride on hd, a "
                         f"16-byte-aligned base and strides of whole 16 "
                         f"bytes; got strides {tuple(t.stride())} at "
                         f"address {t.data_ptr()}")


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


_SM_COUNT = {}
_FNS = {}


def _sm_count(device) -> int:
    """The SM count of a tensor's card (read once: a host-side query)."""
    if device.index not in _SM_COUNT:
        _SM_COUNT[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SM_COUNT[device.index]


def _entry(name: str, n_ptrs: int, n_ints: int, n_strides: int,
           scale: bool):
    """The C entry ``name`` of ``csrc/prefill_attention.cu`` with its
    argument types set (once: a call then converts its arguments only)."""
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(_build.load("prefill_attention"), name)
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                       + [ctypes.c_longlong] * n_strides
                       + [ctypes.c_float] * scale + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def _call(name: str, ptrs, ints, strides, scale, stream):
    fn = _entry(name, len(ptrs), len(ints), len(strides), scale is not None)
    rc = fn(*[None if t is None else t.data_ptr() for t in ptrs], *ints,
            *strides, *(() if scale is None else (scale,)), stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _launch(entry: str, q, leaves, index, ints, splits: int):
    """Call ``entry`` of ``csrc/prefill_attention.cu`` on the current
    stream: the pointers of q, the cache leaves, the index tensors (None:
    a null pointer), the output and the split scratch (None with one
    split); q's type, ``ints``, then ``splits``; the (row, position, head)
    strides of q, each leaf and the output, the softmax scale and the
    stream.  The caller (``ops``) has checked devices, types and
    layouts."""
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    scratch = [None, None]
    if splits > 1:
        # one f32 buffer: the accumulators [splits, M, Sq, H, hd], then
        # (m, l) [splits, M, Sq, H, 2]
        rows = splits * q.shape[0] * q.shape[1] * q.shape[2]
        buf = q.new_empty(rows * (q.shape[3] + 2), dtype=torch.float32)
        scratch = [buf, buf[rows * q.shape[3]:]]
    strides = [st for t in (q, *leaves, out) for st in t.stride()[:3]]
    _call(entry, [q, *leaves, *index, out, *scratch],
          (0 if q.dtype == torch.float32 else 1, *ints, splits), strides,
          1.0 / q.shape[3] ** 0.5,
          torch.cuda.current_stream(q.device).cuda_stream)
    return out


def _dense_splits(q, Hk: int, cap: int) -> int:
    """The split count of a call (every entry): ``prefill_splits`` in
    bf16; f32 runs unsplit on the CUDA-core body."""
    if q.dtype != torch.bfloat16:
        return 1
    M, Sq, H, _ = q.shape
    return prefill_splits(M, Sq, Hk, H // Hk, cap, _sm_count(q.device))


def _q_rows_aligned(q):
    """q with 16-byte-aligned rows (a copy only when they are not)."""
    es = q.element_size()
    if (q.stride(3) == 1 and q.data_ptr() % 16 == 0
            and all(st * es % 16 == 0 for st in q.stride()[:3])):
        return q
    return q.clone(memory_format=torch.contiguous_format)


def merge_partials_cuda(part_o, part_ml, dtype):
    """Launch the bf16 entries' merge kernel alone on part_o/part_ml (as
    ``merge_partials_plain``); the tests and ``chip_smoke.py`` hold it
    against the plain form."""
    splits, M, Sq, H, hd = part_o.shape
    out = torch.empty((M, Sq, H, hd), dtype=dtype, device=part_o.device)
    _call("prefill_merge", [part_o.contiguous(), part_ml.contiguous(), out],
          (0 if dtype == torch.float32 else 1, M, Sq, H, hd, splits),
          out.stride()[:3], None,
          torch.cuda.current_stream(part_o.device).cuda_stream)
    return out


def prefill_attention_cuda(q, k_cache, v_cache, q_offset, lengths, *,
                           window: int = 0, slot_idx=None):
    """Launch the slab kernel (``ops.flash_prefill``)."""
    M, Sq, H, hd = q.shape
    B, S, Hk = k_cache.shape[:3]
    if q.dtype == torch.bfloat16:
        q = _q_rows_aligned(q)
    return _launch("flash_prefill", q, (k_cache, v_cache),
                   (slot_idx, q_offset, lengths),
                   (M, Sq, Hk, H // Hk, S, hd, int(window), B),
                   splits=_dense_splits(q, Hk, S))


def prefill_attention_paged_cuda(q, k_arena, v_arena, q_offset, lengths,
                                 block_tables, window: int = 0):
    """Launch the paged kernel (``ops.flash_prefill_paged``; the page
    size is a power of two)."""
    M, Sq, H, hd = q.shape
    P, page, Hk = k_arena.shape[:3]
    pmax = block_tables.shape[1]
    if q.dtype == torch.bfloat16:
        q = _q_rows_aligned(q)
    return _launch("flash_prefill_paged", q, (k_arena, v_arena),
                   (block_tables, q_offset, lengths),
                   (M, Sq, Hk, H // Hk, pmax, page.bit_length() - 1, hd,
                    int(window), P),
                   splits=_dense_splits(q, Hk, pmax * page))


def prefill_attention_quant_cuda(q, k_q, k_s, v_q, v_s, q_offset, lengths,
                                 *, window: int = 0, slot_idx=None):
    """Launch the int8 slab kernel (``ops.flash_prefill_quant``)."""
    M, Sq, H, hd = q.shape
    B, S, Hk = k_q.shape[:3]
    if q.dtype == torch.bfloat16:
        q = _q_rows_aligned(q)
    return _launch("flash_prefill_quant", q, (k_q, k_s, v_q, v_s),
                   (slot_idx, q_offset, lengths),
                   (M, Sq, Hk, H // Hk, S, hd, int(window), B),
                   splits=_dense_splits(q, Hk, S))


def prefill_attention_paged_quant_cuda(q, k_q, k_s, v_q, v_s, q_offset,
                                       lengths, block_tables,
                                       window: int = 0):
    """Launch the int8 paged kernel (``ops.flash_prefill_paged_quant``;
    the page size is a power of two)."""
    M, Sq, H, hd = q.shape
    P, page, Hk = k_q.shape[:3]
    pmax = block_tables.shape[1]
    if q.dtype == torch.bfloat16:
        q = _q_rows_aligned(q)
    return _launch("flash_prefill_paged_quant", q, (k_q, k_s, v_q, v_s),
                   (block_tables, q_offset, lengths),
                   (M, Sq, Hk, H // Hk, pmax, page.bit_length() - 1, hd,
                    int(window), P),
                   splits=_dense_splits(q, Hk, pmax * page))
