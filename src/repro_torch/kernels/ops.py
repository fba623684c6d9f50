"""Public kernel wrappers: check the arguments, then dispatch on the
tensors' device.  Slab caches go to ``flash_prefill``/``flash_decode``,
the paged arena with its block tables to ``flash_prefill_paged``/
``flash_decode_paged``; the Mamba-2 chunked scan is ``ssd_scan``; the
MoE experts' grouped matmul is ``moe_gmm``.

A CUDA tensor launches the hand-written kernel (``csrc/*.cu``, built at
first use by ``_build``) or raises: there is no fallback to the plain
version when a build or a launch fails.  A CPU tensor runs the kernel's
plain PyTorch version, which is how the tests exercise the surrounding
shapes, offsets and layouts on a machine without a card.

``LAUNCHES`` counts kernel launches per kernel (one per successful
launch, nowhere else), so a run can show that its main path went
through the kernels.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels.decode_attention import (
    MAX_GROUP, decode_attention_cuda, decode_attention_paged_cuda,
    decode_attention_paged_plain, decode_attention_plain)
from repro_torch.kernels.prefill_attention import (
    prefill_attention_cuda, prefill_attention_paged_cuda,
    prefill_attention_paged_plain, prefill_attention_plain)
from repro_torch.kernels.moe_gmm import gmm_cuda, gmm_plain
from repro_torch.kernels.ssd_scan import (MAX_CHUNK, SHAPES, ssd_scan_cuda,
                                          ssd_scan_plain)

LAUNCHES: Dict[str, int] = {"flash_prefill": 0, "flash_decode": 0,
                            "flash_prefill_paged": 0,
                            "flash_decode_paged": 0, "ssd_scan": 0,
                            "moe_gmm": 0}

_DTYPES = (torch.float32, torch.bfloat16)
_HEAD_DIMS = (64, 128)
_MAX_PREFILL_GROUP = 64
# page sizes the paged CUDA kernels take: powers of two (each 16-byte
# vector finds its page with a shift and a mask), 8 to 1024 rows
PAGE_SIZES = tuple(1 << i for i in range(3, 11))


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_common(q, k_cache, v_cache, index_tensors, name: str) -> None:
    if q.dim() != 4 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"{name}: q must be [*, S, H, hd] and the caches "
                         f"[B, S_max, Hk, hd] of one shape; got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    H, hd = q.shape[2], q.shape[3]
    Hk = k_cache.shape[2]
    if k_cache.shape[3] != hd or H % Hk:
        raise ValueError(f"{name}: head dims disagree (H={H}, Hk={Hk}, "
                         f"hd={hd} vs {k_cache.shape[3]})")
    if not (q.dtype == k_cache.dtype == v_cache.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"{name}: q/k/v must share one of {_DTYPES}; got "
                        f"{q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    devs = {t.device for t in (q, k_cache, v_cache, *index_tensors)}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on several devices: {devs}")
    for t in index_tensors:
        if t.dtype != torch.int32 or t.dim() != 1:
            raise TypeError(f"{name}: index tensors must be 1-D int32")
    if q.is_cuda:
        if hd not in _HEAD_DIMS:
            raise ValueError(f"{name}: the CUDA kernel takes hd in "
                             f"{_HEAD_DIMS}, got {hd}")
        vec = 16 // k_cache.element_size()      # the kernels' 16-byte loads
        for c in (k_cache, v_cache):
            if (c.stride(3) != 1 or c.data_ptr() % 16
                    or any(st % vec for st in c.stride()[:3])):
                raise ValueError(f"{name}: cache rows need a unit stride on "
                                 f"hd and 16-byte alignment")
        if any(not t.is_contiguous() for t in index_tensors):
            raise ValueError(f"{name}: index tensors must be contiguous")


def _check_tables(block_tables, rows: int, lengths, k_arena,
                  name: str) -> None:
    """Block-table checks on top of ``_check_common``: [rows, P_max]
    int32, contiguous, on the arena's device, a page size the kernel
    takes, and ``P_max * page`` bounding the lengths.  The last is read
    only from CPU tensors: reading a CUDA tensor's values would wait on
    the stream, so there the kernel clamps the keys at ``P_max * page``
    instead, as the slab kernel clamps at ``S_max``."""
    if block_tables.dim() != 2 or block_tables.dtype != torch.int32:
        raise TypeError(f"{name}: block_tables must be 2-D int32; got "
                        f"{block_tables.dim()}-D {block_tables.dtype}")
    if block_tables.device != k_arena.device:
        raise ValueError(f"{name}: block_tables on {block_tables.device}, "
                         f"arenas on {k_arena.device}")
    if not block_tables.is_contiguous():
        raise ValueError(f"{name}: block_tables must be contiguous")
    if block_tables.shape[0] != rows:
        raise ValueError(f"{name}: block_tables has {block_tables.shape[0]} "
                         f"rows, q has {rows}")
    page = k_arena.shape[1]
    if k_arena.is_cuda and page not in PAGE_SIZES:
        raise ValueError(f"{name}: the CUDA kernel takes page sizes "
                         f"{PAGE_SIZES}, got {page}")
    cap = block_tables.shape[1] * page
    if not lengths.is_cuda and rows and int(lengths.max()) > cap:
        raise ValueError(f"{name}: lengths up to {int(lengths.max())} exceed "
                         f"the tables' P_max * page = {cap}")


def flash_prefill(q, k_cache, v_cache, q_offset, lengths, *,
                  window: int = 0, slot_idx=None):
    """Cache-aware chunk prefill. q: [M, Sq, H, hd]; caches
    [B, S_max, Hk, hd]; q_offset/lengths: [M] int32; slot_idx: [M] int32
    cache rows (None: row m) -> [M, Sq, H, hd] in q's type."""
    idx = [q_offset, lengths] + ([slot_idx] if slot_idx is not None else [])
    _check_common(q, k_cache, v_cache, idx, "flash_prefill")
    M = q.shape[0]
    if any(t.shape[0] != M for t in idx):
        raise ValueError("flash_prefill: q_offset/lengths/slot_idx need M rows")
    if slot_idx is None and k_cache.shape[0] != M:
        raise ValueError("flash_prefill: without slot_idx the cache batch "
                         "must equal M")
    if not q.is_cuda:
        return prefill_attention_plain(q, k_cache, v_cache, q_offset, lengths,
                                       window=window, slot_idx=slot_idx)
    if q.shape[2] // k_cache.shape[2] > _MAX_PREFILL_GROUP:
        raise ValueError("flash_prefill: more than 64 query heads per KV head")
    if q.stride(3) != 1:
        q = q.contiguous()
    out = prefill_attention_cuda(q, k_cache, v_cache, q_offset, lengths,
                                 window=window, slot_idx=slot_idx)
    LAUNCHES["flash_prefill"] += 1
    return out


def flash_decode(q, k_cache, v_cache, lengths):
    """One-token decode. q: [B, 1, H, hd]; caches [B, S_max, Hk, hd];
    lengths: [B] int32 valid keys incl. the current one -> [B, 1, H, hd]."""
    _check_common(q, k_cache, v_cache, [lengths], "flash_decode")
    B = q.shape[0]
    if q.shape[1] != 1 or k_cache.shape[0] != B or lengths.shape[0] != B:
        raise ValueError("flash_decode: q must be [B, 1, H, hd] over a cache "
                         "and lengths of B rows")
    if not q.is_cuda:
        return decode_attention_plain(q, k_cache, v_cache, lengths)
    if q.shape[2] // k_cache.shape[2] > MAX_GROUP:
        raise ValueError(f"flash_decode: more than {MAX_GROUP} query heads "
                         f"per KV head")
    if q.stride(3) != 1:
        q = q.contiguous()
    out = decode_attention_cuda(q, k_cache, v_cache, lengths)
    LAUNCHES["flash_decode"] += 1
    return out


def flash_prefill_paged(q, k_arena, v_arena, q_offset, lengths,
                        block_tables, *, window: int = 0):
    """Cache-aware chunk prefill through block tables. q: [M, Sq, H, hd];
    arenas [P_phys, page, Hk, hd]; q_offset/lengths: [M] int32;
    block_tables [M, P_max] int32 (row m's table) -> [M, Sq, H, hd]."""
    _check_common(q, k_arena, v_arena, [q_offset, lengths],
                  "flash_prefill_paged")
    M = q.shape[0]
    if q_offset.shape[0] != M or lengths.shape[0] != M:
        raise ValueError("flash_prefill_paged: q_offset/lengths need M rows")
    _check_tables(block_tables, M, lengths, k_arena, "flash_prefill_paged")
    if not q.is_cuda:
        return prefill_attention_paged_plain(q, k_arena, v_arena, q_offset,
                                             lengths, block_tables,
                                             window=window)
    if q.shape[2] // k_arena.shape[2] > _MAX_PREFILL_GROUP:
        raise ValueError("flash_prefill_paged: more than 64 query heads per "
                         "KV head")
    if q.stride(3) != 1:
        q = q.contiguous()
    out = prefill_attention_paged_cuda(q, k_arena, v_arena, q_offset,
                                       lengths, block_tables, window=window)
    LAUNCHES["flash_prefill_paged"] += 1
    return out


def flash_decode_paged(q, k_arena, v_arena, lengths, block_tables):
    """One-token decode through block tables. q: [B, 1, H, hd]; arenas
    [P_phys, page, Hk, hd]; lengths: [B] int32 valid keys incl. the
    current one; block_tables [B, P_max] int32 -> [B, 1, H, hd]."""
    _check_common(q, k_arena, v_arena, [lengths], "flash_decode_paged")
    B = q.shape[0]
    if q.shape[1] != 1 or lengths.shape[0] != B:
        raise ValueError("flash_decode_paged: q must be [B, 1, H, hd] with "
                         "lengths of B rows")
    _check_tables(block_tables, B, lengths, k_arena, "flash_decode_paged")
    if not q.is_cuda:
        return decode_attention_paged_plain(q, k_arena, v_arena, lengths,
                                            block_tables)
    if q.shape[2] // k_arena.shape[2] > MAX_GROUP:
        raise ValueError(f"flash_decode_paged: more than {MAX_GROUP} query "
                         f"heads per KV head")
    if q.stride(3) != 1:
        q = q.contiguous()
    out = decode_attention_paged_cuda(q, k_arena, v_arena, lengths,
                                      block_tables)
    LAUNCHES["flash_decode_paged"] += 1
    return out


def ssd_scan(x, dt, A, Bm, Cm, h0, *, chunk: int = 128):
    """Mamba-2 SSD over a sequence, model layout (no ``D`` term).
    x: [B, S, nh, hd] and Bm/Cm: [B, S, N], one of f32/bf16; dt: [B, S, nh]
    post-softplus f32; A: [nh] negative f32; h0: [B, nh, hd, N] f32.
    Chunks of ``chunk`` rows (the last may be short).
    Returns (y [B, S, nh, hd] in x's type, h_final [B, nh, hd, N] f32)."""
    if x.dim() != 4 or Bm.dim() != 3 or Cm.shape != Bm.shape:
        raise ValueError(f"ssd_scan: x must be [B, S, nh, hd] and B/C "
                         f"[B, S, N]; got {tuple(x.shape)}, "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    B, S, nh, hd = x.shape
    N = Bm.shape[-1]
    if (Bm.shape[:2] != (B, S) or tuple(dt.shape) != (B, S, nh)
            or tuple(A.shape) != (nh,) or tuple(h0.shape) != (B, nh, hd, N)):
        raise ValueError(f"ssd_scan: shapes disagree: x {tuple(x.shape)}, "
                         f"dt {tuple(dt.shape)}, A {tuple(A.shape)}, "
                         f"B {tuple(Bm.shape)}, h0 {tuple(h0.shape)}")
    if not (x.dtype == Bm.dtype == Cm.dtype) or x.dtype not in _DTYPES:
        raise TypeError(f"ssd_scan: x/B/C must share one of {_DTYPES}; got "
                        f"{x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if any(t.dtype != torch.float32 for t in (dt, A, h0)):
        raise TypeError("ssd_scan: dt, A and h0 must be float32")
    if len({t.device for t in (x, dt, A, Bm, Cm, h0)}) != 1:
        raise ValueError("ssd_scan: tensors on several devices")
    if chunk < 1:
        raise ValueError(f"ssd_scan: chunk must be >= 1, got {chunk}")
    if not x.is_cuda:
        return ssd_scan_plain(x, dt, A, Bm, Cm, h0, chunk=chunk)
    if (hd, N) not in SHAPES:
        raise ValueError(f"ssd_scan: the CUDA kernel takes (hd, N) in "
                         f"{SHAPES}, got {(hd, N)}")
    if min(chunk, max(S, 1)) > MAX_CHUNK:
        raise ValueError(f"ssd_scan: the CUDA kernel takes chunks of at most "
                         f"{MAX_CHUNK} rows, got {chunk}")
    if S == 0 or B == 0:
        return torch.empty_like(x), h0.clone()
    out = ssd_scan_cuda(x, dt, A, Bm, Cm, h0, chunk=chunk)
    LAUNCHES["ssd_scan"] += 1
    return out


def moe_gmm(x, w):
    """Grouped expert matmul. x: [E, C, d]; w: [E, d, f] of one type
    (f32/bf16) -> [E, C, f] in that type, accumulated in f32.  x may be
    a broadcast view with expert stride 0 (it is read in place).  On CUDA
    the kernel takes d and f multiples of 8, a unit stride on the last
    dim and 16-byte aligned rows; anything else raises."""
    if (x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0]
            or x.shape[2] != w.shape[1]):
        raise ValueError(f"moe_gmm: x must be [E, C, d] and w [E, d, f]; "
                         f"got {tuple(x.shape)}, {tuple(w.shape)}")
    if x.dtype != w.dtype or x.dtype not in _DTYPES:
        raise TypeError(f"moe_gmm: x and w must share one of {_DTYPES}; got "
                        f"{x.dtype}, {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"moe_gmm: x on {x.device}, w on {w.device}")
    if not x.is_cuda:
        return gmm_plain(x, w)
    E, C, d = x.shape
    f = w.shape[2]
    if d % 8 or f % 8:
        raise ValueError(f"moe_gmm: the CUDA kernel takes d and f multiples "
                         f"of 8, got d={d}, f={f}")
    vec = 16 // x.element_size()            # the kernel's 16-byte loads
    for t in (x, w):
        # a size-1 dim's stride is never used for an address
        outer = [s for n, s in zip(t.shape[:2], t.stride()[:2]) if n > 1]
        if ((t.shape[2] > 1 and t.stride(2) != 1) or t.data_ptr() % 16
                or any(s % vec for s in outer)):
            raise ValueError("moe_gmm: rows need a unit stride on the last "
                             "dim and 16-byte alignment")
    if E == 0 or C == 0 or f == 0:
        return torch.zeros((E, C, f), dtype=x.dtype, device=x.device)
    out = gmm_cuda(x, w)
    LAUNCHES["moe_gmm"] += 1
    return out
