"""Public attention wrappers: check the arguments, then dispatch on the
tensors' device.

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

from repro_torch.kernels.decode_attention import (MAX_GROUP,
                                                  decode_attention_cuda,
                                                  decode_attention_plain)
from repro_torch.kernels.prefill_attention import (prefill_attention_cuda,
                                                   prefill_attention_plain)

LAUNCHES: Dict[str, int] = {"flash_prefill": 0, "flash_decode": 0}

_DTYPES = (torch.float32, torch.bfloat16)
_HEAD_DIMS = (64, 128)
_MAX_PREFILL_GROUP = 64


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
