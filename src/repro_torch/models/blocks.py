"""The dense decoder layer in prefill and decode modes.

Cache writes are in place: a layer's cache leaves are views
[B, S_max, Hk, hd] into the stacked [G, B, S_max, Hk, hd] cache, written
with advanced-index assignment (the JAX package's functional update with
donation becomes an in-place update here).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import (blocked_attention, decode_attention,
                                          prefill_attention)
from repro_torch.models.common import rms_norm
from repro_torch.models.mlp import apply_mlp
from repro_torch.models.rope import apply_rope


def _qkv(p, x, cfg: ModelConfig):
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, cfg.num_heads, hd)
    k = (x @ p["wk"]).reshape(B, S, cfg.num_kv_heads, hd)
    v = (x @ p["wv"]).reshape(B, S, cfg.num_kv_heads, hd)
    return q, k, v


def _rope(cfg: ModelConfig, q, k, positions):
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta))


def _cache_rows(slot_idx, M: int, device):
    """[M, 1] cache-row index per batch row (row m, or ``slot_idx[m]``)."""
    rows = (torch.arange(M, device=device) if slot_idx is None
            else slot_idx.long())
    return rows[:, None]


def _write_kv(cache_k, cache_v, k_new, v_new, offsets, slot_idx=None):
    """Write per-row chunks at per-row offsets, in place.

    cache_*: [B, S_max, Hk, hd]; k_new: [M, S, Hk, hd]; offsets: [M].
    Like ``dynamic_update_slice`` in the JAX package, a start that would
    run past the end is clamped so the whole chunk fits."""
    S_max = cache_k.shape[1]
    M, S = k_new.shape[:2]
    start = torch.clamp(offsets.long(), 0, S_max - S)
    pos = start[:, None] + torch.arange(S, device=k_new.device)[None, :]
    rows = _cache_rows(slot_idx, M, k_new.device)
    cache_k[rows, pos] = k_new
    cache_v[rows, pos] = v_new


def _slab_write_scatter(cache, rows_new, positions, slot_idx=None):
    """Per-row scatter into the slab cache, in place.  cache:
    [B, S_max, Hk, hd]; rows_new: [M, S, Hk, hd]; positions: [M, S]
    absolute row indices.  Negative or out-of-range positions redirect to
    the scratch row ``S_max - 1`` (never read; the engine keeps real
    content out of it), so an inactive lane's rows are absorbed without
    clobbering its valid prefix."""
    S_max = cache.shape[1]
    pos = positions.long()
    pos = torch.where((pos < 0) | (pos >= S_max),
                      torch.full_like(pos, S_max - 1), pos)
    cache[_cache_rows(slot_idx, rows_new.shape[0], rows_new.device), pos] = rows_new


def apply_attn_mixer(p, x, cfg: ModelConfig, *, mode: str, positions,
                     lengths, layer_cache: Optional[Dict[str, torch.Tensor]],
                     window: int, write_positions=None, slot_idx=None
                     ) -> torch.Tensor:
    """x: [M, S, d].  ``lengths`` [M]: valid tokens in the cache *before*
    this call.  ``write_positions`` decouples the K/V write position from
    the attention valid length ([M] in decode mode, [M, S] in prefill
    mode; out of range = the scratch row).  ``slot_idx`` [M] names each
    row's cache row (prefill mode).  Writes ``layer_cache`` in place and
    returns the mixer output."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg)
    q, k = _rope(cfg, q, k, positions)
    if mode == "prefill" and layer_cache is None:
        out = blocked_attention(q, k, v, causal=True, window=window)
    elif mode == "prefill":
        ck, cv = layer_cache["k"], layer_cache["v"]
        if write_positions is not None:
            _slab_write_scatter(ck, k, write_positions, slot_idx)
            _slab_write_scatter(cv, v, write_positions, slot_idx)
        else:
            _write_kv(ck, cv, k, v, lengths, slot_idx)
        out = prefill_attention(q, ck, cv, q_offset=lengths,
                                lengths=lengths + S, window=window,
                                slot_idx=slot_idx)
    elif mode == "decode":
        assert layer_cache is not None and S == 1 and slot_idx is None
        ck, cv = layer_cache["k"], layer_cache["v"]
        wpos = lengths if write_positions is None else write_positions
        _write_kv(ck, cv, k, v, wpos)
        out = decode_attention(q, ck, cv, lengths + 1, window=window)
    else:
        raise ValueError(mode)
    return out.reshape(B, S, cfg.num_heads * cfg.head_dim) @ p["wo"]


def apply_layer(lp, x, cfg: ModelConfig, *, mode: str, positions, lengths,
                layer_cache, window: int, write_positions=None,
                slot_idx=None) -> torch.Tensor:
    """Pre-norm residual block (attention mixer + MLP)."""
    h = rms_norm(x, lp["norm1"], cfg.norm_eps)
    x = x + apply_attn_mixer(
        lp["attn"], h, cfg, mode=mode, positions=positions, lengths=lengths,
        layer_cache=layer_cache, window=window,
        write_positions=write_positions, slot_idx=slot_idx)
    h = rms_norm(x, lp["norm2"], cfg.norm_eps)
    return x + apply_mlp(lp["ffn"], h, cfg.act)
