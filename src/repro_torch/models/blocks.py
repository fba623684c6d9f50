"""Layer slots (attention or Mamba-2 mixer; MLP, MoE or no FFN) in prefill
and decode modes, and (attention + MLP) in the differentiable train mode.

A *layer slot* is described statically by ``LayerSpec``, as in the JAX
package; ``models.model`` stacks identical slots across repeating groups.

Cache writes are in place: an attention layer's cache leaves are views
[B, S_max, Hk, hd] into the stacked [G, B, S_max, Hk, hd] slab cache, or
[P_phys, page, Hk, hd] into the stacked [G, P_phys, page, Hk, hd] page
arena, written with advanced-index assignment (the JAX package's
functional update with donation becomes an in-place update here).  An
int8 cache (``"ks" in layer_cache``) holds int8 "k"/"v" and their scales
"ks"/"vs" [..., Hk, 1]: its writers quantise the new rows once
(``quantize_kv``) and write the four leaves at one index.  A Mamba-2
layer's leaves are per-slot states [B, ...] on both layouts, gathered
by slot, advanced, and written back (only on active lanes).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import mamba2
from repro_torch.models.attention import (blocked_attention, decode_attention,
                                          decode_attention_paged,
                                          prefill_attention,
                                          prefill_attention_paged,
                                          prefill_attention_paged_quant,
                                          prefill_attention_quant, quantize_kv,
                                          train_attention)
from repro_torch.models.common import rms_norm
from repro_torch.models.mlp import apply_mlp
from repro_torch.models.moe import moe_output
from repro_torch.models.rope import apply_rope


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str        # "attn" | "ssm"
    ffn: str         # "mlp" | "moe" | "none"


def layer_specs_for_group(cfg: ModelConfig, group_size: int):
    """Static layout of one repeating group (layer i uses i % group_size)."""
    def ffn(j):
        if cfg.d_ff == 0:
            return "none"
        return "moe" if cfg.layer_has_moe(j) else "mlp"
    return tuple(LayerSpec(kind=cfg.layer_kind(j), ffn=ffn(j))
                 for j in range(group_size))


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


def _chunk_index(S_max: int, k_new, offsets, slot_idx):
    """(rows [M, 1], positions [M, S]) of per-row chunks at per-row
    offsets.  Like ``dynamic_update_slice`` in the JAX package, a start
    that would run past the end is clamped so the whole chunk fits."""
    M, S = k_new.shape[:2]
    start = torch.clamp(offsets.long(), 0, S_max - S)
    pos = start[:, None] + torch.arange(S, device=k_new.device)[None, :]
    return _cache_rows(slot_idx, M, k_new.device), pos


def _write_kv(cache_k, cache_v, k_new, v_new, offsets, slot_idx=None):
    """Write per-row chunks at per-row offsets, in place.

    cache_*: [B, S_max, Hk, hd]; k_new: [M, S, Hk, hd]; offsets: [M]."""
    idx = _chunk_index(cache_k.shape[1], k_new, offsets, slot_idx)
    cache_k[idx] = k_new
    cache_v[idx] = v_new


def _quantized(k_new, v_new):
    """The four int8-cache leaves of new K/V rows, quantised once."""
    kq, ks = quantize_kv(k_new)
    vq, vs = quantize_kv(v_new)
    return {"k": kq, "v": vq, "ks": ks, "vs": vs}


def _write_leaves(layer_cache, rows, idx) -> None:
    for name, r in rows.items():
        leaf = layer_cache[name]
        leaf[idx] = r.to(leaf.dtype)


def _write_kv_quant(layer_cache, k_new, v_new, offsets, slot_idx=None):
    """``_write_kv`` into an int8 cache: quantise the chunks, then write
    values and scales at the same rows, in place."""
    idx = _chunk_index(layer_cache["k"].shape[1], k_new, offsets, slot_idx)
    _write_leaves(layer_cache, _quantized(k_new, v_new), idx)


def _scatter_index(S_max: int, positions, slot_idx, M: int, device):
    """Scatter rows and positions into a slab cache of ``S_max`` rows,
    out-of-range positions redirected to the scratch row."""
    pos = positions.long()
    pos = torch.where((pos < 0) | (pos >= S_max),
                      torch.full_like(pos, S_max - 1), pos)
    return _cache_rows(slot_idx, M, device), pos


def _slab_write_scatter(cache, rows_new, positions, slot_idx=None):
    """Per-row scatter into the slab cache, in place.  cache:
    [B, S_max, Hk, hd]; rows_new: [M, S, Hk, hd]; positions: [M, S]
    absolute row indices.  Negative or out-of-range positions redirect to
    the scratch row ``S_max - 1`` (never read; the engine keeps real
    content out of it), so an inactive lane's rows are absorbed without
    clobbering its valid prefix."""
    cache[_scatter_index(cache.shape[1], positions, slot_idx,
                         rows_new.shape[0], rows_new.device)] = rows_new


def _slab_write_scatter_quant(layer_cache, k_new, v_new, positions,
                              slot_idx=None):
    """``_slab_write_scatter`` into an int8 cache: quantise once, write
    the four leaves at one index, in place."""
    idx = _scatter_index(layer_cache["k"].shape[1], positions, slot_idx,
                         k_new.shape[0], k_new.device)
    _write_leaves(layer_cache, _quantized(k_new, v_new), idx)


def paged_write_index(block_tables, positions, num_pages: int, page: int):
    """Where new rows land in a page arena of ``num_pages`` physical
    pages of ``page`` rows: (physical page, row in page), each [B, S],
    for absolute ``positions`` [B, S] through ``block_tables`` [B, P_max]
    (unmapped entries already point at the scratch page).  Negative or
    beyond-table positions go to the scratch (last physical) page, which
    is never read.  Every layer writes the same places, so a forward
    computes this once."""
    p_max = block_tables.shape[1]
    pos = torch.clamp(positions.long(), min=0)
    logical = pos // page
    pg = torch.gather(block_tables.long(), 1,
                      torch.clamp(logical, max=p_max - 1))
    oob = (positions < 0) | (logical >= p_max)
    return torch.where(oob, num_pages - 1, pg), pos % page


def _paged_write(arena, rows, block_tables, positions):
    """Scatter new rows into the page arena through a block table, in
    place.  arena: [P_phys, page, Hk, hd]; rows: [B, S, Hk, hd]; see
    ``paged_write_index``.  Distinct sessions own distinct writable
    pages, so in-range indices never collide; the rows that collide all
    land on the scratch page."""
    arena[paged_write_index(block_tables, positions, arena.shape[0],
                            arena.shape[1])] = rows


def _paged_write_quant(layer_cache, k_new, v_new, paged_index):
    """The paged write into int8 arenas: quantise once, write values and
    scale arenas at the forward's one ``paged_write_index``, in place."""
    _write_leaves(layer_cache, _quantized(k_new, v_new), paged_index)


def apply_attn_mixer(p, x, cfg: ModelConfig, *, mode: str, positions,
                     lengths, layer_cache: Optional[Dict[str, torch.Tensor]],
                     window: int, write_positions=None, slot_idx=None,
                     block_tables=None, paged_index=None) -> torch.Tensor:
    """x: [M, S, d].  ``lengths`` [M]: valid tokens in the cache *before*
    this call.  ``write_positions`` decouples the K/V write position from
    the attention valid length ([M] in decode mode, [M, S] in prefill
    mode; out of range = the scratch row or page).  ``slot_idx`` [M]
    names each row's slab cache row (prefill mode).  ``block_tables``
    [M, P_max] switches to the paged layout (the leaves are page
    arenas; row m's table); ``paged_index`` is then where the chunk's
    rows land (``paged_write_index``, write positions already applied).
    An int8 cache (``"ks" in layer_cache``) is quantised on write and
    read through the int8 dispatchers; the cache decides, as in JAX.
    ``mode="train"``: causal attention over the rows themselves, no cache,
    differentiable (``train_attention``: kernel 9 on CUDA tensors).
    Writes ``layer_cache`` in place and returns the mixer output."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg)
    q, k = _rope(cfg, q, k, positions)
    # an int8 cache carries its scales beside the values
    quant = layer_cache is not None and "ks" in layer_cache
    if mode == "train":
        assert layer_cache is None
        out = train_attention(q, k, v, causal=True, window=window)
    elif mode == "prefill" and layer_cache is None:
        out = blocked_attention(q, k, v, causal=True, window=window)
    elif mode == "prefill" and block_tables is not None:
        assert slot_idx is None
        lc = layer_cache
        kw = dict(q_offset=lengths, lengths=lengths + S, window=window)
        if quant:
            _paged_write_quant(lc, k, v, paged_index)
            out = prefill_attention_paged_quant(
                q, lc["k"], lc["ks"], lc["v"], lc["vs"], block_tables, **kw)
        else:
            lc["k"][paged_index] = k
            lc["v"][paged_index] = v
            out = prefill_attention_paged(q, lc["k"], lc["v"], block_tables,
                                          **kw)
    elif mode == "prefill":
        lc = layer_cache
        if quant and write_positions is not None:
            _slab_write_scatter_quant(lc, k, v, write_positions, slot_idx)
        elif quant:
            _write_kv_quant(lc, k, v, lengths, slot_idx)
        elif write_positions is not None:
            _slab_write_scatter(lc["k"], k, write_positions, slot_idx)
            _slab_write_scatter(lc["v"], v, write_positions, slot_idx)
        else:
            _write_kv(lc["k"], lc["v"], k, v, lengths, slot_idx)
        kw = dict(q_offset=lengths, lengths=lengths + S, window=window,
                  slot_idx=slot_idx)
        if quant:
            out = prefill_attention_quant(q, lc["k"], lc["ks"], lc["v"],
                                          lc["vs"], **kw)
        else:
            out = prefill_attention(q, lc["k"], lc["v"], **kw)
    elif mode == "decode" and block_tables is not None:
        assert layer_cache is not None and S == 1 and slot_idx is None
        lc = layer_cache
        scales = {}
        if quant:
            _paged_write_quant(lc, k, v, paged_index)
            scales = dict(k_scale=lc["ks"], v_scale=lc["vs"])
        else:
            lc["k"][paged_index] = k
            lc["v"][paged_index] = v
        out = decode_attention_paged(q, lc["k"], lc["v"], block_tables,
                                     lengths + 1, window=window, **scales)
    elif mode == "decode":
        assert layer_cache is not None and S == 1 and slot_idx is None
        lc = layer_cache
        wpos = lengths if write_positions is None else write_positions
        scales = {}
        if quant:
            _write_kv_quant(lc, k, v, wpos)
            scales = dict(k_scale=lc["ks"], v_scale=lc["vs"])
        else:
            _write_kv(lc["k"], lc["v"], k, v, wpos)
        out = decode_attention(q, lc["k"], lc["v"], lengths + 1,
                               window=window, **scales)
    else:
        raise ValueError(mode)
    return out.reshape(B, S, cfg.num_heads * cfg.head_dim) @ p["wo"]


def apply_ssm_mixer(p, x, cfg: ModelConfig, *, mode: str, layer_cache,
                    slot_idx=None, active=None, valid=None,
                    write_state: bool = True) -> torch.Tensor:
    """Mamba-2 mixer over x: [M, S, d].  ``layer_cache``: this layer's
    per-slot state leaves (conv_x, conv_B, conv_C [B, d_conv-1, ch]; ssd
    [B, nh, hd, N]) or None (start from a zero state, write nothing).
    Row m reads and writes slot ``slot_idx[m]`` (default: slot m), on
    both layouts.  ``active`` [M] bool (decode): lanes whose state may
    advance; the others keep theirs.  ``valid`` [M]: real tokens per row
    of a padded prefill chunk (the state fence).  ``write_state`` False:
    read the states and write none back."""
    M = x.shape[0]
    rows = None if slot_idx is None else slot_idx.long()
    if layer_cache is None:
        state = mamba2.init_ssm_state(M, cfg.d_model, cfg.ssm, x.dtype,
                                      x.device)
    else:
        state = mamba2.SSMState(**{
            k: (v[:M] if rows is None else v[rows])
            for k, v in layer_cache.items()})
    if mode == "decode":
        out, new = mamba2.apply_mamba2_step(p, x, state, cfg.ssm)
    else:
        out, new = mamba2.apply_mamba2_scan(p, x, state, cfg.ssm, valid=valid)
    if layer_cache is not None and write_state:
        for k, leaf in layer_cache.items():
            n = getattr(new, k).to(leaf.dtype)
            if active is not None:
                n = torch.where(active.reshape((M,) + (1,) * (n.dim() - 1)),
                                n, getattr(state, k))
            if rows is None:
                leaf[:M].copy_(n)
            else:
                leaf[rows] = n
    return out


def apply_layer(lp, x, cfg: ModelConfig, spec: LayerSpec, *, mode: str,
                positions, lengths, layer_cache, window: int,
                write_positions=None, slot_idx=None, block_tables=None,
                paged_index=None, active=None, ssm_valid=None,
                write_states: bool = True,
                moe_mode: str = "gmm") -> torch.Tensor:
    """Pre-norm residual block (attention or Mamba-2 mixer, then the MLP
    or MoE FFN unless the slot has none).  ``slot_idx`` names each row's
    slab cache row for attention, and each row's state slot for Mamba-2
    on both layouts (the paged attention rows go through
    ``block_tables``).  ``write_states`` False: Mamba-2 layers read their
    states and write none back.  ``moe_mode``: the MoE FFN's mode (at
    ``moe_output``'s default capacity factor and one data shard); its aux
    loss is not computed on this (serving) path."""
    h = rms_norm(x, lp["norm1"], cfg.norm_eps)
    if spec.kind == "attn":
        x = x + apply_attn_mixer(
            lp["attn"], h, cfg, mode=mode, positions=positions,
            lengths=lengths, layer_cache=layer_cache, window=window,
            write_positions=write_positions,
            slot_idx=None if block_tables is not None else slot_idx,
            block_tables=block_tables, paged_index=paged_index)
    else:
        x = x + apply_ssm_mixer(lp["ssm"], h, cfg, mode=mode,
                                layer_cache=layer_cache, slot_idx=slot_idx,
                                active=active, valid=ssm_valid,
                                write_state=write_states)
    if spec.ffn == "none":
        return x
    h = rms_norm(x, lp["norm2"], cfg.norm_eps)
    if spec.ffn == "moe":
        return x + moe_output(lp["ffn"], h, cfg.moe, cfg.act, mode=moe_mode)
    return x + apply_mlp(lp["ffn"], h, cfg.act)
