"""Model assembly: stacked layer groups, a Python loop over them.

Every architecture is ``G`` repetitions of a statically described group
of ``gs`` layer slots (``group_layout``: gs = lcm(hybrid_period,
moe.every), e.g. Jamba: 9 groups x 8 slots), as in the JAX package.  The
parameters are a dict that mirrors the JAX pytree:
``params["groups"]["l{j}"]`` holds slot j's weights stacked along a
leading group axis G (a dense, MoE or pure Mamba-2 stack has one slot,
so G = num_layers).  The serving cache has the same keys: an
attention slot holds {"k", "v"} with leaves [G, B, S_max, Hk, hd] (slab
layout) or [G, P + 1, page, Hk, hd] (paged layout: a page arena
addressed through per-slot block tables, the last page the write
scratch page); a Mamba-2 slot holds per-slot states {"conv_x", "conv_B",
"conv_C", "ssd"} [G, B, ...] on both layouts.  Keys, stacked axes and
weight orientation (``x @ wq`` with wq [d, H * hd]) are the JAX
package's, so ``from_jax_params`` carries its weights across one to one.
The JAX ``lax.scan`` over groups is a Python loop here, and cache writes
are in place: every forward returns the cache object it was given,
updated.

Public entry points:
  init_params / from_jax_params   — weights (random, or from JAX numpy)
  init_cache / num_kv_pages       — the serving cache (slab or paged)
  forward_prefill                 — chunk prefill writing into a cache
  forward_decode                  — one token per sequence
  forward_decode_fused            — decode + greedy sample + length step,
                                    device-resident (no host sync)
  forward_decode_megastep         — K fused decode steps
  forward_resume_batch            — M resume prefills packed in one call

Every forward takes ``block_tables`` [B, P_max] int32 for the paged
layout (None: slab), and ``moe_mode`` for the MoE slots (the JAX
default: "gmm").
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import mamba2
from repro_torch.models.blocks import (LayerSpec, apply_layer,
                                       layer_specs_for_group,
                                       paged_write_index)
from repro_torch.models.common import dense_init, embed_init, rms_norm

# Cache leaves whose writes are positional (rows at sequence offsets
# derived from ``lengths``) rather than a recurrent state's overwrite.
POSITIONAL_CACHE_KEYS = frozenset({"k", "v", "ks", "vs"})


def _check_ported(cfg: ModelConfig) -> None:
    if (cfg.family not in ("dense", "moe", "ssm", "hybrid") or cfg.mrope
            or cfg.encoder_only):
        raise NotImplementedError(
            f"{cfg.name}: only dense, MoE, Mamba-2 and hybrid (attention + "
            f"Mamba-2, with or without MoE) decoders are ported (family "
            f"{cfg.family!r})")
    if cfg.family in ("ssm", "hybrid") and cfg.ssm is None:
        raise ValueError(f"{cfg.name}: family {cfg.family!r} needs an "
                         f"SSMConfig")


def group_layout(cfg: ModelConfig) -> Tuple[int, int, Tuple[LayerSpec, ...]]:
    """(G, group_size, specs): ``G`` repetitions of ``group_size`` slots."""
    _check_ported(cfg)
    gs = math.lcm(cfg.hybrid_period or 1, cfg.moe.every if cfg.moe else 1)
    if cfg.num_layers % gs:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers are not a "
                         f"multiple of the group size {gs}")
    return cfg.num_layers // gs, gs, layer_specs_for_group(cfg, gs)


def _layer_shapes(cfg: ModelConfig, spec: LayerSpec, G: int):
    d, hd = cfg.d_model, cfg.head_dim
    H, Hk, ff = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff
    out: Dict[str, Any] = {"norm1": ((G, d), ("ones",), False)}
    if spec.kind == "attn":
        out["attn"] = {"wq": ((G, d, H * hd), ("dense", d), False),
                       "wk": ((G, d, Hk * hd), ("dense", d), False),
                       "wv": ((G, d, Hk * hd), ("dense", d), False),
                       "wo": ((G, H * hd, d), ("dense", H * hd), False)}
    else:
        out["ssm"] = {k: ((G,) + shape, init, k in mamba2.F32_PARAMS)
                      for k, (shape, init)
                      in mamba2.mamba2_shapes(d, cfg.ssm).items()}
    if spec.ffn == "moe":
        E = cfg.moe.num_experts
        out["norm2"] = ((G, d), ("ones",), False)
        out["ffn"] = {"router": ((G, d, E), ("dense", d), False),
                      "w_up": ((G, E, d, ff), ("dense", d), False),
                      "w_down": ((G, E, ff, d), ("dense", ff), False)}
        if cfg.act == "swiglu":
            out["ffn"]["w_gate"] = ((G, E, d, ff), ("dense", d), False)
    elif spec.ffn != "none":
        out["norm2"] = ((G, d), ("ones",), False)
        if cfg.act == "swiglu":
            out["ffn"] = {"w_gate": ((G, d, ff), ("dense", d), False),
                          "w_up": ((G, d, ff), ("dense", d), False),
                          "w_down": ((G, ff, d), ("dense", ff), False)}
        else:
            out["ffn"] = {"w_up": ((G, d, ff), ("dense", d), False),
                          "w_down": ((G, ff, d), ("dense", ff), False)}
    return out


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """Nested dict of (shape, init, f32) per leaf: init is ("dense",
    fan_in), ("embed",), ("ones",), ("zeros",), ("normal", scale) or
    ("a_log",); ``f32`` marks leaves that stay float32 whatever the
    model's type (Mamba-2's dt_bias, A_log and D)."""
    G, _, specs = group_layout(cfg)
    d = cfg.d_model
    out = {
        "embed": ((cfg.padded_vocab, d), ("embed",), False),
        "groups": {f"l{j}": _layer_shapes(cfg, spec, G)
                   for j, spec in enumerate(specs)},
        "final_norm": ((d,), ("ones",), False),
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = ((d, cfg.padded_vocab), ("embed",), False)
    return out


def _map_spec(spec, fn):
    if isinstance(spec, dict):
        return {k: _map_spec(v, fn) for k, v in spec.items()}
    return fn(*spec)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.float32) -> Dict[str, Any]:
    """Random weights with the JAX package's distributions (normal x
    1/sqrt(fan_in) for dense layers, normal x 0.02 for the embedding,
    ones for the norms; Mamba-2: normal x 0.1 conv weights, zero biases,
    A_log = log U[1, 16), D = 1), drawn from ``generator`` on its own
    device: a full-width model is made directly on the card this way."""
    device = generator.device

    def make(shape, init, f32):
        dt = torch.float32 if f32 else dtype
        kind = init[0]
        if kind in ("ones", "zeros"):
            fill = torch.ones if kind == "ones" else torch.zeros
            return fill(shape, dtype=dt, device=device)
        if kind == "embed":
            return embed_init(generator, shape, dt, device)
        if kind == "dense":
            return dense_init(generator, shape, init[1], dt, device)
        if kind == "normal":
            return (torch.randn(shape, generator=generator, device=device)
                    * init[1]).to(dt)
        if kind == "a_log":
            u = torch.rand(shape, generator=generator, device=device)
            return torch.log(1.0 + 15.0 * u).to(dt)
        raise ValueError(f"unknown init {init!r}")
    return _map_spec(param_shapes(cfg), make)


def from_jax_params(cfg: ModelConfig, tree, dtype=None,
                    device="cuda") -> Dict[str, Any]:
    """Carry a JAX parameter pytree across.  ``tree`` is the JAX pytree
    with its leaves already turned into numpy arrays by the caller; keys,
    stacked axes and orientation are kept as they are.  ``dtype`` None
    keeps each leaf's type (bfloat16 leaves arrive as float32 when numpy
    cannot hold them); otherwise every leaf takes ``dtype`` except those
    that stay float32 by design (``param_shapes``)."""
    def take(node, spec, path):
        if isinstance(spec, dict):
            if not isinstance(node, dict) or set(node) != set(spec):
                got = sorted(node) if isinstance(node, dict) else type(node)
                raise ValueError(f"{path or 'params'}: keys {got} != "
                                 f"{sorted(spec)}")
            return {k: take(node[k], spec[k], f"{path}/{k}") for k in spec}
        shape, _, f32 = spec
        arr = np.asarray(node)
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"{path}: shape {arr.shape} != {shape}")
        if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
            arr = arr.astype(np.float32)
        t = torch.tensor(arr, device=device)
        if dtype is None:
            return t
        return t.to(torch.float32 if f32 else dtype)
    return take(tree, param_shapes(cfg), "")


def num_kv_pages(cfg: ModelConfig, batch: int, max_seq: int) -> int:
    """Default usable page count for the paged layout: capacity parity
    with the slab layout (``batch`` full-length stripes)."""
    return batch * (-(-max_seq // cfg.kv_page_size))


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.float32, device="cuda",
               num_pages: int = 0) -> Dict[str, Any]:
    """Serving cache, one entry per group slot ``l{j}``.  Attention
    slots, slab layout: {"k", "v"} [G, batch, max_seq, Hk, hd];
    ``cfg.kv_layout == "paged"``: [G, num_pages + 1, page, Hk, hd], a
    page arena addressed through per-slot block tables, the extra last
    page the write scratch page (never read); ``num_pages`` 0 means
    slab-capacity parity.  Mamba-2 slots, both layouts: per-slot states
    conv_x/conv_B/conv_C [G, batch, d_conv - 1, ch] in ``dtype`` and ssd
    [G, batch, nh, hd, N] in float32 (a recurrent state is a point
    summary at one length, not positional rows, so it is never paged)."""
    G, _, specs = group_layout(cfg)
    paged = cfg.kv_layout == "paged"
    if paged:
        if max_seq % cfg.kv_page_size:
            raise ValueError(f"max_seq {max_seq} is not a multiple of the "
                             f"page size {cfg.kv_page_size}")
        num_pages = num_pages or num_kv_pages(cfg, batch, max_seq)
        kv_shape = (G, num_pages + 1, cfg.kv_page_size, cfg.num_kv_heads,
                    cfg.head_dim)
    else:
        kv_shape = (G, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    cache: Dict[str, Any] = {}
    for j, spec in enumerate(specs):
        if spec.kind == "attn":
            cache[f"l{j}"] = {
                "k": torch.zeros(kv_shape, dtype=dtype, device=device),
                "v": torch.zeros(kv_shape, dtype=dtype, device=device)}
        else:
            st = mamba2.init_ssm_state(batch, cfg.d_model, cfg.ssm, dtype,
                                       "meta")
            cache[f"l{j}"] = {
                k: torch.zeros((G,) + tuple(v.shape), dtype=v.dtype,
                               device=device)
                for k, v in st._asdict().items()}
    return cache


# ---------------------------------------------------------------------------
# forward core
# ---------------------------------------------------------------------------


def _layer_params(node, g: int):
    if isinstance(node, dict):
        return {k: _layer_params(v, g) for k, v in node.items()}
    return node[g]


def _run_layers(params, x, cfg: ModelConfig, *, mode: str, positions,
                lengths, cache, window: int, write_positions=None,
                slot_idx=None, block_tables=None, active=None,
                ssm_valid=None, moe_mode: str = "gmm"):
    G, _, specs = group_layout(cfg)
    groups = params["groups"]
    paged_index = None
    arena = None if cache is None else next(
        (cache[f"l{j}"]["k"] for j, sp in enumerate(specs)
         if sp.kind == "attn"), None)
    if block_tables is not None and arena is not None:
        # every attention layer writes the same arena rows: find them once
        pos_w = write_positions
        if pos_w is None:
            pos_w = (lengths if mode == "decode" else
                     lengths[:, None] + torch.arange(
                         x.shape[1], device=x.device,
                         dtype=lengths.dtype)[None, :])
        if mode == "decode":
            pos_w = pos_w[:, None]
        paged_index = paged_write_index(block_tables, pos_w, arena.shape[1],
                                        arena.shape[2])
    for g in range(G):
        for j, spec in enumerate(specs):
            name = f"l{j}"
            lc = (None if cache is None else
                  {k: v[g] for k, v in cache[name].items()})
            x = apply_layer(_layer_params(groups[name], g), x, cfg, spec,
                            mode=mode, positions=positions, lengths=lengths,
                            layer_cache=lc, window=window,
                            write_positions=write_positions,
                            slot_idx=slot_idx, block_tables=block_tables,
                            paged_index=paged_index, active=active,
                            ssm_valid=ssm_valid, moe_mode=moe_mode)
    return x


def _logits(params, cfg: ModelConfig, h):
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = (h @ params["embed"].T if cfg.tie_embeddings
              else h @ params["lm_head"])
    if cfg.padded_vocab != cfg.vocab_size:
        logits = logits[..., : cfg.vocab_size]
    return logits


def forward_prefill(params, cfg: ModelConfig, tokens, cache, lengths, *,
                    logit_idx=None, slot_idx=None, block_tables=None,
                    moe_mode: str = "gmm"):
    """Process a chunk (cold or resume prefill), writing into ``cache``.

    tokens: [M, S] appended at per-row offsets ``lengths`` [M].
    ``logit_idx`` [M]: position within the chunk whose logits to return
    (default: the last); it marks the last real token of a padded row,
    so it also fences the Mamba-2 state against the padding.
    ``slot_idx`` [M]: the cache slot each chunk row reads and writes
    (default: row m): its slab attention rows and, on both layouts, its
    Mamba-2 states.  ``block_tables`` [M, P_max]: the paged layout, row
    m's table (the attention rows go through it).
    Returns (logits [M, vocab], cache, new_lengths)."""
    x = params["embed"][tokens]
    M, S, _ = x.shape
    positions = lengths[:, None] + torch.arange(S, device=x.device,
                                                dtype=lengths.dtype)[None, :]
    h = _run_layers(params, x, cfg, mode="prefill", positions=positions,
                    lengths=lengths, cache=cache, window=cfg.sliding_window,
                    slot_idx=slot_idx, block_tables=block_tables,
                    ssm_valid=None if logit_idx is None else logit_idx + 1,
                    moe_mode=moe_mode)
    if logit_idx is None:
        h_last = h[:, -1]
    else:
        h_last = h[torch.arange(M, device=h.device), logit_idx.long()]
    return _logits(params, cfg, h_last), cache, lengths + S


def forward_decode(params, cfg: ModelConfig, tokens, cache, lengths, *,
                   write_positions=None, block_tables=None, active=None,
                   moe_mode: str = "gmm"):
    """One decode step. tokens: [B] (last sampled token per sequence).
    ``write_positions`` [B] decouples where the new K/V row lands from
    the attention valid length (default: ``lengths``; negative = the
    paged scratch page).  ``block_tables`` [B, P_max]: the paged layout.
    ``active`` [B] bool: the lanes whose Mamba-2 states advance (default:
    every lane).  Returns (logits [B, vocab], cache, new_lengths)."""
    x = params["embed"][tokens[:, None]]
    h = _run_layers(params, x, cfg, mode="decode", positions=lengths[:, None],
                    lengths=lengths, cache=cache, window=cfg.sliding_window,
                    write_positions=write_positions,
                    block_tables=block_tables, active=active,
                    moe_mode=moe_mode)
    return _logits(params, cfg, h[:, 0]), cache, lengths + 1


# ---------------------------------------------------------------------------
# device-resident serving hot path
# ---------------------------------------------------------------------------


def _scratch_write_lengths(cache, lengths, active):
    """Redirect inactive lanes' positional writes to the cache's last
    sequence row (the scratch row; engines keep real content out of it).
    Attention-free caches need no redirect."""
    for layer in cache.values():
        if "k" in layer:
            return torch.where(active, lengths,
                               torch.full_like(lengths, layer["k"].shape[2] - 1))
    return lengths


def forward_decode_fused(params, cfg: ModelConfig, tokens, cache, lengths,
                         active, *, block_tables=None, moe_mode: str = "gmm"):
    """One decode step with greedy sampling and the length increment
    folded in, so an engine keeps ``tokens``/``lengths``/``active`` on the
    device and never syncs per token.

    tokens: [B] int32; active: [B] bool.  Returns (next_tokens [B],
    cache, new_lengths); inactive lanes keep their token and length, their
    only attention write lands in the scratch row (slab) or scratch page
    (paged), and their Mamba-2 states are written back unchanged (the
    JAX package's active-lane merge, done at the in-place write).
    Attention still reads each lane's real length."""
    if block_tables is not None:
        # paged: a negative write position redirects to the scratch page
        write_positions = torch.where(active, lengths,
                                      torch.full_like(lengths, -1))
    else:
        write_positions = _scratch_write_lengths(cache, lengths, active)
    logits, cache, _ = forward_decode(
        params, cfg, tokens, cache, lengths, write_positions=write_positions,
        block_tables=block_tables, active=active, moe_mode=moe_mode)
    next_tokens = torch.argmax(logits, dim=-1).to(torch.int32)
    next_tokens = torch.where(active, next_tokens, tokens)
    return next_tokens, cache, lengths + active.to(lengths.dtype)


def forward_decode_megastep(params, cfg: ModelConfig, tokens, cache,
                            lengths, active, *, num_steps: int,
                            block_tables=None, moe_mode: str = "gmm"):
    """``num_steps`` fused decode iterations (the JAX ``lax.scan`` as a
    loop).  Returns (tokens_seq [K, B], next_tokens [B], cache,
    new_lengths); ``tokens_seq[i]`` is the token emitted by step i
    (inactive lanes repeat their input token)."""
    toks = []
    for _ in range(num_steps):
        tokens, cache, lengths = forward_decode_fused(
            params, cfg, tokens, cache, lengths, active,
            block_tables=block_tables, moe_mode=moe_mode)
        toks.append(tokens)
    return torch.stack(toks), tokens, cache, lengths


def forward_resume_batch(params, cfg: ModelConfig, tokens, cache, slot_idx,
                         lengths, logit_idx, *, block_tables=None,
                         moe_mode: str = "gmm"):
    """Batched resume prefill: M jobs packed as one [M, bucket] chunk.

    tokens: [M, S]; slot_idx: [M] (distinct cache slots); lengths: [M]
    (cached tokens per slot); logit_idx: [M] (last unpadded position per
    row).  The chunk rows read and write their slots of the shared cache
    in place through ``slot_idx`` (no gather of whole slot stripes); the
    Mamba-2 states of those slots are gathered, advanced and scattered
    back on both layouts; under the paged layout (``block_tables``
    [B, P_max]) the attention rows go through the M table rows
    ``block_tables[slot_idx]``.
    Returns (logits [M, vocab], cache)."""
    bt = None if block_tables is None else block_tables[slot_idx.long()]
    logits, cache, _ = forward_prefill(
        params, cfg, tokens, cache, lengths, logit_idx=logit_idx,
        slot_idx=slot_idx, block_tables=bt, moe_mode=moe_mode)
    return logits, cache
