"""Model assembly: stacked layer groups, a Python loop over them.

The parameters are a dict that mirrors the JAX package's pytree:
``params["groups"]["l0"]`` holds every layer's weights stacked along a
leading group axis G (a dense decoder has one layer per group, so
G = num_layers), and the serving cache is ``{"l0": {"k", "v"}}`` with
leaves [G, B, S_max, Hk, hd] (slab layout) or [G, P + 1, page, Hk, hd]
(paged layout: a page arena addressed through per-slot block tables,
the last page the write scratch page).  Keys, stacked axes and weight
orientation (``x @ wq`` with wq [d, H * hd]) are the JAX package's, so
``from_jax_params`` carries its weights across one to one.  The JAX
``lax.scan`` over groups is a Python loop here, and cache writes are in
place: every forward returns the cache object it was given, updated.

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
layout (None: slab).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.blocks import apply_layer, paged_write_index
from repro_torch.models.common import dense_init, embed_init, rms_norm

# Cache leaves whose writes are positional (rows at sequence offsets
# derived from ``lengths``) rather than a recurrent state's overwrite.
POSITIONAL_CACHE_KEYS = frozenset({"k", "v", "ks", "vs"})


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.mrope or cfg.encoder_only:
        raise NotImplementedError(
            f"{cfg.name}: only dense decoders are ported "
            f"(family {cfg.family!r})")


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """Nested dict of (shape, init) per leaf: init is ("dense", fan_in),
    ("embed",) or ("ones",)."""
    _check_ported(cfg)
    G, d, hd = cfg.num_layers, cfg.d_model, cfg.head_dim
    H, Hk, ff = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff
    if cfg.act == "swiglu":
        ffn = {"w_gate": ((G, d, ff), ("dense", d)),
               "w_up": ((G, d, ff), ("dense", d)),
               "w_down": ((G, ff, d), ("dense", ff))}
    else:
        ffn = {"w_up": ((G, d, ff), ("dense", d)),
               "w_down": ((G, ff, d), ("dense", ff))}
    out = {
        "embed": ((cfg.padded_vocab, d), ("embed",)),
        "groups": {"l0": {
            "norm1": ((G, d), ("ones",)),
            "attn": {"wq": ((G, d, H * hd), ("dense", d)),
                     "wk": ((G, d, Hk * hd), ("dense", d)),
                     "wv": ((G, d, Hk * hd), ("dense", d)),
                     "wo": ((G, H * hd, d), ("dense", H * hd))},
            "norm2": ((G, d), ("ones",)),
            "ffn": ffn}},
        "final_norm": ((d,), ("ones",)),
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = ((d, cfg.padded_vocab), ("embed",))
    return out


def _map_spec(spec, fn):
    if isinstance(spec, dict):
        return {k: _map_spec(v, fn) for k, v in spec.items()}
    return fn(*spec)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.float32) -> Dict[str, Any]:
    """Random weights with the JAX package's distributions (normal x
    1/sqrt(fan_in) for dense layers, normal x 0.02 for the embedding,
    ones for the norms), drawn from ``generator`` on its own device: a
    full-width model is made directly on the card this way."""
    device = generator.device
    def make(shape, init):
        if init[0] == "ones":
            return torch.ones(shape, dtype=dtype, device=device)
        if init[0] == "embed":
            return embed_init(generator, shape, dtype, device)
        return dense_init(generator, shape, init[1], dtype, device)
    return _map_spec(param_shapes(cfg), make)


def from_jax_params(cfg: ModelConfig, tree, dtype=None,
                    device="cuda") -> Dict[str, Any]:
    """Carry a JAX parameter pytree across.  ``tree`` is the JAX pytree
    with its leaves already turned into numpy arrays by the caller; keys,
    stacked axes and orientation are kept as they are.  ``dtype`` None
    keeps each leaf's type (bfloat16 leaves arrive as float32 when numpy
    cannot hold them)."""
    def take(node, spec, path):
        if isinstance(spec, dict):
            if not isinstance(node, dict) or set(node) != set(spec):
                got = sorted(node) if isinstance(node, dict) else type(node)
                raise ValueError(f"{path or 'params'}: keys {got} != "
                                 f"{sorted(spec)}")
            return {k: take(node[k], spec[k], f"{path}/{k}") for k in spec}
        shape = spec[0]
        arr = np.asarray(node)
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"{path}: shape {arr.shape} != {shape}")
        if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
            arr = arr.astype(np.float32)
        t = torch.tensor(arr, device=device)
        return t if dtype is None else t.to(dtype)
    return take(tree, param_shapes(cfg), "")


def num_kv_pages(cfg: ModelConfig, batch: int, max_seq: int) -> int:
    """Default usable page count for the paged layout: capacity parity
    with the slab layout (``batch`` full-length stripes)."""
    return batch * (-(-max_seq // cfg.kv_page_size))


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.float32, device="cuda",
               num_pages: int = 0) -> Dict[str, Any]:
    """Serving cache {"l0": {"k", "v"}}.  Slab layout: leaves
    [G, batch, max_seq, Hk, hd].  ``cfg.kv_layout == "paged"``: leaves
    [G, num_pages + 1, page, Hk, hd], a page arena addressed through
    per-slot block tables; the extra last page is the write scratch page
    (never read).  ``num_pages`` 0 means slab-capacity parity."""
    _check_ported(cfg)
    if cfg.kv_layout == "paged":
        if max_seq % cfg.kv_page_size:
            raise ValueError(f"max_seq {max_seq} is not a multiple of the "
                             f"page size {cfg.kv_page_size}")
        num_pages = num_pages or num_kv_pages(cfg, batch, max_seq)
        shape = (cfg.num_layers, num_pages + 1, cfg.kv_page_size,
                 cfg.num_kv_heads, cfg.head_dim)
    else:
        shape = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads,
                 cfg.head_dim)
    return {"l0": {"k": torch.zeros(shape, dtype=dtype, device=device),
                   "v": torch.zeros(shape, dtype=dtype, device=device)}}


# ---------------------------------------------------------------------------
# forward core
# ---------------------------------------------------------------------------


def _layer_params(node, g: int):
    if isinstance(node, dict):
        return {k: _layer_params(v, g) for k, v in node.items()}
    return node[g]


def _run_layers(params, x, cfg: ModelConfig, *, mode: str, positions,
                lengths, cache, window: int, write_positions=None,
                slot_idx=None, block_tables=None):
    group = params["groups"]["l0"]
    layer_cache = None if cache is None else cache["l0"]
    paged_index = None
    if block_tables is not None and layer_cache is not None:
        # every layer writes the same arena rows: find them once
        pos_w = write_positions
        if pos_w is None:
            pos_w = (lengths if mode == "decode" else
                     lengths[:, None] + torch.arange(
                         x.shape[1], device=x.device,
                         dtype=lengths.dtype)[None, :])
        if mode == "decode":
            pos_w = pos_w[:, None]
        arena = layer_cache["k"]
        paged_index = paged_write_index(block_tables, pos_w, arena.shape[1],
                                        arena.shape[2])
    for g in range(cfg.num_layers):
        lc = (None if layer_cache is None else
              {"k": layer_cache["k"][g], "v": layer_cache["v"][g]})
        x = apply_layer(_layer_params(group, g), x, cfg, mode=mode,
                        positions=positions, lengths=lengths, layer_cache=lc,
                        window=window, write_positions=write_positions,
                        slot_idx=slot_idx, block_tables=block_tables,
                        paged_index=paged_index)
    return x


def _logits(params, cfg: ModelConfig, h):
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = (h @ params["embed"].T if cfg.tie_embeddings
              else h @ params["lm_head"])
    if cfg.padded_vocab != cfg.vocab_size:
        logits = logits[..., : cfg.vocab_size]
    return logits


def forward_prefill(params, cfg: ModelConfig, tokens, cache, lengths, *,
                    logit_idx=None, slot_idx=None, block_tables=None):
    """Process a chunk (cold or resume prefill), writing into ``cache``.

    tokens: [M, S] appended at per-row offsets ``lengths`` [M].
    ``logit_idx`` [M]: position within the chunk whose logits to return
    (default: the last).  ``slot_idx`` [M]: the slab cache row each chunk
    row reads and writes (default: row m).  ``block_tables`` [M, P_max]:
    the paged layout, row m's table (then ``slot_idx`` is None).
    Returns (logits [M, vocab], cache, new_lengths)."""
    x = params["embed"][tokens]
    M, S, _ = x.shape
    positions = lengths[:, None] + torch.arange(S, device=x.device,
                                                dtype=lengths.dtype)[None, :]
    h = _run_layers(params, x, cfg, mode="prefill", positions=positions,
                    lengths=lengths, cache=cache, window=cfg.sliding_window,
                    slot_idx=slot_idx, block_tables=block_tables)
    if logit_idx is None:
        h_last = h[:, -1]
    else:
        h_last = h[torch.arange(M, device=h.device), logit_idx.long()]
    return _logits(params, cfg, h_last), cache, lengths + S


def forward_decode(params, cfg: ModelConfig, tokens, cache, lengths, *,
                   write_positions=None, block_tables=None):
    """One decode step. tokens: [B] (last sampled token per sequence).
    ``write_positions`` [B] decouples where the new K/V row lands from
    the attention valid length (default: ``lengths``; negative = the
    paged scratch page).  ``block_tables`` [B, P_max]: the paged layout.
    Returns (logits [B, vocab], cache, new_lengths)."""
    x = params["embed"][tokens[:, None]]
    h = _run_layers(params, x, cfg, mode="decode", positions=lengths[:, None],
                    lengths=lengths, cache=cache, window=cfg.sliding_window,
                    write_positions=write_positions,
                    block_tables=block_tables)
    return _logits(params, cfg, h[:, 0]), cache, lengths + 1


# ---------------------------------------------------------------------------
# device-resident serving hot path
# ---------------------------------------------------------------------------


def merge_decode_cache(new_cache, old_cache, active):
    """Merge a decode step's cache updates under an active-lane mask.
    Positional (attention KV) leaves pass through: inactive lanes only
    wrote their scratch row.  Stateful leaves would be where-selected
    per lane; a dense decoder has none."""
    out = {}
    for name, layer in new_cache.items():
        if set(layer) <= POSITIONAL_CACHE_KEYS:
            out[name] = layer
            continue
        out[name] = {}
        for k, n in layer.items():
            shape = (1, n.shape[1]) + (1,) * (n.dim() - 2)
            out[name][k] = torch.where(active.reshape(shape), n,
                                       old_cache[name][k])
    return out


def _scratch_write_lengths(cache, lengths, active):
    """Redirect inactive lanes' positional writes to the cache's last
    sequence row (the scratch row; engines keep real content out of it)."""
    for layer in cache.values():
        if "k" in layer:
            return torch.where(active, lengths,
                               torch.full_like(lengths, layer["k"].shape[2] - 1))
    return lengths


def forward_decode_fused(params, cfg: ModelConfig, tokens, cache, lengths,
                         active, *, block_tables=None):
    """One decode step with greedy sampling and the length increment
    folded in, so an engine keeps ``tokens``/``lengths``/``active`` on the
    device and never syncs per token.

    tokens: [B] int32; active: [B] bool.  Returns (next_tokens [B],
    cache, new_lengths); inactive lanes keep their token and length, and
    their only cache write lands in the scratch row (slab) or scratch
    page (paged).  Attention still reads each lane's real length."""
    if block_tables is not None:
        # paged: a negative write position redirects to the scratch page
        write_positions = torch.where(active, lengths,
                                      torch.full_like(lengths, -1))
    else:
        write_positions = _scratch_write_lengths(cache, lengths, active)
    logits, new_cache, _ = forward_decode(
        params, cfg, tokens, cache, lengths, write_positions=write_positions,
        block_tables=block_tables)
    next_tokens = torch.argmax(logits, dim=-1).to(torch.int32)
    next_tokens = torch.where(active, next_tokens, tokens)
    merged = merge_decode_cache(new_cache, cache, active)
    return next_tokens, merged, lengths + active.to(lengths.dtype)


def forward_decode_megastep(params, cfg: ModelConfig, tokens, cache,
                            lengths, active, *, num_steps: int,
                            block_tables=None):
    """``num_steps`` fused decode iterations (the JAX ``lax.scan`` as a
    loop).  Returns (tokens_seq [K, B], next_tokens [B], cache,
    new_lengths); ``tokens_seq[i]`` is the token emitted by step i
    (inactive lanes repeat their input token)."""
    toks = []
    for _ in range(num_steps):
        tokens, cache, lengths = forward_decode_fused(
            params, cfg, tokens, cache, lengths, active,
            block_tables=block_tables)
        toks.append(tokens)
    return torch.stack(toks), tokens, cache, lengths


def forward_resume_batch(params, cfg: ModelConfig, tokens, cache, slot_idx,
                         lengths, logit_idx, *, block_tables=None):
    """Batched resume prefill: M jobs packed as one [M, bucket] chunk.

    tokens: [M, S]; slot_idx: [M] (distinct cache slots); lengths: [M]
    (cached tokens per slot); logit_idx: [M] (last unpadded position per
    row).  The chunk rows read and write their slots of the shared cache
    in place through ``slot_idx`` (no gather of whole slot stripes);
    under the paged layout (``block_tables`` [B, P_max]) through the M
    table rows ``block_tables[slot_idx]``.
    Returns (logits [M, vocab], cache)."""
    if block_tables is not None:
        logits, cache, _ = forward_prefill(
            params, cfg, tokens, cache, lengths, logit_idx=logit_idx,
            block_tables=block_tables[slot_idx.long()])
        return logits, cache
    logits, cache, _ = forward_prefill(
        params, cfg, tokens, cache, lengths, logit_idx=logit_idx,
        slot_idx=slot_idx)
    return logits, cache
