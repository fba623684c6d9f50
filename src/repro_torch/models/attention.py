"""Attention for the serving forwards.

``blocked_attention`` is the forward-only plain path (the JAX package's
XLA reference): an online softmax over KV blocks that never builds the
full [Sq, Sk] score matrix; ``blocked_attention_quant`` is the same over
an int8 cache.  The serving dispatchers go through the kernel wrappers
in ``repro_torch.kernels.ops``: the CUDA kernels on CUDA tensors, their
plain versions on CPU tensors.  ``prefill_attention`` and
``decode_attention`` read the slab cache; ``prefill_attention_paged``
and ``decode_attention_paged`` read the page arena through block tables.
An int8 cache (``quantize_kv``: int8 values with per-(position, head)
scales) goes to ``prefill_attention_quant``,
``prefill_attention_paged_quant``, and the decode dispatchers given
``k_scale``/``v_scale``.  Sliding-window decode runs in the decode
kernels on CUDA tensors (they start at ``max(0, len - window)``); on CPU
tensors it keeps the JAX package's slice-then-blocked path.

``train_attention`` is the attention of the training and cold forwards
(no cache): the ``FlashAttention`` autograd Function, whose forward is
``ops.flash_attention`` (kernel 9 on CUDA tensors) and whose backward is
a PyTorch port of the JAX package's custom-VJP backward (``_flash_bwd``,
XLA there, matmuls here: no TPU kernel to port).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import paged_gather

NEG_INF = -1e30
# keys per block of the FlashAttention backward, the JAX package's
# blocked_attention default
_BWD_BLOCK = 512


def _blocked(q, k, v, k_scale, v_scale, q_offset, lengths, causal: bool,
             window: int, block_size: int):
    """The online softmax of ``blocked_attention[_quant]``; with scales,
    each KV block is dequantised as ``f32(int8) * f32(scale)``."""
    B, Sq, H, hd = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    dev = q.device
    if q_offset is None:
        q_offset = torch.zeros((B,), dtype=torch.int32, device=dev)
    if lengths is None:
        lengths = torch.full((B,), Sk, dtype=torch.int32, device=dev)
    block = min(block_size, Sk)
    qg = (q * (1.0 / hd ** 0.5)).float().reshape(B, Sq, Hk, G, hd)
    q_pos = q_offset.long()[:, None] + torch.arange(Sq, device=dev)[None, :]
    lens = lengths.long()
    m = torch.full((B, Hk, G, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hk, G, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hk, G, Sq, hd), dtype=torch.float32, device=dev)
    for start in range(0, Sk, block):
        k_blk = k[:, start:start + block].float()
        v_blk = v[:, start:start + block].float()
        if k_scale is not None:
            k_blk = k_blk * k_scale[:, start:start + block].float()
            v_blk = v_blk * v_scale[:, start:start + block].float()
        key_pos = torch.arange(start, start + k_blk.shape[1], device=dev)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_blk)
        valid = key_pos[None, None, :] < lens[:, None, None]
        if causal:
            valid = valid & (key_pos[None, None, :] <= q_pos[:, :, None])
            if window > 0:
                valid = valid & (key_pos[None, None, :]
                                 > q_pos[:, :, None] - window)
        s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, v_blk)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]              # [B,Hk,G,Sq,hd]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)


def blocked_attention(q, k, v, *, q_offset=None, lengths=None,
                      causal: bool = True, window: int = 0,
                      block_size: int = 512):
    """q: [B, Sq, H, hd]; k/v: [B, Sk, Hk, hd]; q_offset: [B] absolute
    position of q[:, 0]; lengths: [B] valid keys -> [B, Sq, H, hd]."""
    return _blocked(q, k, v, None, None, q_offset, lengths, causal, window,
                    block_size)


def _flash_bwd(q, k, v, o, m, l, do, causal: bool, window: int):
    """The FlashAttention backward of the JAX package (``_flash_bwd``):
    from the saved q, k, v, o and the forward's row statistics m, l
    [B, H, Sq], ``D = sum(dO * O)``, then per key block the masked
    probabilities ``exp(s - m) / l`` and dv, dq, dk, all in f32.  The
    scores take q as the forward kernel does (cast to f32, then scaled),
    so m and l fit them in every type.  Returns (dq, dk, dv) in the input
    types."""
    B, Sq, H, hd = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    scale = 1.0 / hd ** 0.5
    dev = q.device
    qg = q.float().reshape(B, Sq, Hk, G, hd) * scale
    dog = do.float().reshape(B, Sq, Hk, G, hd).permute(0, 2, 3, 1, 4)
    og = o.float().reshape(B, Sq, Hk, G, hd).permute(0, 2, 3, 1, 4)
    m = m.reshape(B, Hk, G, Sq)
    l_safe = torch.clamp(l.reshape(B, Hk, G, Sq), min=1e-30)
    D = (dog * og).sum(dim=-1)                                    # [B,Hk,G,Sq]
    q_pos = torch.arange(Sq, device=dev)[:, None]
    dq = torch.zeros((B, Sq, Hk, G, hd), dtype=torch.float32, device=dev)
    dks, dvs = [], []
    for start in range(0, Sk, _BWD_BLOCK):
        k_blk = k[:, start:start + _BWD_BLOCK].float()
        v_blk = v[:, start:start + _BWD_BLOCK].float()
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_blk)
        if causal:
            k_pos = torch.arange(start, start + k_blk.shape[1],
                                 device=dev)[None]
            valid = k_pos <= q_pos
            if window > 0:
                valid = valid & (k_pos > q_pos - window)
            s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        p = torch.exp(s - m[..., None]) / l_safe[..., None]   # [B,Hk,G,Sq,k]
        dvs.append(torch.einsum("bhgqk,bhgqd->bkhd", p, dog))
        dp = torch.einsum("bhgqd,bkhd->bhgqk", dog, v_blk)
        ds = p * (dp - D[..., None])
        dq += torch.einsum("bhgqk,bkhd->bqhgd", ds, k_blk)
        dks.append(torch.einsum("bhgqk,bqhgd->bkhd", ds, qg))
    dq = (dq * scale).reshape(B, Sq, H, hd).to(q.dtype)
    # dk needs no extra scale: qg already carries 1/sqrt(hd)
    return dq, torch.cat(dks, 1).to(k.dtype), torch.cat(dvs, 1).to(v.dtype)


class FlashAttention(torch.autograd.Function):
    """Attention with a FlashAttention backward, the JAX package's
    ``_flash`` custom VJP: the forward (``ops.flash_attention``: kernel 9
    on CUDA tensors, its plain version on CPU tensors) saves q, k, v, o
    and the row statistics m, l; the backward (``_flash_bwd``) re-derives
    each key block's probabilities from them."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        o, m, l = ops.flash_attention(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, o, m, l)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, m, l = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, o, m, l, do, ctx.causal, ctx.window)
        return dq, dk, dv, None, None


def train_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Whole-sequence attention of the training and cold forwards (the
    JAX mixer's "train" mode: ``blocked_attention`` with no offsets or
    lengths). q: [B, S, H, hd]; k/v: [B, S, Hk, hd] -> [B, S, H, hd],
    differentiable through ``FlashAttention``."""
    return FlashAttention.apply(q, k, v, causal, window)


def blocked_attention_quant(q, k_q, k_s, v_q, v_s, *, q_offset=None,
                            lengths=None, causal: bool = True,
                            window: int = 0, block_size: int = 512):
    """``blocked_attention`` over an int8 cache: k_q/v_q int8
    [B, Sk, Hk, hd]; k_s/v_s per-(position, head) scales [B, Sk, Hk, 1],
    dequantised per block as the JAX package's scan does.  The plain
    path of CPU tensors (windowed int8 decode) and of the tests."""
    return _blocked(q, k_q, v_q, k_s, v_s, q_offset, lengths, causal,
                    window, block_size)


def quantize_kv(x):
    """x: [..., hd] -> (int8 values, per-(...) scale [..., 1] in x's
    type), as the JAX package: the scale ``max|x| / 127`` in f32 floored
    at 1e-8, values ``round(x / s)`` (half to even) clipped to +-127."""
    xf = x.float()
    s = torch.clamp(xf.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / s), -127, 127)
    return q.to(torch.int8), s.to(x.dtype)


def prefill_attention(q, k_cache, v_cache, *, q_offset, lengths,
                      window: int = 0, slot_idx=None):
    """Serving prefill/resume attention: a [M, Sq] query chunk against
    the resident slab cache [B, S_max] (chunk rows already written).
    ``slot_idx`` [M] names each row's cache row (None: row m)."""
    return ops.flash_prefill(q, k_cache, v_cache, q_offset.int(),
                             lengths.int(), window=window,
                             slot_idx=None if slot_idx is None
                             else slot_idx.int())


def prefill_attention_quant(q, k_q, k_s, v_q, v_s, *, q_offset, lengths,
                            window: int = 0, slot_idx=None):
    """``prefill_attention`` over an int8 slab cache: values k_q/v_q int8
    [B, S_max, Hk, hd] with scales k_s/v_s [B, S_max, Hk, 1]."""
    return ops.flash_prefill_quant(q, k_q, k_s, v_q, v_s, q_offset.int(),
                                   lengths.int(), window=window,
                                   slot_idx=None if slot_idx is None
                                   else slot_idx.int())


def decode_attention(q, k_cache, v_cache, lengths, *, window: int = 0,
                     block_size: int = 2048, k_scale=None, v_scale=None):
    """Single-token decode against the slab cache. q: [B, 1, H, hd];
    caches [B, S, Hk, hd]; lengths [B] valid keys incl. the current one.
    ``k_scale``/``v_scale`` [B, S, Hk, 1]: the cache is int8.

    With ``window > 0`` only the last ``window`` cache entries are read:
    on CUDA tensors the decode kernels start at ``max(0, len - window)``;
    on CPU tensors a per-row slice feeds the blocked plain path, as in
    the JAX package."""
    S = k_cache.shape[1]
    quant = k_scale is not None
    if 0 < window < S and not q.is_cuda:
        B = q.shape[0]
        starts = torch.clamp(lengths.long() - window, min=0)
        idx = starts[:, None] + torch.arange(window, device=q.device)[None, :]
        rows = torch.arange(B, device=q.device)[:, None]
        rel_len = lengths.long() - starts
        kw = dict(q_offset=rel_len - 1, lengths=rel_len, causal=True,
                  window=0, block_size=min(block_size, window))
        if quant:
            return blocked_attention_quant(
                q, k_cache[rows, idx], k_scale[rows, idx],
                v_cache[rows, idx], v_scale[rows, idx], **kw)
        return blocked_attention(q, k_cache[rows, idx], v_cache[rows, idx],
                                 **kw)
    if quant:
        return ops.flash_decode_quant(q, k_cache, k_scale, v_cache, v_scale,
                                      lengths.int(), window=window)
    return ops.flash_decode(q, k_cache, v_cache, lengths.int(), window=window)


def prefill_attention_paged(q, k_arena, v_arena, block_tables, *, q_offset,
                            lengths, window: int = 0):
    """Paged serving prefill/resume attention: a [M, Sq] query chunk
    against one layer's page arenas [P_phys, page, Hk, hd] through
    ``block_tables`` [M, P_max] (row m's table; chunk rows already
    written)."""
    return ops.flash_prefill_paged(q, k_arena, v_arena, q_offset.int(),
                                   lengths.int(), block_tables.int(),
                                   window=window)


def prefill_attention_paged_quant(q, k_arena, ks_arena, v_arena, vs_arena,
                                  block_tables, *, q_offset, lengths,
                                  window: int = 0):
    """``prefill_attention_paged`` over int8 arenas: values
    [P_phys, page, Hk, hd] with scale arenas [P_phys, page, Hk, 1], read
    through the same tables."""
    return ops.flash_prefill_paged_quant(q, k_arena, ks_arena, v_arena,
                                         vs_arena, q_offset.int(),
                                         lengths.int(), block_tables.int(),
                                         window=window)


def decode_attention_paged(q, k_arena, v_arena, block_tables, lengths, *,
                           window: int = 0, block_size: int = 2048,
                           k_scale=None, v_scale=None):
    """Paged single-token decode. q: [B, 1, H, hd]; arenas
    [P_phys, page, Hk, hd]; block_tables [B, P_max]; lengths [B] valid
    keys incl. the current one; ``k_scale``/``v_scale`` scale arenas
    [P_phys, page, Hk, 1]: the arenas are int8.  With ``window > 0`` the
    kernels read only the window's pages on CUDA tensors; on CPU tensors
    the pages are gathered and the slab windowed path runs on the linear
    view, which keeps every position."""
    if 0 < window < block_tables.shape[1] * k_arena.shape[1] \
            and not q.is_cuda:
        scales = {}
        if k_scale is not None:
            scales = dict(k_scale=paged_gather(k_scale, block_tables),
                          v_scale=paged_gather(v_scale, block_tables))
        return decode_attention(q, paged_gather(k_arena, block_tables),
                                paged_gather(v_arena, block_tables), lengths,
                                window=window, block_size=block_size,
                                **scales)
    if k_scale is not None:
        return ops.flash_decode_paged_quant(q, k_arena, k_scale, v_arena,
                                            v_scale, lengths.int(),
                                            block_tables.int(), window=window)
    return ops.flash_decode_paged(q, k_arena, v_arena, lengths.int(),
                                  block_tables.int(), window=window)
