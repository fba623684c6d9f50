"""Mixture-of-Experts layer (Mixtral / OLMoE / Jamba), the counterpart of
the JAX package's ``repro.models.moe``.

Two execution paths, selected by ``mode``:

* ``"gmm"``   — stable sort by expert + capacity-bounded scatter into
                per-expert rows [E, C, d], the grouped matmul, and the
                weighted combine back to tokens.  Every token of the call
                competes for capacity, so rows of one call are coupled
                (padding and inactive lanes route too, as in JAX).
* ``"dense"`` — every expert computes every token (the [T, d] tokens as
                an expert-stride-0 view [E, T, d]), outputs combined with
                the router weights zeroed outside the top-k.  Rows are
                independent.

Both run the expert FFN through ``kernels.ops.moe_gmm`` (the CUDA kernel
on CUDA tensors), where the JAX model runs the same product as an XLA
einsum.  Router: f32 softmax over the expert logits, top-k (ties to the
lower index, as ``lax.top_k``), weights renormalised over the selected
experts.  ``apply_moe`` also returns the Switch-style load-balance loss;
the serving path calls ``moe_output``, which skips it.  The mesh path
(``_gmm_shard_map``) is not ported.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.kernels import ops

MODES = ("gmm", "dense")


def _expert_ffn(params, h, act: str = "swiglu"):
    """h: [E, C, d] -> [E, C, d] through each expert's FFN."""
    up = ops.moe_gmm(h, params["w_up"])
    if act == "swiglu":
        mid = F.silu(ops.moe_gmm(h, params["w_gate"])) * up
    else:
        # jax.nn.gelu defaults to the tanh approximation
        mid = F.gelu(up, approximate="tanh")
    return ops.moe_gmm(mid, params["w_down"])


def _router(params, x2d, moe: MoEConfig):
    """(probs [T, E] f32, weights [T, k] f32, idx [T, k] int64)."""
    logits = (x2d @ params["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort keeps equal probabilities in expert order,
    # which is lax.top_k's tie rule (torch.topk promises no order)
    weights, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, idx = weights[:, :moe.top_k], idx[:, :moe.top_k]
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    return probs, weights, idx


def _aux_loss(probs, idx, moe: MoEConfig):
    """Switch-transformer load-balance loss: E * sum_e f_e * P_e."""
    E = moe.num_experts
    hits = F.one_hot(idx, E).float().sum(1)                     # [T, E]
    f = hits.mean(0) / moe.top_k
    P = probs.mean(0)
    return E * torch.sum(f * P)


def _gmm_dispatch_one(params, x2d, weights, idx, *, moe: MoEConfig,
                      act: str, C: int):
    """Capacity-bounded sort/scatter grouped matmul for one token shard.
    x2d: [T, d]; weights/idx: [T, k].  An expert's rows past ``C`` are
    dropped (they write the overflow row ``E * C`` and contribute 0)."""
    T, d = x2d.shape
    k, E = moe.top_k, moe.num_experts
    dev = x2d.device
    e_flat = idx.reshape(-1)                                     # [T*k]
    t_flat = torch.arange(T, device=dev).repeat_interleave(k)
    w_flat = weights.reshape(-1)

    order = torch.argsort(e_flat, stable=True)
    se, st, sw = e_flat[order], t_flat[order], w_flat[order]
    counts = torch.bincount(e_flat, minlength=E)                 # [E]
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(T * k, device=dev) - starts[se]
    dropped = pos_in_e >= C
    slot = torch.where(dropped, E * C, se * C + pos_in_e)       # overflow row

    buf = torch.zeros((E * C + 1, d), dtype=x2d.dtype, device=dev)
    buf[slot] = x2d[st]
    h = _expert_ffn(params, buf[:E * C].reshape(E, C, d), act)
    h = h.reshape(E * C, d)
    contrib = torch.where(dropped[:, None], 0.0,
                          h[torch.where(dropped, 0, slot)] * sw[:, None]
                          ).to(x2d.dtype)
    # the combine: JAX's .at[st].add sums each token's k contributions in
    # x's type in sorted (ascending expert) order; the same order here,
    # as k gathered adds (a scatter-add would sum in no fixed order on
    # CUDA, and streams would change from run to run)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * k, device=dev)
    pos = torch.sort(inv.reshape(T, k), dim=1).values            # [T, k]
    parts = contrib[pos]                                         # [T, k, d]
    out = parts[:, 0]
    for j in range(1, k):
        out = out + parts[:, j]
    return out


def moe_output(params, x, moe: MoEConfig, act: str, *, mode: str = "gmm",
               capacity_factor: float = 1.25,
               data_shards: int = 1) -> torch.Tensor:
    """x: [B, S, d] -> [B, S, d], the MoE FFN without the aux loss."""
    return _moe(params, x, moe, act, mode, capacity_factor, data_shards)[0]


def apply_moe(params, x, moe: MoEConfig, act: str, *, mode: str = "gmm",
              capacity_factor: float = 1.25,
              data_shards: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (out [B, S, d], aux_loss scalar).

    ``data_shards``: number of data-parallel shards of the token stream;
    the gmm dispatch runs independently per shard (its own sort and
    capacity), as in JAX when T divides evenly."""
    out, probs, idx = _moe(params, x, moe, act, mode, capacity_factor,
                           data_shards)
    return out, _aux_loss(probs, idx, moe)


def _moe(params, x, moe: MoEConfig, act: str, mode: str,
         capacity_factor: float, data_shards: int):
    if mode not in MODES:
        raise ValueError(f"moe mode {mode!r} not in {MODES}")
    B, S, d = x.shape
    T = B * S
    x2d = x.reshape(T, d)
    probs, weights, idx = _router(params, x2d, moe)
    k, E = moe.top_k, moe.num_experts

    if mode == "dense":
        comb = torch.zeros((T, E), dtype=torch.float32, device=x.device)
        comb.scatter_(1, idx, weights)             # zero outside the top-k
        outs = _expert_ffn(params, x2d.expand(E, T, d), act)    # [E, T, d]
        out = torch.einsum("te,etd->td", comb.to(x.dtype), outs)
        return out.reshape(B, S, d), probs, idx

    R = data_shards if T % data_shards == 0 else 1
    T_loc = T // R
    C = int(max(1, -(-T_loc * k // E) * capacity_factor))
    out = torch.cat([
        _gmm_dispatch_one(params, x2d[r * T_loc:(r + 1) * T_loc],
                          weights[r * T_loc:(r + 1) * T_loc],
                          idx[r * T_loc:(r + 1) * T_loc], moe=moe, act=act,
                          C=C)
        for r in range(R)])
    return out.reshape(B, S, d), probs, idx
