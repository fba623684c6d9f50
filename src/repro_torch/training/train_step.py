"""Training step: causal-LM loss + AdamW update, the JAX package's
``make_train_step`` in PyTorch.

``jax.value_and_grad`` becomes ``torch.autograd.grad`` over the parameter
tree's leaves; remat (``torch.utils.checkpoint``) recomputes each
layer's activations in the backward, and ``ce_chunk`` > 0 keeps the
[B, chunk, V] logits of one chunk alive at a time.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import forward_train
from repro_torch.models.common import tree_leaves
from repro_torch.models.model import _logits
from repro_torch.training.optimizer import (AdamWConfig, OptState,
                                            apply_updates)


def _nll(logits, targets):
    """Per-position negative log-likelihood in f32."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, targets.long()[..., None])[..., 0]


def _chunked_ce(params, cfg: ModelConfig, h, targets, mask, chunk: int):
    """CE over sequence chunks: each chunk's logits are recomputed in the
    backward (``checkpoint``), so the full [B, S, V] logits never exist."""
    B, S, _ = h.shape
    if S % chunk:
        raise ValueError(f"ce_chunk {chunk} does not divide the sequence "
                         f"length {S}")

    def body(hc, tc, mc):
        return (_nll(_logits(params, cfg, hc), tc) * mc).sum(), mc.sum()

    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        t, c = checkpoint(body, h[:, sl], targets[:, sl], mask[:, sl],
                          use_reentrant=False)
        tot, cnt = tot + t, cnt + c
    return tot / torch.clamp(cnt, min=1.0)


def lm_loss(params, cfg: ModelConfig, tokens, *, embeds=None, labels=None,
            remat: bool = True, ce_chunk: int = 0):
    """Next-token CE of a decoder: (loss, {"ce", "aux"}).  ``ce_chunk`` > 0
    takes the memory-bounded chunked CE."""
    lbl = labels if labels is not None else tokens
    if ce_chunk:
        h, aux = forward_train(params, cfg, tokens, embeds=embeds,
                               remat=remat, return_hidden=True)
        B, S, _ = h.shape
        targets = torch.cat([lbl[:, 1:], torch.zeros_like(lbl[:, :1])], 1)
        mask = torch.ones((B, S), dtype=torch.float32, device=h.device)
        mask[:, -1] = 0.0
        ce = _chunked_ce(params, cfg, h, targets, mask, min(ce_chunk, S))
        return ce, {"ce": ce, "aux": aux}
    logits, aux = forward_train(params, cfg, tokens, embeds=embeds,
                                remat=remat)
    ce = _nll(logits[:, :-1], lbl[:, 1:]).mean()
    return ce, {"ce": ce, "aux": aux}


def _grads(loss, params):
    """d loss / d every leaf of ``params``, in the tree's structure."""
    leaves = tree_leaves(params)
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    return _rebuild(params, iter([torch.zeros_like(p) if g is None else g
                                  for p, g in zip(leaves, gs)]))


def _rebuild(template, it):
    """A tree of ``template``'s structure from its leaves in order."""
    if isinstance(template, dict):
        return {k: _rebuild(template[k], it) for k in sorted(template)}
    return next(it)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                    remat: bool = True, ce_chunk: int = 0,
                    microbatches: int = 1):
    """Returns train_step(params, opt_state, batch) -> (params, opt, stats)
    with the stats of the JAX package: loss, ce, aux, grad_norm and lr.

    batch: {"tokens": [B, S]} or {"embeds": [B, S, d], "labels": [B, S]}.
    ``microbatches`` > 1 accumulates the gradients of B / microbatches
    rows at a time in f32, as JAX does.  Parameters are updated in place
    (``apply_updates``); they require grad only inside the step."""

    def loss_and_grads(params, mb):
        loss, parts = lm_loss(params, cfg, mb.get("tokens"),
                              embeds=mb.get("embeds"),
                              labels=mb.get("labels"), remat=remat,
                              ce_chunk=ce_chunk)
        return loss.detach(), {k: x.detach() for k, x in parts.items()}, \
            _grads(loss, params)

    def train_step(params, opt_state: OptState, batch: Dict[str, Any]):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            if microbatches == 1:
                loss, parts, grads = loss_and_grads(params, batch)
            else:
                n = microbatches
                rows = next(iter(batch.values())).shape[0] // n
                g_acc, loss, all_parts = None, 0.0, []
                for i in range(n):
                    mb = {k: x[i * rows:(i + 1) * rows]
                          for k, x in batch.items()}
                    l, parts, g = loss_and_grads(params, mb)
                    g_leaves = [x.float() for x in tree_leaves(g)]
                    g_acc = (g_leaves if g_acc is None else
                             [a + b for a, b in zip(g_acc, g_leaves)])
                    loss = loss + l
                    all_parts.append(parts)
                grads = _rebuild(params, iter([a / n for a in g_acc]))
                loss = loss / n
                parts = {k: torch.stack([p[k] for p in all_parts]).mean(0)
                         for k in all_parts[0]}
        finally:
            for p in leaves:
                p.requires_grad_(False)
        params, opt_state, ostats = apply_updates(opt_cfg, params, grads,
                                                  opt_state)
        return params, opt_state, {"loss": loss, **parts, **ostats}

    return train_step
