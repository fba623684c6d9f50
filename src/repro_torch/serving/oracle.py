"""Turn-by-turn greedy reference decode: the engine's identity oracle.

Greedy decoding is scheduling-independent: whatever order the engine
interleaves prefill chunks and decode steps across sessions, each
session's token stream must equal the stream produced by running that
session *alone* — whole-prompt prefill, then one greedy decode step per
token.  ``oracle_streams`` computes exactly that with the engine's own
hot-path forwards, each session in a fresh slab pool (the KV layout does
not change a stream, so a paged config is served on the slab here).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from repro_torch.serving.engine import get_executables, resolve_device
from repro_torch.serving.kvcache import KVCachePool


def oracle_streams(cfg, params, sessions, *, num_slots: int, max_seq: int,
                   dtype=torch.float32, device="cuda") -> Dict[int, List[int]]:
    """{session_id: [token ids]} for each session decoded in isolation
    in slot 0 of its own pool."""
    dev = resolve_device(device)
    cfg = dataclasses.replace(cfg, kv_layout="slab")
    ex = get_executables(cfg)
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32, device=dev)
    out = {}
    for s in sessions:
        pool = KVCachePool(cfg, num_slots, max_seq, dtype, dev)
        stream = []
        length = 0
        for turn in s.turns:
            pt = torch.tensor(np.asarray(turn.prefill_tokens, np.int32)[None],
                              device=dev)
            logits, pool.cache = ex.prefill(
                params, pool.cache, pt, i32(0), i32(length),
                i32(pt.shape[1] - 1))
            length += pt.shape[1]
            tok = int(logits.float().argmax())
            stream.append(tok)
            for _ in range(turn.decode_len - 1):
                tvec = torch.zeros((num_slots,), dtype=torch.int32, device=dev)
                lvec = torch.zeros((num_slots,), dtype=torch.int32, device=dev)
                tvec[0], lvec[0] = tok, length
                logits2, pool.cache = ex.decode(params, pool.cache, tvec, lvec)
                length += 1
                tok = int(logits2[0].float().argmax())
                stream.append(tok)
        out[s.session_id] = stream
    return out
