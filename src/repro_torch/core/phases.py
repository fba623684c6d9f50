"""Phase-aware request taxonomy (paper §II, Fig 1).

Agent traffic decomposes into three phases with very different resource
profiles:

* ``COLD_PREFILL``   — long uncached system prompt (2.5k-3.5k tokens);
                       compute-heavy, the head-of-line-blocking source.
* ``RESUME_PREFILL`` — tool output / steering text appended to a cached
                       context (30-421 tokens); short, frequent.
* ``DECODE``         — structured-output generation (27-141 tokens);
                       lightweight per token, latency-critical.

``classify`` implements the Request Manager's decision (paper §III-A):
a request whose prefix is cached beyond a threshold fraction is a resume
prefill; otherwise it is cold.  Decode is a state, not an arrival — a
sequence enters DECODE after its prefill completes.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class Phase(enum.Enum):
    COLD_PREFILL = "cold_prefill"
    RESUME_PREFILL = "resume_prefill"
    DECODE = "decode"


@dataclasses.dataclass
class PhaseThresholds:
    """Classification knobs.

    ``min_cached_fraction``: how much of the request's prefix must be
    KV-cached for it to count as a resume (cache-extension) prefill.
    ``resume_max_new``: resume prefills longer than this are *re-routed
    to the cold queue* regardless of cache state (paper §III-A: "unless
    they exceed a predefined token budget")."""
    min_cached_fraction: float = 0.5
    resume_max_new: int = 1024


def classify(total_len: int, cached_len: int, new_len: int,
             thresholds: Optional[PhaseThresholds] = None) -> Phase:
    """Classify an incoming *prefill* request.

    total_len: prompt length including cached prefix; cached_len: tokens
    already in the KV cache for this session; new_len: tokens that still
    need prefilling (total_len - cached_len)."""
    t = thresholds or PhaseThresholds()
    if new_len <= 0:
        return Phase.DECODE
    if cached_len > 0 and cached_len / max(total_len, 1) >= t.min_cached_fraction \
            and new_len <= t.resume_max_new:
        return Phase.RESUME_PREFILL
    return Phase.COLD_PREFILL
