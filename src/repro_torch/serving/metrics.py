"""Serving metrics: TTFT, TPOT, throughput, session-level SLO attainment.

Definitions follow the paper §IV-A exactly:
  TTFT  — request submission -> first output token (per request: the
          cold prefill and every resume prefill each start a request).
  TPOT  — inter-token latency within decode bursts.
  throughput — aggregate output tokens / wall time.
  SLO attainment — fraction of *sessions* whose every request met the
          TTFT bound AND whose TPOT stayed within the TPOT bound
          (joint criterion; we use per-session max TTFT and p95 TPOT).
Thresholds are calibrated per model-device pair by scaling isolated
(single-session, unloaded) performance by a constant factor, as §IV-A
prescribes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serving.request import Session


def _pct(xs: Sequence[float], p: float) -> float:
    return float(np.percentile(np.asarray(xs), p)) if len(xs) else float("nan")


@dataclasses.dataclass
class SLOThresholds:
    ttft_s: float
    tpot_s: float

    @classmethod
    def from_isolated(cls, isolated_ttft_s: float, isolated_tpot_s: float,
                      factor: float = 3.0) -> "SLOThresholds":
        return cls(ttft_s=isolated_ttft_s * factor,
                   tpot_s=isolated_tpot_s * factor)


@dataclasses.dataclass
class ServingReport:
    policy: str
    num_sessions: int
    wall_time_s: float
    ttft_p50_s: float
    ttft_p95_s: float
    tpot_p50_s: float
    tpot_p95_s: float
    throughput_tok_s: float
    slo_attainment: float
    total_output_tokens: int
    extra: Dict[str, float] = dataclasses.field(default_factory=dict)
    # telemetry-overhead self-check (DESIGN.md §11): tok/s cost of
    # tracing, measured by the hotpath bench as (off - on) / off over
    # best-of-N paired runs; NaN when the run didn't measure it
    telemetry_overhead_pct: float = float("nan")
    # speculative-decode amortization (DESIGN.md §12): mean decode
    # tokens emitted per model forward pass (1.0 = plain decode)
    tokens_per_model_call: float = 1.0

    def row(self) -> str:
        return (f"{self.policy},{self.num_sessions},{self.wall_time_s:.3f},"
                f"{self.ttft_p50_s * 1e3:.1f},{self.ttft_p95_s * 1e3:.1f},"
                f"{self.tpot_p50_s * 1e3:.1f},{self.tpot_p95_s * 1e3:.1f},"
                f"{self.throughput_tok_s:.1f},{self.slo_attainment:.3f},"
                f"{self.telemetry_overhead_pct:.2f},"
                f"{self.tokens_per_model_call:.2f}")

    HEADER = ("policy,sessions,wall_s,ttft_p50_ms,ttft_p95_ms,"
              "tpot_p50_ms,tpot_p95_ms,throughput_tok_s,slo_rate,"
              "telemetry_overhead_pct,tokens_per_model_call")


def collect_ttfts(sessions: Sequence[Session]) -> List[float]:
    out = []
    for s in sessions:
        for arr, first in zip(s.request_arrivals, s.first_token_s):
            out.append(first - arr)
    return out


def collect_tpots(sessions: Sequence[Session]) -> List[float]:
    """Inter-token gaps within each contiguous decode burst."""
    out = []
    for s in sessions:
        ts = np.asarray(s.token_times_s)
        firsts = set(np.round(s.first_token_s, 9).tolist())
        gaps = np.diff(ts)
        for i, g in enumerate(gaps):
            # a gap that ends on a burst-first token spans a tool call /
            # prefill; exclude it from TPOT
            if round(float(ts[i + 1]), 9) not in firsts:
                out.append(float(g))
    return out


def session_slo_ok(s: Session, thr: SLOThresholds) -> bool:
    ttfts = [f - a for a, f in zip(s.request_arrivals, s.first_token_s)]
    if any(t > thr.ttft_s for t in ttfts):
        return False
    tpots = collect_tpots([s])
    if tpots and _pct(tpots, 95) > thr.tpot_s:
        return False
    return True


def collect_queue_delays(sessions: Sequence[Session]) -> List[float]:
    """Per-request admission wait (request ready -> admitted)."""
    out: List[float] = []
    for s in sessions:
        out.extend(s.queue_delays_s)
    return out


def collect_open_loop_ttfts(sessions: Sequence[Session]) -> List[float]:
    """Open-loop TTFT: request *ready* (arrival-process timestamp or
    tool completion) -> first token.  Differs from the closed-loop TTFT
    by the queue delay — under open-loop pressure the admission wait is
    the dominant term, and hiding it would make an overloaded server
    look healthy."""
    out = []
    for s in sessions:
        for arr, first, qd in zip(s.request_arrivals, s.first_token_s,
                                  s.queue_delays_s):
            out.append((first - arr) + qd)
    return out


@dataclasses.dataclass
class OpenLoopReport:
    """Goodput-vs-offered-rate row for the gateway benchmark.

    ``goodput_tok_s`` counts output tokens only from sessions that met
    the SLO (equal to throughput when no thresholds are given);
    ``rejected`` counts 429-style watermark shed."""
    policy: str
    offered_rps: float
    submitted: int
    completed: int
    rejected: int
    wall_time_s: float
    goodput_tok_s: float
    throughput_tok_s: float
    ttft_p50_s: float
    ttft_p95_s: float
    tpot_p50_s: float
    tpot_p95_s: float
    queue_delay_p50_s: float
    queue_delay_p95_s: float
    slo_attainment: float
    aborted: int = 0                 # fault/deadline/disconnect terminals
    # per-reason abort attribution (e.g. {"deadline": 3}) — a dict, so
    # excluded from the CSV row
    abort_reasons: Dict[str, int] = dataclasses.field(default_factory=dict)
    # telemetry-overhead self-check (see ServingReport)
    telemetry_overhead_pct: float = float("nan")
    # speculative-decode amortization (see ServingReport)
    tokens_per_model_call: float = 1.0

    def row(self) -> str:
        return (f"{self.policy},{self.offered_rps:.3f},{self.submitted},"
                f"{self.completed},{self.rejected},{self.aborted},"
                f"{self.wall_time_s:.3f},"
                f"{self.goodput_tok_s:.1f},{self.throughput_tok_s:.1f},"
                f"{self.ttft_p50_s * 1e3:.1f},{self.ttft_p95_s * 1e3:.1f},"
                f"{self.tpot_p50_s * 1e3:.1f},{self.tpot_p95_s * 1e3:.1f},"
                f"{self.queue_delay_p50_s * 1e3:.1f},"
                f"{self.queue_delay_p95_s * 1e3:.1f},"
                f"{self.slo_attainment:.3f},"
                f"{self.telemetry_overhead_pct:.2f},"
                f"{self.tokens_per_model_call:.2f}")

    HEADER = ("policy,offered_rps,submitted,completed,rejected,aborted,"
              "wall_s,goodput_tok_s,throughput_tok_s,ttft_p50_ms,"
              "ttft_p95_ms,tpot_p50_ms,tpot_p95_ms,qdelay_p50_ms,"
              "qdelay_p95_ms,slo_rate,telemetry_overhead_pct,"
              "tokens_per_model_call")


def collect_abort_reasons(sessions: Sequence[Session]) -> Dict[str, int]:
    """Per-reason histogram over aborted sessions (DESIGN.md §10) —
    the per-session ``abort_reason`` is set by ``abort_session``."""
    out: Dict[str, int] = {}
    for s in sessions:
        reason = getattr(s, "abort_reason", None)
        if reason:
            out[reason] = out.get(reason, 0) + 1
    return out


def build_open_loop_report(policy: str, sessions: Sequence[Session],
                           wall_time_s: float, offered_rps: float,
                           rejected: int = 0,
                           thresholds: Optional[SLOThresholds] = None,
                           aborted_sessions: Sequence[Session] = (),
                           ) -> OpenLoopReport:
    """Open-loop rollup over the *completed* sessions of one offered-rate
    run (rejected submissions are counted, not measured; aborted
    sessions contribute only their count and abort reason)."""
    ttfts = collect_open_loop_ttfts(sessions)
    tpots = collect_tpots(sessions)
    qdelays = collect_queue_delays(sessions)
    total_tokens = sum(s.output_tokens() for s in sessions)
    wall = max(wall_time_s, 1e-9)
    slo = float("nan")
    good_tokens = total_tokens
    if thresholds is not None and sessions:
        oks = [session_slo_ok(s, thresholds) for s in sessions]
        slo = float(np.mean(oks))
        good_tokens = sum(s.output_tokens()
                          for s, ok in zip(sessions, oks) if ok)
    return OpenLoopReport(
        policy=policy,
        offered_rps=offered_rps,
        submitted=len(sessions) + rejected + len(aborted_sessions),
        completed=len(sessions),
        rejected=rejected,
        aborted=len(aborted_sessions),
        abort_reasons=collect_abort_reasons(aborted_sessions),
        wall_time_s=wall_time_s,
        goodput_tok_s=good_tokens / wall,
        throughput_tok_s=total_tokens / wall,
        ttft_p50_s=_pct(ttfts, 50),
        ttft_p95_s=_pct(ttfts, 95),
        tpot_p50_s=_pct(tpots, 50),
        tpot_p95_s=_pct(tpots, 95),
        queue_delay_p50_s=_pct(qdelays, 50),
        queue_delay_p95_s=_pct(qdelays, 95),
        slo_attainment=slo,
    )


def build_report(policy: str, sessions: Sequence[Session],
                 wall_time_s: float,
                 thresholds: Optional[SLOThresholds] = None,
                 extra: Optional[Dict[str, float]] = None) -> ServingReport:
    ttfts = collect_ttfts(sessions)
    tpots = collect_tpots(sessions)
    total_tokens = sum(s.output_tokens() for s in sessions)
    slo = float("nan")
    if thresholds is not None:
        oks = [session_slo_ok(s, thresholds) for s in sessions]
        slo = float(np.mean(oks)) if oks else float("nan")
    return ServingReport(
        policy=policy,
        num_sessions=len(sessions),
        wall_time_s=wall_time_s,
        ttft_p50_s=_pct(ttfts, 50),
        ttft_p95_s=_pct(ttfts, 95),
        tpot_p50_s=_pct(tpots, 50),
        tpot_p95_s=_pct(tpots, 95),
        throughput_tok_s=total_tokens / max(wall_time_s, 1e-9),
        slo_attainment=slo,
        total_output_tokens=total_tokens,
        extra=extra or {},
    )
