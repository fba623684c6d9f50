"""Dual-queue request admission (paper §III-A, Orchestration Layer).

Q_D holds decode jobs plus resume prefills within the current budget
B_prefill(t); Q_P holds cold prefills and over-budget resume prefills.
Cold prefills never enter Q_D — that is the isolation invariant the
property tests assert.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, List, Optional

from repro_torch.core.phases import Phase
from repro_torch.core.scheduler import TPOTScheduler


@dataclasses.dataclass
class Job:
    """One schedulable unit of work."""
    session_id: int
    phase: Phase
    new_len: int                 # tokens to prefill (0 for decode jobs)
    arrival_s: float = 0.0
    enqueued_cold: bool = False  # set if a resume was re-routed to Q_P


class AdmissionQueues:
    def __init__(self, scheduler: TPOTScheduler):
        self.scheduler = scheduler
        self.q_decode: Deque[Job] = collections.deque()   # Q_D
        self.q_prefill: Deque[Job] = collections.deque()  # Q_P

    def enqueue(self, job: Job) -> str:
        """Algorithm 1 lines 10-15. Returns which queue the job entered."""
        if job.phase == Phase.DECODE:
            self.q_decode.append(job)
            return "Q_D"
        if (job.phase == Phase.RESUME_PREFILL
                and self.scheduler.admit_to_decode_queue(False, job.new_len)):
            self.q_decode.append(job)
            return "Q_D"
        job.enqueued_cold = job.phase == Phase.RESUME_PREFILL
        self.q_prefill.append(job)
        return "Q_P"

    def pop_decode_batch(self, max_jobs: int) -> List[Job]:
        out = []
        while self.q_decode and len(out) < max_jobs:
            out.append(self.q_decode.popleft())
        return out

    def pop_prefill(self) -> Optional[Job]:
        return self.q_prefill.popleft() if self.q_prefill else None

    def occupancy(self):
        return len(self.q_decode), len(self.q_prefill)

    def total_occupancy(self) -> int:
        return len(self.q_decode) + len(self.q_prefill)


@dataclasses.dataclass
class WatermarkGate:
    """Hysteretic admission gate for the online gateway (DESIGN.md §6).

    Open-loop arrivals are unbounded, so the gateway sheds load instead
    of queueing forever: when occupancy (queued jobs + sessions waiting
    for a KV slot) reaches ``high`` the gate closes and submissions are
    rejected (surfaced as 429-style results); it reopens only once
    occupancy drains to ``low``.  The high/low hysteresis prevents
    reject/accept flapping right at the boundary.

    ``pressure`` tightens the gate without reconfiguring it: the
    effective high watermark drops by that amount (floored just above
    ``low`` so the hysteresis invariant holds).  The gateway raises it
    while the engine reports KV-exhaustion deferrals — shedding at the
    door is the cheapest rung of the degradation ladder (DESIGN.md
    §10) — and clears it once the pressure passes."""
    high: int
    low: int = -1                    # default: high // 2
    shedding: bool = False
    admitted: int = 0
    rejected: int = 0
    pressure: int = 0                # transient tightening (KV pressure)

    def __post_init__(self):
        if self.low < 0:
            self.low = self.high // 2
        if self.low >= self.high:
            raise ValueError(f"low watermark {self.low} must be below "
                             f"high {self.high}")

    def effective_high(self) -> int:
        return max(self.low + 1, self.high - self.pressure)

    def set_pressure(self, pressure: int) -> None:
        self.pressure = max(0, int(pressure))

    def check(self, occupancy: int) -> bool:
        """Update the shedding state for the observed occupancy and
        return whether a request would be admitted (no counting)."""
        if occupancy >= self.effective_high():
            self.shedding = True
        elif occupancy <= self.low:
            self.shedding = False
        return not self.shedding

    def offer(self, occupancy: int) -> bool:
        """check() plus admitted/rejected accounting — call once per
        actual submission decision."""
        ok = self.check(occupancy)
        if ok:
            self.admitted += 1
        else:
            self.rejected += 1
        return ok
