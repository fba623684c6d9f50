"""TPOT-driven resource scheduling — Algorithm 1, faithfully.

The controller regulates two variables each control interval Δt:

* ``B_prefill(t)`` — the resume-prefill token budget: the maximum resume
  prefill length admitted into the decode queue/stream.
* ``R_min(t)``     — the minimum resource reservation for decode.  On
  GPU this is SMs; in the TPU/JAX adaptation it is the decode share of
  the per-step token budget, quantised to the pre-established slot grid
  (DESIGN.md §2).

Control law (paper Algorithm 1, lines 4-9):

    TPOT_step = ΔL_decode / ΔK_decode
    if TPOT_step > θ_high:   B -= Δ_B (floor B_min);  R += Δ_R (cap S)
    elif TPOT_step < θ_low:  B += Δ_B (cap B_max);    R -= Δ_R (floor R_base)

The scheduler is deliberately mechanism-agnostic: it emits integer
resource units in [0, S]; the execution layer (slots.py / engine.py)
decides what a unit means.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple


@dataclasses.dataclass
class SchedulerConfig:
    total_resources: int = 100      # S: total resource units on the device
    r_base: int = 10                # floor of the decode reservation
    r_init: int = 30
    delta_r: int = 10               # Δ_R: reservation step (= slot granularity g)
    b_min: int = 16                 # resume budget floor (tokens)
    b_max: int = 1024               # resume budget cap
    b_init: int = 256
    delta_b: int = 64               # Δ_B: budget step
    theta_low_ms: float = 0.0       # θ_low; 0 => derive from SLO
    theta_high_ms: float = 0.0      # θ_high; 0 => derive from SLO
    tpot_slo_ms: float = 50.0       # τ_max for deriving thresholds
    control_interval_s: float = 0.25  # Δt

    def __post_init__(self):
        if self.theta_high_ms <= 0:
            self.theta_high_ms = 0.9 * self.tpot_slo_ms
        if self.theta_low_ms <= 0:
            self.theta_low_ms = 0.5 * self.tpot_slo_ms


@dataclasses.dataclass
class ControlState:
    b_prefill: int
    r_min: int
    tpot_step_ms: float = 0.0
    mode: str = "hold"              # protect | relax | hold


class TPOTScheduler:
    """Feedback controller over (B_prefill, R_min). One instance per engine."""

    def __init__(self, cfg: SchedulerConfig):
        self.cfg = cfg
        self.state = ControlState(b_prefill=cfg.b_init, r_min=cfg.r_init)
        # interval accumulators (ΔL_decode, ΔK_decode)
        self._decode_time_s = 0.0
        self._decode_steps = 0
        self.history: List[ControlState] = []

    # ---- measurement (Algorithm 1 lines 2-3) --------------------------
    def record_decode_step(self, elapsed_s: float, steps: int = 1) -> None:
        self._decode_time_s += elapsed_s
        self._decode_steps += steps

    # ---- control update (Algorithm 1 lines 4-9) -----------------------
    def update(self) -> ControlState:
        c, s = self.cfg, self.state
        if self._decode_steps > 0:
            tpot_ms = 1000.0 * self._decode_time_s / self._decode_steps
            s.tpot_step_ms = tpot_ms
            if tpot_ms > c.theta_high_ms:           # protection mode
                s.b_prefill = max(c.b_min, s.b_prefill - c.delta_b)
                s.r_min = min(c.total_resources, s.r_min + c.delta_r)
                s.mode = "protect"
            elif tpot_ms < c.theta_low_ms:          # relaxation mode
                s.b_prefill = min(c.b_max, s.b_prefill + c.delta_b)
                s.r_min = max(c.r_base, s.r_min - c.delta_r)
                s.mode = "relax"
            else:
                s.mode = "hold"
        self._decode_time_s = 0.0
        self._decode_steps = 0
        self.history.append(dataclasses.replace(s))
        return s

    # ---- partition (Algorithm 1 line 16) ------------------------------
    def partition(self) -> Tuple[int, int]:
        """(S_decode, S_prefill) = (R_min, S - R_min)."""
        return self.state.r_min, self.cfg.total_resources - self.state.r_min

    # ---- admission test (Algorithm 1 lines 10-15) ----------------------
    def admit_to_decode_queue(self, is_decode: bool, new_len: int) -> bool:
        return is_decode or new_len <= self.state.b_prefill
