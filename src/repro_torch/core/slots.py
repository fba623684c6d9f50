"""Pre-established discrete resource slots — the Green Context analogue.

Paper §III-C: ten CUDA Green Contexts reserving 10%..100% of SMs are
created *offline* because context construction is expensive; at runtime
threads are *rebound* to the nearest pre-created context ≥ the target
(<50 µs, vs milliseconds for construction).

TPU/JAX adaptation (DESIGN.md §2): the expensive offline operation is
**XLA compilation**; a "slot" is a pre-compiled executable for one point
on the discrete (decode_batch, prefill_chunk) step-shape grid, and
"rebinding" is dispatching to a different already-compiled executable.
The granularity invariant is identical: allocations are drawn from the
discrete set G = {g, 2g, ..., S} (Assumption 2), and the runtime rounds
a target reservation *up* to the nearest slot (bounded overshoot δ < g).

``SlotManager`` also measures both costs so the paper's claim structure
(construction >> rebind) can be validated on this substrate
(benchmarks/fig7_ablation.py).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple


@dataclasses.dataclass
class SlotStats:
    warmup_s: Dict[int, float] = dataclasses.field(default_factory=dict)
    rebinds: int = 0
    rebind_total_s: float = 0.0
    misses: int = 0          # dispatches that had to compile on demand

    @property
    def mean_rebind_us(self) -> float:
        return 1e6 * self.rebind_total_s / max(self.rebinds, 1)


class SlotManager:
    """Discrete slot grid {g, 2g, ..., S} with pre-established executables.

    ``builder(level)`` returns the executable for a slot level (an int in
    units of g); with ``preestablish=False`` the manager degrades to the
    paper's "No-Green" ablation: every level change constructs on demand
    inside the serving path."""

    def __init__(self, total: int, granularity: int,
                 builder: Callable[[int], Any], *,
                 preestablish: bool = True):
        assert total % granularity == 0
        self.total = total
        self.g = granularity
        self.levels = [g for g in range(granularity, total + 1, granularity)]
        self._builder = builder
        self._slots: Dict[int, Any] = {}
        self.stats = SlotStats()
        self.current_level: Optional[int] = None
        if preestablish:
            self.warmup()

    # ---- offline construction (== Green Context creation) -------------
    def warmup(self) -> None:
        for lv in self.levels:
            t0 = time.perf_counter()
            self._slots[lv] = self._builder(lv)
            self.stats.warmup_s[lv] = time.perf_counter() - t0

    # ---- runtime rebinding (== cuGreenCtx switch) ----------------------
    def quantize_up(self, target: int) -> int:
        """Round a target reservation up to the nearest slot level.
        Overshoot δ is bounded by g - 1 (Assumption 2)."""
        target = max(min(target, self.total), self.g)
        return -(-target // self.g) * self.g

    def bind(self, target: int) -> Tuple[Any, int]:
        """Return (executable, level) for the nearest slot ≥ target."""
        lv = self.quantize_up(target)
        t0 = time.perf_counter()
        if lv not in self._slots:          # No-Green path: build on demand
            self._slots[lv] = self._builder(lv)
            self.stats.misses += 1
        exe = self._slots[lv]
        dt = time.perf_counter() - t0
        if self.current_level != lv:
            self.stats.rebinds += 1
            self.stats.rebind_total_s += dt
            self.current_level = lv
        return exe, lv

    def overshoot(self, target: int) -> int:
        """δ for a given target (slot-rounding overshoot)."""
        return self.quantize_up(target) - max(min(target, self.total), self.g)

    # ---- downward binding (decode-megastep grids) ----------------------
    def quantize_down(self, target: int) -> Optional[int]:
        """Round a target *down* to the nearest slot level, or ``None``
        when the target is below the smallest slot.  Used by grids whose
        level is a hard cap (e.g. megastep token counts must not exceed
        the shortest active decode burst), where rounding up would
        overshoot a correctness bound rather than a resource one."""
        if target < self.g:
            return None
        return min(target, self.total) // self.g * self.g

    def bind_down(self, target: int) -> Optional[Tuple[Any, int]]:
        """Return (executable, level) for the nearest slot ≤ target, or
        ``None`` when no level fits.  Same miss/rebind accounting as
        ``bind``."""
        lv = self.quantize_down(target)
        if lv is None:
            return None
        t0 = time.perf_counter()
        if lv not in self._slots:          # No-Green path: build on demand
            self._slots[lv] = self._builder(lv)
            self.stats.misses += 1
        exe = self._slots[lv]
        dt = time.perf_counter() - t0
        if self.current_level != lv:
            self.stats.rebinds += 1
            self.stats.rebind_total_s += dt
            self.current_level = lv
        return exe, lv
