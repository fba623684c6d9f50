"""Scheduling policies: AgentServe + the paper's three baselines + the
two ablations (§IV-A Baselines, §IV-D Ablation) + the SLO-class
extension.

Every policy runs on the *same* engine machinery (same executables, same
KV pool, same workload) so measured differences come from scheduling
decisions only — the fairest single-substrate comparison we can make.
Since the plan-based refactor (DESIGN.md §9) each policy's decisions
live in one pure ``CyclePlanner`` class (``core/planner.py``), consumed
identically by the real engine and the fluid simulator; the
``PolicySpec`` here carries its tunables plus the construction-time
knobs (which executable shapes to warm, pre-establish or not).

  agentserve — phase split, resume prefills fused into the decode stream
               under B_prefill(t), cold prefills chunked into the
               prefill stream sized by the slot partition, TPOT feedback
               (Algorithm 1), pre-established slots.
  pd_static  — SGLang-style PD disaggregation: decode protected, but a
               *static* partition, and all prefills (cold and resume)
               share one prefill queue.  (== the paper's No-Alg ablation
               when derived from agentserve.)
  chunked    — vLLM-style chunked prefill + continuous batching: fixed
               chunk budget mixed with decodes every cycle, single FCFS
               prefill queue, no phase awareness, no feedback.
  fcfs       — llama.cpp-style: strict arrival order; a prefill runs to
               completion before any decode step proceeds (the
               head-of-line blocking baseline).
  no_alg     — agentserve minus Algorithm 1 (static partition).
  no_green   — agentserve minus pre-established slots: every partition
               change constructs its executable on demand *inside* the
               serving path.
  priority   — agentserve plus SLO classes (interactive vs batch):
               interactive arrivals preempt batch cold prefills at chunk
               boundaries (KV stays resident via park/unpark).  The new
               capability the planner layer exists to make cheap; not in
               ``POLICIES`` (the paper's comparison set) but in
               ``PLANNERS`` (everything servable).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.planner import (CyclePlanner, PolicySpec,
                                make_planner as _planner_from_spec)

__all__ = ["PolicySpec", "POLICIES", "PLANNERS", "make_planner",
           "AGENTSERVE", "PD_STATIC", "CHUNKED", "FCFS", "NO_ALG",
           "NO_GREEN", "PRIORITY"]


AGENTSERVE = PolicySpec(
    name="agentserve", adaptive=True, split_phases=True,
    resume_to_decode_queue=True, protect_decode=True, chunk_by_slots=True,
    cache_aware=True)

PD_STATIC = PolicySpec(
    name="pd_static", adaptive=False, split_phases=True,
    resume_to_decode_queue=False, protect_decode=True, chunk_by_slots=True,
    static_r_frac=0.5)

CHUNKED = PolicySpec(
    name="chunked", adaptive=False, split_phases=False,
    resume_to_decode_queue=False, protect_decode=True, chunk_by_slots=False,
    fixed_chunk_frac=0.5)

FCFS = PolicySpec(
    name="fcfs", adaptive=False, split_phases=False,
    resume_to_decode_queue=False, protect_decode=False, whole_prefill=True)

NO_ALG = dataclasses.replace(AGENTSERVE, name="no_alg", adaptive=False)

NO_GREEN = dataclasses.replace(AGENTSERVE, name="no_green",
                               preestablish=False)

PRIORITY = dataclasses.replace(AGENTSERVE, name="priority")

# The paper's comparison set (Fig 5/6/7).
POLICIES = {p.name: p for p in
            [AGENTSERVE, PD_STATIC, CHUNKED, FCFS, NO_ALG, NO_GREEN]}

# Everything the serving stack can run (launchers, gateway, sweeps).
PLANNERS = {**POLICIES, PRIORITY.name: PRIORITY}


def make_planner(policy) -> CyclePlanner:
    """Resolve a policy name, a ``PolicySpec``, or a ready planner
    instance (e.g. ``ReplayPlanner``) to a ``CyclePlanner``."""
    if isinstance(policy, str):
        policy = PLANNERS[policy]
    if isinstance(policy, PolicySpec):
        return _planner_from_spec(policy)
    if hasattr(policy, "plan") and hasattr(policy, "plan_control"):
        return policy
    raise TypeError(f"not a policy name, PolicySpec or planner: {policy!r}")
