"""The AgentServe single-engine serving loop (slab or paged KV layout).

Execution model: the engine advances in *cycles*.  Each cycle runs at
most one batched decode step (all active sequences — continuous
batching) and an amount of prefill work bounded by the current slot
partition: the decode reservation R(t) of the cycle token budget C
protects decode cadence, and the complement (C - R) is the cold-prefill
chunk processed that cycle.  Resume prefills within B_prefill(t) are
fused into the decode stream (Q_D); cold prefills only ever run from the
prefill stream (Q_P) — the isolation invariant.

Plan -> execute: the engine makes **no scheduling decisions**.  Each
``step()`` asks its ``CyclePlanner`` (a pure strategy over an immutable
``EngineView``, ``core/planner.py``) for a declarative ``CyclePlan``; the
``Dispatcher`` carries the plan out against the hot-path forwards and
the KV pool.  Every executed plan is journaled.

TPOT is measured as the gap between consecutive decode-step completions
— the inter-emission gap the user experiences.

Device-resident hot path: the decode stream never syncs per token.
Greedy sampling and the length increment are folded into one fused step
(``forward_decode_fused``), so ``last_token``/``lengths``/``active`` live
on the device between steps; each step's tokens are copied to host
memory asynchronously behind a CUDA event, and the host only waits at
*flush points* (control-interval boundaries, burst completions and every
``telemetry_sample_steps`` steps).  When both queues are empty and no
control update is due, up to K decode iterations run as one *megastep*
drawn from a pre-established grid, or, with ``spec_k``, one
draft-and-verify step (``forward_spec_step``) scores up to K drafted
tokens per lane in one forward; its host mirrors advance only at the
flush, when the accept counts are read.  Resume prefills from Q_D are packed
M-at-a-time into one [M, bucket] batched call that reads and writes the
shared cache in place through per-row slot indices.

Paged layout (``ModelConfig.kv_layout == "paged"``): every executable
takes the pool's device block tables as a trailing argument, and every
dispatch that writes K/V first calls the pool's ``prepare_append`` (map
missing pages, copy shared ones); a ``KVExhausted`` there defers the op
to the next cycle.

What replaces the JAX mechanics: the hot-path "executables" are plain
closures over in-place cache writes (PyTorch runs eagerly; there is no
compile step, so the slot grid's pre-establishment only warms each shape
once at construction); ``block_until_ready`` becomes a CUDA event wait or
``torch.cuda.synchronize``; double-buffered dispatch (``overlap_dispatch``)
is on by default when the device is CUDA.

Reactor surface: ``attach`` registers a session, ``step()`` runs exactly
one cycle and returns the ``TokenEvent``s it emitted, and the closed-loop
``run()`` is attach-all + step-until-done.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.admission import AdmissionQueues, Job
from repro_torch.core.phases import Phase, PhaseThresholds
from repro_torch.core.planner import (SPEC_EMA_RECOVERY, Admission,
                                      ColdOp, CyclePlan, CyclePlanner,
                                      CycleRecord, EngineView, JobView,
                                      PlanJournal, ResumePlan, SessionView)
from repro_torch.core.scheduler import SchedulerConfig, TPOTScheduler
from repro_torch.core.slots import SlotManager
from repro_torch.models import (forward_decode, forward_decode_fused,
                                forward_decode_megastep, forward_prefill,
                                forward_resume_batch, forward_spec_step)
from repro_torch.serving.faults import SessionFault
from repro_torch.serving.kvcache import KVExhausted, make_pool
from repro_torch.serving.metrics import (ServingReport, SLOThresholds,
                                         build_report)
from repro_torch.serving.policies import PolicySpec, make_planner
from repro_torch.serving.reactor import TokenEvent
from repro_torch.serving.request import Session, SessionState
from repro_torch.serving.telemetry import RegistryDict, Telemetry


@dataclasses.dataclass
class EngineConfig:
    num_slots: int = 8
    max_seq: int = 1024
    cycle_budget: int = 320          # C: tokens of work per cycle
    granularity: int = 32            # g: slot granularity (C/g = 10 slots)
    moe_mode: str = "dense"          # MoE FFN path of every executable:
    #                                  "dense" keeps lanes independent;
    #                                  "gmm" couples a call's rows through
    #                                  the expert capacity
    control_interval_s: float = 0.25
    tpot_slo_ms: float = 50.0
    b_min: int = 32
    b_max: int = 512
    b_init: int = 128
    delta_b: int = 32
    max_wall_s: float = 300.0
    # --- device-resident hot path --------------------------------------
    megastep_max: int = 8            # K cap for fused decode megasteps
    megastep_unit: int = 2           # megastep grid granularity (≥2)
    # --- speculative decode ---------------------------------------------
    spec_k: int = 0                  # draft-and-verify width cap: one
    #                                  verify forward scores up to K
    #                                  tokens per lane (0 = off)
    overlap_dispatch: Optional[bool] = None  # double-buffer plain decode
    #                                  windows: dispatch the next step
    #                                  before waiting on the previous
    #                                  window's tokens.  None = auto: on
    #                                  when the device is CUDA, off on
    #                                  the CPU (synchronous there)
    resume_batch_max: int = 4        # M cap for batched resume prefill
    telemetry_sample_steps: int = 32  # decode flush cadence (host sync)
    # --- cache-aware prefill hot path -----------------------------------
    cold_batch_max: int = 4          # M cap for packed cold prefills
    autotune_chunks: bool = True     # measure chunk tok/s at slot warmup
    prefill_tile: int = 128          # KV tile of the tile-skip estimate
    # --- paged KV pool ----------------------------------------------------
    kv_pages: int = 0                # paged layout: usable page count
    #                                  (0 = slab-capacity parity:
    #                                  num_slots * max_seq / page_size)
    prefix_cache: str = "radix"      # paged prefix index: "radix"
    #                                  (longest-match trie over token ids;
    #                                  partial hits restore by block-table
    #                                  surgery) | "exact" (whole-key store)
    # --- online reactor ---------------------------------------------------
    trace_max: int = 200_000         # per-cycle telemetry cap
    record_events: bool = False      # run(): keep TokenEvents in
    #                                  engine.event_log
    journal_max: int = 200_000       # executed CyclePlans kept
    kv_defer_limit: int = 8          # per-session KVExhausted deferrals
    #                                  tolerated before the session aborts
    telemetry: bool = True           # span tracing + latency histograms
    spans_max: int = 200_000         # completed-span ring capacity


def _resume_buckets(cfg: EngineConfig) -> List[int]:
    out, b = [], cfg.granularity
    while b < cfg.b_max:
        out.append(b)
        b *= 2
    out.append(cfg.b_max)
    return out


@dataclasses.dataclass
class HotPathExecutables:
    """The hot-path forwards bound to one model config.  Each writes the
    pool cache in place and returns it; callers keep the returned
    reference (it is the same object).  Under the paged layout each takes
    the device block tables [num_slots, P_max] as a trailing argument."""
    decode: Callable       # per-step decode returning logits
    prefill: Callable      # batch-1 chunk prefill into one slot
    fused: Callable        # device-resident decode step
    resume: Callable       # batched resume prefill
    megastep: Callable[[int], Callable]   # K -> K fused decode steps
    spec: Callable[[int], Callable]       # K -> draft-and-verify


def get_executables(mcfg: ModelConfig, moe_mode: str) -> HotPathExecutables:
    # ``*bt``: the paged layout's block tables (absent for the slab)
    def decode_step(params, cache, tokens, lengths, *bt):
        logits, cache, _ = forward_decode(params, mcfg, tokens, cache, lengths,
                                          block_tables=bt[0] if bt else None,
                                          moe_mode=moe_mode)
        return logits, cache

    def prefill_step(params, cache, tokens, slot, length, logit_idx, *bt):
        # slot/length/logit_idx: [1] int32 device tensors; the slot names
        # the row's slab rows and its recurrent states on both layouts
        logits, cache, _ = forward_prefill(
            params, mcfg, tokens, cache, length, logit_idx=logit_idx,
            slot_idx=slot, block_tables=bt[0][slot.long()] if bt else None,
            moe_mode=moe_mode)
        return logits[0], cache

    def fused_step(params, cache, tokens, lengths, active, *bt):
        return forward_decode_fused(params, mcfg, tokens, cache, lengths,
                                    active, block_tables=bt[0] if bt else None,
                                    moe_mode=moe_mode)

    def megastep(num_steps: int) -> Callable:
        def mega_step(params, cache, tokens, lengths, active, *bt):
            return forward_decode_megastep(
                params, mcfg, tokens, cache, lengths, active,
                num_steps=num_steps, block_tables=bt[0] if bt else None,
                moe_mode=moe_mode)
        return mega_step

    def resume_step(params, cache, tokens, slots, lengths, logit_idx, *bt):
        return forward_resume_batch(params, mcfg, tokens, cache, slots,
                                    lengths, logit_idx,
                                    block_tables=bt[0] if bt else None,
                                    moe_mode=moe_mode)

    def spec(num_draft: int) -> Callable:
        def spec_step(params, cache, history, tokens, lengths, active, *bt):
            return forward_spec_step(
                params, mcfg, history, tokens, cache, lengths, active,
                num_draft=num_draft,
                block_tables=bt[0] if bt else None, moe_mode=moe_mode)
        return spec_step

    return HotPathExecutables(decode=decode_step, prefill=prefill_step,
                              fused=fused_step, resume=resume_step,
                              megastep=megastep, spec=spec)


def resolve_device(device) -> torch.device:
    """The engine's device.  CUDA must be present when asked for; the
    CPU is used only when the caller names it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA requested but torch.cuda.is_available() is "
                           "False; pass device='cpu' to run on the CPU")
    return dev


def _plan_kind(plan: CyclePlan) -> str:
    """Dispatch-kind label for the cycle span: the streams the plan
    touches, joined (a fused cycle reads e.g. "mega+resume")."""
    parts = []
    if plan.decode is not None:
        if plan.decode.spec_k > 0:
            parts.append("spec")
        else:
            parts.append("mega" if plan.decode.megastep_target > 0
                         else "decode")
    if plan.resume is not None:
        parts.append("resume")
    if plan.prefill:
        parts.append("prefill")
    if plan.admissions and not parts:
        parts.append("admit")
    return "+".join(parts) or "idle"


def _planned_tokens(plan: CyclePlan) -> int:
    """Token volume the plan *intended* (compared with the dispatch
    counters in the cycle span)."""
    total = 0
    if plan.decode is not None:
        total += max(1, plan.decode.megastep_target,
                     plan.decode.spec_k) * len(plan.decode.session_ids)
    if plan.resume is not None:
        total += plan.resume.bucket * len(plan.resume.session_ids)
    for op in plan.prefill:
        if op.kind == "pack":
            total += op.shape * len(op.session_ids)
        else:
            total += op.shape * op.reps
    return total


@dataclasses.dataclass
class CycleOutcome:
    """What one dispatched cycle observably did (telemetry feed)."""
    did_work: bool = False
    q_d: int = 0
    q_p: int = 0
    q_p_cold: int = 0                # cold-phase jobs in Q_P
    q_p_resume: int = 0              # over-budget resumes re-routed to Q_P
    active: int = 0


class Dispatcher:
    """Carries a ``CyclePlan`` out against the engine's hot-path forwards
    and KV pool — all mechanism, no decisions.  The only choices made
    here are *safety clamps* (burst/capacity bounds on the megastep K,
    free-slot checks) that keep a diverged plan from corrupting state."""

    def __init__(self, engine: "ServingEngine"):
        self.eng = engine

    def execute(self, plan: CyclePlan, now: float) -> CycleOutcome:
        eng = self.eng
        out = CycleOutcome()
        for sid in plan.preempt:
            eng._preempt_prefill(sid)
        for adm in plan.admissions:
            eng._exec_admission(adm, now)
        out.q_d, out.q_p = eng.queues.occupancy()
        out.q_p_cold = sum(1 for j in eng.queues.q_prefill
                           if j.phase == Phase.COLD_PREFILL)
        out.q_p_resume = out.q_p - out.q_p_cold
        out.active = sum(1 for s in eng._sessions.values()
                         if s.state == SessionState.DECODING)
        slot_exec = None
        if plan.slot_level > 0:
            slot_exec, _ = eng.slots.bind(plan.slot_level)

        # ---- decode stream ----------------------------------------
        if plan.decode is not None:
            active = [eng._sessions[sid] for sid in plan.decode.session_ids
                      if sid in eng._sessions
                      and eng._sessions[sid].state == SessionState.DECODING]
            if active:
                eng._decode_dispatch(active, plan.decode.megastep_target,
                                     plan.decode.spec_k)
                out.did_work = True
        elif plan.flush_idle:
            eng._flush_decode()
            eng._window_t0 = None

        # ---- resume prefills fused into the decode stream --------
        if plan.resume is not None:
            out.did_work |= eng._exec_resume(plan.resume)

        # ---- prefill stream (cold / over-budget / phase-blind) ----
        eng._drop_stale_prefill_heads()
        for op in plan.prefill:
            if op.reclaim and any(
                    s.state == SessionState.DECODING
                    for s in eng._sessions.values()):
                break                # decode demand appeared mid-cycle
            out.did_work |= eng._exec_cold_op(op, slot_exec)

        for sid in plan.unsuspend:
            eng._unsuspend_prefill(sid, now)
        return out


class ServingEngine:
    def __init__(self, model_cfg: ModelConfig, params, policy,
                 engine_cfg: Optional[EngineConfig] = None,
                 dtype=torch.float32, device="cuda"):
        self.mcfg = model_cfg
        self.params = params
        self.device = resolve_device(device)
        # ``policy`` may be a PolicySpec, a policy name, or a ready
        # CyclePlanner instance.  The spec remains the construction-time
        # config: which shapes to warm, pre-establish or not.
        self.planner: CyclePlanner = make_planner(policy)
        self.policy: PolicySpec = self.planner.spec
        policy = self.policy
        self.ecfg = engine_cfg or EngineConfig()
        self._paged = model_cfg.kv_layout == "paged"
        self.pool = make_pool(model_cfg, self.ecfg.num_slots,
                              self.ecfg.max_seq, dtype, self.device,
                              num_pages=self.ecfg.kv_pages,
                              prefix_cache=self.ecfg.prefix_cache)
        C, g = self.ecfg.cycle_budget, self.ecfg.granularity
        self.scheduler = TPOTScheduler(SchedulerConfig(
            total_resources=C, r_base=g, r_init=2 * g, delta_r=g,
            b_min=self.ecfg.b_min, b_max=self.ecfg.b_max,
            b_init=self.ecfg.b_init, delta_b=self.ecfg.delta_b,
            tpot_slo_ms=self.ecfg.tpot_slo_ms,
            control_interval_s=self.ecfg.control_interval_s))
        self.queues = AdmissionQueues(self.scheduler)
        self.thresholds = PhaseThresholds(resume_max_new=self.ecfg.b_max)
        self._buckets = _resume_buckets(self.ecfg)

        self._ex = get_executables(model_cfg, self.ecfg.moe_mode)
        self._prefill_fn = self._ex.prefill
        # resume batch sizes: powers of two up to the M cap (exact-M
        # dispatch — batches round *down* to a warmed size, no padding
        # rows, so the scatter never sees duplicate slot indices)
        self._resume_levels = []
        m = 1
        while m <= min(self.ecfg.resume_batch_max, self.ecfg.num_slots):
            self._resume_levels.append(m)
            m *= 2
        # cold-pack batch sizes; m = 1 uses the batch-1 slot executable
        self._cold_levels = []
        m = 2
        while m <= min(self.ecfg.cold_batch_max, self.ecfg.num_slots):
            self._cold_levels.append(m)
            m *= 2
        self._warmed_packs: set = set()
        # chunk autotune table: executable + measured tok/s per warmed
        # prefill chunk shape (filled by _build_slot at warmup)
        self._chunk_fns: Dict[int, Callable] = {}
        self._chunk_tok_s: Dict[int, float] = {}
        self.slots = SlotManager(
            C, g, self._build_slot, preestablish=policy.preestablish)
        self.megasteps: Optional[SlotManager] = None
        if self.ecfg.megastep_max >= self.ecfg.megastep_unit >= 2:
            total = (self.ecfg.megastep_max // self.ecfg.megastep_unit
                     * self.ecfg.megastep_unit)
            self.megasteps = SlotManager(
                total, self.ecfg.megastep_unit, self._build_megastep,
                preestablish=policy.preestablish)
        # speculative draft-and-verify grid: one verify width per level,
        # the same shape-stable discipline as the megastep grid
        B = self.ecfg.num_slots
        self._spec_on = self.ecfg.spec_k >= 2
        # per-slot token history (position p holds the token *input* at
        # p: prompt tokens, then each emitted token as it becomes the
        # next input), host mirror + device tensor; the per-session
        # acceptance EMA; parked sessions' history rows
        self._history = np.zeros((B, self.ecfg.max_seq), np.int32)
        self._dev_history = torch.zeros((B, self.ecfg.max_seq),
                                        dtype=torch.int32, device=self.device)
        self._hist_dirty = True
        self._parked_hist: Dict[int, np.ndarray] = {}
        self._spec_ema: Dict[int, float] = {}
        self.specsteps: Optional[SlotManager] = None
        if self._spec_on:
            self.specsteps = SlotManager(
                self.ecfg.spec_k // 2 * 2, 2, self._build_specstep,
                preestablish=policy.preestablish)
        self._warm_shared()

        # run-state
        self._t0 = time.perf_counter()
        self.trace: List[Dict] = []       # per-cycle telemetry
        self.dispatcher = Dispatcher(self)
        self.journal = PlanJournal(max_records=self.ecfg.journal_max)
        self._cycle = 0
        self._sessions: Dict[int, Session] = {}
        self._events: List[TokenEvent] = []
        self._next_ctrl = self.ecfg.control_interval_s
        self._parked: Dict[int, object] = {}   # sid -> parked KV snapshot
        self._paused_seq: Dict[int, int] = {}  # sid -> preemption stamp
        self._preempt_count = 0
        # sid -> (pool.prefix_version, usable hit length)
        self._prefix_probe: Dict[int, Tuple[int, int]] = {}
        self.last_step_did_work = False
        self.event_log: List[TokenEvent] = []  # run(), record_events only
        # device-resident decode state (rebuilt from host mirrors only on
        # membership changes)
        self._dev_tokens = torch.zeros((B,), dtype=torch.int32,
                                       device=self.device)
        self._dev_lengths = torch.zeros((B,), dtype=torch.int32,
                                        device=self.device)
        self._dev_mask = torch.zeros((B,), dtype=torch.bool,
                                     device=self.device)
        self._dev_ids: List[int] = []
        self._dev_dirty = True
        # telemetry window (sampled-cadence sync)
        self._window_t0: Optional[float] = None
        self._window_steps = 0
        self._window_sessions: List[Session] = []
        # per-dispatch (host token copy, ready event) within the window,
        # so the flush can emit true per-token TokenEvents
        self._window_toks: List[Tuple[torch.Tensor, object]] = []
        # windows are mode-pure ("plain" fused/megastep or "spec"
        # draft-and-verify): a mode switch flushes first.  Spec dispatches
        # append ((toks [K, B], acc [B]) on the host, ready event, K); the
        # host mirrors advance only at the flush, when the accept counts
        # are known, so a spec window's ``_window_steps`` is also the
        # pessimistic in-flight token count per lane
        self._window_mode = "plain"
        self._window_spec: List[Tuple[Tuple[torch.Tensor, torch.Tensor],
                                      object, int]] = []
        # double-buffered dispatch: at window overflow the completed
        # window is detached here, the next step is dispatched, and only
        # then does the host wait on the detached window's tokens
        self._overlap = (self.ecfg.overlap_dispatch
                         if self.ecfg.overlap_dispatch is not None
                         else self.device.type == "cuda")
        self._completed_window: Optional[Dict] = None
        # unified telemetry: one registry is the stats surface
        self.telemetry = Telemetry(enabled=self.ecfg.telemetry,
                                   spans_max=self.ecfg.spans_max)
        reg = self.telemetry.registry
        self.hotpath_stats = RegistryDict(
            reg,
            {"fused_steps": 0, "megasteps": 0,
             "mega_tokens": 0,
             "spec_steps": 0, "spec_proposed": 0, "spec_accepted": 0,
             "resume_batches": 0,
             "resume_jobs": 0, "capacity_overruns": 0,
             "cold_batches": 0, "cold_jobs": 0,
             "prefill_tiles_streamed": 0,
             "prefill_tiles_skipped": 0,
             "parks": 0, "unparks": 0,
             "preemptions": 0, "preempt_resumes": 0,
             "aborted": 0, "deadline_aborts": 0,
             "kv_deferred": 0},
            rename={"aborted": "engine_aborted",
                    "parks": "engine_parks",
                    "unparks": "engine_unparks"},
            help_prefix="engine hot-path counter: ")
        self._h_ttft = reg.histogram(
            "ttft_s", help="request submission -> first token (s)")
        self._h_tpot = reg.histogram(
            "tpot_s", help="inter-token gap within decode bursts (s)")
        self._h_gap = reg.histogram(
            "dispatch_gap_s",
            help="host time between consecutive decode submissions, "
                 "excluding time the host spent waiting on the device — "
                 "pure host-side dispatch overhead (s)")
        self._h_devwait = reg.histogram(
            "device_wait_s",
            help="device wait at decode flush points (s)")
        self._h_host = reg.histogram(
            "cycle_host_s", help="wall time of one dispatched cycle (s)")
        self._h_tpmc = reg.histogram(
            "tokens_per_model_call",
            help="decode tokens emitted per model forward pass "
                 "(1 = plain decode; >1 = accepted speculative drafts)",
            buckets=(1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0))
        reg.gauge("spec_acceptance_rate",
                  help="accepted / proposed speculative draft tokens "
                       "(lifetime ratio; 0 when speculation is off)",
                  fn=lambda: (
                      float(self.hotpath_stats["spec_accepted"])
                      / max(1.0,
                            float(self.hotpath_stats["spec_proposed"]))))
        reg.gauge("q_decode", help="decode-queue depth",
                  fn=lambda: float(self.queues.occupancy()[0]))
        reg.gauge("q_prefill", help="prefill-queue depth",
                  fn=lambda: float(self.queues.occupancy()[1]))
        reg.gauge("free_slots", help="unbound KV slots",
                  fn=lambda: float(self.pool.free_slots))
        reg.gauge("slots_in_use", help="bound KV slots",
                  fn=lambda: float(self.pool.slots_in_use))
        reg.gauge("prefix_hits", help="prefix-cache restores",
                  fn=lambda: float(self.pool.stats["prefix_hits"]))
        reg.gauge("prefix_misses", help="prefix-cache lookup misses",
                  fn=lambda: float(self.pool.stats["prefix_misses"]))
        reg.gauge("prefix_evictions", help="prefix-cache entry evictions",
                  fn=lambda: float(self.pool.stats["evictions"]))
        self._h_hitlen = reg.histogram(
            "prefix_hit_len",
            help="restored cached-prefix length per prefix-cache hit "
                 "(tokens)",
            buckets=(16.0, 32.0, 64.0, 128.0, 256.0, 512.0, 1024.0,
                     2048.0, 4096.0))
        reg.gauge("kv_pressure", help="1 when a KVExhausted deferral "
                  "happened within the last 50 cycles",
                  fn=lambda: float(self.kv_pressure_recent()))
        if self.pool.has_state_leaves:
            reg.gauge("state_copies", help="recurrent-state snapshots and "
                      "restores (prefix registrations and hits, parks)",
                      fn=lambda: float(self.pool.stats["state_copies"]))
        if self._paged:
            reg.gauge("free_pages", help="free KV arena pages",
                      fn=lambda: float(self.pool.free_pages))
            reg.gauge("pages_in_use", help="allocated KV arena pages",
                      fn=lambda: float(self.pool.pages_in_use))
            reg.gauge("page_copies", help="copy-on-write page copies",
                      fn=lambda: float(self.pool.stats["page_copies"]))
            if self.pool.prefix_mode == "radix":
                reg.gauge("radix_nodes", help="live radix-tree nodes "
                          "in the prefix index",
                          fn=lambda: float(self.pool.radix_nodes))
                reg.gauge("prefix_pinned_pages",
                          help="page references held by the radix "
                               "prefix index",
                          fn=lambda: float(self.pool.prefix_page_refs))
        # dispatch-gap + per-cycle accounting state.  The gap subtracts
        # ``_block_since_dispatch`` — host time spent waiting on the
        # device since the previous submission
        self._last_dispatch_t: Optional[float] = None
        self._block_since_dispatch = 0.0
        self._cycle_decode_tokens = 0
        self._cycle_prefill_tokens = 0
        self._cycle_block_s = 0.0
        # fault-domain state: per-session KVExhausted deferral counts and
        # the last deferral cycle
        self._kv_retries: Dict[int, int] = {}
        self._kv_last_defer_cycle = -(10 ** 9)
        # prefill-side telemetry accumulated at dispatch time (host
        # arithmetic only), folded into hotpath_stats at flush cadence
        self._prefill_pending = {"cold_batches": 0, "cold_jobs": 0,
                                 "prefill_tiles_streamed": 0,
                                 "prefill_tiles_skipped": 0}

    # ------------------------------------------------------------------
    # device helpers
    # ------------------------------------------------------------------
    def _h2d(self, arr) -> torch.Tensor:
        """Copy a host array to the device without waiting on the stream
        (pinned staging + non-blocking copy on CUDA)."""
        t = torch.tensor(np.asarray(arr))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _sync(self) -> None:
        """Wait for all work queued on the device."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _to_host(self, *ts: torch.Tensor) -> Tuple[object, object]:
        """Start asynchronous copies of ``ts`` to host memory; returns the
        host tensor (a tuple of them for several) and the event that
        marks them ready (None on the CPU)."""
        if self.device.type != "cuda":
            return (ts[0] if len(ts) == 1 else ts), None
        host = tuple(t.to("cpu", non_blocking=True) for t in ts)
        ev = torch.cuda.Event()
        ev.record()
        return (host[0] if len(host) == 1 else host), ev

    # ------------------------------------------------------------------
    # executables & warmup
    # ------------------------------------------------------------------
    def _i32(self, *vals) -> torch.Tensor:
        return self._h2d(np.asarray(vals, np.int32))

    def _bt(self) -> Tuple:
        """Trailing block-table argument of the executables (empty under
        the slab layout, so call sites can splat it unconditionally)."""
        if not self._paged:
            return ()
        return (self.pool.block_tables_device(),)

    def _prepare_append(self, slot: int, n: int,
                        start: Optional[int] = None) -> None:
        """Paged pre-dispatch hook: grow or copy-on-write ``slot``'s block
        table to cover ``n`` tokens from ``start`` (default: the slot's
        current length; speculative dispatches pass the pessimistic
        in-flight frontier).  No-op under the slab layout."""
        if self._paged:
            base = int(self.pool.lengths[slot]) if start is None else start
            self.pool.prepare_append(slot, base, n)

    def _build_slot(self, level: int):
        """Slot executable for decode-reservation ``level``: the prefill
        chunk is C - level tokens.  Pre-establishing warms the chunk shape
        (and times it for the autotune table) at construction; eager
        PyTorch has nothing to compile, so the on-demand (No-Green) path
        binds the same forward with no construction cost, and never runs
        a warm call inside the serving loop, where it would write into a
        live slot."""
        chunk = self.ecfg.cycle_budget - level
        if chunk <= 0:
            return {"chunk": 0, "fn": None}
        fn = self._prefill_fn
        if self.policy.preestablish:
            self._warm_prefill(fn, chunk)
            if self.ecfg.autotune_chunks:
                # chunk autotune: measure each warmed chunk shape's
                # throughput so dispatch can pick the best chunk ≤ a
                # budget instead of assuming the full budget is optimal
                self._chunk_fns[chunk] = fn
                self._chunk_tok_s[chunk] = chunk / self._time_prefill(fn, chunk)
        return {"chunk": chunk, "fn": fn}

    def _time_prefill(self, fn, chunk: int, reps: int = 2) -> float:
        """Best-of-``reps`` wall time of one chunk call into slot 0 at
        offset 0 (construction time: every slot is free)."""
        toks = torch.zeros((1, chunk), dtype=torch.int32, device=self.device)
        args = (self._i32(0), self._i32(0), self._i32(chunk - 1))
        best = float("inf")
        for _ in range(reps):
            self._sync()
            t0 = time.perf_counter()
            fn(self.params, self.pool.cache, toks, *args, *self._bt())
            self._sync()
            best = min(best, time.perf_counter() - t0)
        return max(best, 1e-9)

    def _build_megastep(self, level: int):
        """Megastep executable fusing ``level`` decode iterations.  The
        warm call runs with every lane inactive, so its only writes land
        in the scratch rows (safe at any time)."""
        fn = self._ex.megastep(level)
        B = self.ecfg.num_slots
        z = torch.zeros((B,), dtype=torch.int32, device=self.device)
        fn(self.params, self.pool.cache, z, z,
           torch.zeros((B,), dtype=torch.bool, device=self.device),
           *self._bt())
        self._sync()
        return {"steps": level, "fn": fn}

    def _build_specstep(self, level: int):
        """Draft-and-verify step scoring ``level`` positions per lane.  The
        warm call runs with every lane inactive on a scratch history: its
        K/V writes land in the scratch rows or page and no recurrent
        state changes (safe at any time)."""
        fn = self._ex.spec(level)
        B = self.ecfg.num_slots
        z = torch.zeros((B,), dtype=torch.int32, device=self.device)
        fn(self.params, self.pool.cache,
           torch.zeros((B, self.ecfg.max_seq), dtype=torch.int32,
                       device=self.device), z, z,
           torch.zeros((B,), dtype=torch.bool, device=self.device),
           *self._bt())
        self._sync()
        return {"draft": level, "fn": fn}

    def _warm_prefill(self, fn, chunk: int) -> None:
        toks = torch.zeros((1, chunk), dtype=torch.int32, device=self.device)
        fn(self.params, self.pool.cache, toks, self._i32(0), self._i32(0),
           self._i32(chunk - 1), *self._bt())
        self._sync()

    def _warm_resume(self, m: int, bucket: int) -> None:
        """Warm one [m, bucket] batched-prefill shape into slots 0..m-1 at
        offset 0 (construction time: every slot is free)."""
        if (m, bucket) in self._warmed_packs:
            return      # resume and cold-pack grids share (M, bucket) shapes
        self._warmed_packs.add((m, bucket))
        self._ex.resume(
            self.params, self.pool.cache,
            torch.zeros((m, bucket), dtype=torch.int32, device=self.device),
            torch.arange(m, dtype=torch.int32, device=self.device),
            torch.zeros((m,), dtype=torch.int32, device=self.device),
            torch.full((m,), bucket - 1, dtype=torch.int32,
                       device=self.device), *self._bt())
        self._sync()

    def _warm_shared(self) -> None:
        B = self.ecfg.num_slots
        zeros_b = torch.zeros((B,), dtype=torch.int32, device=self.device)
        self._ex.fused(self.params, self.pool.cache, zeros_b, zeros_b,
                       torch.zeros((B,), dtype=torch.bool, device=self.device),
                       *self._bt())
        self._sync()
        if self.policy.resume_to_decode_queue:
            for m in self._resume_levels:
                for b in self._buckets:
                    self._warm_resume(m, b)
        if self._cold_levels and not self.policy.whole_prefill:
            for m in self._cold_levels:
                for b in self._buckets:
                    self._warm_resume(m, b)
        if self.policy.whole_prefill:
            self._warm_prefill(self._prefill_fn, self._buckets[-1])
        if not self.policy.chunk_by_slots and not self.policy.whole_prefill:
            self._warm_prefill(self._prefill_fn, self._fixed_chunk())

    def _fixed_chunk(self) -> int:
        g = self.ecfg.granularity
        c = int(self.policy.fixed_chunk_frac * self.ecfg.cycle_budget)
        return max(g, (c // g) * g)

    # ------------------------------------------------------------------
    # prefill work execution
    # ------------------------------------------------------------------
    def _run_prefill_tokens(self, sess: Session, shape_len: int,
                            take: Optional[int] = None,
                            fn: Optional[Callable] = None) -> None:
        """Prefill up to ``take`` real tokens (default: fill the shape)
        of the session's current turn in a call of token-shape
        ``shape_len`` — shorter work is padded and masked.  The host only
        waits on the logits when this chunk completes the prefill."""
        take = min(take if take is not None else shape_len, shape_len,
                   self._aligned_remaining(sess))
        if take <= 0:
            return
        if self.pool.lengths[sess.slot] + take > self.ecfg.max_seq - 1:
            self.hotpath_stats["capacity_overruns"] += 1
        turn = sess.current_turn
        toks = turn.prefill_tokens[sess.prefill_done: sess.prefill_done + take]
        pad = shape_len - take
        if pad:
            toks = np.concatenate([toks, np.zeros(pad, np.int32)])
        fn = fn or self._prefill_fn
        self._write_history(sess.slot, int(self.pool.lengths[sess.slot]),
                            toks[:take])
        self._prepare_append(sess.slot, take)
        logits, self.pool.cache = fn(
            self.params, self.pool.cache,
            self._h2d(np.asarray(toks, np.int32)[None]),
            self._i32(sess.slot), self._i32(self.pool.lengths[sess.slot]),
            self._i32(take - 1), *self._bt())
        self._note_prefill_dispatch([self.pool.lengths[sess.slot]], shape_len)
        self._cycle_prefill_tokens += take
        self.pool.lengths[sess.slot] += take
        sess.prefill_done += take
        sess.cached_len = int(self.pool.lengths[sess.slot])
        self._maybe_register_prefix(sess)
        if sess.remaining_prefill == 0:
            self._finish_prefill(sess, logits.float().cpu().numpy())

    def _note_prefill_dispatch(self, cached_lens, shape_len: int,
                               cold_pack: int = 0) -> None:
        """Prefill-side hot-path telemetry (host arithmetic only): per
        dispatched row, the cache-aware kernel streams KV tiles up to the
        row's post-chunk valid length and skips the rest of the padded
        ``max_seq`` extent (estimated at ``prefill_tile`` granularity)."""
        bk = self.ecfg.prefill_tile
        total = -(-self.ecfg.max_seq // bk)
        streamed = sum(min(-(-(int(l) + shape_len) // bk), total)
                       for l in cached_lens)
        p = self._prefill_pending
        p["prefill_tiles_streamed"] += streamed
        p["prefill_tiles_skipped"] += len(cached_lens) * total - streamed
        if cold_pack:
            p["cold_batches"] += 1
            p["cold_jobs"] += cold_pack

    def _maybe_register_prefix(self, sess: Session) -> None:
        """Prefix registration at the shared-prompt boundary (cold only)."""
        if (sess.turn_idx == 0 and sess.shared_prefix_len > 0
                and sess.cached_len == sess.shared_prefix_len
                and sess.prefill_done == sess.shared_prefix_len):
            self.pool.register_prefix(
                sess.slot,
                sess.turns[0].prefill_tokens[:sess.shared_prefix_len])

    def _aligned_remaining(self, s: Session) -> int:
        """Remaining prefill, capped at the shared-prefix boundary so the
        prefix snapshot is taken at exactly that length."""
        rem = s.remaining_prefill
        if (s.turn_idx == 0 and s.prefill_done < s.shared_prefix_len
                and s.cached_len < s.shared_prefix_len):
            rem = min(rem, s.shared_prefix_len - s.prefill_done)
        return rem

    def _finish_prefill(self, sess: Session, last_logits: np.ndarray) -> None:
        self._flush_decode()             # decode membership changes below
        self._dev_dirty = True
        now = self._clock()
        sess.last_token = int(last_logits.argmax())
        sess.first_token_s.append(now)
        sess.token_times_s.append(now)
        sess.decoded = 1
        self._h_ttft.observe(now - sess.arrival_s)
        tr = self.telemetry.tracer
        if tr is not None:
            tr.transition(sess.session_id, "DECODE", now,
                          tokens=sess.current_turn.decode_len,
                          turn=sess.turn_idx)
        self._emit(sess, sess.last_token, now, index=0, first=True,
                   turn_end=sess.decoded >= sess.current_turn.decode_len)
        self._after_token(sess, now)

    def _emit(self, sess: Session, token, t: float, index: int,
              first: bool = False, turn_end: bool = False) -> None:
        """Record one emitted token as a reactor event (drained by
        ``step()``).  Must run *before* ``_after_token`` advances
        ``turn_idx`` so the event names the turn that produced it."""
        self._events.append(TokenEvent(
            session_id=sess.session_id, token=int(token), t=t,
            turn_idx=sess.turn_idx, index=index, first=first,
            turn_end=turn_end,
            session_end=turn_end and sess.turn_idx + 1 >= len(sess.turns)))

    # ------------------------------------------------------------------
    # decode stream (device-resident)
    # ------------------------------------------------------------------
    def _park_history(self, s: Session) -> None:
        """Save a parked session's history row (the proposer's state)."""
        if self._spec_on and s.slot >= 0:
            self._parked_hist[s.session_id] = self._history[s.slot].copy()

    def _restore_history(self, s: Session) -> None:
        """Restore a parked session's history row into its fresh slot."""
        if self._spec_on:
            row = self._parked_hist.pop(s.session_id, None)
            self._history[s.slot, :] = 0 if row is None else row
            self._hist_dirty = True

    def _write_history(self, slot: int, start: int, toks) -> None:
        """Host mirror of the proposer history: ``toks`` are the inputs at
        positions ``start..`` of ``slot`` (cut at the row's end: a
        capacity overrun has no history past it)."""
        if self._spec_on:
            n = max(0, min(len(toks), self.ecfg.max_seq - start))
            self._history[slot, start:start + n] = np.asarray(toks[:n])
            self._hist_dirty = True

    def _upload_history(self) -> None:
        """Replace the device history with the host mirror when dirty."""
        if self._spec_on and self._hist_dirty:
            self._dev_history = self._h2d(self._history)
            self._hist_dirty = False

    def _sync_device_state(self, active: Sequence[Session]) -> None:
        """Rebuild the device token/length/mask arrays from host mirrors.
        Only happens when decode membership changed — every such event
        passes through a flush, so the host mirrors are exact here.  The
        history mirror re-uploads whenever a host-side write dirtied it
        (prefill chunks, plain windows, restores), membership or not."""
        ids = [s.session_id for s in active]
        if not self._dev_dirty and ids == self._dev_ids:
            self._upload_history()
            return
        if self._window_steps:
            self._flush_decode()
        B = self.ecfg.num_slots
        tokens = np.zeros((B,), np.int32)
        mask = np.zeros((B,), bool)
        for s in active:
            tokens[s.slot] = s.last_token
            mask[s.slot] = True
        self._dev_tokens = self._h2d(tokens)
        self._dev_mask = self._h2d(mask)
        self._dev_lengths = self._h2d(self.pool.lengths)
        self._upload_history()
        self._dev_ids = ids
        self._dev_dirty = False

    def _observe_gap(self, t_disp: float) -> None:
        """Dispatch-gap sample: host time since the previous submission
        minus any device-wait time in between."""
        gap = t_disp - self._last_dispatch_t - self._block_since_dispatch
        self._h_gap.observe(max(gap, 0.0))

    def _decode_dispatch(self, active: Sequence[Session],
                         megastep_target: int, spec_target: int = 0) -> None:
        """Dispatch one fused decode step — a K-step megastep, or a
        draft-and-verify step when the plan asked for one — without
        waiting on the result.  The planner's targets are clamped to the
        live burst/capacity bounds (correctness clamps, not decisions)."""
        ecfg = self.ecfg
        if (self._window_sessions
                and [s.session_id for s in self._window_sessions]
                != [s.session_id for s in active]):
            self._flush_decode()         # defensive: membership changed
        if spec_target > 0 and self.specsteps is not None:
            if self._spec_dispatch(active, spec_target):
                return
        if self._window_mode == "spec" and self._window_steps:
            self._flush_decode()         # mode switch: the spec window closes
        k_alive = min(s.current_turn.decode_len - s.decoded for s in active)
        k_cap = (ecfg.max_seq - 1
                 - max(int(self.pool.lengths[s.slot]) for s in active))
        if k_cap < 1:
            # a lane is at the usable capacity (max_seq - 1 rows; the last
            # row is the scratch row).  Proceed, but count it.
            self.hotpath_stats["capacity_overruns"] += 1
            k_cap = 1
        exe, K = None, 1
        if self.megasteps is not None and megastep_target > 0:
            bound = self.megasteps.bind_down(
                min(megastep_target, k_alive, k_cap))
            if bound is not None:
                exe, K = bound[0]["fn"], bound[1]
        if self._window_steps + K > ecfg.telemetry_sample_steps:
            if self._overlap and self._completed_window is None:
                # double buffer: detach the completed window, dispatch the
                # next step first, and only then wait on the detached
                # window — the flush overlaps the new step's execution
                self._completed_window = self._take_window()
            else:
                self._flush_decode()
        try:
            for s in active:
                # paged: grow/COW each lane's table to cover the K decode
                # writes before the dispatch (the step reads one table)
                self._prepare_append(s.slot, K)
        except KVExhausted:
            # decode cannot proceed without its pages: skip this cycle's
            # decode (pages already mapped for earlier lanes stay with
            # their slots) and retry next cycle; past the defer limit
            # the session aborts
            self._kv_defer_or_abort(s.session_id)
            self._drain_completed()
            return
        for s in active:
            self._kv_retries.pop(s.session_id, None)
        self._sync_device_state(active)
        if self._window_t0 is None:
            self._window_t0 = self._clock()
        t_disp = self._clock()
        if self._last_dispatch_t is not None:
            self._observe_gap(t_disp)
        if exe is not None:
            step_toks, nt, nc, nl = exe(self.params, self.pool.cache,
                                        self._dev_tokens, self._dev_lengths,
                                        self._dev_mask, *self._bt())
            self._window_toks.append(self._to_host(step_toks))  # [K, B]
            self.hotpath_stats["megasteps"] += 1
            self.hotpath_stats["mega_tokens"] += K * len(active)
        else:
            nt, nc, nl = self._ex.fused(self.params, self.pool.cache,
                                        self._dev_tokens, self._dev_lengths,
                                        self._dev_mask, *self._bt())
            self._window_toks.append(self._to_host(nt))         # [B]
            self.hotpath_stats["fused_steps"] += 1
        self._dev_tokens, self._dev_lengths = nt, nl
        self.pool.cache = nc
        self._last_dispatch_t = self._clock()
        self._block_since_dispatch = 0.0
        self._cycle_decode_tokens += K * len(active)
        self._window_steps += K
        self._window_sessions = list(active)
        burst_done = False
        for s in active:
            s.decoded += K
            self.pool.lengths[s.slot] += K
            s.cached_len = int(self.pool.lengths[s.slot])
            burst_done |= s.decoded >= s.current_turn.decode_len
        # drain the detached window now — its device work is done or
        # finishing behind the step just submitted
        self._drain_completed()
        if burst_done:
            self._flush_decode()

    def _spec_dispatch(self, active: Sequence[Session],
                       spec_target: int) -> bool:
        """Dispatch one draft-and-verify step: the device drafts K - 1
        tokens per lane by prompt lookup, one verify forward scores them,
        and the accepted prefix commits.  The host mirrors (``decoded``,
        pool lengths, history) advance only at the flush, when the accept
        counts are known; ``_window_steps`` carries the pessimistic
        in-flight bound.  Returns False when the clamps leave no room for
        a draft — the caller goes plain."""
        ecfg = self.ecfg
        if self._window_mode != "spec" and self._window_steps:
            self._flush_decode()         # mode switch: plain window closes
        pend = self._window_steps        # 0 unless this window is spec
        k_alive = min(s.current_turn.decode_len - s.decoded - pend
                      for s in active)
        k_cap = (ecfg.max_seq - 1 - pend
                 - max(int(self.pool.lengths[s.slot]) for s in active))
        bound = None
        if min(k_alive, k_cap) >= 2:
            bound = self.specsteps.bind_down(
                min(spec_target, k_alive, k_cap))
        if bound is None:
            return False                 # burst tail / capacity: go plain
        exe, K = bound[0]["fn"], bound[1]
        if self._window_steps + K > ecfg.telemetry_sample_steps:
            self._flush_decode()
        self._sync_device_state(active)
        try:
            for s in active:
                # cover the verify writes beyond the in-flight frontier;
                # pages of rejected drafts are freed by truncate at flush
                self._prepare_append(
                    s.slot, K, start=int(self.pool.lengths[s.slot])
                    + self._window_steps)
        except KVExhausted:
            self._kv_defer_or_abort(s.session_id)
            return True                  # cycle skipped (deferral counted)
        for s in active:
            self._kv_retries.pop(s.session_id, None)
        if self._window_t0 is None:
            self._window_t0 = self._clock()
        t_disp = self._clock()
        if self._last_dispatch_t is not None:
            self._observe_gap(t_disp)
        toks, acc, nt, self._dev_history, self.pool.cache, nl = exe(
            self.params, self.pool.cache, self._dev_history,
            self._dev_tokens, self._dev_lengths, self._dev_mask,
            *self._bt())
        host, ev = self._to_host(toks, acc)
        self._window_spec.append((host, ev, K))
        self._dev_tokens, self._dev_lengths = nt, nl
        self._last_dispatch_t = self._clock()
        self._block_since_dispatch = 0.0
        self.hotpath_stats["spec_steps"] += 1
        self.hotpath_stats["spec_proposed"] += (K - 1) * len(active)
        self._cycle_decode_tokens += K * len(active)   # dispatched volume
        self._window_steps += K          # pessimistic in-flight bound
        self._window_mode = "spec"
        self._window_sessions = list(active)
        if any(s.decoded + self._window_steps
               >= s.current_turn.decode_len for s in active):
            self._flush_decode()         # the burst may be complete
        return True

    def _take_window(self) -> Dict:
        """Detach the live plain decode window into a record that can be
        processed after the next dispatch (the double buffer).  Host
        mirrors already advanced at dispatch, so only the emission
        bookkeeping is deferred."""
        rec = dict(
            steps=self._window_steps,
            toks=self._window_toks,
            sessions=self._window_sessions,
            t0=self._window_t0,
            base={s.session_id: s.decoded - self._window_steps
                  for s in self._window_sessions},
            # captured now: the next dispatch advances lengths and a later
            # flush rewrites last_token, but this window's history rows
            # anchor at its own pre-window frontier
            hist_base={s.session_id: int(self.pool.lengths[s.slot])
                       - self._window_steps
                       for s in self._window_sessions},
            prev_tok={s.session_id: s.last_token
                      for s in self._window_sessions})
        self._window_sessions = []
        self._window_steps = 0
        self._window_toks = []
        self._window_t0 = None
        self._window_mode = "plain"
        return rec

    def _drain_completed(self) -> None:
        """Wait on a detached window's tokens and emit its events.  Any
        in-flight live window effectively started when the device
        finished the detached one — re-anchor its t0."""
        if self._completed_window is None:
            return
        rec, self._completed_window = self._completed_window, None
        now = self._process_window(rec)
        if self._window_steps:
            self._window_t0 = now

    def _process_window(self, rec: Dict) -> float:
        """Emit one detached window's token events, waiting only on the
        window's own tokens (the device may already run newer work).
        ``_after_token`` is NOT called here: a detached window never
        completed a burst (a burst-completing dispatch flushes at once),
        so the per-session transition belongs to a later flush."""
        n = rec["steps"]
        sessions = rec["sessions"]
        t_wait = self._clock()
        if rec["toks"] and rec["toks"][-1][1] is not None:
            rec["toks"][-1][1].synchronize()
        now = self._clock()
        self._h_devwait.observe(now - t_wait)
        self._cycle_block_s += now - t_wait
        self._block_since_dispatch += now - t_wait
        t0 = rec["t0"]
        if t0 is not None and now > t0:
            self.scheduler.record_decode_step(now - t0, steps=n)
            ts = [t0 + (now - t0) * (i + 1) / n for i in range(n)]
            # one weighted observation per flush: the window-mean gap
            self._h_tpot.observe((now - t0) / n, n * len(sessions))
        else:
            ts = [now] * n
        B = self.ecfg.num_slots
        step_toks = np.concatenate(
            [h.numpy().reshape(-1, B) for h, _ in rec["toks"]],
            axis=0) if rec["toks"] else np.zeros((0, B), np.int32)
        assert step_toks.shape[0] == n, (step_toks.shape, n)
        self._h_tpmc.observe(1.0, n * len(sessions))
        for s in sessions:
            s.last_token = int(step_toks[-1, s.slot])
            s.token_times_s.extend(ts)
            base = rec["base"][s.session_id]
            dlen = s.current_turn.decode_len
            for i in range(n):
                self._emit(s, step_toks[i, s.slot], ts[i], index=base + i,
                           turn_end=base + i + 1 >= dlen)
            if self._spec_on:
                # plain windows feed the proposer history too: the
                # window's inputs were the token before it and every
                # emitted token but the last
                self._write_history(
                    s.slot, rec["hist_base"][s.session_id],
                    [rec["prev_tok"][s.session_id]]
                    + step_toks[:-1, s.slot].tolist())
                # acceptance-EMA recovery: a session below SPEC_EMA_FLOOR
                # would never re-probe (plain windows give no acceptance
                # signal), so its EMA creeps back up per plain token
                if s.session_id in self._spec_ema:
                    self._spec_ema[s.session_id] = min(
                        1.0, self._spec_ema[s.session_id]
                        + SPEC_EMA_RECOVERY * n)
        return now

    def _flush_decode(self) -> None:
        """Sampled-cadence host sync: wait on the decode stream, record
        the aggregate inter-emission gap (TPOT x steps) and assign token
        timestamps interpolated across the window.  Prefill-side counters
        accumulated since the last flush fold into ``hotpath_stats`` here.
        Handles the detached double-buffer window first, then the live
        window: plain (uniform n steps) or speculative (variable accepted
        counts)."""
        self._drain_completed()
        for k, v in self._prefill_pending.items():
            self.hotpath_stats[k] += v
            self._prefill_pending[k] = 0
        if self._window_steps == 0:
            return
        if self._window_mode == "spec":
            self._flush_spec_window()
            return
        sessions = self._window_sessions
        rec = self._take_window()
        now = self._process_window(rec)
        self._window_t0 = now
        for s in sessions:
            self._after_token(s, now)

    def _flush_spec_window(self) -> None:
        """Host sync of a speculative window: read each dispatch's accept
        counts, advance the host mirrors by the amounts really accepted
        (the dispatch advanced only the pessimistic bound), free pages
        prepared for rejected drafts (``pool.truncate``), write the
        emitted tokens into the proposer history, update the per-session
        acceptance EMA, and emit the variable-length token streams."""
        dispatches = self._window_spec
        sessions = self._window_sessions
        self._window_spec = []
        self._window_sessions = []
        self._window_steps = 0
        self._window_mode = "plain"
        t_wait = self._clock()
        if dispatches[-1][1] is not None:
            dispatches[-1][1].synchronize()
        now = self._clock()
        self._h_devwait.observe(now - t_wait)
        self._cycle_block_s += now - t_wait
        self._block_since_dispatch += now - t_wait
        t0 = self._window_t0
        self._window_t0 = now
        tok_h = [t.numpy() for (t, _), _, _ in dispatches]   # each [K, B]
        acc_h = [a.numpy() for (_, a), _, _ in dispatches]   # each [B]
        totals = []
        for s in sessions:
            emitted: List[int] = []
            for th, ah, (_, _, K) in zip(tok_h, acc_h, dispatches):
                a = int(ah[s.slot])
                emitted.extend(int(x) for x in th[:a, s.slot])
                if K > 1:
                    rate = (a - 1) / (K - 1)
                    prev = self._spec_ema.get(s.session_id, 1.0)
                    self._spec_ema[s.session_id] = 0.9 * prev + 0.1 * rate
                self.hotpath_stats["spec_accepted"] += a - 1
                self._h_tpmc.observe(float(a))
            total = len(emitted)
            totals.append(total)
            if total == 0:
                continue                 # inactive lane (diverged plan)
            L0 = int(self.pool.lengths[s.slot])
            # history: position p holds the token input at p — the window
            # consumed the token before it plus every emitted token but
            # the last (that is the next round's input)
            self._write_history(s.slot, L0, [s.last_token] + emitted[:-1])
            base = s.decoded
            dlen = s.current_turn.decode_len
            s.decoded += total
            self.pool.lengths[s.slot] = L0 + total
            s.cached_len = L0 + total
            # paged rollback: unmap the pages prepared for rejected drafts
            # beyond the accepted frontier (slab: the length rewind
            # happened by not advancing past L0 + total)
            self.pool.truncate(s.slot, L0 + total)
            s.last_token = emitted[-1]
            if t0 is not None and now > t0:
                ts = [t0 + (now - t0) * (i + 1) / total
                      for i in range(total)]
                self._h_tpot.observe((now - t0) / total, total)
            else:
                ts = [now] * total
            s.token_times_s.extend(ts)
            for i, tok in enumerate(emitted):
                self._emit(s, tok, ts[i], index=base + i,
                           turn_end=base + i + 1 >= dlen)
            self._after_token(s, now)
        if t0 is not None and now > t0 and totals:
            # controller TPOT: the window's per-token pace at the mean
            # accepted depth across lanes
            mean_total = max(1, int(round(sum(totals) / len(totals))))
            self.scheduler.record_decode_step(now - t0, steps=mean_total)

    def _after_token(self, sess: Session, now: float) -> None:
        turn = sess.current_turn
        if sess.decoded < turn.decode_len:
            sess.state = SessionState.DECODING
            return
        self._dev_dirty = True           # session leaves the decode stream
        tr = self.telemetry.tracer
        if sess.turn_idx + 1 >= len(sess.turns):
            sess.state = SessionState.FINISHED
            self.pool.free(sess.slot)
            if tr is not None:
                tr.slot_free(sess.slot, now)
                tr.transition(sess.session_id, "DONE", now)
            return
        if tr is not None:
            tr.transition(sess.session_id, "TOOL_WAIT", now,
                          turn=sess.turn_idx + 1)
        sess.turn_idx += 1
        sess.prefill_done = 0
        sess.decoded = 0
        # the tool call is simulated: the session is ready again after the
        # turn's tool latency (an online front end's tool clock is not ported)
        sess.state = SessionState.TOOL_CALL
        sess.ready_s = now + sess.turns[sess.turn_idx - 1].tool_latency_s

    # ------------------------------------------------------------------
    # plan execution: admission
    # ------------------------------------------------------------------
    def _slot_bind_span(self, slot: int, sid: int, t: float) -> None:
        tr = self.telemetry.tracer
        if tr is not None:
            tr.slot_bind(slot, sid, t)

    def _slot_free_span(self, slot: int, t: float) -> None:
        tr = self.telemetry.tracer
        if tr is not None:
            tr.slot_free(slot, t)

    def _exec_admission(self, adm: Admission, now: float) -> None:
        s = self._sessions.get(adm.session_id)
        if s is None:
            return
        if s.state == SessionState.WAITING_PREFILL:
            if self.pool.free_slots == 0:
                return  # backpressure: the planner retries next cycle
            try:
                s.slot = self.pool.alloc()
            except KVExhausted:
                self._kv_defer_or_abort(s.session_id)
                return  # admission deferred: retries next cycle
            if self._spec_on:
                # fresh slot: clear the previous occupant's history row
                # (stale drafts cannot change tokens, the verify rejects
                # them, but they would lower the acceptance rate)
                self._history[s.slot, :] = 0
                self._hist_dirty = True
            self._slot_bind_span(s.slot, s.session_id, now)
            # always probe, even when the plan's peek saw a miss: the
            # pool's hit/miss accounting and LRU refresh are
            # dispatch-time effects that must happen exactly once
            self._maybe_restore_prefix(s)
        elif s.state == SessionState.TOOL_CALL:
            if adm.unpark and s.slot < 0 and s.session_id in self._parked:
                # parked during TOOL_WAIT: needs a fresh slot + a lossless
                # restore before its resume prefill may run
                if self.pool.free_slots == 0:
                    return
                try:
                    s.slot = self.pool.alloc()
                except KVExhausted:
                    self._kv_defer_or_abort(s.session_id)
                    return
                self.pool.unpark(s.slot,
                                 self._parked.pop(s.session_id))
                self._restore_history(s)
                self.hotpath_stats["unparks"] += 1
                self._slot_bind_span(s.slot, s.session_id, now)
            elif s.slot < 0:
                return                   # parked, but the plan diverged
        else:
            return                       # stale plan entry
        self._submit(s, now, adm)

    def _maybe_restore_prefix(self, s: Session) -> None:
        if s.shared_prefix_len <= 0:
            return
        toks = s.turns[0].prefill_tokens
        # cap the restorable length at one token short of the whole
        # request: a fully-cached request still needs >= 1 new prefill
        # token to produce its first logits
        entry = self.pool.lookup_longest(toks[:s.shared_prefix_len],
                                         max_len=len(toks) - 1)
        if entry is not None:
            self.pool.restore_prefix(s.slot, entry)
            s.cached_len = entry.length
            s.prefill_done = entry.length
            self._h_hitlen.observe(float(entry.length))
            self._write_history(s.slot, 0, toks[:entry.length])

    def _submit(self, s: Session, now: float, adm: Admission) -> None:
        s.arrival_s = now
        s.request_arrivals.append(now)
        # queue delay: how long the request sat ready before admission
        s.queue_delays_s.append(max(0.0, now - s.ready_s)
                                if np.isfinite(s.ready_s) else 0.0)
        s.state = SessionState.PREFILLING
        tr = self.telemetry.tracer
        if tr is not None:
            tr.transition(s.session_id,
                          "RESUME" if s.turn_idx else "PREFILL", now,
                          turn=s.turn_idx)
        job = Job(session_id=s.session_id, phase=adm.phase,
                  new_len=s.remaining_prefill, arrival_s=now)
        if adm.to_decode_queue:
            self.queues.q_decode.append(job)
        else:
            job.enqueued_cold = adm.phase == Phase.RESUME_PREFILL
            self.queues.q_prefill.append(job)

    # ------------------------------------------------------------------
    # plan execution: preemption (PriorityPlanner)
    # ------------------------------------------------------------------
    def _preempt_prefill(self, sid: int) -> None:
        """Suspend a cold prefill at a chunk boundary: its KV rows are
        kept by the park machinery, the slot is freed, and its queue
        entry is pulled (re-created on unsuspend)."""
        s = self._sessions.get(sid)
        if s is None or s.state != SessionState.PREFILLING or s.slot < 0:
            return
        self._parked[sid] = self.pool.park(s.slot)
        self._park_history(s)
        t = self._clock()
        self._slot_free_span(s.slot, t)
        tr = self.telemetry.tracer
        if tr is not None:
            tr.transition(sid, "PAUSED", t)
        s.slot = -1
        s.state = SessionState.PREFILL_PAUSED
        self._preempt_count += 1
        self._paused_seq[sid] = self._preempt_count
        jobs = [j for j in self.queues.q_prefill if j.session_id != sid]
        self.queues.q_prefill.clear()
        self.queues.q_prefill.extend(jobs)
        self.hotpath_stats["preemptions"] += 1

    def _unsuspend_prefill(self, sid: int, now: float) -> None:
        """Resume a suspended cold prefill: unpark its snapshot into a
        fresh slot (bit-identical state) and re-queue its job."""
        s = self._sessions.get(sid)
        if (s is None or s.state != SessionState.PREFILL_PAUSED
                or self.pool.free_slots == 0):
            return
        try:
            s.slot = self.pool.alloc()
        except KVExhausted:
            self._kv_defer_or_abort(s.session_id)
            return
        self.pool.unpark(s.slot, self._parked.pop(sid))
        self._restore_history(s)
        self._paused_seq.pop(sid, None)
        self._slot_bind_span(s.slot, sid, now)
        tr = self.telemetry.tracer
        if tr is not None:
            tr.transition(sid, "PREFILL", now, turn=s.turn_idx,
                          resumed=True)
        s.state = SessionState.PREFILLING
        self.queues.q_prefill.append(Job(
            session_id=sid, phase=Phase.COLD_PREFILL,
            new_len=s.remaining_prefill, arrival_s=now))
        self.hotpath_stats["preempt_resumes"] += 1

    # ------------------------------------------------------------------
    # plan execution: resume prefills (batched, fused into decode)
    # ------------------------------------------------------------------
    def _exec_resume(self, rp: ResumePlan) -> bool:
        """Pack the planned resume jobs from Q_D into one [M, bucket]
        call with per-row slots/lengths.  Stale entries scanned on the
        way are dropped; on plan/queue divergence the batch rounds down
        to a warmed size."""
        qd = self.queues.q_decode
        want = list(rp.session_ids)
        jobs: List[Tuple[Job, Session]] = []
        while qd and len(jobs) < len(want):
            job = qd.popleft()
            s = self._sessions.get(job.session_id)
            if (s is None or s.state != SessionState.PREFILLING
                    or s.remaining_prefill <= 0):
                continue                 # stale entry: dropped
            if job.session_id != want[len(jobs)]:
                qd.appendleft(job)       # diverged from the plan: stop
                break
            jobs.append((job, s))
        if not jobs:
            return False
        if len(jobs) < len(want):
            lvls = [lv for lv in self._resume_levels if lv <= len(jobs)]
            if not lvls:
                for job, _ in reversed(jobs):
                    qd.appendleft(job)
                return False
            m = max(lvls)
            for job, _ in reversed(jobs[m:]):
                qd.appendleft(job)
            jobs = jobs[:m]
        try:
            unfinished = self._dispatch_prefill_batch(jobs, rp.bucket,
                                                      count_overruns=False)
        except KVExhausted as e:
            for job, _ in reversed(jobs):
                qd.appendleft(job)       # whole batch retries next cycle
            self._kv_defer_or_abort(e.session_id)
            return False
        self.hotpath_stats["resume_batches"] += 1
        self.hotpath_stats["resume_jobs"] += len(jobs)
        for job, _ in unfinished:
            qd.append(job)               # continue next cycle
        return True

    def _dispatch_prefill_batch(self, jobs: List[Tuple[Job, Session]],
                                bucket: int, *, count_overruns: bool,
                                cold_pack: int = 0,
                                ) -> List[Tuple[Job, Session]]:
        """Shared [M, bucket] batched-prefill dispatch for resume batches
        and cold packs: assemble per-row tokens/slots/lengths, run the
        batched call, advance the host mirrors, register prefixes and
        finish completed prefills.  Returns the (job, session) pairs
        still mid-prefill."""
        m = len(jobs)
        takes = []
        toks = np.zeros((m, bucket), np.int32)
        for i, (_, s) in enumerate(jobs):
            take = min(bucket, self._aligned_remaining(s))
            takes.append(take)
            toks[i, :take] = s.current_turn.prefill_tokens[
                s.prefill_done: s.prefill_done + take]
            if (count_overruns and self.pool.lengths[s.slot] + take
                    > self.ecfg.max_seq - 1):
                self.hotpath_stats["capacity_overruns"] += 1
        slots = np.asarray([s.slot for _, s in jobs], np.int32)
        lens = np.asarray([self.pool.lengths[s.slot] for _, s in jobs],
                          np.int32)
        logit_idx = np.asarray([t - 1 for t in takes], np.int32)
        try:
            for i, (_, s) in enumerate(jobs):
                self._prepare_append(s.slot, takes[i])
        except KVExhausted as e:
            # name the session for the caller's deferral accounting; pages
            # mapped for earlier rows stay with their slots (those appends
            # just find them mapped on the retry)
            e.session_id = s.session_id
            raise
        logits, self.pool.cache = self._ex.resume(
            self.params, self.pool.cache, self._h2d(toks), self._h2d(slots),
            self._h2d(lens), self._h2d(logit_idx), *self._bt())
        self._note_prefill_dispatch(lens, bucket, cold_pack=cold_pack)
        self._cycle_prefill_tokens += sum(takes)

        np_logits: Optional[np.ndarray] = None
        unfinished: List[Tuple[Job, Session]] = []
        for i, (job, s) in enumerate(jobs):
            self._write_history(s.slot, int(self.pool.lengths[s.slot]),
                                toks[i, :takes[i]])
            self.pool.lengths[s.slot] += takes[i]
            s.prefill_done += takes[i]
            s.cached_len = int(self.pool.lengths[s.slot])
            self._maybe_register_prefix(s)
            if s.remaining_prefill == 0:
                if np_logits is None:
                    np_logits = logits.float().cpu().numpy()
                self._finish_prefill(s, np_logits[i])
            else:
                unfinished.append((job, s))
        return unfinished

    # ------------------------------------------------------------------
    # plan execution: prefill stream
    # ------------------------------------------------------------------
    def _drop_stale_prefill_heads(self) -> None:
        qp = self.queues.q_prefill
        while qp:
            s = self._sessions.get(qp[0].session_id)
            if s is not None and s.state == SessionState.PREFILLING:
                return
            qp.popleft()                 # drop stale entries at the head

    def _take_prefill_job(self, sid: int) -> Optional[Tuple[Job, Session]]:
        """Remove and return ``sid``'s live Q_P entry (None when absent
        or stale)."""
        qp = self.queues.q_prefill
        for i, job in enumerate(qp):
            if job.session_id == sid:
                s = self._sessions.get(sid)
                if s is None or s.state != SessionState.PREFILLING:
                    return None
                del qp[i]
                return job, s
        return None

    def _resolve_cold_fn(self, op: ColdOp, slot_exec) -> Optional[Callable]:
        if op.fn_src == "slot":
            return slot_exec["fn"] if slot_exec else None
        if op.fn_src == "slot_full":
            # opportunistic reclaim: bind the full-budget slot
            full_exec, _ = self.slots.bind(self.scheduler.cfg.r_base)
            return full_exec["fn"]
        if op.fn_src == "tuned":
            return self._chunk_fns.get(op.shape)
        return None                      # shared batch-1 prefill

    def _exec_cold_op(self, op: ColdOp, slot_exec) -> bool:
        qp = self.queues.q_prefill
        if op.kind == "pack":
            return self._exec_cold_pack(op)
        got = self._take_prefill_job(op.session_ids[0])
        if got is None:
            return False
        job, s = got
        if s.remaining_prefill == 0:
            raise RuntimeError("fully-cached request needs >=1 new token")
        try:
            if op.kind == "whole":
                # llama.cpp-style: run the entire prompt to completion
                while s.state == SessionState.PREFILLING:
                    self._run_prefill_tokens(s, op.shape)
                return True
            fn = self._resolve_cold_fn(op, slot_exec)
            for _ in range(op.reps):
                if s.state != SessionState.PREFILLING:
                    break
                self._run_prefill_tokens(s, op.shape, fn=fn)
        except KVExhausted:
            # the chunk's prepare_append rolled back cleanly: the job
            # returns to the head of Q_P and retries next cycle (lengths
            # advance only on a successful dispatch)
            qp.appendleft(job)
            self._kv_defer_or_abort(s.session_id)
            return True
        if s.state == SessionState.PREFILLING:
            qp.appendleft(job)           # unfinished: stays at the head
        return True

    def _exec_cold_pack(self, op: ColdOp) -> bool:
        """Pack the planned M prefills into one [M, bucket] batched call
        (the same machinery — and warmed shapes — as batched resume).
        Unfinished jobs return to the queue head in order."""
        qp = self.queues.q_prefill
        jobs: List[Tuple[Job, Session]] = []
        for sid in op.session_ids:
            got = self._take_prefill_job(sid)
            if got is None:
                continue
            if got[1].remaining_prefill == 0:
                raise RuntimeError("fully-cached request needs >=1 new token")
            jobs.append(got)
        if not jobs:
            return False
        try:
            unfinished = self._dispatch_prefill_batch(
                jobs, op.shape, count_overruns=True, cold_pack=len(jobs))
        except KVExhausted as e:
            for job, _ in reversed(jobs):
                qp.appendleft(job)       # whole pack retries next cycle
            self._kv_defer_or_abort(e.session_id)
            return False
        for job, _ in reversed(unfinished):
            qp.appendleft(job)           # continue next cycle, in order
        return True

    # ------------------------------------------------------------------
    # reactor surface: attach / step / poll-state
    # ------------------------------------------------------------------
    def _clock(self) -> float:
        return time.perf_counter() - self._t0

    def attach(self, session: Session) -> None:
        """Register a session with the reactor."""
        if session.session_id in self._sessions:
            raise ValueError(
                f"duplicate session_id {session.session_id}")
        self._sessions[session.session_id] = session
        tr = self.telemetry.tracer
        if tr is not None:
            tr.transition(session.session_id, "QUEUED", self._clock())

    def _begin(self) -> None:
        ecfg = self.ecfg
        r = self.planner.static_r_min(ecfg.cycle_budget, ecfg.granularity)
        if r is not None:
            self.scheduler.state.r_min = r
        self._next_ctrl = self._clock() + ecfg.control_interval_s

    _TERMINAL = (SessionState.FINISHED, SessionState.ABORTED)

    def pending(self) -> bool:
        return any(s.state not in self._TERMINAL
                   for s in self._sessions.values())

    def snapshot(self, now: Optional[float] = None) -> EngineView:
        """The immutable ``EngineView`` the planner sees.  Built fresh
        each cycle; the only pool interaction is the non-mutating
        ``peek_longest`` probe (the restore happens at dispatch)."""
        if now is None:
            now = self._clock()
        ver = self.pool.prefix_version
        svs = []
        for s in self._sessions.values():
            t = s.current_turn
            hit = 0
            if (s.state == SessionState.WAITING_PREFILL
                    and s.ready_s <= now and s.shared_prefix_len > 0):
                probe = self._prefix_probe.get(s.session_id)
                if probe is not None and probe[0] == ver:
                    hit = probe[1]
                else:
                    toks = s.turns[0].prefill_tokens
                    hit = self.pool.peek_longest(
                        toks[:s.shared_prefix_len],
                        max_len=len(toks) - 1)
                    self._prefix_probe[s.session_id] = (ver, hit)
            svs.append(SessionView(
                session_id=s.session_id, state=s.state.value, slot=s.slot,
                turn_idx=s.turn_idx, num_turns=len(s.turns),
                cached_len=s.cached_len, prefill_done=s.prefill_done,
                turn_prefill_len=len(t.prefill_tokens) if t else 0,
                decode_len=t.decode_len if t else 0, decoded=s.decoded,
                shared_prefix_len=s.shared_prefix_len, ready_s=s.ready_s,
                slo=s.slo_class, prefix_hit_len=hit,
                paused_seq=self._paused_seq.get(s.session_id, -1),
                deadline_s=s.deadline_s,
                spec_ema=self._spec_ema.get(s.session_id, 1.0)))
        return EngineView(
            now=now, next_ctrl=self._next_ctrl,
            tpot_step_ms=self.scheduler.state.tpot_step_ms,
            r_min=self.scheduler.state.r_min,
            b_prefill=self.scheduler.state.b_prefill,
            cycle_budget=self.ecfg.cycle_budget,
            granularity=self.ecfg.granularity,
            r_base=self.scheduler.cfg.r_base,
            max_seq=self.ecfg.max_seq,
            free_slots=self.pool.free_slots,
            slot_lengths=tuple(int(x) for x in self.pool.lengths),
            sessions=tuple(svs),
            q_decode=tuple(JobView(j.session_id, j.phase, j.new_len)
                           for j in self.queues.q_decode),
            q_prefill=tuple(JobView(j.session_id, j.phase, j.new_len)
                            for j in self.queues.q_prefill),
            buckets=tuple(self._buckets),
            resume_levels=tuple(self._resume_levels),
            cold_levels=tuple(self._cold_levels),
            megastep_levels=(tuple(self.megasteps.levels)
                             if self.megasteps is not None else ()),
            spec_levels=(tuple(self.specsteps.levels)
                         if self.specsteps is not None else ()),
            chunk_tok_s=self._chunk_tok_s,
            autotune=self.ecfg.autotune_chunks,
            min_cached_fraction=self.thresholds.min_cached_fraction,
            resume_max_new=self.thresholds.resume_max_new)

    def step(self) -> List[TokenEvent]:
        """One reactor cycle, plan -> execute.  Non-blocking apart from
        the sampled-cadence decode flush and prefill completions.
        Returns the token events this cycle emitted."""
        ecfg = self.ecfg
        now = self._clock()

        # ---- SLO deadline sweep ------------------------------------
        for s in list(self._sessions.values()):
            if s.deadline_s < now and s.state not in self._TERMINAL:
                if self.abort_session(s.session_id, "deadline"):
                    self.hotpath_stats["deadline_aborts"] += 1

        # ---- control update (Algorithm 1) -------------------------
        ctrl = self.planner.plan_control(now, self._next_ctrl)
        if ctrl.flush:
            self._flush_decode()         # fresh TPOT for the controller
            if ctrl.update:
                self.scheduler.update()
            self._next_ctrl = now + ecfg.control_interval_s

        # ---- plan -> execute ---------------------------------------
        view = self.snapshot(now)
        plan = self.planner.plan(view)
        plan = dataclasses.replace(
            plan, control=ctrl,
            plan_id=self._cycle if plan.plan_id < 0 else plan.plan_id)
        if plan.decode is None:
            # decode pauses this cycle: the next dispatch gap would span
            # scheduling dead time, not host dispatch overhead
            self._last_dispatch_t = None
        events_before = len(self._events)
        self._cycle_decode_tokens = 0
        self._cycle_prefill_tokens = 0
        self._cycle_block_s = 0.0
        t_host0 = time.perf_counter()
        try:
            outcome = self.dispatcher.execute(plan, now)
        except SessionFault as f:
            # engine-level quarantine: the fault names exactly one session
            # (raised before any device dispatch); abort it, keep serving
            self.abort_session(f.session_id, f.reason)
            outcome = CycleOutcome(did_work=True)
        host_s = time.perf_counter() - t_host0

        if outcome.did_work:
            self._h_host.observe(host_s)
            tr = self.telemetry.tracer
            if tr is not None:
                tr.cycle(plan.plan_id, _plan_kind(plan), now,
                         self._clock(),
                         planned=_planned_tokens(plan),
                         actual=(self._cycle_decode_tokens
                                 + self._cycle_prefill_tokens),
                         host_ms=round(host_s * 1e3, 4),
                         block_ms=round(self._cycle_block_s * 1e3, 4),
                         q_d=outcome.q_d, q_p=outcome.q_p)

        if len(self.trace) < ecfg.trace_max:
            self.trace.append(dict(
                t=self._clock(), tpot_ms=self.scheduler.state.tpot_step_ms,
                r_min=self.scheduler.state.r_min,
                b_prefill=self.scheduler.state.b_prefill,
                q_d=outcome.q_d, q_p=outcome.q_p,
                q_p_cold=outcome.q_p_cold, q_p_resume=outcome.q_p_resume,
                active=outcome.active))
        self.journal.record(CycleRecord(
            cycle=self._cycle, plan=plan,
            events=len(self._events) - events_before,
            did_work=outcome.did_work))
        self._cycle += 1
        self.last_step_did_work = outcome.did_work
        events, self._events = self._events, []
        return events

    def tokens_per_model_call(self) -> float:
        """Mean decode tokens emitted per model forward pass over the run
        (1.0 for plain decode): the speculative-decode amortisation."""
        h = self._h_tpmc
        return h.sum / h.total if h.total else 1.0

    def stats(self) -> Dict[str, float]:
        """The unified stats surface: a flat snapshot of the registry."""
        return self.telemetry.registry.snapshot()

    def abort_session(self, session_id: int, reason: str) -> bool:
        """Quarantine one session: flush any in-flight decode window it
        sits in, strip its queue entries, reclaim its slot / parked
        snapshot, mark it ABORTED and emit its terminal error event.
        False when the session is unknown or already terminal."""
        s = self._sessions.get(session_id)
        if s is None or s.state in (SessionState.FINISHED,
                                    SessionState.ABORTED):
            return False
        in_completed = (self._completed_window is not None and any(
            w.session_id == session_id
            for w in self._completed_window["sessions"]))
        if in_completed or any(w.session_id == session_id
                               for w in self._window_sessions):
            # the window holds real decoded tokens — deliver them first
            self._flush_decode()
            if s.state in (SessionState.FINISHED, SessionState.ABORTED):
                return False             # the flush completed the session
        for q in (self.queues.q_decode, self.queues.q_prefill):
            stale = [j for j in q if j.session_id == session_id]
            for j in stale:
                q.remove(j)
        t_now = self._clock()
        if s.slot >= 0:
            self.pool.free(s.slot)
            self._slot_free_span(s.slot, t_now)
            s.slot = -1
        entry = self._parked.pop(session_id, None)
        if entry is not None:
            self.pool.release_entry(entry)
        self._parked_hist.pop(session_id, None)
        self._spec_ema.pop(session_id, None)
        self._paused_seq.pop(session_id, None)
        self._kv_retries.pop(session_id, None)
        self._dev_dirty = True           # decode membership changed
        s.state = SessionState.ABORTED
        s.abort_reason = reason
        self.hotpath_stats["aborted"] += 1
        tr = self.telemetry.tracer
        if tr is not None:
            tr.transition(session_id, "ABORTED", t_now, reason=reason)
        self._events.append(TokenEvent(
            session_id=session_id, token=-1, t=t_now,
            turn_idx=s.turn_idx, index=-1, session_end=True,
            error=True, abort_reason=reason))
        return True

    def _kv_defer_or_abort(self, session_id: int) -> None:
        """KVExhausted degradation ladder: count the deferral, and once
        one session has deferred past ``kv_defer_limit`` convert it to a
        ``SessionFault``."""
        self.hotpath_stats["kv_deferred"] += 1
        self._kv_last_defer_cycle = self._cycle
        n = self._kv_retries.get(session_id, 0) + 1
        self._kv_retries[session_id] = n
        if n > self.ecfg.kv_defer_limit:
            raise SessionFault(session_id, "kv_exhausted")

    def kv_pressure_recent(self, window: int = 50) -> bool:
        """True when a KVExhausted deferral happened within the last
        ``window`` cycles."""
        return self._cycle - self._kv_last_defer_cycle <= window

    # ------------------------------------------------------------------
    # closed-loop batch API — on the reactor
    # ------------------------------------------------------------------
    def run(self, sessions: Sequence[Session],
            thresholds: Optional[SLOThresholds] = None) -> ServingReport:
        self._sessions = {}
        self._prefix_probe.clear()
        for s in sessions:
            self.attach(s)
        self._t0 = time.perf_counter()
        self._last_dispatch_t = None
        tr = self.telemetry.tracer
        if tr is not None:
            # the clock just restarted: reopen the cohort at t=0
            tr.reset()
            for s in sessions:
                tr.transition(s.session_id, "QUEUED", 0.0)
        self._begin()
        ecfg = self.ecfg
        self.event_log = []

        while self.pending():
            if self._clock() > ecfg.max_wall_s:
                break
            events = self.step()
            if ecfg.record_events:
                self.event_log.extend(events)
            if not self.last_step_did_work:
                time.sleep(0.0005)

        self._flush_decode()
        self._events.clear()
        wall = self._clock()
        extra = {
            "rebinds": float(self.slots.stats.rebinds),
            "mean_rebind_us": self.slots.stats.mean_rebind_us,
            "slot_misses": float(self.slots.stats.misses),
            "prefix_hits": float(self.pool.stats["prefix_hits"]),
            "prefix_partial_hits":
                float(self.pool.stats["prefix_partial_hits"]),
            "prefix_misses": float(self.pool.stats["prefix_misses"]),
            "prefix_evictions": float(self.pool.stats["evictions"]),
        }
        extra.update({k: float(v) for k, v in self.hotpath_stats.items()})
        rep = build_report(self.policy.name, list(sessions), wall,
                           thresholds, extra)
        rep.tokens_per_model_call = self.tokens_per_model_call()
        return rep
