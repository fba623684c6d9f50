"""Pure plan-based scheduling core (DESIGN.md §9).

The paper's claim is that *scheduling decisions alone* — phase split,
resume budgeting, adaptive partitions (Algorithm 1) — drive the serving
wins.  This module makes those decisions a first-class, swappable layer:
a ``CyclePlanner`` looks at an immutable ``EngineView`` (queues, session
phases, TPOT/control state, slot levels, KV pressure) and emits a
declarative ``CyclePlan`` — which control update to run, which slot
level to bind, which sessions to decode (and the megastep K), how to
compose the resume batch, which cold-prefill chunks to run, which
sessions to admit and how to route them, and (for the SLO-class
planner) which cold prefills to preempt.  Planners touch **no device
state**: they are pure functions of the view, unit-testable in
microseconds, and consumed verbatim by both the real engine
(``serving/engine.py`` executes plans through its ``Dispatcher``) and
the fluid simulator (``serving/simulator.py`` reads the same planner's
policy semantics) — one copy of every policy, no drift.

Plan → execute contract: ``ServingEngine.step()`` is

    ctrl = planner.plan_control(now, next_ctrl)   # control boundary?
    <execute ctrl: host-sync flush, Algorithm-1 update, clock advance>
    view = engine snapshot                        # post-control state
    plan = planner.plan(view)                     # everything else
    dispatcher.execute(plan)

The control decision is planned *before* the main view is built because
Algorithm 1's update rewrites the TPOT estimate and the partition that
every later decision (megastep K, slot level, chunk budgets) reads —
the view hands the planner the post-update numbers, exactly like the
pre-refactor inline loop.

Fidelity notes (vs the pre-refactor inlined engine): admissions are
planned from the post-control view, so on the rare control-boundary
cycle a resume is routed against the *updated* ``B_prefill`` (the old
code read the pre-update value); and an all-stale prefill queue no
longer triggers the opportunistic-reclaim slot bind.  Neither changes a
single emitted token — the golden-trace tests pin that.

Every executed plan is appended to the engine's ``PlanJournal``;
``ReplayPlanner`` feeds a recorded journal back through the dispatcher,
reproducing a run's token events deterministically (wall-clock
decisions — control timing, megastep sizing, admission readiness — are
all *inside* the recorded plans, so replay never consults the clock).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core.phases import Phase, PhaseThresholds, classify

# Session lifecycle states, mirrored from serving.request.SessionState
# values (the core layer stays import-free of serving):
S_WAITING = "waiting_prefill"
S_PREFILLING = "prefilling"
S_DECODING = "decoding"
S_TOOL_CALL = "tool_call"
S_TOOL_WAIT = "tool_wait"
S_PAUSED = "prefill_paused"
S_FINISHED = "finished"

INTERACTIVE = "interactive"          # SLO classes (PriorityPlanner)
BATCH = "batch"
SLO_CLASSES = (INTERACTIVE, BATCH)

# below this per-session acceptance EMA the planner stops issuing
# draft-and-verify plans (the extra verify positions cost more than the
# accepted drafts save) and falls back to plain/megastep decode
SPEC_EMA_FLOOR = 0.25
# per-plain-token EMA creep applied by the engine while a session is
# demoted: crossing the floor again triggers a cheap re-probe (a failed
# probe decays straight back; a successful one re-engages drafting)
SPEC_EMA_RECOVERY = 0.002


# ---------------------------------------------------------------------------
# the immutable view
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SessionView:
    """One session's scheduling-relevant state (no tokens, no tensors)."""
    session_id: int
    state: str                       # SessionState value
    slot: int
    turn_idx: int
    num_turns: int
    cached_len: int
    prefill_done: int
    turn_prefill_len: int            # len(current_turn.prefill_tokens)
    decode_len: int                  # current turn's decode burst length
    decoded: int
    shared_prefix_len: int
    ready_s: float
    slo: str = BATCH
    prefix_hit_len: int = 0          # non-mutating prefix-cache probe
    paused_seq: int = -1             # preemption order stamp (PAUSED only)
    deadline_s: float = float("inf")  # absolute SLO deadline (the engine
    #                                   aborts past it; planners may order
    #                                   admissions by urgency)
    spec_ema: float = 1.0            # draft-acceptance EMA (1.0 until the
    #                                  first speculative window lands)

    @property
    def remaining_prefill(self) -> int:
        return self.turn_prefill_len - self.prefill_done

    @property
    def total_prompt_len(self) -> int:
        return self.cached_len + self.turn_prefill_len

    def aligned_remaining(self, prefill_done: Optional[int] = None,
                          cached_len: Optional[int] = None) -> int:
        """Remaining prefill capped at the shared-prefix boundary (so the
        prefix snapshot is taken at exactly that length); overridable
        counters let the prefill simulation advance a session."""
        done = self.prefill_done if prefill_done is None else prefill_done
        cached = self.cached_len if cached_len is None else cached_len
        rem = self.turn_prefill_len - done
        if (self.turn_idx == 0 and done < self.shared_prefix_len
                and cached < self.shared_prefix_len):
            rem = min(rem, self.shared_prefix_len - done)
        return rem


@dataclasses.dataclass(frozen=True)
class JobView:
    """One queued admission-queue entry."""
    session_id: int
    phase: Phase
    new_len: int


@dataclasses.dataclass(frozen=True)
class EngineView:
    """Immutable snapshot a planner sees — and nothing else."""
    now: float                       # engine clock at cycle start
    next_ctrl: float                 # next control boundary (post-advance)
    tpot_step_ms: float              # controller's TPOT estimate
    r_min: int                       # decode reservation (post-update)
    b_prefill: int                   # resume-prefill admission budget
    cycle_budget: int                # C
    granularity: int                 # g
    r_base: int                      # controller floor (reclaim binds here)
    max_seq: int
    free_slots: int
    slot_lengths: Tuple[int, ...]    # KV pool lengths per slot
    sessions: Tuple[SessionView, ...]        # registry insertion order
    q_decode: Tuple[JobView, ...]
    q_prefill: Tuple[JobView, ...]
    buckets: Tuple[int, ...]         # warmed resume token buckets
    resume_levels: Tuple[int, ...]   # warmed resume batch sizes M
    cold_levels: Tuple[int, ...]     # warmed cold-pack batch sizes
    megastep_levels: Tuple[int, ...] # warmed megastep K grid (() = none)
    chunk_tok_s: Mapping[int, float] = dataclasses.field(
        default_factory=dict)        # autotuned chunk -> tok/s (read-only)
    autotune: bool = True
    min_cached_fraction: float = 0.5
    resume_max_new: int = 1024
    spec_levels: Tuple[int, ...] = ()  # warmed draft-verify K grid (() = off)

    def session(self, sid: int) -> SessionView:
        return self._by_id[sid]

    def __post_init__(self):
        object.__setattr__(self, "_by_id",
                           {s.session_id: s for s in self.sessions})


# ---------------------------------------------------------------------------
# the declarative plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ControlAction:
    """Control-boundary decision: host-sync the decode window (fresh
    TPOT) and optionally run the Algorithm-1 update."""
    flush: bool = False
    update: bool = False


@dataclasses.dataclass(frozen=True)
class Admission:
    """Admit one ready session and route its job."""
    session_id: int
    phase: Phase
    to_decode_queue: bool            # Q_D (in-budget resume) vs Q_P
    unpark: bool = False             # parked session: restore KV first
    restore_prefix: bool = False     # planner's peek saw a prefix hit
    #                                  (journal/debug — the dispatcher
    #                                  always probes at admission so the
    #                                  pool's hit/miss + LRU accounting
    #                                  happens exactly once)


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """Dispatch one decode step over these sessions.  ``megastep_target``
    is the K the planner wants fused (0 = don't attempt a megastep; the
    dispatcher still clamps K to the live burst/capacity bounds).
    ``spec_k`` is the draft-and-verify width: one multi-query verify
    forward covering up to ``spec_k`` tokens per lane (0 = plain decode;
    mutually exclusive with ``megastep_target``)."""
    session_ids: Tuple[int, ...]
    megastep_target: int = 0
    spec_k: int = 0


@dataclasses.dataclass(frozen=True)
class ResumePlan:
    """Batched resume-prefill composition: M sessions, one [M, bucket]
    executable (M is already rounded to a warmed batch size)."""
    session_ids: Tuple[int, ...]
    bucket: int


@dataclasses.dataclass(frozen=True)
class ColdOp:
    """One prefill-stream operation.

    kind: "whole" (run the session's prompt to completion — FCFS),
          "pack"  (M sessions into one [M, bucket] batched executable),
          "chunk" (``reps`` dispatches of a ``shape``-token chunk to one
                   session).
    fn_src: which warmed executable serves the chunk — "slot" (the
          cycle's bound slot executable), "slot_full" (the full-budget
          reclaim slot), "tuned" (autotune-table chunk executable), or
          "default" (the shared batch-1 prefill)."""
    kind: str
    session_ids: Tuple[int, ...]
    shape: int
    reps: int = 1
    fn_src: str = "default"
    reclaim: bool = False            # opportunistic full-budget pass


@dataclasses.dataclass(frozen=True)
class CyclePlan:
    """Everything one engine cycle will do, decided up front.

    ``plan_id`` is the telemetry/journal correlation key: the engine
    stamps it with the cycle index at execution time when it is still
    the -1 sentinel, and leaves recorded ids untouched — so a
    ``ReplayPlanner`` run re-executes plans under their *original* ids
    and its exported timeline can be diffed span-for-span against the
    source run's."""
    control: ControlAction = ControlAction()
    plan_id: int = -1                # stamped by the engine at execution
    slot_level: int = 0              # decode-reservation level to bind
    admissions: Tuple[Admission, ...] = ()
    preempt: Tuple[int, ...] = ()    # suspend these cold prefills
    unsuspend: Tuple[int, ...] = ()  # resume these suspended prefills
    decode: Optional[DecodePlan] = None
    flush_idle: bool = False         # no active decoders: sync the window
    resume: Optional[ResumePlan] = None
    prefill: Tuple[ColdOp, ...] = ()


# ---------------------------------------------------------------------------
# policy configuration (construction-time knobs + semantic defaults)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PolicySpec:
    """Per-policy configuration.

    The scheduling *semantics* live in the planner classes below; the
    spec carries their tunables plus the construction-time knobs the
    engine needs before any plan exists (which executable shapes to
    warm, whether slots are pre-established)."""
    name: str
    adaptive: bool = False            # run Algorithm 1 feedback
    split_phases: bool = False        # distinguish cold vs resume
    resume_to_decode_queue: bool = False  # fuse in-budget resumes into Q_D
    protect_decode: bool = True       # decode step every cycle
    chunk_by_slots: bool = False      # prefill chunk = slot partition share
    fixed_chunk_frac: float = 0.5     # when not slot-driven: share of budget
    whole_prefill: bool = False       # fcfs: run prefill to completion
    preestablish: bool = True         # pre-build slot executables
    static_r_frac: float = 0.5        # static decode reservation share
    cache_aware: bool = False         # admission order favours sessions
    #                                   with the longest reusable cached
    #                                   prefix (radix prefix cache,
    #                                   DESIGN.md §13) — a 90%-cached
    #                                   cold is effectively a resume and
    #                                   should get a slot first


def quantize_up(target: int, total: int, g: int) -> int:
    """Round a reservation up to the slot grid (Assumption 2)."""
    target = max(min(target, total), g)
    return -(-target // g) * g


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if b >= n:
            return b
    return buckets[-1]


def bucket_down(n: int, buckets: Sequence[int]) -> Optional[int]:
    best = None
    for b in buckets:
        if b <= n:
            best = b
    return best


# ---------------------------------------------------------------------------
# the planner strategy interface + shared machinery
# ---------------------------------------------------------------------------

class CyclePlanner:
    """Base planner: the dual-queue, slot-partitioned cycle shared by
    every policy.  Subclasses pin one policy each and override the
    decision hooks (`admits_resumes_to_decode`, `allow_decode`,
    `prefill_mode`, admission ordering, preemption).  Instances are
    stateless beyond their spec — ``plan`` is a pure function of the
    view."""

    def __init__(self, spec: PolicySpec):
        self.spec = spec

    # ---- identity ------------------------------------------------------
    @property
    def name(self) -> str:
        return self.spec.name

    @property
    def adaptive(self) -> bool:
        return self.spec.adaptive

    # ---- run-start partition (non-adaptive policies) -------------------
    def static_r_min(self, total: int, g: int) -> Optional[int]:
        """Static decode reservation for non-adaptive policies (engine
        applies it once at run start), or None to leave the controller's
        initial point."""
        if self.adaptive:
            return None
        return max(g, int(self.spec.static_r_frac * total) // g * g)

    # ---- stage 1: the control boundary --------------------------------
    def plan_control(self, now: float, next_ctrl: float) -> ControlAction:
        due = now >= next_ctrl
        return ControlAction(flush=due, update=due and self.adaptive)

    # ---- stage 2: the cycle body --------------------------------------
    def plan(self, view: EngineView) -> CyclePlan:
        sim = _SimState(view)
        preempt = self.plan_preemptions(view, sim)
        admissions = self.plan_admissions(view, sim)
        slot_level = quantize_up(view.r_min, view.cycle_budget,
                                 view.granularity)
        decode, flush_idle = self.plan_decode(view, sim)
        resume = self.plan_resume(view, sim)
        prefill = self.plan_prefill(view, sim, slot_level)
        unsuspend = self.plan_unsuspend(view, sim)
        return CyclePlan(slot_level=slot_level, admissions=admissions,
                         preempt=preempt, unsuspend=unsuspend,
                         decode=decode, flush_idle=flush_idle,
                         resume=resume, prefill=prefill)

    # ---- admission -----------------------------------------------------
    def admission_order(self, candidates: List[SessionView],
                        ) -> List[SessionView]:
        """Service order for ready sessions (registry order by default)."""
        return candidates

    def classify_phase(self, sv: SessionView, cached: int,
                       new_len: int, view: EngineView) -> Phase:
        if not self.spec.split_phases:
            return Phase.COLD_PREFILL          # phase-blind baseline
        thr = PhaseThresholds(
            min_cached_fraction=view.min_cached_fraction,
            resume_max_new=view.resume_max_new)
        return classify(cached + sv.turn_prefill_len, cached, new_len, thr)

    def route_to_decode_queue(self, phase: Phase, new_len: int,
                              view: EngineView) -> bool:
        """Algorithm 1 lines 10-15: in-budget resumes join Q_D."""
        if not self.spec.resume_to_decode_queue:
            return False
        return (phase == Phase.RESUME_PREFILL
                and new_len <= view.b_prefill)

    def plan_admissions(self, view: EngineView, sim: "_SimState",
                        ) -> Tuple[Admission, ...]:
        ready = [sv for sv in view.sessions
                 if ((sv.state == S_WAITING or sv.state == S_TOOL_CALL)
                     and sv.ready_s <= view.now
                     and sv.deadline_s > view.now)]   # expired: engine
        #                                               aborts, not admits
        out: List[Admission] = []
        for sv in self.admission_order(ready):
            needs_slot = sv.state == S_WAITING or sv.slot < 0
            if needs_slot:
                if sim.free_slots == 0:
                    continue                   # backpressure: retry next cycle
                sim.free_slots -= 1
            restore = (sv.state == S_WAITING and sv.prefix_hit_len > 0)
            cached = sv.prefix_hit_len if restore else sv.cached_len
            done = sv.prefix_hit_len if restore else sv.prefill_done
            new_len = sv.turn_prefill_len - done
            phase = self.classify_phase(sv, cached, new_len, view)
            to_qd = self.route_to_decode_queue(phase, new_len, view)
            adm = Admission(session_id=sv.session_id, phase=phase,
                            to_decode_queue=to_qd,
                            unpark=sv.state == S_TOOL_CALL and sv.slot < 0,
                            restore_prefix=restore)
            out.append(adm)
            sim.admit(sv, adm, done, cached, new_len)
        return tuple(out)

    # ---- decode --------------------------------------------------------
    def allow_decode(self, view: EngineView, sim: "_SimState") -> bool:
        return self.spec.protect_decode or sim.q_p_len == 0

    def plan_decode(self, view: EngineView, sim: "_SimState",
                    ) -> Tuple[Optional[DecodePlan], bool]:
        active = [sv for sv in view.sessions if sv.state == S_DECODING]
        if not active:
            return None, True                  # sync any in-flight window
        if not self.allow_decode(view, sim):
            return None, False
        target = 0
        spec = 0
        quiet = sim.q_d_len == 0 and sim.q_p_len == 0
        if (view.spec_levels and quiet):
            # draft-and-verify: one verify forward emits up to K tokens
            # per lane.  Engage the largest warmed level that fits the
            # shortest live burst (the dispatcher re-clamps), but only
            # while the worst per-session acceptance EMA says drafting
            # pays for the extra verify positions.
            k_alive = min(sv.decode_len - sv.decoded for sv in active)
            k_cap = max(1, view.max_seq - 1
                        - max(view.slot_lengths[sv.slot] for sv in active))
            ema = min(sv.spec_ema for sv in active)
            fit = [lv for lv in view.spec_levels
                   if lv <= min(k_alive, k_cap)]
            if fit and ema >= SPEC_EMA_FLOOR:
                spec = max(fit)
        if spec == 0 and (view.megastep_levels and quiet):
            k_alive = min(sv.decode_len - sv.decoded for sv in active)
            k_cap = max(1, view.max_seq - 1
                        - max(view.slot_lengths[sv.slot] for sv in active))
            k_fit = k_alive
            tpot_s = view.tpot_step_ms / 1000.0
            if tpot_s > 0:
                k_fit = max(1, int((view.next_ctrl - view.now) / tpot_s))
            target = min(k_alive, k_cap, k_fit)
        return DecodePlan(
            session_ids=tuple(sv.session_id for sv in active),
            megastep_target=target, spec_k=spec), False

    # ---- batched resume prefills --------------------------------------
    def plan_resume(self, view: EngineView, sim: "_SimState",
                    ) -> Optional[ResumePlan]:
        if not self.spec.resume_to_decode_queue or not sim.q_d:
            return None
        eligible: List[SessionView] = []
        for job in sim.q_d:
            if len(eligible) >= view.resume_levels[-1]:
                break
            sv = sim.sv(job.session_id)
            if (sim.state(job.session_id) == S_PREFILLING
                    and sim.remaining(job.session_id) > 0):
                eligible.append(sv)
        if not eligible:
            return None
        m = max(lv for lv in view.resume_levels if lv <= len(eligible))
        chosen = eligible[:m]
        bucket = view.buckets[0]
        for sv in chosen:
            aligned = sim.aligned(sv.session_id)
            bucket = max(bucket, bucket_for(max(aligned, 1), view.buckets))
        for sv in chosen:
            # completions join the decode stream — the reclaim pass and
            # later plan stages must see them as decoding
            sim.apply_prefill(sv.session_id, bucket)
        return ResumePlan(
            session_ids=tuple(sv.session_id for sv in chosen),
            bucket=bucket)

    # ---- prefill stream ------------------------------------------------
    def prefill_mode(self, view: EngineView, slot_level: int):
        """(mode, budget) — "whole" | ("slot", C - level) | ("fixed", n)."""
        if self.spec.whole_prefill:
            return "whole", None
        if self.spec.chunk_by_slots:
            return "slot", view.cycle_budget - slot_level
        g = view.granularity
        c = int(self.spec.fixed_chunk_frac * view.cycle_budget)
        return "fixed", max(g, (c // g) * g)

    def tuned_chunk(self, view: EngineView, budget: int,
                    ) -> Tuple[int, int, bool]:
        """(chunk, reps, tuned): the measured-fastest warmed chunk ≤
        budget (>10% margin over the full budget — timing-noise guard),
        or (budget, 1, False) when autotune is off / nothing warmed."""
        table = view.chunk_tok_s
        if not view.autotune or not table:
            return budget, 1, False
        cands = [c for c in table if c <= budget]
        if not cands:
            return budget, 1, False
        full = max(cands)
        best = max(cands, key=lambda c: table[c])
        chunk = best if table[best] > 1.10 * table[full] else full
        reps = max(1, min(budget // chunk, 4))
        return chunk, reps, True

    def prefill_queue_order(self, jobs: List[JobView], sim: "_SimState",
                            ) -> List[JobView]:
        """Service order over the prefill stream (FIFO by default)."""
        return jobs

    # ---- fluid-simulator semantics (serving/simulator.py) --------------
    def sim_prefill_order(self, resumes: Sequence, colds: Sequence, *,
                          arrival, slo=None) -> List:
        """Service order over the fluid simulator's prefill backlog —
        the same policy semantics the engine planner applies through its
        queues: phase-split policies serve resumes first, phase-blind
        policies serve in arrival order.  ``arrival``/``slo`` are
        accessors over the caller's session objects."""
        if not self.spec.split_phases:
            return sorted(list(resumes) + list(colds), key=arrival)
        return list(resumes) + list(colds)

    def plan_prefill(self, view: EngineView, sim: "_SimState",
                     slot_level: int) -> Tuple[ColdOp, ...]:
        mode, budget = self.prefill_mode(view, slot_level)
        sim.q_p = self.prefill_queue_order(sim.q_p, sim)
        ops: List[ColdOp] = []
        if mode == "whole":
            op = self._sim_whole(view, sim)
            return (op,) if op else ()
        fn_src = "slot" if mode == "slot" else "default"
        op = self._sim_stream_op(view, sim, budget, fn_src)
        if op:
            ops.append(op)
        if (mode == "slot" and not sim.any_decoding_started
                and not any(sv.state == S_DECODING for sv in view.sessions)):
            # opportunistic reclaim (paper §III-C): no decode demand, the
            # prefill stream claims the full cycle budget
            full_budget = view.cycle_budget - quantize_up(
                view.r_base, view.cycle_budget, view.granularity)
            for _ in range(3):
                if not sim.q_p or sim.any_decoding_started:
                    break
                rop = self._sim_stream_op(view, sim, full_budget,
                                          "slot_full", reclaim=True)
                if rop is None:
                    break
                ops.append(rop)
        return tuple(ops)

    def plan_preemptions(self, view: EngineView, sim: "_SimState",
                         ) -> Tuple[int, ...]:
        return ()

    def plan_unsuspend(self, view: EngineView, sim: "_SimState",
                       ) -> Tuple[int, ...]:
        return ()

    # ---- prefill simulation helpers ------------------------------------
    def _sim_whole(self, view: EngineView, sim: "_SimState",
                   ) -> Optional[ColdOp]:
        sim.drop_stale_heads()
        if not sim.q_p:
            return None
        sid = sim.q_p[0].session_id
        sim.run_to_completion(sid)
        sim.q_p.pop(0)
        return ColdOp(kind="whole", session_ids=(sid,),
                      shape=view.buckets[-1])

    def _sim_stream_op(self, view: EngineView, sim: "_SimState",
                       budget: int, fn_src: str, reclaim: bool = False,
                       ) -> Optional[ColdOp]:
        sim.drop_stale_heads()
        if not sim.q_p or budget is None or budget <= 0:
            return None
        pack = self._sim_pack(view, sim, budget, reclaim)
        if pack is not None:
            return pack
        sid = sim.q_p[0].session_id
        chunk, reps, tuned = self.tuned_chunk(view, budget)
        done_reps = 0
        for _ in range(reps):
            if sim.state(sid) != S_PREFILLING:
                break
            sim.apply_prefill(sid, chunk)
            done_reps += 1
        if sim.state(sid) != S_PREFILLING:
            sim.q_p.pop(0)
        return ColdOp(kind="chunk", session_ids=(sid,), shape=chunk,
                      reps=reps, fn_src="tuned" if tuned else fn_src,
                      reclaim=reclaim)

    def _sim_pack(self, view: EngineView, sim: "_SimState", budget: int,
                  reclaim: bool) -> Optional[ColdOp]:
        """Mirror of the engine's cold-pack selection: the first M
        pending prefills into one [M, bucket] executable with bucket·M ≤
        the budget (stale entries scanned along the way are dropped)."""
        if not view.cold_levels:
            return None
        chosen: List[int] = []
        scan = 0
        while scan < len(sim.q_p) and len(chosen) < view.cold_levels[-1]:
            job = sim.q_p[scan]
            if sim.state(job.session_id) != S_PREFILLING:
                sim.q_p.pop(scan)              # stale: dropped by the scan
                continue
            chosen.append(job.session_id)
            scan += 1
        m = bucket = None
        if len(chosen) >= 2:
            for lv in reversed(view.cold_levels):
                if lv <= len(chosen):
                    b = bucket_down(budget // lv, view.buckets)
                    if b is not None:
                        need = max(sim.aligned(sid) for sid in chosen[:lv])
                        m = lv
                        bucket = min(b, bucket_for(need, view.buckets))
                        break
        if m is None:
            return None
        sids = chosen[:m]
        for sid in sids:
            sim.apply_prefill(sid, bucket)
        # queue update: the packed jobs leave their positions; unfinished
        # ones return to the head in order
        sid_set = set(sids)
        rest = [j for j in sim.q_p if j.session_id not in sid_set]
        back = [j for j in sim.q_p if j.session_id in sid_set
                and sim.state(j.session_id) == S_PREFILLING]
        sim.q_p = back + rest
        return ColdOp(kind="pack", session_ids=tuple(sids), shape=bucket,
                      fn_src="pack", reclaim=reclaim)


class _SimState:
    """Mutable cycle simulation the planner threads through its stages:
    queue contents and per-session prefill counters evolve exactly as
    the dispatcher will evolve them, so later plan stages see the state
    earlier stages produce.  Purely host arithmetic — no device state,
    no clocks."""

    def __init__(self, view: EngineView):
        self.view = view
        self.free_slots = view.free_slots
        self.q_d: List[JobView] = list(view.q_decode)
        self.q_p: List[JobView] = list(view.q_prefill)
        self._state: Dict[int, str] = {
            sv.session_id: sv.state for sv in view.sessions}
        self._done: Dict[int, int] = {
            sv.session_id: sv.prefill_done for sv in view.sessions}
        self._cached: Dict[int, int] = {
            sv.session_id: sv.cached_len for sv in view.sessions}
        self.any_decoding_started = False

    @property
    def q_d_len(self) -> int:
        return len(self.q_d)

    @property
    def q_p_len(self) -> int:
        return len(self.q_p)

    def sv(self, sid: int) -> SessionView:
        return self.view.session(sid)

    def state(self, sid: int) -> str:
        return self._state[sid]

    def remaining(self, sid: int) -> int:
        return self.sv(sid).turn_prefill_len - self._done[sid]

    def aligned(self, sid: int) -> int:
        return self.sv(sid).aligned_remaining(self._done[sid],
                                              self._cached[sid])

    def admit(self, sv: SessionView, adm: Admission, done: int,
              cached: int, new_len: int) -> None:
        self._state[sv.session_id] = S_PREFILLING
        self._done[sv.session_id] = done
        self._cached[sv.session_id] = cached
        job = JobView(session_id=sv.session_id, phase=adm.phase,
                      new_len=new_len)
        (self.q_d if adm.to_decode_queue else self.q_p).append(job)

    def suspend(self, sid: int) -> None:
        self._state[sid] = S_PAUSED
        self.q_p = [j for j in self.q_p if j.session_id != sid]
        self.free_slots += 1

    def apply_prefill(self, sid: int, shape: int) -> None:
        take = min(shape, self.aligned(sid))
        if take <= 0:
            return
        self._done[sid] += take
        self._cached[sid] += take
        if self.remaining(sid) == 0:
            self._state[sid] = S_DECODING
            self.any_decoding_started = True

    def run_to_completion(self, sid: int) -> None:
        while self.state(sid) == S_PREFILLING and self.remaining(sid) > 0:
            self.apply_prefill(sid, self.view.buckets[-1])
        self._state[sid] = S_DECODING
        self.any_decoding_started = True

    def drop_stale_heads(self) -> None:
        while self.q_p and self.state(self.q_p[0].session_id) \
                != S_PREFILLING:
            self.q_p.pop(0)


# ---------------------------------------------------------------------------
# one planner class per policy
# ---------------------------------------------------------------------------

class AgentServePlanner(CyclePlanner):
    """The paper's policy: phase split, in-budget resumes fused into the
    decode stream, cold prefills chunked by the adaptive slot partition,
    Algorithm-1 feedback, pre-established slots.  With ``cache_aware``
    set, admissions additionally favour the longest reusable cached
    prefix: under slot scarcity the near-free (mostly-cached) prefills
    get slots first, maximizing bytes served from the radix prefix
    cache per unit of prefill budget."""

    def admission_order(self, candidates: List[SessionView],
                        ) -> List[SessionView]:
        if not self.spec.cache_aware:
            return candidates
        # stable sort: sessions with no probed hit keep registry
        # (arrival) order, so cache-awareness only reorders when the
        # prefix cache actually has something to offer
        return sorted(candidates, key=lambda sv: -sv.prefix_hit_len)


class NoAlgPlanner(AgentServePlanner):
    """AgentServe minus Algorithm 1: the partition is frozen at the
    static point (§IV-D No-Alg ablation)."""


class NoGreenPlanner(AgentServePlanner):
    """AgentServe minus pre-established slots: identical plans; the
    engine constructs executables on demand inside the serving path (the
    cost the ablation measures)."""


class PDStaticPlanner(CyclePlanner):
    """SGLang-style PD disaggregation: decode protected behind a
    *static* partition; all prefills (cold and resume) share one FIFO
    prefill queue."""


class ChunkedPlanner(CyclePlanner):
    """vLLM-style chunked prefill + continuous batching: a fixed chunk
    budget mixed with decodes every cycle, phase-blind FIFO."""


class FCFSPlanner(CyclePlanner):
    """llama.cpp-style strict arrival order: a prefill runs to
    completion before any decode proceeds (the head-of-line-blocking
    baseline)."""


class PriorityPlanner(AgentServePlanner):
    """SLO-class scheduling: ``interactive`` sessions pre-empt ``batch``
    cold prefills.

    Extensions over AgentServe (all pure view logic):

    * admissions serve interactive-class sessions first;
    * when an interactive session is ready but the KV pool has no free
      slot, the batch-class cold prefill with the most remaining work is
      *suspended at a chunk boundary*: its KV rows stay resident on
      device through the existing park/unpark machinery, its slot is
      freed for the interactive request, and its queue entry is pulled;
    * the prefill stream serves interactive jobs ahead of batch jobs;
    * once no interactive demand is waiting and a slot is free, the
      oldest suspended prefill is resumed (unparked into a fresh slot,
      bit-identical state) and re-queued.
    """

    def admission_order(self, candidates: List[SessionView],
                        ) -> List[SessionView]:
        # interactive first; within a class, earliest deadline first,
        # then longest reusable cached prefix (stable: all-inf
        # deadlines + zero hits preserve registry order)
        return sorted(candidates,
                      key=lambda sv: (0 if sv.slo == INTERACTIVE else 1,
                                      sv.deadline_s,
                                      -sv.prefix_hit_len
                                      if self.spec.cache_aware else 0))

    def prefill_queue_order(self, jobs: List[JobView], sim: "_SimState",
                            ) -> List[JobView]:
        return ([j for j in jobs if sim.sv(j.session_id).slo == INTERACTIVE]
                + [j for j in jobs
                   if sim.sv(j.session_id).slo != INTERACTIVE])

    def sim_prefill_order(self, resumes: Sequence, colds: Sequence, *,
                          arrival, slo=None) -> List:
        ordered = super().sim_prefill_order(resumes, colds,
                                            arrival=arrival, slo=slo)
        if slo is None:
            return ordered
        return ([s for s in ordered if slo(s) == INTERACTIVE]
                + [s for s in ordered if slo(s) != INTERACTIVE])

    def _interactive_demand(self, view: EngineView, sim: "_SimState",
                            ) -> int:
        """Interactive sessions ready now but needing a KV slot."""
        return sum(1 for sv in view.sessions
                   if sv.slo == INTERACTIVE and sv.ready_s <= view.now
                   and (sv.state == S_WAITING
                        or (sv.state == S_TOOL_CALL and sv.slot < 0)))

    def plan_preemptions(self, view: EngineView, sim: "_SimState",
                         ) -> Tuple[int, ...]:
        need = self._interactive_demand(view, sim) - sim.free_slots
        if need <= 0:
            return ()
        # cold-only invariant: an over-budget resume routed to Q_P keeps
        # its RESUME_PREFILL phase and is never a preemption victim
        cold_sids = {j.session_id for j in view.q_prefill
                     if j.phase == Phase.COLD_PREFILL}
        victims = sorted(
            (sv for sv in view.sessions
             if sv.slo != INTERACTIVE and sv.state == S_PREFILLING
             and sv.slot >= 0 and sv.session_id in cold_sids
             and sv.remaining_prefill > 0),
            key=lambda sv: -sv.remaining_prefill)
        out = []
        for sv in victims[:need]:
            out.append(sv.session_id)
            sim.suspend(sv.session_id)
        return tuple(out)

    def plan_unsuspend(self, view: EngineView, sim: "_SimState",
                       ) -> Tuple[int, ...]:
        if sim.free_slots <= 0 or self._interactive_demand(view, sim) > 0:
            return ()
        paused = [sv for sv in view.sessions
                  if sim.state(sv.session_id) == S_PAUSED]
        if not paused:
            return ()
        sv = min(paused, key=lambda v: v.paused_seq)  # oldest suspension
        sim.free_slots -= 1
        return (sv.session_id,)


# ---------------------------------------------------------------------------
# journal + deterministic replay
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CycleRecord:
    """One executed cycle: the plan plus its observable outcome."""
    cycle: int
    plan: CyclePlan
    events: int = 0                  # token events this cycle emitted
    did_work: bool = False


@dataclasses.dataclass
class PlanJournal:
    """Record of every executed ``CyclePlan`` (bounded).  Feed it to a
    ``ReplayPlanner`` to re-execute a run deterministically, or to
    ``summary()`` for per-policy reporting."""
    max_records: int = 200_000
    records: List[CycleRecord] = dataclasses.field(default_factory=list)
    dropped: int = 0

    def record(self, rec: CycleRecord) -> None:
        if len(self.records) < self.max_records:
            self.records.append(rec)
        else:
            self.dropped += 1

    def summary(self) -> Dict[str, float]:
        chunks: List[int] = []
        preemptions = resumes = admissions = packs = megasteps = 0
        decode_cycles = resume_batches = spec_cycles = 0
        for r in self.records:
            p = r.plan
            preemptions += len(p.preempt)
            resumes += len(p.unsuspend)
            admissions += len(p.admissions)
            if p.decode is not None:
                decode_cycles += 1
                if p.decode.megastep_target > 1:
                    megasteps += 1
                if getattr(p.decode, "spec_k", 0) > 1:
                    spec_cycles += 1
            if p.resume is not None:
                resume_batches += 1
            for op in p.prefill:
                if op.kind == "pack":
                    packs += 1
                    chunks.extend([op.shape] * len(op.session_ids))
                elif op.kind == "chunk":
                    chunks.extend([op.shape] * op.reps)
        return dict(
            cycles=float(len(self.records)),
            dropped=float(self.dropped),
            admissions=float(admissions),
            decode_cycles=float(decode_cycles),
            megastep_cycles=float(megasteps),
            spec_cycles=float(spec_cycles),
            resume_batches=float(resume_batches),
            cold_packs=float(packs),
            preemptions=float(preemptions),
            preempt_resumes=float(resumes),
            mean_chunk=float(sum(chunks) / len(chunks)) if chunks else 0.0)


class ReplayPlanner:
    """Plays a recorded journal back through the dispatcher.

    Every wall-clock-dependent decision (control boundaries, megastep
    sizing, admission readiness) is inside the recorded plans, and the
    dispatcher never consults the clock for correctness, so replaying a
    journal against the same attached workload reproduces the original
    run's token events exactly — the golden-trace debugging loop."""

    def __init__(self, journal: PlanJournal,
                 spec: Optional[PolicySpec] = None):
        self._records = journal.records
        self._i = -1
        self.spec = spec or PolicySpec(name="replay")

    @property
    def name(self) -> str:
        return f"replay:{self.spec.name}"

    @property
    def adaptive(self) -> bool:
        return False

    def static_r_min(self, total: int, g: int) -> Optional[int]:
        return None                   # partition comes from recorded plans

    def exhausted(self) -> bool:
        return self._i + 1 >= len(self._records)

    def plan_control(self, now: float, next_ctrl: float) -> ControlAction:
        self._i += 1
        if self._i >= len(self._records):
            raise RuntimeError(
                f"replay journal exhausted after {len(self._records)} "
                f"cycles — the run diverged from the recording")
        return self._records[self._i].plan.control

    def plan(self, view: EngineView) -> CyclePlan:
        return self._records[self._i].plan


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

PLANNER_CLASSES: Dict[str, type] = {
    "agentserve": AgentServePlanner,
    "pd_static": PDStaticPlanner,
    "chunked": ChunkedPlanner,
    "fcfs": FCFSPlanner,
    "no_alg": NoAlgPlanner,
    "no_green": NoGreenPlanner,
    "priority": PriorityPlanner,
}


def make_planner(spec: PolicySpec) -> CyclePlanner:
    """Planner for a spec: by registered name, else inferred from the
    spec's shape (custom specs, e.g. fig7's static-partition sweeps).
    Spec-only by design — resolving policy *names* needs the named-spec
    registry, which lives in ``repro_torch.serving.policies.make_planner``."""
    if not isinstance(spec, PolicySpec):
        raise TypeError(
            f"expected a PolicySpec, got {spec!r}; to resolve a policy "
            f"name use repro_torch.serving.policies.make_planner")
    cls = PLANNER_CLASSES.get(spec.name)
    if cls is None:
        if spec.whole_prefill:
            cls = FCFSPlanner
        elif not spec.chunk_by_slots:
            cls = ChunkedPlanner
        elif spec.resume_to_decode_queue:
            cls = AgentServePlanner if spec.adaptive else NoAlgPlanner
        else:
            cls = PDStaticPlanner
    return cls(spec)
