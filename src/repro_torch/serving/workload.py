"""ToolBench-like agent workload generators (paper §IV-A, Table I).

Two paradigms, with token distributions matching Table I:

  ReAct           cold 2.5k-3.5k | resume 30-127 (avg 56)  | decode 27-127
  Plan-and-Execute cold 2.5k-3.5k | resume 125-421 (avg 251)| decode 33-141

``token_scale`` shrinks every length by a constant factor so the same
session *structure* runs against CPU mini-models in bounded wall time
(DESIGN.md §7.3); scale=1.0 reproduces Table I exactly (validated by
benchmarks/table1_tokens.py).

Sessions within a run share one of ``num_system_prompts`` system prompts
(tool specs are per-deployment, not per-session) — this is what makes
cross-session prefix caching meaningful.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.serving.request import AgentTurn, Session


@dataclasses.dataclass
class WorkloadSpec:
    name: str
    cold_range: tuple = (2500, 3500)
    resume_range: tuple = (30, 127)
    resume_mean: float = 56.0
    decode_range: tuple = (27, 127)
    decode_mean: float = 40.0
    turns_range: tuple = (3, 7)
    tool_latency_range_s: tuple = (0.05, 0.3)


REACT = WorkloadSpec(
    name="react",
    resume_range=(30, 127), resume_mean=56.0,
    decode_range=(27, 127), decode_mean=40.0,
    turns_range=(4, 8),
)

PLAN_EXECUTE = WorkloadSpec(
    name="plan_execute",
    resume_range=(125, 421), resume_mean=251.0,
    decode_range=(33, 141), decode_mean=60.0,
    turns_range=(2, 5),
)

SPECS = {"react": REACT, "plan_execute": PLAN_EXECUTE}


def _clipped_lognormal(rng, lo, hi, mean, size=None):
    """Right-skewed lengths in [lo, hi] with the requested mean — matches
    the 'short typical, long tail' shape of tool outputs."""
    mu = np.log(max(mean - lo, 1.0))
    x = lo + np.exp(rng.normal(mu, 0.55, size=size))
    return np.clip(np.round(x), lo, hi).astype(int)


def make_session(session_id: int, spec: WorkloadSpec, rng: np.random.Generator,
                 vocab_size: int, *, token_scale: float = 1.0,
                 system_prompt: Optional[np.ndarray] = None) -> Session:
    def scale(n):
        return max(1, int(round(n * token_scale)))

    cold_len = scale(rng.integers(*spec.cold_range))
    shared_len = 0
    if system_prompt is not None:
        sys_part = system_prompt[:cold_len]
        shared_len = len(sys_part)
        user_part = rng.integers(0, vocab_size, size=max(cold_len // 8, 1))
        cold_tokens = np.concatenate([sys_part, user_part]).astype(np.int32)
    else:
        cold_tokens = rng.integers(0, vocab_size, size=cold_len,
                                   dtype=np.int32)

    n_turns = int(rng.integers(*spec.turns_range))
    turns: List[AgentTurn] = [AgentTurn(
        prefill_tokens=cold_tokens,
        decode_len=scale(_clipped_lognormal(
            rng, *spec.decode_range, spec.decode_mean)),
        tool_latency_s=float(rng.uniform(*spec.tool_latency_range_s)),
    )]
    for _ in range(n_turns - 1):
        r_len = scale(_clipped_lognormal(
            rng, *spec.resume_range, spec.resume_mean))
        turns.append(AgentTurn(
            prefill_tokens=rng.integers(0, vocab_size, size=r_len,
                                        dtype=np.int32),
            decode_len=scale(_clipped_lognormal(
                rng, *spec.decode_range, spec.decode_mean)),
            tool_latency_s=float(rng.uniform(*spec.tool_latency_range_s)),
        ))
    return Session(session_id=session_id, turns=turns, workload=spec.name,
                   shared_prefix_len=shared_len)


def make_workload(num_sessions: int, *, workload: str = "react",
                  vocab_size: int = 512, token_scale: float = 1.0,
                  num_system_prompts: int = 1, seed: int = 0,
                  stagger_s: float = 0.15) -> List[Session]:
    """Sessions arrive staggered by ``stagger_s`` (multi-agent burst)."""
    rng = np.random.default_rng(seed)
    spec = SPECS[workload]
    max_cold = int(round(spec.cold_range[1] * token_scale)) + 1
    prompts = [rng.integers(0, vocab_size, size=max_cold, dtype=np.int32)
               for _ in range(num_system_prompts)]
    sessions = []
    for i in range(num_sessions):
        s = make_session(i, spec, rng, vocab_size, token_scale=token_scale,
                         system_prompt=prompts[i % num_system_prompts])
        s.ready_s = i * stagger_s
        sessions.append(s)
    return sessions


def shared_prefix_workload(num_agents: int, *, num_templates: int = 2,
                           divergence: float = 0.1, workload: str = "react",
                           vocab_size: int = 512, token_scale: float = 1.0,
                           seed: int = 0, stagger_s: float = 0.0,
                           rate_rps: Optional[float] = None,
                           turns_range: Optional[tuple] = None,
                           tool_latency_range_s: Optional[tuple] = None,
                           ) -> List[Session]:
    """N agents stamped from P system-prompt *templates* (the fleet
    pattern of agentic traces: many agents, few deployments), with a
    controllable ``divergence`` fraction.

    Unlike ``make_workload`` — where each session truncates the shared
    prompt at its own random cold length, so cross-session prefixes
    agree only up to the shorter truncation — every agent of one
    template here shares exactly the same ``(1 - divergence)`` leading
    fraction of its cold prompt and then diverges into its own random
    tail.  This is the radix prefix cache's target shape: an exact-key
    cache misses on every agent after the first; a longest-match index
    restores the whole shared stem (DESIGN.md §13).

    Arrivals: ``stagger_s`` fixed spacing, or ``rate_rps`` seeded
    Poisson (open-loop).  ``turns_range`` / ``tool_latency_range_s``
    override the paradigm spec — e.g. ``turns_range=(1, 2)`` makes a
    cold-prefill-dominated cohort where admission-order effects are not
    swamped by tool-wait slot occupancy."""
    assert 0.0 <= divergence <= 1.0, divergence
    rng = np.random.default_rng(seed)
    spec = SPECS[workload]
    if turns_range is not None:
        spec = dataclasses.replace(spec, turns_range=turns_range)
    if tool_latency_range_s is not None:
        spec = dataclasses.replace(
            spec, tool_latency_range_s=tool_latency_range_s)

    def scale(n):
        return max(1, int(round(n * token_scale)))

    cold_len = scale((spec.cold_range[0] + spec.cold_range[1]) // 2)
    keep = max(1, int(round(cold_len * (1.0 - divergence))))
    templates = [rng.integers(0, vocab_size, size=keep, dtype=np.int32)
                 for _ in range(num_templates)]
    arrivals = (poisson_arrivals(rate_rps, num_agents, seed=seed)
                if rate_rps is not None
                else np.arange(num_agents) * stagger_s)
    sessions = []
    for i in range(num_agents):
        stem = templates[i % num_templates]
        tail = rng.integers(0, vocab_size, size=max(cold_len - keep, 1),
                            dtype=np.int32)
        cold_tokens = np.concatenate([stem, tail]).astype(np.int32)
        n_turns = int(rng.integers(*spec.turns_range))
        turns: List[AgentTurn] = [AgentTurn(
            prefill_tokens=cold_tokens,
            decode_len=scale(_clipped_lognormal(
                rng, *spec.decode_range, spec.decode_mean)),
            tool_latency_s=float(rng.uniform(*spec.tool_latency_range_s)),
        )]
        for _ in range(n_turns - 1):
            r_len = scale(_clipped_lognormal(
                rng, *spec.resume_range, spec.resume_mean))
            turns.append(AgentTurn(
                prefill_tokens=rng.integers(0, vocab_size, size=r_len,
                                            dtype=np.int32),
                decode_len=scale(_clipped_lognormal(
                    rng, *spec.decode_range, spec.decode_mean)),
                tool_latency_s=float(rng.uniform(*spec.tool_latency_range_s)),
            ))
        s = Session(session_id=i, turns=turns, workload=spec.name,
                    shared_prefix_len=keep)
        s.ready_s = float(arrivals[i])
        sessions.append(s)
    return sessions


# ---------------------------------------------------------------------------
# open-loop arrival processes (DESIGN.md §6)
# ---------------------------------------------------------------------------

def poisson_arrivals(rate_rps: float, n: int, seed: int = 0,
                     start_s: float = 0.0) -> np.ndarray:
    """``n`` seeded-deterministic Poisson arrival times at ``rate_rps``
    requests/s.  Open-loop: arrivals do not wait for service, which is
    what creates the HOL-blocking queueing regime the paper studies —
    a closed cohort can never over-subscribe the engine."""
    if rate_rps <= 0:
        raise ValueError(f"rate_rps must be positive, got {rate_rps}")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_rps, size=n)
    return start_s + np.cumsum(gaps)


def save_arrival_trace(path: str, arrivals: np.ndarray) -> None:
    """One arrival timestamp (seconds, float) per line."""
    with open(path, "w") as f:
        for t in np.asarray(arrivals, dtype=float):
            f.write(f"{t:.9f}\n")


def load_arrival_trace(path: str) -> np.ndarray:
    """Replay a recorded arrival trace (one float per line; blank lines
    and ``#`` comments ignored).  Times must be non-decreasing."""
    times = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if line:
                times.append(float(line))
    arr = np.asarray(times, dtype=float)
    if arr.size and np.any(np.diff(arr) < 0):
        raise ValueError(f"arrival trace {path} is not sorted")
    return arr


def make_open_loop_workload(num_sessions: int, *, workload: str = "react",
                            vocab_size: int = 512, token_scale: float = 1.0,
                            num_system_prompts: int = 1, seed: int = 0,
                            rate_rps: Optional[float] = None,
                            arrivals: Optional[np.ndarray] = None,
                            trace_path: Optional[str] = None):
    """Sessions with open-loop arrival times in ``ready_s``.

    Exactly one arrival source: ``rate_rps`` (seeded Poisson),
    ``arrivals`` (explicit times), or ``trace_path`` (trace-file
    replay).  Session *content* is drawn with the same generator as the
    closed-loop ``make_workload`` so Table-I distributions are
    preserved; determinism follows from (seed, arrival source)."""
    sources = sum(x is not None for x in (rate_rps, arrivals, trace_path))
    if sources != 1:
        raise ValueError("pass exactly one of rate_rps / arrivals / "
                         "trace_path")
    if rate_rps is not None:
        arrivals = poisson_arrivals(rate_rps, num_sessions, seed=seed)
    elif trace_path is not None:
        arrivals = load_arrival_trace(trace_path)
    arrivals = np.asarray(arrivals, dtype=float)
    if len(arrivals) < num_sessions:
        raise ValueError(f"need {num_sessions} arrivals, trace has "
                         f"{len(arrivals)}")
    sessions = make_workload(num_sessions, workload=workload,
                             vocab_size=vocab_size, token_scale=token_scale,
                             num_system_prompts=num_system_prompts,
                             seed=seed, stagger_s=0.0)
    for s, t in zip(sessions, arrivals):
        s.ready_s = float(t)
    return sessions


def table1_statistics(workload: str, n: int = 200, seed: int = 0):
    """Empirical token distribution for benchmarks/table1_tokens.py."""
    rng = np.random.default_rng(seed)
    spec = SPECS[workload]
    colds, resumes, decodes = [], [], []
    for i in range(n):
        s = make_session(i, spec, rng, vocab_size=512)
        colds.append(len(s.turns[0].prefill_tokens))
        for t in s.turns[1:]:
            resumes.append(len(t.prefill_tokens))
        for t in s.turns:
            decodes.append(t.decode_len)
    stats = {}
    for k, xs in [("cold_prefill", colds), ("resume_prefill", resumes),
                  ("decode", decodes)]:
        xs = np.asarray(xs)
        stats[k] = dict(min=int(xs.min()), max=int(xs.max()),
                        mean=float(xs.mean()))
    return stats
