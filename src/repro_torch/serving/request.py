"""Request/session dataclasses for the serving engine."""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional

import numpy as np


class SessionState(enum.Enum):
    WAITING_PREFILL = "waiting_prefill"   # request submitted, not started
    PREFILLING = "prefilling"             # chunks in flight
    PREFILL_PAUSED = "prefill_paused"     # cold prefill preempted by an
    #                                       interactive-class arrival: KV
    #                                       parked on device, slot freed
    DECODING = "decoding"
    TOOL_CALL = "tool_call"               # engine-clocked tool wait
    TOOL_WAIT = "tool_wait"               # gateway-clocked tool wait:
    #                                       resume_session() re-arms it
    FINISHED = "finished"
    ABORTED = "aborted"                   # terminal: fault / deadline /
    #                                       disconnect (abort_reason says)


@dataclasses.dataclass
class AgentTurn:
    """One reasoning-action step: a prefill (cold or resume) followed by a
    bounded decode burst and an external tool call."""
    prefill_tokens: np.ndarray        # tokens to append
    decode_len: int                   # structured-output length
    tool_latency_s: float             # simulated external-call duration


@dataclasses.dataclass
class Session:
    session_id: int
    turns: List[AgentTurn]
    workload: str = "react"           # react | plan_execute
    shared_prefix_len: int = 0        # leading tokens shared across sessions
    external_tools: bool = False      # gateway owns the tool-wait clock
    slo_class: str = "batch"          # interactive | batch (PriorityPlanner)
    # runtime state
    state: SessionState = SessionState.WAITING_PREFILL
    turn_idx: int = 0
    slot: int = -1                    # KV-cache slot
    cached_len: int = 0               # tokens in KV cache
    prefill_done: int = 0             # tokens of current turn prefilled
    decoded: int = 0                  # tokens decoded in current turn
    last_token: int = 0
    arrival_s: float = 0.0            # current request submission time
    ready_s: float = 0.0              # when the session may next be served
    deadline_s: float = float("inf")  # absolute engine-clock SLO deadline:
    #                                   the engine aborts the session past
    #                                   it (the gateway sets it at submit)
    abort_reason: Optional[str] = None  # terminal fault attribution
    # metrics bookkeeping
    request_arrivals: List[float] = dataclasses.field(default_factory=list)
    first_token_s: List[float] = dataclasses.field(default_factory=list)
    token_times_s: List[float] = dataclasses.field(default_factory=list)
    # per-request admission wait (request ready -> admitted), aligned
    # with request_arrivals — the open-loop queue-delay breakdown
    queue_delays_s: List[float] = dataclasses.field(default_factory=list)

    @property
    def current_turn(self) -> Optional[AgentTurn]:
        return self.turns[self.turn_idx] if self.turn_idx < len(self.turns) else None

    @property
    def remaining_prefill(self) -> int:
        t = self.current_turn
        return 0 if t is None else len(t.prefill_tokens) - self.prefill_done

    @property
    def total_prompt_len(self) -> int:
        t = self.current_turn
        return self.cached_len + (len(t.prefill_tokens) if t else 0)

    def output_tokens(self) -> int:
        return len(self.token_times_s)
