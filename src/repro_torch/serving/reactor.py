"""The engine's emission record (the reactor surface's event type).

``TokenEvent`` is one decoded token for one session, stamped with the
engine clock.  ``turn_end`` marks the last token of a decode burst (the
agent is about to leave for a tool call) and ``session_end`` the last
token of the final turn.  The steppable reactor and the online gateway
that consume these events are not ported yet; ``ServingEngine.step()``
already returns them.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class TokenEvent:
    """One emitted token. ``t`` is engine-clock seconds; ``index`` is the
    token's position within its turn's decode burst (0 == first token,
    emitted by the prefill completion)."""
    session_id: int
    token: int
    t: float
    turn_idx: int
    index: int
    first: bool = False          # first token of a burst (TTFT event)
    turn_end: bool = False       # burst complete -> tool call next
    session_end: bool = False    # final token of the final turn
    # fault-domain terminal: an aborted session's last event carries
    # error=True (token == -1) so stream consumers distinguish failure
    # from completion; abort_reason attributes it
    error: bool = False
    abort_reason: str = ""
