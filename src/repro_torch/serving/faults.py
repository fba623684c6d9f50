"""Fault-domain types the engine raises and catches.

Only ``SessionFault`` is ported so far: the seeded chaos layer
(``FaultPlan``, ``drive_chaos``) waits for the gateway.
"""
from __future__ import annotations


class SessionFault(RuntimeError):
    """A fault attributable to exactly one session.  ``step()`` catches
    it and quarantines (aborts) that session; every other session's
    cycle proceeds."""

    def __init__(self, session_id: int, reason: str):
        super().__init__(f"session {session_id}: {reason}")
        self.session_id = session_id
        self.reason = reason
