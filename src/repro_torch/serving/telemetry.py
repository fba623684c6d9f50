"""Unified telemetry layer: metrics registry, span tracing, timeline
export (DESIGN.md §11).

Three coordinated pieces, all allocation-light on the serving hot path:

  * **MetricsRegistry** — typed counters / gauges / histograms.  One
    registry per engine; the gateway registers its own metrics into the
    engine's registry at construction, so ``engine.stats()``,
    ``gateway.stats()`` and the HTTP ``GET /stats`` / ``GET /metrics``
    surfaces are all *views of the same object* — stats keys cannot
    drift between them (the PR-6 fault counters did exactly that).
    ``snapshot()`` flattens to the ``Dict[str, float]`` the existing
    ``stats()`` contract expects; ``prometheus_text()`` renders the
    text exposition format.  ``RegistryDict`` lets legacy dict-shaped
    counter groups (``engine.hotpath_stats``, ``gateway.counters``)
    keep their ``stats["x"] += 1`` call sites while every increment
    lands in a registered metric.

  * **SpanTracer** — per-session span timelines (QUEUED → PREFILL →
    DECODE → TOOL_WAIT → RESUME → DONE/ABORTED, plus per-tool-attempt
    child spans), per-slot occupancy spans, and per-cycle spans
    carrying the executed ``CyclePlan`` id.  Spans are plain tuples in
    bounded deques; recording happens only at phase boundaries and the
    engine's sampled flush cadence, never per token.

  * **Timeline export** — ``export_trace()`` renders the tracer's rings
    as Chrome/Perfetto ``trace_event`` JSON: one track per session, one
    per KV slot, one cycle/plan track.  Cycle spans carry the plan id
    recorded in the engine's ``PlanJournal``, so a journal replay's
    timeline can be diffed against the original run's.
    ``validate_trace_events`` / ``parse_prometheus_text`` are the
    self-contained format checkers the CI telemetry smoke uses (run
    ``python -m repro_torch.serving.telemetry trace.json`` to validate a
    dumped trace).

Timestamps are engine-clock seconds (``ServingEngine.clock()``)
throughout, so spans, the cycle trace and the plan journal share one
timebase.
"""
from __future__ import annotations

import collections
import json
import math
import re
import sys
from typing import Callable, Dict, Iterable, List, Mapping, Optional, \
    Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "RegistryDict",
    "SpanTracer", "Telemetry", "export_trace", "validate_trace_events",
    "parse_prometheus_text", "reconstruct_latency",
]

# default histogram buckets (seconds): sub-ms dispatch gaps up to
# multi-second queue waits
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


class Counter:
    """Monotonic (by convention) numeric metric.  ``value`` is plain
    attribute access so ``RegistryDict`` increments stay cheap."""
    kind = "counter"
    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name, self.help, self.value = name, help, 0

    def inc(self, n=1) -> None:
        self.value += n


class Gauge:
    """Point-in-time value: either set explicitly or computed by a
    callback at read time (queue depths, occupancy, KV pressure)."""
    kind = "gauge"
    __slots__ = ("name", "help", "value", "fn")

    def __init__(self, name: str, help: str = "",
                 fn: Optional[Callable[[], float]] = None):
        self.name, self.help, self.value, self.fn = name, help, 0.0, fn

    def set(self, v: float) -> None:
        self.value = v

    def read(self) -> float:
        return float(self.fn()) if self.fn is not None else float(self.value)


class Histogram:
    """Fixed-bucket histogram plus a bounded raw-sample ring for
    accurate percentiles (bucket interpolation is too coarse for the
    sub-ms dispatch-gap distribution the ROADMAP item needs)."""
    kind = "histogram"
    __slots__ = ("name", "help", "buckets", "counts", "total", "sum",
                 "samples")

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_BUCKETS,
                 sample_cap: int = 8192):
        self.name, self.help = name, help
        self.buckets = tuple(sorted(buckets))
        self.counts = [0] * len(self.buckets)
        self.total = 0
        self.sum = 0.0
        self.samples: collections.deque = collections.deque(
            maxlen=sample_cap)

    def observe(self, v: float, count: int = 1) -> None:
        """Record ``count`` observations of value ``v`` (the engine's
        sampled flush observes one window-mean gap for all n steps at
        once — one call, not n)."""
        for i, b in enumerate(self.buckets):
            if v <= b:
                self.counts[i] += count
                break
        self.total += count
        self.sum += v * count
        self.samples.append(v)

    def percentile(self, p: float) -> float:
        if not self.samples:
            return 0.0
        xs = sorted(self.samples)
        k = min(len(xs) - 1, max(0, int(round((p / 100.0) * (len(xs) - 1)))))
        return xs[k]


class MetricsRegistry:
    """One flat namespace of typed metrics.  ``counter``/``gauge``/
    ``histogram`` are get-or-create (the gateway and engine register
    independently; re-registering the same name with the same kind
    returns the existing metric, a different kind is a hard error)."""

    def __init__(self):
        self._metrics: "collections.OrderedDict[str, object]" = \
            collections.OrderedDict()

    def _get_or_create(self, cls, name: str, **kwargs):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        m = self._metrics.get(name)
        if m is not None:
            if not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}")
            return m
        m = cls(name, **kwargs)
        self._metrics[name] = m
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help=help)

    def gauge(self, name: str, help: str = "",
              fn: Optional[Callable[[], float]] = None) -> Gauge:
        g = self._get_or_create(Gauge, name, help=help)
        if fn is not None:
            g.fn = fn
        return g

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help=help,
                                   buckets=buckets)

    def metrics(self) -> List[object]:
        return list(self._metrics.values())

    # ---- the stats() surface ------------------------------------------
    def snapshot(self) -> Dict[str, float]:
        """Flatten every metric to the ``Dict[str, float]`` shape the
        existing ``stats()`` consumers (tests, /stats JSON) expect.
        Histograms contribute ``_count``/``_sum`` plus raw-sample
        percentiles (0.0 when empty — the JSON surface must stay
        NaN-free)."""
        out: Dict[str, float] = {}
        for m in self._metrics.values():
            if isinstance(m, Counter):
                out[m.name] = float(m.value)
            elif isinstance(m, Gauge):
                out[m.name] = m.read()
            else:
                out[f"{m.name}_count"] = float(m.total)
                out[f"{m.name}_sum"] = float(m.sum)
                for p in (50, 95, 99):
                    out[f"{m.name}_p{p}"] = float(m.percentile(p))
        return out

    # ---- the /metrics surface -----------------------------------------
    def prometheus_text(self) -> str:
        """Prometheus text exposition format (version 0.0.4): # HELP /
        # TYPE headers, cumulative ``_bucket{le=...}`` histogram series
        with the mandatory ``+Inf`` bucket, ``_sum`` and ``_count``."""
        lines: List[str] = []
        for m in self._metrics.values():
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            if isinstance(m, Counter):
                lines.append(f"{m.name} {float(m.value)}")
            elif isinstance(m, Gauge):
                lines.append(f"{m.name} {m.read()}")
            else:
                acc = 0
                for b, c in zip(m.buckets, m.counts):
                    acc += c
                    lines.append(f'{m.name}_bucket{{le="{b}"}} {acc}')
                lines.append(f'{m.name}_bucket{{le="+Inf"}} {m.total}')
                lines.append(f"{m.name}_sum {float(m.sum)}")
                lines.append(f"{m.name}_count {m.total}")
        return "\n".join(lines) + "\n"


def parse_prometheus_text(text: str) -> Dict[str, float]:
    """Validating parser for the text exposition format (the CI smoke's
    scrape check).  Returns ``{sample_name{labels}: value}``; raises
    ``ValueError`` on malformed lines, unknown TYPEs, samples preceding
    their TYPE header, or non-monotonic histogram buckets."""
    samples: Dict[str, float] = {}
    types: Dict[str, str] = {}
    bucket_last: Dict[str, float] = {}
    for ln, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) < 3 or parts[1] not in ("HELP", "TYPE"):
                raise ValueError(f"line {ln}: malformed comment {raw!r}")
            if parts[1] == "TYPE":
                typ = parts[3] if len(parts) > 3 else ""
                if typ not in ("counter", "gauge", "histogram", "summary",
                               "untyped"):
                    raise ValueError(f"line {ln}: unknown type {raw!r}")
                types[parts[2]] = typ
            continue
        mobj = re.match(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"
                        r"(\{[^}]*\})?\s+(\S+)(?:\s+\d+)?$", line)
        if mobj is None:
            raise ValueError(f"line {ln}: malformed sample {raw!r}")
        name, labels, val = mobj.group(1), mobj.group(2) or "", mobj.group(3)
        try:
            fval = float(val)
        except ValueError:
            raise ValueError(f"line {ln}: bad value {val!r}") from None
        family = re.sub(r"_(bucket|sum|count)$", "", name)
        if family not in types and name not in types:
            raise ValueError(f"line {ln}: sample {name!r} has no TYPE")
        if name.endswith("_bucket"):
            lm = re.match(r'\{le="([^"]+)"\}', labels)
            if lm is None:
                raise ValueError(f"line {ln}: bucket without le label")
            if fval < bucket_last.get(name, 0.0):
                raise ValueError(
                    f"line {ln}: non-cumulative histogram bucket")
            bucket_last[name] = fval
        samples[name + labels] = fval
    return samples


class RegistryDict(collections.abc.MutableMapping):
    """Dict-shaped facade over registered counters.

    ``engine.hotpath_stats`` and ``gateway.counters`` predate the
    registry and are written as plain dicts all over the engine, the
    gateway and the tests (``stats["kv_deferred"] += 1``).  This keeps
    that call-site syntax while making the registry the single source
    of truth.  ``rename`` maps a dict key to a different *registry*
    name where the flat namespace would collide (the engine's
    ``aborted`` vs the gateway's ``aborted``)."""

    def __init__(self, registry: MetricsRegistry,
                 initial: Mapping[str, float],
                 rename: Optional[Mapping[str, str]] = None,
                 help_prefix: str = ""):
        self._metrics: "collections.OrderedDict[str, Counter]" = \
            collections.OrderedDict()
        rename = rename or {}
        for key, val in initial.items():
            c = registry.counter(rename.get(key, key),
                                 help=f"{help_prefix}{key}")
            c.value = val
            self._metrics[key] = c

    def __getitem__(self, key):
        return self._metrics[key].value

    def __setitem__(self, key, value):
        self._metrics[key].value = value

    def __delitem__(self, key):
        raise TypeError("RegistryDict keys are fixed at construction")

    def __iter__(self):
        return iter(self._metrics)

    def __len__(self):
        return len(self._metrics)


# ---------------------------------------------------------------------------
# span tracing
# ---------------------------------------------------------------------------

# span tuple layout: (track, track_id, name, t0, t1, args)
SESSION_TRACK = "session"
SLOT_TRACK = "slot"
CYCLE_TRACK = "cycle"

TERMINAL_PHASES = ("DONE", "ABORTED")


class SpanTracer:
    """Bounded span recorder.  Open session spans live in one small
    dict (one entry per live session); completed spans append tuples to
    a bounded ring.  All methods are O(1) and run only at phase
    boundaries / flush points — never per decoded token."""

    def __init__(self, spans_max: int = 200_000):
        self.spans: collections.deque = collections.deque(maxlen=spans_max)
        self._open: Dict[int, List] = {}          # sid -> [phase, t0, args]
        self._open_slots: Dict[int, Tuple[int, float]] = {}  # slot->(sid,t0)

    def reset(self) -> None:
        self.spans.clear()
        self._open.clear()
        self._open_slots.clear()

    # ---- session timeline ---------------------------------------------
    def transition(self, sid: int, phase: str, t: float, **args) -> None:
        """Close ``sid``'s current span at ``t`` and open the next one.
        Terminal phases (DONE/ABORTED) close the timeline: they record
        a zero-length terminal marker span instead of staying open, so
        ``open_span_count`` reaching zero *is* the no-leak invariant."""
        cur = self._open.pop(sid, None)
        if cur is not None:
            self.spans.append(
                (SESSION_TRACK, sid, cur[0], cur[1], t, cur[2]))
        if phase in TERMINAL_PHASES:
            self.spans.append(
                (SESSION_TRACK, sid, phase, t, t, args or None))
        else:
            self._open[sid] = [phase, t, args or None]

    def child(self, sid: int, name: str, t0: float, t1: float,
              **args) -> None:
        """Record a completed child span on a session's track (tool
        attempts, retries) — it nests under the open TOOL_WAIT span."""
        self.spans.append((SESSION_TRACK, sid, name, t0, t1, args or None))

    # ---- slot occupancy -----------------------------------------------
    def slot_bind(self, slot: int, sid: int, t: float) -> None:
        prev = self._open_slots.pop(slot, None)
        if prev is not None:             # defensive: close a stale bind
            self.spans.append((SLOT_TRACK, slot, f"sid {prev[0]}",
                               prev[1], t, {"session": prev[0]}))
        self._open_slots[slot] = (sid, t)

    def slot_free(self, slot: int, t: float) -> None:
        prev = self._open_slots.pop(slot, None)
        if prev is not None:
            self.spans.append((SLOT_TRACK, slot, f"sid {prev[0]}",
                               prev[1], t, {"session": prev[0]}))

    # ---- cycle/plan track ---------------------------------------------
    def cycle(self, plan_id: int, kind: str, t0: float, t1: float,
              **args) -> None:
        args["plan_id"] = plan_id
        self.spans.append((CYCLE_TRACK, 0, kind, t0, t1, args))

    # ---- leak accounting ----------------------------------------------
    def open_spans(self) -> Dict[str, List[int]]:
        return {"sessions": sorted(self._open),
                "slots": sorted(self._open_slots)}

    def open_span_count(self) -> int:
        return len(self._open) + len(self._open_slots)


class Telemetry:
    """Engine-owned facade: the registry is always live (it *is* the
    stats surface); the tracer exists only when tracing is enabled, so
    ``telemetry=off`` engines skip every span call via one None
    check."""

    def __init__(self, enabled: bool = True, spans_max: int = 200_000,
                 registry: Optional[MetricsRegistry] = None):
        self.registry = registry or MetricsRegistry()
        self.enabled = enabled
        self.tracer: Optional[SpanTracer] = (
            SpanTracer(spans_max) if enabled else None)

    def export_trace(self, path: str) -> int:
        if self.tracer is None:
            raise RuntimeError(
                "trace export requires telemetry=on (EngineConfig)")
        doc = export_trace(self.tracer)
        with open(path, "w") as f:
            json.dump(doc, f)
        return len(doc["traceEvents"])


# ---------------------------------------------------------------------------
# Chrome/Perfetto trace_event export
# ---------------------------------------------------------------------------

_PID = {SESSION_TRACK: 1, SLOT_TRACK: 2, CYCLE_TRACK: 3}


def export_trace(tracer: SpanTracer) -> Dict:
    """Render the tracer's rings as a Chrome ``trace_event`` JSON
    object (Perfetto/chrome://tracing loadable): 'X' complete events
    with µs timestamps, one process per track family (sessions, KV
    slots, engine cycles), one thread per session / slot."""
    events: List[Dict] = []
    for pid, name in ((1, "sessions"), (2, "kv slots"), (3, "engine")):
        events.append({"ph": "M", "pid": pid, "tid": 0,
                       "name": "process_name", "args": {"name": name}})
    named_tids = set()
    spans = list(tracer.spans)
    for track, tid, name, t0, t1, args in spans:
        pid = _PID[track]
        if (pid, tid) not in named_tids:
            named_tids.add((pid, tid))
            label = {SESSION_TRACK: f"session {tid}",
                     SLOT_TRACK: f"slot {tid}",
                     CYCLE_TRACK: "cycles"}[track]
            events.append({"ph": "M", "pid": pid, "tid": tid,
                           "name": "thread_name",
                           "args": {"name": label}})
        ev = {"ph": "X", "pid": pid, "tid": tid, "name": name,
              "ts": t0 * 1e6, "dur": max(0.0, (t1 - t0) * 1e6)}
        if args:
            ev["args"] = args
        events.append(ev)
    # still-open spans export as 'B' begin events so a mid-run dump of
    # a live server is loadable too
    for sid, (phase, t0, args) in tracer._open.items():
        ev = {"ph": "B", "pid": 1, "tid": sid, "name": phase,
              "ts": t0 * 1e6}
        if args:
            ev["args"] = args
        events.append(ev)
    for slot, (sid, t0) in tracer._open_slots.items():
        events.append({"ph": "B", "pid": 2, "tid": slot,
                       "name": f"sid {sid}", "ts": t0 * 1e6,
                       "args": {"session": sid}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def validate_trace_events(doc) -> int:
    """Structural validation of a ``trace_event`` JSON document (the CI
    telemetry smoke's schema check).  Returns the event count; raises
    ``ValueError`` with the first offending event otherwise."""
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError("trace must be an object with 'traceEvents'")
    events = doc["traceEvents"]
    if not isinstance(events, list) or not events:
        raise ValueError("'traceEvents' must be a non-empty array")
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i}: not an object")
        ph = ev.get("ph")
        if ph not in ("X", "B", "E", "M", "i", "C"):
            raise ValueError(f"event {i}: unknown phase {ph!r}")
        for key in ("pid", "tid"):
            if not isinstance(ev.get(key), int):
                raise ValueError(f"event {i}: {key} must be an int")
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            raise ValueError(f"event {i}: missing name")
        if ph in ("X", "B", "E", "i"):
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)) or math.isnan(ts):
                raise ValueError(f"event {i}: bad ts {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if (not isinstance(dur, (int, float)) or math.isnan(dur)
                    or dur < 0):
                raise ValueError(f"event {i}: bad dur {dur!r}")
        if "args" in ev and not isinstance(ev["args"], dict):
            raise ValueError(f"event {i}: args must be an object")
    return len(events)


# ---------------------------------------------------------------------------
# latency reconstruction from spans (the acceptance cross-check)
# ---------------------------------------------------------------------------

def reconstruct_latency(spans: Iterable[Tuple],
                        ) -> Tuple[List[float], float]:
    """Recover (per-request TTFTs, mean TPOT) from a span stream, for
    sessions whose timeline reached DONE.

    TTFT: each DECODE span starts at its burst's first-token timestamp
    and the PREFILL/RESUME span it closes started at the request's
    submission — exactly ``metrics.collect_ttfts``'s operands.  TPOT:
    within a burst the interpolated inter-token gaps telescope, so
    ``sum(decode span durations) / sum(tokens - 1)`` equals the mean of
    ``metrics.collect_tpots`` exactly.  The 1%-agreement acceptance
    check (tests + serve smoke) runs through this function."""
    pending: Dict[int, float] = {}       # sid -> open request start
    ttfts: Dict[int, List[float]] = collections.defaultdict(list)
    gap_sum: Dict[int, float] = collections.defaultdict(float)
    gap_n: Dict[int, int] = collections.defaultdict(int)
    done: set = set()
    for track, sid, name, t0, t1, args in spans:
        if track != SESSION_TRACK:
            continue
        if name in ("PREFILL", "RESUME"):
            if not (args or {}).get("resumed"):
                pending[sid] = t0        # resumed=True continues a
                #                          request, it starts none
        elif name == "DECODE":
            start = pending.pop(sid, None)
            if start is not None:
                ttfts[sid].append(t0 - start)
            tokens = int((args or {}).get("tokens", 1))
            gap_sum[sid] += t1 - t0
            gap_n[sid] += max(0, tokens - 1)
        elif name == "DONE":
            done.add(sid)
    flat_ttfts = [t for sid in sorted(done) for t in ttfts[sid]]
    total_gap = sum(gap_sum[sid] for sid in done)
    total_n = sum(gap_n[sid] for sid in done)
    mean_tpot = total_gap / total_n if total_n else float("nan")
    return flat_ttfts, mean_tpot


# ---------------------------------------------------------------------------
# CLI: validate a dumped trace (CI telemetry smoke)
# ---------------------------------------------------------------------------

def _main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: python -m repro_torch.serving.telemetry TRACE.json "
              "[METRICS.txt]", file=sys.stderr)
        return 2
    with open(argv[0]) as f:
        doc = json.load(f)
    n = validate_trace_events(doc)
    x = sum(1 for ev in doc["traceEvents"] if ev.get("ph") == "X")
    print(f"{argv[0]}: OK — {n} trace events ({x} complete spans)")
    if len(argv) > 1:
        with open(argv[1]) as f:
            samples = parse_prometheus_text(f.read())
        print(f"{argv[1]}: OK — {len(samples)} prometheus samples")
    return 0


if __name__ == "__main__":
    sys.exit(_main())
