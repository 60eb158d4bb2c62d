"""Request-scoped span tracing.

The serving stack's counters (profiling.EngineStats & co) say HOW MUCH
happened; they cannot say WHERE one slow request's time went. This
module is the low-overhead answer: a process-wide :data:`TRACER` mints
sampled per-request trace ids at admission (``ServingEngine.submit`` /
``FleetRouter.submit``) and the request's journey — host prepare, queue
wait, the micro-batch it coalesced into, each failover re-dispatch
attempt, the shadow mirror — lands as SPANS in a bounded ring.
``Workflow.train`` gets the same treatment per stage (executor.py), so
a train's critical path is inspectable with the same tooling.

Design constraints (the serving hot path pays for every byte here):

* **Sampling is the fast path.** ``TM_TRACE_SAMPLE`` (0.0–1.0, default
  0 = off) decides per request; a sampled-out request costs one
  ``enabled`` branch at the call site — no id minted, no object
  allocated, no lock taken. Sampling is DETERMINISTIC (every
  round(1/rate)-th admission), so a drill with sample=1.0 traces every
  request and a production 0.01 traces a steady 1-in-100 — no RNG on
  the hot path, reproducible selection in tests.
* **Bounded.** Finished spans land in a lock-cheap ring
  (``TM_TRACE_CAPACITY``, default 8192); old spans fall off, the
  ``recorded`` counter keeps the true total so truncation is visible,
  never silent.
* **Exportable.** ``export_chrome()`` writes Chrome trace-event JSON —
  openable as-is in Perfetto (ui.perfetto.dev) or TensorBoard's trace
  viewer; ``export_jsonl()`` writes one span per line for ad-hoc
  grepping, re-convertible via ``jsonl_to_chrome`` (the ``telemetry``
  CLI subcommand wraps both).

Trace ids propagate across layers by riding the request Future
(:func:`set_trace` / :func:`get_trace`): the router stamps its routed
future, the engine stamps its per-request future, and the shadow scorer
reads the stamp off the live future it mirrors — no signature changes
on the tap contract.

All span timestamps are ``time.monotonic()`` seconds (the same clock
the engine's ``enqueued_at`` already uses), so call sites can hand
existing timestamps straight to :meth:`Tracer.record`.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, Iterator, List, Optional

__all__ = ["Tracer", "TRACER", "configure", "get_trace", "set_trace",
           "chrome_document", "jsonl_to_chrome"]

#: attribute name carrying a trace id on request Futures (duck-typed
#: propagation: router future -> engine future -> shadow tap)
TRACE_ATTR = "tm_trace"

#: sentinel for "no upstream sampling decision was made" — the engine
#: samples itself only when its caller (a bare submit) passes this; the
#: fleet router always passes its own decision (an id or None), so one
#: request is sampled exactly once however many layers it crosses
UNSET = object()


def get_trace(future) -> Optional[str]:
    """The trace id riding ``future``, or None (unsampled/untraced)."""
    return getattr(future, TRACE_ATTR, None)


def set_trace(future, trace: Optional[str]) -> None:
    if trace is not None:
        setattr(future, TRACE_ATTR, trace)


class _OpenSpan:
    """A begun-but-unfinished span; ``end()`` records it. Handed out
    only for SAMPLED work, so allocation cost is never on the
    sampled-out path."""

    __slots__ = ("_tracer", "trace", "name", "cat", "t0", "attrs")

    def __init__(self, tracer: "Tracer", trace: str, name: str,
                 cat: str, attrs: Dict[str, Any]):
        self._tracer = tracer
        self.trace = trace
        self.name = name
        self.cat = cat
        self.t0 = time.monotonic()
        self.attrs = attrs

    def end(self, **attrs) -> None:
        if attrs:
            self.attrs.update(attrs)
        self._tracer.record(self.trace, self.name, self.t0,
                            time.monotonic(), cat=self.cat, **self.attrs)


class Tracer:
    """See module docstring. One instance (:data:`TRACER`) serves the
    process; :func:`configure` retunes it IN PLACE so every module-level
    ``from telemetry.spans import TRACER`` stays valid."""

    def __init__(self, sample: float = 0.0, capacity: int = 8192):
        self._lock = threading.Lock()
        self._configure_locked(sample, capacity)

    # -- configuration -----------------------------------------------------
    def _configure_locked(self, sample: float, capacity: int) -> None:
        sample = float(sample)
        capacity = int(capacity)
        if not (0.0 <= sample <= 1.0):
            raise ValueError(
                f"trace sample rate must be in [0, 1], got {sample}")
        if capacity < 1:
            raise ValueError("trace capacity must be >= 1")
        self.sample = sample
        # write order matters: sample_trace reads enabled then _period
        # WITHOUT the lock, so _period must be valid before enabled
        # flips true (and sample_trace still guards against a mid-
        # configure 0 — flipping the knob on a live engine must never
        # fail a request)
        self._period = max(1, round(1.0 / sample)) if sample > 0.0 else 0
        #: THE hot-path flag: call sites guard every tracing branch on
        #: this one attribute read, so tracing-off costs ~one branch
        self.enabled = sample > 0.0
        self._spans: deque = deque(maxlen=capacity)
        self.capacity = capacity
        #: lock-free arrival ordinal: itertools.count.__next__ is
        #: atomic under the GIL, so the sampled-out path (the 99% at
        #: production rates) never serializes admission threads on the
        #: process-wide tracer lock
        self._arrival_iter = itertools.count()
        self._arrivals = 0      # advisory mirror, refreshed on mint —
        #                         exact at sample=1.0, lags by at most
        #                         period-1 between mints otherwise
        self._ids = 0           # ids minted (traces + free spans)
        self._recorded = 0      # spans ever recorded (ring may be smaller)

    def configure(self, sample: float = 0.0,
                  capacity: int = 8192) -> "Tracer":
        """Reconfigure (and RESET: counters + ring) in place."""
        with self._lock:
            self._configure_locked(sample, capacity)
        return self

    @classmethod
    def from_env(cls, environ: Optional[Dict[str, str]] = None
                 ) -> "Tracer":
        """``TM_TRACE_SAMPLE`` / ``TM_TRACE_CAPACITY``. Unparsable
        values raise naming the variable — a drill whose tracing knob
        silently didn't apply proves nothing (the TM_FAULTS
        convention)."""
        env = os.environ if environ is None else environ
        sample, capacity = 0.0, 8192
        raw = env.get("TM_TRACE_SAMPLE")
        if raw:
            try:
                sample = float(raw)
            except ValueError:
                raise ValueError(
                    f"bad value {raw!r} for TM_TRACE_SAMPLE "
                    f"(expected a float in [0, 1])") from None
        raw = env.get("TM_TRACE_CAPACITY")
        if raw:
            try:
                capacity = int(raw)
            except ValueError:
                raise ValueError(
                    f"bad value {raw!r} for TM_TRACE_CAPACITY "
                    f"(expected an int >= 1)") from None
        return cls(sample=sample, capacity=capacity)

    # -- id minting --------------------------------------------------------
    def sample_trace(self, kind: str = "req") -> Optional[str]:
        """Mint a trace id for this admission, or None (sampled out).
        Deterministic every-Nth selection; the caller should guard with
        ``if TRACER.enabled`` so the disabled path stays one branch.
        Sampled-out admissions are LOCK-FREE (an atomic counter bump):
        production rates like 0.01 must not serialize every submit
        thread on the tracer lock for the 99% they don't trace."""
        if not self.enabled:
            return None
        n = next(self._arrival_iter)
        period = self._period       # one read: a concurrent configure
        if not period or n % period:    # may zero it mid-decision —
            return None                 # degrade to sampled-out
        with self._lock:
            self._arrivals = n + 1
            self._ids += 1
            return f"{kind}-{self._ids:06d}"

    def mint(self, kind: str) -> str:
        """An unconditional id (batch spans, train traces) — no
        sampling decision consumed."""
        with self._lock:
            self._ids += 1
            return f"{kind}-{self._ids:06d}"

    # -- recording ---------------------------------------------------------
    def record(self, trace: Optional[str], name: str, t0: float,
               t1: float, cat: str = "serving", **attrs) -> None:
        """Record one finished span with explicit monotonic times.
        No-op when ``trace`` is None, so call sites can thread an
        optional trace straight through."""
        if trace is None:
            return
        span: Dict[str, Any] = {
            "trace": trace, "name": name, "cat": cat,
            "ts": t0, "dur": max(0.0, t1 - t0),
            "tid": threading.get_ident(), "wall": time.time()}
        if attrs:
            span["attrs"] = attrs
        with self._lock:
            self._recorded += 1
            self._spans.append(span)

    def begin(self, trace: Optional[str], name: str,
              cat: str = "serving", **attrs) -> Optional[_OpenSpan]:
        """Start a span whose end lives on another thread (the
        request span ended by a future's done-callback). None in,
        None out."""
        if trace is None:
            return None
        return _OpenSpan(self, trace, name, cat, dict(attrs))

    @contextlib.contextmanager
    def span(self, trace: Optional[str], name: str, cat: str = "serving",
             **attrs) -> Iterator[Optional[Dict[str, Any]]]:
        """Context-managed span; yields the attrs dict (add fields
        before exit) or None when ``trace`` is None."""
        if trace is None:
            yield None
            return
        box = dict(attrs)
        t0 = time.monotonic()
        try:
            yield box
        finally:
            self.record(trace, name, t0, time.monotonic(), cat=cat, **box)

    # -- reading / export --------------------------------------------------
    def spans(self, trace: Optional[str] = None) -> List[Dict[str, Any]]:
        with self._lock:
            out = [dict(s) for s in self._spans]
        if trace is not None:
            out = [s for s in out if s["trace"] == trace]
        return out

    def counts(self) -> Dict[str, Any]:
        """The /statusz `telemetry` block: sampling config + volume
        (``recorded`` keeps the true total, so ring truncation is
        visible: recorded > retained means old spans fell off)."""
        with self._lock:
            return {"sample": self.sample, "enabled": self.enabled,
                    "capacity": self.capacity,
                    "arrivals": self._arrivals,
                    "recorded": self._recorded,
                    "retained": len(self._spans)}

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    def export_jsonl(self, path: str) -> str:
        """One span per line (grep/jq-friendly); convert to Chrome
        trace JSON later with :func:`jsonl_to_chrome`."""
        spans = self.spans()
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            for s in spans:
                f.write(json.dumps(s, default=str) + "\n")
        return path

    def export_chrome(self, path: str) -> str:
        """Chrome trace-event JSON — open directly in Perfetto
        (ui.perfetto.dev) or chrome://tracing."""
        doc = chrome_document(self.spans())
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(doc, f, default=str)
        return path


def chrome_document(spans: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Span dicts -> the Chrome trace-event document. Each span becomes
    one complete ("X") event; ts/dur are microseconds on the shared
    monotonic clock (only relative placement matters to the viewers).
    The trace id rides ``args.trace`` so Perfetto's query/filter box
    can isolate one request's fan-out."""
    events = []
    for s in spans:
        args = dict(s.get("attrs") or {})
        args["trace"] = s["trace"]
        events.append({
            "name": s["name"], "cat": s.get("cat", "serving"),
            "ph": "X", "ts": s["ts"] * 1e6, "dur": s["dur"] * 1e6,
            "pid": os.getpid(), "tid": s.get("tid", 0), "args": args})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def jsonl_to_chrome(jsonl_path: str, out_path: str) -> str:
    """Convert an ``export_jsonl`` file to Chrome trace JSON (the
    ``telemetry --spans ... --chrome-out ...`` CLI path)."""
    spans = []
    with open(jsonl_path) as f:
        for line in f:
            line = line.strip()
            if line:
                spans.append(json.loads(line))
    doc = chrome_document(spans)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(doc, f, default=str)
    return out_path


#: THE process tracer. Reconfigure with :func:`configure` (in place, so
#: module-level imports of this name never go stale).
TRACER = Tracer.from_env()


def configure(sample: float = 0.0, capacity: int = 8192) -> Tracer:
    """Retune the global tracer (tests, the overhead bench). Resets
    counters and the span ring."""
    return TRACER.configure(sample=sample, capacity=capacity)
