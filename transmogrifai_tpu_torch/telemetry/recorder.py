"""Control-plane flight recorder.

When a rollout rolls back at 3am, the counters say THAT it happened;
reconstructing WHY means correlating breaker transitions, failovers,
fault injections, and continuum state changes that live in five
different subsystems' heads. The flight recorder is the one bounded,
structured event log they all write to:

* every event carries monotonic + wall stamps, a severity, the emitting
  subsystem, an event name, optional trace-id correlation (the SAME ids
  the span tracer mints, so a failover event joins the request spans it
  interrupted), and free-form attrs;
* the log is a lock-cheap bounded ring (``capacity`` events; the
  ``seq`` counter keeps the true total so truncation is visible);
* it AUTO-DUMPS to disk on the events that end an incident —
  whole-fleet rollback, replica crash, fleet stop, an injected
  crash-process fault — so the causal chain survives the process that
  produced it. One JSONL file per process
  (``TM_FLIGHT_DIR``/``tm_flight_<pid>.jsonl``, default the system
  tempdir), REWRITTEN with the full ring on every auto-dump: the file
  on disk is always the most recent complete picture, not an append
  log that interleaves incidents.

Readers: the tail rides /statusz (``flightRecorder`` block), the
``telemetry`` CLI subcommand pretty-prints/filters a dump, and the
chaos-drill tests assert the full inject → breaker → failover →
rollback chain from the dump file alone (tests/test_telemetry.py).

Writers call :func:`record` — module-level, stdlib-only, safe to import
from anywhere in the stack (no cycles: telemetry imports nothing from
the package).
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

__all__ = ["FlightRecorder", "RECORDER", "record", "default_dump_path"]

SEVERITIES = ("info", "warning", "error")


def dump_dir() -> str:
    """Where auto-dumps land: ``TM_FLIGHT_DIR`` or the system tempdir
    (read at dump time, so a test's monkeypatched dir applies)."""
    return os.environ.get("TM_FLIGHT_DIR") or tempfile.gettempdir()


def default_dump_path() -> str:
    return os.path.join(dump_dir(), f"tm_flight_{os.getpid()}.jsonl")


class FlightRecorder:
    """See module docstring."""

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError("flight-recorder capacity must be >= 1")
        self._lock = threading.Lock()
        #: serializes dump() end to end — the supervisor's crash dump
        #: and a rollout thread's rollback dump can fire concurrently,
        #: and both writing the same .tmp path would interleave and
        #: promote a corrupted artifact (separate from _lock: dump()
        #: calls record()/events(), which take _lock themselves)
        self._dump_lock = threading.Lock()
        self._events: deque = deque(maxlen=int(capacity))
        self._seq = 0
        self.capacity = int(capacity)
        self.last_dump_path: Optional[str] = None
        self.dumps = 0

    # -- writing -----------------------------------------------------------
    def record(self, subsystem: str, event: str, severity: str = "info",
               trace: Optional[str] = None, **attrs) -> Dict[str, Any]:
        """Append one event. ``severity`` is one of info/warning/error
        (validated — a typo'd severity would silently vanish from every
        severity-filtered view). Returns the event dict (tests)."""
        if severity not in SEVERITIES:
            raise ValueError(f"unknown severity {severity!r}; one of "
                             f"{SEVERITIES}")
        ev: Dict[str, Any] = {
            "seq": 0,                   # stamped under the lock below
            "wall": time.time(), "mono": time.monotonic(),
            "severity": severity, "subsystem": subsystem, "event": event}
        if trace is not None:
            ev["trace"] = trace
        if attrs:
            ev["attrs"] = attrs
        with self._lock:
            self._seq += 1
            ev["seq"] = self._seq
            self._events.append(ev)
        return ev

    # -- reading -----------------------------------------------------------
    @property
    def total(self) -> int:
        """Events ever recorded (> len(tail) once the ring wrapped)."""
        with self._lock:
            return self._seq

    def events(self, subsystem: Optional[str] = None,
               severity: Optional[str] = None,
               trace: Optional[str] = None) -> List[Dict[str, Any]]:
        """The retained ring, oldest first, optionally filtered."""
        with self._lock:
            out = [dict(e) for e in self._events]
        if subsystem is not None:
            out = [e for e in out if e["subsystem"] == subsystem]
        if severity is not None:
            floor = SEVERITIES.index(severity)
            out = [e for e in out
                   if SEVERITIES.index(e["severity"]) >= floor]
        if trace is not None:
            out = [e for e in out if e.get("trace") == trace]
        return out

    def tail(self, n: int = 64) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(e) for e in list(self._events)[-int(n):]]

    def clear(self) -> None:
        """Test isolation only — production rings just wrap."""
        with self._lock:
            self._events.clear()
            self._seq = 0

    # -- dumping -----------------------------------------------------------
    def dump(self, path: Optional[str] = None,
             reason: Optional[str] = None) -> str:
        """Write the full retained ring as JSONL (one event per line,
        preceded by one header line identifying the dump). The dump
        itself is recorded as an event FIRST, so the file explains its
        own existence."""
        with self._dump_lock:
            self.record("recorder", "dump", reason=reason or "manual")
            path = path or default_dump_path()
            events = self.events()
            header = {"dump": True, "reason": reason or "manual",
                      "pid": os.getpid(), "wall": time.time(),
                      "events_total": self.total,
                      "events_retained": len(events)}
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
            tmp = f"{path}.tmp"
            with open(tmp, "w") as f:
                f.write(json.dumps(header, default=str) + "\n")
                for e in events:
                    f.write(json.dumps(e, default=str) + "\n")
            os.replace(tmp, path)   # readers never see a half dump
            with self._lock:
                self.last_dump_path = path
                self.dumps += 1
            return path

    def auto_dump(self, reason: str) -> Optional[str]:
        """Best-effort dump on an incident boundary (rollback, crash,
        fleet stop). NEVER raises — losing the dump must not compound
        the incident — but never silent either: a failed write lands as
        an error event in the ring the next dump will carry."""
        try:
            return self.dump(reason=reason)
        except Exception as e:      # noqa: BLE001 — incident path
            try:
                self.record("recorder", "dump_failed", severity="error",
                            reason=reason, error=f"{type(e).__name__}: {e}")
            except Exception:       # noqa: BLE001
                pass
            return None


def load_dump(path: str) -> List[Dict[str, Any]]:
    """Read a dump file back into event dicts (header line skipped) —
    the `telemetry` CLI's and the drill tests' reader."""
    events = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            doc = json.loads(line)
            if doc.get("dump"):
                continue            # the header line
            events.append(doc)
    return events


#: THE process flight recorder (control-plane events are process-scoped
#: facts, same rationale as faults.STATS / SWEEP_STATS).
RECORDER = FlightRecorder()


def record(subsystem: str, event: str, severity: str = "info",
           trace: Optional[str] = None, **attrs) -> Dict[str, Any]:
    """Module-level convenience: ``RECORDER.record(...)``."""
    return RECORDER.record(subsystem, event, severity=severity,
                           trace=trace, **attrs)
