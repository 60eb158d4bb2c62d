"""Shadow scoring: mirror live traffic onto a CANDIDATE model.

The continuum loop's gate between "the retrain produced a model" and
"the fleet serves it": a :class:`ShadowScorer` attaches to the serving
request plane as a tap (``engine.add_tap`` / ``fleet.add_tap``), and
for each mirrored request scores the SAME rows on the candidate's own
backend, comparing against the result the live default actually
returned. Candidate scores are never returned to callers — the only
outputs are comparison statistics and a pass/fail verdict.

Isolation contract (what makes this safe to run against production
traffic):

* the tap callback is O(1): it only attaches a done-callback to the
  live future and the callback only enqueues into a BOUNDED queue —
  when the shadow worker falls behind, observations are dropped (and
  counted), never buffered unboundedly and never back-pressured into
  the live path;
* candidate scoring runs on the shadow worker thread through the
  candidate's own scorer — it shares host CPU (measured by
  ``bench.py drift_loop`` as live-path p99 overhead) but never the live
  engine's queue, dispatcher, or registry;
* ``sample_every=k`` shadows every k-th accepted request, the knob for
  bounding that CPU share on small hosts;
* a candidate failure (raise, NaN output, row-count mismatch) is a
  counted comparison outcome that fails the verdict — exactly what the
  gate exists to catch. The ``continuum.shadow.score`` TM_FAULTS point
  fires per mirrored request, so the bad-candidate drill is one spec:
  ``continuum.shadow.score:raise-fatal:1+``.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Any, Dict, Optional

import numpy as np

from ..resilience.faults import fault_point
from ..telemetry import spans as _spans

__all__ = ["ShadowScorer", "shadow_backend"]


def shadow_backend(model, *, buckets=True, warm_sample=None,
                   device=None):
    """A scoring backend for a candidate WorkflowModel, compiled on the
    SAME bucket ladder (and ``device``: None keeps the model's own)
    the live fleet serves with, so shadow-measured behavior is the
    behavior a promotion would ship. Warming is optional — shadow
    traffic is not latency-sensitive — but a warm sample keeps the
    first mirrored comparisons off a cold first pass."""
    from .registry import _FusedBackend
    backend = _FusedBackend(model.compile_scoring(buckets=buckets,
                                                  device=device))
    if warm_sample is not None:
        backend.warm(warm_sample)
    return backend


class ShadowScorer:
    """See module docstring. Lifecycle: construct → ``start()`` →
    ``serving.add_tap(scorer.observe)`` → traffic flows → remove tap →
    ``stop()`` → ``verdict(...)``."""

    def __init__(self, backend, *, max_queue: int = 256,
                 sample_every: int = 1):
        if sample_every < 1:
            raise ValueError("sample_every must be >= 1")
        self.backend = backend
        self.max_queue = int(max_queue)
        self.sample_every = int(sample_every)
        self._lock = threading.Lock()
        self._queue: deque = deque()
        self._cond = threading.Condition(self._lock)
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._seen = 0              # accepted requests observed (sampling)
        # comparison accumulators (under _lock)
        self.samples = 0            # mirrored requests candidate-scored
        self.rows = 0
        self.errors = 0             # candidate raised / row mismatch
        self.dropped = 0            # queue-full drops (worker behind)
        self.live_errors = 0        # live side failed; nothing to compare
        self.nonfinite = 0          # candidate outputs with NaN/Inf
        self.sum_abs_delta = 0.0
        self.delta_elems = 0
        self.max_abs_delta = 0.0
        self.disagree = 0           # argmax mismatches (classification)
        self.disagree_n = 0
        self.candidate_seconds = 0.0
        self.last_error: Optional[str] = None

    # -- the tap (live submit thread / router thread) ----------------------
    def observe(self, data, live_future) -> None:
        """The request-plane tap. O(1): sampling decision + one
        done-callback registration; all real work happens on the shadow
        worker thread once the LIVE result exists."""
        with self._lock:
            self._seen += 1
            if (self._seen - 1) % self.sample_every != 0:
                return

        def on_done(fut):
            exc = fut.exception()
            with self._cond:
                if not self._running:
                    return
                if exc is not None:
                    self.live_errors += 1   # nothing to compare against
                    return
                if len(self._queue) >= self.max_queue:
                    self.dropped += 1       # bounded: drop, never block
                    return
                # the live request's trace id (if sampled) rides along
                # so the mirrored comparison lands in the same trace
                self._queue.append((data, fut.result(),
                                    _spans.get_trace(fut)))
                self._cond.notify()

        live_future.add_done_callback(on_done)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "ShadowScorer":
        with self._cond:
            if self._running:
                return self
            self._running = True
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="tm-shadow-scorer")
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        with self._cond:
            self._running = False
            self._cond.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout)

    def __enter__(self) -> "ShadowScorer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- worker ------------------------------------------------------------
    def _worker(self) -> None:
        import time
        while True:
            with self._cond:
                while self._running and not self._queue:
                    self._cond.wait()
                if not self._running:
                    return
                data, live, trace = self._queue.popleft()
            t0 = time.perf_counter()
            t_mono = time.monotonic()
            try:
                fault_point("continuum.shadow.score")
                n, vals = self.backend.prepare(data)
                out = self.backend.run(n, vals)
            except Exception as e:      # noqa: BLE001 — THE gate signal
                _spans.TRACER.record(trace, "shadow.score", t_mono,
                                     time.monotonic(), cat="continuum",
                                     outcome=type(e).__name__)
                with self._lock:
                    self.samples += 1
                    self.errors += 1
                    self.last_error = f"{type(e).__name__}: {e}"
                continue
            dt = time.perf_counter() - t0
            _spans.TRACER.record(trace, "shadow.score", t_mono,
                                 time.monotonic(), cat="continuum",
                                 rows=int(n), outcome="ok")
            self._compare(n, out, live, dt)

    def _compare(self, n: int, out: Dict[str, Any],
                 live: Dict[str, Any], seconds: float) -> None:
        """Fold one mirrored comparison into the accumulators. Compared
        per shared result name: elementwise |candidate - live| moments,
        argmax disagreement for (n, k>=2) classification matrices, and
        a non-finite scan of the candidate side."""
        err = None
        abs_sum = 0.0
        abs_max = 0.0
        elems = 0
        disagree = disagree_n = 0
        nonfinite = 0
        shared = [k for k in out if k in live]
        if not shared:
            err = "no shared result columns between candidate and live"
        for k in shared:
            c = np.asarray(out[k], dtype=np.float64)
            l = np.asarray(live[k], dtype=np.float64)
            if c.shape != l.shape:
                err = (f"result {k!r} shape {c.shape} vs live {l.shape}")
                break
            nonfinite += int(np.size(c) - np.isfinite(c).sum())
            d = np.abs(c - l)
            abs_sum += float(d.sum())
            abs_max = max(abs_max, float(d.max()) if d.size else 0.0)
            elems += int(d.size)
            if c.ndim == 2 and c.shape[1] >= 2 and c.shape[0]:
                disagree += int((np.argmax(c, axis=1)
                                 != np.argmax(l, axis=1)).sum())
                disagree_n += int(c.shape[0])
        with self._lock:
            self.samples += 1
            self.rows += int(n)
            self.candidate_seconds += seconds
            if err is not None:
                self.errors += 1
                self.last_error = err
                return
            self.nonfinite += nonfinite
            self.sum_abs_delta += abs_sum
            self.delta_elems += elems
            if abs_max > self.max_abs_delta:
                self.max_abs_delta = abs_max
            self.disagree += disagree
            self.disagree_n += disagree_n

    # -- reading -----------------------------------------------------------
    def summary(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "samples": self.samples,
                "rows": self.rows,
                "errors": self.errors,
                "live_errors": self.live_errors,
                "dropped": self.dropped,
                "nonfinite": self.nonfinite,
                "mean_abs_delta": (self.sum_abs_delta / self.delta_elems
                                   if self.delta_elems else 0.0),
                "max_abs_delta": self.max_abs_delta,
                "disagreement": (self.disagree / self.disagree_n
                                 if self.disagree_n else 0.0),
                "candidate_seconds": self.candidate_seconds,
                "last_error": self.last_error,
            }

    def verdict(self, *, min_samples: int, max_error_rate: float = 0.0,
                max_disagreement: float = 0.25,
                max_mean_abs_delta: Optional[float] = None
                ) -> Dict[str, Any]:
        """The metric-delta gate decision. FAIL-CLOSED: too few
        mirrored samples is a failure ("insufficient evidence"), not a
        vacuous pass — a candidate must earn promotion on observed
        traffic. Fails on candidate error rate, non-finite outputs,
        argmax disagreement above tolerance, and (optionally) mean
        absolute score delta."""
        s = self.summary()
        out = {"ok": True, "reason": None, **s}
        if s["samples"] < min_samples:
            out["ok"] = False
            out["reason"] = (f"insufficient mirrored traffic: "
                             f"{s['samples']} < {min_samples} samples")
            return out
        err_rate = s["errors"] / s["samples"]
        if err_rate > max_error_rate:
            out["ok"] = False
            out["reason"] = (f"candidate error rate {err_rate:.3f} > "
                             f"{max_error_rate} ({s['last_error']})")
            return out
        if s["nonfinite"] > 0:
            out["ok"] = False
            out["reason"] = (f"candidate produced {s['nonfinite']} "
                             f"non-finite score values")
            return out
        if s["disagreement"] > max_disagreement:
            out["ok"] = False
            out["reason"] = (f"candidate/live argmax disagreement "
                             f"{s['disagreement']:.3f} > "
                             f"{max_disagreement}")
            return out
        if max_mean_abs_delta is not None \
                and s["mean_abs_delta"] > max_mean_abs_delta:
            out["ok"] = False
            out["reason"] = (f"mean |candidate - live| score delta "
                             f"{s['mean_abs_delta']:.4f} > "
                             f"{max_mean_abs_delta}")
        return out
