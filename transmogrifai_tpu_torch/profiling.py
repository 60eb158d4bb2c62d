"""Serving counters of the ported path: the jax-free part of
``transmogrifai_tpu.profiling``.

* ``SnapshotStats`` — the ``snapshot_seq`` torn-read convention.
* ``ScoringStats`` — per-bucket batch/row/padding counters of one
  ``workflow.FusedScorer`` (without the JAX package's compile counter:
  PyTorch runs eagerly, so there is no program trace to count).
* ``FaultStats`` — arrival/injection counters of the fault harness.
* ``EngineStats`` — the serving engine's queue, wait, fused-plane,
  per-model/per-tenant and host-overhead counters, with the shared
  ``percentile_nearest_rank`` and ``shape_bucket`` helpers.
* ``SweepStats`` — execute and per-device dispatch attribution of the
  validation sweep's batches (``SWEEP_STATS``), without the JAX
  package's compile entries: nothing is traced.
* ``check_finite`` — the post-fit guard on fitted parameters.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Any, Dict, Iterator, Optional


class SnapshotStats:
    """THE ``snapshot_seq`` torn-read convention, in one place.

    Every stats class below used to hand-roll the same three-line
    ritual (a lock, a monotonic mutation counter bumped inside every
    write's lock hold, a one-lock-hold snapshot carrying the counter).
    This base is that ritual: subclasses mutate via :meth:`_bump`
    (uniform counter adds) or inside a ``with self._mutating():`` block
    (anything else), and take snapshots under one ``self._lock`` hold
    that includes ``self._seq`` as ``snapshot_seq``. A scraper reading
    two snapshots with EQUAL seqs knows nothing moved between them;
    unequal seqs prove the read straddled a mutation — never a torn
    aggregate across separately-polled endpoints."""

    def __init__(self):
        self._lock = threading.Lock()
        self._seq = 0

    def _bump(self, **fields) -> None:
        with self._lock:
            self._seq += 1
            for k, v in fields.items():
                setattr(self, k, getattr(self, k) + v)

    @contextlib.contextmanager
    def _mutating(self) -> Iterator[None]:
        """Lock hold + seq bump for writes `_bump` can't express."""
        with self._lock:
            self._seq += 1
            yield


class ScoringStats(SnapshotStats):
    """Per-bucket serving counters for the (bucketed) fused scorer.

    One instance rides each FusedScorer; keys are padded row-bucket
    sizes (or the exact batch size when bucketing is off). The lock
    keeps the counters safe to update from the engine's dispatcher and
    to READ from any thread — a metrics scraper polling as_dict()."""

    def __init__(self):
        super().__init__()
        self.batches: Dict[int, int] = {}
        self.rows: Dict[int, int] = {}
        self.padded_rows: Dict[int, int] = {}
        self.seconds = 0.0

    # -- recording (FusedScorer internals) --------------------------------
    def note_batch(self, bucket: int, rows: int) -> None:
        with self._mutating():
            self.batches[bucket] = self.batches.get(bucket, 0) + 1
            self.rows[bucket] = self.rows.get(bucket, 0) + rows
            self.padded_rows[bucket] = (self.padded_rows.get(bucket, 0)
                                        + max(bucket - rows, 0))

    def add_seconds(self, dt: float) -> None:
        with self._mutating():
            self.seconds += dt

    @contextlib.contextmanager
    def timed(self) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add_seconds(time.perf_counter() - t0)

    # -- reading ----------------------------------------------------------
    @property
    def total_rows(self) -> int:
        with self._lock:
            return sum(self.rows.values())

    @property
    def total_padded_rows(self) -> int:
        with self._lock:
            return sum(self.padded_rows.values())

    def rows_per_sec(self) -> Optional[float]:
        with self._lock:
            n = sum(self.rows.values())
            return n / self.seconds if self.seconds > 0 else None

    def padding_overhead(self) -> float:
        """Fraction of device rows that were padding (wasted compute)."""
        with self._lock:
            rows = sum(self.rows.values())
            pad = sum(self.padded_rows.values())
            return pad / (rows + pad) if (rows + pad) else 0.0

    def as_dict(self) -> Dict[str, Any]:
        """JSON-ready snapshot (bench sections, the serve CLI, the
        engine's /health status) — one consistent locked snapshot,
        aggregates derived once from it. `snapshot_seq` is a monotonic
        mutation counter taken inside the same lock hold: a scraper that
        reads two snapshots with equal seq knows NOTHING moved between
        them (no torn read across separately-polled endpoints)."""
        with self._lock:
            seq = self._seq
            batches = dict(self.batches)
            rows = dict(self.rows)
            padded = dict(self.padded_rows)
            seconds = self.seconds
        n_rows = sum(rows.values())
        n_padded = sum(padded.values())
        return {
            "snapshot_seq": seq,
            "per_bucket": {
                str(b): {"batches": batches.get(b, 0),
                         "rows": rows.get(b, 0),
                         "padded_rows": padded.get(b, 0)}
                for b in sorted(batches)},
            "total_rows": n_rows,
            "total_padded_rows": n_padded,
            "padding_overhead": (n_padded / (n_rows + n_padded)
                                 if (n_rows + n_padded) else 0.0),
            "seconds": seconds,
            "rows_per_sec": n_rows / seconds if seconds > 0 else None,
        }



class FaultStats:
    """Arrival/injection counters for the deterministic fault harness
    (resilience.faults). ``arrivals`` counts every pass through an
    armed injection point; ``injected`` counts faults actually fired,
    keyed ``point:kind`` — a fault drill asserts against these, so a
    spec that never fires (wrong nth, wrong point) fails the test
    instead of silently proving nothing. Counting only happens while a
    TM_FAULTS spec is armed."""

    def __init__(self):
        self._lock = threading.Lock()
        self.arrivals: Dict[str, int] = {}
        self.injected: Dict[str, int] = {}

    def reset(self) -> None:
        with self._lock:
            self.arrivals.clear()
            self.injected.clear()

    def note_arrival(self, point: str) -> int:
        """Count + return this point's (1-based) arrival ordinal."""
        with self._lock:
            n = self.arrivals.get(point, 0) + 1
            self.arrivals[point] = n
            return n

    def note_injected(self, point: str, kind: str) -> None:
        with self._lock:
            key = f"{point}:{kind}"
            self.injected[key] = self.injected.get(key, 0) + 1

    @property
    def total_injected(self) -> int:
        with self._lock:
            return sum(self.injected.values())

    def as_dict(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {"arrivals": dict(self.arrivals),
                    "injected": dict(self.injected)}


def percentile_nearest_rank(sorted_vals, q: float) -> float:
    """Nearest-rank percentile over pre-sorted values (0.0 on empty).
    THE percentile definition for every serving latency number — the
    engine's wait and host-overhead p50/p99 and ``chip_smoke.py``'s
    request latencies all call this one formula so their reported
    numbers stay comparable (the JAX package uses the same one)."""
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1) + 0.5))
    return sorted_vals[i]


def shape_bucket(rows: int) -> int:
    """Power-of-two ceiling of a batch row count (0 stays 0) — THE
    bucketing for the engine's observed batch-shape mix. Pow2 bounds
    the label cardinality of the ``tm_engine_batch_shape_total``
    /metricsz family no matter what the traffic looks like; the exact
    per-batch row counts ride EngineStats' bounded ring for the bucket
    tuner (autotune.buckets.observed_mix), which needs full
    resolution."""
    rows = int(rows)
    if rows <= 0:
        return 0
    return 1 << (rows - 1).bit_length()


class EngineStats(SnapshotStats):
    """Serving-engine counters (serving.engine.ServingEngine): queue
    depth gauges, per-request wait times, coalesced micro-batch shape,
    and the degraded-mode counters admission control promises are never
    silent (shed/rejected requests each land in exactly one counter).

    Wait-time percentiles come from a bounded ring of the most recent
    samples — a scraper gets recent-traffic p50/p99 without the engine
    holding unbounded history. Snapshot discipline is the shared
    SnapshotStats base: one lock hold per as_dict(), plus a monotonic
    `snapshot_seq` so torn reads across polls are detectable."""

    #: distinct tenant ids tracked exactly; traffic from any further
    #: tenant aggregates under "other" (an adversarial stream of unique
    #: tenant strings must not grow this dict without bound)
    TENANT_TRACK_LIMIT = 256

    #: host-overhead clock segments, in request-pipeline order:
    #: submit-side admission+prepare+enqueue work, queue residency,
    #: batch build/launch, scatter+future resolution. The engine stamps
    #: monotonic times on the request record and books one sample per
    #: SERVED request; the per-sample total is the exact float sum of
    #: its segments (pinned by tests), so a profile that ranks segments
    #: accounts for all measured host time.
    OVERHEAD_SEGMENTS = ("admission", "queue", "build", "resolve")

    def __init__(self, wait_samples: int = 4096, model_topk: int = 10):
        super().__init__()
        self.submitted = 0          # requests accepted into the queue
        self.completed = 0          # requests whose future got a result
        self.failed = 0             # requests whose future got an error
        self.shed_expired = 0       # deadline passed while queued
        self.cancelled = 0          # caller cancelled the future pre-dispatch
        self.rejected_queue_full = 0
        self.rejected_predicted_late = 0   # EMA said deadline unmeetable
        self.rejected_tenant_budget = 0    # one tenant's share exhausted
        self.batches = 0            # coalesced device micro-batches
        self.batched_rows = 0
        self.batched_requests = 0
        self.swaps = 0              # registry hot-swaps observed
        #: device-side fused cross-model plane (TM_SERVE_FUSED_KERNEL):
        #: one fused launch co-scores fused_models backends' requests
        #: in ONE device dispatch; fallbacks count stack-ineligible
        #: groups that kept the classic path while fusion was on
        self.fused_batches = 0
        self.fused_requests = 0
        self.fused_rows = 0
        self.fused_models = 0       # cumulative co-scored model count
        self.fused_fallbacks = 0
        self.queue_depth_requests = 0      # gauges (set, not summed)
        self.queue_depth_rows = 0
        self.wait_seconds_total = 0.0
        self.wait_seconds_max = 0.0
        self._waits = deque(maxlen=wait_samples)
        #: observed batch-shape mix: pow2 rows-bucket -> batches (the
        #: cumulative, bounded-cardinality view)
        self.batch_shape_counts: Dict[int, int] = {}
        #: per-model / per-tenant traffic attribution (multi-model
        #: serving). Models are bounded by the registry catalog (alias
        #: ids included); the SNAPSHOT view is top-``model_topk`` by
        #: requests plus an aggregated "other" bucket, so a 10k-model
        #: catalog cannot blow up /statusz or a /metricsz scrape.
        #: Tenants cap at TENANT_TRACK_LIMIT exact entries.
        self.model_topk = int(model_topk)
        self.model_requests: Dict[str, int] = {}
        self.model_rows: Dict[str, int] = {}
        self.tenant_requests: Dict[str, int] = {}
        self.tenant_rows: Dict[str, int] = {}
        #: host-overhead clock (always-on, booked once per SERVED
        #: request in the dispatcher's one-lock-per-group sweep):
        #: cumulative seconds per segment + bounded rings of recent
        #: per-request samples for the p50/p99 snapshot view
        self.host_overhead_requests = 0
        self.host_admission_seconds = 0.0
        self.host_queue_seconds = 0.0
        self.host_build_seconds = 0.0
        self.host_resolve_seconds = 0.0
        self._oh_admission = deque(maxlen=wait_samples)
        self._oh_queue = deque(maxlen=wait_samples)
        self._oh_build = deque(maxlen=wait_samples)
        self._oh_resolve = deque(maxlen=wait_samples)
        self._oh_total = deque(maxlen=wait_samples)

    def note_fused(self, requests: int, rows: int, models: int) -> None:
        """One fused family launch completed: ``models`` backends'
        requests scored in ONE device dispatch."""
        self._bump(fused_batches=1, fused_requests=requests,
                   fused_rows=rows, fused_models=models)

    def note_fused_fallback(self) -> None:
        """A two-phase group could not stack (non-linear family,
        multi-result tail) and kept the classic path with fusion on."""
        self._bump(fused_fallbacks=1)

    def note_failed(self, n: int = 1) -> None:
        self._bump(failed=n)

    def note_shed(self, n: int = 1) -> None:
        self._bump(shed_expired=n)

    def note_cancelled(self, n: int = 1) -> None:
        self._bump(cancelled=n)

    def note_rejected(self, reason: str) -> None:
        if reason == "queue_full":
            self._bump(rejected_queue_full=1)
        elif reason == "predicted_late":
            self._bump(rejected_predicted_late=1)
        elif reason == "tenant_budget":
            self._bump(rejected_tenant_budget=1)
        else:
            raise ValueError(f"unknown rejection reason {reason!r}")

    def note_swap(self) -> None:
        self._bump(swaps=1)

    def note_queue_depth(self, requests: int, rows: int) -> None:
        with self._mutating():
            self.queue_depth_requests = requests
            self.queue_depth_rows = rows

    # -- batched dispatch-plane bookkeeping: one lock hold per drain
    # -- pass / finalized group instead of one (or several) per request

    def note_submit_depth(self, requests: int, rows: int) -> None:
        """One accepted submit + the queue-depth gauges it produced,
        under ONE lock hold."""
        with self._lock:
            self._seq += 1
            self.submitted += 1
            self.queue_depth_requests = requests
            self.queue_depth_rows = rows

    def note_dispatch_waits(self, waits) -> None:
        """All of one drain pass's wait samples under ONE lock hold."""
        with self._mutating():
            total = self.wait_seconds_total
            mx = self.wait_seconds_max
            for w in waits:
                total += w
                if w > mx:
                    mx = w
            self.wait_seconds_total = total
            self.wait_seconds_max = mx
            self._waits.extend(waits)

    def note_group_complete(self, requests: int, rows: int, traffic,
                            overhead) -> None:
        """One finalized co-batch group's COMPLETE bookkeeping —
        batch shape, model/tenant attribution, completion outcomes and
        host-overhead samples — under one lock hold.

        ``traffic`` is an iterable of (model, tenant, rows) per
        request; ``overhead`` an iterable of (admission, queue, build,
        resolve) second tuples (may be empty)."""
        with self._mutating():
            self.batches += 1
            self.batched_requests += requests
            self.batched_rows += rows
            b = shape_bucket(rows)
            self.batch_shape_counts[b] = \
                self.batch_shape_counts.get(b, 0) + 1
            mreq = self.model_requests
            mrow = self.model_rows
            treq = self.tenant_requests
            trow = self.tenant_rows
            limit = self.TENANT_TRACK_LIMIT
            for model, tenant, n in traffic:
                mreq[model] = mreq.get(model, 0) + 1
                mrow[model] = mrow.get(model, 0) + n
                if tenant not in treq and len(treq) >= limit:
                    tenant = "other"
                treq[tenant] = treq.get(tenant, 0) + 1
                trow[tenant] = trow.get(tenant, 0) + n
            self.completed += requests
            if overhead:
                self._book_overhead(overhead)

    def _book_overhead(self, overhead) -> None:
        """Callers hold self._lock (via _mutating)."""
        for adm, queue, build, resolve in overhead:
            self.host_admission_seconds += adm
            self.host_queue_seconds += queue
            self.host_build_seconds += build
            self.host_resolve_seconds += resolve
            self._oh_admission.append(adm)
            self._oh_queue.append(queue)
            self._oh_build.append(build)
            self._oh_resolve.append(resolve)
            self._oh_total.append(adm + queue + build + resolve)
            self.host_overhead_requests += 1

    _percentile = staticmethod(percentile_nearest_rank)

    @staticmethod
    def _models_view(reqs: Dict[str, int], rows: Dict[str, int],
                     k: int) -> Dict[str, Any]:
        """Bounded per-model traffic view from already-copied counter
        dicts: the top-``k`` model ids by cumulative requests (each a
        monotonic counter while listed) plus an aggregated ``other``
        remainder and the distinct catalog count — the /statusz +
        /metricsz shape that keeps a 10k-model catalog scrapeable."""
        top = sorted(reqs, key=lambda m: (-reqs[m], m))[:k]
        other_req = sum(v for m, v in reqs.items() if m not in top)
        other_rows = sum(v for m, v in rows.items() if m not in top)
        return {
            "top": {m: {"requests": reqs[m], "rows": rows.get(m, 0)}
                    for m in top},
            "other": {"requests": other_req, "rows": other_rows,
                      "models": max(0, len(reqs) - len(top))},
            "distinct": len(reqs),
        }

    @staticmethod
    def _tenants_view(reqs: Dict[str, int], rows: Dict[str, int]
                      ) -> Dict[str, Dict[str, int]]:
        return {t: {"requests": reqs[t], "rows": rows.get(t, 0)}
                for t in sorted(reqs)}

    @staticmethod
    def _overhead_view(requests: int, totals, rings) -> Dict[str, Any]:
        """The ``requestOverhead`` snapshot block from already-copied
        ring/total state (computed OUTSIDE the stats lock — sorting
        five rings under it would extend every submitter's critical
        section, the exact hazard the wait-percentile fix removed).
        All values are µs; ``totals``/``rings`` line up with
        OVERHEAD_SEGMENTS + a trailing all-segments total."""
        pct = EngineStats._percentile
        names = EngineStats.OVERHEAD_SEGMENTS + ("total",)
        out: Dict[str, Any] = {"requests": requests,
                               "samples": len(rings[-1])}
        segments: Dict[str, Any] = {}
        for name, total, ring in zip(names, totals, rings):
            vals = sorted(ring)
            segments[name] = {
                "p50_us": pct(vals, 0.50) * 1e6,
                "p99_us": pct(vals, 0.99) * 1e6,
                "total_us": total * 1e6,
            }
        out["total"] = segments.pop("total")
        out["segments"] = segments
        return out

    def as_dict(self) -> Dict[str, Any]:
        with self._lock:
            seq = self._seq
            out = {
                "snapshot_seq": seq,
                "submitted": self.submitted,
                "completed": self.completed,
                "failed": self.failed,
                "shed_expired": self.shed_expired,
                "cancelled": self.cancelled,
                "rejected_queue_full": self.rejected_queue_full,
                "rejected_predicted_late": self.rejected_predicted_late,
                "rejected_tenant_budget": self.rejected_tenant_budget,
                "batches": self.batches,
                "batched_rows": self.batched_rows,
                "batched_requests": self.batched_requests,
                "swaps": self.swaps,
                "fused_batches": self.fused_batches,
                "fused_requests": self.fused_requests,
                "fused_rows": self.fused_rows,
                "fused_models": self.fused_models,
                "fused_fallbacks": self.fused_fallbacks,
                "queue_depth_requests": self.queue_depth_requests,
                "queue_depth_rows": self.queue_depth_rows,
                "wait_seconds_total": self.wait_seconds_total,
                "wait_seconds_max": self.wait_seconds_max,
                "batch_shapes": {str(b): c for b, c in
                                 sorted(self.batch_shape_counts.items())},
            }
            # copy the attribution dicts INSIDE the same hold as the
            # counters (one-lock-hold-per-as_dict contract): per-model/
            # per-tenant sums must reconcile with batched_requests in
            # one snapshot, never straddle a concurrent booking
            model_reqs = dict(self.model_requests)
            model_rows = dict(self.model_rows)
            tenant_reqs = dict(self.tenant_requests)
            tenant_rows = dict(self.tenant_rows)
            topk = self.model_topk
            # COPY the rings under the lock; sort + percentiles happen
            # outside it. Sorting in here made every /metricsz scrape
            # extend every submitter's critical section by an
            # O(n log n) pass over the ring.
            waits = list(self._waits)
            oh_requests = self.host_overhead_requests
            oh_totals = (self.host_admission_seconds,
                         self.host_queue_seconds,
                         self.host_build_seconds,
                         self.host_resolve_seconds,
                         self.host_admission_seconds
                         + self.host_queue_seconds
                         + self.host_build_seconds
                         + self.host_resolve_seconds)
            oh_rings = (list(self._oh_admission), list(self._oh_queue),
                        list(self._oh_build), list(self._oh_resolve),
                        list(self._oh_total))
        out["models"] = self._models_view(model_reqs, model_rows, topk)
        out["tenants"] = self._tenants_view(tenant_reqs, tenant_rows)
        out["requests_per_batch"] = (out["batched_requests"] / out["batches"]
                                     if out["batches"] else 0.0)
        waits.sort()
        out["wait_p50_ms"] = self._percentile(waits, 0.50) * 1e3
        out["wait_p99_ms"] = self._percentile(waits, 0.99) * 1e3
        out["requestOverhead"] = self._overhead_view(
            oh_requests, oh_totals, oh_rings)
        return out


class SweepStats:
    """Execute-time attribution of the validation sweep's batches
    (models/tuning.py ``_SweepBatch``), keyed by a readable program
    label (family / metric / classes / static hypers / sliced):
    cumulative execute wall and dispatch count, and per device the
    dispatches and REAL (unpadded) items it carried. ``snapshot()`` /
    ``delta()`` attribute one fit's share."""

    def __init__(self):
        self._lock = threading.Lock()
        self.programs: Dict[str, Dict[str, Any]] = {}

    def _rec(self, label: str, batch: int) -> Dict[str, Any]:
        return self.programs.setdefault(label, {
            "dispatches": 0, "execute_s": 0.0, "batch": int(batch)})

    def note_execute(self, label: str, seconds: float, batch: int) -> None:
        with self._lock:
            rec = self._rec(label, batch)
            rec["dispatches"] += 1
            rec["execute_s"] += float(seconds)
            rec["batch"] = int(batch)

    def note_device_dispatch(self, label: str, devices, items) -> None:
        """One launch's per-device work: ``items[i]`` real sweep items
        on ``devices[i]``."""
        with self._lock:
            devs = self._rec(label, 0).setdefault("devices", {})
            for dev, n in zip(devices, items):
                e = devs.setdefault(dev, {"dispatches": 0, "items": 0})
                e["dispatches"] += 1
                e["items"] += int(n)

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            out = {}
            for k, v in self.programs.items():
                rec = dict(v)
                if "devices" in rec:
                    rec["devices"] = {d: dict(c)
                                      for d, c in rec["devices"].items()}
                out[k] = rec
            return out

    @staticmethod
    def delta(before: Dict[str, Dict[str, Any]],
              after: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
        """Per-program counter delta between two snapshots + totals."""
        progs: Dict[str, Dict[str, Any]] = {}
        devices: Dict[str, Dict[str, int]] = {}
        for label, rec in after.items():
            prev = before.get(label, {})
            d = {k: rec[k] - prev.get(k, 0)
                 for k in ("dispatches", "execute_s")}
            d["batch"] = rec["batch"]
            prev_dev = prev.get("devices") or {}
            devs = {}
            for dev, c in (rec.get("devices") or {}).items():
                p = prev_dev.get(dev, {})
                dd = {k: c[k] - p.get(k, 0) for k in ("dispatches", "items")}
                if dd["dispatches"] or dd["items"]:
                    devs[dev] = dd
                    e = devices.setdefault(dev, {"dispatches": 0, "items": 0})
                    e["dispatches"] += dd["dispatches"]
                    e["items"] += dd["items"]
            if devs:
                d["devices"] = devs
            if d["dispatches"] or devs:
                progs[label] = d
        out = {"programs": progs,
               "dispatches": sum(p["dispatches"] for p in progs.values()),
               "execute_s": sum(p["execute_s"] for p in progs.values())}
        if devices:
            out["devices"] = devices
        return out


#: process-wide sweep attribution
SWEEP_STATS = SweepStats()


def check_finite(tree: Any, what: str = "parameters",
                 allow_inf: bool = False, _path: str = "") -> None:
    """Raise with a named path when any float array leaf of a (nested
    dict / list) numpy pytree holds NaN (and Inf unless allow_inf —
    tree params legitimately use +inf no-split thresholds). Cheap
    post-fit guard; the reference's equivalent is Spark task failure."""
    import numpy as np

    if isinstance(tree, dict):
        for k in sorted(tree):
            check_finite(tree[k], what, allow_inf, f"{_path}[{k!r}]")
        return
    if isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            check_finite(v, what, allow_inf, f"{_path}[{i}]")
        return
    arr = np.asarray(tree)
    if arr.dtype.kind != "f":
        return
    bad = (np.isnan(arr).any() if allow_inf
           else not np.isfinite(arr).all())
    if bad:
        raise FloatingPointError(
            f"non-finite values in {what} at {_path}")
