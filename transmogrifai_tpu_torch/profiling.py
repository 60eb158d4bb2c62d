"""Counters and snapshots of the ported paths: the jax-free part of
``transmogrifai_tpu.profiling``, every snapshot keyed as the JAX
package's (``/statusz`` readers and the mirrored tests read the same
document).

* ``SnapshotStats`` — the ``snapshot_seq`` torn-read convention.
* ``ScoringStats`` — per-bucket compile/batch/row/padding counters of
  one ``workflow.FusedScorer`` (``compiles``: each bucket shape's first
  pass — the port traces no program).
* ``CacheStats`` / ``register_cache`` / ``program_caches_dict`` — the
  bounded caches ``/statusz`` lists as ``programCaches``: the serving
  engine's fused group scorers and the CUDA kernel libraries loaded,
  where the JAX package lists its XLA program caches.
* ``FaultStats`` — arrival/injection counters of the fault harness.
* ``EngineStats`` — the serving engine's queue, wait, outcome-ring,
  fused-plane, per-model/per-tenant, tap and host-overhead counters,
  with the shared ``percentile_nearest_rank`` and ``shape_bucket``
  helpers.
* ``FleetStats`` / ``TransportStats`` / ``ScalerStats`` /
  ``ContinuumStats`` — the fleet router, a socket transport's wire
  plane, the autoscaler and the continuum loop.
* ``SweepStats`` — execute and per-device dispatch attribution of the
  validation sweep's batches (``SWEEP_STATS``), without the JAX
  package's compile entries: nothing is traced.
* ``TrainStats`` — per-stage/per-layer observability of one
  ``Workflow.train`` (``train_summaries["stageTimings"]``).
* ``trace`` — a ``torch.profiler`` Chrome trace of a block (the
  runner's ``profile_location``, the CLI's ``TM_TRACE_DIR``).
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
    sizes (or the exact batch size when bucketing is off). `compiles`
    keeps the JAX package's key and counts each bucket shape's FIRST
    pass through this scorer — the port runs eagerly and traces no
    program, so the first pass at a shape (the warm pass, which pays
    the allocator and the kernel library's load) is what stands where
    a trace would; the bucketing guarantee (total compiles <=
    len(buckets)) reads the same. The lock keeps the counters safe to
    update from the engine's dispatcher and to READ from any thread —
    a metrics scraper polling as_dict()."""

    def __init__(self):
        super().__init__()
        self.compiles: Dict[int, int] = {}
        self.batches: Dict[int, int] = {}
        self.rows: Dict[int, int] = {}
        self.padded_rows: Dict[int, int] = {}
        self.seconds = 0.0

    # -- recording (FusedScorer internals) --------------------------------
    def note_compile(self, bucket: int) -> None:
        with self._mutating():
            self.compiles[bucket] = self.compiles.get(bucket, 0) + 1

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
    def total_compiles(self) -> int:
        with self._lock:
            return sum(self.compiles.values())

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
            compiles = dict(self.compiles)
            batches = dict(self.batches)
            rows = dict(self.rows)
            padded = dict(self.padded_rows)
            seconds = self.seconds
        n_rows = sum(rows.values())
        n_padded = sum(padded.values())
        return {
            "snapshot_seq": seq,
            "per_bucket": {
                str(b): {"compiles": compiles.get(b, 0),
                         "batches": batches.get(b, 0),
                         "rows": rows.get(b, 0),
                         "padded_rows": padded.get(b, 0)}
                for b in sorted(set(compiles) | set(batches))},
            "total_compiles": sum(compiles.values()),
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


class CacheStats:
    """Size/traffic counters for one bounded program cache.

    The stable-identity jit caches (tuning._FIT_EVAL_CACHE /
    _FOLDED_PROGRAMS, selector._REFIT_PROGRAMS) are LRU-bounded; each
    registers here so a long-lived process can see how many compiled
    programs it is holding, how often they hit, and whether eviction is
    churning (an eviction storm means the bound is too small for the
    workload and every train is re-tracing). Read via
    `program_caches_dict()` — surfaced by serving /statusz."""

    def __init__(self, name: str, capacity: int):
        self._lock = threading.Lock()
        self.name = name
        self.capacity = int(capacity)
        self.size = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def note_hit(self) -> None:
        with self._lock:
            self.hits += 1

    def note_miss(self, size: int) -> None:
        with self._lock:
            self.misses += 1
            self.size = int(size)

    def note_evict(self, size: int) -> None:
        with self._lock:
            self.evictions += 1
            self.size = int(size)

    def as_dict(self) -> Dict[str, int]:
        with self._lock:
            return {"size": self.size, "capacity": self.capacity,
                    "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions}


#: name -> CacheStats for every registered bounded program cache
_PROGRAM_CACHES: Dict[str, CacheStats] = {}
_PROGRAM_CACHES_LOCK = threading.Lock()


def register_cache(name: str, capacity: int) -> CacheStats:
    """One CacheStats per cache name, created on first registration
    (module-level caches register at import; re-imports reuse)."""
    with _PROGRAM_CACHES_LOCK:
        st = _PROGRAM_CACHES.get(name)
        if st is None:
            st = _PROGRAM_CACHES[name] = CacheStats(name, capacity)
        return st


def program_caches_dict() -> Dict[str, Dict[str, int]]:
    """Every registered bounded cache, plus ``cuda.kernel_libraries``:
    the hand-written CUDA kernels' shared libraries this process built
    or loaded (``_cuda_build``; size = loaded, capacity = sources,
    misses = loads). The port traces no programs, so these stand where
    the JAX package lists its XLA program caches."""
    with _PROGRAM_CACHES_LOCK:
        caches = list(_PROGRAM_CACHES.values())
    out = {c.name: c.as_dict() for c in caches}
    from . import _cuda_build
    loaded = len(_cuda_build._LIBS)
    out["cuda.kernel_libraries"] = {
        "size": loaded, "capacity": len(_cuda_build.kernel_names()),
        "hits": 0, "misses": loaded, "evictions": 0}
    return out


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
    per-batch row counts ride EngineStats' bounded ring
    (``recent_batch_rows``) for readers that need full resolution."""
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
        self.tap_errors = 0         # request-tap callbacks that raised
        self.wait_seconds_total = 0.0
        self.wait_seconds_max = 0.0
        self._waits = deque(maxlen=wait_samples)
        #: recent request outcomes (True=completed, False=failed) — the
        #: rollout monitor's recent-history error-rate baseline
        self._outcomes = deque(maxlen=wait_samples)
        #: observed batch-shape mix: pow2 rows-bucket -> batches (the
        #: cumulative, bounded-cardinality /metricsz view) plus a ring
        #: of EXACT recent batch row counts (``recent_batch_rows``)
        self.batch_shape_counts: Dict[int, int] = {}
        self._batch_rows = deque(maxlen=wait_samples)
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

    def note_submit(self) -> None:
        self._bump(submitted=1)

    def note_fused(self, requests: int, rows: int, models: int) -> None:
        """One fused family launch completed: ``models`` backends'
        requests scored in ONE device dispatch."""
        self._bump(fused_batches=1, fused_requests=requests,
                   fused_rows=rows, fused_models=models)

    def note_fused_fallback(self) -> None:
        """A two-phase group could not stack (non-linear family,
        multi-result tail) and kept the classic path with fusion on."""
        self._bump(fused_fallbacks=1)

    def note_complete(self, n: int = 1) -> None:
        with self._mutating():
            self.completed += n
            self._outcomes.extend([True] * n)

    def note_failed(self, n: int = 1, ring: bool = True) -> None:
        """ring=False keeps the ledger counter moving WITHOUT booking a
        serving outcome: a non-drain stop flushing queued futures with
        EngineStopped is shutdown bookkeeping the router makes client-
        invisible by re-dispatching — recording those as ring failures
        would poison the next rollout's recent-history error baseline
        (a post-crash rollout would tolerate a genuinely bad candidate)."""
        with self._mutating():
            self.failed += n
            if ring:
                self._outcomes.extend([False] * n)

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

    def note_model_traffic(self, model: str, tenant: str,
                           rows: int) -> None:
        """One dispatched request's model/tenant attribution. Models
        track exactly (catalog-bounded); tenants past
        TENANT_TRACK_LIMIT distinct ids fold into "other"."""
        with self._mutating():
            self.model_requests[model] = \
                self.model_requests.get(model, 0) + 1
            self.model_rows[model] = self.model_rows.get(model, 0) + rows
            if tenant not in self.tenant_requests and \
                    len(self.tenant_requests) >= self.TENANT_TRACK_LIMIT:
                tenant = "other"
            self.tenant_requests[tenant] = \
                self.tenant_requests.get(tenant, 0) + 1
            self.tenant_rows[tenant] = \
                self.tenant_rows.get(tenant, 0) + rows

    def note_swap(self) -> None:
        self._bump(swaps=1)

    def note_tap_error(self) -> None:
        """A request-tap callback raised. The tap contract is that
        observers (drift monitor, shadow mirror) NEVER fail the live
        path — the exception is swallowed at the call site, but never
        silently: this counter is the evidence."""
        self._bump(tap_errors=1)

    def note_batch(self, requests: int, rows: int) -> None:
        with self._mutating():
            self.batches += 1
            self.batched_requests += requests
            self.batched_rows += rows
            b = shape_bucket(rows)
            self.batch_shape_counts[b] = self.batch_shape_counts.get(b, 0) + 1
            self._batch_rows.append(int(rows))

    def recent_batch_rows(self, last_n: int) -> list:
        """EXACT row counts of the last ``last_n`` coalesced batches —
        the bucket tuner's observed traffic mix (the pow2
        batch_shape_counts are the scrape-visible mirror)."""
        with self._lock:
            return list(self._batch_rows)[-int(last_n):] if last_n > 0 \
                else []

    def note_queue_depth(self, requests: int, rows: int) -> None:
        with self._mutating():
            self.queue_depth_requests = requests
            self.queue_depth_rows = rows

    def note_wait(self, seconds: float) -> None:
        with self._mutating():
            self.wait_seconds_total += seconds
            if seconds > self.wait_seconds_max:
                self.wait_seconds_max = seconds
            self._waits.append(seconds)

    # -- batched dispatch-plane bookkeeping (the request-plane fast
    # -- path): one lock hold per drain pass / finalized group instead
    # -- of one (or several) per request ------------------------------

    def note_submit_depth(self, requests: int, rows: int) -> None:
        """One accepted submit + the queue-depth gauges it produced,
        under ONE lock hold — the fast submit path's replacement for
        the note_queue_depth + note_submit pair (two stats-lock
        acquisitions per submit, one of them inside the engine
        condition hold)."""
        with self._lock:
            self._seq += 1
            self.submitted += 1
            self.queue_depth_requests = requests
            self.queue_depth_rows = rows

    def note_dispatch_waits(self, waits) -> None:
        """All of one drain pass's wait samples under ONE lock hold.
        Sample order and float accumulation order match the legacy
        per-request note_wait loop exactly (bitwise-pinned: sum, max
        and ring contents are identical)."""
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
        host-overhead samples — under one lock hold. Replaces the
        legacy note_batch + N x note_model_traffic + note_complete
        chain (2 + N stats-lock acquisitions per group) on the
        dispatcher hot path; every counter lands exactly as the legacy
        calls would have left it.

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
            self._batch_rows.append(int(rows))
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
            self._outcomes.extend([True] * requests)
            if overhead:
                self._book_overhead(overhead)

    def note_host_overhead(self, overhead) -> None:
        """Book host-overhead samples on their own (the legacy
        resolution path, which keeps its historical per-request
        bookkeeping, still carries the clock — one extra batched call
        per group, the same recording cost the fast path pays)."""
        with self._mutating():
            self._book_overhead(overhead)

    def _book_overhead(self, overhead) -> None:
        """Callers hold self._lock (via _mutating) — the lexical
        stats-discipline scan cannot see a caller's hold, hence the
        explicit waivers below."""
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

    def recent_host_overhead(self, last_n: int):
        """The last ``last_n`` per-request overhead samples as
        (admission, queue, build, resolve, total) second tuples — the
        segment-sum-equals-total pin's input (and any offline
        analysis that wants full resolution instead of percentiles)."""
        with self._lock:
            n = int(last_n)
            if n <= 0:
                return []
            return list(zip(list(self._oh_admission)[-n:],
                            list(self._oh_queue)[-n:],
                            list(self._oh_build)[-n:],
                            list(self._oh_resolve)[-n:],
                            list(self._oh_total)[-n:]))

    _percentile = staticmethod(percentile_nearest_rank)

    def recent_wait_ms(self, last_n: int, q: float) -> float:
        """Percentile (ms) over the LAST ``last_n`` wait samples only —
        the staged-rollout monitor's bake-window latency: counter
        deltas give how many requests the window served, and this
        slices exactly that many samples off the ring tail, so the
        verdict reflects the candidate version, not the mixed history
        the full-ring p99 would blend in."""
        with self._lock:
            tail = list(self._waits)[-int(last_n):] if last_n > 0 else []
        return self._percentile(sorted(tail), q) * 1e3

    def recent_outcomes(self, last_n: int) -> tuple:
        """(completed, failed) counts over the LAST ``last_n`` request
        outcomes — the rollout monitor's baseline error rate. Lifetime
        cumulative counters would not do: a crash storm hours ago
        inflates a lifetime rate until a candidate failing 25% of its
        bake passes the error-rate gate; the ring tail is what healthy
        serving looked like just before the rollout."""
        with self._lock:
            tail = list(self._outcomes)[-int(last_n):] if last_n > 0 else []
        ok = sum(1 for o in tail if o)
        return ok, len(tail) - ok

    def load_gauges(self) -> Dict[str, int]:
        """Queue-depth gauges only — O(1) under the lock. The
        autoscaler's tick polls this per replica several times a
        second; as_dict() would copy and sort the whole wait ring per
        poll (the same hazard outcome_counters() exists for)."""
        with self._lock:
            return {"queue_depth_requests": self.queue_depth_requests,
                    "queue_depth_rows": self.queue_depth_rows}

    def outcome_counters(self) -> Dict[str, int]:
        """Just the request-outcome counters — O(1) under the lock.
        The rollout monitor polls this every 10 ms during a bake
        window; as_dict() would copy and sort the whole wait ring per
        poll, contending with note_wait on the dispatch hot path during
        exactly the window whose wait p99 is being judged."""
        with self._lock:
            return {"completed": self.completed,
                    "failed": self.failed,
                    "shed_expired": self.shed_expired,
                    "rejected_queue_full": self.rejected_queue_full,
                    "rejected_predicted_late": self.rejected_predicted_late,
                    "rejected_tenant_budget": self.rejected_tenant_budget}

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

    def models_snapshot(self) -> Dict[str, Any]:
        with self._lock:
            reqs = dict(self.model_requests)
            rows = dict(self.model_rows)
            k = self.model_topk
        return self._models_view(reqs, rows, k)

    def tenants_snapshot(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            reqs = dict(self.tenant_requests)
            rows = dict(self.tenant_rows)
        return self._tenants_view(reqs, rows)

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
                "tap_errors": self.tap_errors,
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


class FleetStats(SnapshotStats):
    """Fleet-level counters (serving.fleet.ServingFleet): failover
    re-dispatches, circuit-breaker transitions, replica crash/restart
    supervision events, staged-rollout outcomes, and per-replica
    dispatch counts. Snapshot discipline is the shared SnapshotStats
    base — a scraper polling the aggregated fleet /statusz twice can
    prove nothing moved (equal seqs) or that a read straddled a
    mutation, never a torn aggregate."""

    def __init__(self):
        super().__init__()
        self.routed = 0             # requests accepted by the router
        self.completed = 0          # router futures resolved with a result
        self.failed = 0             # router futures resolved with an error
        self.cancelled = 0          # router futures cancelled by the caller
        self.failovers = 0          # re-dispatches to a DIFFERENT replica
        self.retries = 0            # re-dispatch attempts (any replica)
        self.breaker_opens = 0      # closed/half-open -> open
        self.breaker_probes = 0     # half-open probe dispatches allowed
        self.breaker_closes = 0     # half-open -> closed (probe success)
        self.replica_crashes = 0    # hard kills (chaos or injected)
        self.replica_restarts = 0   # supervisor restarts
        self.rollouts = 0           # staged rollouts started
        self.rollbacks = 0          # fleet-wide automatic rollbacks
        self.no_replica_available = 0   # every candidate down/open
        self.tap_errors = 0         # request-tap callbacks that raised
        self.replicas_added = 0     # elastic scale-up joins
        self.replicas_removed = 0   # elastic scale-down drains
        self.hedges = 0             # speculative second dispatches fired
        self.hedge_wins = 0         # hedges that resolved their request
        self.ejections = 0          # hung replicas pulled from placement
        self.readmissions = 0       # degraded replicas back in the ring
        self.retry_budget_exhausted = 0  # retries/hedges denied by budget
        self.deadline_sheds = 0     # shed at router: deadline below floor
        self.dispatches: Dict[str, int] = {}    # per-replica

    def note_routed(self) -> None:
        self._bump(routed=1)

    def note_completed(self) -> None:
        self._bump(completed=1)

    def note_failed(self) -> None:
        self._bump(failed=1)

    def note_cancelled(self) -> None:
        self._bump(cancelled=1)

    def note_dispatch(self, replica: str) -> None:
        with self._mutating():
            self.dispatches[replica] = self.dispatches.get(replica, 0) + 1

    def note_failover(self) -> None:
        self._bump(failovers=1, retries=1)

    def note_retry(self) -> None:
        self._bump(retries=1)

    def note_breaker(self, event: str) -> None:
        field = {"open": "breaker_opens", "probe": "breaker_probes",
                 "close": "breaker_closes"}[event]
        self._bump(**{field: 1})

    def note_crash(self) -> None:
        self._bump(replica_crashes=1)

    def note_restart(self) -> None:
        self._bump(replica_restarts=1)

    def note_rollout(self) -> None:
        self._bump(rollouts=1)

    def note_rollback(self) -> None:
        self._bump(rollbacks=1)

    def note_no_replica(self) -> None:
        self._bump(no_replica_available=1)

    def note_tap_error(self) -> None:
        self._bump(tap_errors=1)

    def note_replica_added(self) -> None:
        self._bump(replicas_added=1)

    def note_replica_removed(self) -> None:
        self._bump(replicas_removed=1)

    def note_hedge(self) -> None:
        self._bump(hedges=1)

    def note_hedge_win(self) -> None:
        self._bump(hedge_wins=1)

    def note_ejection(self) -> None:
        self._bump(ejections=1)

    def note_readmission(self) -> None:
        self._bump(readmissions=1)

    def note_retry_budget_exhausted(self) -> None:
        self._bump(retry_budget_exhausted=1)

    def note_deadline_shed(self) -> None:
        self._bump(deadline_sheds=1)

    def as_dict(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "snapshot_seq": self._seq,
                "routed": self.routed,
                "completed": self.completed,
                "failed": self.failed,
                "cancelled": self.cancelled,
                "failovers": self.failovers,
                "retries": self.retries,
                "breaker_opens": self.breaker_opens,
                "breaker_probes": self.breaker_probes,
                "breaker_closes": self.breaker_closes,
                "replica_crashes": self.replica_crashes,
                "replica_restarts": self.replica_restarts,
                "rollouts": self.rollouts,
                "rollbacks": self.rollbacks,
                "no_replica_available": self.no_replica_available,
                "tap_errors": self.tap_errors,
                "replicas_added": self.replicas_added,
                "replicas_removed": self.replicas_removed,
                "hedges": self.hedges,
                "hedge_wins": self.hedge_wins,
                "ejections": self.ejections,
                "readmissions": self.readmissions,
                "retry_budget_exhausted": self.retry_budget_exhausted,
                "deadline_sheds": self.deadline_sheds,
                "dispatches": dict(self.dispatches),
            }


class TransportStats(SnapshotStats):
    """Wire-plane counters + overhead rings for one socket transport
    (serving.transport.tcp). The engine's host-overhead clock stops at
    the process boundary, so the ``transport`` segment is booked HERE,
    client-side: per round trip the worker reports its own engine
    seconds and the client attributes ``rtt − engine`` to the wire
    (encode + send + remote accept + reply decode). ``wire_p99_us`` is
    the cross_host_load bench's budget gate."""

    RING = 4096

    def __init__(self):
        super().__init__()
        self.requests = 0           # round trips resolved with scores
        self.errors = 0             # round trips resolved with an error
        self.disconnects = 0        # connections torn (any reason)
        self.reconnects = 0         # successful re-dials
        self._rtt_s: deque = deque(maxlen=self.RING)
        self._wire_s: deque = deque(maxlen=self.RING)

    def note_roundtrip(self, rtt_s: float, wire_s: float) -> None:
        with self._mutating():
            self.requests += 1
            self._rtt_s.append(float(rtt_s))
            self._wire_s.append(float(wire_s))

    def note_error(self) -> None:
        self._bump(errors=1)

    def note_disconnect(self) -> None:
        self._bump(disconnects=1)

    def note_reconnect(self) -> None:
        self._bump(reconnects=1)

    def recent_wire_us(self, last_n: int, q: float) -> Optional[float]:
        """q-quantile of the wire-overhead segment over the last
        ``last_n`` round trips, in µs (None until traffic flows)."""
        with self._lock:
            tail = list(self._wire_s)[-int(last_n):]
        if not tail:
            return None
        return percentile_nearest_rank(sorted(tail), q) * 1e6

    def as_dict(self) -> Dict[str, Any]:
        with self._lock:
            rtt = sorted(self._rtt_s)
            wires = sorted(self._wire_s)
            doc: Dict[str, Any] = {
                "snapshot_seq": self._seq,
                "requests": self.requests,
                "errors": self.errors,
                "disconnects": self.disconnects,
                "reconnects": self.reconnects,
                "sampled": len(wires),
            }
        for label, vals in (("rtt", rtt), ("wire", wires)):
            if vals:
                doc[f"{label}_p50_us"] = round(
                    percentile_nearest_rank(vals, 0.50) * 1e6, 1)
                doc[f"{label}_p99_us"] = round(
                    percentile_nearest_rank(vals, 0.99) * 1e6, 1)
        return doc


class ScalerStats(SnapshotStats):
    """Elastic-fleet autoscaler counters
    (serving.autoscaler.FleetAutoscaler): tick/evaluation volume,
    pressure and forecast breaches, scale decisions by direction,
    provision retries/failures, admission re-prices, and the
    provision-to-serving latency of the most recent scale-up (the
    number the elastic_load bench reports as
    ``scale_up_to_serving_s``). Snapshot discipline is the shared
    SnapshotStats base — every mutation bumps ``snapshot_seq`` under
    the lock, as_dict() is one lock hold."""

    def __init__(self):
        super().__init__()
        self.ticks = 0              # evaluation loop wakeups
        self.evaluations = 0        # ticks that sampled + decided
        self.evaluations_dropped = 0    # tick bodies lost to faults
        self.pressure_breaches = 0  # ticks over the scale-up thresholds
        self.calm_ticks = 0         # ticks under the scale-down ones
        self.forecast_breaches = 0  # predicted load over fleet capacity
        self.scale_ups = 0          # scale-up decisions applied
        self.scale_downs = 0        # scale-down decisions applied
        self.decisions_deferred = 0  # decisions skipped: action in flight
        self.replicas_added = 0     # replicas provisioned + joined
        self.replicas_removed = 0   # replicas drained + removed
        self.provision_retries = 0  # replica builds retried after a fault
        self.provision_failures = 0  # scale-ups abandoned (retries spent)
        self.reprices = 0           # admission price pushes (price != 1)
        self.last_price = 1.0
        self.last_scale_up_s: Optional[float] = None
        self.scale_up_seconds_total = 0.0
        self.last_decision: Optional[Dict[str, Any]] = None
        self.last_forecast: Optional[Dict[str, Any]] = None

    def note_tick(self) -> None:
        self._bump(ticks=1)

    def note_evaluation(self) -> None:
        self._bump(evaluations=1)

    def note_evaluation_dropped(self) -> None:
        self._bump(evaluations_dropped=1)

    def note_pressure(self, breach: bool, calm: bool) -> None:
        if breach:
            self._bump(pressure_breaches=1)
        elif calm:
            self._bump(calm_ticks=1)

    def note_forecast(self, snapshot: Dict[str, Any],
                      breach: bool) -> None:
        with self._mutating():
            self.last_forecast = dict(snapshot)
            if breach:
                self.forecast_breaches += 1

    def note_decision(self, decision: Dict[str, Any]) -> None:
        with self._mutating():
            self.last_decision = dict(decision)
            if decision.get("direction") == "up":
                self.scale_ups += 1
            elif decision.get("direction") == "down":
                self.scale_downs += 1

    def note_deferred(self) -> None:
        self._bump(decisions_deferred=1)

    def note_replica_added(self, scale_up_s: float) -> None:
        with self._mutating():
            self.replicas_added += 1
            self.last_scale_up_s = float(scale_up_s)
            self.scale_up_seconds_total += float(scale_up_s)

    def note_replica_removed(self) -> None:
        self._bump(replicas_removed=1)

    def note_provision_retry(self) -> None:
        self._bump(provision_retries=1)

    def note_provision_failure(self) -> None:
        self._bump(provision_failures=1)

    def note_reprice(self, price: float) -> None:
        with self._mutating():
            self.reprices += 1
            self.last_price = float(price)

    def as_dict(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "snapshot_seq": self._seq,
                "ticks": self.ticks,
                "evaluations": self.evaluations,
                "evaluations_dropped": self.evaluations_dropped,
                "pressure_breaches": self.pressure_breaches,
                "calm_ticks": self.calm_ticks,
                "forecast_breaches": self.forecast_breaches,
                "scale_ups": self.scale_ups,
                "scale_downs": self.scale_downs,
                "decisions_deferred": self.decisions_deferred,
                "replicas_added": self.replicas_added,
                "replicas_removed": self.replicas_removed,
                "provision_retries": self.provision_retries,
                "provision_failures": self.provision_failures,
                "reprices": self.reprices,
                "last_price": self.last_price,
                "last_scale_up_s": self.last_scale_up_s,
                "scale_up_seconds_total": self.scale_up_seconds_total,
                "last_decision": (dict(self.last_decision)
                                  if self.last_decision else None),
                "last_forecast": (dict(self.last_forecast)
                                  if self.last_forecast else None),
            }


class ContinuumStats(SnapshotStats):
    """Continuous-learning control-loop counters
    (continuum.controller.ContinuumController): monitor ticks and
    per-feature drift scores, debounced triggers (and the coalesced
    ones that did NOT stack a second retrain), retrain attempts/
    resumes/failures, gate outcomes (lint, shadow), promotions and
    bake-window rollbacks, and the cycle-phase wall clocks the bench's
    drift_loop section reports. Snapshot discipline is the shared
    SnapshotStats base: every mutation bumps ``snapshot_seq`` under
    the lock and ``as_dict()`` is one lock hold."""

    def __init__(self):
        super().__init__()
        self.ticks = 0              # controller loop monitor ticks
        self.observed_requests = 0  # tapped requests folded into sketches
        self.observed_rows = 0
        self.dropped_observations = 0   # tap queue full (bounded, lossy)
        self.monitor_errors = 0     # observe/tick bodies that raised
        self.windows = 0            # completed evaluation windows
        self.triggers = 0           # debounced drift triggers fired
        self.coalesced_triggers = 0  # triggers while a cycle was in flight
        self.cycles = 0             # retrain cycles started
        self.retrains = 0           # retrain attempts launched
        self.retrain_retries = 0    # attempts after a failed/killed one
        self.retrain_failures = 0   # cycles whose retrain exhausted
        self.lint_rejects = 0       # candidates failing the strict gate
        self.shadow_samples = 0     # mirrored requests candidate-scored
        self.shadow_rejects = 0     # candidates failing shadow verdict
        self.promotions = 0         # candidates promoted fleet/engine-wide
        self.promote_rollbacks = 0  # promotions undone by the bake window
        self.cycle_errors = 0       # cycles ended by an unexpected error
        self.last_drift_scores: Dict[str, float] = {}
        self.peak_drift_scores: Dict[str, float] = {}
        self.last_trigger_reason: Optional[str] = None

    def note_tick(self) -> None:
        self._bump(ticks=1)

    def note_observed(self, requests: int, rows: int) -> None:
        self._bump(observed_requests=requests, observed_rows=rows)

    def note_dropped(self, n: int = 1) -> None:
        self._bump(dropped_observations=n)

    def note_monitor_error(self) -> None:
        self._bump(monitor_errors=1)

    def note_scores(self, scores: Dict[str, float],
                    window_complete: bool) -> None:
        with self._mutating():
            self.last_drift_scores = dict(scores)
            for k, v in scores.items():
                if v > self.peak_drift_scores.get(k, 0.0):
                    self.peak_drift_scores[k] = v
            if window_complete:
                self.windows += 1

    def note_trigger(self, reason: str) -> None:
        with self._mutating():
            self.triggers += 1
            self.last_trigger_reason = reason

    def note_coalesced(self) -> None:
        self._bump(coalesced_triggers=1)

    def note_cycle(self) -> None:
        self._bump(cycles=1)

    def note_retrain(self) -> None:
        self._bump(retrains=1)

    def note_retrain_retry(self) -> None:
        self._bump(retrain_retries=1)

    def note_retrain_failure(self) -> None:
        self._bump(retrain_failures=1)

    def note_lint_reject(self) -> None:
        self._bump(lint_rejects=1)

    def note_shadow_samples(self, n: int) -> None:
        self._bump(shadow_samples=n)

    def note_shadow_reject(self) -> None:
        self._bump(shadow_rejects=1)

    def note_promotion(self) -> None:
        self._bump(promotions=1)

    def note_promote_rollback(self) -> None:
        self._bump(promote_rollbacks=1)

    def note_cycle_error(self) -> None:
        self._bump(cycle_errors=1)

    def as_dict(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "snapshot_seq": self._seq,
                "ticks": self.ticks,
                "observed_requests": self.observed_requests,
                "observed_rows": self.observed_rows,
                "dropped_observations": self.dropped_observations,
                "monitor_errors": self.monitor_errors,
                "windows": self.windows,
                "triggers": self.triggers,
                "coalesced_triggers": self.coalesced_triggers,
                "cycles": self.cycles,
                "retrains": self.retrains,
                "retrain_retries": self.retrain_retries,
                "retrain_failures": self.retrain_failures,
                "lint_rejects": self.lint_rejects,
                "shadow_samples": self.shadow_samples,
                "shadow_rejects": self.shadow_rejects,
                "promotions": self.promotions,
                "promote_rollbacks": self.promote_rollbacks,
                "cycle_errors": self.cycle_errors,
                "last_drift_scores": dict(self.last_drift_scores),
                "peak_drift_scores": dict(self.peak_drift_scores),
                "last_trigger_reason": self.last_trigger_reason,
            }


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

    def devices_dict(self) -> Dict[str, Dict[str, int]]:
        """Process-cumulative per-chip totals across every sweep
        program: {device: {dispatches, items}} — the /statusz
        ``sweepDevices`` block and the /metricsz {device=} source."""
        with self._lock:
            agg: Dict[str, Dict[str, int]] = {}
            for rec in self.programs.values():
                for dev, c in (rec.get("devices") or {}).items():
                    e = agg.setdefault(dev, {"dispatches": 0, "items": 0})
                    e["dispatches"] += c["dispatches"]
                    e["items"] += c["items"]
            return agg

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


class TrainStats:
    """Per-stage observability for the workflow training executor
    (executor.py): fit/transform wall time per stage, rows/s, how each
    transform ran (host / fused device block / skipped by lifetime
    pruning), per-layer pool occupancy, and columns materialized vs
    pruned. One instance rides each Workflow.train call and lands in
    ``train_summaries["stageTimings"]`` (``TM_WORKFLOW_PROFILE=1``
    prints `format_table()`); stage records are appended from the
    executor's deterministic merge loop, so their order matches the
    serial stage order — the JSON is reproducible run to run apart from
    the timing values themselves."""

    def __init__(self, executor: str, workers: int):
        self._lock = threading.Lock()
        self.executor = executor
        self.workers = int(workers)
        self.stages: list = []
        self.layers: list = []
        self.columns_materialized = 0
        self.columns_pruned = 0
        self.seconds = 0.0
        self.retries: list = []         # [{uid, attempt, error}] per retry
        self.degraded: list = []        # degrade records (see executor)
        self.resumed_layers = 0         # layers restored from checkpoint
        self.checkpointed_layers = 0    # layers persisted this train
        self.folded_programs: Optional[Dict[str, Any]] = None
        #: span-trace correlation: the telemetry trace id this train's
        #: per-stage spans were recorded under (None = unsampled)
        self.trace_id: Optional[str] = None

    def note_stage(self, layer: int, model, rows: int, fit_s: float,
                   transform_s: float, transform: str) -> None:
        total = fit_s + transform_s
        rec = {
            "layer": layer,
            "uid": model.uid,
            "operation": type(model).__name__,
            "output": model.output.name,
            "rows": int(rows),
            "fit_s": fit_s,
            "transform_s": transform_s,
            "transform": transform,
            "rows_per_sec": rows / total if total > 0 else None,
        }
        with self._lock:
            self.stages.append(rec)

    def note_layer(self, layer: int, n_stages: int, wall_s: float,
                   busy_s: float, critical_s: Optional[float] = None
                   ) -> None:
        denom = wall_s * max(self.workers, 1)
        # critical_s: the layer's longest single-stage chain (its
        # unparallelizable floor). serialFraction = critical/wall is the
        # per-layer Amdahl number: ~1.0 means adding workers cannot help
        # this layer (single-stage model layers), ~1/stages means the
        # layer parallelized perfectly.
        rec = {"layer": layer, "stages": int(n_stages), "wall_s": wall_s,
               "busy_s": busy_s,
               "pool_occupancy": min(1.0, busy_s / denom) if denom > 0
               else None,
               "critical_s": critical_s,
               "serialFraction": (min(1.0, critical_s / wall_s)
                                  if critical_s is not None and wall_s > 0
                                  else None)}
        with self._lock:
            self.layers.append(rec)

    def note_columns(self, materialized: int = 0, pruned: int = 0) -> None:
        with self._lock:
            self.columns_materialized += materialized
            self.columns_pruned += pruned

    def note_retry(self, uid: str, attempt: int, error: BaseException
                   ) -> None:
        with self._lock:
            self.retries.append({"uid": uid, "attempt": int(attempt),
                                 "error": f"{type(error).__name__}: "
                                          f"{error}"})

    def note_degraded(self, record: Dict[str, Any]) -> None:
        with self._lock:
            self.degraded.append(dict(record))

    def note_resume(self, resumed: int = 0, checkpointed: int = 0) -> None:
        with self._lock:
            self.resumed_layers += resumed
            self.checkpointed_layers += checkpointed

    def set_total(self, seconds: float) -> None:
        with self._lock:
            self.seconds = seconds

    def set_folded_programs(self, delta: Optional[Dict[str, Any]]) -> None:
        """Attach this train's sweep program attribution (a
        SweepStats.delta — execute wall and dispatches per program)."""
        with self._lock:
            self.folded_programs = delta

    def as_dict(self) -> Dict[str, Any]:
        with self._lock:
            wall = sum(r["wall_s"] for r in self.layers)
            busy = sum(r["busy_s"] for r in self.layers)
            crit = sum(r["critical_s"] for r in self.layers
                       if r.get("critical_s") is not None)
            denom = wall * max(self.workers, 1)
            return {
                "executor": self.executor,
                "workers": self.workers,
                "seconds": self.seconds,
                "poolOccupancy": (min(1.0, busy / denom)
                                  if denom > 0 else None),
                # whole-train Amdahl split: the share of layer wall
                # clock that sat on single-stage critical paths — what
                # `run --profile` prints as the ceiling on executor
                # concurrency (1.0 = nothing left to overlap)
                "serialFraction": (min(1.0, crit / wall) if wall > 0
                                   else None),
                "columnsMaterialized": self.columns_materialized,
                "columnsPruned": self.columns_pruned,
                "retries": [dict(r) for r in self.retries],
                "resumedLayers": self.resumed_layers,
                "checkpointedLayers": self.checkpointed_layers,
                "foldedPrograms": self.folded_programs,
                "traceId": self.trace_id,
                "layers": [dict(r) for r in self.layers],
                "stages": [dict(r) for r in self.stages],
            }

    def format_table(self) -> str:
        """Aligned per-stage table for `train --profile`, followed by
        the per-layer Amdahl split and (when a sweep ran) the sweep
        programs' execute attribution."""
        with self._lock:
            stages = [dict(r) for r in self.stages]
            layers = [dict(r) for r in self.layers]
            folded = (dict(self.folded_programs)
                      if self.folded_programs else None)
            head = (f"workflow train [{self.executor}] workers="
                    f"{self.workers} seconds={self.seconds:.3f} "
                    f"materialized={self.columns_materialized} "
                    f"pruned={self.columns_pruned}")
        rows = [("layer", "stage", "output", "transform", "fit_s",
                 "transform_s", "rows/s")]
        for r in stages:
            rps = r["rows_per_sec"]
            rows.append((str(r["layer"]), r["operation"],
                         r["output"][:40], r["transform"],
                         f"{r['fit_s']:.4f}", f"{r['transform_s']:.4f}",
                         f"{rps:.0f}" if rps else "-"))
        widths = [max(len(row[j]) for row in rows)
                  for j in range(len(rows[0]))]
        lines = [head] + ["  ".join(v.ljust(w) for v, w in
                                    zip(row, widths)) for row in rows]
        amdahl = [f"L{r['layer']:02d} wall={r['wall_s']:.3f}s "
                  f"serialFraction="
                  + (f"{r['serialFraction']:.2f}"
                     if r.get("serialFraction") is not None else "-")
                  for r in layers]
        if amdahl:
            lines += ["-- layer Amdahl split --"] + amdahl
        if folded and folded.get("programs"):
            lines.append(
                f"-- sweep programs: {folded['dispatches']} dispatches "
                f"({folded['execute_s']:.2f}s) --")
            for label, p in folded["programs"].items():
                lines.append(
                    f"  {label}: batch={p['batch']} "
                    f"dispatches={p['dispatches']} "
                    f"execute_s={p['execute_s']:.2f}")
                devs = p.get("devices")
                if devs:
                    lines.append("    devices: " + " ".join(
                        f"{d}={c['items']}" for d, c in sorted(
                            devs.items())))
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Record a ``torch.profiler`` trace of the enclosed block (CPU
    activity, plus CUDA when a card is present) and write it as a
    Chrome trace (``trace.json``, open in Perfetto or chrome://tracing)
    under ``log_dir``. No-op when log_dir is falsy, so callers can
    thread an optional OpParams field straight through."""
    if not log_dir:
        yield
        return
    import os

    import torch

    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


#: debug_nans blocks open anywhere in the process (the JAX package's
#: jax_debug_nans is process-wide too)
_NAN_DEPTH = 0
_NAN_LOCK = threading.Lock()
_NAN_TLS = threading.local()


#: ops whose output is uninitialized memory (its bits may read as NaN
#: before anything is written): no computation made it
_UNINITIALIZED_OPS = frozenset({"empty", "empty_like", "empty_strided",
                                "new_empty", "new_empty_strided", "resize_"})


def _nan_mode():
    """The dispatch mode that checks every op's float outputs (built on
    first use: ``torch.utils._python_dispatch`` is imported lazily)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class _NanCheck(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            op = str(func.overloadpacket.__name__)
            if op not in _UNINITIALIZED_OPS:
                check_nan_outputs(op, out, (args, tuple(kwargs.values())))
            return out

    return _NanCheck()


def nan_checking() -> bool:
    """Whether a :func:`debug_nans` block is open in this process."""
    return _NAN_DEPTH > 0


def _has_nan(tree) -> bool:
    import torch

    stack = [tree]
    while stack:
        t = stack.pop()
        if isinstance(t, (list, tuple)):
            stack.extend(t)
        elif (isinstance(t, torch.Tensor) and t.is_floating_point()
              and t.numel() and bool(torch.isnan(t).any())):
            return True
    return False


def check_nan_outputs(op: str, outs, ins=()) -> None:
    """Raise ``FloatingPointError`` naming ``op`` when it made a NaN: a
    float tensor among ``outs`` (tensors or nested lists / tuples of
    them) holds one while no float tensor among its inputs ``ins`` did.
    An op that only carries its inputs' NaNs on (a column's missing
    values moved to the card, or masked out) is not where they arose, as
    a transfer to the device is no checked operation for JAX. The
    hand-written kernels, which launch through ``ctypes`` outside the
    dispatcher, call it on their outputs while :func:`nan_checking`."""
    if _has_nan(outs) and not _has_nan(ins):
        raise FloatingPointError(f"invalid value (nan) encountered in {op}")


@contextlib.contextmanager
def nan_checks() -> Iterator[None]:
    """NaN checking in this thread while a :func:`debug_nans` block is
    open anywhere in the process: the worker threads a run fits on (the
    executor's pool, the rank threads of ``parallel.spmd``, a stage's
    watchdog) enter it so the whole run is checked, as JAX's
    process-wide flag checks it. A no-op otherwise, or when this thread
    already checks."""
    if not nan_checking() or getattr(_NAN_TLS, "on", False):
        yield
        return
    _NAN_TLS.on = True
    try:
        with _nan_mode():
            yield
    finally:
        _NAN_TLS.on = False


@contextlib.contextmanager
def debug_nans(enabled: bool = True) -> Iterator[None]:
    """NaN debugging for the enclosed block (the JAX package's
    ``jax_debug_nans``; the prior state returns on exit): every torch op
    run in it, in this thread and in the threads that enter
    :func:`nan_checks`, has its float outputs checked, and the first op
    whose output holds a NaN raises ``FloatingPointError`` naming it.
    Each check reads the device, so a run under it is slow: for
    debugging runs only."""
    global _NAN_DEPTH
    if not enabled:
        yield
        return
    with _NAN_LOCK:
        _NAN_DEPTH += 1
    try:
        with nan_checks():
            yield
    finally:
        with _NAN_LOCK:
            _NAN_DEPTH -= 1


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
