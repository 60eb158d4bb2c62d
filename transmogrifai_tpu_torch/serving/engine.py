"""In-process serving engine: adaptive micro-batching over FusedScorer.

Counterpart of ``transmogrifai_tpu/serving/engine.py``; the request
plane is host-only and comes across as it is, the device work goes
through the port's FusedScorer and fused group scorer. Concurrent
callers are coalesced into device-sized micro-batches:

* Callers submit from any thread; each request's HOST work (request
  normalization, boundary assembly) runs on the submitting thread, so
  host work parallelizes across clients while the device stays a
  single well-packed stream.
* A dispatcher thread collects queued requests into one DRAIN PASS,
  flushing when pending rows reach `max_batch_rows` OR the oldest
  request has waited `max_wait_ms` — the classic throughput/latency
  knob.
* Results scatter back to per-caller futures in submission row order.
  Because the device tail is a composition of row-level functions and
  bucket padding is sliced off before results surface, engine results
  equal scoring each request alone.
* Admission control (admission.py) bounds the queue (globally AND per
  tenant), sheds expired-deadline requests before device dispatch, and
  rejects requests the EMA latency model says cannot meet their
  deadline.
* Hot-swap (registry.py) is a warmed atomic pointer flip observed
  between micro-batches; a request prepared under the old version
  re-prepares against the new one if the swap lands before its batch
  dispatches.

Multi-model, multi-tenant serving:

* **(model, bucket) dispatch keys** — ``submit(model=...)`` selects
  WHICH registered version scores the request; an unknown model id
  fails ITS request loudly at submit (``registry.ModelNotFound``).
  ``model=None`` follows the registry default pointer.
* **Continuous cross-model batching** — one drain pass pops requests
  for MANY models: requests whose model ids resolve to the same
  backend object (registry aliases) CO-BATCH into a single device
  dispatch; distinct backends form per-key sub-batches that are all
  LAUNCHED (queued on the device stream) before any is materialized.
* **Fused cross-model plane** (``fused_kernel=True``,
  TM_SERVE_FUSED_KERNEL) — backends of one stackable linear family
  score as ONE launch of the fused kernel per bucket slice
  (serving/fusion.py, models/serving_kernels.py).
* **Weighted-fair tenant queueing** — requests carry a ``tenant``;
  each tenant gets its own FIFO and the drain pass pops via DEFICIT
  ROUND-ROBIN (quantum rows x tenant weight per visit); per-tenant
  admission budgets (``tenant_queue_share``) sit in front.

The request plane is the JAX package's fast plane only (its legacy
plane, dict-of-deques queues and one-model-per-pass dispatch are
benchmark baselines): per-request stats are booked once per drain pass
/ finalized group, and each tenant keeps one queue slot object.
Request taps (``add_tap``: the continuum drift monitor, the shadow
mirror) see every accepted request; with none registered the fan-out
is one tuple test, so the fused pass keeps its device operations.
Every request carries four monotonic stamps (submit, enqueue,
dispatch, resolve) feeding the always-on host-overhead clock in
``EngineStats``.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Dict, List, Optional

import numpy as np

from ..models.serving_kernels import (
    serve_policy_token as _serve_policy_token)
from ..profiling import EngineStats, register_cache, shape_bucket
from ..resilience.faults import fault_point
from ..telemetry import recorder as _flight
from ..telemetry import spans as _spans
from .admission import (AdmissionController, DeadlineExpired,
                        DeadlineUnmeetable, EngineClosed, EngineStopped,
                        QueueFull, TenantBudgetExceeded)
from .fusion import (FusedGroupScorer, backend_caps as _backend_caps,
                     fused_env_fields)
from .registry import ModelRegistry, model_env_fields

# hot-path module bindings: the drain loop and submit path run
# these hundreds of thousands of times per second — a global load is
# one dict probe vs. two attribute walks per call. _TRACER is safe to
# bind: telemetry.spans.configure() mutates the module singleton IN
# PLACE, never rebinds it.
_monotonic = time.monotonic
_asarray = np.asarray
_TRACER = _spans.TRACER


def _future_outcome(fut: Future) -> str:
    """'ok' / the exception type name / 'cancelled' — span attrs."""
    try:
        exc = fut.exception()
    except Exception:               # CancelledError on a cancelled future
        return "cancelled"
    return "ok" if exc is None else type(exc).__name__


def tenant_weights_spec(raw: str) -> Dict[str, int]:
    """Parse a ``name:weight,name:weight`` spec (TM_TENANT_WEIGHTS)
    into a weight map. Strict: an empty entry, a missing ``:``, or a
    weight below 1 raises ValueError — a typo'd fairness policy must
    fail the deploy, not silently run flat weights."""
    weights: Dict[str, int] = {}
    for part in str(raw).split(","):
        part = part.strip()
        if not part:
            continue
        name, sep, w = part.rpartition(":")
        if not sep or not name:
            raise ValueError(
                f"bad tenant weight entry {part!r} (want name:weight)")
        weight = int(w)             # ValueError propagates
        if weight < 1:
            raise ValueError(
                f"tenant weight for {name!r} must be >= 1, got {weight}")
        weights[name.strip()] = weight
    if not weights:
        raise ValueError("tenant weight spec names no tenants")
    return weights


#: TM_TENANT_* env knobs (strict parse_env_fields catalog): the
#: weighted-fair queueing + per-tenant admission-budget surface.
_TENANT_ENV_FIELDS: Dict[str, tuple] = {
    "TM_TENANT_WEIGHTS": ("tenant_weights", tenant_weights_spec),
    "TM_TENANT_DEFAULT_WEIGHT": ("tenant_default_weight", int),
    "TM_TENANT_QUANTUM_ROWS": ("tenant_quantum_rows", int),
    "TM_TENANT_QUEUE_SHARE": ("tenant_queue_share", float),
}

#: TM_ENGINE_* env knobs (strict parse_env_fields catalog): the
#: batching-window tuning and queue bounds. The JAX package's
#: TM_ENGINE_QUEUE_IMPL / TM_ENGINE_REQUEST_PLANE selectors have no
#: counterpart (one plane here), so the strict parse rejects them.
_ENGINE_ENV_FIELDS: Dict[str, tuple] = {
    "TM_ENGINE_MAX_WAIT_MS": ("max_wait_ms", float),
    "TM_ENGINE_MAX_BATCH_ROWS": ("max_batch_rows", int),
    "TM_ENGINE_MAX_QUEUE_ROWS": ("max_queue_rows", int),
    "TM_ENGINE_MAX_QUEUE_REQUESTS": ("max_queue_requests", int),
}

#: the tenant id requests without an explicit tenant= ride under
DEFAULT_TENANT = "default"


class EngineConfig:
    """Tuning knobs for the micro-batching dispatcher (batching window,
    queue bounds, tenant fairness, the fused plane)."""

    def __init__(self, max_batch_rows: Optional[int] = None,
                 max_wait_ms: float = 2.0,
                 max_queue_rows: int = 65536,
                 max_queue_requests: int = 4096,
                 ema_alpha: float = 0.25,
                 drain_timeout_s: float = 30.0,
                 model_topk: int = 10,
                 tenant_weights: Optional[Dict[str, int]] = None,
                 tenant_default_weight: int = 1,
                 tenant_quantum_rows: int = 64,
                 tenant_queue_share: float = 1.0,
                 fused_kernel: bool = False,
                 fused_min_models: int = 2):
        if max_wait_ms < 0:
            raise ValueError("max_wait_ms must be >= 0")
        if max_batch_rows is not None and max_batch_rows < 1:
            # 0 would make every drain pass empty: the dispatcher would
            # busy-spin while every queued future hangs forever
            raise ValueError("max_batch_rows must be >= 1 (or None)")
        if model_topk < 1:
            raise ValueError("model_topk (TM_MODEL_TOPK) must be >= 1")
        if tenant_default_weight < 1:
            raise ValueError(
                "tenant_default_weight (TM_TENANT_DEFAULT_WEIGHT) must "
                "be >= 1")
        if tenant_quantum_rows < 1:
            raise ValueError(
                "tenant_quantum_rows (TM_TENANT_QUANTUM_ROWS) must be "
                ">= 1")
        if not (0.0 < float(tenant_queue_share) <= 1.0):
            raise ValueError(
                "tenant_queue_share (TM_TENANT_QUEUE_SHARE) must be in "
                "(0, 1] — 1.0 means no per-tenant budget")
        if tenant_weights:
            for name, w in tenant_weights.items():
                if int(w) < 1:
                    raise ValueError(
                        f"tenant weight for {name!r} must be >= 1")
        if int(fused_min_models) < 2:
            # a 1-member "fused" launch is the classic path with extra
            # tracing overhead — refuse rather than silently degrade
            raise ValueError(
                "fused_min_models (TM_SERVE_FUSED_MIN_MODELS) must be "
                ">= 2")
        #: flush threshold; None = the scorer's top bucket (device-sized)
        self.max_batch_rows = max_batch_rows
        self.max_wait_ms = float(max_wait_ms)
        self.max_queue_rows = int(max_queue_rows)
        self.max_queue_requests = int(max_queue_requests)
        self.ema_alpha = float(ema_alpha)
        self.drain_timeout_s = float(drain_timeout_s)
        #: stats snapshot per-model bound: top-K model ids
        #: by traffic, everything else aggregated under "other"
        self.model_topk = int(model_topk)
        self.tenant_weights = dict(tenant_weights or {})
        self.tenant_default_weight = int(tenant_default_weight)
        self.tenant_quantum_rows = int(tenant_quantum_rows)
        self.tenant_queue_share = float(tenant_queue_share)
        #: device-side fused cross-model scoring (one kernel launch
        #: per backend family and bucket slice; see serving/fusion.py).
        #: Default OFF, as in the JAX package.
        self.fused_kernel = bool(fused_kernel)
        self.fused_min_models = int(fused_min_models)

    @classmethod
    def from_env(cls, environ: Optional[Dict[str, str]] = None,
                 **overrides) -> "EngineConfig":
        """Build a config from the TM_TENANT_* / TM_MODEL_* /
        TM_ENGINE_* knobs (+ explicit overrides, which win). STRICT
        like every other TM_* surface: an unknown prefixed name or an
        unparsable value raises — a fairness policy that silently
        didn't apply starves someone."""
        from ..resilience.config import parse_env_fields
        fields = parse_env_fields("TM_TENANT_", _TENANT_ENV_FIELDS,
                                  what="tenant env var", environ=environ)
        fields.update(parse_env_fields(
            "TM_ENGINE_", _ENGINE_ENV_FIELDS,
            what="engine env var", environ=environ))
        mf = model_env_fields(environ=environ)
        if "topk" in mf:
            fields["model_topk"] = mf["topk"]
        ff = fused_env_fields(environ=environ)
        if "fused_kernel" in ff:
            ff["fused_kernel"] = bool(ff["fused_kernel"])
        fields.update(ff)
        fields.update(overrides)
        return cls(**fields)


#: the engine's bounded fused-scorer caches (each scorer holds its
#: members' stacked weights and compiled prefix tables), process-wide:
#: /statusz ``programCaches``
_FUSED_SCORER_CAP = 32
_FUSED_SCORER_STATS = register_cache("serving.fused_scorers",
                                     _FUSED_SCORER_CAP)


class RequestTaps:
    """Copy-on-write request-tap set — THE one implementation of the
    observe-only tap contract, shared by ServingEngine and
    ServingFleet: registration under a lock, lock-free tuple read on
    the hot path, and a raising tap swallowed (the live request
    proceeds) but counted via ``on_error``, never silent."""

    def __init__(self, on_error):
        self._lock = threading.Lock()
        self._taps: tuple = ()
        self._on_error = on_error

    def add(self, fn) -> None:
        with self._lock:
            self._taps = self._taps + (fn,)

    def remove(self, fn) -> None:
        with self._lock:
            self._taps = tuple(t for t in self._taps if t is not fn)

    def notify(self, data, future) -> None:
        for tap in self._taps:
            try:
                tap(data, future)
            except Exception:   # noqa: BLE001 — observers never fail
                self._on_error()                # the live path; counted


class _Request:
    """Single-allocation slotted request record. ``t_submit`` is the
    host-overhead clock's origin stamp; ``enqueued_at`` is re-stamped
    at enqueue so admission time (prepare + admit) and queue time stay
    distinct segments. ``sig`` caches the prepared dtype signature
    computed on the SUBMITTING thread so the dispatcher
    does not recompute it per request; re-prepare invalidates it."""

    __slots__ = ("data", "n", "vals", "prepared_by", "deadline",
                 "enqueued_at", "future", "trace", "model", "tenant",
                 "t_submit", "sig")

    def __init__(self, data, n, vals, prepared_by, deadline, trace=None,
                 model=None, tenant=DEFAULT_TENANT, t_submit=0.0,
                 sig=None):
        self.data = data
        self.n = n
        self.vals = vals
        # the BACKEND OBJECT that ran prepare — identity, not version
        # name: a released name can be re-registered (rollback) with a
        # different model, and name equality would then silently feed
        # stale host-prepared values to the new model's device tail
        self.prepared_by = prepared_by
        self.deadline = deadline
        self.enqueued_at = time.monotonic()
        self.future: Future = Future()
        self.trace = trace          # telemetry trace id (None: unsampled)
        self.model = model          # requested model id (None: default)
        self.tenant = tenant        # admission/fairness tenant id
        self.t_submit = t_submit    # host-overhead clock origin
        self.sig = sig              # cached prepared dtype signature


class _TenantSlot:
    """One tenant's whole queue-plane state in ONE allocation: FIFO,
    DRR deficit, row occupancy, cached weight. Allocated once per
    tenant and kept across idle periods (``_ArrayQueues._slots``), so
    steady-state enqueue/pop touches no dicts at all."""

    __slots__ = ("name", "queue", "deficit", "rows", "weight")

    def __init__(self, name: str, weight: int):
        self.name = name
        self.queue: deque = deque()
        self.deficit = 0.0
        self.rows = 0
        self.weight = weight


class _ArrayQueues:
    """Slot-backed weighted-fair tenant queues: the DRR rotation is a
    list of ``_TenantSlot``s and every per-request booking is plain
    attribute arithmetic — no dict get/setdefault/del churn per
    request. All methods are called under the engine's ``_cond``
    except the advisory ``occupancy``/``rows``/``requests`` reads on
    the submit path."""

    __slots__ = ("rows", "requests", "_slots", "_rotation", "_idx",
                 "_weights", "_default_weight")

    def __init__(self, weights: Optional[Dict[str, int]],
                 default_weight: int):
        self.rows = 0
        self.requests = 0
        #: every tenant ever seen -> its slot (persists across idle)
        self._slots: Dict[str, _TenantSlot] = {}
        #: slots with queued work, in activation order (the DRR ring)
        self._rotation: List[_TenantSlot] = []
        self._idx = 0
        self._weights = dict(weights or {})
        self._default_weight = int(default_weight)

    # opaudit: hotpath
    def enqueue(self, req: _Request) -> None:
        s = self._slots.get(req.tenant)
        if s is None:
            s = self._slots[req.tenant] = _TenantSlot(
                req.tenant,
                self._weights.get(req.tenant, self._default_weight))
            self._rotation.append(s)
        elif not s.queue:
            # re-activation: standard DRR — an idle tenant banks no
            # credit
            s.deficit = 0.0
            self._rotation.append(s)
        s.queue.append(req)
        rn = req.n
        s.rows += rn
        self.rows += rn
        self.requests += 1

    def occupancy(self, tenant: str):
        """(queued rows, queued requests) for one tenant — the
        per-tenant admission-budget inputs."""
        s = self._slots.get(tenant)
        if s is None:
            return 0, 0
        return s.rows, len(s.queue)

    def oldest(self) -> float:
        return min(s.queue[0].enqueued_at for s in self._rotation)

    # opaudit: hotpath
    def drr_pop(self, max_rows: int, quantum: float) -> List[_Request]:
        """Deficit-round-robin drain: visit tenants in rotation, credit
        ``quantum x weight`` rows per visit, pop FIFO while the head
        fits the tenant's deficit and the pass's row budget. A tenant
        whose queue empties leaves the rotation with its deficit reset.
        Terminates: deficits grow every visit, so an empty pass keeps
        cycling until the first head is covered; once the pass holds
        anything, a full popless cycle means nothing else fits
        ``max_rows`` and the pass closes."""
        batch: List[_Request] = []
        rows = 0
        rotation = self._rotation
        idle_visits = 0
        while rotation and rows < max_rows:
            if self._idx >= len(rotation):
                self._idx = 0
            s = rotation[self._idx]
            deficit = s.deficit + quantum * s.weight
            q = s.queue
            popped = False
            while q and (not batch or rows + q[0].n <= max_rows) \
                    and q[0].n <= deficit:
                r = q.popleft()
                rn = r.n
                s.rows -= rn
                self.rows -= rn
                self.requests -= 1
                deficit -= rn
                batch.append(r)
                rows += rn
                popped = True
                if rows >= max_rows:
                    break
            s.deficit = deficit
            if not q:
                # retire: leave the rotation (slot object persists);
                # _idx now names the next slot
                s.deficit = 0.0
                s.rows = 0
                rotation.pop(self._idx)
                if self._idx >= len(rotation):
                    self._idx = 0
            else:
                self._idx += 1
            idle_visits = 0 if popped else idle_visits + 1
            if batch and idle_visits > len(rotation):
                break
        return batch

    def flush(self) -> List[_Request]:
        """Drain every queued request (stop(drain=False))."""
        drained = [r for s in self._rotation for r in s.queue]
        for s in self._rotation:
            s.queue.clear()
            s.rows = 0
            s.deficit = 0.0
        self._rotation.clear()
        self._idx = 0
        self.rows = 0
        self.requests = 0
        return drained


class ServingEngine:
    """See module docstring. Construct with a model (portable
    artifact path / portable.PortableModel / FusedScorer) or a prebuilt
    ModelRegistry (the multi-model catalog path), call start(), then
    score()/submit() from any number of threads. ``device`` places a
    model passed as ``model=`` (see ModelRegistry.register: None loads
    a path onto CUDA, raising without it)."""

    def __init__(self, model=None, *, registry: Optional[ModelRegistry] = None,
                 buckets=True, config: Optional[EngineConfig] = None,
                 version: str = "v1", warm_sample=None, device=None):
        if (model is None) == (registry is None):
            raise ValueError("pass exactly one of model= or registry=")
        if registry is None:
            registry = ModelRegistry()
            registry.register(version, model, buckets=buckets,
                              warm_sample=warm_sample, make_default=True,
                              device=device)
        self.registry = registry
        self.config = config or EngineConfig.from_env()
        self.stats = EngineStats(model_topk=self.config.model_topk)
        self.admission = AdmissionController(
            max_queue_rows=self.config.max_queue_rows,
            max_queue_requests=self.config.max_queue_requests,
            ema_alpha=self.config.ema_alpha,
            tenant_queue_share=self.config.tenant_queue_share)
        #: set at stop(): side-running work handed this event aborts
        #: promptly when the engine shuts down
        self.cancel_event = threading.Event()
        self._cond = threading.Condition()
        #: advisory pre-admission fires only once the queue
        #: is within 2x of a bound — below that no global/deadline
        #: verdict can change before the authoritative admit, so the
        #: light-load submit path skips one occupancy+admit round. (A
        #: tenant can exhaust ITS budget share earlier; that request
        #: just pays prepare before the authoritative reject.)
        self._precheck_rows = max(1, self.config.max_queue_rows // 2)
        self._precheck_requests = max(
            1, self.config.max_queue_requests // 2)
        #: enqueue wakes the dispatcher only on the
        #: empty->nonempty transition (it sits in an UNTIMED wait only
        #: then) or when pending rows cross the flush threshold (its
        #: timed wait re-checks rows); other enqueues change neither
        #: wake condition, so notifying would be a pure spurious wakeup.
        #: None = threshold not cheaply knowable (bucket-derived) —
        #: notify every time.
        self._notify_rows = self.config.max_batch_rows
        #: the tenant-queue plane (mutated only under _cond; the
        #: submit path additionally reads occupancy lock-free for the
        #: advisory pre-prepare admission check)
        self._tq = _ArrayQueues(self.config.tenant_weights,
                                self.config.tenant_default_weight)
        #: device-side fused cross-model plane (TM_SERVE_FUSED_KERNEL)
        self._fused = bool(self.config.fused_kernel)
        #: bounded scorer cache: (member backend ids, sig, serve
        #: policy token) -> FusedGroupScorer (strong backend refs
        #: inside keep the ids stable per entry)
        self._fused_scorers: Dict[tuple, FusedGroupScorer] = {}
        #: backend ids whose stack-ineligibility was already
        #: flight-recorded (fall back loudly, but once per backend)
        self._fused_fallback_seen: set = set()
        self._last_data = None      # most recent request's raw data —
        #                             the default warm sample for swap()
        self._accepting = False
        self._thread: Optional[threading.Thread] = None
        self._dispatcher_alive = False      # flipped ONLY under _cond
        #: request-plane observers: fn(data, future) per ACCEPTED
        #: request — the continuum drift monitor / shadow mirror
        self._taps = RequestTaps(self.stats.note_tap_error)
        self.started_at: Optional[float] = None

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "ServingEngine":
        with self._cond:
            self._accepting = True
            # restart support: a previous stop() set the cancel signal;
            # a running engine must not hand out a pre-fired event
            self.cancel_event.clear()
            if self._dispatcher_alive:
                # a prior stop()'s dispatcher is still draining: with
                # _accepting back on it simply resumes as THE dispatcher
                # (it only exits after re-checking _accepting under this
                # lock, so no start/exit race can strand the queue)
                self._cond.notify_all()
                return self
            self._dispatcher_alive = True
            self._thread = threading.Thread(
                target=self._dispatch_loop, daemon=True,
                name="tm-serving-dispatch")
            self.started_at = time.time()
            self._thread.start()
        return self

    def stop(self, drain: bool = True,
             timeout: Optional[float] = None) -> None:
        """Stop accepting new work. drain=True (default) scores every
        already-accepted request before the dispatcher exits — the
        zero-accepted-loss contract extends to shutdown; drain=False
        fails queued requests with EngineStopped, a DISTINCT retryable
        subclass of EngineClosed (still never silent: each future gets
        the error and the failed counter moves) — a fleet router
        classifies it re-dispatchable, while a bare late submit() keeps
        getting the plain EngineClosed."""
        with self._cond:
            self._accepting = False
            if not drain:
                for r in self._tq.flush():
                    if self._fail_future(r.future, EngineStopped(
                            "engine stopped before dispatch")):
                        # ledger only, NOT a serving outcome: the
                        # fleet router re-dispatches these client-
                        # invisibly, and ring failures here would
                        # poison the next rollout's recent-history
                        # error baseline
                        self.stats.note_failed(ring=False)
                self._note_depth_locked()
            self._cond.notify_all()
        self.cancel_event.set()
        t = self._thread
        if t is not None:
            t.join(timeout if timeout is not None
                   else self.config.drain_timeout_s)

    def __enter__(self) -> "ServingEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- submission (any thread) ------------------------------------------
    # opaudit: hotpath
    def submit(self, data, deadline_ms: Optional[float] = None,
               trace=_spans.UNSET, priority: str = "normal",
               model: Optional[str] = None,
               tenant: Optional[str] = None) -> Future:
        """Queue one request; returns a Future resolving to
        {result name: (n, k) array} for exactly this request's rows.
        `deadline_ms` is a relative budget: the request is rejected now
        if the EMA says it cannot be met, and shed before device
        dispatch if it expires while queued. ``priority="low"`` marks
        shed-first traffic (explanations, best-effort rescoring): under
        a re-priced admission controller it is rejected BEFORE
        same-deadline normal traffic (admission.PRIORITIES).

        ``model`` selects WHICH registered version (or alias) scores
        this request. An unknown id raises ``registry.ModelNotFound``
        HERE, loudly — the pre-refactor behavior (silently scoring the
        registry default) is gone. ``model=None`` follows the registry
        default pointer, including across hot-swaps. A COLD model's
        load/reload runs on THIS submitting thread, never on the
        dispatcher hot path.

        ``tenant`` is the admission + fairness identity: per-tenant
        queue budgets reject at the tenant's share of the bounded
        queue, and the dispatcher drains tenants by weighted deficit
        round-robin. ``None`` rides the shared "default" tenant.

        ``trace`` carries an UPSTREAM sampling decision (the fleet
        router's minted id, or None for its sampled-out requests) so
        one request is sampled ONCE however many layers it crosses; a
        bare submit leaves the default and the engine samples at
        admission itself. Sampled-out requests pay one branch here —
        no id, no allocation, no lock.

        One stats-lock acquisition per request (note_submit_depth,
        inside _cond so the depth gauge never goes stale against the
        dispatcher's post-drain write); the dtype signature is computed
        here, not on the dispatcher."""
        # opaudit: disable=concurrency -- advisory admission gate: a stale read costs one request an EngineClosed (or one extra enqueue that stop(drain) resolves); the authoritative _accepting check runs under _cond in the dispatcher/stop path
        if not self._accepting:
            raise EngineClosed("engine is not accepting requests")
        t_submit = _monotonic()
        tenant = DEFAULT_TENANT if tenant is None else str(tenant)
        if trace is _spans.UNSET:
            trace = (_TRACER.sample_trace()
                     if _TRACER.enabled else None)
        deadline = (t_submit + deadline_ms / 1e3
                    if deadline_ms is not None else None)
        tq = self._tq
        # cheap PRE-check before paying the host prefix: under overload
        # (the moment backpressure exists for) a doomed request must be
        # rejected without parsing/hashing all its rows first. Advisory
        # and LOCK-FREE here (occupancy reads may be a beat stale); the
        # authoritative admit re-runs under the lock below. Gated on
        # queue pressure: far from every bound the verdict cannot
        # differ, so the light-load path skips the extra admit round.
        if (tq.rows >= self._precheck_rows
                or tq.requests >= self._precheck_requests):
            approx = self._approx_rows(data)
            if approx is not None:
                trows, treqs = tq.occupancy(tenant)
                self._admit_checked(approx, deadline, priority,
                                    tq.rows, tq.requests, trows, treqs)
        t_prepare = _monotonic() if trace is not None else 0.0
        # resolves the model id — ModelNotFound raises here, before any
        # queueing — and runs the host prefix against it
        with self.registry.acquire(model) as (vname, backend):
            n, vals = backend.prepare(data)
        if trace is not None:
            _TRACER.record(trace, "engine.prepare", t_prepare,
                           _monotonic(), rows=n,
                           version=vname, tenant=tenant)
        sig = tuple(_asarray(v).dtype.str for v in vals)
        req = _Request(data, n, vals, backend, deadline, trace,
                       model=model, tenant=tenant, t_submit=t_submit,
                       sig=sig)
        if trace is not None:
            # stamp BEFORE enqueue: the dispatcher may see the future
            # the instant it is queued
            _spans.set_trace(req.future, trace)
        cond = self._cond
        with cond:
            if not self._accepting:
                raise EngineClosed("engine is not accepting requests")
            trows, treqs = tq.occupancy(tenant)
            self._admit_checked(n, deadline, priority,
                                tq.rows, tq.requests, trows, treqs)
            # re-stamp at actual enqueue: time burned in prepare +
            # admission belongs to the admission segment, not queue
            req.enqueued_at = _monotonic()
            tq.enqueue(req)
            self._last_data = data
            self.stats.note_submit_depth(tq.requests, tq.rows)
            # single waiter (the dispatcher): notify() over
            # notify_all(), and only when this enqueue can change what
            # it is waiting FOR (see _notify_rows above)
            notify_rows = self._notify_rows
            if (tq.requests == 1 or notify_rows is None
                    or tq.rows >= notify_rows):
                cond.notify()
        if trace is not None:
            sp = _TRACER.begin(trace, "engine.request", rows=n,
                               model=vname, tenant=tenant)
            req.future.add_done_callback(
                lambda f, sp=sp: sp.end(outcome=_future_outcome(f)))
        taps = self._taps
        if taps._taps:
            taps.notify(data, req.future)
        return req.future

    # -- request taps (continuum monitor / shadow mirror) ------------------
    def add_tap(self, fn) -> None:
        """Register a request-plane observer: ``fn(data, future)`` is
        called once per ACCEPTED request (after admission + enqueue, on
        the submitting thread). The contract is observe-only: a tap
        must be O(1)-cheap and must never raise — a raising tap is
        swallowed (the live request proceeds) and counted in
        ``EngineStats.tap_errors``, never silent."""
        self._taps.add(fn)

    def remove_tap(self, fn) -> None:
        self._taps.remove(fn)

    def score(self, data, timeout: Optional[float] = None,
              deadline_ms: Optional[float] = None,
              priority: str = "normal", model: Optional[str] = None,
              tenant: Optional[str] = None) -> Dict[str, np.ndarray]:
        """Blocking convenience: submit + wait for this request's rows."""
        return self.submit(data, deadline_ms=deadline_ms,
                           priority=priority, model=model,
                           tenant=tenant).result(timeout)

    # -- hot swap ---------------------------------------------------------
    def swap(self, version: str, model, *, buckets=True, warm_sample=None,
             retire_old: bool = True, device=None) -> Optional[str]:
        """Zero-downtime model swap: warm the new version's buckets,
        atomically flip the default, drain + release the old version.
        Safe to call while traffic is flowing; accepted requests are
        never lost (pre-flip queued requests re-prepare against the new
        version at dispatch if their boundary contract changed).

        With no warm_sample, the most recent request's raw data warms
        the new version instead — zero-filled float32 warm data has the
        wrong dtypes for models with integer boundary columns. Real
        traffic is the ground truth for boundary dtypes."""
        if warm_sample is None:
            warm_sample = self._last_data
        prev = self.registry.hot_swap(
            version, model, buckets=buckets, warm_sample=warm_sample,
            retire_old=retire_old,
            drain_timeout=self.config.drain_timeout_s, device=device)
        self.stats.note_swap()
        _flight.record("engine", "swap", version=version, previous=prev,
                       retire_old=retire_old)
        return prev

    # -- liveness / readiness ---------------------------------------------
    def live(self) -> bool:
        t = self._thread
        return bool(t is not None and t.is_alive())

    def ready(self) -> bool:
        # opaudit: disable=concurrency -- readiness probe: a stale _accepting read flips the answer one poll late, which is what every scraper already tolerates; taking _cond here would let probes contend with the dispatcher
        if not (self.live() and self._accepting):
            return False
        try:
            self.registry.get()
            return True
        except KeyError:
            return False

    def status(self) -> Dict[str, Any]:
        from .health import status_snapshot
        return status_snapshot(self)

    # -- dispatcher internals ---------------------------------------------
    def _fail_future(self, fut: Future, exc: BaseException) -> bool:
        """set_exception guarded against caller-side cancel(): a future
        cancelled between queue and resolution must not raise
        InvalidStateError inside the dispatcher (which would kill the
        dispatch thread and hang every other caller). Returns True when
        the exception was delivered; False means the request ended as
        CANCELLED (counted here) — the caller must then NOT also count
        it, keeping the exactly-one-terminal-counter invariant."""
        try:
            if not fut.cancelled():
                fut.set_exception(exc)
                return True
        except Exception:       # lost the cancel race — already resolved
            pass
        self.stats.note_cancelled()
        return False

    @staticmethod
    def _approx_rows(data) -> Optional[int]:
        """Cheap row count WITHOUT running the host prefix (for the
        pre-prepare admission check). None = not cheaply knowable."""
        n = getattr(data, "n_rows", None)
        if isinstance(n, int):
            return n
        if isinstance(data, dict):
            for v in data.values():
                try:
                    return len(v)
                except TypeError:
                    return None
            return 0
        if isinstance(data, (list, tuple)):
            return len(data)
        return None

    def _admit_checked(self, rows: int, deadline: Optional[float],
                       priority: str, queued_rows: int,
                       queued_requests: int, tenant_rows: int,
                       tenant_requests: int) -> None:
        """admission.admit against EXPLICIT occupancy numbers,
        recording any rejection — never a silent drop. The pre-check
        passes advisory lock-free reads, the authoritative admit
        lock-held ones."""
        try:
            self.admission.admit(
                rows, deadline, queued_rows, queued_requests,
                priority=priority, tenant_rows=tenant_rows,
                tenant_requests=tenant_requests)
        except TenantBudgetExceeded:
            self.stats.note_rejected("tenant_budget")
            raise
        except QueueFull:
            self.stats.note_rejected("queue_full")
            raise
        except DeadlineUnmeetable:
            self.stats.note_rejected("predicted_late")
            raise

    def _note_depth_locked(self) -> None:
        self.stats.note_queue_depth(self._tq.requests, self._tq.rows)

    def _max_batch_rows(self) -> int:
        cfg = self.config.max_batch_rows
        if cfg is not None:
            return cfg
        try:
            v = self.registry.get()
            buckets = getattr(v.backend, "buckets", None)
        except KeyError:
            buckets = None
        return buckets[-1] if buckets else 8192

    def _collect(self) -> Optional[List[_Request]]:
        """Block until a drain pass is ready; None = shut down (queues
        empty and no longer accepting). Flush when pending rows reach
        max_batch_rows, when the OLDEST request has waited max_wait_ms,
        or immediately on shutdown (drain)."""
        max_rows = self._max_batch_rows()
        max_wait = self.config.max_wait_ms / 1e3
        tq = self._tq
        with self._cond:
            while not tq.requests:
                if not self._accepting:
                    return None
                # untimed: submit() and stop() both notify under this
                # condition, so an idle engine sleeps instead of polling
                self._cond.wait()
            flush_at = tq.oldest() + max_wait
            while (self._accepting and tq.rows < max_rows):
                remaining = flush_at - _monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
            batch = tq.drr_pop(max_rows,
                               float(self.config.tenant_quantum_rows))
            self._note_depth_locked()
            return batch

    def _dispatch_loop(self) -> None:
        while True:
            batch = self._collect()
            if batch is None:
                with self._cond:
                    if self._accepting:
                        continue    # restarted mid-shutdown: keep serving
                    self._dispatcher_alive = False
                    return
            now = _monotonic()
            live, expired = self.admission.split_expired(batch, now)
            for r in expired:
                if self._fail_future(r.future, DeadlineExpired(
                        f"deadline expired after {now - r.enqueued_at:.3f}s "
                        f"in queue; shed before device dispatch")):
                    self.stats.note_shed()
            # transition PENDING -> RUNNING: a caller's fut.cancel() can
            # no longer win after this point, so the scatter below can
            # set_result unconditionally; already-cancelled requests
            # drop out before their rows reach the device
            running = []
            for r in live:
                if r.future.set_running_or_notify_cancel():
                    running.append(r)
                else:
                    self.stats.note_cancelled()
            if not running:
                continue
            self._run_pass(running)

    # opaudit: hotpath
    def _run_pass(self, batch: List[_Request]) -> None:
        """Dispatch one drain pass: resolve every distinct model key
        once (holding the version refcounts for the whole pass), group
        into (backend, dtype-signature) sub-batches — requests whose
        model ids share a backend (registry aliases) CO-BATCH into one
        device dispatch — then LAUNCH every sub-batch before
        materializing any (launches only queue work on the device
        stream, so sub-batches for different models queue back to
        back instead of each waiting on the previous one's results),
        and finally scatter
        results back per request. A failure anywhere fails only the
        requests it touches."""
        t_dispatch = _monotonic()
        # ONE stats-lock acquisition for the whole pass's wait
        # bookkeeping; span records only when a member is sampled
        waits = []
        append = waits.append
        any_traced = False
        for r in batch:
            append(t_dispatch - r.enqueued_at)
            if r.trace is not None:
                any_traced = True
        self.stats.note_dispatch_waits(waits)
        if any_traced:
            record = _TRACER.record
            for r in batch:
                if r.trace is not None:
                    record(r.trace, "engine.queue",
                           r.enqueued_at, t_dispatch)
        keys: Dict[Optional[str], None] = {}
        for r in batch:
            keys.setdefault(r.model)
        with contextlib.ExitStack() as stack:
            resolved: Dict[Optional[str], tuple] = {}
            for key in keys:
                try:
                    lease = self.registry.acquire_if_loaded(key)
                    vname, backend = stack.enter_context(lease)
                except Exception as e:  # noqa: BLE001 — per-key failure
                    # retired/released between submit and dispatch:
                    # fail THIS key's requests below, not the whole pass
                    resolved[key] = (None, None, None, e)
                else:
                    # publish-time dispatch capabilities ride the lease
                    # (the pre-caps hot path re-ran getattr + signature
                    # probes on every dispatch)
                    resolved[key] = (vname, backend, lease.caps, None)
            ready: List[tuple] = []     # (request, vname, backend, caps)
            for r in batch:
                vname, backend, caps, err = resolved[r.model]
                if err is not None:
                    r.future.set_exception(err)     # RUNNING: no race
                    self.stats.note_failed()
                    continue
                if backend is None:
                    # the model went COLD (LRU-evicted) between submit
                    # and dispatch: score on the backend this request
                    # was prepared under — the same model, kept alive
                    # by the request's own reference. Loading it back
                    # here would stall the dispatcher for EVERY model
                    # and tenant; the next submit reloads it on a
                    # submitting thread instead. (Cold = rare: caps are
                    # re-resolved on the fly for this request only.)
                    ready.append((r, vname, r.prepared_by,
                                  _backend_caps(r.prepared_by)))
                    continue
                if r.prepared_by is not backend:
                    # hot-swap (or LRU eviction + reload) landed between
                    # submit and dispatch (identity check: even a
                    # re-registered NAME is a different backend): re-run
                    # the host prefix against the serving backend so
                    # boundary values match its device tail
                    try:
                        r.n, r.vals = backend.prepare(r.data)
                        r.prepared_by = backend
                        r.sig = None    # cached signature now stale
                    except Exception as e:
                        r.future.set_exception(e)   # RUNNING: no race
                        self.stats.note_failed()
                        continue
                ready.append((r, vname, backend, caps))
            # group by (backend identity, prepared dtype signature):
            # np.concatenate would silently PROMOTE a mixed int/float
            # boundary column (corrupting hashed ids above 2^24 for
            # every request in the sub-batch); an odd-typed request
            # scores in its own group
            groups: Dict[tuple, List[_Request]] = {}
            by_backend: Dict[int, tuple] = {}
            for r, vname, backend, caps in ready:
                sig = r.sig
                if sig is None:
                    sig = tuple(_asarray(v).dtype.str for v in r.vals)
                groups.setdefault((id(backend), sig), []).append(r)
                by_backend[id(backend)] = (vname, backend, caps)
            if self._fused and len(groups) > 1:
                fused_plans, classic = self._plan_fused(groups,
                                                        by_backend)
            else:
                fused_plans, classic = (), groups.items()
            fused_launched = []
            for members in fused_plans:
                entry = self._launch_fused(members)
                if entry is not None:
                    fused_launched.append(entry)
            launched = []
            for (bid, _sig), reqs in classic:
                vname, backend, caps = by_backend[bid]
                entry = self._launch_group(reqs, vname, backend, caps)
                if entry is not None:
                    launched.append(entry)
            for entry in fused_launched:
                self._finalize_fused(*entry, t_dispatch)
            for entry in launched:
                self._finalize_group(*entry, t_dispatch)

    def _launch_group(self, batch: List[_Request], vname: str, backend,
                      caps=None):
        """Gather one co-batch group's rows and launch its device
        dispatch; returns the in-flight entry for _finalize_group, or
        None when the launch failed (the group's futures already carry
        the error). ``t_built`` is stamped after gather/concat but
        BEFORE the fault point so the host-overhead build segment never
        absorbs an emulated device hang. ``caps`` is the lease's
        publish-time BackendCaps: the two-phase launch fn is already
        resolved there, so the hot path keeps only the cheap
        instance-``run``-override probe per dispatch."""
        t0 = _monotonic()
        try:
            if len(batch) == 1:
                n, vals = batch[0].n, batch[0].vals
            else:
                n = sum(r.n for r in batch)
                vals = [np.concatenate([r.vals[i] for r in batch], axis=0)
                        for i in range(len(batch[0].vals))]
            t_built = _monotonic()
            # chaos-drill hook: an injected raise here fails this
            # sub-batch's futures through the except below — exactly
            # the surface a replica-local dispatch crash (OOM, device
            # loss) presents to a fleet router. One arrival per
            # SUB-BATCH: aliased models pay it once, serial per-model
            # dispatch pays it per model.
            fault_point("serving.engine.dispatch", version=vname,
                        requests=len(batch))
            launch = (caps.launch if caps is not None
                      else getattr(backend, "launch", None))
            if launch is not None \
                    and "run" not in getattr(backend, "__dict__", {}):
                return (batch, backend, vname, n, t0, t_built,
                        launch(n, vals), False)
            # duck-typed backend without the two-phase API — or one
            # whose run() was instance-wrapped (gating/instrumentation
            # interposers must stay THE single scoring entry point):
            # synchronous, no overlap, same results
            return (batch, backend, vname, n, t0, t_built,
                    backend.run(n, vals), True)
        except Exception as e:      # noqa: BLE001 — fails this group
            for r in batch:
                if not r.future.done():
                    r.future.set_exception(e)
            self.stats.note_failed(len(batch))
            return None

    # opaudit: hotpath
    def _plan_fused(self, groups: Dict[tuple, List[_Request]],
                    by_backend: Dict[int, tuple]):
        """Partition one drain pass's (backend, sig) groups into fused
        family launches and classic co-batch groups. Groups whose
        backends carry a stackable head AND share a fuse key (same
        boundary layout, buckets, head shape/activation, dtype sig)
        merge when at least ``fused_min_models`` distinct backends are
        present; everything else keeps the Python-layer co-batching.
        Stack-ineligible two-phase backends fall back LOUDLY: counted
        per pass, flight-recorded once per backend."""
        classic = []
        pools: Dict[tuple, list] = {}
        no_ns = dict()          # hoisted getattr default (hot loop)
        for key, reqs in groups.items():
            bid, sig = key
            vname, backend, caps = by_backend[bid]
            spec = caps.stack if caps is not None else None
            if spec is None or "run" in getattr(backend, "__dict__", no_ns):
                if (spec is None and caps is not None
                        and caps.launch is not None):
                    self._note_unstackable(bid, vname, backend)
                classic.append((key, reqs))
                continue
            pools.setdefault((sig,) + spec.fuse_key(), []).append(
                (sig, reqs, vname, backend, spec))
        fused = []
        min_models = self.config.fused_min_models
        for pool in pools.values():
            if len(pool) >= min_models:
                # canonical member order (by version name): the model
                # index each request rides under — and the scorer
                # cache key — must not depend on arrival order
                pool.sort(key=lambda m: m[2])
                fused.append(pool)
            else:
                for m in pool:
                    classic.append(((id(m[3]), m[0]), m[1]))
        return fused, classic

    def _note_unstackable(self, bid: int, vname: str, backend) -> None:
        self.stats.note_fused_fallback()
        if bid not in self._fused_fallback_seen:
            self._fused_fallback_seen.add(bid)
            _flight.record(
                "serving", "fused_fallback", severity="warning",
                version=vname, kind=getattr(backend, "kind", None))

    def _fused_scorer(self, members):
        """Bounded cache of fused group scorers. Key: (member backend
        ids, dtype signature, serve policy token) — the scorer holds
        STRONG refs to its member backends, so the ids cannot be reused
        while the entry lives, and a flipped parity / dtype knob
        rebuilds instead of reusing a stale scorer.

        Returns ``(scorer, positions)`` where ``positions[k]`` is the
        model-id value member ``k``'s rows ride under. On an exact-key
        miss, a cached scorer whose member set is a SUPERSET of the
        current members (same sig/policy) is reused with remapped
        positions: absent members simply receive no rows, and every
        distinct subset of a family pending in a drain pass does not
        build (and stack weights for) a scorer of its own."""
        ids = tuple(id(m[3]) for m in members)
        tail = (members[0][0], _serve_policy_token(members[0][4].device))
        sc = self._fused_scorers.get((ids,) + tail)
        if sc is not None:
            _FUSED_SCORER_STATS.note_hit()
            return sc, tuple(range(len(members)))
        want = set(ids)
        for ckey, csc in self._fused_scorers.items():
            if ckey[1:] == tail and want.issubset(ckey[0]):
                pos = dict()
                for j, bid in enumerate(ckey[0]):
                    pos[bid] = j
                _FUSED_SCORER_STATS.note_hit()
                return csc, tuple(pos[b] for b in ids)
        sc = FusedGroupScorer([(m[3], m[4]) for m in members])
        if len(self._fused_scorers) >= _FUSED_SCORER_CAP:
            # catalogs churn: drop the oldest entry (insertion
            # order); a re-fused family just rebuilds
            self._fused_scorers.pop(
                next(iter(self._fused_scorers)))
            _FUSED_SCORER_STATS.note_evict(len(self._fused_scorers))
        self._fused_scorers[(ids,) + tail] = sc
        _FUSED_SCORER_STATS.note_miss(len(self._fused_scorers))
        return sc, tuple(range(len(members)))

    # opaudit: hotpath
    def _launch_fused(self, members):
        """Gather ALL member groups' rows plus the per-row model-id
        vector and launch ONE fused kernel per bucket slice for the
        whole family (fusion.FusedGroupScorer). The dispatch fault
        point — and the per-launch overhead it stands for — is paid
        once per FAMILY instead of once per backend. Returns the
        in-flight entry for _finalize_fused, or None when the launch
        failed (the members' futures already carry the error)."""
        t0 = _monotonic()
        batch: List[_Request] = []
        try:
            scorer, mpos = self._fused_scorer(members)
            meta = []           # (result column name, vname) per request
            mid_parts = []
            for k, (_sig, reqs, vname, _backend, spec) in \
                    enumerate(members):
                for r in reqs:
                    batch.append(r)
                    meta.append((spec.result_name, vname))
                    mid_parts.append(np.full(r.n, mpos[k], np.int32))
            n = sum(r.n for r in batch)
            vals = [np.concatenate([r.vals[i] for r in batch], axis=0)
                    for i in range(len(batch[0].vals))]
            mid = (mid_parts[0] if len(mid_parts) == 1
                   else np.concatenate(mid_parts))
            t_built = _monotonic()
            fault_point("serving.engine.dispatch",
                        version="+".join(m[2] for m in members),
                        requests=len(batch))
            return (batch, meta, scorer, len(members), n, t0, t_built,
                    scorer.launch(n, vals, mid))
        except Exception as e:      # noqa: BLE001 — fails this launch
            failed = 0
            for _sig, reqs, _vname, _backend, _spec in members:
                for r in reqs:
                    failed += 1
                    if not r.future.done():
                        r.future.set_exception(e)
            self.stats.note_failed(failed)
            return None

    # opaudit: hotpath
    def _finalize_fused(self, batch: List[_Request], meta, scorer,
                        models: int, n: int, t0: float, t_built: float,
                        payload, t_dispatch: float) -> None:
        """Materialize one fused family launch and scatter each
        request's rows under its OWN backend's result column name.
        Books the same completion stats as _finalize_group plus the
        fused-plane counters; sampled requests fan into an
        ``engine.fused_dispatch`` batch span."""
        try:
            out = scorer.finalize(payload)
        except Exception as e:      # noqa: BLE001 — fails this launch
            for r in batch:
                if not r.future.done():
                    r.future.set_exception(e)
            self.stats.note_failed(len(batch))
            return
        t1 = _monotonic()
        self.admission.ema.update(n, t1 - t0)
        self.stats.note_fused(len(batch), n, models)
        traced = [r for r in batch if r.trace is not None]
        if traced:
            bt = _TRACER.mint("batch")
            _TRACER.record(bt, "engine.fused_dispatch", t0, t1,
                           requests=len(batch), rows=n,
                           shape_bucket=shape_bucket(n), models=models,
                           fan_in=[r.trace for r in traced])
            for r, (_name, vname) in zip(batch, meta):
                if r.trace is not None:
                    _TRACER.record(r.trace, "engine.execute", t0, t1,
                                   batch=bt, rows=r.n, model=vname)
        off = 0
        overhead = []
        traffic = []
        for r, (name, vname) in zip(batch, meta):
            rn = r.n
            # slices .copy() so callers own their memory (a retained
            # small result must not pin the fused batch's buffer)
            sl = dict()
            sl[name] = out[off:off + rn].copy()
            off += rn
            r.future.set_result(sl)
            t_done = _monotonic()
            overhead.append((r.enqueued_at - r.t_submit,
                             t_dispatch - r.enqueued_at,
                             t_built - t_dispatch,
                             t_done - t1))
            traffic.append((r.model if r.model is not None
                            else vname, r.tenant, rn))
        self.stats.note_group_complete(len(batch), n, traffic, overhead)

    # opaudit: hotpath
    def _finalize_group(self, batch: List[_Request], backend, vname: str,
                        n: int, t0: float, t_built: float, payload,
                        done: bool, t_dispatch: float) -> None:
        """Materialize one launched sub-batch and scatter results back
        to its member requests' futures (submission row order), then
        book the whole group's completion stats — batch shape,
        model/tenant traffic, host-overhead segments — in ONE
        stats-lock acquisition via note_group_complete. Traffic is
        attributed to the REQUESTED model id (aliases stay
        distinguishable), else the resolved default's name."""
        try:
            out = payload if done else backend.finalize(payload)
        except Exception as e:      # noqa: BLE001 — fails this group
            for r in batch:
                if not r.future.done():
                    r.future.set_exception(e)
            self.stats.note_failed(len(batch))
            return
        t1 = _monotonic()
        self.admission.ema.update(n, t1 - t0)
        traced = [r for r in batch if r.trace is not None]
        if traced:
            # ONE batch span fanning in the member requests' traces,
            # plus a per-request execute span joining each sampled
            # request's own trace to the batch it coalesced into
            bt = _TRACER.mint("batch")
            _TRACER.record(bt, "engine.batch", t0, t1,
                           requests=len(batch), rows=n,
                           shape_bucket=shape_bucket(n),
                           model=vname,
                           fan_in=[r.trace for r in traced])
            for r in traced:
                _TRACER.record(r.trace, "engine.execute", t0, t1,
                               batch=bt, rows=r.n, model=vname)
        single = len(batch) == 1
        if not single:
            # materialize each result column ONCE for the whole group
            # instead of per request (the slices still .copy() so
            # callers own their memory — bitwise-identical results)
            items = [(k, _asarray(v)) for k, v in out.items()]
        off = 0
        overhead = []
        traffic = []
        for r in batch:
            # callers get arrays that OWN their memory: a retained
            # small result must pin neither the coalesced batch's
            # result buffers nor (single-request case, where _finalize
            # returns a slice-view of the padded output) the whole
            # bucket-padded array
            rn = r.n
            if single:
                sl = {k: self._owned(v) for k, v in out.items()}
            else:
                sl = {k: v[off:off + rn].copy() for k, v in items}
            off += rn
            r.future.set_result(sl)
            # resolve stamp AFTER set_result: the segment charges the
            # done-callback sweep (span ends, router hops) to resolve
            t_done = _monotonic()
            overhead.append((r.enqueued_at - r.t_submit,
                             t_dispatch - r.enqueued_at,
                             t_built - t_dispatch,
                             t_done - t1))
            traffic.append((r.model if r.model is not None else vname,
                            r.tenant, rn))
        self.stats.note_group_complete(len(batch), n, traffic, overhead)

    @staticmethod
    def _owned(a) -> np.ndarray:
        a = np.asarray(a)
        return a.copy() if a.base is not None else a
