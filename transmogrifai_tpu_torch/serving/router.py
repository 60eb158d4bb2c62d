"""Shared-nothing fleet router: placement, circuit breaking, failover.

The fleet layer (fleet.py) supervises N independent ServingEngine
replicas; this module decides WHERE each request goes and what happens
when a replica fails it:

* **Consistent-hash placement** — every model version maps to a
  deterministic rendezvous order over the replica set (stable hash, no
  ring to rebalance): the first ``placement_width`` replicas are the
  version's home set (traffic round-robins across them), the rest of
  the order is the failover ladder. Adding or losing a replica moves
  only the versions whose order actually changed — the property that
  makes a multi-model fleet's memory footprint predictable.
* **Per-replica circuit breakers** — classic closed → open →
  half-open → closed. A replica opens on consecutive failures OR on a
  failure ratio over a recent-outcome window (timeouts count); while
  open it takes no traffic; after ``open_s`` one half-open probe
  request tests it, success closes, failure re-opens. Breakers keep a
  crashing replica from eating every request's first attempt.
* **Deadline-aware failover re-dispatch** — a retryable failure
  (EngineStopped from a killed replica, injected transients, a closed
  engine) re-dispatches to the next replica in the ladder, sleeping
  the SAME deterministic seeded-jitter backoff schedule as every other
  retry in this codebase (resilience.policy.RetryPolicy.sleep_for —
  shared, not re-implemented), clamped so the sleep never eats a
  request's remaining deadline budget. Backpressure signals
  (QueueFull, DeadlineUnmeetable) fail over IMMEDIATELY with no
  breaker penalty — an overloaded replica is not a broken one.

Re-dispatch sleeps happen on the router's own timer thread, never on a
replica's dispatcher thread — a failing replica must not slow the
healthy ones' scatter path — and due re-dispatches hand off to a small
pool so a burst of failovers after a crash can't head-of-line block
each other on the timer thread either.
"""
from __future__ import annotations

import hashlib
import heapq
import itertools
import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

from ..resilience.config import parse_env_fields
from ..resilience.faults import FaultError, fault_point
from ..resilience.policy import RetryPolicy, is_retryable
from ..telemetry import recorder as _flight
from ..telemetry import spans as _spans
from .admission import (DeadlineExpired, DeadlineUnmeetable, EngineClosed,
                        EngineStopped, QueueFull, RejectedError)


class NoReplicaAvailable(RejectedError):
    """Every candidate replica is dead, stopped, or circuit-open —
    the fleet-level backpressure signal (retry with backoff)."""

    retryable = True


# -- circuit breaker ---------------------------------------------------------

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class CircuitBreaker:
    """Per-replica three-state breaker.

    Opens when EITHER trip condition holds:
      * ``failure_threshold`` consecutive failures, or
      * failure ratio >= ``ratio_threshold`` over the last ``window``
        outcomes, once at least ``min_volume`` outcomes exist
        (timeouts recorded as failures — the "timeout ratio" trip).

    While OPEN, ``allow()`` refuses traffic until ``open_s`` elapses,
    then the breaker turns HALF_OPEN and ``allow()`` admits exactly one
    in-flight probe; the probe's outcome settles the state (success →
    CLOSED with counters reset, failure → OPEN with the timer
    re-armed). ``clock`` is injectable so the state machine unit-tests
    without real sleeps."""

    def __init__(self, failure_threshold: int = 5,
                 ratio_threshold: float = 0.5, window: int = 20,
                 min_volume: int = 10, open_s: float = 1.0,
                 clock=time.monotonic, on_transition=None,
                 on_probe=None):
        if failure_threshold < 1 or window < 1 or min_volume < 1:
            raise ValueError("breaker thresholds must be >= 1")
        if not (0.0 < ratio_threshold <= 1.0):
            raise ValueError("ratio_threshold must be in (0, 1]")
        self.failure_threshold = int(failure_threshold)
        self.ratio_threshold = float(ratio_threshold)
        self.min_volume = int(min_volume)
        self.open_s = float(open_s)
        self._clock = clock
        self._on_transition = on_transition
        self._on_probe = on_probe
        self._lock = threading.Lock()
        self._state = CLOSED
        self._outcomes: deque = deque(maxlen=int(window))
        self._consecutive_failures = 0
        self._opened_at: Optional[float] = None
        self._probe_inflight = False

    def _transition(self, new: str) -> None:
        old, self._state = self._state, new
        if new == OPEN:
            self._opened_at = self._clock()
        if self._on_transition is not None and old != new:
            self._on_transition(old, new)

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            return self._state

    def _maybe_half_open(self) -> None:
        if self._state == OPEN and \
                self._clock() - self._opened_at >= self.open_s:
            self._probe_inflight = False
            self._transition(HALF_OPEN)

    def allow(self):
        """May a request dispatch to this replica right now? Returns
        False (refuse), True (CLOSED-state admit), or the truthy string
        ``"probe"`` — HALF_OPEN handed the caller THE single probe
        slot, and the caller must report its outcome with
        record_success/record_failure(probe=True)."""
        probe = False
        with self._lock:
            self._maybe_half_open()
            if self._state == CLOSED:
                return True
            if self._state == HALF_OPEN and not self._probe_inflight:
                self._probe_inflight = True
                probe = True
        if probe and self._on_probe is not None:
            self._on_probe()
        return "probe" if probe else False

    def record_success(self, probe: bool = False) -> None:
        """Only the reserved probe's outcome settles a HALF_OPEN
        breaker: a stale success from a request dispatched BEFORE the
        breaker opened must not close it without probe evidence (full
        traffic would return to a still-degraded replica while the real
        probe is still out)."""
        with self._lock:
            self._consecutive_failures = 0
            self._outcomes.append(True)
            if self._state == HALF_OPEN and probe:
                self._outcomes.clear()
                self._probe_inflight = False
                self._transition(CLOSED)

    def record_failure(self, probe: bool = False) -> None:
        with self._lock:
            self._outcomes.append(False)
            self._consecutive_failures += 1
            if self._state == HALF_OPEN:
                if probe:           # stale failures just record
                    self._probe_inflight = False
                    self._transition(OPEN)
                return
            if self._state != CLOSED:
                return
            failures = sum(1 for ok in self._outcomes if not ok)
            if (self._consecutive_failures >= self.failure_threshold
                    or (len(self._outcomes) >= self.min_volume
                        and failures / len(self._outcomes)
                        >= self.ratio_threshold)):
                self._transition(OPEN)

    def release_probe(self) -> None:
        """Free a reserved half-open probe slot WITHOUT recording an
        outcome: the probe attempt ended in backpressure (QueueFull /
        DeadlineUnmeetable), which proves the replica full, not broken
        — no penalty, no close, and the next allow() may probe again.
        Without this, an overload outcome on the single probe would
        leave ``_probe_inflight`` set forever and wedge the breaker in
        HALF_OPEN — permanently unroutable, in exactly the overload
        regime that trips breakers in the first place."""
        with self._lock:
            if self._state == HALF_OPEN:
                self._probe_inflight = False

    def force_open(self) -> None:
        """Trip immediately (replica observed dead — no need to burn
        ``failure_threshold`` requests proving it)."""
        with self._lock:
            if self._state != OPEN:
                self._transition(OPEN)
            else:
                self._opened_at = self._clock()    # re-arm the timer

    def as_dict(self) -> Dict[str, Any]:
        with self._lock:
            self._maybe_half_open()
            outcomes = list(self._outcomes)
            return {"state": self._state,
                    "consecutive_failures": self._consecutive_failures,
                    "window_failures": sum(1 for ok in outcomes if not ok),
                    "window_size": len(outcomes),
                    "opened_at": self._opened_at}


# -- gray-failure configs (hedging / ejection / retry budgets) ---------------

#: TM_TRANSPORT_HEDGE_* env knobs (strict parse_env_fields catalog):
#: speculative second dispatch of idempotent score requests after a
#: p-quantile-derived delay. OFF by default — hedging trades extra
#: dispatched load for tail latency, a trade the operator opts into.
_HEDGE_ENV_FIELDS: Dict[str, tuple] = {
    "TM_TRANSPORT_HEDGE_ENABLED": ("enabled", int),
    "TM_TRANSPORT_HEDGE_QUANTILE": ("quantile", float),
    "TM_TRANSPORT_HEDGE_MIN_DELAY_S": ("min_delay_s", float),
    "TM_TRANSPORT_HEDGE_MAX_DELAY_S": ("max_delay_s", float),
    "TM_TRANSPORT_HEDGE_MIN_SAMPLES": ("min_samples", int),
}


class HedgeConfig:
    """Hedged-request tuning (see ``_HEDGE_ENV_FIELDS``). The hedge
    delay is the ``quantile`` of the fleet's recent completion
    latencies clamped to [min_delay_s, max_delay_s]; no hedge fires
    until ``min_samples`` latencies exist — a cold fleet has no p99 to
    derive a delay from."""

    def __init__(self, enabled: int = 0, quantile: float = 0.99,
                 min_delay_s: float = 0.02, max_delay_s: float = 2.0,
                 min_samples: int = 20):
        if not (0.0 < quantile <= 1.0):
            raise ValueError("hedge quantile must be in (0, 1]")
        if min_delay_s < 0 or max_delay_s < min_delay_s:
            raise ValueError(
                "hedge delays must satisfy 0 <= min <= max")
        if min_samples < 1:
            raise ValueError("hedge min_samples must be >= 1")
        self.enabled = bool(enabled)
        self.quantile = float(quantile)
        self.min_delay_s = float(min_delay_s)
        self.max_delay_s = float(max_delay_s)
        self.min_samples = int(min_samples)

    @classmethod
    def from_env(cls, environ: Optional[Dict[str, str]] = None,
                 **overrides) -> "HedgeConfig":
        return cls(**parse_env_fields(
            "TM_TRANSPORT_HEDGE_", _HEDGE_ENV_FIELDS,
            what="hedge env var", environ=environ, overrides=overrides))


#: TM_ROUTER_EJECT_* env knobs (strict catalog): hung-replica
#: detection — the gray-failure complement to the crash supervisor.
#: A replica is HUNG when its oldest in-flight dispatch outlives
#: max(min_age_s, factor x its response-latency EWMA) while its
#: transport still reports live (heartbeat fresh — a crash would have
#: tripped the observed-dead sweep instead).
_EJECT_ENV_FIELDS: Dict[str, tuple] = {
    "TM_ROUTER_EJECT_ENABLED": ("enabled", int),
    "TM_ROUTER_EJECT_EWMA_ALPHA": ("ewma_alpha", float),
    "TM_ROUTER_EJECT_FACTOR": ("factor", float),
    "TM_ROUTER_EJECT_MIN_AGE_S": ("min_age_s", float),
    "TM_ROUTER_EJECT_MIN_SAMPLES": ("min_samples", int),
    "TM_ROUTER_EJECT_PROBE_TIMEOUT_S": ("probe_timeout_s", float),
    "TM_ROUTER_EJECT_LOSER_STREAK": ("loser_streak", int),
}


class EjectConfig:
    """Hung-replica ejection tuning (see ``_EJECT_ENV_FIELDS``)."""

    def __init__(self, enabled: int = 1, ewma_alpha: float = 0.2,
                 factor: float = 8.0, min_age_s: float = 1.0,
                 min_samples: int = 8, probe_timeout_s: float = 1.0,
                 loser_streak: int = 4):
        if not (0.0 < ewma_alpha <= 1.0):
            raise ValueError("eject ewma_alpha must be in (0, 1]")
        if factor <= 0 or min_age_s <= 0 or probe_timeout_s <= 0:
            raise ValueError(
                "eject factor/min_age_s/probe_timeout_s must be > 0")
        if min_samples < 1:
            raise ValueError("eject min_samples must be >= 1")
        if loser_streak < 0:
            raise ValueError("eject loser_streak must be >= 0")
        self.enabled = bool(enabled)
        self.ewma_alpha = float(ewma_alpha)
        self.factor = float(factor)
        self.min_age_s = float(min_age_s)
        self.min_samples = int(min_samples)
        self.probe_timeout_s = float(probe_timeout_s)
        #: consecutive hedge losses that count as hung evidence on their
        #: own (0 disables): when hedging is on, a winner CANCELS the
        #: stuck primary, which clears the oldest-in-flight age before
        #: it can cross the threshold — the streak is the evidence that
        #: survives the rescue. Reset by any direct success.
        self.loser_streak = int(loser_streak)

    @classmethod
    def from_env(cls, environ: Optional[Dict[str, str]] = None,
                 **overrides) -> "EjectConfig":
        return cls(**parse_env_fields(
            "TM_ROUTER_EJECT_", _EJECT_ENV_FIELDS,
            what="eject env var", environ=environ, overrides=overrides))


#: TM_RETRY_BUDGET_* env knobs (strict catalog): token-bucket retry +
#: hedge budgets. Deposits are coupled to OFFERED load (ratio tokens
#: per routed request / per replica dispatch), not to wall time, so
#: amplification (dispatched/offered) is bounded by 1 + ratio at
#: steady state plus the one-time burst — a retry storm can never
#: multiply a brownout into an outage. min_deadline_ms > 0 sheds a
#: request at the ROUTER when its remaining deadline is below the
#: floor — shed here, not dispatched to die on a replica.
_BUDGET_ENV_FIELDS: Dict[str, tuple] = {
    "TM_RETRY_BUDGET_ENABLED": ("enabled", int),
    "TM_RETRY_BUDGET_RATIO": ("ratio", float),
    "TM_RETRY_BUDGET_BURST": ("burst", int),
    "TM_RETRY_BUDGET_HEDGE_RATIO": ("hedge_ratio", float),
    "TM_RETRY_BUDGET_HEDGE_BURST": ("hedge_burst", int),
    "TM_RETRY_BUDGET_REPLICA_BURST": ("replica_burst", int),
    "TM_RETRY_BUDGET_MIN_DEADLINE_MS": ("min_deadline_ms", float),
}


class RetryBudgetConfig:
    """Retry/hedge token-budget tuning (see ``_BUDGET_ENV_FIELDS``)."""

    def __init__(self, enabled: int = 1, ratio: float = 0.2,
                 burst: int = 64, hedge_ratio: float = 0.2,
                 hedge_burst: int = 64, replica_burst: int = 16,
                 min_deadline_ms: float = 0.0):
        if ratio < 0 or hedge_ratio < 0 or min_deadline_ms < 0:
            raise ValueError(
                "budget ratios/min_deadline_ms must be >= 0")
        if burst < 1 or hedge_burst < 1 or replica_burst < 1:
            raise ValueError("budget bursts must be >= 1")
        self.enabled = bool(enabled)
        self.ratio = float(ratio)
        self.burst = int(burst)
        self.hedge_ratio = float(hedge_ratio)
        self.hedge_burst = int(hedge_burst)
        self.replica_burst = int(replica_burst)
        self.min_deadline_ms = float(min_deadline_ms)

    @classmethod
    def from_env(cls, environ: Optional[Dict[str, str]] = None,
                 **overrides) -> "RetryBudgetConfig":
        return cls(**parse_env_fields(
            "TM_RETRY_BUDGET_", _BUDGET_ENV_FIELDS,
            what="retry-budget env var", environ=environ,
            overrides=overrides))


class _TokenBucket:
    """Deterministic token bucket: ``deposit()`` adds ``ratio`` tokens
    per unit of offered load (capped at ``burst``), ``take()`` spends
    one whole token or refuses. No wall clock — the budget tracks
    load, not time, so drills replay bit-identically."""

    __slots__ = ("ratio", "burst", "_tokens", "_lock")

    def __init__(self, ratio: float, burst: int):
        self.ratio = float(ratio)
        self.burst = float(burst)
        self._tokens = float(burst)
        self._lock = threading.Lock()

    def deposit(self, units: float = 1.0) -> None:
        with self._lock:
            self._tokens = min(self.burst,
                               self._tokens + self.ratio * units)

    def take(self) -> bool:
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False

    def refund(self) -> None:
        with self._lock:
            self._tokens = min(self.burst, self._tokens + 1.0)

    def tokens(self) -> float:
        with self._lock:
            return self._tokens


# -- placement ---------------------------------------------------------------

def rendezvous_order(key: str, replicas: List[str]) -> List[str]:
    """Deterministic highest-random-weight order of ``replicas`` for
    ``key`` (stable across processes — hashlib, not hash())."""
    def score(name: str) -> Tuple[int, str]:
        h = hashlib.blake2b(f"{key}|{name}".encode(), digest_size=8)
        return (int.from_bytes(h.digest(), "big"), name)

    return sorted(replicas, key=score, reverse=True)


# -- router ------------------------------------------------------------------

class _RoutedRequest:
    __slots__ = ("data", "deadline", "version", "future", "attempt",
                 "last_replica", "tried", "seq", "probe", "trace",
                 "t_submit", "t_attempt", "priority", "tenant",
                 "resolved", "hedge_scheduled", "inflight")

    def __init__(self, data, deadline: Optional[float],
                 version: Optional[str], seq: int, trace=None,
                 priority: str = "normal", tenant: Optional[str] = None):
        self.data = data
        self.deadline = deadline        # absolute time.monotonic()
        self.version = version          # model id: placement AND scoring
        self.future: Future = Future()
        self.attempt = 0                # dispatch attempts so far
        self.last_replica: Optional[str] = None
        self.tried: set = set()
        self.seq = seq
        self.probe = False              # this attempt holds a probe slot
        self.trace = trace              # telemetry trace id (None: off)
        self.t_submit = 0.0             # span starts (traced requests)
        self.t_attempt = 0.0
        self.priority = priority        # admission class (shed-first: low)
        self.tenant = tenant            # admission/fairness tenant id
        # set AFTER the winning resolution books its ledger entry (a
        # bare future.done() check would race a caller-side cancel()
        # that has not booked note_cancelled yet — see _resolve_*)
        self.resolved = False
        self.hedge_scheduled = False    # at most ONE hedge per request
        self.inflight: list = []        # [(future, handle)] for cancel


class FleetRouter:
    """Routes requests across a ServingFleet's replicas. Constructed by
    the fleet; not used standalone. ``policy`` supplies the attempt
    budget and the SHARED deterministic backoff math."""

    def __init__(self, fleet, policy: RetryPolicy,
                 placement_width: int = 0,
                 hedge: Optional[HedgeConfig] = None,
                 eject: Optional[EjectConfig] = None,
                 retry_budget: Optional[RetryBudgetConfig] = None):
        self.fleet = fleet
        self.policy = policy
        self.placement_width = int(placement_width)
        self.stats = fleet.stats
        self.hedge = hedge if hedge is not None else HedgeConfig.from_env()
        self.eject = eject if eject is not None else EjectConfig.from_env()
        self.retry_budget = (retry_budget if retry_budget is not None
                             else RetryBudgetConfig.from_env())
        # fleet-level retry + hedge budgets, plus lazy per-replica
        # buckets: BOTH levels must grant for a retry/hedge to dispatch
        # (fleet caps total amplification, replica caps a single bad
        # replica's ladder from soaking the whole fleet budget)
        self._retry_bucket = _TokenBucket(self.retry_budget.ratio,
                                          self.retry_budget.burst)
        self._hedge_bucket = _TokenBucket(self.retry_budget.hedge_ratio,
                                          self.retry_budget.hedge_burst)
        self._replica_buckets: Dict[str, _TokenBucket] = {}
        # per-replica latency EWMA + in-flight dispatch ages (the
        # hung-replica detector's evidence) and a fleet-wide ring of
        # recent completion latencies (the hedge delay's p-quantile)
        self._lat_lock = threading.Lock()
        self._lat: Dict[str, Dict[str, Any]] = {}
        self._lat_ring: deque = deque(maxlen=2048)
        self._rr_lock = threading.Lock()
        self._rr: Dict[str, int] = {}       # per-version round-robin
        #: submission sequence — itertools.count is a single C-level
        #: atomic step under the GIL, so the submit hot path no longer
        #: takes _rr_lock at all (first value 1, as before)
        self._seq = itertools.count(1)
        # timer thread state: deterministic backoff sleeps happen HERE,
        # not on the replica dispatcher thread that resolved the future
        self._timer_cond = threading.Condition()
        self._delayed: list = []    # heap of (due, seq, kind, req);
        #                             kind: "redispatch" | "hedge"
        self._timer_thread: Optional[threading.Thread] = None
        #: due re-dispatches are HANDED OFF here, not run on the timer
        #: thread: a _dispatch pays the engine's backend.prepare host
        #: work up front, and dozens of failovers after a replica crash
        #: must not head-of-line block each other on one thread during
        #: exactly the window whose p99 the bench and rollouts judge
        self._redispatch_pool: Optional[ThreadPoolExecutor] = None
        self._running = False

    # -- lifecycle (driven by the fleet) ----------------------------------
    def start(self) -> None:
        with self._timer_cond:
            if self._running:
                return
            self._running = True
            self._redispatch_pool = ThreadPoolExecutor(
                max_workers=4, thread_name_prefix="tm-fleet-redispatch")
            self._timer_thread = threading.Thread(
                target=self._timer_loop, daemon=True,
                name="tm-fleet-timer")
            self._timer_thread.start()

    def drain(self, timeout: float = 30.0) -> None:
        """Flush the failover path before engines close: fire every
        delayed re-dispatch immediately (no backoff sleeps — the
        engines are about to stop) and wait until every routed future
        has resolved. Without this, fleet.stop(drain=True) would close
        the engines while a request sits in the backoff heap and the
        only outcome left for it is EngineStopped — an accepted request
        three healthy replicas could have served, erroring on a DRAIN
        shutdown."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._timer_cond:
                # pending hedges are SPECULATION, not owed work — the
                # primary dispatch resolves the request; drop them
                batch = [req for _, _, kind, req in self._delayed
                         if kind == "redispatch"]
                self._delayed.clear()
            for req in batch:
                self._dispatch(req)
            d = self.stats.as_dict()
            if not batch and d["routed"] == (d["completed"] + d["failed"]
                                             + d["cancelled"]):
                return      # nothing delayed, nothing in flight
            time.sleep(0.005)

    def stop(self) -> None:
        """Fail every pending delayed re-dispatch with EngineStopped —
        a fleet shutdown leaves NO router future unresolved."""
        with self._timer_cond:
            self._running = False
            # hedge entries are dropped, not failed: their request's
            # primary dispatch still owns the terminal outcome
            pending = [req for _, _, kind, req in self._delayed
                       if kind == "redispatch"]
            self._delayed.clear()
            # captured inside the hold: start() publishes the pool
            # under _timer_cond, so an unguarded read here could see
            # None while a racing start() already spawned the timer
            pool = self._redispatch_pool
            self._timer_cond.notify_all()
        t = self._timer_thread
        if t is not None:
            t.join(5.0)
        if pool is not None:
            # in-flight handed-off dispatches resolve via the
            # fleet-stopping classification path before this returns
            pool.shutdown(wait=True)
        for req in pending:
            self._resolve_error(req, EngineStopped(
                "fleet stopped before re-dispatch"))

    # -- public entry ------------------------------------------------------
    def submit(self, data, deadline_ms: Optional[float] = None,
               version: Optional[str] = None,
               priority: str = "normal",
               tenant: Optional[str] = None) -> Future:
        """``version`` is the MODEL id: it keys placement (rendezvous
        home set + failover ladder, unchanged) AND selects which
        registered version the replica's engine scores — an unknown id
        fails the request loudly (registry.ModelNotFound, terminal:
        equally unknown on every replica). None follows each replica's
        registry default. ``tenant`` rides into the engine's
        weighted-fair admission."""
        deadline = (time.monotonic() + deadline_ms / 1e3
                    if deadline_ms is not None else None)
        # fleet admission is where a request's trace is minted; the
        # decision rides req.trace into every engine dispatch so the
        # engine never re-samples it (sampled-out: one branch)
        trace = (_spans.TRACER.sample_trace()
                 if _spans.TRACER.enabled else None)
        seq = next(self._seq)
        req = _RoutedRequest(data, deadline, version, seq, trace,
                             priority=priority, tenant=tenant)
        if trace is not None:
            _spans.set_trace(req.future, trace)
            req.t_submit = time.monotonic()
        self.stats.note_routed()
        # budgets earn tokens per unit of OFFERED load — this coupling
        # is what bounds dispatched/offered amplification under overload
        self._retry_bucket.deposit()
        self._hedge_bucket.deposit()
        self._dispatch(req)
        return req.future

    def score(self, data, timeout: Optional[float] = None,
              deadline_ms: Optional[float] = None,
              version: Optional[str] = None,
              tenant: Optional[str] = None):
        return self.submit(data, deadline_ms=deadline_ms,
                           version=version, tenant=tenant).result(timeout)

    # -- placement ---------------------------------------------------------
    def candidates(self, version: Optional[str],
                   tried: Optional[set] = None) -> List:
        """Replica handles in dispatch-preference order for a version:
        rotate the home set (round-robin load spread), then the rest of
        the rendezvous ladder; already-tried replicas sort last so a
        re-dispatch lands somewhere NEW whenever anywhere new exists.

        The handle list is re-read HERE, per dispatch attempt, so the
        placement ring tracks elastic growth/shrink mid-flight: a
        request parked in the failover backoff heap re-resolves against
        the UPDATED ring when its re-dispatch fires — a replica added
        since it parked is a candidate, and a DRAINING replica (elastic
        scale-down in progress: stopped accepting, still completing its
        queue) is excluded instead of burning the request's remaining
        attempts on EngineClosed bounces until the caller sees an
        error no healthy replica deserved."""
        handles = [h for h in self.fleet.replica_handles()
                   if not h.draining
                   and not getattr(h, "degraded", False)]
        names = [h.name for h in handles]
        by_name = {h.name: h for h in handles}
        key = version or "__default__"
        order = rendezvous_order(key, names)
        width = self.placement_width or len(order)
        home, ladder = order[:width], order[width:]
        with self._rr_lock:
            rot = self._rr.get(key, 0)
            self._rr[key] = rot + 1
        rot %= max(1, len(home))
        ordered = home[rot:] + home[:rot] + ladder
        if tried:
            ordered = ([n for n in ordered if n not in tried]
                       + [n for n in ordered if n in tried])
        return [by_name[n] for n in ordered]

    def _pick(self, req: _RoutedRequest):
        """First candidate that is alive and whose breaker admits
        traffic (allow() reserves half-open probe slots, so it is only
        consulted for replicas actually tried, in order). Marks the
        request when it holds a probe slot — only the probe's outcome
        may settle a half-open breaker."""
        for h in self.candidates(req.version, req.tried):
            if h.dead or not h.transport.live():
                continue
            admit = h.breaker.allow()
            if admit:
                req.probe = admit == "probe"
                return h
        return None

    # -- per-replica latency / in-flight tracking (ejection evidence) ------
    def _lat_entry(self, name: str) -> Dict[str, Any]:
        entry = self._lat.get(name)
        if entry is None:
            entry = {"ewma": 0.0, "n": 0, "inflight": {}, "losers": 0}
            self._lat[name] = entry
        return entry

    def _note_dispatch_start(self, name: str) -> object:
        token = object()
        with self._lat_lock:
            self._lat_entry(name)["inflight"][token] = time.monotonic()
        return token

    def _note_dispatch_end(self, name: str, token: object,
                           ok: bool) -> None:
        now = time.monotonic()
        with self._lat_lock:
            entry = self._lat_entry(name)
            t0 = entry["inflight"].pop(token, None)
            if t0 is None or not ok:
                # failures do not feed the EWMA: a replica failing FAST
                # must not lower its own hang threshold, and a replica
                # failing slow is charged by the breaker already
                return
            elapsed = now - t0
            # a direct success clears hedge-loss suspicion: the replica
            # answered on its own, so it is slow at worst, not hung
            entry["losers"] = 0
            alpha = self.eject.ewma_alpha
            if entry["n"] == 0:
                entry["ewma"] = elapsed
            else:
                entry["ewma"] += alpha * (elapsed - entry["ewma"])
            entry["n"] += 1
            self._lat_ring.append(elapsed)

    def oldest_inflight_age(self, name: str) -> Optional[float]:
        """Seconds the replica's OLDEST in-flight dispatch has been
        outstanding (None: nothing in flight). The ejection sweep's
        primary evidence: a hung replica accumulates age here while its
        heartbeat — a different code path — stays fresh."""
        with self._lat_lock:
            entry = self._lat.get(name)
            if not entry or not entry["inflight"]:
                return None
            return time.monotonic() - min(entry["inflight"].values())

    def replica_latency(self, name: str) -> Tuple[float, int]:
        """(success-latency EWMA seconds, sample count) for a replica."""
        with self._lat_lock:
            entry = self._lat.get(name)
            if not entry:
                return 0.0, 0
            return entry["ewma"], entry["n"]

    def hedge_loss_streak(self, name: str) -> int:
        """Consecutive dispatches to the replica that a hedge beat (the
        winner cancelled them before they answered). The ejection
        sweep's SECONDARY evidence: hedging rescues each request fast
        enough that the stuck primary never accumulates in-flight age,
        so the streak of lost races is what a hung-but-hedged replica
        leaves behind. Any direct success resets it."""
        with self._lat_lock:
            entry = self._lat.get(name)
            return int(entry["losers"]) if entry else 0

    def reset_suspicion(self, name: str) -> None:
        """Clear the replica's hedge-loss streak (readmission after a
        probe-ok or a restart: fresh process, fresh evidence)."""
        with self._lat_lock:
            entry = self._lat.get(name)
            if entry:
                entry["losers"] = 0

    def hedge_delay_s(self) -> Optional[float]:
        """The p-quantile of recent fleet completion latencies, clamped
        to the configured band — None until ``min_samples`` exist."""
        with self._lat_lock:
            snap = list(self._lat_ring)
        if len(snap) < self.hedge.min_samples:
            return None
        snap.sort()
        idx = min(len(snap) - 1,
                  max(0, int(self.hedge.quantile * len(snap)) - 1))
        return min(self.hedge.max_delay_s,
                   max(self.hedge.min_delay_s, snap[idx]))

    def _replica_bucket(self, name: str) -> _TokenBucket:
        with self._lat_lock:
            bucket = self._replica_buckets.get(name)
            if bucket is None:
                bucket = _TokenBucket(self.retry_budget.ratio,
                                      self.retry_budget.replica_burst)
                self._replica_buckets[name] = bucket
            return bucket

    def _take_retry_budget(self, name: str) -> bool:
        """Both the fleet retry bucket AND the per-replica bucket must
        grant; the fleet token is refunded when the replica denies.
        ``name`` is the replica whose failure triggered the retry — its
        bucket is charged so one bad replica's failover ladder cannot
        soak the whole fleet's budget."""
        if not self.retry_budget.enabled:
            return True
        if not self._retry_bucket.take():
            return False
        if self._replica_bucket(name).take():
            return True
        self._retry_bucket.refund()
        return False

    # -- dispatch / failover ----------------------------------------------
    # opaudit: hotpath
    def _dispatch(self, req: _RoutedRequest) -> None:
        # one attempt consumed per entry, whatever the failure surface
        # (route fault, empty candidate set, submit error, batch error)
        # — every failure path below is bounded by policy.attempts
        req.attempt += 1
        req.probe = False       # set per-attempt by _pick
        if req.trace is not None:
            req.t_attempt = time.monotonic()
        if req.deadline is not None:
            remaining = req.deadline - time.monotonic()
            if remaining <= 0:
                self._resolve_error(req, DeadlineExpired(
                    f"deadline expired before dispatch attempt "
                    f"{req.attempt}"))
                return
            floor = self.retry_budget.min_deadline_ms
            if self.retry_budget.enabled and floor > 0 \
                    and remaining * 1e3 < floor:
                # shed at the ROUTER: a request that cannot finish
                # within its remaining budget must not be dispatched to
                # die on a replica, consuming real work on the way
                self.stats.note_deadline_shed()
                _flight.record("router", "deadline_shed",
                               severity="warning", trace=req.trace,
                               attempt=req.attempt,
                               remaining_ms=remaining * 1e3,
                               floor_ms=floor)
                self._resolve_error(req, DeadlineUnmeetable(
                    f"remaining deadline {remaining * 1e3:.1f}ms below "
                    f"router floor {floor:.1f}ms"))
                return
        try:
            fault_point("serving.router.route", version=req.version,
                        attempt=req.attempt)
        except BaseException as e:      # noqa: BLE001 — drill surface
            self._after_failure(req, None, e)
            return
        h = self._pick(req)
        if h is None:
            self.stats.note_no_replica()
            _flight.record("router", "no_replica_available",
                           severity="error", trace=req.trace,
                           attempt=req.attempt, version=req.version)
            self._after_failure(req, None, NoReplicaAvailable(
                "no live replica with a closed (or probing) breaker"))
            return
        req.tried.add(h.name)
        try:
            fault_point("serving.replica.crash", replica=h.name)
        except FaultError as e:
            # the drill kind: hard-kill the SELECTED replica mid-load,
            # then fail over this request like any crash would
            self.fleet.chaos_kill(h.name, reason=str(e))
            self._after_failure(req, h, EngineStopped(
                f"replica {h.name} crashed by fault injection: {e}"))
            return
        deadline_ms = None
        if req.deadline is not None:
            deadline_ms = max((req.deadline - time.monotonic()) * 1e3, 0.0)
        self.stats.note_dispatch(h.name)
        if self.retry_budget.enabled:
            # per-replica budgets earn per dispatch TO that replica —
            # the replica-local notion of offered load
            self._replica_bucket(h.name).deposit()
        try:
            fut = h.transport.submit(req.data, deadline_ms=deadline_ms,
                                     trace=req.trace,
                                     priority=req.priority,
                                     model=req.version,
                                     tenant=req.tenant)
        except BaseException as e:      # noqa: BLE001 — classified below
            self._after_failure(req, h, e)
            return
        token = self._note_dispatch_start(h.name)
        req.inflight.append((fut, h))
        fut.add_done_callback(
            lambda f, req=req, h=h, token=token:
            self._on_engine_done(req, h, f, token))
        self._maybe_schedule_hedge(req)

    # opaudit: hotpath
    def _on_engine_done(self, req: _RoutedRequest, h, fut: Future,
                        token=None) -> None:
        if fut.cancelled():
            # this dispatch lost a hedge race and was cancelled by the
            # winner: fut.exception() would RAISE CancelledError here
            # and kill the callback thread — nothing to book, the
            # winner already resolved the request
            if token is not None:
                self._note_dispatch_end(h.name, token, ok=False)
            return
        exc = fut.exception()
        if token is not None:
            self._note_dispatch_end(h.name, token, ok=exc is None)
        if exc is None:
            if req.trace is not None:
                _spans.TRACER.record(
                    req.trace, "router.dispatch", req.t_attempt,
                    time.monotonic(), replica=h.name,
                    attempt=req.attempt, outcome="ok")
            h.breaker.record_success(probe=req.probe)
            if self._resolve_result(req, fut.result()):
                self._cancel_losers(req, fut)
            return
        self._after_failure(req, h, exc)

    # -- hedged requests ---------------------------------------------------
    def _maybe_schedule_hedge(self, req: _RoutedRequest) -> None:
        """Arm ONE speculative re-dispatch for a first-attempt request,
        due after the fleet's p-quantile latency: if the primary
        replica answers normally the hedge entry fires into a resolved
        request and no-ops; if the primary is slow (gray link, hung
        replica), the hedge dispatches the SAME idempotent score to a
        second replica and the first result wins."""
        if (not self.hedge.enabled or req.hedge_scheduled
                or req.attempt != 1):
            return
        delay = self.hedge_delay_s()
        if delay is None:
            return                      # not enough latency evidence yet
        if req.deadline is not None \
                and req.deadline - time.monotonic() <= delay:
            return                      # would fire after the deadline
        req.hedge_scheduled = True
        self._schedule(req, time.monotonic() + delay, kind="hedge")

    def _fire_hedge(self, req: _RoutedRequest) -> None:
        if req.resolved or req.future.done():
            return                      # primary already answered
        if not self._hedge_bucket.take():
            self.stats.note_retry_budget_exhausted()
            _flight.record("router", "hedge_budget_exhausted",
                           severity="warning", trace=req.trace,
                           seq=req.seq)
            return
        h = None
        for cand in self.candidates(req.version, req.tried):
            if cand.name in req.tried or cand.dead \
                    or not cand.transport.live():
                continue
            # hedges take CLOSED-breaker replicas only — a speculative
            # request must never burn the single half-open probe slot
            if cand.breaker.allow() is True:
                h = cand
                break
        if h is None:
            self._hedge_bucket.refund()
            return
        if self.retry_budget.enabled \
                and not self._replica_bucket(h.name).take():
            self._hedge_bucket.refund()
            self.stats.note_retry_budget_exhausted()
            return
        req.tried.add(h.name)
        deadline_ms = None
        if req.deadline is not None:
            deadline_ms = max(
                (req.deadline - time.monotonic()) * 1e3, 0.0)
        self.stats.note_hedge()
        self.stats.note_dispatch(h.name)
        _flight.record("router", "hedge", trace=req.trace,
                       replica=h.name, seq=req.seq)
        try:
            fut = h.transport.submit(req.data, deadline_ms=deadline_ms,
                                     trace=req.trace,
                                     priority=req.priority,
                                     model=req.version,
                                     tenant=req.tenant)
        except BaseException:   # noqa: BLE001 — speculation only: the
            return              # primary attempt chain owns the outcome
        token = self._note_dispatch_start(h.name)
        req.inflight.append((fut, h))
        fut.add_done_callback(
            lambda f, req=req, h=h, token=token:
            self._on_hedge_done(req, h, f, token))

    def _on_hedge_done(self, req: _RoutedRequest, h, fut: Future,
                       token) -> None:
        if fut.cancelled():
            self._note_dispatch_end(h.name, token, ok=False)
            return
        exc = fut.exception()
        self._note_dispatch_end(h.name, token, ok=exc is None)
        if exc is None:
            h.breaker.record_success()
            if self._resolve_result(req, fut.result()):
                self.stats.note_hedge_win()
                _flight.record("router", "hedge_win", trace=req.trace,
                               replica=h.name, seq=req.seq)
                self._cancel_losers(req, fut)
            return
        # a failed hedge NEVER re-dispatches — the primary attempt
        # chain owns retries; hedge failures only feed the breaker
        kind = self._classify(exc)
        if kind in ("retryable", "terminal-timeout"):
            h.breaker.record_failure()

    def _cancel_losers(self, req: _RoutedRequest,
                       winner: Future) -> None:
        """First result won: abandon the losing in-flight dispatches
        (socket binding drops the pending correlation entry, so the
        loser's late RESULT frame is ignored, not mis-delivered)."""
        for fut, h in req.inflight:
            if fut is winner or fut.done():
                continue
            # losing a hedge race is hung evidence: the cancel below
            # wipes the stuck dispatch's in-flight age, so the streak
            # counter carries what the age-based detector can no
            # longer see (see EjectConfig.loser_streak)
            with self._lat_lock:
                self._lat_entry(h.name)["losers"] += 1
            try:
                h.transport.cancel_request(fut)
            except Exception:   # noqa: BLE001 — best-effort abandon
                pass

    def _classify(self, exc: BaseException) -> str:
        """overload → immediate failover, no breaker penalty;
        retryable → failover with breaker penalty + seeded backoff;
        terminal → resolve the router future with the error, NO breaker
        penalty (a request-content bug fails the same on every replica;
        only a consumed deadline — terminal-timeout — counts toward the
        breaker's timeout ratio)."""
        if isinstance(exc, DeadlineExpired):
            return "terminal-timeout"   # budget consumed — count, stop
        if isinstance(exc, (QueueFull, DeadlineUnmeetable)):
            return "overload"
        if isinstance(exc, NoReplicaAvailable):
            return "retryable"
        if is_retryable(exc, extra=(EngineClosed,)):
            return "retryable"
        return "terminal"

    def _after_failure(self, req: _RoutedRequest, h,
                       exc: BaseException) -> None:
        if req.resolved:
            # a hedge already won this request; the losing primary's
            # late failure books nothing and must not re-dispatch
            return
        kind = self._classify(exc)
        if req.trace is not None:
            _spans.TRACER.record(
                req.trace, "router.dispatch", req.t_attempt,
                time.monotonic(),
                replica=h.name if h is not None else None,
                attempt=req.attempt, outcome=type(exc).__name__,
                classified=kind)
        if h is not None and kind in ("retryable", "terminal-timeout"):
            # a shed deadline counts toward the breaker's timeout
            # ratio; backpressure (overload) does not — an overloaded
            # replica is healthy, just full — and neither does a
            # request-CONTENT bug (terminal): it would fail identically
            # on every replica, and charging it would let a burst of
            # malformed client requests open every breaker and turn bad
            # input into a fleet-wide NoReplicaAvailable outage
            h.breaker.record_failure(probe=req.probe)
        elif h is not None and req.probe \
                and kind in ("overload", "terminal"):
            # this dispatch held the half-open probe slot — free it:
            # neither outcome says anything about replica health (and
            # a non-holder must never release another probe's slot)
            h.breaker.release_probe()
        if kind in ("retryable", "overload") \
                and not self.fleet.accepting():
            # fleet shutting down: every routed future resolves with
            # the DISTINCT EngineStopped, whatever replica-local error
            # the last attempt happened to surface — callers (and
            # outer routing layers) get one classifiable signal
            self._resolve_error(req, EngineStopped(
                "fleet stopped before re-dispatch"))
            return
        if kind in ("terminal", "terminal-timeout") \
                or req.attempt >= self.policy.attempts:
            self._resolve_error(req, exc)
            return
        if h is not None and not self._take_retry_budget(h.name):
            # the retry budget is the overload backstop: when failures
            # outpace the token earn rate (ratio x offered load), the
            # retry that would have amplified load is DENIED and the
            # request fails with the replica's own error — bounded
            # amplification beats a retry storm turning a brownout
            # into an outage
            self.stats.note_retry_budget_exhausted()
            _flight.record("router", "retry_budget_exhausted",
                           severity="warning", trace=req.trace,
                           replica=h.name, attempt=req.attempt,
                           classified=kind, error=type(exc).__name__)
            self._resolve_error(req, exc)
            return
        if h is not None:
            req.last_replica = h.name
            self.stats.note_failover()
            # the flight-recorder arrow a chaos drill reconstructs:
            # which replica failed WHICH traced request, and how the
            # error was classified — joined to the request's spans by
            # the shared trace id
            _flight.record("router", "failover", severity="warning",
                           trace=req.trace, replica=h.name,
                           attempt=req.attempt, classified=kind,
                           error=type(exc).__name__)
        else:
            self.stats.note_retry()
        if kind == "overload":
            self._dispatch(req)         # immediate: load signal, not fault
            return
        sleep = self.policy.sleep_for(f"fleet.route#{req.seq}", req.attempt)
        if req.deadline is not None:
            remaining = req.deadline - time.monotonic()
            if remaining <= 0:
                self._resolve_error(req, DeadlineExpired(
                    "deadline expired during failover backoff"))
                return
            # never sleep the whole remaining budget away: leave room
            # for the re-dispatched attempt itself
            sleep = min(sleep, remaining / 2.0)
        self._schedule(req, time.monotonic() + sleep)

    # -- timer thread ------------------------------------------------------
    def _schedule(self, req: _RoutedRequest, due: float,
                  kind: str = "redispatch") -> None:
        with self._timer_cond:
            if self._running:
                # seq orders heap ties; kind sorts after seq so two
                # entries for the SAME request (backoff + hedge) still
                # compare without ever reaching the unorderable req
                heapq.heappush(self._delayed, (due, req.seq, kind, req))
                self._timer_cond.notify_all()
                return
        if kind == "redispatch":
            self._resolve_error(req, EngineStopped(
                "fleet stopped before re-dispatch"))

    def _timer_loop(self) -> None:
        while True:
            with self._timer_cond:
                while self._running and \
                        (not self._delayed
                         or self._delayed[0][0] > time.monotonic()):
                    if not self._delayed:
                        self._timer_cond.wait()
                    else:
                        self._timer_cond.wait(
                            max(0.0, self._delayed[0][0]
                                - time.monotonic()))
                if not self._running:
                    return
                _, _, kind, req = heapq.heappop(self._delayed)
                pool = self._redispatch_pool
            fire = (self._fire_hedge if kind == "hedge"
                    else self._dispatch)
            try:
                pool.submit(fire, req)
            except RuntimeError:        # pool shut down under us
                if kind == "redispatch":
                    self._resolve_error(req, EngineStopped(
                        "fleet stopped before re-dispatch"))

    # -- resolution (exactly one terminal outcome per request) -------------
    # Both guarded against caller-side Future.cancel(): losing the
    # cancel race must not raise InvalidStateError on a dispatcher or
    # timer thread (which would kill it and strand every queued
    # re-dispatch) — the same hazard engine._fail_future guards.
    def _resolve_result(self, req: _RoutedRequest, result) -> bool:
        """True when THIS call booked the completed outcome — the
        hedging callbacks key loser-cancellation and hedge-win stats on
        winning this claim, never on a racy done() pre-check."""
        if req.resolved:
            return False        # a racing resolution already booked
        if req.trace is not None:
            _spans.TRACER.record(req.trace, "router.request",
                                 req.t_submit, time.monotonic(),
                                 attempts=req.attempt, outcome="ok")
        won = False
        try:
            if req.future.set_running_or_notify_cancel():
                req.future.set_result(result)
                self.stats.note_completed()
                won = True
            else:
                # caller cancelled: still a terminal outcome — count it,
                # or drain()'s routed == completed+failed+cancelled
                # ledger never balances and every drain shutdown spins
                # to its timeout
                self.stats.note_cancelled()
        except Exception:       # noqa: BLE001 — lost a resolution race
            pass
        # set AFTER booking: resolved means "the ledger entry exists",
        # which is what the done-guards in _after_failure rely on
        req.resolved = True
        return won

    def _resolve_error(self, req: _RoutedRequest,
                       exc: BaseException) -> None:
        if req.resolved:
            return              # a racing resolution already booked
        if req.trace is not None:
            _spans.TRACER.record(req.trace, "router.request",
                                 req.t_submit, time.monotonic(),
                                 attempts=req.attempt,
                                 outcome=type(exc).__name__)
        try:
            # same atomic claim as _resolve_result: a cancelled()/done()
            # pre-check would race a caller-side cancel() landing between
            # check and set_exception — the swallowed InvalidStateError
            # would then book NEITHER failed nor cancelled, unbalancing
            # the drain ledger forever
            if req.future.set_running_or_notify_cancel():
                req.future.set_exception(exc)
                self.stats.note_failed()
            else:
                self.stats.note_cancelled()
        except Exception:       # noqa: BLE001 — lost a resolution race
            pass
        req.resolved = True

    def breakers_dict(self) -> Dict[str, Dict[str, Any]]:
        return {h.name: h.breaker.as_dict()
                for h in self.fleet.replica_handles()}
