"""Admission control for the in-process serving engine.

Production TPU serving dies by queue, not by kernel: when offered load
exceeds device throughput, an unbounded queue converts overload into
unbounded latency for EVERYONE. The controls here keep the engine's
latency distribution honest under pressure, and every degraded-mode
decision lands in a counter (profiling.EngineStats) — never a silent
drop:

* **Bounded queue** — submissions beyond `max_queue_rows` /
  `max_queue_requests` are rejected at the door with `QueueFull`
  (backpressure the caller can see and retry against), instead of
  growing the queue until every request misses its deadline.
* **Deadline admission** — a request carrying a deadline the EMA
  latency model says cannot be met is rejected immediately
  (`DeadlineUnmeetable`) rather than queued, scored, and thrown away.
* **Pre-dispatch shedding** — requests whose deadline expires while
  queued are shed BEFORE device dispatch (their future gets
  `DeadlineExpired`); the device never burns cycles on an answer
  nobody is waiting for.
* **Per-tenant budgets** — ``tenant_queue_share`` caps how much of the
  bounded queue any ONE tenant may hold (`TenantBudgetExceeded`, a
  QueueFull subclass): the admission half of the engine's multi-tenant
  fairness story, in front of the weighted-fair (deficit round-robin)
  drain order the dispatcher applies to whatever was admitted.
* **Adaptive re-pricing** — the EMA rejection threshold can be
  RE-PRICED from live wait percentiles (``set_price``): when observed
  queue waits climb toward the autoscaler's pressure threshold, the
  price multiplies the EMA completion estimate, so deadline admission
  starts shedding BEFORE the queue saturates instead of after every
  caller is already late. Low-priority traffic (``priority="low"`` —
  explanations, best-effort rescoring) pays an extra factor on top, so
  under pressure it sheds FIRST and scores keep flowing.
"""
from __future__ import annotations

import time
from typing import List, Optional, Tuple

# hot-path module binding (the shape_bucket idiom): admit() and
# split_expired() run once per request / per drain pass — one global
# load beats two attribute walks per call
_monotonic = time.monotonic

#: admission priority classes. "low" = shed-first traffic (explain /
#: best-effort requests): under a re-priced controller it pays
#: ``low_priority_factor`` on top of the price, so it trips
#: DeadlineUnmeetable while same-deadline "normal" traffic still admits.
PRIORITIES = ("normal", "low")


class RejectedError(RuntimeError):
    """Base: the engine refused to accept a request (backpressure)."""


class QueueFull(RejectedError):
    """The bounded request queue is at capacity — retry with backoff."""


class TenantBudgetExceeded(QueueFull):
    """ONE tenant's share of the bounded queue is at capacity while the
    queue as a whole still has room — per-tenant backpressure
    (``tenant_queue_share``): a hot tenant flooding submissions is
    rejected at ITS budget instead of filling the shared queue and
    starving every other tenant's admission. A QueueFull subclass, so
    routers classify it the same way (overload: immediate failover, no
    breaker penalty)."""


class DeadlineUnmeetable(RejectedError):
    """The EMA latency estimate says this request's deadline cannot be
    met given the current queue — rejected before queuing."""


class DeadlineExpired(TimeoutError):
    """The request's deadline passed while it waited in the queue; it
    was shed before device dispatch (recorded in shed_expired)."""


class EngineClosed(RuntimeError):
    """submit() after the engine stopped accepting work."""


class EngineStopped(EngineClosed):
    """A request ACCEPTED into the queue was failed by a non-drain
    engine (or fleet) shutdown before it could dispatch. Distinct from
    the bare EngineClosed a late submit() gets: the request was valid
    and the engine vanished under it, so a fleet router classifies it
    RETRYABLE and re-dispatches to another replica — the engine's
    zero-silent-loss contract composes into the fleet's
    zero-accepted-loss contract."""

    #: resilience.policy classification hook: re-dispatch elsewhere
    retryable = True


class EmaLatency:
    """Exponential moving average of micro-batch service latency.

    Models a batch as `fixed + rows * per_row` seconds, tracked as two
    EMAs (batch seconds and per-row seconds). `estimate(rows)` is
    deliberately a slight OVER-estimate (the fixed term still contains
    some row time): admission errs toward rejecting a request that
    would probably miss its deadline, because a late answer costs the
    caller more than an immediate honest rejection."""

    def __init__(self, alpha: float = 0.25):
        if not (0.0 < alpha <= 1.0):
            raise ValueError("alpha must be in (0, 1]")
        self.alpha = alpha
        self._batch_s: Optional[float] = None
        self._row_s: Optional[float] = None

    def update(self, rows: int, seconds: float) -> None:
        row_s = seconds / max(rows, 1)
        if self._batch_s is None:
            self._batch_s, self._row_s = seconds, row_s
            return
        a = self.alpha
        self._batch_s = (1 - a) * self._batch_s + a * seconds
        self._row_s = (1 - a) * self._row_s + a * row_s

    def estimate(self, rows: int) -> Optional[float]:
        """Estimated seconds to serve `rows` queued-plus-new rows, or
        None before the first observation (optimistic cold start: the
        first requests must be allowed through to seed the EMA)."""
        if self._batch_s is None:
            return None
        return self._batch_s + rows * (self._row_s or 0.0)

    def as_dict(self):
        return {"batch_seconds_ema": self._batch_s,
                "row_seconds_ema": self._row_s}


class AdmissionController:
    """Admission decisions for ServingEngine.submit().

    Stateless beyond the EMA — queue depth is passed in by the engine
    (which owns the queue lock), so this class never takes a lock of
    its own and admit() is safe to call from any submitting thread."""

    def __init__(self, max_queue_rows: int = 65536,
                 max_queue_requests: int = 4096,
                 ema_alpha: float = 0.25,
                 low_priority_factor: float = 4.0,
                 tenant_queue_share: float = 1.0):
        if max_queue_rows < 1 or max_queue_requests < 1:
            raise ValueError("queue bounds must be >= 1")
        if low_priority_factor < 1.0:
            raise ValueError("low_priority_factor must be >= 1.0")
        if not (0.0 < tenant_queue_share <= 1.0):
            raise ValueError("tenant_queue_share must be in (0, 1]")
        self.max_queue_rows = int(max_queue_rows)
        self.max_queue_requests = int(max_queue_requests)
        self.low_priority_factor = float(low_priority_factor)
        #: the per-tenant admission budget: one tenant may hold at most
        #: this fraction of the queue bounds. 1.0 (default) is the
        #: historical single-tenant behavior — the per-tenant bound
        #: coincides with the global one and can never trip first.
        self.tenant_queue_share = float(tenant_queue_share)
        self.ema = EmaLatency(ema_alpha)
        #: live re-pricing of the EMA rejection threshold (>= 1.0).
        #: 1.0 = at rest (the historical behavior, priority classes
        #: indistinguishable); the autoscaler raises it from observed
        #: wait percentiles as pressure builds, so deadline admission
        #: rejects EARLIER than the raw EMA alone would — shedding
        #: starts before the queue saturates, and low-priority traffic
        #: (x low_priority_factor on top) sheds first.
        self.price = 1.0

    def set_price(self, price: float) -> float:
        """Re-price the rejection threshold from live latency evidence
        (the autoscaler's tick does this). Values below 1.0 clamp to
        1.0 — admission may err conservative, never optimistic-beyond-
        the-EMA. Returns the applied price. Benign to race: a float
        store is atomic and every admit() reads it once."""
        self.price = max(1.0, float(price))
        return self.price

    def _margin(self, priority: str) -> float:
        """The effective estimate multiplier for one request: the live
        price, times the low-priority surcharge once any pressure
        exists (price > 1). At rest every class admits identically."""
        if priority not in PRIORITIES:
            raise ValueError(
                f"unknown admission priority {priority!r}; one of "
                f"{PRIORITIES}")
        price = self.price
        if priority == "low" and price > 1.0:
            return price * self.low_priority_factor
        return price

    # opaudit: hotpath
    def admit(self, rows: int, deadline: Optional[float],
              queued_rows: int, queued_requests: int,
              now: Optional[float] = None,
              priority: str = "normal",
              tenant_rows: int = 0,
              tenant_requests: int = 0) -> None:
        """Raise QueueFull / TenantBudgetExceeded / DeadlineUnmeetable,
        or return to accept. `deadline` is an absolute time.monotonic()
        timestamp; ``tenant_rows``/``tenant_requests`` are the
        submitting tenant's CURRENT queue occupancy (the engine owns
        those gauges). The global bound is checked first, so at
        ``tenant_queue_share=1.0`` a full queue keeps raising the
        historical QueueFull, never the tenant variant."""
        margin = self._margin(priority)     # validates priority first:
        #                                     even deadline-less requests
        #                                     must reject a typo'd class
        if queued_requests + 1 > self.max_queue_requests or \
                queued_rows + rows > self.max_queue_rows:
            raise QueueFull(
                f"serving queue at capacity ({queued_requests} requests / "
                f"{queued_rows} rows queued; limits "
                f"{self.max_queue_requests} / {self.max_queue_rows})")
        share = self.tenant_queue_share
        if share < 1.0 and (
                tenant_requests + 1 > share * self.max_queue_requests
                or tenant_rows + rows > share * self.max_queue_rows):
            raise TenantBudgetExceeded(
                f"tenant admission budget at capacity "
                f"({tenant_requests} requests / {tenant_rows} rows "
                f"queued by this tenant; share {share:.2f} of "
                f"{self.max_queue_requests} / {self.max_queue_rows})")
        if deadline is not None:
            now = _monotonic() if now is None else now
            if deadline <= now:
                raise DeadlineUnmeetable(
                    "request deadline already expired at submission")
            est = self.ema.estimate(queued_rows + rows)
            if est is not None and now + est * margin > deadline:
                raise DeadlineUnmeetable(
                    f"estimated completion in {est * 1e3:.2f} ms "
                    f"(x{margin:.2f} re-priced margin, priority "
                    f"{priority}) exceeds the "
                    f"{((deadline - now) * 1e3):.2f} ms deadline "
                    f"budget ({queued_rows} rows ahead in queue)")

    # opaudit: hotpath
    @staticmethod
    def split_expired(requests: List, now: Optional[float] = None
                      ) -> Tuple[List, List]:
        """(live, expired) partition of a popped micro-batch — called by
        the dispatcher immediately before device dispatch so a request
        that died waiting never reaches the device."""
        now = _monotonic() if now is None else now
        live, expired = [], []
        for r in requests:
            (expired if (r.deadline is not None and r.deadline <= now)
             else live).append(r)
        return live, expired
