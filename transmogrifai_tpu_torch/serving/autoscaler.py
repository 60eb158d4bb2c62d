"""Telemetry-driven elastic fleet: autoscaling + load-adaptive admission.

The telemetry plane exposes queue depth, wait percentiles, and
shed/reject counters; the fleet can drain, restart, and roll back
replicas. Without a consumer of those signals a fleet is a
static-N deployment that either over-provisions or falls over under a
spike. ``FleetAutoscaler`` closes the loop, supervisor-style (the
``ContinuumController`` tick-thread pattern is the template):

* **Reactive scaling with hysteresis** — each tick samples per-replica
  queue depth and the TICK WINDOW's wait p99 (outcome-counter deltas
  slice exactly the window's samples off each engine's wait ring, the
  staged-rollout bake convention, so the pressure signal is current
  traffic, not blended history). ``up_ticks`` consecutive breaching
  ticks scale up; ``down_ticks`` consecutive calm ticks scale down; the
  band between the up and down thresholds (validated non-empty) holds
  steady — oscillating load cannot flap the fleet.
* **Predictive pre-scaling** — a deterministic Holt double-exponential
  smoother (``ArrivalForecast``; ``ema`` mode pins the trend term to
  zero, ``off`` disables) tracks the arrival rate from router counter
  deltas and projects it ``horizon_s`` ahead. A projection above the
  fleet's capacity (explicit ``replica_rps`` or the peak observed
  per-replica completion rate) triggers scale-up BEFORE the queue
  pressure lands, and blocks a scale-down that the forecast says the
  fleet would immediately regret.
* **Actuation rides the existing drill-hardened paths** — scale-up
  provisions a replica via ``fleet.add_replica`` (registry build + warm
  bucket compiles happen entirely OFF the hot path, before the replica
  joins the router's placement ring), under a ``RetryPolicy`` with the
  ``serving.scaler.provision`` fault point on each attempt; scale-down
  retires the newest replica via ``fleet.remove_replica`` (router stops
  placing traffic, the engine's ``stop(drain=True)`` completes every
  accepted request, THEN the handle leaves — zero accepted-request loss
  by construction). Actions run on their own thread so a slow
  provision/drain never stalls the evaluation loop.
* **Load-adaptive admission** — every tick re-prices each replica's
  ``AdmissionController`` from the live wait p99
  (``price = clamp(wait_p99 / target, 1, price_max)``): as waits climb
  toward the pressure threshold the EMA rejection margin inflates, so
  deadline admission starts shedding BEFORE queues saturate — and
  low-priority traffic (``priority="low"``: explanations, best-effort
  rescoring) sheds first (admission.PRIORITIES).

Every scaling decision books a flight-recorder event (subsystem
``scaler``) and rides the ``tm_fleet_scale_*`` /metricsz families; the
``serving.scaler.tick`` fault point drops ONE evaluation (never the
loop). Knobs ride ``ScalerConfig`` with strict ``TM_SCALE_*`` env
spellings through the shared parser — a typo'd knob fails the deploy,
not the scale-up at 3am.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

from ..profiling import ScalerStats
from ..resilience.faults import fault_point
from ..resilience.policy import RetryPolicy
from ..telemetry import recorder as _flight

__all__ = ["ScalerConfig", "ArrivalForecast", "ScalingPolicy",
           "FleetAutoscaler"]

#: forecast modes (stable enumeration)
FORECAST_MODES = ("holt", "ema", "off")

#: TM_SCALE_* env var -> (ScalerConfig field, parser). The catalog IS
#: the validation: any other TM_SCALE_ name is a typo and raises.
_ENV_FIELDS: Dict[str, tuple] = {
    "TM_SCALE_MIN_REPLICAS": ("min_replicas", int),
    "TM_SCALE_MAX_REPLICAS": ("max_replicas", int),
    "TM_SCALE_TICK_S": ("tick_s", float),
    "TM_SCALE_UP_QUEUE_DEPTH": ("up_queue_depth", float),
    "TM_SCALE_UP_WAIT_P99_MS": ("up_wait_p99_ms", float),
    "TM_SCALE_DOWN_QUEUE_DEPTH": ("down_queue_depth", float),
    "TM_SCALE_DOWN_WAIT_P99_MS": ("down_wait_p99_ms", float),
    "TM_SCALE_UP_TICKS": ("up_ticks", int),
    "TM_SCALE_DOWN_TICKS": ("down_ticks", int),
    "TM_SCALE_COOLDOWN_S": ("cooldown_s", float),
    "TM_SCALE_STEP": ("step", int),
    "TM_SCALE_FORECAST": ("forecast", str),
    "TM_SCALE_FORECAST_ALPHA": ("forecast_alpha", float),
    "TM_SCALE_FORECAST_BETA": ("forecast_beta", float),
    "TM_SCALE_HORIZON_S": ("horizon_s", float),
    "TM_SCALE_HEADROOM": ("headroom", float),
    "TM_SCALE_REPLICA_RPS": ("replica_rps", float),
    "TM_SCALE_PROVISION_ATTEMPTS": ("provision_attempts", int),
    "TM_SCALE_PROVISION_BACKOFF_S": ("provision_backoff_s", float),
    "TM_SCALE_PRICE_MAX": ("price_max", float),
    "TM_SCALE_TARGET_WAIT_MS": ("target_wait_ms", float),
    "TM_SCALE_SEED": ("seed", int),
}


class ScalerConfig:
    """Elastic-fleet knobs. See _ENV_FIELDS for TM_SCALE_* spellings.

    Validation is all here, at config time: a scale-up that discovers a
    bad threshold only when the spike lands protects nothing. The
    load-bearing rule is the HYSTERESIS BAND — the scale-down
    thresholds must sit STRICTLY below the scale-up ones, or a fleet
    serving right at the threshold flaps add/drain forever."""

    def __init__(self, min_replicas: int = 1,
                 max_replicas: int = 4,
                 tick_s: float = 0.25,
                 up_queue_depth: float = 8.0,
                 up_wait_p99_ms: float = 50.0,
                 down_queue_depth: float = 1.0,
                 down_wait_p99_ms: float = 10.0,
                 up_ticks: int = 2,
                 down_ticks: int = 8,
                 cooldown_s: float = 2.0,
                 step: int = 1,
                 forecast: str = "holt",
                 forecast_alpha: float = 0.5,
                 forecast_beta: float = 0.3,
                 horizon_s: float = 1.0,
                 headroom: float = 0.8,
                 replica_rps: float = 0.0,
                 provision_attempts: int = 2,
                 provision_backoff_s: float = 0.1,
                 price_max: float = 8.0,
                 target_wait_ms: float = 0.0,
                 seed: int = 0):
        if min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if max_replicas < min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        if tick_s <= 0:
            # Event.wait(<=0) returns immediately: the scaler thread
            # would busy-spin at 100% CPU for the fleet's life
            raise ValueError("tick_s must be > 0")
        if up_ticks < 1 or down_ticks < 1:
            raise ValueError("up_ticks/down_ticks must be >= 1")
        if up_queue_depth <= 0 or up_wait_p99_ms <= 0:
            raise ValueError("scale-up thresholds must be > 0")
        if not (0.0 <= down_queue_depth < up_queue_depth):
            raise ValueError(
                "down_queue_depth must be in [0, up_queue_depth): equal "
                "thresholds leave no hysteresis band and the fleet "
                "flaps add/drain at the boundary")
        if not (0.0 <= down_wait_p99_ms < up_wait_p99_ms):
            raise ValueError(
                "down_wait_p99_ms must be in [0, up_wait_p99_ms): equal "
                "thresholds leave no hysteresis band and the fleet "
                "flaps add/drain at the boundary")
        if cooldown_s < 0:
            raise ValueError("cooldown_s must be >= 0")
        if step < 1:
            raise ValueError("step must be >= 1")
        if forecast not in FORECAST_MODES:
            raise ValueError(f"unknown forecast mode {forecast!r}; one "
                             f"of {FORECAST_MODES}")
        if not (0.0 < forecast_alpha <= 1.0):
            raise ValueError("forecast_alpha must be in (0, 1]")
        if not (0.0 <= forecast_beta <= 1.0):
            raise ValueError("forecast_beta must be in [0, 1]")
        if horizon_s < 0:
            raise ValueError("horizon_s must be >= 0")
        if not (0.0 < headroom <= 1.0):
            raise ValueError("headroom must be in (0, 1]")
        if provision_attempts < 1:
            raise ValueError("provision_attempts must be >= 1")
        if provision_backoff_s < 0:
            raise ValueError("provision_backoff_s must be >= 0")
        if price_max < 1.0:
            # a max below 1 would turn the re-pricer into an admission
            # DISCOUNT — the exact silently-inverted-knob failure the
            # strict convention forbids
            raise ValueError("price_max must be >= 1.0")
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.tick_s = float(tick_s)
        self.up_queue_depth = float(up_queue_depth)
        self.up_wait_p99_ms = float(up_wait_p99_ms)
        self.down_queue_depth = float(down_queue_depth)
        self.down_wait_p99_ms = float(down_wait_p99_ms)
        self.up_ticks = int(up_ticks)
        self.down_ticks = int(down_ticks)
        self.cooldown_s = float(cooldown_s)
        self.step = int(step)
        self.forecast = str(forecast)
        self.forecast_alpha = float(forecast_alpha)
        self.forecast_beta = float(forecast_beta)
        self.horizon_s = float(horizon_s)
        self.headroom = float(headroom)
        self.replica_rps = float(replica_rps)   # <= 0: learn from traffic
        self.provision_attempts = int(provision_attempts)
        self.provision_backoff_s = float(provision_backoff_s)
        self.price_max = float(price_max)
        self.target_wait_ms = float(target_wait_ms)  # <= 0: up_wait_p99_ms
        self.seed = int(seed)

    @classmethod
    def from_env(cls, environ: Optional[Dict[str, str]] = None,
                 **overrides) -> "ScalerConfig":
        """TM_SCALE_* env vars + explicit overrides (which win), through
        the shared STRICT parser: unknown name or unparsable value
        raises — a typo'd autoscaler knob must fail the deploy, not
        silently run a static fleet."""
        from ..resilience.config import parse_env_fields
        return cls(**parse_env_fields(
            "TM_SCALE_", _ENV_FIELDS, what="scaler env var",
            environ=environ, overrides=overrides))

    def as_dict(self) -> Dict[str, Any]:
        return {f: getattr(self, f) for f, _ in _ENV_FIELDS.values()}


class ArrivalForecast:
    """Deterministic short-horizon arrival-rate forecast.

    Holt double-exponential smoothing (level + trend) over the
    per-tick arrival rate: ``observe(rate)`` once per tick,
    ``predict(h)`` projects ``h`` TICKS ahead (level + h x trend,
    clamped non-negative). ``mode="ema"`` pins the trend term to zero
    (level-only smoothing — the classic EMA); ``mode="off"`` observes
    nothing and predicts None. Pure float arithmetic over the input
    series, no clocks, no randomness: the same series produces
    bit-identical forecasts in any process (pinned)."""

    def __init__(self, mode: str = "holt", alpha: float = 0.5,
                 beta: float = 0.3):
        if mode not in FORECAST_MODES:
            raise ValueError(f"unknown forecast mode {mode!r}; one of "
                             f"{FORECAST_MODES}")
        if not (0.0 < alpha <= 1.0):
            raise ValueError("alpha must be in (0, 1]")
        if not (0.0 <= beta <= 1.0):
            raise ValueError("beta must be in [0, 1]")
        self.mode = mode
        self.alpha = float(alpha)
        self.beta = float(beta) if mode == "holt" else 0.0
        self.level: Optional[float] = None
        self.trend = 0.0
        self.observations = 0

    def observe(self, rate: float) -> None:
        if self.mode == "off":
            return
        rate = max(0.0, float(rate))
        self.observations += 1
        if self.level is None:
            self.level = rate           # seed: first observation IS the
            return                      # level, trend starts flat
        prev = self.level
        a, b = self.alpha, self.beta
        self.level = a * rate + (1.0 - a) * (self.level + self.trend)
        self.trend = b * (self.level - prev) + (1.0 - b) * self.trend

    def predict(self, horizon_ticks: float) -> Optional[float]:
        """Projected rate ``horizon_ticks`` ahead; None while off or
        unseeded (no observation yet — an unseeded forecast must not
        read as "zero load ahead")."""
        if self.mode == "off" or self.level is None:
            return None
        return max(0.0, self.level + self.trend * float(horizon_ticks))

    def as_dict(self) -> Dict[str, Any]:
        return {"mode": self.mode, "level": self.level,
                "trend": self.trend, "observations": self.observations}


class ScalingPolicy:
    """The pure decision core: hysteresis streaks + forecast vs
    capacity, no threads, no fleet — ``decide(sample, now)`` is driven
    by the autoscaler's tick (or a test's fake clock and synthetic
    samples; every number that feeds a decision arrives in ``sample``).

    ``decide`` updates the streaks and RETURNS a decision; a non-hold
    decision takes effect only when the caller ``commit()``s it (reset
    streaks, arm cooldown). The split keeps a deferred decision — the
    scaler skips applying while a previous action is still in flight —
    from burning the streak evidence that produced it: pressure that
    persists simply re-fires next tick."""

    def __init__(self, config: ScalerConfig):
        self.config = config
        self.forecast = ArrivalForecast(config.forecast,
                                        config.forecast_alpha,
                                        config.forecast_beta)
        self._up_streak = 0
        self._down_streak = 0
        self._cooldown_until = 0.0
        #: learned per-replica capacity: the PEAK observed per-replica
        #: completion rate (a lower bound that tightens as traffic
        #: grows — predictive scaling errs conservative, never
        #: optimistic). config.replica_rps > 0 overrides.
        self._learned_rps = 0.0

    def capacity_rps(self) -> float:
        """Per-replica sustainable request rate (0.0 = unknown yet)."""
        if self.config.replica_rps > 0:
            return self.config.replica_rps
        return self._learned_rps

    def decide(self, sample: Dict[str, Any], now: float
               ) -> Dict[str, Any]:
        """One evaluation. ``sample`` carries: ``replicas`` (live,
        non-draining — the serving-capacity count pressure and the
        forecast are judged against), ``total_replicas`` (every
        non-draining handle INCLUDING dead-pending-restart ones — the
        count the min/max bounds are judged against: a crashed replica
        comes back via the supervisor, so scaling past max "because one
        is briefly dead" would overshoot the budget the moment it
        restarts), ``queue_depth_mean`` (queued requests per live
        replica), ``wait_p99_ms`` (this tick window's worst per-replica
        wait p99), ``arrival_rate`` and ``completion_rate`` (req/s over
        the tick window)."""
        cfg = self.config
        replicas = max(1, int(sample["replicas"]))
        total = max(replicas,
                    int(sample.get("total_replicas", replicas)))
        rate = float(sample.get("arrival_rate", 0.0))
        self.forecast.observe(rate)
        if cfg.replica_rps <= 0:
            per = float(sample.get("completion_rate", 0.0)) / replicas
            if per > self._learned_rps:
                self._learned_rps = per
        cap = self.capacity_rps()
        horizon_ticks = cfg.horizon_s / cfg.tick_s
        predicted = self.forecast.predict(horizon_ticks)

        breach = (sample["queue_depth_mean"] > cfg.up_queue_depth
                  or sample["wait_p99_ms"] > cfg.up_wait_p99_ms)
        calm = (sample["queue_depth_mean"] <= cfg.down_queue_depth
                and sample["wait_p99_ms"] <= cfg.down_wait_p99_ms)
        if breach:
            self._up_streak += 1
            self._down_streak = 0
        elif calm:
            self._down_streak += 1
            self._up_streak = 0
        else:
            # inside the hysteresis band: hold, and neither streak may
            # keep growing — a band tick is evidence of NEITHER regime
            self._up_streak = 0
            self._down_streak = 0
        forecast_breach = bool(
            cap > 0 and predicted is not None
            and predicted > cap * replicas * cfg.headroom)

        out: Dict[str, Any] = {
            "direction": "hold", "amount": 0, "reason": None,
            "replicas": replicas, "total_replicas": total,
            "target_replicas": total,
            "breach": breach, "calm": calm,
            "forecast_breach": forecast_breach,
            "predicted_rps": predicted, "capacity_rps": cap,
            "up_streak": self._up_streak,
            "down_streak": self._down_streak}
        if now < self._cooldown_until:
            out["reason"] = "cooldown"
            return out
        if self._up_streak >= cfg.up_ticks or forecast_breach:
            if total >= cfg.max_replicas:
                out["reason"] = (f"pressure at max_replicas="
                                 f"{cfg.max_replicas}")
                return out
            amount = min(cfg.step, cfg.max_replicas - total)
            out.update(direction="up", amount=amount,
                       target_replicas=total + amount)
            if forecast_breach and self._up_streak < cfg.up_ticks:
                out["reason"] = (
                    f"forecast: predicted {predicted:.1f} rps > "
                    f"{cap:.1f} rps/replica x {replicas} x "
                    f"headroom {cfg.headroom}")
            else:
                out["reason"] = (
                    f"pressure: queue {sample['queue_depth_mean']:.1f} / "
                    f"wait p99 {sample['wait_p99_ms']:.1f} ms over "
                    f"thresholds for {self._up_streak} ticks")
            return out
        if self._down_streak >= cfg.down_ticks \
                and total > cfg.min_replicas:
            amount = min(cfg.step, total - cfg.min_replicas)
            if predicted is not None and cap > 0 and predicted > (
                    cap * (replicas - amount) * cfg.headroom):
                # the forecast says the shrunken fleet could not carry
                # the projected load: a drain now would be re-provisioned
                # within the horizon — hold instead of thrash
                out["reason"] = (f"calm, but forecast {predicted:.1f} "
                                 f"rps holds {replicas} replicas")
                return out
            out.update(direction="down", amount=amount,
                       target_replicas=total - amount,
                       reason=(f"calm for {self._down_streak} ticks "
                               f"(queue {sample['queue_depth_mean']:.1f}"
                               f" / wait p99 "
                               f"{sample['wait_p99_ms']:.1f} ms)"))
            return out
        return out

    def commit(self, now: float) -> None:
        """A decision was APPLIED: spend the streak evidence and arm
        the cooldown (a deferred decision never calls this)."""
        self._up_streak = 0
        self._down_streak = 0
        self._cooldown_until = now + self.config.cooldown_s

    def in_cooldown(self, now: float) -> bool:
        return now < self._cooldown_until


class FleetAutoscaler:
    """See module docstring. ``fleet`` is a (usually started)
    ServingFleet; the scaler does NOT own the fleet lifecycle — start/
    stop it yourself (``with fleet: with scaler: ...``). Duck-typed for
    ``HealthServer(scaler)``: live/ready delegate to the fleet and
    ``status()`` is the fleet /statusz snapshot with a ``scaler``
    block riding along."""

    def __init__(self, fleet, config: Optional[ScalerConfig] = None,
                 clock=time.monotonic):
        self.fleet = fleet
        self.config = config or ScalerConfig.from_env()
        self.stats = ScalerStats()
        self.policy = ScalingPolicy(self.config)
        self._clock = clock
        self._provision_policy = RetryPolicy(
            attempts=self.config.provision_attempts,
            backoff_s=self.config.provision_backoff_s,
            seed=self.config.seed)
        self._stop_event = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._action_thread: Optional[threading.Thread] = None
        self._action_direction: Optional[str] = None
        self._running = False
        self._last_sample_t: Optional[float] = None
        self._last_routed = 0
        self._last_completed = 0
        self._last_served: Dict[str, int] = {}   # replica -> served count
        self._last_price = 1.0
        self._target: Optional[int] = None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "FleetAutoscaler":
        if self._running:
            return self
        # opaudit: disable=concurrency -- lifecycle flag: flipped only by start/stop (externally serialized); the loop's read is advisory and _stop_event, set first on stop, is the authoritative signal
        self._running = True
        self._stop_event.clear()
        # a restarted scaler must not compute its first deltas against
        # a stopped epoch's counters
        # opaudit: disable=concurrency -- written before Thread.start() spawns the loop; Thread.start() is the happens-before edge, and thereafter the field is loop-thread-only
        self._last_sample_t = None
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="tm-fleet-scaler")
        self._thread.start()
        _flight.record("scaler", "start",
                       min_replicas=self.config.min_replicas,
                       max_replicas=self.config.max_replicas)
        return self

    def stop(self, timeout: Optional[float] = None) -> None:
        """Stop the evaluation loop; an in-flight scaling action (a
        provision or a drain) is joined to completion — a half-joined
        replica or a half-drained removal must not outlive its
        supervisor. The re-priced admission margin is RELEASED on the
        way out: a scaler stopped mid-spike must not leave the fleet
        shedding at its last inflated price forever (nothing else
        would ever set it back)."""
        was_running = self._running
        self._stop_event.set()
        self._running = False
        t = self._thread
        if t is not None:
            t.join(5.0)
        act = self._action_thread
        if act is not None:
            act.join(timeout if timeout is not None else 30.0)
        for h in self.fleet.replica_handles():
            try:
                h.transport.set_price(1.0)
            except Exception:   # noqa: BLE001 — replica mid-teardown
                pass
        # opaudit: disable=concurrency -- stop() writes only after joining the loop and action threads; Thread.join() is the happens-before edge over the loop's _reprice writes
        self._last_price = 1.0
        if was_running:
            _flight.record("scaler", "stop")

    def __enter__(self) -> "FleetAutoscaler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- evaluation loop ---------------------------------------------------
    def _loop(self) -> None:
        while not self._stop_event.wait(self.config.tick_s):
            if not self._running:
                return
            self._tick()

    def _tick(self) -> None:
        self.stats.note_tick()
        try:
            # drill hook: a raise here drops ONE evaluation (counted),
            # never the loop — the scaler keeps scaling
            fault_point("serving.scaler.tick")
            sample = self._sample()
        except Exception:   # noqa: BLE001 — incl. injected faults
            self.stats.note_evaluation_dropped()
            return
        self.stats.note_evaluation()
        self._reprice(sample)
        now = self._clock()
        decision = self.policy.decide(sample, now)
        self.stats.note_pressure(decision["breach"], decision["calm"])
        self.stats.note_forecast(
            {**self.policy.forecast.as_dict(),
             "predicted_rps": decision["predicted_rps"],
             "capacity_rps": decision["capacity_rps"]},
            decision["forecast_breach"])
        if decision["direction"] == "hold":
            return
        act = self._action_thread
        if act is not None and act.is_alive():
            # one action at a time: pressure that persists re-fires on
            # a later tick (decide() did not spend the streaks)
            self.stats.note_deferred()
            return
        self.policy.commit(now)
        # opaudit: disable=concurrency -- single-flight: _tick writes only after is_alive() proved no action thread runs, and _apply's clearing finally executes inside run() (is_alive() still True); status() reads are advisory
        self._target = decision["target_replicas"]
        self.stats.note_decision(decision)
        # THE decision event: the causal spine a post-incident dump is
        # read for (forecast breach -> scale-up -> ... -> scale-down)
        _flight.record("scaler", "scale.decision",
                       severity="info",
                       direction=decision["direction"],
                       amount=decision["amount"],
                       replicas=decision["replicas"],
                       target_replicas=decision["target_replicas"],
                       reason=decision["reason"],
                       predicted_rps=decision["predicted_rps"],
                       capacity_rps=decision["capacity_rps"])
        # opaudit: disable=concurrency -- single-flight, same protocol as _target above: writers are serialized by the is_alive() check, readers are advisory status probes
        self._action_direction = decision["direction"]
        self._action_thread = threading.Thread(
            target=self._apply, args=(decision,), daemon=True,
            name=f"tm-scaler-{decision['direction']}")
        self._action_thread.start()

    def _sample(self) -> Dict[str, Any]:
        """One pressure sample from the EXISTING telemetry counters —
        nothing re-instrumented: router arrival/completion deltas,
        per-replica queue-depth gauges (O(1) reads), and each replica's
        tick-window wait p99 (outcome-counter deltas slice exactly this
        window's samples off the ring tail — the rollout bake-window
        convention, so calm after a spike is not masked by spike-era
        history)."""
        now = self._clock()
        fl = self.fleet.stats.as_dict()
        not_draining = [h for h in self.fleet.replica_handles()
                        if not h.draining]
        handles = [h for h in not_draining if not h.dead]
        n = max(1, len(handles))
        depth = 0
        wait_p99 = 0.0
        served_now: Dict[str, int] = {}
        for h in handles:
            try:
                depth += h.transport.load_gauges()[
                    "queue_depth_requests"]
                oc = h.transport.outcome_counters()
            except Exception:   # noqa: BLE001 — a replica dying
                # between the dead-filter above and this stats RPC
                # (socket binding) must not kill the scaler tick; the
                # supervisor handles the death, this sample skips it
                continue
            served = oc["completed"] + oc["failed"]
            served_now[h.name] = served
            delta = served - self._last_served.get(h.name, 0)
            if delta > 0:
                wait_p99 = max(wait_p99, h.transport.recent_wait_ms(
                    min(delta, 512), 0.99))
        dt = (now - self._last_sample_t
              if self._last_sample_t is not None else None)
        arrival = completion = 0.0
        if dt is not None and dt > 0:
            arrival = (fl["routed"] - self._last_routed) / dt
            completion = (fl["completed"] - self._last_completed) / dt
        self._last_sample_t = now
        self._last_routed = fl["routed"]
        self._last_completed = fl["completed"]
        self._last_served = served_now
        return {"replicas": len(handles),
                "total_replicas": len(not_draining),
                "queue_depth_mean": depth / n,
                "wait_p99_ms": wait_p99,
                "arrival_rate": arrival,
                "completion_rate": completion}

    def _reprice(self, sample: Dict[str, Any]) -> None:
        """Push the re-priced admission margin to every live replica:
        observed wait p99 over the target wait (default: the scale-up
        threshold) — pressure inflates the EMA rejection estimate, so
        deadline shedding starts BEFORE the queue saturates, low
        priority first."""
        cfg = self.config
        target = (cfg.target_wait_ms if cfg.target_wait_ms > 0
                  else cfg.up_wait_p99_ms)
        price = min(cfg.price_max,
                    max(1.0, sample["wait_p99_ms"] / target))
        for h in self.fleet.replica_handles():
            if not h.draining:
                try:
                    h.transport.set_price(price)
                except Exception:   # noqa: BLE001 — replica died
                    pass            # mid-reprice; supervisor's problem
        if price != self._last_price:
            self._last_price = price
            self.stats.note_reprice(price)

    # -- actuation (its own thread; one action at a time) ------------------
    def _apply(self, decision: Dict[str, Any]) -> None:
        try:
            if decision["direction"] == "up":
                self._scale_up(decision["amount"])
            else:
                self._scale_down(decision["amount"])
        finally:
            self._action_direction = None
            self._target = None

    def _scale_up(self, amount: int) -> None:
        for _ in range(amount):
            t0 = self._clock()

            def attempt():
                # drill hook: each replica BUILD attempt — transient
                # raises retry with the seeded backoff, a hang is the
                # kill-mid-scale-up window
                fault_point("serving.scaler.provision")
                return self.fleet.add_replica()

            try:
                name = self._provision_policy.run(
                    attempt, what="scaler replica provision",
                    on_retry=lambda k, e: self._provision_retry(k, e))
            except Exception as e:      # noqa: BLE001 — retries spent
                # the fleet keeps serving at its current N; the breach
                # (if still real) re-fires a fresh decision next tick
                self.stats.note_provision_failure()
                _flight.record("scaler", "provision.failed",
                               severity="error",
                               error=f"{type(e).__name__}: {e}")
                return
            dt = self._clock() - t0
            # provision-to-serving latency: add_replica returns only
            # after warm compiles AND ring join, so dt is the honest
            # "how long until new capacity takes traffic" number
            self.stats.note_replica_added(dt)
            _flight.record("scaler", "replica.provisioned",
                           replica=name, seconds=round(dt, 4))

    def _provision_retry(self, attempt: int, error: BaseException) -> None:
        self.stats.note_provision_retry()
        _flight.record("scaler", "provision.retry", severity="warning",
                       attempt=attempt,
                       error=f"{type(error).__name__}: {error}")

    def _scale_down(self, amount: int) -> None:
        for _ in range(amount):
            name = self._pick_scale_down()
            if name is None:
                return
            try:
                self.fleet.remove_replica(name)
            except (KeyError, ValueError) as e:
                # last-live-replica floor, or a crash/remove race took
                # the handle first — both mean "do not shrink further"
                _flight.record("scaler", "scale_down.refused",
                               severity="warning", replica=name,
                               error=f"{type(e).__name__}: {e}")
                return
            self.stats.note_replica_removed()
            _flight.record("scaler", "replica.drained", replica=name)

    def _pick_scale_down(self) -> Optional[str]:
        """Newest non-draining replica (LIFO): deterministic, and the
        longest-lived replicas — the ones whose breakers and EMAs carry
        the most history — stay."""
        handles = [h for h in self.fleet.replica_handles()
                   if not h.draining]
        if len(handles) <= 1:
            return None
        return handles[-1].name

    # -- status (HealthServer-compatible: live/ready/status) ---------------
    def live(self) -> bool:
        t = self._thread
        return bool(self.fleet.live()
                    and t is not None and t.is_alive())

    def ready(self) -> bool:
        return bool(self.fleet.ready())

    def _state(self) -> str:
        if not self._running:
            return "stopped"
        act = self._action_thread
        if act is not None and act.is_alive():
            return ("scaling_up" if self._action_direction == "up"
                    else "scaling_down")
        if self.policy.in_cooldown(self._clock()):
            return "cooldown"
        return "steady"

    def scaler_status(self) -> Dict[str, Any]:
        handles = self.fleet.replica_handles()
        live = [h.name for h in handles if not h.draining and not h.dead]
        draining = [h.name for h in handles if h.draining]
        horizon_ticks = self.config.horizon_s / self.config.tick_s
        st = self.stats.as_dict()
        return {
            "state": self._state(),
            "replicas": len(handles),
            "live_replicas": len(live),
            "draining": draining,
            "target_replicas": (self._target if self._target is not None
                                else len(live)),
            "price": st["last_price"],
            "last_decision": st["last_decision"],
            "forecast": {**self.policy.forecast.as_dict(),
                         "predicted_rps":
                             self.policy.forecast.predict(horizon_ticks),
                         "capacity_rps": self.policy.capacity_rps()},
            "config": self.config.as_dict(),
            "stats": st,
        }

    def status(self) -> Dict[str, Any]:
        """The fleet's full /statusz snapshot with the ``scaler`` block
        riding along — ``HealthServer(scaler)`` serves the whole
        elastic loop's observability at one endpoint, and /metricsz
        picks the ``tm_fleet_scale_*`` families off the same block."""
        doc = dict(self.fleet.status())
        doc["scaler"] = self.scaler_status()
        return doc
