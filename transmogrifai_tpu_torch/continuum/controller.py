"""The self-healing continuous-learning control loop.

``ContinuumController`` supervises one serving surface (a
``ServingFleet`` or a single ``ServingEngine``) through the full
monitor → retrain → gate → promote state machine:

* **MONITORING** — a request-plane tap feeds the
  :class:`continuum.monitor.DriftMonitor`'s streaming sketches (bounded
  queue, drained on the controller's own tick thread — zero work on the
  live path beyond one deque append); a debounced sustained breach
  trips the trigger.
* **RETRAINING** — ``workflow_factory()`` trains on ``train_data``
  under ``Workflow.train(checkpoint_dir=…)`` with a ``RetryPolicy``
  around the WHOLE attempt: a retrain killed mid-way (chaos, OOM,
  preemption) relaunches and RESUMES from the last completed layer,
  producing a bitwise-identical candidate (the train checkpoint
  contract, exercised by the loop that needs it most).
* **GATING** — the candidate's fitted model must pass the opcheck
  linter (``TM_LINT`` strict by default here: a candidate that fails
  static verification never reaches traffic).
* **SHADOWING** — a :class:`serving.shadow.ShadowScorer` mirrors live
  traffic onto the candidate and the metric-delta verdict decides;
  candidate scores are never returned to callers.
* **PROMOTING** — ``fleet.rollout()`` (staged, bake-window watched,
  whole-fleet auto-rollback inherited) or a single engine's warmed
  ``swap()``. On success the monitor re-anchors on the candidate's own
  train-time baseline; on rollback the fleet is already back on the
  previous version and the loop returns to monitoring after a
  cooldown.

Triggers that arrive while a cycle is in flight COALESCE: at most one
pending follow-up cycle, never a stack of concurrent retrains.

Every transition is observable (``status()`` → the serving snapshot
plus a ``continuum`` block; ``on_transition`` callback for tests/ops)
and injectable: the ``continuum.monitor.observe`` /
``continuum.retrain.launch`` / ``continuum.shadow.score`` /
``continuum.promote`` TM_FAULTS points sit on each arrow of the state
machine, so the full drill — inject drift, detect, kill the retrain
mid-way, resume, shadow-gate, promote, inject a bad candidate,
whole-fleet rollback — runs deterministically in tier-1
(tests/test_continuum.py).

Retrains run on the serving surface's device (a fleet's ``device``, or
``device=`` given to the controller; None: CUDA, raising without it),
so the candidate is trained, shadow-scored and promoted where it will
serve.

Knobs ride ``ContinuumConfig`` with ``TM_CONTINUUM_*`` env spellings
through the shared STRICT parser: a typo'd knob raises at construction.
"""
from __future__ import annotations

import inspect
import os
import shutil
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from .._device import resolve_device
from ..profiling import ContinuumStats
from ..resilience.faults import fault_point
from ..resilience.policy import RetryPolicy
from ..telemetry import recorder as _flight
from .monitor import DriftConfig, DriftMonitor

__all__ = ["ContinuumConfig", "ContinuumController"]

#: state-machine states
MONITORING = "monitoring"
RETRAINING = "retraining"
GATING = "gating"
SHADOWING = "shadowing"
PROMOTING = "promoting"
COOLDOWN = "cooldown"
STOPPED = "stopped"


def _opt_str(v: str) -> Optional[str]:
    return v or None


#: TM_CONTINUUM_* env var -> (ContinuumConfig field, parser). The
#: catalog IS the validation: any other TM_CONTINUUM_ name raises.
_ENV_FIELDS: Dict[str, tuple] = {
    "TM_CONTINUUM_TICK_S": ("tick_s", float),
    "TM_CONTINUUM_COOLDOWN_S": ("cooldown_s", float),
    "TM_CONTINUUM_RETRAIN_ATTEMPTS": ("retrain_attempts", int),
    "TM_CONTINUUM_RETRAIN_BACKOFF_S": ("retrain_backoff_s", float),
    "TM_CONTINUUM_SHADOW_MIN_SAMPLES": ("shadow_min_samples", int),
    "TM_CONTINUUM_SHADOW_TIMEOUT_S": ("shadow_timeout_s", float),
    "TM_CONTINUUM_SHADOW_MAX_ERROR_RATE": ("shadow_max_error_rate", float),
    "TM_CONTINUUM_SHADOW_MAX_DISAGREEMENT":
        ("shadow_max_disagreement", float),
    "TM_CONTINUUM_SHADOW_MAX_MEAN_ABS_DELTA":
        ("shadow_max_mean_abs_delta", float),
    "TM_CONTINUUM_SHADOW_QUEUE": ("shadow_queue", int),
    "TM_CONTINUUM_SHADOW_SAMPLE_EVERY": ("shadow_sample_every", int),
    "TM_CONTINUUM_TAP_QUEUE": ("tap_queue", int),
    "TM_CONTINUUM_LINT": ("lint_mode", str),
    "TM_CONTINUUM_VERSION_PREFIX": ("version_prefix", str),
    "TM_CONTINUUM_CKPT": ("checkpoint_dir", _opt_str),
    "TM_CONTINUUM_SEED": ("seed", int),
    "TM_CONTINUUM_STOP_TIMEOUT_S": ("stop_timeout_s", float),
}


class ContinuumConfig:
    """Control-loop knobs. See _ENV_FIELDS for TM_CONTINUUM_*
    spellings; drift-detection thresholds live separately in
    :class:`continuum.monitor.DriftConfig` (TM_DRIFT_*)."""

    def __init__(self, tick_s: float = 0.25,
                 cooldown_s: float = 10.0,
                 retrain_attempts: int = 2,
                 retrain_backoff_s: float = 0.05,
                 shadow_min_samples: int = 16,
                 shadow_timeout_s: float = 20.0,
                 shadow_max_error_rate: float = 0.0,
                 shadow_max_disagreement: float = 0.25,
                 shadow_max_mean_abs_delta: float = -1.0,
                 shadow_queue: int = 256,
                 shadow_sample_every: int = 1,
                 tap_queue: int = 1024,
                 lint_mode: str = "strict",
                 version_prefix: str = "c",
                 checkpoint_dir: Optional[str] = None,
                 seed: int = 0,
                 stop_timeout_s: float = 30.0):
        if tick_s <= 0:
            # Event.wait(<=0) returns immediately: the controller
            # thread would busy-spin at 100% CPU for the loop's life
            raise ValueError("tick_s must be > 0")
        if retrain_attempts < 1:
            raise ValueError("retrain_attempts must be >= 1")
        if shadow_min_samples < 1:
            # 0 would make the shadow gate a vacuous pass with zero
            # mirrored evidence — the health gate silently off
            raise ValueError("shadow_min_samples must be >= 1")
        if shadow_timeout_s <= 0 or stop_timeout_s <= 0:
            raise ValueError(
                "shadow_timeout_s/stop_timeout_s must be > 0")
        if min(shadow_queue, shadow_sample_every, tap_queue) < 1:
            raise ValueError(
                "shadow_queue/shadow_sample_every/tap_queue must be >= 1")
        if min(cooldown_s, retrain_backoff_s, shadow_max_error_rate) < 0:
            raise ValueError(
                "cooldown_s/retrain_backoff_s/shadow_max_error_rate "
                "must be >= 0")
        # shadow_max_mean_abs_delta: NEGATIVE disables the gate, 0.0 is
        # the STRICTEST setting (any score delta fails) — 0.0-as-off
        # would collide with the neighboring shadow_max_error_rate,
        # where 0.0 means zero tolerance
        if not (0.0 <= shadow_max_disagreement <= 1.0):
            raise ValueError(
                "shadow_max_disagreement must be in [0, 1]")
        if not version_prefix:
            raise ValueError("version_prefix must be non-empty")
        from ..lint import resolve_lint_mode
        # validates the spelling NOW (typos fail the deploy, not the
        # first candidate hours later); "strict"/"warn"/"off" semantics
        # are applied per cycle by the gate itself
        resolve_lint_mode(lint_mode)
        self.tick_s = float(tick_s)
        self.cooldown_s = float(cooldown_s)
        self.retrain_attempts = int(retrain_attempts)
        self.retrain_backoff_s = float(retrain_backoff_s)
        self.shadow_min_samples = int(shadow_min_samples)
        self.shadow_timeout_s = float(shadow_timeout_s)
        self.shadow_max_error_rate = float(shadow_max_error_rate)
        self.shadow_max_disagreement = float(shadow_max_disagreement)
        self.shadow_max_mean_abs_delta = float(shadow_max_mean_abs_delta)
        self.shadow_queue = int(shadow_queue)
        self.shadow_sample_every = int(shadow_sample_every)
        self.tap_queue = int(tap_queue)
        self.lint_mode = str(lint_mode)
        self.version_prefix = str(version_prefix)
        self.checkpoint_dir = checkpoint_dir
        self.seed = int(seed)
        self.stop_timeout_s = float(stop_timeout_s)

    @classmethod
    def from_env(cls, environ: Optional[Dict[str, str]] = None,
                 **overrides) -> "ContinuumConfig":
        """TM_CONTINUUM_* env vars + explicit overrides (which win),
        through the shared STRICT parser: unknown name or unparsable
        value raises."""
        from ..resilience.config import parse_env_fields
        return cls(**parse_env_fields(
            "TM_CONTINUUM_", _ENV_FIELDS, what="continuum env var",
            environ=environ, overrides=overrides))

    def as_dict(self) -> Dict[str, Any]:
        return {f: getattr(self, f) for f, _ in _ENV_FIELDS.values()}


class ContinuumController:
    """See module docstring.

    ``serving``  — a started ServingFleet (staged rollout + bake-window
                   auto-rollback on promote) or ServingEngine (warmed
                   hot-swap promote, no bake gate). The controller does
                   NOT own the serving lifecycle — start/stop it
                   yourself (`with fleet: with controller: ...`).
    ``model``    — the WorkflowModel currently serving (baseline
                   anchor).
    ``workflow_factory`` — zero-arg callable returning a fresh
                   (unfitted) Workflow for each retrain.
    ``train_data`` — retrain data, or a zero-arg callable returning it
                   (called once per cycle, so every attempt of one
                   cycle — including a resumed one — trains on the
                   SAME data and the checkpoint fingerprint holds).
    ``device``   — where retrains run and candidates are shadow-scored
                   (None: the serving fleet's ``device``, else CUDA).
    """

    def __init__(self, serving, model, workflow_factory: Callable[[], Any],
                 train_data, *,
                 baseline: Optional[Dict[str, Any]] = None,
                 baseline_data=None,
                 config: Optional[ContinuumConfig] = None,
                 drift_config: Optional[DriftConfig] = None,
                 buckets=None, warm_sample=None,
                 on_transition: Optional[Callable[[str, str, str], None]]
                 = None, device=None):
        self.serving = serving
        self.device = resolve_device(
            device if device is not None
            else getattr(serving, "device", None))
        self.model = model
        self.workflow_factory = workflow_factory
        self.train_data = train_data
        self.config = config or ContinuumConfig.from_env()
        self.stats = ContinuumStats()
        self.monitor = DriftMonitor(
            model, baseline=baseline, baseline_data=baseline_data,
            config=drift_config or DriftConfig.from_env())
        self._baseline_data = baseline_data
        # promotion/shadow compile config: default to the fleet's own
        # construction-time bucket ladder/warm sample so the candidate
        # is judged (and shipped) on the padding/compile config the
        # fleet actually serves with
        self._buckets = (buckets if buckets is not None
                         else getattr(serving, "_buckets", True))
        self._warm_sample = (warm_sample if warm_sample is not None
                             else getattr(serving, "_warm_sample", None))
        self._on_transition = on_transition
        self._ckpt_base = self.config.checkpoint_dir or os.path.join(
            tempfile.gettempdir(), f"tm_continuum_ckpt_{os.getpid()}")

        from collections import deque
        self._tap_queue: deque = deque()
        self._tap_lock = threading.Lock()
        self._state_lock = threading.RLock()
        self._state = MONITORING
        self._history: List[Dict[str, Any]] = []
        self._cycle_lock = threading.Lock()
        self._cycle_thread: Optional[threading.Thread] = None
        self._cycle_no = 0
        self._pending_trigger: Optional[str] = None
        self._cooldown_until = 0.0
        self._current_version: Optional[str] = None
        self.last_cycle: Optional[Dict[str, Any]] = None
        self._stop_event = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._running = False

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "ContinuumController":
        if self._running:
            return self
        self._running = True
        self._stop_event.clear()
        if self.state == STOPPED:
            # restart support: a stopped controller re-enters the loop
            # MONITORING — leaving it STOPPED would make the loop drain
            # taps forever without ever evaluating drift (a dead safety
            # loop that still reports live)
            self._transition(MONITORING, "controller restarted")
        self.serving.add_tap(self._tap)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="tm-continuum")
        self._thread.start()
        return self

    def stop(self, timeout: Optional[float] = None) -> None:
        """Detach from the serving taps and stop the loop. An in-flight
        cycle is asked to stop at its next phase boundary (a running
        Workflow.train cannot be interrupted mid-layer — its checkpoint
        makes that loss-free) and joined up to the timeout."""
        self._stop_event.set()
        self._running = False
        try:
            self.serving.remove_tap(self._tap)
        except Exception:   # noqa: BLE001 — serving may already be down
            pass
        t = self._thread
        if t is not None:
            t.join(5.0)
        with self._cycle_lock:
            # _cycle_thread is published under the cycle lock
            # (_launch_cycle_locked); an unguarded read could miss a
            # cycle the loop launched just before it observed the stop
            cyc = self._cycle_thread
        if cyc is not None:
            cyc.join(timeout if timeout is not None
                     else self.config.stop_timeout_s)
        try:
            # a graceful stop folds the still-queued observations into
            # the monitor instead of discarding them — a short-lived
            # serve (one JSONL batch) still records what it saw
            self._drain_observations()
        except Exception:   # noqa: BLE001 — incl. injected faults
            self.stats.note_monitor_error()
        self._transition(STOPPED, "controller stopped")

    def __enter__(self) -> "ContinuumController":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- the request tap (live submit thread: O(1), never raises) ----------
    def _tap(self, data, future) -> None:
        with self._tap_lock:
            if len(self._tap_queue) >= self.config.tap_queue:
                self._tap_queue.popleft()   # bounded: lose the OLDEST
                self.stats.note_dropped()
            self._tap_queue.append(data)

    # -- state machine -----------------------------------------------------
    @property
    def state(self) -> str:
        with self._state_lock:
            return self._state

    def _transition(self, new: str, reason: str) -> None:
        with self._state_lock:
            old, self._state = self._state, new
            self._history.append({
                "time": time.time(), "mono": time.monotonic(),
                "from": old, "to": new, "reason": reason})
            del self._history[:-64]
        # the loop's state changes join the same flight-recorder stream
        # as the fleet's breaker/rollout events: a drift-triggered
        # retrain that ends in a rollback reads as ONE causal chain
        _flight.record("continuum", "transition", from_state=old,
                       to_state=new, reason=reason)
        cb = self._on_transition
        if cb is not None and old != new:
            try:
                cb(old, new, reason)
            except Exception:   # noqa: BLE001 — observer, not control flow
                pass

    def history(self) -> List[Dict[str, Any]]:
        with self._state_lock:
            return [dict(h) for h in self._history]

    # -- trigger (monitor tick or external caller) -------------------------
    def trigger(self, reason: str = "manual") -> bool:
        """Request a retrain cycle. Returns True when a cycle launched;
        False when one was already in flight (or cooling down) and the
        request COALESCED into at most one pending follow-up — never a
        stack of concurrent retrains."""
        self.stats.note_trigger(reason)
        with self._cycle_lock:
            busy = (self._cycle_thread is not None
                    and self._cycle_thread.is_alive())
            if busy or self.state != MONITORING:
                self.stats.note_coalesced()
                if self._pending_trigger is None:
                    self._pending_trigger = reason
                return False
            self._launch_cycle_locked(reason)
            return True

    def _launch_cycle_locked(self, reason: str) -> None:
        self._cycle_no += 1
        t = threading.Thread(
            target=self._run_cycle, args=(self._cycle_no, reason),
            daemon=True, name=f"tm-continuum-cycle{self._cycle_no}")
        self._cycle_thread = t
        t.start()

    # -- controller loop ---------------------------------------------------
    def _loop(self) -> None:
        while not self._stop_event.wait(self.config.tick_s):
            try:
                self._drain_observations()
            except Exception:   # noqa: BLE001 — incl. injected faults
                self.stats.note_monitor_error()
            with self._cycle_lock:
                cyc = self._cycle_thread
            if cyc is not None and cyc.is_alive():
                continue        # cycle owns the state until it ends
            st = self.state
            if st == COOLDOWN:
                with self._state_lock:
                    cooldown_until = self._cooldown_until
                if time.monotonic() >= cooldown_until:
                    self._transition(MONITORING, "cooldown elapsed")
                continue
            if st != MONITORING:
                continue
            pending = None
            with self._cycle_lock:
                if self._pending_trigger is not None:
                    pending = self._pending_trigger
                    self._pending_trigger = None
                    self._launch_cycle_locked(f"coalesced: {pending}")
            if pending is not None:
                continue
            self._monitor_tick()

    def _drain_observations(self) -> None:
        with self._tap_lock:
            batch = list(self._tap_queue)
            self._tap_queue.clear()
        if not batch:
            return
        # drill hook: a raise here loses ONE tick's observations (the
        # loop counts it and carries on), never the loop itself
        fault_point("continuum.monitor.observe", requests=len(batch))
        rows = 0
        for data in batch:
            rows += self.monitor.observe(data)
        self.stats.note_observed(len(batch), rows)

    def _monitor_tick(self) -> None:
        self.stats.note_tick()
        try:
            tick = self.monitor.tick()
        except Exception:   # noqa: BLE001 — a bad tick must not kill
            self.stats.note_monitor_error()     # the control loop
            return
        self.stats.note_scores(tick.scores, tick.window_complete)
        if tick.triggered:
            worst = sorted(tick.scores.items(), key=lambda kv: -kv[1])[:3]
            named = ", ".join(f"{n} js={s:.3f}" for n, s in worst
                              if n in tick.breached)
            # ONE coalesce/launch implementation: trigger() — the
            # at-most-one-pending invariant must not live in two copies
            self.trigger(f"drift: {named}" if named else "drift")

    # -- the cycle (its own thread) ----------------------------------------
    def _run_cycle(self, n: int, reason: str) -> None:
        self.stats.note_cycle()
        t_start = time.monotonic()
        report: Dict[str, Any] = {
            "cycle": n, "trigger_reason": reason, "outcome": None,
            "version": None, "phases": {}}
        phase = [RETRAINING]

        def timed(name, fn):
            t0 = time.monotonic()
            try:
                return fn()
            finally:
                report["phases"][name] = time.monotonic() - t0

        try:
            self._transition(RETRAINING, reason)
            candidate = timed("retrain_s", lambda: self._retrain(n))
            if self._stop_event.is_set():
                report["outcome"] = "stopped"
                return
            phase[0] = GATING
            self._transition(GATING, f"cycle {n}: lint gate")
            ok, lint_info = timed("lint_s",
                                  lambda: self._lint_gate(candidate))
            report["lint"] = lint_info
            if not ok:
                self.stats.note_lint_reject()
                report["outcome"] = "lint_rejected"
                return
            phase[0] = SHADOWING
            self._transition(SHADOWING, f"cycle {n}: shadow gate")
            verdict = timed("shadow_s",
                            lambda: self._shadow_gate(candidate))
            report["shadow"] = verdict
            if self._stop_event.is_set():
                # stop interrupted the shadow wait: the cycle ends
                # "stopped", NOT "shadow_rejected" — an insufficient-
                # samples verdict here is the shutdown's fault, not an
                # indictment of the candidate
                report["outcome"] = "stopped"
                return
            if not verdict["ok"]:
                self.stats.note_shadow_reject()
                report["outcome"] = "shadow_rejected"
                report["reason"] = verdict["reason"]
                return
            phase[0] = PROMOTING
            version = f"{self.config.version_prefix}{n}"
            report["version"] = version
            self._transition(PROMOTING, f"cycle {n}: promote {version}")
            promoted, rollout = timed(
                "promote_s", lambda: self._promote(version, candidate))
            report["rollout"] = rollout
            if promoted:
                self.stats.note_promotion()
                with self._state_lock:
                    # continuum_status reads it under the same lock —
                    # the promoted version and the state transition
                    # must never be observed torn
                    self._current_version = version
                self.model = candidate
                self._reanchor_monitor(candidate)
                report["outcome"] = "promoted"
            else:
                self.stats.note_promote_rollback()
                self.monitor.reset()
                report["outcome"] = "rolled_back"
                report["reason"] = (rollout or {}).get("reason")
        except Exception as e:      # noqa: BLE001 — the cycle's backstop
            if phase[0] == RETRAINING:
                self.stats.note_retrain_failure()
            else:
                self.stats.note_cycle_error()
            self.monitor.reset()
            report["outcome"] = "error"
            report["phase"] = phase[0]
            report["error"] = f"{type(e).__name__}: {e}"
        finally:
            report["wall_s"] = time.monotonic() - t_start
            self.last_cycle = report
            with self._state_lock:
                # the cooldown deadline belongs to the COOLDOWN state
                # it arms — written under the state lock so the loop
                # and continuum_status never see the state without
                # its deadline
                self._cooldown_until = (time.monotonic()
                                        + self.config.cooldown_s)
            self._transition(
                COOLDOWN, f"cycle {n}: {report['outcome']}")

    def _reanchor_monitor(self, candidate) -> None:
        """Drift is measured against what the SERVING model trained on:
        after a promotion the monitor re-anchors on the candidate's own
        persisted baseline. A candidate without one (factory workflow
        lacking the raw-feature filter and no baseline_data) keeps the
        previous baseline — windows still reset so the next trigger is
        earned on fresh traffic. The catch is BROAD on purpose: the
        promotion already happened, and a transient baseline_data read
        failure here must degrade to keep-the-old-baseline, not mark a
        successful promotion as a cycle error."""
        try:
            self.monitor.set_model(candidate,
                                   baseline_data=self._baseline_data)
        except Exception:   # noqa: BLE001 — degrade, never un-promote
            self.monitor.reset()

    # -- phases ------------------------------------------------------------
    def _retrain(self, cycle_no: int):
        ckpt_dir = os.path.join(self._ckpt_base, f"cycle{cycle_no:04d}")
        # fresh cycle = fresh train: a stale dir from a PREVIOUS process
        # with different data would be rejected loudly mid-attempt
        # (CheckpointMismatch) — wipe it here, BEFORE attempt 1; the
        # attempts within this cycle then share it, which is the resume
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        data = (self.train_data() if callable(self.train_data)
                else self.train_data)
        policy = RetryPolicy(attempts=self.config.retrain_attempts,
                             backoff_s=self.config.retrain_backoff_s,
                             seed=self.config.seed)

        def attempt():
            self.stats.note_retrain()
            fault_point("continuum.retrain.launch", cycle=cycle_no)
            wf = self.workflow_factory()
            # a workflow whose train takes no device (a caller's own
            # stand-in) trains where it decides
            kw = ({"device": self.device} if "device" in
                  inspect.signature(wf.train).parameters else {})
            return wf.train(data, checkpoint_dir=ckpt_dir, **kw)

        candidate = policy.run(
            attempt, what=f"continuum retrain #{cycle_no}",
            on_retry=lambda k, e: self.stats.note_retrain_retry())
        shutil.rmtree(ckpt_dir, ignore_errors=True)     # train deleted
        return candidate                                # contents; tidy dir

    def _lint_gate(self, candidate):
        from ..lint import lint_model, resolve_lint_mode
        mode = resolve_lint_mode(self.config.lint_mode)
        if mode == "off":
            return True, {"mode": "off"}
        report = lint_model(candidate)
        info = {"mode": mode, "errors": sum(
            1 for f in report.findings if f.severity == "error"),
            "findings": len(report.findings)}
        if report.has_errors:
            info["report"] = report.format_text()
            if mode == "strict":
                return False, info
        return True, info

    def _shadow_gate(self, candidate) -> Dict[str, Any]:
        from ..serving.shadow import ShadowScorer, shadow_backend
        cfg = self.config
        backend = shadow_backend(candidate, buckets=self._buckets,
                                 warm_sample=self._warm_sample,
                                 device=self.device)
        scorer = ShadowScorer(backend, max_queue=cfg.shadow_queue,
                              sample_every=cfg.shadow_sample_every)
        scorer.start()
        self.serving.add_tap(scorer.observe)
        try:
            deadline = time.monotonic() + cfg.shadow_timeout_s
            while time.monotonic() < deadline \
                    and not self._stop_event.is_set():
                s = scorer.summary()
                if s["samples"] >= cfg.shadow_min_samples:
                    break
                time.sleep(min(0.02, cfg.tick_s))
        finally:
            self.serving.remove_tap(scorer.observe)
            scorer.stop()
        verdict = scorer.verdict(
            min_samples=cfg.shadow_min_samples,
            max_error_rate=cfg.shadow_max_error_rate,
            max_disagreement=cfg.shadow_max_disagreement,
            max_mean_abs_delta=(cfg.shadow_max_mean_abs_delta
                                if cfg.shadow_max_mean_abs_delta >= 0
                                else None))
        self.stats.note_shadow_samples(verdict["samples"])
        return verdict

    def _promote(self, version: str, candidate):
        fault_point("continuum.promote", version=version)
        if hasattr(self.serving, "rollout"):
            # staged fleet rollout: bake-window health verdicts and the
            # whole-fleet auto-rollback are INHERITED, not re-implemented
            report = self.serving.rollout(version, candidate)
            return (not report.get("rolled_back")), report
        prev = self.serving.swap(version, candidate,
                                 buckets=self._buckets,
                                 retire_old=True)
        return True, {"rolled_back": False, "previous": prev,
                      "mode": "hot-swap"}

    # -- status (HealthServer-compatible: live/ready/status) ---------------
    def live(self) -> bool:
        t = self._thread
        return bool(self.serving.live()
                    and t is not None and t.is_alive())

    def ready(self) -> bool:
        return bool(self.serving.ready())

    def continuum_status(self) -> Dict[str, Any]:
        with self._state_lock:
            state = self._state
            history = [dict(h) for h in self._history[-16:]]
            current_version = self._current_version
            cooldown_until = self._cooldown_until
        with self._cycle_lock:
            cyc = self._cycle_thread
            cycle_no = self._cycle_no
            pending_trigger = self._pending_trigger
        return {
            "state": state,
            "cycle": cycle_no,
            "cycle_in_flight": bool(cyc is not None and cyc.is_alive()),
            "pending_trigger": pending_trigger,
            "current_version": current_version,
            "cooldown_remaining_s": max(
                0.0, cooldown_until - time.monotonic())
            if state == COOLDOWN else 0.0,
            "config": self.config.as_dict(),
            "stats": self.stats.as_dict(),
            "drift": self.monitor.status(),
            "last_cycle": dict(self.last_cycle) if self.last_cycle
            else None,
            "history": history,
        }

    def status(self) -> Dict[str, Any]:
        """The serving layer's full /statusz snapshot with the
        continuum block riding along — ``HealthServer(controller)``
        serves the whole loop's observability at one endpoint."""
        doc = dict(self.serving.status())
        doc["continuum"] = self.continuum_status()
        return doc
