"""Resilient multi-replica serving fleet.

One ServingEngine is one process/one failure domain: a crashed
dispatcher or a bad hot-swap takes every caller down. The fleet layer
turns N engines into one serving surface that survives both:

* **Shared-nothing replicas** — each replica owns its OWN ModelRegistry
  and compiled programs (built independently from the same model/
  artifact), so no replica failure can corrupt another's state. A
  supervisor thread watches liveness and restarts dead replicas after a
  deterministic seeded backoff.
* **Routing** (router.py) — consistent-hash model→replica placement,
  per-replica circuit breakers, and deadline-aware failover
  re-dispatch. The engine's EngineStopped guarantee (a non-drain stop
  fails queued futures with a DISTINCT retryable error) is what lets
  the router classify a replica crash as re-dispatchable: accepted
  requests survive the loss of the replica that accepted them.
* **Staged rollout with automatic rollback** — ``rollout()`` swaps a
  new model version replica-by-replica (composing the engine's warmed
  hot-swap and the registry's skew gate, which run per replica),
  watches each baked replica's /statusz health deltas (error rate,
  shed/reject counters, bake-window wait p99) against the fleet's
  pre-rollout baseline, and rolls the WHOLE fleet back to the previous
  version on regression. The previous version stays registered and
  warm until the rollout commits, so rollback is an atomic per-replica
  pointer flip — no cold compiles, no client-visible gap.
* **Chaos drills** — the request plane carries the same deterministic
  TM_FAULTS harness as the training runtime:
  ``serving.engine.dispatch`` (fail a micro-batch),
  ``serving.router.route`` (fail a routing attempt), and
  ``serving.replica.crash`` (hard-kill the selected replica mid-load —
  any raise-* kind at that point triggers ``chaos_kill``).

Every replica serves on the fleet's one device (``device=``, resolved
like every entry point of the port: CUDA unless the caller asks for the
CPU, raising without it): each inproc replica's registry is built
there, and each socket worker is handed it (``--device``). With every
replica on the same device and path, a kernel that fails fails the
requests it carried on every replica alike: failover cannot turn a
device fault into a success elsewhere.

Config rides ``FleetConfig``, overridable via ``TM_FLEET_*`` env vars
parsed with the same strict-typo-rejection convention as TM_FAULTS: an
unknown ``TM_FLEET_`` variable or an unparsable value raises at
construction — a drill (or a production deploy) whose knobs silently
didn't apply proves nothing.
"""
from __future__ import annotations

import os
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional

from .._device import resolve_device
from ..profiling import FleetStats
from ..resilience.policy import RetryPolicy
from ..telemetry import recorder as _flight
from .admission import EngineClosed, EngineStopped
from .engine import EngineConfig, RequestTaps, ServingEngine
from .registry import ModelRegistry, build_registry
from .router import (CircuitBreaker, EjectConfig, FleetRouter,
                     HedgeConfig, NoReplicaAvailable, RetryBudgetConfig)
from .transport import (InprocTransport, ProcessWorkerTransport,
                        ReplicaTransport, TRANSPORT_KINDS,
                        TransportConfig)

__all__ = ["FleetConfig", "ServingFleet", "NoReplicaAvailable",
           "EngineStopped"]


#: TM_FLEET_* env var -> (FleetConfig field, parser). The catalog IS the
#: validation: any other TM_FLEET_ name is a typo and raises.
_ENV_FIELDS: Dict[str, tuple] = {
    "TM_FLEET_REPLICAS": ("replicas", int),
    "TM_FLEET_BREAKER_FAILURES": ("breaker_failures", int),
    "TM_FLEET_BREAKER_RATIO": ("breaker_ratio", float),
    "TM_FLEET_BREAKER_WINDOW": ("breaker_window", int),
    "TM_FLEET_BREAKER_MIN_VOLUME": ("breaker_min_volume", int),
    "TM_FLEET_BREAKER_OPEN_S": ("breaker_open_s", float),
    "TM_FLEET_ROUTE_ATTEMPTS": ("route_attempts", int),
    "TM_FLEET_BACKOFF_S": ("backoff_s", float),
    "TM_FLEET_SEED": ("seed", int),
    "TM_FLEET_PLACEMENT_WIDTH": ("placement_width", int),
    "TM_FLEET_SUPERVISE_S": ("supervise_s", float),
    "TM_FLEET_RESTART_BACKOFF_S": ("restart_backoff_s", float),
    "TM_FLEET_ROLLOUT_MIN_REQUESTS": ("rollout_min_requests", int),
    "TM_FLEET_ROLLOUT_BAKE_S": ("rollout_bake_s", float),
    "TM_FLEET_ROLLOUT_ERROR_TOL": ("rollout_error_tol", float),
    "TM_FLEET_ROLLOUT_P99_FACTOR": ("rollout_p99_factor", float),
    "TM_FLEET_ROLLOUT_P99_FLOOR_MS": ("rollout_p99_floor_ms", float),
    "TM_FLEET_DRAIN_TIMEOUT_S": ("drain_timeout_s", float),
    "TM_FLEET_TRANSPORT": ("transport", str),
}


class FleetConfig:
    """Fleet topology, breaker, failover, supervision, and rollout
    knobs. See _ENV_FIELDS for the TM_FLEET_* spellings."""

    def __init__(self, replicas: int = 2,
                 breaker_failures: int = 5,
                 breaker_ratio: float = 0.5,
                 breaker_window: int = 20,
                 breaker_min_volume: int = 10,
                 breaker_open_s: float = 1.0,
                 route_attempts: int = 3,
                 backoff_s: float = 0.01,
                 seed: int = 0,
                 placement_width: int = 0,
                 supervise_s: float = 0.1,
                 restart_backoff_s: float = 0.2,
                 rollout_min_requests: int = 32,
                 rollout_bake_s: float = 3.0,
                 rollout_error_tol: float = 0.02,
                 rollout_p99_factor: float = 3.0,
                 rollout_p99_floor_ms: float = 5.0,
                 drain_timeout_s: float = 30.0,
                 transport: str = "inproc"):
        if replicas < 1:
            raise ValueError("replicas must be >= 1")
        if route_attempts < 1:
            raise ValueError("route_attempts must be >= 1")
        if placement_width < 0:
            raise ValueError("placement_width must be >= 0 (0 = all)")
        if rollout_p99_factor <= 0 or rollout_bake_s <= 0:
            raise ValueError("rollout thresholds must be > 0")
        # validate EVERYTHING here, not deep in CircuitBreaker after the
        # full N-replica warm-compile cold start (and with the breaker's
        # field name instead of the TM_FLEET_ spelling)
        if min(breaker_failures, breaker_window, breaker_min_volume) < 1:
            raise ValueError(
                "breaker_failures/breaker_window/breaker_min_volume "
                "must be >= 1")
        if not (0.0 < breaker_ratio <= 1.0):
            raise ValueError("breaker_ratio must be in (0, 1]")
        if rollout_min_requests < 1:
            # 0 would make every bake window exit instantly with zero
            # served -> the vacuous pass -> ANY broken candidate
            # promotes fleet-wide: the health gate silently off
            raise ValueError("rollout_min_requests must be >= 1")
        if supervise_s <= 0:
            # Event.wait(<=0) returns immediately: the supervisor
            # thread would busy-spin at 100% CPU for the fleet's life
            raise ValueError("supervise_s must be > 0")
        if min(breaker_open_s, restart_backoff_s, backoff_s,
               rollout_error_tol, drain_timeout_s) < 0:
            raise ValueError(
                "breaker_open_s/restart_backoff_s/backoff_s/"
                "rollout_error_tol/drain_timeout_s must be >= 0")
        if transport not in TRANSPORT_KINDS:
            raise ValueError(
                f"transport (TM_FLEET_TRANSPORT) must be one of "
                f"{TRANSPORT_KINDS}, got {transport!r}")
        self.replicas = int(replicas)
        self.breaker_failures = int(breaker_failures)
        self.breaker_ratio = float(breaker_ratio)
        self.breaker_window = int(breaker_window)
        self.breaker_min_volume = int(breaker_min_volume)
        self.breaker_open_s = float(breaker_open_s)
        self.route_attempts = int(route_attempts)
        self.backoff_s = float(backoff_s)
        self.seed = int(seed)
        self.placement_width = int(placement_width)
        self.supervise_s = float(supervise_s)
        self.restart_backoff_s = float(restart_backoff_s)
        self.rollout_min_requests = int(rollout_min_requests)
        self.rollout_bake_s = float(rollout_bake_s)
        self.rollout_error_tol = float(rollout_error_tol)
        self.rollout_p99_factor = float(rollout_p99_factor)
        self.rollout_p99_floor_ms = float(rollout_p99_floor_ms)
        self.drain_timeout_s = float(drain_timeout_s)
        self.transport = str(transport)

    @classmethod
    def from_env(cls, environ: Optional[Dict[str, str]] = None,
                 **overrides) -> "FleetConfig":
        """Build a config from TM_FLEET_* env vars (+ explicit
        overrides, which win). STRICT like TM_FAULTS: an unknown
        TM_FLEET_ variable, or a value the field cannot parse, raises
        ValueError — a typo'd knob must fail the deploy, not silently
        run the defaults. The parse itself is the SHARED
        resilience.config.parse_env_fields — one strictness
        implementation behind TM_FLEET_*/TM_DRIFT_*/TM_CONTINUUM_*."""
        from ..resilience.config import parse_env_fields
        return cls(**parse_env_fields(
            "TM_FLEET_", _ENV_FIELDS, what="fleet env var",
            environ=environ, overrides=overrides))

    def as_dict(self) -> Dict[str, Any]:
        return {f: getattr(self, f) for f, _ in _ENV_FIELDS.values()}


class ReplicaHandle:
    """One supervised replica: transport + breaker + supervision state.

    ``transport`` is the fleet's one seam to the replica (dispatch,
    liveness, lifecycle, stats — see serving/transport/base.py);
    ``engine`` is the LOCAL ServingEngine behind an inproc transport
    (None for a socket replica, whose engine lives in a worker
    process). Rollout hot-swaps and engine-level taps are engine
    surfaces, which is exactly why they are inproc-only."""

    def __init__(self, name: str, transport: ReplicaTransport,
                 breaker: CircuitBreaker,
                 engine: Optional[ServingEngine] = None):
        self.name = name
        self.transport = transport
        self.engine = engine
        self.breaker = breaker
        self.dead = False           # killed/observed-dead, pending restart
        self.draining = False       # elastic scale-down in progress: the
        #                             router stops placing traffic here,
        #                             the engine completes its queue,
        #                             then the handle leaves the fleet
        self.degraded = False       # ejected as HUNG (liveness fresh but
        #                             requests stalled): out of the
        #                             placement ring until a probe
        #                             readmits it or the supervisor
        #                             escalates to a restart
        self.restarts = 0
        self.restart_at: Optional[float] = None


class ServingFleet:
    """See module docstring. ``model`` may be a WorkflowModel, an
    artifact/registry-root path, or a zero-arg factory called once per
    replica; each replica builds its OWN registry and compiled programs
    from it. Sharing one already-built FusedScorer/PortableModel across
    replicas would share mutable backend state, defeating the
    shared-nothing failure isolation — rejected for replicas > 1.
    ``device`` places every replica (None: CUDA, raising without it)."""

    def __init__(self, model=None, *, replicas: Optional[int] = None,
                 buckets=True, version: str = "v1", warm_sample=None,
                 warm: bool = True, config: Optional[FleetConfig] = None,
                 engine_config: Optional[EngineConfig] = None,
                 transport: Optional[str] = None,
                 transport_config: Optional[TransportConfig] = None,
                 worker_devices: Optional[List[str]] = None,
                 worker_env: Optional[Dict[str, str]] = None,
                 hedge_config: Optional[HedgeConfig] = None,
                 eject_config: Optional[EjectConfig] = None,
                 retry_budget_config: Optional[RetryBudgetConfig] = None,
                 device=None):
        self.config = config or FleetConfig.from_env()
        #: the one device every replica serves on
        self.device = resolve_device(device)
        kind = transport if transport is not None \
            else self.config.transport
        if kind not in TRANSPORT_KINDS:
            raise ValueError(f"transport must be one of "
                             f"{TRANSPORT_KINDS}, got {kind!r}")
        self._transport_kind = kind
        self._transport_config = transport_config
        #: TM_MESH_DEVICES values (device counts), assigned round-robin
        #: to socket workers; on a one-card machine they all share it
        self._worker_devices = list(worker_devices or [])
        #: extra environment for socket workers (TM_ENGINE_*/TM_FAULTS/
        #: ...) — engine_config objects cannot cross a process
        #: boundary, knobs can
        self._worker_env = dict(worker_env or {})
        n = int(replicas) if replicas is not None else self.config.replicas
        if n < 1:
            raise ValueError("a fleet needs at least one replica")
        self._check_shared_nothing(model, n)
        self._artifact_path: Optional[str] = None
        if kind == "socket":
            if engine_config is not None:
                raise ValueError(
                    "engine_config cannot cross a process boundary — "
                    "configure socket workers via TM_ENGINE_*/"
                    "TM_TENANT_* entries in worker_env")
            if warm_sample is not None:
                raise ValueError(
                    "warm_sample cannot cross a process boundary — "
                    "socket workers warm from the bucket ladder")
            self._artifact_path = self._resolve_artifact(model)
        self.stats = FleetStats()
        self.version = version
        self._engine_config = engine_config
        #: elastic scale-up provisions NEW replicas from the same source
        #: the fleet was built from (model / artifact path / factory; a
        #: committed rollout re-points this at the promoted model so a
        #: replica added later serves what the fleet serves)
        self._model_source = model
        self._warm = warm
        #: rollout defaults: a candidate must serve on the SAME bucket
        #: ladder / warm data the fleet was deployed with, or promotion
        #: silently changes the padding/compile configuration (and the
        #: bake p99 is judged on different buckets than the baseline)
        self._buckets = buckets
        self._warm_sample = warm_sample
        #: fleet-level request taps: one observation per ROUTED request
        #: (not per replica dispatch/failover) — the SHARED
        #: engine.RequestTaps contract implementation
        self._taps = RequestTaps(self.stats.note_tap_error)
        self._rollout_lock = threading.Lock()
        #: guards dead/restart transitions — chaos_kill and the
        #: supervisor race on h.dead; without the lock one crash can be
        #: counted twice and the restart backoff re-armed
        self._life_lock = threading.Lock()
        self._running = False
        self._supervisor: Optional[threading.Thread] = None
        self._stop_event = threading.Event()
        #: deterministic restart-delay schedule — the SAME seeded-jitter
        #: math every retry in this codebase uses (policy.sleep_for)
        self._restart_policy = RetryPolicy(
            attempts=2, backoff_s=self.config.restart_backoff_s,
            seed=self.config.seed)
        if kind == "socket":
            # worker processes build their own registries from the
            # artifact at spawn — nothing to build here
            registries: List[Optional[ModelRegistry]] = [None] * n
        else:
            # a factory is called serially (no thread-safety demand on
            # user code); the per-replica registry builds — warm bucket
            # compiles are the expensive part — run on a small pool:
            # they are independent shared-nothing units, and building
            # them one after another would make fleet cold-start N x
            # one replica's load-and-warm wall
            materialized = [model() if callable(model) else model
                            for _ in range(n)]

            def build(m):
                return self._build_registry(m, buckets=buckets,
                                            version=version,
                                            warm_sample=warm_sample,
                                            warm=warm)
            if n > 1:
                from concurrent.futures import ThreadPoolExecutor
                with ThreadPoolExecutor(max_workers=min(n, 4),
                                        thread_name_prefix="tm-fleet-build"
                                        ) as pool:
                    registries = list(pool.map(build, materialized))
            else:
                registries = [build(materialized[0])]
        #: guards _handles mutations (elastic add/remove vs supervisor
        #: sweep vs status reads); readers take the lock for a
        #: consistent copy, the hot dispatch path reads the copy
        self._topology_lock = threading.Lock()
        #: monotonically increasing replica-name counter: removal
        #: leaves gaps, so names stay unique for the fleet's whole life
        #: (flight-recorder chains and per-replica metric labels must
        #: never alias two different replicas under one name)
        self._replica_seq = n
        self._handles: List[ReplicaHandle] = [
            self._new_handle(f"r{i}", registries[i]) for i in range(n)]
        self.router = FleetRouter(
            self,
            policy=RetryPolicy(attempts=self.config.route_attempts,
                               backoff_s=self.config.backoff_s,
                               seed=self.config.seed),
            placement_width=self.config.placement_width,
            hedge=hedge_config, eject=eject_config,
            retry_budget=retry_budget_config)

    @staticmethod
    def _check_shared_nothing(model, n: int) -> None:
        if n <= 1 or model is None or isinstance(model, str) \
                or callable(model):
            return
        from ..workflow import FusedScorer, WorkflowModel
        if isinstance(model, WorkflowModel):
            return      # immutable fitted params; each replica compiles
        if isinstance(model, ModelRegistry):
            raise ValueError(
                "shared-nothing fleet: one prebuilt ModelRegistry would "
                "be SHARED across replicas (one mutable catalog + LRU, "
                "one failure domain) — pass a zero-arg factory that "
                "builds a fresh registry per replica instead")
        if isinstance(model, FusedScorer) or hasattr(model,
                                                     "score_columns"):
            raise ValueError(
                "shared-nothing fleet: a prebuilt scorer/portable model "
                "would be SHARED across replicas (one mutable backend, "
                "one failure domain) — pass a WorkflowModel, an artifact "
                "path, or a zero-arg factory instead")

    @staticmethod
    def _resolve_artifact(model) -> str:
        """The on-disk artifact socket workers load at spawn: a saved
        workflow / portable export / registry-root path passes
        through; a WorkflowModel is saved once to a temp dir; anything
        else (factories, prebuilt registries/scorers) cannot cross a
        process boundary and is rejected loudly."""
        if isinstance(model, str):
            if not os.path.isdir(model):
                raise ValueError(
                    f"socket transport: artifact path {model!r} is not "
                    f"a directory")
            return model
        from ..workflow import WorkflowModel
        if isinstance(model, WorkflowModel):
            path = tempfile.mkdtemp(prefix="tm-fleet-artifact-")
            model.save(path)
            return path
        raise ValueError(
            "socket transport needs a saved artifact path or a "
            "WorkflowModel (factories and prebuilt registries cannot "
            "cross a process boundary)")

    def _devices_for(self, name: str) -> Optional[str]:
        """Round-robin TM_MESH_DEVICES assignment by replica ordinal
        (names are ``r<seq>`` for the fleet's whole life, so a
        restarted or re-added worker keeps a stable pin)."""
        if not self._worker_devices:
            return None
        ordinal = int(name[1:]) if name[1:].isdigit() else 0
        return self._worker_devices[ordinal % len(self._worker_devices)]

    def _worker_environment(self) -> Dict[str, str]:
        """Per-spawn extra env for socket workers: the fleet's bucket
        ladder + warm policy in TM_WORKER_* spellings, then the
        caller's worker_env (which wins)."""
        env: Dict[str, str] = {}
        if self._buckets is not True:
            env["TM_WORKER_BUCKETS"] = ",".join(
                str(b) for b in self._buckets)
        if not self._warm:
            env["TM_WORKER_WARM"] = "0"
        env.update(self._worker_env)
        return env

    def _new_handle(self, name: str,
                    registry: Optional[ModelRegistry]) -> ReplicaHandle:
        """One supervised replica + breaker wired into the fleet's
        stats/flight-recorder callbacks — shared by the constructor and
        elastic scale-up. Inproc: an engine around the already-built
        registry. Socket: a process-worker transport that spawns from
        the fleet's artifact on start()."""
        if self._transport_kind == "socket":
            engine = None
            transport: ReplicaTransport = ProcessWorkerTransport(
                self._artifact_path, name=name, version=self.version,
                devices=self._devices_for(name),
                env=self._worker_environment(),
                config=self._transport_config,
                device=str(self.device))
        else:
            engine = ServingEngine(registry=registry,
                                   config=self._engine_config)
            transport = InprocTransport(engine)
        breaker = CircuitBreaker(
            failure_threshold=self.config.breaker_failures,
            ratio_threshold=self.config.breaker_ratio,
            window=self.config.breaker_window,
            min_volume=self.config.breaker_min_volume,
            open_s=self.config.breaker_open_s,
            on_transition=(lambda old, new, name=name:
                           self._breaker_transition(name, old, new)),
            on_probe=lambda name=name: self._breaker_probe(name))
        return ReplicaHandle(name, transport, breaker, engine=engine)

    def _build_registry(self, m, *, buckets, version, warm_sample,
                        warm) -> ModelRegistry:
        """``m`` is already materialized (factories are called by the
        constructor, serially). Source detection is the shared
        registry.build_registry — the CLI's single-engine path uses
        the same one, so the modes cannot drift."""
        return build_registry(m, buckets=buckets, version=version,
                              warm_sample=warm_sample, warm=warm,
                              device=self.device)

    def _breaker_transition(self, replica: str, old: str,
                            new: str) -> None:
        if new == "open":
            self.stats.note_breaker("open")
        elif new == "closed" and old == "half_open":
            self.stats.note_breaker("close")
        # every breaker edge lands in the flight recorder: the
        # open → half_open → closed walk after a crash is the causal
        # spine a post-incident dump is read for
        _flight.record("fleet", "breaker",
                       severity="warning" if new == "open" else "info",
                       replica=replica, from_state=old, to_state=new)

    def _breaker_probe(self, replica: str) -> None:
        self.stats.note_breaker("probe")
        _flight.record("fleet", "breaker_probe", replica=replica)

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "ServingFleet":
        if self._running:
            return self
        # opaudit: disable=concurrency -- lifecycle flag flipped only by start/stop (externally serialized); mid-operation readers treat it as advisory and every topology/rollout mutation re-validates under its own lock
        self._running = True
        self._stop_event.clear()
        handles = self.replica_handles()
        if self._transport_kind == "socket" and len(handles) > 1:
            # worker spawns are seconds each (interpreter + model load
            # + warm compiles) and fully independent — parallelize so
            # fleet cold-start is one worker's wall, not N of them
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(max_workers=min(len(handles), 8),
                                    thread_name_prefix="tm-fleet-spawn"
                                    ) as pool:
                list(pool.map(lambda h: h.transport.start(), handles))
        else:
            for h in handles:
                h.transport.start()
        self.router.start()
        self._supervisor = threading.Thread(
            target=self._supervise_loop, daemon=True,
            name="tm-fleet-supervisor")
        self._supervisor.start()
        return self

    def stop(self, drain: bool = True,
             timeout: Optional[float] = None) -> None:
        """Stop every replica. drain=True completes accepted work —
        INCLUDING requests parked in the router's failover-backoff
        queue, which flush to the still-live replicas before any engine
        closes; drain=False fails queued engine futures with
        EngineStopped and the router resolves every still-pending
        routed future — a fleet shutdown never strands a Future,
        resolved or failed, ever."""
        self._stop_event.set()
        t = self._supervisor
        if t is not None:
            t.join(5.0)
        if drain and self._running:
            self.router.drain(timeout if timeout is not None
                              else self.config.drain_timeout_s)
        self._running = False
        for h in self.replica_handles():
            h.transport.stop(drain=drain, timeout=timeout)
        self.router.stop()
        _flight.record("fleet", "stop", drain=drain)
        _flight.RECORDER.auto_dump("fleet stop")

    def __enter__(self) -> "ServingFleet":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- request plane ----------------------------------------------------
    def submit(self, data, deadline_ms: Optional[float] = None,
               version: Optional[str] = None, priority: str = "normal",
               tenant: Optional[str] = None):
        """Route one request into the fleet; returns a Future.

        ``version`` is the per-request MODEL id: it keys consistent-
        hash placement (home set / failover ladder — unchanged from
        the single-model fleet) AND selects which registered version
        (or alias) the chosen replica's engine scores. An unknown id
        fails the request loudly with ``registry.ModelNotFound`` — the
        pre-refactor behavior (every request silently scoring the
        replica's registry default) is gone. ``version=None`` follows
        each replica's registry DEFAULT, which is what staged rollouts
        and hot-swaps manage — so existing single-model callers see
        identical behavior. ``tenant`` threads into per-tenant
        admission budgets + weighted-fair queueing; ``priority="low"``
        marks shed-first traffic for the re-priced admission
        controller (admission.PRIORITIES)."""
        if not self._running:
            # same contract as a single engine's late submit: PLAIN
            # non-retryable EngineClosed. Only requests ACCEPTED before
            # shutdown get the retryable EngineStopped — an outer
            # routing layer classifying a late submit as retryable
            # would retry a permanently-stopped fleet forever
            raise EngineClosed("fleet is not accepting requests")
        fut = self.router.submit(data, deadline_ms=deadline_ms,
                                 version=version, priority=priority,
                                 tenant=tenant)
        self._taps.notify(data, fut)
        return fut

    # -- request taps (continuum monitor / shadow mirror) ------------------
    def add_tap(self, fn) -> None:
        """Register a request-plane observer: ``fn(data, future)`` per
        ACCEPTED routed request, called once on the submitting thread
        (failover re-dispatches are replica-plane events the observer
        never sees twice). Same observe-only contract as
        ServingEngine.add_tap; raising taps are swallowed + counted in
        ``FleetStats.tap_errors``."""
        self._taps.add(fn)

    def remove_tap(self, fn) -> None:
        self._taps.remove(fn)

    def score(self, data, timeout: Optional[float] = None,
              deadline_ms: Optional[float] = None,
              version: Optional[str] = None, priority: str = "normal",
              tenant: Optional[str] = None):
        """submit() + wait. Same ``version``-selects-the-model
        semantics (None = the replica's registry default)."""
        return self.submit(data, deadline_ms=deadline_ms,
                           version=version, priority=priority,
                           tenant=tenant).result(timeout)

    def replica_handles(self) -> List[ReplicaHandle]:
        with self._topology_lock:
            return list(self._handles)

    def accepting(self) -> bool:
        """False once stop() begins: the router resolves in-flight
        failovers with EngineStopped instead of retrying into a fleet
        that is going away."""
        return self._running

    def _handle(self, name: str) -> ReplicaHandle:
        for h in self.replica_handles():
            if h.name == name:
                return h
        raise KeyError(f"no such replica: {name!r}")

    # -- elastic topology (the FleetAutoscaler's levers) -------------------
    def add_replica(self, warm_sample=None) -> str:
        """Provision ONE new shared-nothing replica from the fleet's
        model source (the construction-time model/path/factory, or the
        last committed rollout's) and join it to the router's placement
        ring. The expensive part — registry build + warm bucket
        compiles — happens ENTIRELY before the handle becomes visible
        to the router, so a scale-up never exposes live traffic to a
        cold replica: by the time any request can route here, every
        shape bucket is compiled. Returns the new replica's name.

        Serialized against rollouts (the rollout lock): a replica
        provisioned mid-rollout would miss the version being staged and
        leave the fleet split-brained on a clean commit."""
        with self._rollout_lock:
            source = self._model_source
            # a replicas=1 fleet may legally hold a prebuilt scorer —
            # but growing it would SHARE that one mutable backend
            # across two failure domains, so the constructor's guard
            # re-runs here at the new topology size
            self._check_shared_nothing(source, len(self._handles) + 1)
            if self._transport_kind == "socket":
                # the worker builds its own registry from the artifact;
                # the spawn + ready wait below is the warm-before-
                # visible equivalent of the inproc registry build
                registry = None
            else:
                m = source() if callable(source) else source
                registry = self._build_registry(
                    m, buckets=self._buckets, version=self.version,
                    warm_sample=(warm_sample if warm_sample is not None
                                 else self._warm_sample),
                    warm=self._warm)
            with self._topology_lock:
                name = f"r{self._replica_seq}"
                self._replica_seq += 1
            h = self._new_handle(name, registry)
            if self._running:
                # spawn/start BEFORE the handle becomes routable: by
                # the time any request can land here the worker is
                # ready (socket) / the engine is running (inproc)
                h.transport.start()
            with self._topology_lock:
                self._handles.append(h)
                replicas = len(self._handles)
        self.stats.note_replica_added()
        _flight.record("fleet", "replica.add", replica=name,
                       version=self.version, replicas=replicas)
        return name

    def remove_replica(self, name: str,
                       timeout: Optional[float] = None) -> None:
        """Retire ONE replica gracefully: mark it DRAINING (the router
        stops placing new traffic the instant the flag is up — parked
        failover re-dispatches re-resolve against the updated ring),
        drain its accepted queue to completion via the engine's
        ``stop(drain=True)`` path, then drop the handle. Zero accepted-
        request loss by construction: nothing is removed until the
        engine's queue is empty. Refuses to remove the LAST live
        non-draining replica — an elastic fleet never scales to zero
        serving capacity out from under its callers."""
        with self._rollout_lock:
            h = self._handle(name)
            with self._topology_lock:
                alive = [x for x in self._handles
                         if not x.draining and not x.dead
                         and x is not h]
                if self._running and not alive:
                    raise ValueError(
                        f"refusing to remove {name!r}: it is the last "
                        f"live replica (scale-down floor is 1)")
                with self._life_lock:
                    # the draining flag and the dead read happen in ONE
                    # life-lock hold: the supervisor's restart branch
                    # re-checks draining under the same lock, so either
                    # it restarts FIRST (dead flips False, we drain the
                    # restarted engine below) or it sees draining and
                    # skips — a removed dead replica can never be
                    # resurrected into a handle-less zombie engine
                    h.draining = True
                    dead = h.dead
            _flight.record("fleet", "replica.drain", replica=name)
            if not dead:
                # drain=True completes every accepted request before
                # the dispatcher exits — the engine's zero-accepted-
                # loss contract IS the scale-down safety argument
                h.transport.stop(
                    drain=True,
                    timeout=(timeout if timeout is not None
                             else self.config.drain_timeout_s))
            with self._topology_lock:
                self._handles = [x for x in self._handles if x is not h]
                replicas = len(self._handles)
        self.stats.note_replica_removed()
        _flight.record("fleet", "replica.remove", replica=name,
                       replicas=replicas)

    # -- supervision ------------------------------------------------------
    def _mark_dead(self, h: ReplicaHandle,
                   reason: str = "observed dead") -> bool:
        """Crash bookkeeping shared by chaos_kill and the supervisor's
        observed-dead branch: dead flag, crash counter, breaker
        force-open, seeded restart schedule. The dead re-check runs
        under the life lock, so a chaos_kill racing the supervisor's
        observed-dead sweep counts ONE crash, not two. Returns False if
        the replica was already marked."""
        with self._life_lock:
            if h.dead:
                return False
            h.dead = True
            h.restart_at = (time.monotonic()
                            + self._restart_policy.sleep_for(
                                f"fleet.restart.{h.name}",
                                min(h.restarts + 1, 8)))
        self.stats.note_crash()
        _flight.record("fleet", "replica.crash", severity="error",
                       replica=h.name, reason=reason)
        h.breaker.force_open()
        # a crash is an incident boundary: persist the chain NOW — the
        # ring keeps moving, the dump freezes what led here
        _flight.RECORDER.auto_dump(f"replica crash: {h.name}")
        return True

    def chaos_kill(self, name: str, reason: str = "chaos") -> None:
        """Hard-kill a live replica (no drain): its queued requests fail
        with EngineStopped (the router re-dispatches them), its breaker
        force-opens, and the supervisor restarts it after the seeded
        restart backoff. Public: this is the ops/bench chaos hook, and
        the handler the ``serving.replica.crash`` fault kind drives."""
        h = self._handle(name)
        if self._mark_dead(h, reason=reason):
            h.transport.kill()

    def _supervise_loop(self) -> None:
        while not self._stop_event.wait(self.config.supervise_s):
            if not self._running:
                return
            for h in self.replica_handles():
                if not self._running:
                    return
                if h.draining:
                    # an elastic scale-down stops this engine ON
                    # PURPOSE — restarting it would resurrect the
                    # replica the scaler is retiring
                    continue
                if not h.dead and not h.transport.live():
                    # dispatcher/worker died without a chaos_kill:
                    # same treatment — breaker open, restart scheduled
                    # (_mark_dead re-checks under the life lock)
                    self._mark_dead(h)
                elif not h.dead and not h.degraded \
                        and self.router.eject.enabled:
                    # the GRAY branch: liveness is green (or we'd be in
                    # the observed-dead branch) but requests may be
                    # stalling — the hung-replica detector's sweep
                    self._maybe_eject(h)
                elif h.dead and h.restart_at is not None \
                        and time.monotonic() >= h.restart_at:
                    with self._life_lock:
                        if not h.dead or h.restart_at is None \
                                or h.draining:
                            # lost a race with chaos_kill — or with a
                            # remove_replica that marked this DEAD
                            # replica draining after the loop's own
                            # draining check: restarting now would
                            # start an engine whose handle is about to
                            # leave the fleet (a zombie dispatcher no
                            # fleet.stop() would ever stop). Both
                            # sides serialize on the life lock.
                            continue
                        # claim the restart (restart_at=None keeps a
                        # second sweep out) but run it OUTSIDE the life
                        # lock: a socket restart is a multi-second
                        # worker respawn, and holding the fleet-wide
                        # life lock for it would freeze crash
                        # bookkeeping for every OTHER replica
                        h.restart_at = None
                    try:
                        h.transport.start()
                    except Exception as e:  # noqa: BLE001 — respawn
                        with self._life_lock:
                            if h.dead and not h.draining:
                                h.restart_at = (
                                    time.monotonic()
                                    + self._restart_policy.sleep_for(
                                        f"fleet.restart.{h.name}",
                                        min(h.restarts + 1, 8)))
                        _flight.record("fleet", "replica.restart_failed",
                                       severity="error", replica=h.name,
                                       error=repr(e))
                        continue
                    with self._life_lock:
                        if h.draining or not self._running:
                            # the replica left (or the fleet stopped)
                            # while the respawn ran: the fresh worker
                            # must not outlive its handle
                            h.transport.kill()
                            continue
                        h.dead = False
                        h.restarts += 1
                        # a restart after a hung-replica ejection is a
                        # fresh process: readmit to the placement ring
                        was_degraded, h.degraded = h.degraded, False
                    self.router.reset_suspicion(h.name)
                    self.stats.note_restart()
                    _flight.record("fleet", "replica.restart",
                                   replica=h.name, restarts=h.restarts)
                    if was_degraded:
                        self.stats.note_readmission()
                        _flight.record("fleet", "replica.readmit",
                                       replica=h.name,
                                       reason="restarted")

    # -- hung-replica ejection (the gray-failure sweep) --------------------
    def _maybe_eject(self, h: ReplicaHandle) -> None:
        """Detect a HUNG replica — heartbeat fresh, requests stalled —
        and eject it from the placement ring. The evidence is the
        router's per-replica bookkeeping: the oldest in-flight dispatch
        has outlived max(min_age_s, factor x the replica's own success-
        latency EWMA). A crash cannot land here (transport.live() would
        be False → the observed-dead branch); this sweep exists for the
        failure liveness cannot see: a one-way partition blackholing
        every response while PONGs keep flowing.

        After ejection the replica is probed once (a real control RPC
        with its own timeout, run on a side thread so a blackholed
        reply cannot wedge the supervisor). Probe OK → readmit (the
        stall resolved itself — a GC pause, a transient). Probe fail →
        escalate: mark dead + kill, which severs the connection so
        every stuck in-flight future fails retryable (WorkerUnavailable
        → router failover rescues the requests) and the normal restart
        protocol takes over."""
        eject = self.router.eject
        age = self.router.oldest_inflight_age(h.name)
        ewma, n = self.router.replica_latency(h.name)
        threshold = max(eject.min_age_s,
                        eject.factor * ewma
                        if n >= eject.min_samples else 0.0)
        hung_by_age = age is not None and age > threshold
        # the hedged-fleet complement: a winning hedge CANCELS the stuck
        # primary, wiping its in-flight age before it can cross the
        # threshold — what remains is the streak of dispatches the
        # replica lost to hedges without ever answering on its own
        streak = self.router.hedge_loss_streak(h.name)
        hung_by_hedges = (eject.loser_streak > 0
                          and streak >= eject.loser_streak)
        if not hung_by_age and not hung_by_hedges:
            return
        others = [x for x in self.replica_handles()
                  if x is not h and not x.dead and not x.draining
                  and not x.degraded]
        if not others:
            # never eject the last routable replica: degraded-but-slow
            # beats NoReplicaAvailable for every request
            return
        with self._life_lock:
            if h.dead or h.draining or h.degraded:
                return              # lost a race — another path claimed it
            h.degraded = True
        self.stats.note_ejection()
        _flight.record("fleet", "replica.eject", severity="warning",
                       replica=h.name, inflight_age_s=age,
                       latency_ewma_s=ewma, latency_samples=n,
                       threshold_s=threshold,
                       hedge_loser_streak=streak)
        if self._probe_replica(h, eject.probe_timeout_s):
            with self._life_lock:
                if h.degraded:
                    h.degraded = False
                else:
                    return          # raced a restart's readmission
            self.router.reset_suspicion(h.name)
            self.stats.note_readmission()
            _flight.record("fleet", "replica.readmit", replica=h.name,
                           reason="probe_ok")
            return
        _flight.record("fleet", "replica.probe_failed",
                       severity="error", replica=h.name,
                       timeout_s=eject.probe_timeout_s)
        if self._mark_dead(h, reason="hung: ejection probe failed"):
            # severing the connection is the rescue: the hung worker's
            # stuck in-flight futures fail WorkerUnavailable, and the
            # router fails them over to the healthy replicas
            h.transport.kill()

    @staticmethod
    def _probe_replica(h: ReplicaHandle, timeout_s: float) -> bool:
        """One readiness RPC with a HARD timeout, transport-agnostic:
        ready() may block on the very partition being diagnosed, so it
        runs on a disposable daemon thread we abandon at timeout."""
        outcome: Dict[str, bool] = {}

        def run() -> None:
            try:
                outcome["ok"] = bool(h.transport.ready())
            except Exception:   # noqa: BLE001 — a raising probe failed
                outcome["ok"] = False

        t = threading.Thread(target=run, daemon=True,
                             name=f"tm-eject-probe-{h.name}")
        t.start()
        t.join(timeout_s)
        return outcome.get("ok", False)

    # -- staged rollout ---------------------------------------------------
    def rollout(self, version: str, model, *, buckets=None,
                warm_sample=None, bake_s: Optional[float] = None,
                min_requests: Optional[int] = None) -> Dict[str, Any]:
        """Swap ``version`` in replica-by-replica; watch each replica's
        health delta over its bake window against the fleet's
        pre-rollout baseline; on ANY regression roll the whole fleet
        back to the previous version (kept registered and warm until
        the rollout commits). Returns a report dict; never raises on a
        regression — rollback IS the designed outcome. The rollout
        holds a lock: concurrent rollouts are a deploy bug and raise.
        ``buckets``/``warm_sample`` default (None) to the fleet's
        construction-time values — a promotion must not silently move
        the fleet to a different bucket ladder."""
        if self._transport_kind != "inproc":
            # a worker loads ONE artifact at spawn; there is no remote
            # hot_swap verb (yet) — redeploy socket fleets by rolling
            # worker restarts against a new artifact path
            raise RuntimeError(
                "staged rollout is not supported over the socket "
                "transport — restart workers against the new artifact "
                "instead")
        if buckets is None:
            buckets = self._buckets
        if warm_sample is None:
            warm_sample = self._warm_sample
        # same shared-nothing guard as the constructor: rolling a
        # prebuilt scorer out would register ONE mutable backend object
        # behind every replica, silently defeating the isolation the
        # constructor rejects loudly (replica count read under the
        # topology lock — an elastic add/remove mid-read must not feed
        # the guard a torn count)
        with self._topology_lock:
            replica_count = len(self._handles)
        self._check_shared_nothing(model, replica_count)
        if not self._rollout_lock.acquire(blocking=False):
            raise RuntimeError("a rollout (or an elastic scaling "
                               "operation) is already in progress")
        try:
            return self._rollout_locked(
                version, model, buckets=buckets, warm_sample=warm_sample,
                bake_s=(bake_s if bake_s is not None
                        else self.config.rollout_bake_s),
                min_requests=(min_requests if min_requests is not None
                              else self.config.rollout_min_requests))
        finally:
            self._rollout_lock.release()

    def _rollout_handles(self) -> List[ReplicaHandle]:
        """The replica set a rollout stages across: one SNAPSHOT at
        entry (elastic add/remove serializes on the rollout lock, so
        the set cannot change mid-rollout), excluding draining replicas
        — they are leaving the fleet and staging a version onto them
        would bake against an engine that takes no traffic."""
        return [h for h in self.replica_handles() if not h.draining]

    def _recent_baseline(self, min_requests: int) -> Dict[str, Any]:
        """The fleet's health over its most RECENT ``min_requests``
        outcomes per replica (ring tails at rollout entry) — the same
        per-window sample count each candidate's bake is judged on.
        Lifetime cumulative counters would not do: a crash storm hours
        ago inflates a lifetime error rate until a candidate failing
        25% of its bake passes the error-rate gate. A fresh pre-rollout
        observation window would not do either: it delays every rollout
        by a bake and measures whatever transient the deploy moment
        carries instead of steady healthy serving."""
        completed = failed = 0
        p99 = 0.0
        for h in self._rollout_handles():
            c, f = h.transport.recent_outcomes(min_requests)
            completed += c
            failed += f
            if c + f > 0:
                # slice by SERVED count: the wait ring books a sample
                # per dispatched request, failed-at-dispatch included
                p99 = max(p99,
                          h.transport.recent_wait_ms(c + f, 0.99))
        served = completed + failed
        return {"error_rate": failed / served if served else 0.0,
                "wait_p99_ms": p99, "window_served": served}

    def _rollout_locked(self, version, model, *, buckets, warm_sample,
                        bake_s, min_requests) -> Dict[str, Any]:
        self.stats.note_rollout()
        baseline = self._recent_baseline(min_requests)
        _flight.record("fleet", "rollout.start", version=version,
                       baseline_error_rate=baseline["error_rate"],
                       baseline_wait_p99_ms=baseline["wait_p99_ms"])
        base_err = baseline["error_rate"]
        # no serving history at all (fresh fleet, rollout before any
        # traffic): there is no latency regression to measure against —
        # gating on max(floor, 3 x 0.0) would false-rollback any
        # candidate whose honest under-load p99 tops the floor. The
        # error/shed gates still apply (their baseline is a clean 0).
        base_p99 = (baseline["wait_p99_ms"]
                    if baseline["window_served"] else None)
        report: Dict[str, Any] = {
            "version": version, "rolled_back": False, "reason": None,
            "baseline": baseline,
            "replicas": {}}
        swapped: List[tuple] = []
        handles = self._rollout_handles()
        for h in handles:
            try:
                m = model() if callable(model) else model
                prev = h.engine.swap(version, m, buckets=buckets,
                                     warm_sample=warm_sample,
                                     retire_old=False, device=self.device)
            except Exception as e:      # noqa: BLE001 — skew gate, load
                # retries exhausted, warm-compile failure, factory bug:
                # a swap that dies on replica k must not strand
                # replicas 0..k-1 on the new version (split-brain) —
                # roll the already-swapped set back and report, per the
                # never-raises-on-regression contract
                verdict = {"ok": False, "reason": f"swap raised: {e!r}"}
                report["replicas"][h.name] = verdict
                _flight.record("fleet", "rollout.verdict",
                               severity="warning", replica=h.name,
                               version=version, ok=False,
                               reason=verdict["reason"])
                self._rollback(swapped, version)
                try:        # best-effort: the failed replica may have
                    h.engine.registry.retire(    # half-registered it
                        version, drain_timeout=self.config.drain_timeout_s)
                except Exception:   # noqa: BLE001 — never registered
                    pass
                report["rolled_back"] = True
                report["reason"] = f"replica {h.name}: {verdict['reason']}"
                return report
            swapped.append((h, prev))
            # bake window starts AFTER the flip: waits booked while the
            # swap itself warmed bucket programs (compile CPU steals
            # cycles from concurrent dispatch on small hosts) are the
            # swap's cost, not the candidate version's serving health
            pre = h.engine.stats.outcome_counters()
            deadline = time.monotonic() + bake_s
            while time.monotonic() < deadline:
                cur = h.engine.stats.outcome_counters()
                served = ((cur["completed"] - pre["completed"])
                          + (cur["failed"] - pre["failed"]))
                if served >= min_requests:
                    break
                time.sleep(0.01)
            verdict = self._health_verdict(h, pre, base_err, base_p99)
            report["replicas"][h.name] = verdict
            _flight.record("fleet", "rollout.verdict",
                           severity="info" if verdict["ok"]
                           else "warning",
                           replica=h.name, version=version,
                           ok=verdict["ok"], reason=verdict["reason"],
                           served=verdict.get("served"),
                           bake_wait_p99_ms=verdict.get(
                               "bake_wait_p99_ms"))
            if not verdict["ok"]:
                self._rollback(swapped, version)
                report["rolled_back"] = True
                report["reason"] = (f"replica {h.name}: "
                                    f"{verdict['reason']}")
                return report
        for h, prev in swapped:
            if prev and prev != version:
                try:
                    h.engine.registry.retire(
                        prev, drain_timeout=self.config.drain_timeout_s)
                except (KeyError, ValueError):
                    pass    # already gone / re-flipped by an operator
        # the commit re-points the fleet's provisioning source: a
        # replica the autoscaler adds AFTER this rollout must serve the
        # promoted model, not the construction-time one
        self.version = version
        self._model_source = model
        _flight.record("fleet", "rollout.commit", version=version)
        return report

    def _health_verdict(self, h: ReplicaHandle, pre: Dict[str, Any],
                        base_err: float, base_p99: Optional[float]
                        ) -> Dict[str, Any]:
        cur = h.engine.stats.outcome_counters()
        completed_d = cur["completed"] - pre["completed"]
        failed_d = cur["failed"] - pre["failed"]
        shed_d = ((cur["shed_expired"] - pre["shed_expired"])
                  + (cur["rejected_queue_full"]
                     - pre["rejected_queue_full"])
                  + (cur["rejected_predicted_late"]
                     - pre["rejected_predicted_late"])
                  + (cur["rejected_tenant_budget"]
                     - pre["rejected_tenant_budget"]))
        served = completed_d + failed_d
        out = {"ok": True, "reason": None, "served": served,
               "failed": failed_d, "shed_or_rejected": shed_d,
               "bake_wait_p99_ms": None}
        if served == 0:
            out["reason"] = "no traffic during bake (vacuous pass)"
            return out
        err_rate = failed_d / served
        if err_rate > base_err + self.config.rollout_error_tol:
            out["ok"] = False
            out["reason"] = (f"error rate {err_rate:.3f} vs baseline "
                             f"{base_err:.3f} (+tol "
                             f"{self.config.rollout_error_tol})")
            return out
        shed_rate = shed_d / (served + shed_d)
        if shed_rate > self.config.rollout_error_tol:
            out["ok"] = False
            out["reason"] = (f"shed/reject rate {shed_rate:.3f} over "
                             f"tolerance {self.config.rollout_error_tol}")
            return out
        # slice by SERVED count — the wait ring books one sample per
        # dispatched request, failed-at-dispatch included, so a
        # completed-only slice would misalign the window when the bake
        # has failures and drop its earliest (often slowest) waits
        p99 = h.engine.stats.recent_wait_ms(served, 0.99)
        out["bake_wait_p99_ms"] = p99
        if base_p99 is None:
            return out      # no latency baseline: p99 gate skipped
        threshold = max(self.config.rollout_p99_floor_ms,
                        self.config.rollout_p99_factor * base_p99)
        if p99 > threshold:
            out["ok"] = False
            out["reason"] = (f"bake wait p99 {p99:.2f} ms exceeds "
                             f"{threshold:.2f} ms (baseline "
                             f"{base_p99:.2f} ms x "
                             f"{self.config.rollout_p99_factor})")
        return out

    def _rollback(self, swapped: List[tuple], version: str) -> None:
        """Flip every already-swapped replica back to its previous
        default (still registered + warm: the flip is instant), then
        retire the bad version everywhere."""
        self.stats.note_rollback()
        _flight.record("fleet", "rollout.rollback", severity="error",
                       version=version,
                       replicas=[h.name for h, _ in swapped])
        for h, prev in swapped:
            if prev is None or prev == version:
                continue
            h.engine.registry.set_default(prev)
            try:
                h.engine.registry.retire(
                    version, drain_timeout=self.config.drain_timeout_s)
            except (KeyError, ValueError):
                pass
        # rollback ends the incident the bake window caught: freeze the
        # chain (rollout.start -> verdicts -> rollback) on disk
        _flight.RECORDER.auto_dump(f"rollout rollback: {version}")

    # -- status (health.HealthServer serves this directly) -----------------
    def live(self) -> bool:
        return self._running and any(h.transport.live()
                                     for h in self.replica_handles())

    def ready(self) -> bool:
        return self._running and any(
            (not h.dead) and (not h.draining) and (not h.degraded)
            and h.transport.ready()
            for h in self.replica_handles())

    def status(self) -> Dict[str, Any]:
        """The aggregated fleet /statusz: FleetStats (failovers,
        breaker transitions, rollbacks, per-replica dispatch counts —
        snapshot_seq torn-read convention) alongside every replica's
        full per-engine snapshot (EngineStats + ScoringStats)."""
        from .health import telemetry_blocks
        replicas: Dict[str, Any] = {}
        default_version = None
        handles = self.replica_handles()
        for h in handles:
            # process_globals=False: the flight-recorder tail and
            # tracer counts are process-scoped — served ONCE below,
            # not repeated per replica
            try:
                snap = h.transport.status_snapshot(
                    process_globals=False)
            except Exception as e:  # noqa: BLE001 — a dead worker's
                # status RPC must not take the whole fleet /statusz
                # down with it; the supervision block still reports it
                snap = {"live": False, "ready": False,
                        "error": repr(e),
                        "transport": h.transport.describe()}
            snap["supervision"] = {"dead": h.dead,
                                   "draining": h.draining,
                                   "degraded": h.degraded,
                                   "restarts": h.restarts,
                                   "alive": h.transport.live()}
            replicas[h.name] = snap
            if default_version is None and not h.dead:
                default_version = snap.get("default_version")
        # the replicas= constructor arg overrides config.replicas for
        # topology: report the EFFECTIVE count so config and replica
        # list can never contradict each other in one snapshot (and an
        # elastic fleet's count moves for its whole life)
        cfg = self.config.as_dict()
        cfg["replicas"] = len(handles)
        # the transport= constructor arg overrides config.transport the
        # same way replicas= does: report the EFFECTIVE binding
        cfg["transport"] = self._transport_kind
        return {
            "live": self.live(),
            "ready": self.ready(),
            "time": time.time(),
            "replica_count": len(handles),
            "default_version": default_version,
            "fleet": self.stats.as_dict(),
            "breakers": self.router.breakers_dict(),
            "config": cfg,
            "replicas": replicas,
            **telemetry_blocks(),
        }
