"""Serving for the port: the multi-model engine, its registry, and the
fleet tier around it.

* `engine.ServingEngine` — adaptive micro-batching with per-caller
  futures, weighted-fair tenant queues, cross-model co-batching and the
  fused cross-model plane (`EngineConfig(fused_kernel=True)`), whose
  stackable linear families score through the CUDA
  ``fused_linear_scores`` kernel; request taps (`add_tap`) and
  `status()`.
* `registry.ModelRegistry` — versioned models (saved workflows and
  portable artifacts on a device) with aliases, an LRU weight cache,
  load retries, a pre-publish lint gate, warmed zero-downtime hot-swap
  and in-flight draining; `build_registry` picks registry root vs
  single artifact.
* `admission.AdmissionController` — bounded queue backpressure,
  deadline shedding before device dispatch, EMA-based rejection.
* `health` — liveness/readiness, one merged, torn-read-detectable
  snapshot (`status_snapshot`) and `HealthServer` (/healthz, /readyz,
  /statusz, /metricsz).
* `fleet.ServingFleet` / `router.FleetRouter` — N supervised engine
  replicas on one device behind a shared-nothing router:
  consistent-hash placement, per-replica circuit breakers, hedging,
  hung-replica ejection, retry budgets, deadline-aware failover
  re-dispatch, staged rollout with automatic fleet-wide rollback, and
  deterministic request-plane chaos drills (TM_FAULTS serving.*).
* `shadow.ShadowScorer` — mirror live traffic onto a CANDIDATE model
  through the request taps; the continuum loop's pre-promotion gate.
* `autoscaler.FleetAutoscaler` — telemetry-driven replica scaling with
  hysteresis, Holt/EMA predictive pre-scaling and re-priced admission.
* `transport` — `inproc` (direct engine calls, the default) and
  `socket` (each replica an OS process running ``python -m
  transmogrifai_tpu_torch.serving.worker --device ...`` behind the
  length-prefixed wire protocol, byte-identical to the JAX package's).

Quickstart::

    from transmogrifai_tpu_torch.serving import ServingEngine
    with ServingEngine("artifact_dir", buckets=(16, 64)) as eng:
        fut = eng.submit({"x0": xs0, "x1": xs1})    # any thread
        scores = fut.result()                       # this request only

Fleet quickstart::

    from transmogrifai_tpu_torch.serving import ServingFleet
    with ServingFleet("saved_model_dir", replicas=4) as fleet:
        scores = fleet.score(rows)        # routed, breaker-guarded
        report = fleet.rollout("v2", new_model)   # staged, auto-rollback
        print(fleet.status()["fleet"]["failovers"])
"""
from .admission import (AdmissionController, DeadlineExpired,
                        DeadlineUnmeetable, EmaLatency, EngineClosed,
                        EngineStopped, QueueFull, RejectedError,
                        TenantBudgetExceeded)
from .autoscaler import (ArrivalForecast, FleetAutoscaler, ScalerConfig,
                         ScalingPolicy)
from .engine import EngineConfig, RequestTaps, ServingEngine
from .fleet import FleetConfig, ServingFleet
from .fusion import FusedGroupScorer, StackSpec, stack_spec_of
from .health import HealthServer, status_snapshot
from .registry import (ModelNotFound, ModelRegistry, ModelVersion,
                       build_registry)
from .router import (CircuitBreaker, EjectConfig, FleetRouter,
                     HedgeConfig, NoReplicaAvailable, RetryBudgetConfig)
from .shadow import ShadowScorer, shadow_backend
from .transport import (InprocTransport, ProcessWorkerTransport,
                        RemoteError, ReplicaTransport, SocketTransport,
                        TransportConfig, WireProtocolError,
                        WorkerUnavailable)

__all__ = [
    "AdmissionController", "DeadlineExpired", "DeadlineUnmeetable",
    "EmaLatency", "EngineClosed", "EngineStopped", "QueueFull",
    "RejectedError", "TenantBudgetExceeded", "EngineConfig",
    "RequestTaps", "ServingEngine", "HealthServer", "status_snapshot",
    "ModelNotFound", "ModelRegistry", "ModelVersion", "build_registry",
    "FleetConfig", "ServingFleet", "CircuitBreaker", "FleetRouter",
    "NoReplicaAvailable", "HedgeConfig", "EjectConfig",
    "RetryBudgetConfig", "ShadowScorer", "shadow_backend",
    "ArrivalForecast", "FleetAutoscaler", "ScalerConfig",
    "ScalingPolicy", "ReplicaTransport", "InprocTransport",
    "SocketTransport", "ProcessWorkerTransport", "TransportConfig",
    "WireProtocolError", "WorkerUnavailable", "RemoteError",
    "FusedGroupScorer", "StackSpec", "stack_spec_of",
]
