"""In-process serving for the port: the multi-model engine over the
portable-artifact registry.

* `engine.ServingEngine` — adaptive micro-batching with per-caller
  futures, weighted-fair tenant queues, cross-model co-batching and the
  fused cross-model plane (`EngineConfig(fused_kernel=True)`), whose
  stackable linear families score through the CUDA
  ``fused_linear_scores`` kernel.
* `registry.ModelRegistry` — versioned models (portable artifacts on a
  device) with aliases, an LRU weight cache, warmed zero-downtime
  hot-swap and in-flight draining; `build_registry` picks registry root
  vs single artifact.
* `admission.AdmissionController` — bounded queue backpressure,
  deadline shedding before device dispatch, EMA-based rejection.

Quickstart::

    from transmogrifai_tpu_torch.serving import ServingEngine
    with ServingEngine("artifact_dir", buckets=(16, 64)) as eng:
        fut = eng.submit({"x0": xs0, "x1": xs1})    # any thread
        scores = fut.result()                       # this request only

The fleet, router, transports, autoscaler, health server and continuum
loop of the JAX package are not ported yet.
"""
from .admission import (AdmissionController, DeadlineExpired,
                        DeadlineUnmeetable, EngineClosed, EngineStopped,
                        QueueFull, TenantBudgetExceeded)
from .engine import EngineConfig, ServingEngine
from .fusion import FusedGroupScorer, StackSpec, stack_spec_of
from .registry import (ModelNotFound, ModelRegistry, ModelVersion,
                       build_registry)

__all__ = [
    "AdmissionController", "DeadlineExpired", "DeadlineUnmeetable",
    "EngineClosed", "EngineStopped", "QueueFull", "TenantBudgetExceeded",
    "EngineConfig", "ServingEngine",
    "FusedGroupScorer", "StackSpec", "stack_spec_of",
    "ModelNotFound", "ModelRegistry", "ModelVersion", "build_registry",
]
