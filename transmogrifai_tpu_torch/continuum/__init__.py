"""Self-healing continuous-learning loop.

The robustness capstone composing everything the stack already ships:
RawFeatureFilter's drift statistics become a STREAMING monitor over
serving traffic (monitor.py), a sustained drift breach triggers an
incremental checkpointed ``Workflow.train`` retrain that survives
mid-train kills (the train checkpoint/resume + RetryPolicy), the
candidate is lint-gated and SHADOW-SCORED against the live default on
mirrored traffic (serving/shadow.py — candidate scores are never
returned to callers), and a passing candidate promotes through the
fleet's staged rollout with its bake-window auto-rollback inherited
verbatim. Every transition is a deterministic TM_FAULTS
surface (``continuum.monitor.observe`` / ``continuum.retrain.launch`` /
``continuum.shadow.score`` / ``continuum.promote``).

Quickstart::

    from transmogrifai_tpu_torch.continuum import (
        ContinuumConfig, ContinuumController, DriftConfig)
    from transmogrifai_tpu_torch.serving import ServingFleet

    with ServingFleet(model, replicas=4) as fleet:
        loop = ContinuumController(
            fleet, model,
            workflow_factory=build_workflow,    # fresh Workflow per cycle
            train_data=reader,                  # or a zero-arg callable
            drift_config=DriftConfig(threshold=0.2),
        )
        with loop:                              # monitor -> retrain ->
            serve_forever()                     # gate -> promote -> ...
        print(loop.status()["continuum"]["stats"])

Operations: docs/CONTINUUM.md. Knobs: ``TM_DRIFT_*`` (detection
thresholds) and ``TM_CONTINUUM_*`` (loop/gate/promotion), both parsed
STRICTLY — a typo'd knob raises instead of silently disabling a gate.
"""
from .controller import ContinuumConfig, ContinuumController
from .monitor import (DriftConfig, DriftMonitor, MonitorTick,
                      baseline_from_data, baseline_from_model)

__all__ = [
    "ContinuumConfig", "ContinuumController",
    "DriftConfig", "DriftMonitor", "MonitorTick",
    "baseline_from_data", "baseline_from_model",
]
