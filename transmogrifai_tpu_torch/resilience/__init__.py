"""Resilience: the port's copy of ``transmogrifai_tpu.resilience``.

* ``atomic`` — the tmp+fsync+rename artifact write path and the
  ``_SUCCESS`` completeness sentinel every loader checks.
* ``checkpoint`` — durable layer-level ``Workflow.train`` checkpoint/
  resume with fingerprint drift rejection (``TM_TRAIN_CKPT``).
* ``config`` — the shared STRICT env-knob parser (unknown name or
  unparsable value raises).
* ``faults`` — the deterministic fault-injection harness
  (``TM_FAULTS="point:kind:nth[:arg]"``); the engine's dispatch, the
  registry's load and the training executor pass its injection points.
* ``policy`` — ``RetryPolicy`` (bounded attempts, seeded backoff,
  wall-clock watchdog) and ``failure_policy="degrade"`` stages
  (``TM_TRAIN_RETRIES`` / ``TM_STAGE_TIMEOUT_S``).
"""
from .atomic import (IncompleteArtifactError, SENTINEL, atomic_file,
                     atomic_write_bytes, atomic_write_json,
                     atomic_write_npz, clear_complete, is_complete,
                     mark_complete, require_complete)
from .checkpoint import (CheckpointMismatch, TrainCheckpoint,
                         resolve_checkpoint_dir, train_fingerprint)
from .config import parse_env_fields
from .faults import (FaultError, PartialWriteFault, TransientFaultError,
                     fault_point)
from .policy import (NO_RETRY, RetriesExhausted, RetryPolicy,
                     StageTimeoutError, is_retryable,
                     resolve_train_policy)

__all__ = [
    "IncompleteArtifactError", "SENTINEL", "atomic_file",
    "atomic_write_bytes", "atomic_write_json", "atomic_write_npz",
    "clear_complete", "is_complete", "mark_complete", "require_complete",
    "CheckpointMismatch", "TrainCheckpoint", "resolve_checkpoint_dir",
    "train_fingerprint",
    "FaultError", "PartialWriteFault", "TransientFaultError",
    "fault_point",
    "NO_RETRY", "RetriesExhausted", "RetryPolicy", "StageTimeoutError",
    "is_retryable", "resolve_train_policy",
    "parse_env_fields",
]
