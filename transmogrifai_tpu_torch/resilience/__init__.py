"""Resilience: the pieces of ``transmogrifai_tpu.resilience`` the
ported serving and training paths use.

* ``atomic`` — the atomic file write (the selector's fit checkpoint)
  and the ``_SUCCESS`` completeness sentinel every loader checks.
* ``config`` — the shared STRICT env-knob parser (unknown name or
  unparsable value raises).
* ``faults`` — the deterministic fault-injection harness
  (``TM_FAULTS="point:kind:nth[:arg]"``); the engine's dispatch and the
  registry's load pass its injection points.
"""
from .atomic import (IncompleteArtifactError, SENTINEL, atomic_write_json,
                     require_complete)
from .config import parse_env_fields
from .faults import (FaultError, PartialWriteFault, TransientFaultError,
                     fault_point)

__all__ = [
    "IncompleteArtifactError", "SENTINEL", "atomic_write_json",
    "require_complete",
    "parse_env_fields", "FaultError", "PartialWriteFault",
    "TransientFaultError", "fault_point",
]
