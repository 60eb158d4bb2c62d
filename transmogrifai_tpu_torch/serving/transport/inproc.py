"""In-process transport binding — today's fleet, behind the seam.

Wraps a local :class:`~transmogrifai_tpu_torch.serving.engine.ServingEngine`
and forwards every transport verb to it directly. This binding is
deliberately trivial: the transport refactor must be
behavior-preserving for the single-process fleet, and every line here
that did more than delegate would be a place for the two bindings to
drift. The handle keeps exposing ``.engine`` for inproc replicas, so
rollout (hot_swap) and the engine-level taps keep working exactly as
before.
"""
from __future__ import annotations

from concurrent.futures import Future
from typing import Any, Dict, Optional, Tuple

from ...telemetry import spans as _spans
from ..health import status_snapshot
from .base import ReplicaTransport

__all__ = ["InprocTransport"]


class InprocTransport(ReplicaTransport):
    """Transport over a ServingEngine living in this process."""

    kind = "inproc"

    def __init__(self, engine):
        self.engine = engine

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        self.engine.start()

    def stop(self, drain: bool = True,
             timeout: Optional[float] = None) -> None:
        self.engine.stop(drain=drain, timeout=timeout)

    def kill(self) -> None:
        self.engine.stop(drain=False, timeout=0)

    # -- dispatch --------------------------------------------------------

    def submit(self, data, deadline_ms: Optional[float] = None,
               trace=_spans.UNSET, priority: str = "normal",
               model: Optional[str] = None,
               tenant: Optional[str] = None) -> Future:
        return self.engine.submit(data, deadline_ms=deadline_ms,
                                  trace=trace, priority=priority,
                                  model=model, tenant=tenant)

    # -- health ----------------------------------------------------------

    def live(self) -> bool:
        return self.engine.live()

    def ready(self) -> bool:
        return self.engine.ready()

    # -- admission control -----------------------------------------------

    def set_price(self, price: float) -> None:
        self.engine.admission.set_price(price)

    # -- sampled stats ---------------------------------------------------

    def load_gauges(self) -> Dict[str, Any]:
        return self.engine.stats.load_gauges()

    def outcome_counters(self) -> Dict[str, int]:
        return self.engine.stats.outcome_counters()

    def recent_wait_ms(self, last_n: int, q: float) -> float:
        return self.engine.stats.recent_wait_ms(last_n, q)

    def recent_outcomes(self, last_n: int) -> Tuple[int, int]:
        return self.engine.stats.recent_outcomes(last_n)

    # -- introspection ---------------------------------------------------

    def status_snapshot(self,
                        process_globals: bool = False) -> Dict[str, Any]:
        return status_snapshot(self.engine,
                               process_globals=process_globals)

    def describe(self) -> Dict[str, Any]:
        return {"kind": self.kind}
