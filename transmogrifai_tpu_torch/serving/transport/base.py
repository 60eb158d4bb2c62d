"""Replica transport interface — the fleet's one seam to a replica.

Everything the fleet/router/autoscaler/supervisor stack does to a
replica goes through this surface: dispatch (``submit``), liveness
(``live``/``ready``), lifecycle (``start``/``stop``/``kill``),
admission repricing (``set_price``), and the sampled-stats reads the
autoscaler and rollout verdicts run on. Two bindings exist:

* :class:`~transmogrifai_tpu_torch.serving.transport.inproc.InprocTransport`
  wraps a local :class:`~transmogrifai_tpu_torch.serving.engine.ServingEngine`
  — zero behavior change from the pre-transport fleet; every existing
  fleet/autoscaler/rollout/chaos test runs against it unchanged.
* :class:`~transmogrifai_tpu_torch.serving.transport.tcp.ProcessWorkerTransport`
  owns an OS worker process (``python -m
  transmogrifai_tpu_torch.serving.worker``) plus a
  :class:`~transmogrifai_tpu_torch.serving.transport.tcp.SocketTransport`
  RPC client to it — the cross-host binding.

The contract the router depends on: ``submit`` returns a
``concurrent.futures.Future`` resolving to the engine's score dict,
and every failure mode surfaces as a classified exception from the
admission taxonomy (retryable vs terminal) — a dead worker means
in-flight futures FAIL with a retryable
:class:`~transmogrifai_tpu_torch.serving.transport.wire.WorkerUnavailable`,
never hang, which is what makes failover (and therefore kill-9
survival) possible.
"""
from __future__ import annotations

from concurrent.futures import Future
from typing import Any, Dict, Optional, Tuple

from ...telemetry import spans as _spans

__all__ = ["ReplicaTransport", "TRANSPORT_KINDS"]

#: the spellable bindings (TM_FLEET_TRANSPORT validates against this)
TRANSPORT_KINDS = ("inproc", "socket")


class ReplicaTransport:
    """Abstract replica transport. Subclasses implement every method;
    the base exists to document the contract in one place."""

    #: binding name ("inproc" | "socket")
    kind = "abstract"

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        """Bring the replica up (idempotent; a restart after ``kill``
        or a crash goes through here — the supervisor's one verb)."""
        raise NotImplementedError

    def stop(self, drain: bool = True,
             timeout: Optional[float] = None) -> None:
        """Graceful shutdown; ``drain=True`` scores what's queued."""
        raise NotImplementedError

    def kill(self) -> None:
        """Hard-kill, no drain, no goodbye — the chaos verb. For the
        socket binding this is a literal ``SIGKILL``."""
        raise NotImplementedError

    # -- dispatch --------------------------------------------------------

    def submit(self, data, deadline_ms: Optional[float] = None,
               trace=_spans.UNSET, priority: str = "normal",
               model: Optional[str] = None,
               tenant: Optional[str] = None) -> Future:
        """Score a batch; same signature and Future contract as
        ``ServingEngine.submit``."""
        raise NotImplementedError

    def cancel_request(self, fut: Future) -> bool:
        """Best-effort abandonment of an in-flight ``submit`` future
        (the hedging router cancels the losing speculative dispatch
        through here). Default: plain ``Future.cancel`` — succeeds
        only for work not yet running; the socket binding also drops
        the pending correlation entry so a late RESULT is ignored."""
        return bool(fut.cancel())

    # -- health ----------------------------------------------------------

    def live(self) -> bool:
        """Cheap local liveness (no RPC — the router calls this per
        candidate per dispatch). Socket binding: process alive AND
        heartbeat fresh."""
        raise NotImplementedError

    def ready(self) -> bool:
        """Accepting traffic and able to resolve the default model.
        May RPC; callers are the fleet's readiness gate, not the
        dispatch hot path."""
        raise NotImplementedError

    # -- admission control -----------------------------------------------

    def set_price(self, price: float) -> None:
        """Reprice the replica's admission controller (autoscaler
        backpressure)."""
        raise NotImplementedError

    # -- sampled stats (autoscaler / rollout verdict reads) --------------

    def load_gauges(self) -> Dict[str, Any]:
        raise NotImplementedError

    def outcome_counters(self) -> Dict[str, int]:
        raise NotImplementedError

    def recent_wait_ms(self, last_n: int, q: float) -> float:
        raise NotImplementedError

    def recent_outcomes(self, last_n: int) -> Tuple[int, int]:
        """(completed, failed) over the last ``last_n`` outcomes."""
        raise NotImplementedError

    # -- introspection ---------------------------------------------------

    def status_snapshot(self,
                        process_globals: bool = False) -> Dict[str, Any]:
        """The /statusz-shaped replica document (fleet.status() embeds
        one per replica)."""
        raise NotImplementedError

    def describe(self) -> Dict[str, Any]:
        """Small static identity block: kind, address, worker pid —
        what the flight recorder stamps on transport events."""
        return {"kind": self.kind}
