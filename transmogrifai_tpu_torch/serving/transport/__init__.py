"""Replica transports: the fleet's seam between "a replica" and
"where that replica runs".

* ``inproc`` — a ServingEngine in this process (the default; zero
  behavior change from the pre-transport fleet).
* ``socket`` — an OS worker process behind the length-prefixed binary
  wire protocol (``wire.py``), provisioned/killed/restarted through
  :class:`~.tcp.ProcessWorkerTransport`.

Gray failures (slow/lossy/half-open links while liveness stays
green) are drilled through the deterministic ``netchaos`` shim at
the wire seam (``netchaos.py``).

See docs/SERVING.md § Cross-host serving.
"""
from . import netchaos
from .base import ReplicaTransport, TRANSPORT_KINDS
from .inproc import InprocTransport
from .tcp import ProcessWorkerTransport, SocketTransport, TransportConfig
from .wire import RemoteError, WireProtocolError, WorkerUnavailable

__all__ = [
    "ReplicaTransport", "TRANSPORT_KINDS", "InprocTransport",
    "SocketTransport", "ProcessWorkerTransport", "TransportConfig",
    "WireProtocolError", "WorkerUnavailable", "RemoteError",
    "netchaos",
]
