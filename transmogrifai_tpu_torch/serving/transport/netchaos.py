"""Deterministic network chaos at the wire seam.

The transport fault points (``serving.transport.{connect,send,
recv}``) sever a connection cleanly — the CRASH regime. Production
fleets die of the GRAY regime instead: a link that is slow, lossy, or
half-open while the liveness signal stays green. This shim injects
exactly that, seeded and reproducible like everything else in
``resilience/faults.py``: it wraps the two frame-I/O edges of
:class:`~.tcp.SocketTransport` and consults
:func:`~...resilience.faults.fault_action` on every DATA frame, then
applies the matched ``net-*`` kind against the real socket.

Heartbeat frames (PING/PONG) are exempt from both arrival counting
and every effect: the gray regime is precisely "liveness fresh, data
path degraded", and heartbeats are clock-driven — counting them would
destroy the nth-arrival determinism the TM_FAULTS grammar promises.
The one deliberate exception is ``net-stall``, which wedges the
socket mid-frame while HOLDING the send lock, so the heartbeat sender
starves and the classified teardown path (heartbeat expiry →
disconnect → retryable failover) fires — the torn-frame drill.

Kinds (spec arg in parentheses):

* ``net-delay`` (seconds, default 0.05) — per-frame latency with a
  deterministic jitter factor in [0.5, 1.5) derived from
  blake2b(point|arrival); injected BEFORE the send lock so heartbeats
  are never delayed.
* ``net-throttle`` (bytes/s) — the frame trickles out/in at the given
  bandwidth (chunked sends with proportional sleeps).
* ``net-stall`` (seconds, default 30) — send side writes HALF the
  frame then sleeps holding the send lock and raises ConnectionError;
  recv side sleeps then raises WireProtocolError. Either way the
  future fails classified, never hangs.
* ``net-drop`` — the frame silently vanishes (send: swallowed; recv:
  discarded and the next frame is read). With ``nth=N`` this is one
  lost frame; the request it carried is rescued only by hedging or a
  deadline — exactly the failure hedged requests exist for.
* ``net-corrupt`` (XOR byte, default 0xFF) — flips the last payload
  byte (or the magic, for empty payloads): the wire-v2 payload crc
  catches it on whichever side reads the frame, raising a loud
  :class:`~.wire.WireProtocolError` that tears the connection down —
  in-flight futures fail retryable, never resolve to a wrong score.
* ``net-partition`` — the one-way partition: with ``1+`` on
  ``serving.transport.net.recv`` every data frame is blackholed
  forever while PONGs keep passing, so ``live()`` stays True and only
  the hung-replica ejector can see the stall. This is the half-open
  case the PING/PONG generation gating in tcp.py was built for.

Scoping: TM_FAULTS is process-global, but a gray drill wedges ONE
replica of a fleet. :func:`scoped` restricts chaos consultation to
transports whose replica name matches; frames of un-scoped transports
pass through UNCOUNTED, so the victim's nth-arrival sequence stays
deterministic under a multi-replica storm.
"""
from __future__ import annotations

import hashlib
import threading
import time
import zlib
from typing import Optional, Tuple

from ...resilience.faults import FaultSpec, fault_action
from . import wire

__all__ = ["send_frame", "read_frame", "scoped", "set_scope",
           "POINT_SEND", "POINT_RECV"]

POINT_SEND = "serving.transport.net.send"
POINT_RECV = "serving.transport.net.recv"

#: frame types the shim acts on; PING/PONG are the liveness plane and
#: stay exempt (see module docstring)
_DATA_TYPES = frozenset((wire.T_SUBMIT, wire.T_RESULT, wire.T_ERROR,
                         wire.T_CONTROL, wire.T_REPLY))

_SCOPE_LOCK = threading.Lock()
_SCOPE: Optional[str] = None


def set_scope(replica: Optional[str]) -> None:
    """Restrict chaos to the named replica (None = all transports)."""
    global _SCOPE
    with _SCOPE_LOCK:
        _SCOPE = replica


class scoped:
    """Context manager form of :func:`set_scope`::

        with netchaos.scoped("w1"), faults.active(
                "serving.transport.net.recv:net-partition:1+"):
            ...
    """

    def __init__(self, replica: Optional[str]):
        self.replica = replica

    def __enter__(self):
        set_scope(self.replica)
        return self

    def __exit__(self, *exc):
        set_scope(None)
        return False


def _in_scope(replica: Optional[str]) -> bool:
    with _SCOPE_LOCK:
        scope = _SCOPE
    return scope is None or replica == scope


def _jitter(point: str, arrival: int) -> float:
    """Deterministic per-arrival jitter factor in [0.5, 1.5)."""
    digest = hashlib.blake2b(f"{point}|{arrival}".encode("utf-8"),
                             digest_size=8).digest()
    return 0.5 + int.from_bytes(digest, "big") / float(1 << 64)


def _seconds(spec: FaultSpec, default: float) -> float:
    return float(spec.arg) if spec.arg is not None else default


def _corrupted(frame: bytes, spec: FaultSpec) -> bytes:
    """Flip one byte so the receiving decoder fails LOUDLY: the last
    payload byte when there is a payload, else the frame magic."""
    xor = int(spec.arg) if spec.arg is not None else 0xFF
    buf = bytearray(frame)
    idx = len(buf) - 1 if len(buf) > wire.HEADER.size else 0
    buf[idx] ^= (xor or 0xFF) & 0xFF
    return bytes(buf)


# -- send side -----------------------------------------------------------

def send_frame(sock, frame: bytes, send_lock, *,
               replica: Optional[str] = None,
               addr: Optional[str] = None) -> None:
    """Write one frame through the chaos shim. Heartbeats and
    out-of-scope transports bypass (and are not counted)."""
    ftype = frame[3] if len(frame) >= wire.HEADER.size else None
    hit = None
    if ftype in _DATA_TYPES and _in_scope(replica):
        hit = fault_action("serving.transport.net.send",
                           replica=replica, addr=addr,
                           frame_type=ftype, frame_bytes=len(frame))
    if hit is None:
        with send_lock:
            sock.sendall(frame)
        return
    spec, arrival = hit
    if spec.kind in ("net-drop", "net-partition"):
        return                  # swallowed: the worker never sees it
    if spec.kind == "net-delay":
        # sleep BEFORE taking the send lock: latency shapes data
        # frames only, heartbeats keep their cadence
        time.sleep(_seconds(spec, 0.05) * _jitter(POINT_SEND, arrival))
        with send_lock:
            sock.sendall(frame)
        return
    if spec.kind == "net-corrupt":
        with send_lock:
            sock.sendall(_corrupted(frame, spec))
        return
    if spec.kind == "net-throttle":
        rate = max(1.0, _seconds(spec, 1 << 20))
        with send_lock:
            for chunk in _chunks(frame):
                sock.sendall(chunk)
                time.sleep(len(chunk) / rate)
        return
    if spec.kind == "net-stall":
        # the torn-frame wedge: half a frame on the wire, then a long
        # silence HOLDING the send lock (heartbeats starve too — the
        # liveness clock goes stale and tears the connection down),
        # then a classified error, never a hung future
        with send_lock:
            sock.sendall(frame[:max(1, len(frame) // 2)])
            time.sleep(_seconds(spec, 30.0))
        raise ConnectionError(
            f"netchaos: mid-frame stall on send to {replica}")
    raise AssertionError(f"unhandled net kind {spec.kind}")


def _chunks(frame: bytes, size: int = 4096):
    for off in range(0, len(frame), size):
        yield frame[off:off + size]


# -- recv side -----------------------------------------------------------

def read_frame(sock, *, replica: Optional[str] = None,
               addr: Optional[str] = None) -> Tuple[int, int, bytes]:
    """Read one frame through the chaos shim. PING/PONG pass through
    untouched and uncounted; a blackholed data frame (drop/partition)
    is discarded and the NEXT frame is read — which is what keeps the
    heartbeat fresh while every response vanishes."""
    while True:
        ftype, corr, payload = wire.read_frame(sock)
        if ftype not in _DATA_TYPES or not _in_scope(replica):
            return ftype, corr, payload
        hit = fault_action("serving.transport.net.recv",
                           replica=replica, addr=addr,
                           frame_type=ftype, frame_bytes=len(payload))
        if hit is None:
            return ftype, corr, payload
        spec, arrival = hit
        if spec.kind in ("net-drop", "net-partition"):
            continue            # blackholed; PONGs still flow
        if spec.kind == "net-delay":
            time.sleep(_seconds(spec, 0.05)
                       * _jitter(POINT_RECV, arrival))
            return ftype, corr, payload
        if spec.kind == "net-throttle":
            rate = max(1.0, _seconds(spec, 1 << 20))
            time.sleep((wire.HEADER.size + len(payload)) / rate)
            return ftype, corr, payload
        if spec.kind == "net-corrupt":
            # flip a payload byte and push the torn bytes through the
            # SAME crc gate the real read path applies (wire.read_frame
            # verified the pristine payload before this shim saw it):
            # corruption surfaces as the classified WireProtocolError
            # a flipped bit on the actual wire would produce — loud,
            # connection-fatal, never a silently wrong score.
            xor = (int(spec.arg) if spec.arg is not None else 0xFF) \
                or 0xFF
            torn = (payload[:-1] + bytes([payload[-1] ^ (xor & 0xFF)])
                    if payload else b"\xff")
            wire.check_crc(
                torn, zlib.crc32(payload) & 0xFFFFFFFF, ftype)
            raise AssertionError(
                "netchaos: corrupted payload passed its crc")
        if spec.kind == "net-stall":
            time.sleep(_seconds(spec, 30.0))
            raise wire.WireProtocolError(
                f"netchaos: mid-frame stall on recv from {replica}")
        raise AssertionError(f"unhandled net kind {spec.kind}")
