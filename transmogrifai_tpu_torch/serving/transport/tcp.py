"""Socket transport binding — real RPC to an OS worker process.

Two classes:

* :class:`SocketTransport` — the wire client. ``submit`` encodes the
  batch, registers a Future under a fresh correlation id, and writes
  one frame; a reader thread resolves futures as RESULT/ERROR frames
  arrive, and a heartbeat thread keeps PING/PONG liveness fresh so
  ``live()`` is a pair of timestamp reads, never an RPC (the router
  calls it per candidate per dispatch). Losing the connection fails
  every in-flight future with a retryable
  :class:`~.wire.WorkerUnavailable` — the router fails them over, which
  is the zero accepted-request-loss invariant — and (for a standalone
  client) starts a bounded reconnect loop with deterministic backoff.
* :class:`ProcessWorkerTransport` — owns the worker process too:
  spawns ``python -m transmogrifai_tpu_torch.serving.worker``, pins it to a
  device subset via ``TM_MESH_DEVICES``, discovers the bound port via
  a port file, and wraps a SocketTransport to it. ``kill()`` is a
  literal SIGKILL (the chaos drill); ``start()`` is re-entrant, so the
  fleet supervisor's existing restart branch respawns a dead worker
  through the same verb it always used.

Fault points: ``serving.transport.{connect,send,recv}`` wrap the three
I/O edges, so drills can sever any of them via ``TM_FAULTS`` without a
real network. The GRAY failure modes (slow, lossy, half-open — link
degraded while liveness stays green) ride the netchaos shim instead:
both frame-I/O edges route through ``netchaos.send_frame`` /
``netchaos.read_frame``, which consult the
``serving.transport.net.{send,recv}`` points per DATA frame and apply
the matched ``net-*`` kind against the real socket (see netchaos.py).
"""
from __future__ import annotations

import itertools
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, Optional, Tuple

from ...profiling import TransportStats
from ...resilience.config import parse_env_fields
from ...resilience.faults import fault_point
from ...telemetry import spans as _spans
from ...telemetry.recorder import RECORDER
from ...telemetry.spans import TRACER
from ..admission import EngineClosed
from . import netchaos, wire
from .base import ReplicaTransport

__all__ = ["TransportConfig", "SocketTransport",
           "ProcessWorkerTransport"]

#: TM_TRANSPORT_* env knobs (strict parse_env_fields catalog): the
#: socket-binding client surface — heartbeat cadence, liveness window,
#: connect/reconnect bounds, control-RPC timeout, worker spawn budget.
_ENV_FIELDS: Dict[str, tuple] = {
    "TM_TRANSPORT_HEARTBEAT_S": ("heartbeat_s", float),
    "TM_TRANSPORT_LIVENESS_TIMEOUT_S": ("liveness_timeout_s", float),
    "TM_TRANSPORT_CONNECT_ATTEMPTS": ("connect_attempts", int),
    "TM_TRANSPORT_CONNECT_BACKOFF_S": ("connect_backoff_s", float),
    "TM_TRANSPORT_CONNECT_TIMEOUT_S": ("connect_timeout_s", float),
    "TM_TRANSPORT_CALL_TIMEOUT_S": ("call_timeout_s", float),
    "TM_TRANSPORT_RECONNECT_ATTEMPTS": ("reconnect_attempts", int),
    "TM_TRANSPORT_SPAWN_TIMEOUT_S": ("spawn_timeout_s", float),
}


class TransportConfig:
    """Socket-transport client tuning (see ``_ENV_FIELDS``)."""

    def __init__(self, heartbeat_s: float = 0.25,
                 liveness_timeout_s: float = 2.0,
                 connect_attempts: int = 3,
                 connect_backoff_s: float = 0.05,
                 connect_timeout_s: float = 5.0,
                 call_timeout_s: float = 15.0,
                 reconnect_attempts: int = 6,
                 spawn_timeout_s: float = 120.0):
        if heartbeat_s <= 0:
            raise ValueError("heartbeat_s must be > 0")
        if liveness_timeout_s <= heartbeat_s:
            # a liveness window shorter than one heartbeat period
            # declares every healthy worker dead between beats
            raise ValueError(
                "liveness_timeout_s must exceed heartbeat_s")
        if connect_attempts < 1:
            raise ValueError("connect_attempts must be >= 1")
        self.heartbeat_s = float(heartbeat_s)
        self.liveness_timeout_s = float(liveness_timeout_s)
        self.connect_attempts = int(connect_attempts)
        self.connect_backoff_s = float(connect_backoff_s)
        self.connect_timeout_s = float(connect_timeout_s)
        self.call_timeout_s = float(call_timeout_s)
        self.reconnect_attempts = int(reconnect_attempts)
        self.spawn_timeout_s = float(spawn_timeout_s)

    @classmethod
    def from_env(cls, environ: Optional[Dict[str, str]] = None,
                 **overrides) -> "TransportConfig":
        # TM_TRANSPORT_HEDGE_* nests under this prefix but belongs to
        # the router's HedgeConfig — skip it here or the strict parse
        # rejects a perfectly-spelled hedge knob as an unknown one
        fields = parse_env_fields("TM_TRANSPORT_", _ENV_FIELDS,
                                  what="transport env var",
                                  environ=environ,
                                  ignore=("TM_TRANSPORT_HEDGE_",))
        fields.update(overrides)
        return cls(**fields)

    def as_dict(self) -> Dict[str, Any]:
        return dict(vars(self))


def _resolve(fut: Future, value=None, exc: Optional[BaseException] = None
             ) -> None:
    """Resolve a pending RPC future exactly once, tolerating a caller
    that already cancelled it."""
    if not fut.set_running_or_notify_cancel():
        return
    if exc is not None:
        fut.set_exception(exc)
    else:
        fut.set_result(value)


class _Pending:
    """One in-flight RPC: its future, wall anchor, and trace id."""
    __slots__ = ("kind", "future", "t0", "trace")

    def __init__(self, kind: str, future: Future, t0: float,
                 trace: Optional[str]):
        self.kind = kind
        self.future = future
        self.t0 = t0
        self.trace = trace


class SocketTransport(ReplicaTransport):
    """Wire-protocol RPC client to one worker's listener."""

    kind = "socket"

    def __init__(self, host: str, port: int, *, name: str = "worker",
                 config: Optional[TransportConfig] = None,
                 stats: Optional[TransportStats] = None,
                 worker_pid: Optional[int] = None,
                 auto_reconnect: bool = True):
        self.host = str(host)
        self.port = int(port)
        self.name = str(name)
        self.config = config or TransportConfig.from_env()
        self.stats = stats if stats is not None else TransportStats()
        self.worker_pid = worker_pid
        self.auto_reconnect = bool(auto_reconnect)
        self._sock: Optional[socket.socket] = None
        self._pending: Dict[int, _Pending] = {}
        self._corr = itertools.count(1)
        self._send_lock = threading.Lock()
        self._life = threading.RLock()
        self._connected = False
        self._closed = False
        self._generation = 0
        self._last_pong = 0.0
        #: set by stop()/kill() to interrupt a reconnect backoff —
        #: a transport closed mid-backoff returns within one
        #: heartbeat period, not one full backoff
        self._wake = threading.Event()

    # -- identity --------------------------------------------------------

    def describe(self) -> Dict[str, Any]:
        return {"kind": self.kind, "addr": f"{self.host}:{self.port}",
                "worker": (f"{self.name}@{self.worker_pid}"
                           if self.worker_pid else self.name)}

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        self.connect()

    def connect(self) -> None:
        """Dial the worker (bounded attempts, deterministic backoff);
        raises :class:`~.wire.WorkerUnavailable` when every attempt is
        refused."""
        with self._life:
            if self._closed:
                raise EngineClosed(f"transport to {self.name} is closed")
            if self._connected:
                return
            last: Optional[BaseException] = None
            for attempt in range(1, self.config.connect_attempts + 1):
                try:
                    fault_point("serving.transport.connect",
                                replica=self.name,
                                addr=f"{self.host}:{self.port}",
                                attempt=attempt)
                    sock = socket.create_connection(
                        (self.host, self.port),
                        timeout=self.config.connect_timeout_s)
                    sock.settimeout(None)
                    sock.setsockopt(socket.IPPROTO_TCP,
                                    socket.TCP_NODELAY, 1)
                except Exception as e:  # OSError or an armed fault
                    last = e
                    if attempt < self.config.connect_attempts:
                        time.sleep(self.config.connect_backoff_s
                                   * attempt)
                    continue
                self._sock = sock
                self._generation += 1
                self._connected = True
                self._last_pong = time.monotonic()
                gen = self._generation
                threading.Thread(
                    target=self._read_loop, args=(sock, gen),
                    daemon=True,
                    name=f"tm-transport-read[{self.name}]").start()
                threading.Thread(
                    target=self._heartbeat_loop, args=(sock, gen),
                    daemon=True,
                    name=f"tm-transport-beat[{self.name}]").start()
                RECORDER.record(
                    "transport",
                    "connect" if gen == 1 else "reconnect",
                    **self.describe())
                if gen > 1:
                    self.stats.note_reconnect()
                return
            raise wire.WorkerUnavailable(
                f"cannot connect to worker {self.name} at "
                f"{self.host}:{self.port} after "
                f"{self.config.connect_attempts} attempts: {last}")

    def stop(self, drain: bool = True,
             timeout: Optional[float] = None) -> None:
        with self._life:
            self._closed = True
            connected = self._connected
        self._wake.set()
        if connected:
            try:
                self.control("stop", timeout=timeout, drain=bool(drain))
            except Exception:
                pass            # worker may exit before the ack lands
        self._disconnect("stopped")

    def kill(self) -> None:
        """Client-side kill: sever the connection, fail in-flight."""
        with self._life:
            self._closed = True
        self._wake.set()
        self._disconnect("killed")

    # -- wire I/O --------------------------------------------------------

    def _send_frame(self, frame: bytes) -> None:
        with self._life:
            if not self._connected or self._sock is None:
                raise wire.WorkerUnavailable(
                    f"worker {self.name} is not connected")
            sock = self._sock
        try:
            fault_point("serving.transport.send", replica=self.name,
                        addr=f"{self.host}:{self.port}")
            netchaos.send_frame(sock, frame, self._send_lock,
                                replica=self.name,
                                addr=f"{self.host}:{self.port}")
        except OSError as e:
            self._disconnect(f"send failed: {e}")
            raise wire.WorkerUnavailable(
                f"worker {self.name} connection lost on send: {e}"
            ) from e

    def _read_loop(self, sock: socket.socket, gen: int) -> None:
        try:
            while True:
                fault_point("serving.transport.recv",
                            replica=self.name,
                            addr=f"{self.host}:{self.port}")
                ftype, corr, payload = netchaos.read_frame(
                    sock, replica=self.name,
                    addr=f"{self.host}:{self.port}")
                self._on_frame(sock, gen, ftype, corr, payload)
        except Exception as e:  # noqa: BLE001 — any tear ends the conn
            self._disconnect(f"recv failed: {e}", gen=gen)

    def _heartbeat_loop(self, sock: socket.socket, gen: int) -> None:
        ping = wire.encode_frame(wire.T_PING, 0)
        while True:
            time.sleep(self.config.heartbeat_s)
            with self._life:
                if self._generation != gen or not self._connected:
                    return
                stale = (time.monotonic() - self._last_pong
                         > self.config.liveness_timeout_s)
            if stale:
                self._disconnect("heartbeat expired", gen=gen)
                return
            try:
                with self._send_lock:
                    sock.sendall(ping)
            except OSError:
                return          # the reader notices and tears down

    def _on_frame(self, sock: socket.socket, gen: int, ftype: int,
                  corr: int, payload: bytes) -> None:
        if ftype == wire.T_PONG:
            with self._life:
                # generation-gated: a late PONG delivered by a
                # PREVIOUS connection's read loop (buffered frames
                # drain after the reconnect swapped _generation) must
                # not freshen the CURRENT connection's liveness clock
                # — it would mask a dead socket past the heartbeat
                # expiry, the same stale-generation class as the
                # _disconnect(gen=...) guard
                if self._generation == gen:
                    self._last_pong = time.monotonic()
            return
        if ftype == wire.T_PING:
            # reply on the socket the PING ARRIVED on — reading
            # self._sock here would race the reconnect path swapping
            # it, and answer for the wrong connection when it lost
            try:
                with self._send_lock:
                    sock.sendall(wire.encode_frame(wire.T_PONG, 0))
            except OSError:
                pass
            return
        with self._life:
            pend = self._pending.pop(corr, None)
        if pend is None:
            return              # late frame for a failed-over request
        if ftype == wire.T_RESULT:
            try:
                scores, engine_s = wire.decode_result(payload)
            except wire.WireProtocolError as e:
                _resolve(pend.future, exc=e)
                raise
            t1 = time.monotonic()
            rtt = t1 - pend.t0
            overhead = rtt - engine_s if engine_s is not None else rtt
            overhead = max(0.0, overhead)
            self.stats.note_roundtrip(rtt, overhead)
            if pend.trace is not None:
                TRACER.record(pend.trace, "transport.wire", pend.t0, t1,
                              cat="transport", replica=self.name,
                              worker=self.describe()["worker"],
                              wire_us=round(overhead * 1e6, 1))
            _resolve(pend.future, value=scores)
        elif ftype == wire.T_ERROR:
            self.stats.note_error()
            try:
                exc: BaseException = wire.decode_error(payload)
            except wire.WireProtocolError as e:
                # a corrupt ERROR frame must still resolve its future
                # (classified), never leave it hanging after the
                # pending entry was already popped
                _resolve(pend.future, exc=e)
                raise
            _resolve(pend.future, exc=exc)
        elif ftype == wire.T_REPLY:
            try:
                reply = wire.decode_reply(payload)
            except wire.WireProtocolError as e:
                _resolve(pend.future, exc=e)
                raise
            _resolve(pend.future, value=reply)
        else:
            _resolve(pend.future, exc=wire.WireProtocolError(
                f"unexpected frame type {ftype} for correlation "
                f"{corr}"))

    def _disconnect(self, reason: str,
                    gen: Optional[int] = None) -> None:
        with self._life:
            if gen is not None and self._generation != gen:
                return          # a newer connection already exists
            if not self._connected and self._sock is None:
                return
            self._connected = False
            sock, self._sock = self._sock, None
            dropped = list(self._pending.values())
            self._pending.clear()
            closed = self._closed
            # record the tear while still holding the life lock,
            # BEFORE any dropped future resolves: everything downstream
            # (router failover, submit() refusals — both gated on the
            # _connected flip above) must sequence AFTER this event, or
            # a post-incident dump shows the reactions before the cause
            self.stats.note_disconnect()
            RECORDER.record("transport", "disconnect",
                            severity="warning", reason=reason,
                            in_flight=len(dropped), **self.describe())
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        exc = wire.WorkerUnavailable(
            f"worker {self.name} connection lost: {reason}")
        # futures resolve OUTSIDE the lock: a failover callback may
        # re-submit to this very transport, which takes the life lock
        for pend in dropped:
            _resolve(pend.future, exc=exc)
        if self.auto_reconnect and not closed \
                and self.config.reconnect_attempts > 0:
            threading.Thread(
                target=self._reconnect_loop, daemon=True,
                name=f"tm-transport-redial[{self.name}]").start()

    def _reconnect_loop(self) -> None:
        """Bounded redial with linear backoff; gives up after
        ``reconnect_attempts`` (the supervisor owns recovery past
        that). The backoff waits on ``_wake`` instead of sleeping so
        ``stop()``/``kill()`` mid-backoff returns immediately — a
        closed transport must not hold a redial thread for a full
        backoff period."""
        for attempt in range(1, self.config.reconnect_attempts + 1):
            if self._wake.wait(self.config.connect_backoff_s * attempt):
                return          # closed mid-backoff
            with self._life:
                if self._closed or self._connected:
                    return
            try:
                self.connect()
                return
            except Exception:
                continue

    # -- dispatch --------------------------------------------------------

    def submit(self, data, deadline_ms: Optional[float] = None,
               trace=_spans.UNSET, priority: str = "normal",
               model: Optional[str] = None,
               tenant: Optional[str] = None) -> Future:
        with self._life:
            # under the life lock: _closed flips inside stop()/kill()'s
            # life-lock holds, and an unguarded read here could see the
            # pre-close value and classify a post-stop submit as
            # WorkerUnavailable (retryable) instead of EngineClosed
            if self._closed:
                raise EngineClosed(
                    f"transport to {self.name} is closed")
        if trace is _spans.UNSET:
            trace = TRACER.sample_trace()
        payload = wire.encode_submit(
            data, deadline_ms=deadline_ms, trace=trace,
            priority=priority, model=model, tenant=tenant)
        corr = next(self._corr)
        fut: Future = Future()
        _spans.set_trace(fut, trace)
        # the hedging router cancels the losing dispatch by this id
        fut._tm_corr = corr  # type: ignore[attr-defined]
        pend = _Pending("submit", fut, time.monotonic(), trace)
        with self._life:
            if not self._connected:
                raise wire.WorkerUnavailable(
                    f"worker {self.name} is not connected")
            self._pending[corr] = pend
        try:
            self._send_frame(wire.encode_frame(wire.T_SUBMIT, corr,
                                               payload))
        except BaseException:
            with self._life:
                self._pending.pop(corr, None)
            raise
        return fut

    def cancel_request(self, fut: Future) -> bool:
        """Abandon an in-flight submit by its correlation id (the
        hedging router's loser-cancellation path): the pending entry
        is dropped so a late RESULT is ignored as usual, and the
        future is cancelled. Returns False for an unknown/settled
        future."""
        corr = getattr(fut, "_tm_corr", None)
        if corr is None:
            return False
        with self._life:
            pend = self._pending.pop(corr, None)
        if pend is None:
            return False
        cancelled = pend.future.cancel()
        # fire-and-forget remote cancel: if the submit is still queued
        # worker-side it does zero engine work; the REPLY comes back on
        # an unregistered corr and _on_frame drops it like any late
        # frame. No waiting — this runs on a router callback thread.
        try:
            self._send_frame(wire.encode_frame(
                wire.T_CONTROL, next(self._corr),
                wire.encode_control("cancel", corr=corr)))
        except Exception:   # noqa: BLE001 — abandonment is best-effort
            pass
        return cancelled

    # -- control RPCs ----------------------------------------------------

    def control(self, op: str, timeout: Optional[float] = None,
                **args: Any) -> Any:
        """One JSON control round trip; raises the reconstructed
        taxonomy error on a worker-side failure."""
        corr = next(self._corr)
        fut: Future = Future()
        pend = _Pending("control", fut, time.monotonic(), None)
        with self._life:
            if not self._connected:
                raise wire.WorkerUnavailable(
                    f"worker {self.name} is not connected")
            self._pending[corr] = pend
        try:
            self._send_frame(wire.encode_frame(
                wire.T_CONTROL, corr, wire.encode_control(op, **args)))
            reply = fut.result(timeout if timeout is not None
                               else self.config.call_timeout_s)
        except BaseException:
            with self._life:
                self._pending.pop(corr, None)
            raise
        if not reply.get("ok"):
            err = reply.get("error") or {}
            cls = wire.ERROR_TYPES.get(str(err.get("etype")))
            message = str(err.get("message", f"control {op!r} failed"))
            if cls is None:
                raise wire.RemoteError(
                    message, retryable=bool(err.get("retryable")),
                    etype=str(err.get("etype", "RemoteError")))
            raise cls(message)
        return reply.get("value")

    # -- health ----------------------------------------------------------

    def live(self) -> bool:
        with self._life:
            return (self._connected
                    and time.monotonic() - self._last_pong
                    <= self.config.liveness_timeout_s)

    def ready(self) -> bool:
        if not self.live():
            return False
        try:
            return bool(self.control("ready"))
        except Exception:
            return False

    # -- admission control / sampled stats -------------------------------

    def set_price(self, price: float) -> None:
        self.control("set_price", price=float(price))

    def load_gauges(self) -> Dict[str, Any]:
        return dict(self.control("gauges"))

    def outcome_counters(self) -> Dict[str, int]:
        return {str(k): int(v)
                for k, v in dict(self.control("counters")).items()}

    def recent_wait_ms(self, last_n: int, q: float) -> float:
        return float(self.control("wait_ms", last_n=int(last_n),
                                  q=float(q)))

    def recent_outcomes(self, last_n: int) -> Tuple[int, int]:
        ok, failed = self.control("outcomes", last_n=int(last_n))
        return int(ok), int(failed)

    # -- introspection ---------------------------------------------------

    def status_snapshot(self,
                        process_globals: bool = False) -> Dict[str, Any]:
        doc = dict(self.control(
            "status", process_globals=bool(process_globals)))
        doc["transport"] = dict(self.describe(),
                                **self.stats.as_dict())
        return doc


class ProcessWorkerTransport(ReplicaTransport):
    """Socket transport that also OWNS its worker process.

    ``start()`` spawns the worker, waits for the port file, connects,
    and blocks until the worker reports ready; calling it again after
    the worker died (supervisor restart) respawns from scratch — the
    ephemeral port changes, so each generation gets a fresh
    :class:`SocketTransport`. ``kill()`` is SIGKILL: no drain, no
    flush, exactly what the kill-9 chaos drill needs.
    """

    kind = "socket"

    def __init__(self, model_path: str, *, name: str = "worker",
                 version: str = "v1",
                 devices: Optional[str] = None,
                 env: Optional[Dict[str, str]] = None,
                 config: Optional[TransportConfig] = None,
                 device: Optional[str] = None):
        self.model_path = str(model_path)
        self.name = str(name)
        self.version = str(version)
        #: TM_MESH_DEVICES value handed to this worker (a count, as in
        #: the JAX package; every worker on a one-card machine shares
        #: cuda:0)
        self.devices = devices
        #: the torch device the worker serves on (``--device``); None
        #: lets the worker resolve its own default — CUDA, raising
        #: without it: a worker never starts on the CPU unless asked
        self.device = None if device is None else str(device)
        self.extra_env = dict(env or {})
        self.config = config or TransportConfig.from_env()
        self.stats = TransportStats()
        self._life = threading.RLock()
        self._proc: Optional[subprocess.Popen] = None
        self._client: Optional[SocketTransport] = None
        self._generation = 0
        self._closed = False
        self._workdir = tempfile.mkdtemp(prefix=f"tm-worker-{name}-")

    # -- identity --------------------------------------------------------

    def describe(self) -> Dict[str, Any]:
        client = self._client
        doc = {"kind": self.kind, "name": self.name,
               "pid": self._proc.pid if self._proc else None,
               "generation": self._generation,
               "devices": self.devices, "device": self.device}
        if client is not None:
            doc["addr"] = f"{client.host}:{client.port}"
        return doc

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        with self._life:
            if self._closed:
                raise EngineClosed(
                    f"worker transport {self.name} is closed")
            if self._proc is not None and self._proc.poll() is None \
                    and self._client is not None \
                    and self._client.live():
                return          # already up
            self._teardown_locked()
            self._generation += 1
            gen = self._generation
            port_file = os.path.join(self._workdir, f"port.{gen}")
            log_path = os.path.join(self._workdir, f"worker.{gen}.log")
            env = dict(os.environ)
            env.update(self.extra_env)
            env["TM_WORKER_VERSION"] = self.version
            if self.devices is not None:
                env["TM_MESH_DEVICES"] = str(self.devices)
            cmd = [sys.executable, "-m",
                   "transmogrifai_tpu_torch.serving.worker",
                   "--model", self.model_path,
                   "--port-file", port_file]
            if self.device is not None:
                cmd += ["--device", self.device]
            log = open(log_path, "ab")
            try:
                self._proc = subprocess.Popen(
                    cmd, env=env, stdout=log, stderr=log,
                    stdin=subprocess.DEVNULL)
            finally:
                log.close()
            RECORDER.record("transport",
                            "worker.spawn" if gen == 1
                            else "worker.respawn",
                            name=self.name, pid=self._proc.pid,
                            generation=gen, devices=self.devices,
                            device=self.device)
            port = self._await_port(port_file, log_path)
            client = SocketTransport(
                "127.0.0.1", port, name=self.name, config=self.config,
                stats=self.stats, worker_pid=self._proc.pid,
                auto_reconnect=False)
            # gen>1 connects record a "reconnect" event — the flight
            # recorder's restart→reconnect link in the chaos chain
            client._generation = gen - 1
            client.connect()
            self._client = client
        self._await_ready(log_path)

    def _await_port(self, port_file: str, log_path: str) -> int:
        deadline = time.monotonic() + self.config.spawn_timeout_s
        while time.monotonic() < deadline:
            if self._proc is not None \
                    and self._proc.poll() is not None:
                raise wire.WorkerUnavailable(
                    f"worker {self.name} exited with "
                    f"{self._proc.returncode} before binding "
                    f"({self._log_tail(log_path)})")
            try:
                with open(port_file, encoding="utf-8") as fh:
                    text = fh.read().strip()
                if text:
                    return int(text.split()[0])
            except (OSError, ValueError):
                pass
            time.sleep(0.02)
        raise wire.WorkerUnavailable(
            f"worker {self.name} did not bind within "
            f"{self.config.spawn_timeout_s}s "
            f"({self._log_tail(log_path)})")

    def _await_ready(self, log_path: str) -> None:
        deadline = time.monotonic() + self.config.spawn_timeout_s
        client = self._client
        while time.monotonic() < deadline:
            if client is not None and client.ready():
                return
            if self._proc is not None \
                    and self._proc.poll() is not None:
                break
            time.sleep(0.05)
        raise wire.WorkerUnavailable(
            f"worker {self.name} never became ready "
            f"({self._log_tail(log_path)})")

    def _log_tail(self, log_path: str, n: int = 400) -> str:
        try:
            with open(log_path, encoding="utf-8",
                      errors="replace") as fh:
                return "log tail: " + fh.read()[-n:].strip()
        except OSError:
            return "no worker log"

    def _teardown_locked(self) -> None:
        client, self._client = self._client, None
        if client is not None:
            client.kill()
        proc, self._proc = self._proc, None
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()

    def stop(self, drain: bool = True,
             timeout: Optional[float] = None) -> None:
        with self._life:
            self._closed = True
            client, self._client = self._client, None
            proc, self._proc = self._proc, None
        if client is not None:
            client.stop(drain=drain, timeout=timeout)
        if proc is not None:
            try:
                proc.wait(timeout if timeout is not None else 30.0)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            RECORDER.record("transport", "worker.exit",
                            name=self.name, pid=proc.pid,
                            returncode=proc.returncode)

    def kill(self) -> None:
        """SIGKILL the worker — no drain, no goodbye. The client is
        severed as soon as the signal is sent, BEFORE the reap: a
        process holding a CUDA context takes a while to exit (the
        CUDA runtime tears the context down), and in-flight futures must
        fail over now, not after that (or a TCP timeout)."""
        with self._life:
            proc = self._proc
            client = self._client
        killed = proc is not None and proc.poll() is None
        if killed:
            try:
                os.kill(proc.pid, signal.SIGKILL)
            except OSError:
                pass
        if client is not None:
            client._disconnect("worker killed")
        if killed:
            proc.wait()
            RECORDER.record("transport", "worker.exit",
                            severity="warning", name=self.name,
                            pid=proc.pid, returncode=proc.returncode,
                            reason="killed")

    # -- delegation to the wire client -----------------------------------

    def _require_client(self) -> SocketTransport:
        client = self._client
        if client is None:
            raise wire.WorkerUnavailable(
                f"worker {self.name} has no live connection")
        return client

    def submit(self, data, deadline_ms: Optional[float] = None,
               trace=_spans.UNSET, priority: str = "normal",
               model: Optional[str] = None,
               tenant: Optional[str] = None) -> Future:
        return self._require_client().submit(
            data, deadline_ms=deadline_ms, trace=trace,
            priority=priority, model=model, tenant=tenant)

    def cancel_request(self, fut: Future) -> bool:
        client = self._client
        return (client.cancel_request(fut)
                if client is not None else bool(fut.cancel()))

    def live(self) -> bool:
        with self._life:
            proc, client = self._proc, self._client
        return (proc is not None and proc.poll() is None
                and client is not None and client.live())

    def ready(self) -> bool:
        return self.live() and self._require_client().ready()

    def set_price(self, price: float) -> None:
        self._require_client().set_price(price)

    def load_gauges(self) -> Dict[str, Any]:
        return self._require_client().load_gauges()

    def outcome_counters(self) -> Dict[str, int]:
        return self._require_client().outcome_counters()

    def recent_wait_ms(self, last_n: int, q: float) -> float:
        return self._require_client().recent_wait_ms(last_n, q)

    def recent_outcomes(self, last_n: int) -> Tuple[int, int]:
        return self._require_client().recent_outcomes(last_n)

    def status_snapshot(self,
                        process_globals: bool = False) -> Dict[str, Any]:
        doc = self._require_client().status_snapshot(
            process_globals=process_globals)
        doc.setdefault("transport", {}).update(
            pid=self._proc.pid if self._proc else None,
            generation=self._generation, devices=self.devices,
            device=self.device)
        return doc
