"""``python -m transmogrifai_tpu_torch.serving.worker`` — one engine, one
socket, one process.

The cross-host fleet's unit of scale-out: hosts a single
:class:`~transmogrifai_tpu_torch.serving.engine.ServingEngine` behind a TCP
listener speaking the length-prefixed wire protocol
(serving/transport/wire.py). The fleet's
:class:`~transmogrifai_tpu_torch.serving.transport.tcp.ProcessWorkerTransport`
spawns one of these per replica; standalone use is just::

    TM_WORKER_PORT=7433 python -m transmogrifai_tpu_torch.serving.worker \\
        --model /path/to/saved-workflow

The worker serves on the torch device its supervisor names
(``--device``, which ``ProcessWorkerTransport`` passes); with none
named it resolves like every entry point of the port
(``_device.resolve_device``): CUDA, raising without it — BEFORE it
binds, so the supervisor sees the exit and the CUDA error in the
worker's log tail, and never restarts it on the CPU. ``TM_MESH_DEVICES``
keeps its JAX-package meaning (a device count) and rides the child
environment; on a one-card machine every worker shares ``cuda:0``, each
with its own CUDA context. The kernels build at first use; concurrent
first builds from several workers are safe (``_cuda_build`` writes each
build to a file named by pid and thread and renames it atomically).
Engine tuning rides the same ``TM_ENGINE_*`` / ``TM_TENANT_*`` /
``TM_MODEL_*`` knobs as the in-process engine (EngineConfig.from_env
in this process), so a worker is configured exactly like the engine it
replaces. ``TM_WORKER_*`` knobs (strict catalog below) cover what is
worker-specific: bind address, bucket ladder, warm policy, and an
optional off-host health endpoint (``TM_WORKER_HEALTH_PORT`` +
``TM_HEALTH_HOST``) exposing the same /statusz + /metricsz any engine
serves.

Protocol duties: SUBMIT frames feed ``engine.submit`` (the request
envelope's deadline/priority/model/tenant land on the worker's own
admission controller — per-request deadlines are enforced on BOTH
sides of the wire); the resolved future is encoded back as RESULT
(with the worker-side engine seconds, so the client can attribute
RTT − engine to the wire) or a classified ERROR frame. CONTROL frames
serve health/stats/reprice/drain/stop; PING gets PONG. A ``stop``
control acks first, then drains and exits — the client's
``proc.wait`` covers the drain window.
"""
from __future__ import annotations

import argparse
import os
import signal
import socket
import threading
import time
from typing import Any, Dict, Optional, Tuple

from .._device import resolve_device
from ..resilience.atomic import atomic_write_bytes
from ..resilience.config import parse_env_fields
from ..telemetry.recorder import RECORDER
from .engine import EngineConfig, ServingEngine
from .health import HealthServer, status_snapshot
from .registry import build_registry
from .transport import wire

__all__ = ["WorkerConfig", "WorkerServer", "main"]


def buckets_spec(raw: str) -> Any:
    """Parse TM_WORKER_BUCKETS: ``"default"`` (scorer's ladder) or a
    comma list of ascending row buckets. Strict: empty entries or a
    non-ascending ladder raise."""
    raw = str(raw).strip()
    if raw in ("", "default"):
        return True
    sizes = tuple(int(p) for p in raw.split(","))
    if any(b < 1 for b in sizes) or list(sizes) != sorted(set(sizes)):
        raise ValueError(
            f"TM_WORKER_BUCKETS must be ascending positive ints, "
            f"got {raw!r}")
    return sizes


#: TM_WORKER_* env knobs (strict parse_env_fields catalog): the worker
#: process surface. Engine tuning deliberately is NOT here — it rides
#: the shared TM_ENGINE_*/TM_TENANT_*/TM_MODEL_* knobs unchanged.
_ENV_FIELDS: Dict[str, tuple] = {
    "TM_WORKER_HOST": ("host", str),
    "TM_WORKER_PORT": ("port", int),
    "TM_WORKER_VERSION": ("version", str),
    "TM_WORKER_BUCKETS": ("buckets", buckets_spec),
    "TM_WORKER_WARM": ("warm", int),
    "TM_WORKER_HEALTH_PORT": ("health_port", int),
}


class WorkerConfig:
    """Worker bind/load knobs (see ``_ENV_FIELDS``)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 version: str = "v1", buckets: Any = True,
                 warm: int = 1, health_port: int = -1):
        if port < 0 or port > 65535:
            raise ValueError("TM_WORKER_PORT must be in [0, 65535]")
        self.host = str(host)
        self.port = int(port)
        self.version = str(version)
        self.buckets = buckets
        self.warm = bool(warm)
        #: -1 = no health endpoint; 0 = ephemeral port; else fixed
        self.health_port = int(health_port)

    @classmethod
    def from_env(cls, environ: Optional[Dict[str, str]] = None,
                 **overrides) -> "WorkerConfig":
        fields = parse_env_fields("TM_WORKER_", _ENV_FIELDS,
                                  what="worker env var",
                                  environ=environ)
        fields.update(overrides)
        return cls(**fields)


class WorkerServer:
    """The listener: accepts fleet connections, speaks the wire
    protocol, drives the hosted engine."""

    def __init__(self, engine: ServingEngine, host: str = "127.0.0.1",
                 port: int = 0):
        self.engine = engine
        self._listener = socket.create_server((host, port), backlog=8)
        self._listener.settimeout(0.2)
        self.host, self.port = self._listener.getsockname()[:2]
        self._shutdown = threading.Event()
        self._drain_on_stop = True
        self._accept_thread: Optional[threading.Thread] = None
        #: corr -> engine future for submits still in flight — the
        #: "cancel" control op (hedge loser abandonment) resolves
        #: against this so a cancelled request still queued worker-side
        #: does zero engine work
        self._inflight: Dict[int, Any] = {}
        self._inflight_lock = threading.Lock()

    def start(self) -> None:
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name="tm-worker-accept")
        self._accept_thread.start()

    def request_stop(self, drain: bool = True) -> None:
        # opaudit: disable=concurrency -- Event-sequenced: the flag is written BEFORE _shutdown.set() and wait() reads it only AFTER the Event fires; Event.set() is the happens-before edge, no lock needed
        self._drain_on_stop = bool(drain)
        self._shutdown.set()

    def wait(self) -> None:
        """Block until a stop is requested, then drain and exit."""
        while not self._shutdown.wait(0.2):
            pass
        try:
            self.engine.stop(drain=self._drain_on_stop)
        except Exception:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        RECORDER.record("worker", "stop", pid=os.getpid(),
                        drained=self._drain_on_stop)

    # -- connection handling ---------------------------------------------

    def _accept_loop(self) -> None:
        while not self._shutdown.is_set():
            try:
                conn, addr = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._serve_conn,
                             args=(conn, addr), daemon=True,
                             name=f"tm-worker-conn[{addr[1]}]").start()

    def _serve_conn(self, conn: socket.socket,
                    addr: Tuple[str, int]) -> None:
        send_lock = threading.Lock()

        def send(frame: bytes) -> None:
            with send_lock:
                conn.sendall(frame)

        try:
            while not self._shutdown.is_set():
                try:
                    ftype, corr, payload = wire.read_frame(conn)
                except (ConnectionError, OSError):
                    return      # client went away; its problem
                except wire.WireProtocolError as e:
                    # framing is lost — answer loudly, then hang up
                    try:
                        send(wire.encode_frame(wire.T_ERROR, 0,
                                               wire.encode_error(e)))
                    except OSError:
                        pass
                    return
                if ftype == wire.T_PING:
                    send(wire.encode_frame(wire.T_PONG, 0))
                elif ftype == wire.T_SUBMIT:
                    self._handle_submit(send, corr, payload)
                elif ftype == wire.T_CONTROL:
                    self._handle_control(send, corr, payload)
                # T_PONG and anything client-bound: ignore
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _handle_submit(self, send, corr: int, payload: bytes) -> None:
        t0 = time.monotonic()
        try:
            data, env = wire.decode_submit(payload)
            fut = self.engine.submit(
                data, deadline_ms=env["deadline_ms"],
                trace=env["trace"],
                priority=env["priority"] or "normal",
                model=env["model"], tenant=env["tenant"])
        except BaseException as e:  # noqa: BLE001 — crosses the wire
            try:
                send(wire.encode_frame(wire.T_ERROR, corr,
                                       wire.encode_error(e)))
            except OSError:
                pass
            return
        with self._inflight_lock:
            self._inflight[corr] = fut

        def _done(f) -> None:
            with self._inflight_lock:
                self._inflight.pop(corr, None)
            if f.cancelled():
                return          # hedge loser: nothing to send back
            try:
                exc = f.exception()
                if exc is not None:
                    frame = wire.encode_frame(wire.T_ERROR, corr,
                                              wire.encode_error(exc))
                else:
                    frame = wire.encode_frame(
                        wire.T_RESULT, corr,
                        wire.encode_result(
                            f.result(),
                            engine_s=time.monotonic() - t0))
                send(frame)
            except OSError:
                pass            # client gone; scores are orphaned

        fut.add_done_callback(_done)

    def _handle_control(self, send, corr: int, payload: bytes) -> None:
        try:
            op, args = wire.decode_control(payload)
            value = self._control(op, args)
            reply = {"ok": True, "value": value}
        except BaseException as e:  # noqa: BLE001 — crosses the wire
            reply = {"ok": False,
                     "error": {"etype": type(e).__name__,
                               "message": str(e),
                               "retryable": bool(
                                   getattr(e, "retryable", False))}}
        try:
            send(wire.encode_frame(wire.T_REPLY, corr,
                                   wire.encode_reply(reply)))
        except OSError:
            pass

    def _control(self, op: str, args: Dict[str, Any]) -> Any:
        engine = self.engine
        if op == "ready":
            return engine.ready()
        if op == "live":
            return engine.live()
        if op == "gauges":
            return engine.stats.load_gauges()
        if op == "counters":
            return engine.stats.outcome_counters()
        if op == "wait_ms":
            return engine.stats.recent_wait_ms(
                int(args["last_n"]), float(args["q"]))
        if op == "outcomes":
            return list(engine.stats.recent_outcomes(
                int(args["last_n"])))
        if op == "set_price":
            engine.admission.set_price(float(args["price"]))
            return True
        if op == "status":
            return status_snapshot(
                engine,
                process_globals=bool(args.get("process_globals")))
        if op == "cancel":
            # best-effort hedge-loser abandonment: succeeds only while
            # the submit is still QUEUED (a running batch completes and
            # its RESULT is ignored client-side — the usual late-frame
            # path); the fleet treats False as "too late", not an error
            with self._inflight_lock:
                fut = self._inflight.pop(int(args["corr"]), None)
            return bool(fut.cancel()) if fut is not None else False
        if op in ("stop", "drain"):
            # ack FIRST, then drain+exit — the client's proc.wait
            # covers the drain window; a reply after engine.stop
            # would race the process exit
            self.request_stop(drain=bool(args.get("drain", True))
                              or op == "drain")
            return True
        raise ValueError(f"unknown control op {op!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m transmogrifai_tpu_torch.serving.worker",
        description="host one ServingEngine behind a wire-protocol "
                    "socket listener")
    ap.add_argument("--model", required=True,
                    help="saved workflow / portable export / registry "
                         "root to serve")
    ap.add_argument("--port-file", default=None,
                    help="write '<port> <pid>' here once bound (how "
                         "the fleet discovers an ephemeral port)")
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: cuda, "
                         "failing without it)")
    args = ap.parse_args(argv)

    cfg = WorkerConfig.from_env()
    # resolved before anything binds: a worker asked for CUDA on a
    # machine without it exits here, loudly
    device = resolve_device(args.device)
    registry = build_registry(args.model, buckets=cfg.buckets,
                              version=cfg.version, warm=cfg.warm,
                              device=device)
    engine = ServingEngine(registry=registry,
                           config=EngineConfig.from_env())
    engine.start()

    server = WorkerServer(engine, host=cfg.host, port=cfg.port)
    server.start()

    health: Optional[HealthServer] = None
    if cfg.health_port >= 0:
        health = HealthServer(engine, port=cfg.health_port)
        health.start()

    if args.port_file:
        atomic_write_bytes(
            args.port_file,
            f"{server.port} {os.getpid()}\n".encode("utf-8"))
    RECORDER.record("worker", "listening", pid=os.getpid(),
                    addr=f"{server.host}:{server.port}",
                    model=args.model,
                    devices=os.environ.get("TM_MESH_DEVICES"),
                    device=str(device),
                    health_port=health.port if health else None)
    print(f"worker pid={os.getpid()} listening on "
          f"{server.host}:{server.port}", flush=True)

    signal.signal(signal.SIGTERM,
                  lambda *_: server.request_stop(drain=True))
    try:
        server.wait()
    except KeyboardInterrupt:
        server.request_stop(drain=False)
    if health is not None:
        health.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
