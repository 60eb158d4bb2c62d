"""Deterministic fault-injection harness.

Failure paths that are not deterministically testable are failure paths
that do not work (the chaos-engineering position of the systems
references in PAPERS.md). Spark got its failure drills for free — kill
an executor, lineage recomputes; a jax_graft port has to script its own
faults. This module is that script: NAMED injection points compiled
into the production code paths, activated by a ``TM_FAULTS`` spec, with
per-point arrival/injection counters (profiling.FaultStats) so a test
can assert not just "the train survived" but "the fault actually fired
where and when the spec said".

Spec grammar (``TM_FAULTS`` env var or :func:`configure`)::

    spec      := entry (';' entry)*
    entry     := point ':' kind ':' nth [':' arg]
    point     := a registered injection-point name (see POINTS)
    kind      := raise-transient | raise-fatal | hang | partial-write
                 | crash-process
    nth       := N        fire on exactly the Nth arrival (1-based)
               | N+       fire on the Nth and every later arrival
    arg       := float    kind parameter: hang seconds (default 30),
                          crash-process signal (default SIGKILL)

Examples::

    TM_FAULTS="executor.stage_fit:raise-transient:1"
        first stage fit raises a retryable TransientFaultError; a
        RetryPolicy with attempts >= 2 recovers.
    TM_FAULTS="executor.stage_fit:crash-process:5"
        the 5th stage fit SIGKILLs the process mid-train — the
        checkpoint/resume drill.
    TM_FAULTS="stages.persistence.save:partial-write:1"
        the first artifact commit writes a TRUNCATED file to the final
        path (deliberately bypassing the atomic-rename protection) and
        raises — proving every load path rejects a torn artifact.

Injection points are deliberately few and load-bearing (POINTS): each
one sits on a distinct failure surface of the training/serving stack.
Arrival counting only happens while a spec is active, so the disabled
harness costs one tuple lookup per point.

Kinds:

* ``raise-transient`` — raises :class:`TransientFaultError`
  (classified retryable by resilience.policy.RetryPolicy).
* ``raise-fatal`` — raises :class:`FaultError` (never retried).
* ``hang`` — sleeps ``arg`` seconds (default 30) then RETURNS: the
  stall is the fault. A RetryPolicy wall-clock watchdog turns it into
  a StageTimeoutError; without one it is just a delay.
* ``partial-write`` — raises :class:`PartialWriteFault`; the atomic
  write helper (resilience.atomic) catches it, commits a TRUNCATED
  payload to the final path, and re-raises — simulating the torn
  artifact a non-atomic writer leaves after a crash.
* ``crash-process`` — ``os.kill(os.getpid(), SIGKILL)`` (or the
  signal in ``arg``): the real kill -9, no cleanup, no excepthook.
"""
from __future__ import annotations

import os
import signal
import threading
import time
from typing import Dict, List, Optional

from ..profiling import FaultStats


class FaultError(RuntimeError):
    """An injected fatal fault (kind raise-fatal / partial-write)."""

    #: resilience.policy classification hook: never retried
    retryable = False


class TransientFaultError(FaultError):
    """An injected transient fault (kind raise-transient): the
    canonical retryable exception — RetryPolicy recovers from it."""

    retryable = True


class PartialWriteFault(FaultError):
    """Control-flow signal for the partial-write kind: the atomic
    write helper catches this, commits a truncated payload to the
    final path, then re-raises it as the injected failure."""

    retryable = False


#: the injection-point catalog. Registering here (not ad hoc strings at
#: call sites) means a typo'd TM_FAULTS spec fails at configure time
#: instead of silently never firing.
POINTS = frozenset({
    "executor.stage_fit",        # around each stage fit attempt
    "executor.pool_worker",      # top of a parallel-executor pool job
    "stages.persistence.save",   # the atomic artifact-commit step
    "readers.read",              # raw training-data materialization
    "serving.registry.load",     # registry artifact load attempt
    "models.selector.validate",  # after each candidate family validates
    "models.sweep.chip_dispatch",  # per MESH SHARD when the host blocks
    #                                on a fused sweep batch (tuning.
    #                                _SweepBatch.materialize): arrival i
    #                                of a batch is chip i's shard. A
    #                                raise-* kind fails that family's
    #                                whole batch (a dead chip poisons
    #                                the batch it carried); crash-process
    #                                here is the sharded kill/resume
    #                                drill — resume may re-dispatch on a
    #                                DIFFERENT mesh shape and must stay
    #                                bitwise (mesh-size invariance).
    # request-plane points (serving fleet):
    "serving.engine.dispatch",   # per engine micro-batch, pre-device
    "serving.router.route",      # per fleet-router dispatch attempt
    "serving.replica.crash",     # per routed dispatch; a raise-* kind
    #                              here makes the FLEET hard-kill the
    #                              selected replica mid-load (stop
    #                              without drain) — the replica-crash
    #                              drill. crash-process would still
    #                              kill the whole host process.
    # elastic autoscaler points: each sits on one arrow of the
    # scale decision/actuation loop.
    "serving.scaler.tick",        # per autoscaler evaluation tick: a
    #                               raise-* kind drops ONE evaluation
    #                               (counted in ScalerStats
    #                               .evaluations_dropped), never the
    #                               loop — the scaler keeps scaling.
    "serving.scaler.provision",   # per scale-up replica BUILD attempt:
    #                               a raise-transient is retried with
    #                               the seeded provision backoff; spent
    #                               retries abandon THIS scale-up (the
    #                               fleet keeps serving at its current
    #                               N) and the next breach tries again.
    #                               hang delays the build — the window
    #                               the kill-mid-scale-up drill uses.
    # continuum control-loop points: each sits on one transition
    # of the drift→retrain→gate→promote state machine.
    "continuum.monitor.observe",  # per controller monitor tick (a raise
    #                               here drops one tick's observation,
    #                               never the loop)
    "continuum.retrain.launch",   # before each retrain ATTEMPT — pair
    #                               with executor.stage_fit kills for
    #                               the mid-train kill/resume drill
    "continuum.shadow.score",     # per mirrored request scored on the
    #                               CANDIDATE; a raise-* kind makes the
    #                               candidate fail shadow comparison —
    #                               the bad-candidate-at-the-gate drill
    "continuum.promote",          # before the staged rollout / hot-swap
    # cross-host transport points: one per arrow of the wire.
    "serving.transport.connect",  # per TCP connect ATTEMPT (client
    #                               side, inside the bounded-backoff
    #                               loop): raise-transient consumes one
    #                               attempt; exhausting the budget is
    #                               the worker-unreachable drill.
    "serving.transport.send",     # per frame written by the client: a
    #                               raise-* kind severs the connection
    #                               mid-stream — every in-flight future
    #                               fails retryable (WorkerUnavailable)
    #                               and the router fails over.
    "serving.transport.recv",     # per frame read by the client reader
    #                               thread — the torn-response drill:
    #                               the reader disconnects, pending
    #                               futures fail retryable, reconnect
    #                               (or supervisor restart) follows.
    # gray-failure network-chaos points: consulted by the
    # netchaos shim (serving/transport/netchaos.py) on every DATA frame
    # crossing the wire seam. Heartbeat frames (PING/PONG) are exempt
    # from arrival counting AND from every kind except net-stall — the
    # gray regime is precisely "liveness signal healthy, data path
    # degraded", and clock-driven heartbeats would also destroy nth
    # determinism. Only the net-* kinds are meaningful here.
    "serving.transport.net.send",  # per DATA frame written by the
    #                                client: net-delay/-throttle shape
    #                                the send, net-drop/-partition
    #                                swallow it (worker never sees the
    #                                request), net-stall wedges the
    #                                socket mid-frame holding the send
    #                                lock, net-corrupt flips payload
    #                                bytes (worker answers with a loud
    #                                WireProtocolError frame).
    "serving.transport.net.recv",  # per DATA frame read by the client
    #                                reader: net-partition is the
    #                                half-open drill — responses
    #                                blackholed forever while PONGs
    #                                pass, so the heartbeat stays fresh
    #                                and only the hung-replica ejector
    #                                can see the stall.
})

KINDS = ("raise-transient", "raise-fatal", "hang", "partial-write",
         "crash-process",
         # net-* kinds: interpreted by the netchaos wire shim, not by
         # fault_point itself — fault_action() returns the matched spec
         # for the shim to execute against the socket. arg semantics:
         # net-delay seconds (default 0.05, deterministically jittered
         # ±50% per arrival), net-throttle bytes/s, net-stall seconds
         # (default 30) slept mid-frame, net-corrupt XOR byte (default
         # 0xFF), net-drop/net-partition argless.
         "net-delay", "net-throttle", "net-stall", "net-drop",
         "net-corrupt", "net-partition")

#: kinds executed inline by fault_point; the complement (net-*) is
#: returned by fault_action for the netchaos shim to interpret.
_CLASSIC_KINDS = frozenset(
    {"raise-transient", "raise-fatal", "hang", "partial-write",
     "crash-process"})

#: arrival/injection counters (class lives in profiling so the counters
#: ride the same observability surface as every other stat)
STATS = FaultStats()


class FaultSpec:
    """One parsed ``point:kind:nth[:arg]`` entry."""

    __slots__ = ("point", "kind", "nth", "repeat", "arg")

    def __init__(self, point: str, kind: str, nth: int, repeat: bool,
                 arg: Optional[float]):
        self.point = point
        self.kind = kind
        self.nth = nth
        self.repeat = repeat
        self.arg = arg

    def __repr__(self):
        plus = "+" if self.repeat else ""
        return f"FaultSpec({self.point}:{self.kind}:{self.nth}{plus})"


def parse_spec(text: str) -> List[FaultSpec]:
    """Parse a TM_FAULTS string; raises ValueError on any malformed
    entry (a fault drill that silently arms nothing proves nothing)."""
    out: List[FaultSpec] = []
    for entry in text.replace(",", ";").split(";"):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        if len(parts) not in (3, 4):
            raise ValueError(
                f"bad TM_FAULTS entry {entry!r}: expected "
                f"point:kind:nth[:arg]")
        point, kind, nth_s = parts[0], parts[1], parts[2]
        if point not in POINTS:
            raise ValueError(f"unknown fault point {point!r}; one of "
                             f"{sorted(POINTS)}")
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r}; one of "
                             f"{list(KINDS)}")
        repeat = nth_s.endswith("+")
        try:
            nth = int(nth_s[:-1] if repeat else nth_s)
            if nth < 1:
                raise ValueError
        except ValueError:
            raise ValueError(f"bad TM_FAULTS nth {nth_s!r} in {entry!r}: "
                             f"expected a positive int or 'N+'") from None
        arg = float(parts[3]) if len(parts) == 4 else None
        out.append(FaultSpec(point, kind, nth, repeat, arg))
    return out


_LOCK = threading.Lock()
_SPECS: List[FaultSpec] = []
_ARMED = False          # False until configure()/env parse — the fast path
_ENV_LOADED = False


def configure(spec: Optional[str]) -> List[FaultSpec]:
    """Arm the harness with a spec string (None/'' disarms). Resets
    counters — each configured drill starts from a clean count."""
    global _SPECS, _ARMED, _ENV_LOADED
    specs = parse_spec(spec) if spec else []
    with _LOCK:
        _SPECS = specs
        _ARMED = bool(specs)
        _ENV_LOADED = True
        STATS.reset()
    return specs


def reset() -> None:
    """Disarm and clear counters (test teardown)."""
    configure(None)


def _load_env() -> None:
    global _ENV_LOADED
    with _LOCK:
        if _ENV_LOADED:
            return
        _ENV_LOADED = True
    env = os.environ.get("TM_FAULTS")
    if env:
        configure(env)


class active:
    """Context manager arming a spec for a test block::

        with faults.active("executor.stage_fit:raise-transient:1"):
            ...
    """

    def __init__(self, spec: str):
        self.spec = spec

    def __enter__(self):
        configure(self.spec)
        return self

    def __exit__(self, *exc):
        reset()
        return False


def _fire(name: str, ctx: Dict[str, object]
          ) -> Optional[tuple]:
    """Shared arm/arrival/match/record core of fault_point and
    fault_action. Returns ``(spec, n)`` when a spec fired (already
    counted + flight-recorded), else None."""
    if not _ARMED:
        if not _ENV_LOADED:
            _load_env()
            if not _ARMED:
                return None
        else:
            return None
    with _LOCK:
        specs = list(_SPECS)
        if not specs:
            return None
        n = STATS.note_arrival(name)
    fired: Optional[FaultSpec] = None
    for s in specs:
        if s.point != name:
            continue
        if n == s.nth or (s.repeat and n >= s.nth):
            fired = s
            break
    if fired is None:
        return None
    STATS.note_injected(name, fired.kind)
    # every fired fault lands in the control-plane flight recorder: a
    # chaos drill's dump opens with the injection that caused the rest
    # of the chain (telemetry.recorder is stdlib-only — no cycle)
    from ..telemetry.recorder import RECORDER
    RECORDER.record("faults", "injected", severity="warning",
                    point=name, kind=fired.kind, arrival=n,
                    **{k: str(v) for k, v in ctx.items()})
    return fired, n


def fault_action(name: str, **ctx) -> Optional[tuple]:
    """Query-style hook for seams that must INTERPRET a fault rather
    than just suffer it (the netchaos wire shim). Counts the arrival
    and matches exactly like :func:`fault_point`; classic kinds are
    executed here (identical semantics), net-* kinds are RETURNED as
    ``(spec, arrival)`` for the caller to apply against its socket —
    the arrival number rides along so effects like jitter can be a
    pure function of the spec. Returns None when nothing fired."""
    hit = _fire(name, ctx)
    if hit is None:
        return None
    fired, n = hit
    if fired.kind in _CLASSIC_KINDS:
        _execute(fired, name, n, ctx)
        return None
    return fired, n


def fault_point(name: str, **ctx) -> None:
    """The compiled-in hook. Cheap when disarmed; when armed, counts
    the arrival and fires any matching spec whose nth has come up.

    ``ctx`` (stage uid, path, ...) rides the raised error message so a
    drill's failure is attributable without a debugger. net-* specs
    armed on a classic point are inert here — only
    :func:`fault_action` seams can interpret them.
    """
    hit = _fire(name, ctx)
    if hit is None:
        return
    fired, n = hit
    if fired.kind in _CLASSIC_KINDS:
        _execute(fired, name, n, ctx)


def _execute(fired: FaultSpec, name: str, n: int,
             ctx: Dict[str, object]) -> None:
    where = f"{name}#{n}" + (f" ({ctx})" if ctx else "")
    if fired.kind == "raise-transient":
        raise TransientFaultError(f"injected transient fault at {where}")
    if fired.kind == "raise-fatal":
        raise FaultError(f"injected fatal fault at {where}")
    if fired.kind == "partial-write":
        raise PartialWriteFault(f"injected partial write at {where}")
    if fired.kind == "hang":
        time.sleep(fired.arg if fired.arg is not None else 30.0)
        return
    if fired.kind == "crash-process":
        # SIGKILL flushes nothing: persist the flight ring FIRST so the
        # post-mortem dump records its own cause
        RECORDER.auto_dump(f"crash-process injection at {where}")
        sig = int(fired.arg) if fired.arg is not None else signal.SIGKILL
        os.kill(os.getpid(), sig)       # kill -9: no cleanup, no flush
        time.sleep(60)                  # never reached on POSIX


def stats_dict() -> Dict[str, Dict[str, int]]:
    """Counter snapshot for /statusz + train summaries."""
    return STATS.as_dict()
