"""Liveness / readiness / metrics for the serving engine.

One merged, torn-read-detectable snapshot: `status_snapshot` combines
the engine's EngineStats (queue depth, wait percentiles, shed/reject
counters) with every registered version's ScoringStats (per-bucket
compiles/rows/padding) and the registry view. Both stats classes stamp
a monotonic `snapshot_seq` inside their own lock hold, so a scraper
polling twice can prove nothing moved between reads (equal seqs) or
that a read straddled a mutation (seqs differ) — no torn aggregates.

The port adds one block the JAX snapshot has no counterpart for:
``device`` — where the default version's scorer lives and how often
this process launched each hand-written CUDA kernel (the counts are
process-wide, so a socket worker's snapshot is that worker's own).
``programCaches`` holds the port's bounded caches in place of XLA's
program caches: the engine's fused group scorers (stacked weights and
compiled prefix tables) and the CUDA kernel libraries this process
built or loaded (``profiling.program_caches_dict``).

`HealthServer` is an OPTIONAL stdlib HTTP shim exposing the kubernetes
trio (`/healthz` liveness, `/readyz` readiness, `/statusz` the full
snapshot) for scrapers that want an endpoint rather than an in-process
call. It binds lazily and runs on a daemon thread; nothing else in the
serving engine depends on it.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, Optional


def status_snapshot(engine, process_globals: bool = True
                    ) -> Dict[str, Any]:
    """The `/health`-style merged metrics snapshot for a ServingEngine.

    ``process_globals=False`` omits the process-scoped telemetry blocks
    (flight-recorder tail, tracer counts) — the fleet snapshot embeds
    one engine snapshot per replica and serves those blocks ONCE at the
    top level instead of N identical copies."""
    registry = engine.registry
    versions = registry.versions()
    scoring: Dict[str, Any] = {}
    for name in versions:
        try:
            v = registry.get(name)
        except KeyError:            # retired+removed between the two reads
            continue
        backend = v.backend
        if backend is not None and getattr(backend, "stats", None) is not None:
            scoring[name] = backend.stats.as_dict()
            buckets = getattr(backend, "buckets", None)
            scoring[name]["buckets"] = list(buckets) if buckets else None
            # surface what the train-time opcheck gate found (and, in
            # TM_LINT=warn mode, waived) for the version serving traffic
            model = getattr(getattr(backend, "scorer", None), "model", None)
            lint_findings = (getattr(model, "train_summaries", None)
                             or {}).get("lintFindings")
            if lint_findings:
                scoring[name]["lintFindings"] = lint_findings
            # a model trained in degraded mode (skipped stages) must
            # stay visible wherever it serves — an operator reading
            # /statusz sees WHAT was skipped and why, not just scores
            degraded = (getattr(model, "train_summaries", None)
                        or {}).get("degraded")
            if degraded:
                scoring[name]["degraded"] = degraded
            # the train-time Amdahl split + fused-sweep program
            # attribution for the version serving traffic: an operator
            # reading /statusz sees how serial the model's train was
            # (serialFraction) and what its candidate sweep compiled vs
            # executed, without digging up the training logs
            timings = (getattr(model, "train_summaries", None)
                       or {}).get("stageTimings")
            if timings:
                perf = {"executor": timings.get("executor"),
                        "seconds": timings.get("seconds"),
                        "serialFraction": timings.get("serialFraction")}
                folded = timings.get("foldedPrograms")
                if folded:
                    perf["foldedPrograms"] = folded
                scoring[name]["trainPerf"] = perf
    from ..profiling import program_caches_dict
    from ..resilience import faults
    from .registry import LOAD_STATS
    resilience: Dict[str, Any] = {"registryLoads": LOAD_STATS.as_dict()}
    fault_counters = faults.stats_dict()
    if fault_counters["injected"] or fault_counters["arrivals"]:
        resilience["faultInjection"] = fault_counters
    # bounded program-cache population/traffic (tuning fit_eval /
    # folded / sweep, selector refit): an eviction storm here means the
    # process is re-compiling every train — the retrace tax §6 warns
    # about, now visible instead of inferable
    program_caches = {k: v for k, v in program_caches_dict().items()
                      if v["hits"] or v["misses"]}
    # per-chip fused-sweep dispatch attribution (process-cumulative,
    # like programCaches): which devices this process's sweeps actually
    # ran on and how many sweep items each carried — the /metricsz
    # {device=} source. Empty until a train's sweep dispatches.
    from ..profiling import SWEEP_STATS
    out = {
        "live": engine.live(),
        "ready": engine.ready(),
        "time": time.time(),
        "started_at": engine.started_at,
        "default_version": registry.default_version,
        "versions": versions,
        # multi-model plane: tenant-facing alias ids and the LRU'd
        # weight/program cache's population + eviction/reload counters
        # (getattr: the snapshot is duck-typed over registry stubs)
        "aliases": (registry.aliases()
                    if hasattr(registry, "aliases") else {}),
        "modelCache": (registry.cache_stats()
                       if hasattr(registry, "cache_stats") else {}),
        "engine": engine.stats.as_dict(),
        "admission": {
            "max_queue_rows": engine.admission.max_queue_rows,
            "max_queue_requests": engine.admission.max_queue_requests,
            "price": getattr(engine.admission, "price", 1.0),
            "ema": engine.admission.ema.as_dict(),
        },
        "resilience": resilience,
        "programCaches": program_caches,
        "sweepDevices": SWEEP_STATS.devices_dict(),
        "scoring": scoring,
        "device": device_block(registry),
    }
    if process_globals:
        out.update(telemetry_blocks())
    return out


def device_block(registry) -> Dict[str, Any]:
    """The serving device and this process's kernel launch counts:
    ``device`` is the default version's scorer device (None while it is
    cold or unregistered); ``kernels`` maps each hand-written kernel to
    its CUDA launches so far (the CPU path launches none)."""
    from ..models import kernels as tk
    from ..models import serving_kernels as sk
    device = None
    try:
        backend = registry.get().backend
        scorer = getattr(backend, "scorer", None)
        if scorer is not None:
            device = str(scorer.device)
    except KeyError:
        pass
    return {"device": device,
            "kernels": {
                "fused_linear_scores": sk.fused_linear_scores.launches,
                "tree_histogram": tk.histogram_grid.launches}}


def telemetry_blocks() -> Dict[str, Any]:
    """The process-scoped telemetry view every /statusz carries: the
    flight recorder's tail (the last control-plane events, trace-id
    correlated) and the span tracer's volume/config counters."""
    from ..telemetry.recorder import RECORDER
    from ..telemetry.spans import TRACER
    return {
        "flightRecorder": {"events_total": RECORDER.total,
                           "last_dump": RECORDER.last_dump_path,
                           "tail": RECORDER.tail(32)},
        "telemetry": TRACER.counts(),
    }


#: TM_HEALTH_* env knobs (strict parse_env_fields catalog): the health
#: endpoint bind surface. One knob on purpose — port stays a
#: constructor argument because every embedder picks it explicitly.
_ENV_FIELDS = {
    "TM_HEALTH_HOST": ("host", str),
}


def resolve_health_host(environ=None) -> str:
    """The bind host for a ``host=None`` HealthServer: strict
    ``TM_HEALTH_HOST`` (an unknown ``TM_HEALTH_*`` name raises), else
    loopback. ``0.0.0.0`` is how a worker exposes its endpoints
    off-host."""
    from ..resilience.config import parse_env_fields
    fields = parse_env_fields("TM_HEALTH_", _ENV_FIELDS,
                              what="health env var", environ=environ)
    return str(fields.get("host", "127.0.0.1"))


class HealthServer:
    """Minimal stdlib HTTP endpoint for health/metrics.

    GET /healthz  -> 200 {"live": true} | 503      (liveness)
    GET /readyz   -> 200 {"ready": true} | 503     (readiness)
    GET /statusz  -> 200 full status JSON          (humans, tests)
    GET /metricsz -> 200 Prometheus text exposition (scrapers):
                     the same snapshot flattened into stable typed
                     tm_* families (telemetry.metrics)

    Duck-typed over anything exposing live()/ready()/status(): a
    single ServingEngine (status() = status_snapshot) or a whole
    ServingFleet (status() = the aggregated fleet snapshot with
    FleetStats + per-replica engine snapshots).

    Binds loopback by default; ``host=None`` resolves the strict
    ``TM_HEALTH_HOST`` knob so worker processes can expose /statusz
    and /metricsz off-host (``0.0.0.0``) without a code change.
    """

    def __init__(self, engine, host: Optional[str] = None,
                 port: int = 0):
        self.engine = engine
        self.host = resolve_health_host() if host is None else host
        self._port = port
        self._httpd = None
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        if self._httpd is not None:
            return self._httpd.server_address[1]
        return self._port

    def start(self) -> "HealthServer":
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        engine = self.engine

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):      # keep stdout clean
                pass

            def _reply(self, code: int, doc: Dict[str, Any]) -> None:
                self._reply_raw(code,
                                json.dumps(doc, default=float).encode(),
                                "application/json")

            def _reply_raw(self, code: int, body: bytes,
                           content_type: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    live = engine.live()
                    self._reply(200 if live else 503, {"live": live})
                elif self.path == "/readyz":
                    ready = engine.ready()
                    self._reply(200 if ready else 503, {"ready": ready})
                elif self.path == "/statusz":
                    self._reply(200, engine.status())
                elif self.path == "/metricsz":
                    from ..telemetry.metrics import prometheus_text
                    self._reply_raw(
                        200, prometheus_text(engine.status()).encode(),
                        "text/plain; version=0.0.4; charset=utf-8")
                else:
                    self._reply(404, {"error": f"no route {self.path}"})

        self._httpd = ThreadingHTTPServer((self.host, self._port), Handler)
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="tm-serving-health")
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
