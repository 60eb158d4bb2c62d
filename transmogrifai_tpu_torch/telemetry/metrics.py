"""Prometheus text exposition for the serving/continuum status snapshots.

/statusz serves one nested JSON document — great for a human, hostile
to a scraper (no stable flat names, no type information, every poll
re-parses the world). This module adapts the EXISTING snapshot
counters (EngineStats / FleetStats / ContinuumStats / ScoringStats /
CacheStats / FaultStats — none of them re-instrumented) into typed
counter/gauge/summary families rendered in the Prometheus text
exposition format (version 0.0.4), served by ``HealthServer`` at
``/metricsz``.

Contract (pinned by tests/test_telemetry.py):

* **Stable names.** Every family is spelled here, once, with the
  ``tm_`` prefix; cumulative counters end ``_total``. Renaming a
  metric is an API break.
* **Labels, not nesting.** Fleet replicas ride a ``replica`` label on
  the same family a single engine emits unlabeled; scoring stats carry
  ``version``/``bucket``; drift scores carry ``feature``; fused-sweep
  per-chip dispatch attribution carries ``device``. Label values
  are escaped per the exposition spec (backslash, quote, newline).
* **Monotonic counters.** ``_total`` families come straight from the
  cumulative snapshot counters, so consecutive scrapes never regress
  (the promise recording rules and rate() depend on).

The adapter is a PURE function of a status document
(:func:`prometheus_text`), duck-typed over the three snapshot shapes
the stack produces — a single engine's ``status_snapshot``, a fleet's
aggregated ``ServingFleet.status()``, and a continuum controller's
``status()`` (serving doc + ``continuum`` block) — so ``HealthServer``
needs no knowledge of what it fronts.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

__all__ = ["Metric", "render", "metrics_from_status", "prometheus_text"]

#: continuum state -> gauge value (stable enumeration; append-only)
CONTINUUM_STATES = ("monitoring", "retraining", "gating", "shadowing",
                    "promoting", "cooldown", "stopped")
#: breaker state -> gauge value
BREAKER_STATES = ("closed", "half_open", "open")


class Metric:
    """One metric family: name, type, help, and (labels, value)
    samples. ``mtype`` is counter | gauge | summary."""

    __slots__ = ("name", "mtype", "help", "samples")

    def __init__(self, name: str, mtype: str, help_text: str):
        self.name = name
        self.mtype = mtype
        self.help = help_text
        self.samples: List[Tuple[str, Dict[str, Any], Any]] = []

    def add(self, value, labels: Optional[Dict[str, Any]] = None,
            suffix: str = "") -> None:
        """Add one sample; ``suffix`` builds summary ``_sum``/``_count``
        lines. None values are skipped (absent, not zero)."""
        if value is None:
            return
        self.samples.append((suffix, dict(labels or {}), value))


class _Registry:
    """Accumulates families across adapter passes so a fleet's N
    replicas merge into ONE family with a replica label."""

    def __init__(self):
        self._by_name: Dict[str, Metric] = {}
        self._order: List[str] = []

    def family(self, name: str, mtype: str, help_text: str) -> Metric:
        m = self._by_name.get(name)
        if m is None:
            m = Metric(name, mtype, help_text)
            self._by_name[name] = m
            self._order.append(name)
        return m

    def counter(self, name: str, help_text: str, value,
                labels: Optional[Dict[str, Any]] = None) -> None:
        self.family(name, "counter", help_text).add(value, labels)

    def gauge(self, name: str, help_text: str, value,
              labels: Optional[Dict[str, Any]] = None) -> None:
        self.family(name, "gauge", help_text).add(value, labels)

    def metrics(self) -> List[Metric]:
        return [self._by_name[n] for n in self._order]


def _escape_label(v: Any) -> str:
    return (str(v).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _escape_help(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n")


def _fmt_value(v: Any) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    return repr(float(v))


def render(metrics: List[Metric]) -> str:
    """Families -> the text exposition body. Labels sort by key so a
    family's lines are byte-stable across scrapes of the same state."""
    lines: List[str] = []
    for m in metrics:
        if not m.samples:
            continue
        lines.append(f"# HELP {m.name} {_escape_help(m.help)}")
        lines.append(f"# TYPE {m.name} {m.mtype}")
        for suffix, labels, value in m.samples:
            if labels:
                lab = ",".join(
                    f'{k}="{_escape_label(v)}"'
                    for k, v in sorted(labels.items()))
                lines.append(f"{m.name}{suffix}{{{lab}}} "
                             f"{_fmt_value(value)}")
            else:
                lines.append(f"{m.name}{suffix} {_fmt_value(value)}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# adapters: one per snapshot block
# ---------------------------------------------------------------------------

_ENGINE_COUNTERS = (
    ("submitted", "Requests accepted into the engine queue"),
    ("completed", "Requests resolved with a result"),
    ("failed", "Requests resolved with an error"),
    ("shed_expired", "Requests shed after their deadline expired queued"),
    ("cancelled", "Requests cancelled by the caller pre-dispatch"),
    ("rejected_queue_full", "Admissions rejected on queue bounds"),
    ("rejected_predicted_late",
     "Admissions rejected by the EMA deadline model"),
    ("rejected_tenant_budget",
     "Admissions rejected on one tenant's queue-share budget"),
    ("batches", "Coalesced device micro-batches dispatched"),
    ("batched_rows", "Rows dispatched inside micro-batches"),
    ("batched_requests", "Requests coalesced into micro-batches"),
    ("swaps", "Registry hot-swaps observed"),
    ("fused_batches",
     "Fused cross-model family launches (one device dispatch each)"),
    ("fused_requests", "Requests scored inside fused family launches"),
    ("fused_rows", "Rows scored inside fused family launches"),
    ("fused_models",
     "Cumulative backends co-scored across fused family launches"),
    ("fused_fallbacks",
     "Stack-ineligible groups kept on the classic path with fusion on"),
    ("tap_errors", "Request-tap callbacks that raised (swallowed)"),
)

_FLEET_COUNTERS = (
    ("routed", "Requests accepted by the fleet router"),
    ("completed", "Router futures resolved with a result"),
    ("failed", "Router futures resolved with an error"),
    ("cancelled", "Router futures cancelled by the caller"),
    ("failovers", "Re-dispatches to a different replica"),
    ("retries", "Re-dispatch attempts (any replica)"),
    ("breaker_opens", "Circuit breaker closed/half-open -> open"),
    ("breaker_probes", "Half-open probe dispatches allowed"),
    ("breaker_closes", "Half-open -> closed (probe success)"),
    ("replica_crashes", "Replica hard kills (chaos or observed dead)"),
    ("replica_restarts", "Supervisor replica restarts"),
    ("rollouts", "Staged rollouts started"),
    ("rollbacks", "Fleet-wide automatic rollbacks"),
    ("no_replica_available",
     "Dispatch attempts with every candidate down or open"),
    ("tap_errors", "Fleet tap callbacks that raised (swallowed)"),
    ("replicas_added", "Elastic scale-up replica joins"),
    ("replicas_removed", "Elastic scale-down replica drains"),
)

_CONTINUUM_COUNTERS = (
    ("ticks", "Controller monitor ticks"),
    ("observed_requests", "Tapped requests folded into drift sketches"),
    ("observed_rows", "Tapped rows folded into drift sketches"),
    ("dropped_observations", "Tap-queue overflow drops"),
    ("monitor_errors", "Monitor observe/tick bodies that raised"),
    ("windows", "Completed drift evaluation windows"),
    ("triggers", "Debounced drift triggers fired"),
    ("coalesced_triggers", "Triggers coalesced while a cycle ran"),
    ("cycles", "Retrain cycles started"),
    ("retrains", "Retrain attempts launched"),
    ("retrain_retries", "Retrain attempts after a failed/killed one"),
    ("retrain_failures", "Cycles whose retrain exhausted retries"),
    ("lint_rejects", "Candidates failing the strict lint gate"),
    ("shadow_samples", "Mirrored requests candidate-scored"),
    ("shadow_rejects", "Candidates failing the shadow verdict"),
    ("promotions", "Candidates promoted fleet/engine-wide"),
    ("promote_rollbacks", "Promotions undone by the bake window"),
    ("cycle_errors", "Cycles ended by an unexpected error"),
)


def _engine_into(reg: _Registry, snap: Dict[str, Any],
                 labels: Dict[str, Any]) -> None:
    """One engine status_snapshot -> tm_engine_*/tm_scoring_* samples
    (labeled per replica in fleet mode)."""
    eng = snap.get("engine") or {}
    for key, help_text in _ENGINE_COUNTERS:
        reg.counter(f"tm_engine_{key}_total", help_text, eng.get(key),
                    labels)
    reg.gauge("tm_engine_queue_depth_requests",
              "Requests queued right now", eng.get("queue_depth_requests"),
              labels)
    reg.gauge("tm_engine_queue_depth_rows", "Rows queued right now",
              eng.get("queue_depth_rows"), labels)
    # the autoscaler's re-priced admission margin (1.0 = at rest):
    # scrape-visible per replica so a shed storm is attributable to the
    # price that caused it
    adm = snap.get("admission") or {}
    reg.gauge("tm_engine_admission_price",
              "Re-priced EMA admission margin (1.0 = at rest)",
              adm.get("price"), labels)
    # observed batch-shape mix (pow2 rows-bucket): the bucket tuner's
    # input (autotune.buckets), scrape-visible and testable without a
    # live fleet — sourced from cumulative counters, so it never
    # regresses across scrapes like every other _total family
    for bucket, n_batches in (eng.get("batch_shapes") or {}).items():
        reg.counter("tm_engine_batch_shape_total",
                    "Coalesced micro-batches by pow2 row-count bucket",
                    n_batches, {**labels, "bucket": bucket})
    # multi-model traffic attribution, CARDINALITY-BOUNDED at source:
    # the engine snapshot carries only the top-K model ids by traffic
    # (TM_MODEL_TOPK) plus an aggregated remainder, so a 10k-model
    # catalog cannot blow up scrape size. Each named series is a
    # monotonic cumulative counter while listed; the remainder is a
    # GAUGE (a model entering the top-K moves its count out of it).
    models = eng.get("models") or {}
    for model, rec in (models.get("top") or {}).items():
        mlab = {**labels, "model": model}
        reg.counter("tm_engine_model_requests_total",
                    "Requests dispatched per model id (top-K by traffic)",
                    rec.get("requests"), mlab)
        reg.counter("tm_engine_model_rows_total",
                    "Rows dispatched per model id (top-K by traffic)",
                    rec.get("rows"), mlab)
    other = models.get("other") or {}
    if other.get("models"):
        reg.gauge("tm_engine_model_requests_other",
                  "Requests attributed to models outside the top-K "
                  "window", other.get("requests"), labels)
        reg.gauge("tm_engine_model_rows_other",
                  "Rows attributed to models outside the top-K window",
                  other.get("rows"), labels)
    reg.gauge("tm_engine_models_distinct",
              "Distinct model ids that have served traffic",
              models.get("distinct"), labels)
    # per-tenant traffic (exact up to the engine's tenant-track bound,
    # then folded into tenant="other"); label values spec-escaped like
    # every other family
    for tenant, rec in (eng.get("tenants") or {}).items():
        tlab = {**labels, "tenant": tenant}
        reg.counter("tm_engine_tenant_requests_total",
                    "Requests dispatched per tenant", rec.get("requests"),
                    tlab)
        reg.counter("tm_engine_tenant_rows_total",
                    "Rows dispatched per tenant", rec.get("rows"), tlab)
    # the registry's LRU'd weight/program cache (the model plane)
    mc = snap.get("modelCache") or {}
    reg.gauge("tm_model_cache_loaded", "Model versions currently warm",
              mc.get("loaded"), labels)
    reg.gauge("tm_model_cache_capacity",
              "LRU warm-capacity bound (absent counters mean unbounded)",
              mc.get("capacity"), labels)
    reg.gauge("tm_model_cache_aliases",
              "Tenant-facing alias ids over shared versions",
              mc.get("aliases"), labels)
    reg.counter("tm_model_cache_evictions_total",
                "Warm versions evicted by the LRU bound",
                mc.get("evictions"), labels)
    reg.counter("tm_model_cache_reloads_total",
                "Cold reloads of previously evicted versions",
                mc.get("reloads"), labels)
    reg.counter("tm_model_cache_cold_loads_total",
                "First-use lazy version loads", mc.get("cold_loads"),
                labels)
    reg.counter("tm_model_cache_coalesced_loads_total",
                "Acquires that waited on another thread's single-flight "
                "load instead of loading again",
                mc.get("coalesced_loads"), labels)
    wait = reg.family("tm_engine_wait_seconds", "summary",
                      "Queue wait from accept to device dispatch")
    if eng:
        for q, key in (("0.5", "wait_p50_ms"), ("0.99", "wait_p99_ms")):
            if eng.get(key) is not None:
                wait.add(eng[key] / 1e3, {**labels, "quantile": q})
        wait.add(eng.get("wait_seconds_total"), labels, suffix="_sum")
        served = (eng.get("completed", 0) or 0) + (eng.get("failed", 0)
                                                   or 0)
        wait.add(served, labels, suffix="_count")
    # per-segment host overhead (the request-plane Amdahl floor): the
    # always-on submit→enqueue→dispatch→resolve clock, one summary
    # series per pipeline segment plus the all-segments total
    oh = (eng.get("requestOverhead") or {}) if eng else {}
    segs = dict(oh.get("segments") or {})
    if oh.get("total"):
        segs["total"] = oh["total"]
    if segs:
        hov = reg.family(
            "tm_engine_host_overhead_seconds", "summary",
            "Per-request host overhead by pipeline segment "
            "(admission, queue, build, resolve; 'total' = their sum)")
        n = oh.get("requests")
        for segment, rec in segs.items():
            slab = {**labels, "segment": segment}
            for q, key in (("0.5", "p50_us"), ("0.99", "p99_us")):
                if rec.get(key) is not None:
                    hov.add(rec[key] / 1e6, {**slab, "quantile": q})
            if rec.get("total_us") is not None:
                hov.add(rec["total_us"] / 1e6, slab, suffix="_sum")
            hov.add(n, slab, suffix="_count")
    for version, sc in (snap.get("scoring") or {}).items():
        vlab = {**labels, "version": version}
        for bucket, rec in (sc.get("per_bucket") or {}).items():
            blab = {**vlab, "bucket": bucket}
            reg.counter("tm_scoring_compiles_total",
                        "Fused-scorer program compiles",
                        rec.get("compiles"), blab)
            reg.counter("tm_scoring_batches_total",
                        "Fused-scorer batches dispatched",
                        rec.get("batches"), blab)
            reg.counter("tm_scoring_rows_total",
                        "Rows scored (pre-padding)", rec.get("rows"), blab)
            reg.counter("tm_scoring_padded_rows_total",
                        "Padding rows scored (wasted device work)",
                        rec.get("padded_rows"), blab)
        reg.counter("tm_scoring_seconds_total",
                    "Device scoring wall seconds", sc.get("seconds"),
                    vlab)


def _process_globals_into(reg: _Registry, snap: Dict[str, Any]) -> None:
    """Process-scoped blocks (program caches, registry loads, fault
    counters, flight recorder, tracer) — emitted ONCE per scrape, never
    per replica (each replica's snapshot repeats the same globals)."""
    for cache, rec in (snap.get("programCaches") or {}).items():
        lab = {"cache": cache}
        reg.gauge("tm_program_cache_size", "Compiled programs held",
                  rec.get("size"), lab)
        reg.gauge("tm_program_cache_capacity", "Cache LRU bound",
                  rec.get("capacity"), lab)
        reg.counter("tm_program_cache_hits_total", "Cache hits",
                    rec.get("hits"), lab)
        reg.counter("tm_program_cache_misses_total", "Cache misses",
                    rec.get("misses"), lab)
        reg.counter("tm_program_cache_evictions_total", "Cache evictions",
                    rec.get("evictions"), lab)
    for dev, rec in (snap.get("sweepDevices") or {}).items():
        lab = {"device": dev}
        reg.counter("tm_sweep_device_dispatches_total",
                    "Fused sweep shard dispatches per device",
                    rec.get("dispatches"), lab)
        reg.counter("tm_sweep_device_items_total",
                    "Sweep items (fold x grid point fits) dispatched "
                    "per device", rec.get("items"), lab)
    res = snap.get("resilience") or {}
    for key, value in (res.get("registryLoads") or {}).items():
        reg.counter(f"tm_registry_load_{key}_total",
                    f"Registry artifact load {key}", value)
    fi = res.get("faultInjection") or {}
    for point, n in (fi.get("arrivals") or {}).items():
        reg.counter("tm_fault_arrivals_total",
                    "Armed fault-point arrivals", n, {"point": point})
    for key, n in (fi.get("injected") or {}).items():
        point, _, kind = key.rpartition(":")
        reg.counter("tm_fault_injected_total", "Faults actually fired",
                    n, {"point": point, "kind": kind})
    fr = snap.get("flightRecorder") or {}
    reg.counter("tm_flight_recorder_events_total",
                "Control-plane events recorded", fr.get("events_total"))
    tel = snap.get("telemetry") or {}
    reg.counter("tm_trace_spans_total", "Spans recorded by the tracer",
                tel.get("recorded"))
    reg.gauge("tm_trace_sample_rate", "Configured trace sample rate",
              tel.get("sample"))


#: wire-plane counters (serving.transport TransportStats) that ride
#: tm_transport_*_total verbatim, labeled per replica + worker identity
_TRANSPORT_COUNTERS = (
    ("requests", "Wire round trips resolved with scores"),
    ("errors", "Wire round trips resolved with an error"),
    ("disconnects", "Transport connections torn (any reason)"),
    ("reconnects", "Successful transport re-dials"),
)


def _transport_into(reg: _Registry, tr: Dict[str, Any],
                    labels: Dict[str, Any]) -> None:
    """One replica's ``transport`` block (socket binding only) ->
    tm_transport_* samples. The ``worker`` label carries the worker
    identity (``name@pid``) so a respawn — new pid, new series — is
    visible as such in the scrape; ``generation`` counts respawns."""
    labels = {**labels, "worker": tr.get("worker") or tr.get("name")}
    for key, help_text in _TRANSPORT_COUNTERS:
        reg.counter(f"tm_transport_{key}_total", help_text, tr.get(key),
                    labels)
    reg.gauge("tm_transport_generation",
              "Worker spawn generation (increments on supervisor "
              "respawn)", tr.get("generation"), labels)
    wirefam = reg.family(
        "tm_transport_wire_seconds", "summary",
        "Client-attributed wire overhead per round trip "
        "(RTT minus worker-reported engine seconds)")
    rttfam = reg.family(
        "tm_transport_rtt_seconds", "summary",
        "Full client-observed round-trip time per request")
    for fam, stem in ((wirefam, "wire"), (rttfam, "rtt")):
        for q, key in (("0.5", f"{stem}_p50_us"),
                       ("0.99", f"{stem}_p99_us")):
            if tr.get(key) is not None:
                fam.add(tr[key] / 1e6, {**labels, "quantile": q})
        fam.add(tr.get("sampled"), labels, suffix="_count")


def _fleet_into(reg: _Registry, doc: Dict[str, Any]) -> None:
    fl = doc.get("fleet") or {}
    for key, help_text in _FLEET_COUNTERS:
        reg.counter(f"tm_fleet_{key}_total", help_text, fl.get(key))
    # gray-failure families (hedging / ejection / budgets) keep the
    # tm_router_*/tm_retry_budget_* spellings the dashboards alert on
    reg.counter("tm_router_hedges_total",
                "Speculative hedged dispatches fired", fl.get("hedges"))
    reg.counter("tm_router_hedge_wins_total",
                "Hedged dispatches that resolved their request first",
                fl.get("hedge_wins"))
    reg.counter("tm_router_ejections_total",
                "Hung replicas ejected from the placement ring",
                fl.get("ejections"))
    reg.counter("tm_router_readmissions_total",
                "Degraded replicas readmitted (probe ok or restarted)",
                fl.get("readmissions"))
    reg.counter("tm_retry_budget_exhausted_total",
                "Retries/hedges denied by the token budget",
                fl.get("retry_budget_exhausted"))
    reg.counter("tm_router_deadline_sheds_total",
                "Requests shed at the router below the deadline floor",
                fl.get("deadline_sheds"))
    for replica, n in (fl.get("dispatches") or {}).items():
        reg.counter("tm_fleet_dispatches_total",
                    "Requests dispatched per replica", n,
                    {"replica": replica})
    for replica, b in (doc.get("breakers") or {}).items():
        state = b.get("state")
        if state in BREAKER_STATES:
            reg.gauge("tm_fleet_breaker_state",
                      "Breaker state (0=closed 1=half_open 2=open)",
                      BREAKER_STATES.index(state), {"replica": replica})
    reg.gauge("tm_fleet_replicas", "Configured replica count",
              doc.get("replica_count"))
    snaps = doc.get("replicas") or {}
    for replica, snap in snaps.items():
        _engine_into(reg, snap, {"replica": replica})
        sup = snap.get("supervision") or {}
        reg.gauge("tm_fleet_replica_dead",
                  "1 while a replica awaits its supervised restart",
                  sup.get("dead"), {"replica": replica})
        tr = snap.get("transport") or {}
        if tr.get("kind") == "socket":
            _transport_into(reg, tr, {"replica": replica})
    # process-scoped blocks: caches/faults ride each replica snapshot
    # (identical copies — read the first), flight recorder + tracer
    # ride the fleet doc top-level; emitted exactly once either way
    merged = dict(next(iter(snaps.values()), {}))
    merged["flightRecorder"] = doc.get("flightRecorder")
    merged["telemetry"] = doc.get("telemetry")
    _process_globals_into(reg, merged)


#: scaler counters that ride tm_scaler_*_total verbatim
_SCALER_COUNTERS = (
    ("ticks", "Autoscaler evaluation-loop wakeups"),
    ("evaluations", "Ticks that sampled pressure and decided"),
    ("evaluations_dropped", "Evaluations lost to injected/tick faults"),
    ("pressure_breaches", "Ticks over the scale-up thresholds"),
    ("calm_ticks", "Ticks under the scale-down thresholds"),
    ("forecast_breaches", "Forecasts projecting load over capacity"),
    ("decisions_deferred", "Decisions skipped (action in flight)"),
    ("replicas_added", "Replicas provisioned and joined"),
    ("replicas_removed", "Replicas drained and removed"),
    ("provision_retries", "Replica builds retried after a failure"),
    ("provision_failures", "Scale-ups abandoned (retries spent)"),
    ("reprices", "Admission price pushes"),
)


def _scaler_into(reg: _Registry, sc: Dict[str, Any]) -> None:
    """The autoscaler block -> tm_fleet_scale_* / tm_scaler_*
    families. Scale events ride ONE family with a direction label
    (sourced from the cumulative scale_ups/scale_downs counters, so
    scrapes never regress)."""
    stats = sc.get("stats") or {}
    for direction, key in (("up", "scale_ups"), ("down", "scale_downs")):
        reg.counter("tm_fleet_scale_events_total",
                    "Applied scaling decisions by direction",
                    stats.get(key), {"direction": direction})
    reg.gauge("tm_fleet_target_replicas",
              "The autoscaler's current target replica count",
              sc.get("target_replicas"))
    reg.gauge("tm_fleet_live_replicas",
              "Live non-draining replicas right now",
              sc.get("live_replicas"))
    for key, help_text in _SCALER_COUNTERS:
        reg.counter(f"tm_scaler_{key}_total", help_text, stats.get(key))
    fc = sc.get("forecast") or {}
    reg.gauge("tm_scaler_forecast_rps",
              "Projected arrival rate at the forecast horizon",
              fc.get("predicted_rps"))
    reg.gauge("tm_scaler_capacity_rps",
              "Estimated per-replica sustainable request rate",
              fc.get("capacity_rps"))
    reg.gauge("tm_scaler_price",
              "Last admission price pushed to the replicas",
              sc.get("price"))
    reg.gauge("tm_scaler_last_scale_up_seconds",
              "Provision-to-serving latency of the last scale-up",
              stats.get("last_scale_up_s"))


def _continuum_into(reg: _Registry, cont: Dict[str, Any]) -> None:
    stats = cont.get("stats") or {}
    for key, help_text in _CONTINUUM_COUNTERS:
        reg.counter(f"tm_continuum_{key}_total", help_text,
                    stats.get(key))
    state = cont.get("state")
    if state in CONTINUUM_STATES:
        reg.gauge("tm_continuum_state",
                  "Controller state (monitoring=0 retraining=1 gating=2 "
                  "shadowing=3 promoting=4 cooldown=5 stopped=6)",
                  CONTINUUM_STATES.index(state))
    reg.gauge("tm_continuum_cycle", "Retrain cycle counter",
              cont.get("cycle"))
    for feature, score in (stats.get("last_drift_scores") or {}).items():
        reg.gauge("tm_continuum_drift_score",
                  "Last window's per-feature JS divergence", score,
                  {"feature": feature})
    for feature, score in (stats.get("peak_drift_scores") or {}).items():
        reg.gauge("tm_continuum_drift_score_peak",
                  "Peak per-feature JS divergence observed", score,
                  {"feature": feature})


def metrics_from_status(doc: Dict[str, Any]) -> List[Metric]:
    """Duck-typed over the three snapshot shapes (engine / fleet /
    controller-wrapped): see module docstring."""
    reg = _Registry()
    reg.gauge("tm_live", "Liveness (the /healthz answer)",
              doc.get("live"))
    reg.gauge("tm_ready", "Readiness (the /readyz answer)",
              doc.get("ready"))
    if "fleet" in doc and "replicas" in doc:
        _fleet_into(reg, doc)
    elif "engine" in doc:
        _engine_into(reg, doc, {})
        _process_globals_into(reg, doc)
    if "continuum" in doc:
        _continuum_into(reg, doc["continuum"])
    if "scaler" in doc:
        _scaler_into(reg, doc["scaler"])
    return reg.metrics()


def prometheus_text(doc: Dict[str, Any]) -> str:
    """status document -> the full /metricsz body."""
    return render(metrics_from_status(doc))
