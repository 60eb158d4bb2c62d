"""Telemetry for the ported serving path: sampled span tracing
(:mod:`telemetry.spans`, ``TM_TRACE_SAMPLE``), the bounded
control-plane flight recorder (:mod:`telemetry.recorder`) and the
Prometheus text exposition of the status snapshots
(:mod:`telemetry.metrics`, served at ``/metricsz``; the same ``tm_*``
families and labels as the JAX package's, byte for byte on the same
document)."""
from .recorder import RECORDER, FlightRecorder, record
from .metrics import metrics_from_status, prometheus_text
from .spans import TRACER, Tracer, configure, get_trace, set_trace

__all__ = [
    "TRACER", "Tracer", "configure", "get_trace", "set_trace",
    "RECORDER", "FlightRecorder", "record",
    "metrics_from_status", "prometheus_text",
]
