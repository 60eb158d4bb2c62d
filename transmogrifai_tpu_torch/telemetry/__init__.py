"""Telemetry for the ported serving path: sampled span tracing
(:mod:`telemetry.spans`, ``TM_TRACE_SAMPLE``) and the bounded
control-plane flight recorder (:mod:`telemetry.recorder`). The
Prometheus exposition (``telemetry.metrics``) is not ported yet."""
from .recorder import RECORDER, FlightRecorder, record
from .spans import TRACER, Tracer, configure, get_trace, set_trace

__all__ = [
    "TRACER", "Tracer", "configure", "get_trace", "set_trace",
    "RECORDER", "FlightRecorder", "record",
]
