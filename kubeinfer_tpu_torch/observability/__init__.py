"""Request-scoped observability: tracing, trace-context propagation,
Chrome trace export, step-level engine profiling (``stepprof.py``), the
scheduler flight recorder (``flightrecorder.py``) and SLO burn-rate
monitoring (``slo.py``): copies of ``kubeinfer_tpu/observability``'s
modules of the same names. The fleet plane (``loadgen``, ``fleetview``
and the package's ``__main__``) is not ported: its only consumer is the
fleet bench."""

from kubeinfer_tpu_torch.observability.tracing import (
    RECORDER,
    Span,
    SpanContext,
    SpanRecorder,
    TraceContextFilter,
    Tracer,
    add_event,
    current_context,
    current_span,
    get_tracer,
    new_root_context,
    now,
    parse_traceparent,
    set_clock,
    set_span_sampling,
    span_sampling,
    to_chrome_trace,
    trace_sampled,
)
from kubeinfer_tpu_torch.observability.flightrecorder import (
    FlightEvent,
    FlightRecorder,
)
from kubeinfer_tpu_torch.observability.slo import SLOMonitor, SLOObjective
from kubeinfer_tpu_torch.observability.stepprof import StepProfiler, StepRecord

__all__ = [
    "FlightEvent",
    "FlightRecorder",
    "RECORDER",
    "SLOMonitor",
    "SLOObjective",
    "Span",
    "SpanContext",
    "SpanRecorder",
    "StepProfiler",
    "StepRecord",
    "TraceContextFilter",
    "Tracer",
    "add_event",
    "current_context",
    "current_span",
    "get_tracer",
    "new_root_context",
    "now",
    "parse_traceparent",
    "set_clock",
    "set_span_sampling",
    "span_sampling",
    "to_chrome_trace",
    "trace_sampled",
]
