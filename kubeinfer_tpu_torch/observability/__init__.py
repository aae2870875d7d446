"""Request-scoped observability: tracing, trace-context propagation,
Chrome trace export, step-level engine profiling (``stepprof.py``), the
scheduler flight recorder (``flightrecorder.py``) and SLO burn-rate
monitoring (``slo.py``), and the fleet plane: trace-driven load
generation (``loadgen.py``) and cross-replica request ledgers, merged
traces and envelope analytics (``fleetview.py``); copies of
``kubeinfer_tpu/observability``'s modules of the same names. As in the
reference, ``loadgen`` and ``fleetview`` are not re-exported from the
package root: import the submodules. ``python -m
kubeinfer_tpu_torch.observability`` writes one traced request's Chrome
trace (``__main__.py``)."""

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
