"""Request-scoped tracing: spans, trace-context propagation and Chrome
trace export (a copy of the tracing part of
``kubeinfer_tpu/observability``), and the SLO burn-rate monitor
(``slo.py``, imported from there). The flight recorder and the step
profiler are not ported yet."""

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

__all__ = [
    "RECORDER",
    "Span",
    "SpanContext",
    "SpanRecorder",
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
