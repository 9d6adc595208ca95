"""Span tracing with a flight recorder: a copy of
kubernetes_tpu/observability/tracer.py. The cross-component metrics
registry is not ported yet (ROADMAP, the harnesses and commands item)."""

from .tracer import (DEFAULT_POD_SAMPLE, FlightRecorder, NULL_TRACER,
                     Span, SpanTracer, nearest_rank_percentile,
                     stage_percentiles)

__all__ = [
    "DEFAULT_POD_SAMPLE", "FlightRecorder", "NULL_TRACER", "Span",
    "SpanTracer", "nearest_rank_percentile", "stage_percentiles",
]
