"""Span tracing — follow one pod across components, deterministically.

Ref: the reference traces each scheduling attempt with utiltrace
(generic_scheduler.go:185) and exports nothing structured; here the span
layer is first-class: every span carries a trace_id (pod UID for
lifecycle spans, "" for batch/stage spans), timestamps come from an
INJECTABLE clock (REAL_CLOCK or the shared FakeClock), and spans land in
a bounded in-memory flight recorder.

Determinism contract (the chaos harness's, extended to traces): on a
FakeClock with synchronous stepping, two same-seed runs produce
byte-identical span logs — timestamps are virtual, pod UIDs are the
store's deterministic counters, and sampling is a pure function of
trace_id. The exported JSONL is canonically ordered (export_jsonl), so
the contract rests on the deterministic SET of spans, not on which
informer thread's append won a race within a settle window.

Cost model: batch/stage spans are one record per batch (always on);
pod-lifecycle spans are sampled 1-in-`pod_sample` by a crc32 of the
trace_id (default 16, KTPU_TRACE_SAMPLE overrides; harnesses pass 1 to
capture every pod). The recorder is a per-component ring — oldest spans
evict, and the eviction count is itself visible (`dropped`).
"""

from __future__ import annotations

import json
import os
import threading
import zlib
from collections import deque
from typing import Dict, Iterable, List, Optional

from ..utils.clock import Clock, REAL_CLOCK

#: 1-in-N pod-lifecycle sampling when the caller does not choose
#: (KTPU_TRACE_SAMPLE overrides; 1 = trace every pod, 0 = disable)
DEFAULT_POD_SAMPLE = 16


class Span:
    """One recorded interval (start == end for instant events)."""

    __slots__ = ("trace_id", "component", "name", "start", "end", "attrs")

    def __init__(self, trace_id: str, component: str, name: str,
                 start: float, end: float,
                 attrs: Optional[dict] = None):
        self.trace_id = trace_id
        self.component = component
        self.name = name
        self.start = start
        self.end = end
        self.attrs = attrs or {}

    @property
    def duration(self) -> float:
        return self.end - self.start

    def to_dict(self) -> dict:
        d = {"component": self.component, "name": self.name,
             "trace": self.trace_id, "start": self.start, "end": self.end}
        if self.attrs:
            d["attrs"] = self.attrs
        return d

    def to_line(self) -> str:
        # sort_keys: the byte-identity contract must not hinge on dict
        # insertion order surviving refactors
        return json.dumps(self.to_dict(), sort_keys=True)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Span({self.to_line()})"


class FlightRecorder:
    """Bounded per-component span buffers, JSONL-exportable.

    Oldest spans evict when a component's ring fills; the drop count per
    component is kept so a truncated export never silently reads as "the
    whole history"."""

    DEFAULT_CAPACITY = 8192

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = max(1, int(capacity))
        self._lock = threading.Lock()
        self._buffers: Dict[str, deque] = {}
        self.dropped: Dict[str, int] = {}

    def record(self, span: Span) -> None:
        with self._lock:
            buf = self._buffers.get(span.component)
            if buf is None:
                buf = self._buffers[span.component] = deque(
                    maxlen=self.capacity)
            if len(buf) == buf.maxlen:
                self.dropped[span.component] = \
                    self.dropped.get(span.component, 0) + 1
            buf.append(span)

    def components(self) -> List[str]:
        with self._lock:
            return sorted(self._buffers)

    def spans(self, component: Optional[str] = None,
              trace_id: Optional[str] = None,
              name: Optional[str] = None) -> List[Span]:
        """Snapshot (insertion order per component, components sorted)."""
        with self._lock:
            if component is not None:
                items = list(self._buffers.get(component, ()))
            else:
                items = [s for c in sorted(self._buffers)
                         for s in self._buffers[c]]
        if trace_id is not None:
            items = [s for s in items if s.trace_id == trace_id]
        if name is not None:
            items = [s for s in items if s.name == name]
        return items

    def export_jsonl(self, component: Optional[str] = None,
                     trace_id: Optional[str] = None) -> str:
        """One JSON object per line in CANONICAL order — sorted by
        (component, start, rendered line). The byte-identity contract is
        asserted on this export: the SET of spans is deterministic under
        the harness's settling contract, while two informer delivery
        threads may interleave their appends within one settle window —
        canonical ordering keeps that non-signal out of the bytes."""
        spans = self.spans(component=component, trace_id=trace_id)
        lines = sorted((s.component, s.start, s.to_line()) for s in spans)
        return "\n".join(line for _, _, line in lines) \
            + ("\n" if lines else "")

    def clear(self) -> None:
        with self._lock:
            self._buffers.clear()
            self.dropped.clear()

    def __len__(self) -> int:
        with self._lock:
            return sum(len(b) for b in self._buffers.values())


class SpanTracer:
    """The emitting half: components call record()/event()/pod_event()
    and the spans land in the shared FlightRecorder. All timestamps come
    from the injected clock — REAL_CLOCK in production, the harness's
    FakeClock under test (same seed => identical span logs)."""

    def __init__(self, clock: Clock = REAL_CLOCK,
                 recorder: Optional[FlightRecorder] = None,
                 pod_sample: Optional[int] = None,
                 enabled: bool = True):
        self.clock = clock
        self.recorder = recorder if recorder is not None else FlightRecorder()
        if pod_sample is None:
            pod_sample = int(os.environ.get("KTPU_TRACE_SAMPLE",
                                            DEFAULT_POD_SAMPLE))
        self.pod_sample = max(0, int(pod_sample))
        self.enabled = enabled and self.pod_sample != 0

    def now(self) -> float:
        """Span timestamps: monotonic on the real clock (NTP steps must
        never yield a negative stage duration), virtual time on FakeClock
        — the two coincide there, preserving determinism."""
        return self.clock.monotonic()

    def sampled(self, trace_id: str) -> bool:
        """Deterministic 1-in-N per trace: a pure function of trace_id,
        so the SAME pods are traced in every same-seed run (and across
        components within one run)."""
        if self.pod_sample <= 1:
            return self.enabled
        return zlib.crc32(trace_id.encode()) % self.pod_sample == 0

    def record(self, component: str, name: str, start: float,
               end: Optional[float] = None, trace_id: str = "",
               **attrs) -> None:
        """Record a finished interval (batch/stage spans — always on)."""
        if not self.enabled:
            return
        self.recorder.record(Span(trace_id, component, name, start,
                                  end if end is not None else start,
                                  attrs or None))

    def event(self, component: str, name: str, trace_id: str = "",
              **attrs) -> None:
        """Instant span at now() (unsampled — callers own the rate)."""
        if not self.enabled:
            return
        t = self.clock.monotonic()
        self.recorder.record(Span(trace_id, component, name, t, t,
                                  attrs or None))

    def pod_event(self, component: str, name: str, pod, **attrs) -> None:
        """Pod-lifecycle milestone, trace_id = pod UID, sampled 1-in-N.
        The hot-path shape: one crc32 per call for unsampled pods."""
        if not self.enabled:
            return
        meta = pod.metadata
        tid = meta.uid or meta.key()
        if self.pod_sample > 1 and \
                zlib.crc32(tid.encode()) % self.pod_sample != 0:
            return
        t = self.clock.monotonic()
        a = {"pod": meta.key()}
        if attrs:
            a.update(attrs)
        self.recorder.record(Span(tid, component, name, t, t, a))


#: a disabled tracer callers can share instead of None-checking
NULL_TRACER = SpanTracer(enabled=False, pod_sample=1)


def nearest_rank_percentile(sorted_vals: List[float], q: float) -> float:
    """THE nearest-rank percentile over a SORTED sample list — the one
    definition shared by the serving SLO tracker (serving/slo.percentile
    delegates here) and the span stage reports, so the two surfaces
    bench --trace cross-checks can never desynchronize."""
    if not sorted_vals:
        return 0.0
    import math
    rank = max(1, math.ceil(q * len(sorted_vals)))
    return sorted_vals[rank - 1]


def stage_percentiles(recorder: FlightRecorder,
                      component: Optional[str] = None,
                      names: Optional[Iterable[str]] = None) -> dict:
    """Per-stage duration percentiles from batch/stage spans (trace-less
    spans with a real interval) — the bench's --trace report and the
    cross-check against measure_device_profile's pipeline section."""
    by_name: Dict[str, List[float]] = {}
    for s in recorder.spans(component=component):
        if s.trace_id:
            continue  # pod milestones are instants, not stages
        if names is not None and s.name not in names:
            continue
        by_name.setdefault(s.name, []).append(s.duration)
    out = {}
    for name, vals in sorted(by_name.items()):
        vals.sort()
        out[name] = {
            "count": len(vals),
            "p50_s": round(nearest_rank_percentile(vals, 0.50), 6),
            "p95_s": round(nearest_rank_percentile(vals, 0.95), 6),
            "p99_s": round(nearest_rank_percentile(vals, 0.99), 6),
            "total_s": round(sum(vals), 6),
        }
    return out
