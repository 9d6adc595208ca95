"""Event recording — the client-go tools/record analog.

Ref: staging/src/k8s.io/client-go/tools/record (EventRecorder,
EventBroadcaster, events_cache.go EventAggregator/eventLogger): events
are correlated before they hit the API — identical events increment
`count` on one object instead of creating thousands, similar events
aggregate under a synthetic message, and a token-bucket filter caps the
per-source burst rate.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

from ..api.core import Event, ObjectReference
from ..api.meta import ObjectMeta
from ..utils.clock import Clock, REAL_CLOCK, now_iso

#: distinct (involved object, reason) keys before aggregation kicks in
AGGREGATION_THRESHOLD = 10  # ref: events_cache.go defaultAggregateMaxEvents


class _TokenBucket:
    """Ref: the spam filter's rate limiter (events_cache.go
    EventSourceObjectSpamFilter: burst 25, refill ~1/300s)."""

    def __init__(self, burst: int, refill_per_sec: float, clock: Clock):
        self.burst = burst
        self.refill = refill_per_sec
        self.clock = clock
        self.tokens = float(burst)
        self.last = clock.now()

    def allow(self) -> bool:
        now = self.clock.now()
        self.tokens = min(self.burst,
                          self.tokens + (now - self.last) * self.refill)
        self.last = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


class EventRecorder:
    """Correlating recorder writing through a client's events() surface."""

    MAX_CACHE = 4096  # LRU bound (ref: events_cache.go lru.New(maxLruCacheEntries))

    def __init__(self, client, component: str = "",
                 clock: Clock = REAL_CLOCK,
                 burst: int = 25, refill_per_sec: float = 1.0 / 300.0,
                 tracer=None):
        self.client = client
        self.component = component
        self.clock = clock
        #: observability.SpanTracer (optional): every recorded event also
        #: lands as an instant span under the pod's trace, so the flight
        #: recorder shows FailedScheduling next to the queue/drain spans
        self.tracer = tracer
        self.burst = burst
        self.refill_per_sec = refill_per_sec
        self._lock = threading.Lock()
        # (ns, involved uid, reason, message) -> event name (count bumping);
        # insertion-ordered dicts double as LRU rings (evict oldest)
        self._seen: Dict[Tuple, str] = {}
        # (ns, involved uid, reason) -> distinct message count (aggregation)
        self._similar: Dict[Tuple, int] = {}
        self._buckets: Dict[Tuple, _TokenBucket] = {}
        self.dropped = 0

    def _evict(self, d: Dict) -> None:
        while len(d) > self.MAX_CACHE:
            d.pop(next(iter(d)))

    def event(self, obj, event_type: str, reason: str, message: str) -> None:
        """Record one event against `obj` (any API object or an
        ObjectReference-shaped thing)."""
        meta = getattr(obj, "metadata", None)
        ref = ObjectReference(
            kind=getattr(obj, "kind", ""),
            namespace=meta.namespace if meta
            else getattr(obj, "namespace", ""),
            name=meta.name if meta else getattr(obj, "name", ""),
            uid=meta.uid if meta else getattr(obj, "uid", ""))
        ns = ref.namespace or "default"
        if self.tracer is not None and self.tracer.enabled \
                and (ref.uid or ref.name):
            # before correlation: the span log should show every attempt
            # the dedup below collapses into one Event object's count
            if self.tracer.sampled(ref.uid or ref.name):
                self.tracer.event("events", reason,
                                  trace_id=ref.uid or ref.name,
                                  pod=f"{ns}/{ref.name}")
        spam_key = (ns, ref.uid or ref.name)
        agg_key = (ns, ref.uid or ref.name, reason)
        full_key = agg_key + (message,)
        with self._lock:
            bucket = self._buckets.get(spam_key)
            if bucket is None:
                bucket = _TokenBucket(self.burst, self.refill_per_sec,
                                      self.clock)
                self._buckets[spam_key] = bucket
                self._evict(self._buckets)
            existing_name = self._seen.get(full_key)
            if existing_name is None and not bucket.allow():
                self.dropped += 1
                return
            if existing_name is None:
                if self._similar.get(agg_key, 0) >= AGGREGATION_THRESHOLD:
                    # aggregate: one synthetic bucket for the reason
                    message = f"(combined from similar events): {message}"
                    full_key = agg_key + ("__aggregated__",)
                    existing_name = self._seen.get(full_key)
        if existing_name is not None:
            def bump(cur):
                cur.count += 1
                cur.last_timestamp = now_iso(self.clock)
                return cur
            try:
                self.client.events(ns).patch(existing_name, bump)
                return
            except Exception:
                pass  # fall through to create
        ev = Event(
            metadata=ObjectMeta(
                generate_name=f"{ref.name}.", namespace=ns),
            involved_object=ref, reason=reason, message=message,
            type=event_type, count=1,
            source={"component": self.component},
            first_timestamp=now_iso(self.clock),
            last_timestamp=now_iso(self.clock))
        try:
            created = self.client.events(ns).create(ev)
        except Exception:
            return
        with self._lock:
            self._seen[full_key] = created.metadata.name
            self._evict(self._seen)
            # a distinct message consumed a slot only once it LANDED — a
            # transiently failing store must not burn the threshold
            if not full_key[-1] == "__aggregated__":
                self._similar[agg_key] = self._similar.get(agg_key, 0) + 1
                self._evict(self._similar)
