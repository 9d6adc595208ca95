"""Prometheus-style metrics: Counter / Gauge / Histogram + text exposition.

Ref: the reference instruments every component with prometheus client_golang
(e.g. pkg/scheduler/metrics/metrics.go, apiserver endpoints/metrics). This
is the minimal compatible core: labeled metric families, histogram buckets
matching prometheus semantics (+Inf bucket, _sum/_count), and the text
exposition format scrapers parse.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

DEFAULT_BUCKETS = (0.001, 0.002, 0.004, 0.008, 0.016, 0.032, 0.064, 0.128,
                   0.256, 0.512, 1.024, 2.048, 4.096, 8.192, 16.384)

#: codec-latency buckets: payload encode/decode runs in the micro- to
#: low-millisecond range, far below DEFAULT_BUCKETS' 1ms floor
WIRE_CODEC_BUCKETS = (0.00001, 0.00005, 0.0001, 0.0005, 0.001,
                      0.005, 0.02, 0.1, 0.5)


def _label_key(labels: Dict[str, str]) -> Tuple:
    return tuple(sorted(labels.items()))


def _fmt_labels(labels: Tuple) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + inner + "}"


def expose_histogram_series(name: str, buckets: Sequence[float],
                            items) -> List[str]:
    """Histogram sample lines (no header) from (label key, (per-bucket
    counts, sum, count)) items — shared by Histogram.expose and the
    observability MetricsRegistry's label-wise merge, so the two paths
    can never drift in format."""
    out: List[str] = []
    for key, (counts, total, n) in items:
        acc = 0
        for i, b in enumerate(buckets):
            acc += counts[i]
            lab = dict(key)
            lab["le"] = repr(b) if b != int(b) else str(b)
            out.append(f"{name}_bucket{_fmt_labels(_label_key(lab))} {acc}")
        lab = dict(key)
        lab["le"] = "+Inf"
        out.append(f"{name}_bucket{_fmt_labels(_label_key(lab))} {n}")
        out.append(f"{name}_sum{_fmt_labels(key)} {total}")
        out.append(f"{name}_count{_fmt_labels(key)} {n}")
    return out


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_text: str = ""):
        self.name = name
        self.help = help_text
        self._lock = threading.Lock()

    def expose(self) -> List[str]:  # pragma: no cover - abstract
        raise NotImplementedError

    def clear(self) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def _header(self) -> List[str]:
        return [f"# HELP {self.name} {self.help}",
                f"# TYPE {self.name} {self.kind}"]


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name: str, help_text: str = ""):
        super().__init__(name, help_text)
        self._values: Dict[Tuple, float] = {}

    def inc(self, n: float = 1.0, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + n

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def clear(self) -> None:
        with self._lock:
            self._values.clear()

    def snapshot(self) -> Dict[Tuple, float]:
        """Label key -> value copy (the aggregator's merge input)."""
        with self._lock:
            return dict(self._values)

    def expose(self) -> List[str]:
        with self._lock:
            items = sorted(self._values.items())
        out = self._header()
        for key, v in items or [((), 0.0)]:
            out.append(f"{self.name}{_fmt_labels(key)} {v}")
        return out


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name: str, help_text: str = "", fn=None):
        super().__init__(name, help_text)
        self._values: Dict[Tuple, float] = {}
        self._fn = fn  # callback gauge: sampled at expose time

    def set(self, v: float, **labels) -> None:
        with self._lock:
            self._values[_label_key(labels)] = float(v)

    def inc(self, n: float = 1.0, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + n

    def dec(self, n: float = 1.0, **labels) -> None:
        self.inc(-n, **labels)

    def value(self, **labels) -> float:
        if self._fn is not None:
            return float(self._fn())
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def clear(self) -> None:
        with self._lock:
            self._values.clear()

    def snapshot(self) -> Dict[Tuple, float]:
        """Label key -> value copy (callback gauges sample the fn)."""
        if self._fn is not None:
            return {(): float(self._fn())}
        with self._lock:
            return dict(self._values)

    def expose(self) -> List[str]:
        out = self._header()
        if self._fn is not None:
            out.append(f"{self.name} {float(self._fn())}")
            return out
        with self._lock:
            items = sorted(self._values.items())
        for key, v in items or [((), 0.0)]:
            out.append(f"{self.name}{_fmt_labels(key)} {v}")
        return out


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help_text: str = "",
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help_text)
        self.buckets = tuple(buckets)
        # label key -> (bucket counts, sum, count)
        self._series: Dict[Tuple, list] = {}

    def observe(self, v: float, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = [[0] * (len(self.buckets) + 1), 0.0, 0]
                self._series[key] = s
            for i, b in enumerate(self.buckets):
                if v <= b:
                    s[0][i] += 1
                    break
            else:
                s[0][-1] += 1
            s[1] += v
            s[2] += 1

    def count(self, **labels) -> int:
        with self._lock:
            s = self._series.get(_label_key(labels))
            return s[2] if s else 0

    def sum(self, **labels) -> float:
        with self._lock:
            s = self._series.get(_label_key(labels))
            return s[1] if s else 0.0

    def clear(self) -> None:
        with self._lock:
            self._series.clear()

    def quantile(self, q: float, **labels) -> float:
        """Approximate quantile with linear interpolation inside the
        owning bucket (scrape-side histogram_quantile equivalent, for
        tests and bench reporting). Interpolation matters when callers
        RATIO two quantiles: power-of-two buckets would otherwise
        quantize every ratio to a power of two."""
        with self._lock:
            s = self._series.get(_label_key(labels))
            if not s or s[2] == 0:
                return 0.0
            target = q * s[2]
            acc = 0
            lower = 0.0
            for i, c in enumerate(s[0][:-1]):
                if c > 0 and acc + c >= target:
                    frac = (target - acc) / c
                    return lower + (self.buckets[i] - lower) * frac
                acc += c
                lower = self.buckets[i]
            return float("inf")

    def snapshot(self) -> Dict[Tuple, Tuple[list, float, int]]:
        """Label key -> (per-bucket counts, sum, count) copy."""
        with self._lock:
            return {k: ([*s[0]], s[1], s[2])
                    for k, s in self._series.items()}

    def expose(self) -> List[str]:
        items = sorted(self.snapshot().items())
        out = self._header()
        out.extend(expose_histogram_series(self.name, self.buckets, items))
        return out


class GangMetrics:
    """Gang-scheduling metric families (PodGroup coscheduling). Kept here
    with the metric core — the gang gate lives below the scheduler package
    and the controller manager samples the same families — registered into
    the caller's registry so they ride the same /metrics exposition."""

    def __init__(self, registry: Optional["Registry"] = None):
        self.registry = registry if registry is not None else Registry()
        r = self.registry
        #: gangs currently held below minMember (queue gate) or waiting at
        #: the permit gate, respectively
        self.gangs_pending = r.gauge(
            "scheduler_gangs_pending",
            "PodGroups with members held back by the gang gate, by stage")
        self.gangs_admitted = r.counter(
            "scheduler_gangs_admitted_total",
            "PodGroups whose full gang passed the permit gate and bound")
        self.gangs_timed_out = r.counter(
            "scheduler_gangs_timed_out_total",
            "PodGroups whose permit wait expired; reservations rolled back")
        self.gangs_node_lost = r.counter(
            "scheduler_gangs_node_lost_total",
            "PodGroups whose reservations rolled back because a reserved "
            "node died (deleted or NoExecute-dead)")
        self.gangs_rejected = r.counter(
            "scheduler_gangs_rejected_total",
            "Gangs the all-or-nothing kernel could not place atomically")
        self.gang_permit_wait = r.histogram(
            "scheduler_gang_permit_wait_seconds",
            "Seconds a gang member held a reservation at the permit gate")


class InformerMetrics:
    """Reflector/informer observability: how often watch streams break,
    how they recover (resume at last_sync_rv vs full relist), and how
    stale a live stream is. One family set is shared by every informer of
    a factory — series are labeled by resource."""

    def __init__(self, registry: Optional["Registry"] = None):
        self.registry = registry if registry is not None else Registry()
        r = self.registry
        #: watch streams re-established at last_sync_rv WITHOUT a relist —
        #: the reflector resume path (a dropped connection costs one
        #: reconnect, not one LIST of every object)
        self.watch_reconnects = r.counter(
            "informer_watch_reconnects_total",
            "Watch streams re-established at last_sync_rv without a "
            "relist, by resource")
        #: full LIST+replace resyncs: first sync, 410 history overflow,
        #: or a server that lost its watch history (store restart)
        self.relists = r.counter(
            "informer_relists_total",
            "Full LIST+replace resyncs (initial sync or 410 Gone), "
            "by resource")
        #: watch streams that terminated with a recorded error (vs the
        #: server's clean close), by resource and error class
        self.watch_stream_errors = r.counter(
            "informer_watch_stream_errors_total",
            "Watch streams torn down by a stream error, by resource "
            "and reason")
        #: seconds since the last byte (events OR server heartbeats) on
        #: the informer's current watch stream; sampled while the event
        #: queue is idle. A stream past the staleness timeout is killed
        #: and resumed instead of hanging forever.
        self.watch_staleness = r.gauge(
            "informer_watch_staleness_seconds",
            "Seconds since the last byte on the informer's watch stream, "
            "by resource")
        #: streams killed by the staleness watchdog (silently-dead TCP:
        #: no FIN, no heartbeats — the read would otherwise block forever)
        self.watch_stale_kills = r.counter(
            "informer_watch_stale_kills_total",
            "Watch streams killed after heartbeat staleness, by resource")
        #: BOOKMARK heartbeat frames consumed (allowWatchBookmarks): each
        #: advances last_sync_rv through a quiet period, shrinking the
        #: window in which a reconnect would 410 into a full relist
        self.watch_bookmarks = r.counter(
            "informer_watch_bookmarks_total",
            "Watch BOOKMARK frames that advanced last_sync_rv, by resource")
        #: repoint() calls — the informer's upstream swapped to a new
        #: client (replica promotion) and the next watch round resumed at
        #: last_sync_rv through it; pairs with relists to prove the
        #: promote drill's no-relist contract
        self.repoints = r.counter(
            "informer_repoints_total",
            "Informer upstreams swapped by repoint(), by resource")


class RobustnessMetrics:
    """Failure-handling metric families: retried/abandoned API writes
    (utils/backoff.retry), gang-atomic evictions (nodelifecycle), and
    chaos-injected faults (chaos/injector). Registered into the caller's
    registry so they ride the same /metrics exposition as the component
    that owns them."""

    def __init__(self, registry: Optional["Registry"] = None):
        self.registry = registry if registry is not None else Registry()
        r = self.registry
        #: transient API-write failures retried with backoff, by
        #: component/op — what the bare `except: pass` blocks used to hide
        self.api_retries = r.counter(
            "api_request_retries_total",
            "API writes retried after a transient failure")
        self.api_give_ups = r.counter(
            "api_request_give_ups_total",
            "API writes abandoned after exhausting the backoff policy")
        #: whole-PodGroup evictions driven by a member's node dying
        self.gang_evictions = r.counter(
            "nodelifecycle_gang_evictions_total",
            "PodGroups evicted atomically because a member's node died")
        self.pods_evicted = r.counter(
            "nodelifecycle_pods_evicted_total",
            "Pods removed or failed by the node-lifecycle eviction path")
        #: PodGroups rebuilt from Failed back to Pending as one unit
        self.gang_resubmissions = r.counter(
            "podgroup_resubmissions_total",
            "Failed PodGroups resubmitted (members recreated as a unit)")
        #: faults the chaos injector actually fired, by kind
        self.faults_injected = r.counter(
            "chaos_faults_injected_total",
            "Faults injected by the chaos harness, by kind")
        #: pipelined commits whose failure rolled chained device usage
        #: back (forget assumed pods + invalidate + phantom-mark) — the
        #: self-heal path the mid-commit chaos test drives
        self.commit_rollbacks = r.counter(
            "scheduler_pipelined_commit_rollbacks_total",
            "Pipelined commit stages that lost winners and invalidated "
            "chained device usage")
        #: records the deferred WAL worker could NOT write — silent data
        #: loss at the next replay unless someone is watching this
        self.wal_append_errors = r.counter(
            "wal_append_errors_total",
            "WAL records dropped by a failed append on the writer worker")
        #: torn/corrupt-tail recovery accounting, accumulated across every
        #: replay (store open + restart) this process performed
        self.wal_recovery_records_replayed = r.counter(
            "wal_recovery_records_replayed_total",
            "Verified WAL records replayed across store opens/restarts")
        self.wal_recovery_records_dropped = r.counter(
            "wal_recovery_records_dropped_total",
            "Complete-but-corrupt WAL records discarded at replay "
            "(CRC mismatch or unparseable body)")
        self.wal_recovery_truncated_bytes = r.counter(
            "wal_recovery_truncated_bytes_total",
            "Bytes cut off the journal tail by truncate-on-open")
        #: leadership changes (a fresh acquire by a non-holder), by
        #: election name — the reference's leader_election_master_status
        #: flaps collapsed to a transition counter
        self.leader_transitions = r.counter(
            "leader_transitions_total",
            "Leader elections won by a new holder, by election name")
        #: lease-expiry -> standby's first effective action (first bind
        #: for the scheduler election) — the availability gap a leader
        #: kill actually costs, in (virtual) seconds
        self.leader_failover_seconds = r.histogram(
            "leader_failover_seconds",
            "Seconds between losing a leader and the standby's first "
            "bind, by election name",
            buckets=(1.0, 2.0, 5.0, 10.0, 15.0, 20.0, 30.0, 45.0, 60.0,
                     90.0, 120.0, 180.0))
        #: successful lease renews that landed past slow_renew_fraction of
        #: the renew deadline — near-fence conditions visible BEFORE a
        #: failover (one more slow round-trip and the holder self-fences)
        self.slow_renews = r.counter(
            "leaderelection_slow_renews_total",
            "Successful lease renews that approached the renew deadline, "
            "by election name")
        #: how far the follower trails the primary, in rv units (records):
        #: primary resource_version minus the replica store's high-water rv
        self.replication_lag = r.gauge(
            "replication_lag_records",
            "Records the replica store trails the primary by "
            "(primary rv - replica rv)")
        #: replication stream re-established after an error (wire reset,
        #: dropped watch, primary restart) — each costs one LIST+watch
        #: round against the primary
        self.replication_reconnects = r.counter(
            "replication_reconnects_total",
            "Replication reflector streams re-established after an "
            "error, by resource")
        #: read-path rotations by the replica ReadRouter: a follower
        #: gated out of read rotation for lagging (to_primary) or fanned
        #: back in after catching up (to_replica)
        self.replication_read_rotations = r.counter(
            "replication_read_rotations_total",
            "Informer read-path rotations between replica and primary, "
            "by direction")
        #: containers a virtual kubelet garbage-collected because the
        #: store no longer knows their pod (torn-WAL recovery: the pod's
        #: create was lost with the journal tail)
        self.kubelet_orphans_gced = r.counter(
            "kubelet_orphan_containers_gced_total",
            "Containers removed for pods the store no longer knows")
        #: exceptions a drop-and-continue handler deliberately dropped
        #: (utils.errlog.SwallowedErrors — the KTPU001 contract: logged
        #: once per streak, counted every time). Distinct from
        #: api_give_ups, which counts writes a RETRY policy abandoned.
        self.swallowed_errors = r.counter(
            "swallowed_errors_total",
            "Exceptions handled by drop-and-continue paths, by "
            "component and op")


#: pod-startup latency buckets (seconds) — wider than the scheduler's
#: per-batch buckets: startup rides controller sync + schedule + kubelet
SERVING_LATENCY_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 3.0, 5.0, 8.0,
                           13.0, 21.0, 34.0, 55.0)


class ServingMetrics:
    """Serving-mode (open-loop churn) metric families: per-class pod
    lifecycle latencies the SLO tracker observes, and the arrival rate
    the load generator sustains. Registered into the caller's registry so
    they ride the same /metrics exposition as the scheduler's families."""

    def __init__(self, registry: Optional["Registry"] = None):
        self.registry = registry if registry is not None else Registry()
        r = self.registry
        #: created -> Running, by workload class — the latency the SLO is
        #: judged on (the density e2e's p99 <= 5s gate, sustained)
        self.pod_startup_seconds = r.histogram(
            "serving_pod_startup_seconds",
            "Pod creation to Running latency under churn, by class",
            buckets=SERVING_LATENCY_BUCKETS)
        #: created -> bound (spec.nodeName set) — the scheduler's share
        self.pod_bind_seconds = r.histogram(
            "serving_pod_bind_seconds",
            "Pod creation to bound latency under churn, by class",
            buckets=SERVING_LATENCY_BUCKETS)
        #: lifecycle transitions observed, by class and phase
        #: {created, bound, running}
        self.pods_observed = r.counter(
            "serving_pods_observed_total",
            "Pod lifecycle transitions the SLO tracker stamped, "
            "by class and phase")
        #: the open-loop generator's configured arrival rate (pods/s
        #: equivalent; deployment scale deltas and gang members count as
        #: their pod counts)
        self.arrival_rate = r.gauge(
            "serving_arrival_rate_events_per_s",
            "Configured open-loop arrival rate (events/s)")


class APIServerMetrics:
    """The hub's own request/watch families (ref: apiserver
    endpoints/metrics — apiserver_request_total{verb,resource,code} and
    the registered-watcher gauges), self-served on its /metrics next to
    the component registries it aggregates."""

    def __init__(self, registry: Optional["Registry"] = None):
        self.registry = registry if registry is not None else Registry()
        r = self.registry
        #: every completed request, including the error mappings — code
        #: is the HTTP status the response actually carried
        self.requests = r.counter(
            "apiserver_request_total",
            "API requests by verb, resource, and HTTP code")
        #: non-watch request wall time (watches are long-running and
        #: would saturate every bucket with their stream lifetime)
        self.request_duration = r.histogram(
            "apiserver_request_duration_seconds",
            "Request latency for non-watch requests, by verb")
        #: currently-open watch streams (the long-running exemption's
        #: population — what the inflight limits deliberately don't cap)
        self.watch_streams = r.gauge(
            "apiserver_registered_watchers",
            "Currently-open watch streams, by resource")
        #: event frames written to watch streams (coalesced slim frames
        #: count every event they carry)
        self.watch_events = r.counter(
            "apiserver_watch_events_sent_total",
            "Watch events written to streams, by resource")
        #: wire volume split by encoding so the r04 bottleneck
        #: attribution (json encode vs transport) can be re-measured
        #: per negotiated encoding (ref: apiserver response-size
        #: families, split by content type)
        self.wire_bytes_sent = r.counter(
            "apiserver_wire_bytes_sent_total",
            "Response + watch-frame bytes written, by encoding")
        self.wire_bytes_received = r.counter(
            "apiserver_wire_bytes_received_total",
            "Request body bytes read, by encoding")
        #: serialization cost per encoding: payload/frame encode time on
        #: the hub (decode time lives client-side in httpclient's
        #: standalone families)
        self.wire_encode_seconds = r.histogram(
            "apiserver_wire_encode_seconds",
            "Payload encode latency, by encoding",
            buckets=WIRE_CODEC_BUCKETS)
        #: watch frames served from the per-(event, encoding) byte cache
        #: instead of re-serializing per registered watcher
        self.watch_frame_cache_hits = r.counter(
            "apiserver_watch_frame_cache_hits_total",
            "Watch frames reused from the shared per-event byte cache, "
            "by encoding")


class FlowControlMetrics:
    """API Priority & Fairness families (ref: apiserver_flowcontrol_*
    — dispatched/rejected counts and queue-wait by priority level),
    registered on the hub's /metrics beside the request families."""

    def __init__(self, registry: Optional["Registry"] = None):
        self.registry = registry if registry is not None else Registry()
        r = self.registry
        #: requests handed a seat (immediately or after queueing)
        self.dispatched = r.counter(
            "flowcontrol_dispatched_total",
            "Requests dispatched to a seat, by priority level")
        #: requests that had to queue before dispatch
        self.queued = r.counter(
            "flowcontrol_queued_total",
            "Requests that entered a fair queue, by priority level")
        #: requests shed with 429 (queue overflow or queue timeout)
        self.rejected = r.counter(
            "flowcontrol_rejected_total",
            "Requests rejected by flow control, by priority level "
            "and reason")
        #: time spent parked in a fair queue before dispatch
        self.queue_wait = r.histogram(
            "flowcontrol_queue_wait_seconds",
            "Fair-queue wait before dispatch, by priority level")


class Registry:
    """Metric family registry with /metrics text exposition."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def register(self, metric: _Metric) -> _Metric:
        with self._lock:
            if metric.name in self._metrics:
                raise ValueError(f"metric {metric.name} already registered")
            self._metrics[metric.name] = metric
        return metric

    def counter(self, name: str, help_text: str = "") -> Counter:
        return self.register(Counter(name, help_text))  # type: ignore

    def gauge(self, name: str, help_text: str = "", fn=None) -> Gauge:
        return self.register(Gauge(name, help_text, fn=fn))  # type: ignore

    def histogram(self, name: str, help_text: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self.register(Histogram(name, help_text, buckets))  # type: ignore

    def expose(self) -> str:
        with self._lock:
            metrics = list(self._metrics.values())
        lines: List[str] = []
        for m in metrics:
            lines.extend(m.expose())
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        """Ref: the scheduler serves DELETE /metrics -> metrics.Reset()
        (cmd/kube-scheduler/app/server.go:287-291). Values are zeroed but
        the families STAY registered — holders keep observing into the same
        objects and /metrics keeps serving them."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            m.clear()
