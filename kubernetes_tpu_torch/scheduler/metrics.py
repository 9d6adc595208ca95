"""Scheduler metrics — the reference's metric families over the batch path.

Ref: pkg/scheduler/metrics/metrics.go:30-180. Same families and labels
where the concept survives batching; the batch-specific additions are
labeled phases of the device pipeline (tensorize/kernel/fetch) that the
reference's per-pod timers have no analog for.
"""

from __future__ import annotations

from ..utils.metrics import Registry

SCHEDULING_LATENCY_BUCKETS = (0.0005, 0.001, 0.002, 0.004, 0.008, 0.016,
                              0.032, 0.064, 0.128, 0.256, 0.512, 1.024,
                              2.048, 4.096, 8.192)


class SchedulerMetrics:
    def __init__(self, registry: Registry = None):
        self.registry = registry if registry is not None else Registry()
        r = self.registry
        # ref: SchedulingLatency histogram labeled by operation
        # {predicate_evaluation, priority_evaluation, binding, ...}; the
        # batch analog is per-phase wall time per cycle
        self.scheduling_duration = r.histogram(
            "scheduler_scheduling_duration_seconds",
            "Scheduling phase latency per batch cycle, by operation",
            buckets=SCHEDULING_LATENCY_BUCKETS)
        # ref: E2eSchedulingLatency — queue pop to bind committed
        self.e2e_scheduling_duration = r.histogram(
            "scheduler_e2e_scheduling_duration_seconds",
            "End-to-end batch latency from pop to binds committed",
            buckets=SCHEDULING_LATENCY_BUCKETS)
        self.binding_duration = r.histogram(
            "scheduler_binding_duration_seconds",
            "Bind transaction latency per batch",
            buckets=SCHEDULING_LATENCY_BUCKETS)
        # pipelined drain: wall time the commit stage spent on the commit
        # thread — time the drain thread did NOT serialize on (it was
        # tensorizing/dispatching the next batch); the occupancy lens the
        # device_profile's pipelined section reports per-batch
        self.commit_overlap_duration = r.histogram(
            "scheduler_commit_overlap_duration_seconds",
            "Commit-stage wall time overlapped with the next batch's "
            "launch and device compute (pipelined drain)",
            buckets=SCHEDULING_LATENCY_BUCKETS)
        # ref: scheduleAttempts counter labeled result
        # {scheduled, unschedulable, error}
        self.schedule_attempts = r.counter(
            "scheduler_schedule_attempts_total",
            "Scheduling attempts by result")
        # ref: PreemptionAttempts / PreemptionVictims; family names use
        # the reference's POST-rename spelling (the originals predate
        # its metrics-naming linter — exactly the KTPU004 contract)
        self.preemption_attempts = r.counter(
            "scheduler_preemption_attempts_total",
            "Preemption attempts")
        self.preemption_victims = r.counter(
            "scheduler_preemption_victims_total",
            "Pods evicted by preemption")
        # gang members no longer skip preemption silently: each failed
        # attempt by a gang member routes to WHOLE-GANG preemption
        # (price minMember placements against one ICI domain) and is
        # counted here — the old skip path's disappearance is observable
        self.preemption_gang_routed = r.counter(
            "scheduler_preemption_gang_routed_total",
            "Unschedulable gang members routed to whole-gang preemption "
            "(previously skipped outright)")
        self.pod_scheduling_errors = r.counter(
            "scheduler_pod_scheduling_errors_total",
            "Pods that failed a scheduling cycle with an error")
        # ref: PendingPods gauges {active, backoff, unschedulable}
        self.pending_pods = r.gauge(
            "scheduler_pending_pods",
            "Pending pods by queue")
        self.batch_size = r.histogram(
            "scheduler_batch_size",
            "Pods decided per batch cycle",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048,
                     4096))
        # in-scan (anti-)affinity fallbacks, by reason {term_cap, kmax,
        # soft_terms, soft_kmax, soft_gang}: batches the kernel tables
        # could not cover take the repair-overlay / sub-chunked path
        # instead — a capped code path must be visible, never silent
        self.topo_inscan_fallbacks = r.counter(
            "scheduler_topo_inscan_fallbacks_total",
            "Batches that fell back from the in-scan topology/soft-credit "
            "tables, by reason")
        # serving-mode adaptive drain: the batch cap the sizing policy
        # chose per cycle (grows with queue depth, shrinks under commit/
        # bind backpressure or a priority-lane express batch)
        self.adaptive_batch_cap = r.histogram(
            "scheduler_adaptive_batch_cap",
            "Adaptive drain batch cap chosen per cycle (serving mode)",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048,
                     4096, 8192, 16384))
        # express batches popped for the high-priority lane, and cycles
        # shrunk because the hub-side commit/bind stages were backed up
        self.lane_batches = r.counter(
            "scheduler_priority_lane_batches_total",
            "Drain cycles sized to the high-priority lane cohort's "
            "bucket (floored at min_batch, so a tiny lane pops with "
            "bulk pods behind it)")
        self.backpressure_shrinks = r.counter(
            "scheduler_backpressure_shrinks_total",
            "Drain cycles whose batch cap was shrunk by bind/commit "
            "backpressure")
        # unschedulable attribution: one inc per (failed attempt, distinct
        # reason) from the explain() diagnosis, plus the queue's park
        # causes (gang below minMember) — the "why is my pod pending"
        # family /debug/pending reads per-pod detail for
        self.unschedulable_reasons = r.counter(
            "scheduler_unschedulable_reasons_total",
            "Unschedulable scheduling attempts by failure reason "
            "(predicate message or queue park cause)")
        # no silent caps (the contract KTPU005 enforces): every
        # bounded search that truncated its candidate set is visible
        self.capped_scans = r.counter(
            "scheduler_capped_scans_total",
            "Scans truncated at a documented cap, by cap name")
        # ---- sharded drain (mesh execution substrate) ----
        # batches routed through the shard_map kernel (per-shard
        # filter+score, cross-shard argmax) vs the GSPMD/single paths
        self.sharded_batches = r.counter(
            "scheduler_sharded_batches_total",
            "Batches scheduled by the shard-mapped class scan")
        # wall time the fetch spent draining the cross-shard argmax
        # pipeline for a sharded batch (mesh synchronization cost)
        self.shard_sync_seconds = r.histogram(
            "scheduler_shard_sync_seconds",
            "Mesh-synchronization wait fetching a sharded batch's packed "
            "results",
            buckets=SCHEDULING_LATENCY_BUCKETS)
        # mirror rows added purely for shard divisibility (TensorMirror
        # pads the node capacity to a multiple of the mesh's shard count;
        # pad rows are valid=False and excluded from every decision) —
        # padding is visible, never a silent cap
        self.mirror_shard_pad_rows = r.gauge(
            "scheduler_mirror_shard_pad_rows",
            "Node-mirror rows added to make the capacity shard-divisible")
        # ---- speculative cohort assignment (kernels/speculative.py) ----
        # the speculation rate is a first-class observable: cohorts
        # attempted, cohorts that collided (and were serially repaired),
        # pods re-decided by the repair, and oracle-detected divergences
        # from the serial scan (contract: always zero — a nonzero count
        # is a kernel bug, attributed in BatchScheduler.spec_divergence_log)
        self.speculative_cohorts = r.counter(
            "scheduler_speculative_cohorts_total",
            "Speculative cohort assignment attempts")
        self.speculative_collisions = r.counter(
            "scheduler_speculative_collisions_total",
            "Speculative cohorts rejected by collision detection and "
            "replayed serially")
        self.speculative_repaired = r.counter(
            "scheduler_speculative_repaired_pods_total",
            "Pods from the first collision onward whose decisions came "
            "from the serial repair replay")
        self.speculative_divergences = r.counter(
            "scheduler_speculative_divergences_total",
            "Pods whose speculative decision differed from the serial "
            "oracle replay (expected zero; bit-identity contract)")

    def observe_queue(self, queue) -> None:
        """Sample the three sub-queue depths (PendingPods gauges)."""
        with queue._lock:
            active = len(queue._in_active)
            backoff = len(queue._in_backoff)
            unschedulable = len(queue._unschedulable)
        self.pending_pods.set(active, queue="active")
        self.pending_pods.set(backoff, queue="backoff")
        self.pending_pods.set(unschedulable, queue="unschedulable")
