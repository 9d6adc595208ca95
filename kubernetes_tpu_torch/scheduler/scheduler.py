"""Scheduler shell: watch -> batch-pop -> schedule -> assume -> bind.

Port of kubernetes_tpu/scheduler/scheduler.py to the GPU. The shell is the
reference's, line for line, with these differences:

  - `device=None` means CUDA: the BatchScheduler (kernels K1-K3) and the
    DRF account (K4, K5) run there; tests pass device="cpu".
  - one card, no mesh: `mesh=` or KTPU_MESH raise NotImplementedError.
  - the commit thread overlaps the drain when the algorithm's device is
    CUDA (the reference asks jax for its backend); KTPU_COMMIT_THREAD
    still overrides.
  - scheduler extenders are not ported: a non-empty `extenders=` raises.
  - preemption (preempt / preempt_gang) is not ported: where the
    reference prints an exception from it and carries on, the port lets
    NotImplementedError through, so an unported route stops the drain
    loudly. The run loop keeps the error; stop() and wait_for_idle()
    raise it. `disable_preemption=True` keeps its meaning. The
    reference's nominate/evict half of preemption and its extender bind
    path are left out until their kernels and modules are ported.

The reference's description follows.

Ref: pkg/scheduler/scheduler.go (Scheduler, Run :250, scheduleOne :438,
assume :382, bind :411) and eventhandlers.go:319-469 AddAllEventHandlers.

Differences from the reference, by design:
  - scheduleOne becomes schedule_batch: the queue drains up to `batch_size`
    pods per cycle and the TPU kernel decides the whole batch.
  - binds are issued against the store as ONE bulk transaction per batch
    (`_assume_and_bind_all` -> PodClient.bind_bulk_pairs); in the
    pipelined drain the whole commit stage (volumes + plugins + bind +
    assume) runs on a dedicated commit thread, overlapped with the next
    batch's tensorization and device scan — the batch-scale analog of
    the reference's async bind goroutine, which exists to overlap a
    ~100ms apiserver round trip.
  - assume/finish_binding/forget semantics are identical: assumed pods count
    against nodes immediately, are confirmed by the informer's add event, and
    expire on TTL if a bind is lost (internal/cache/interface.go:40-120).
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional

from ..api import helpers, serde, wellknown
from ..api.core import Binding, ObjectReference, Pod
from ..api.meta import ObjectMeta
from ..state.client import Client
from ..state.informer import EventHandlers, SharedInformerFactory
from ..utils.clock import Clock, REAL_CLOCK
from .cache import Cache
from .core import BatchScheduler, ScheduleResult
from .queue import SchedulingQueue

DEFAULT_BATCH_SIZE = 1024
#: pods at/above this priority ride the serving drain's express lane
#: (ref: the reference's PriorityClass values; user classes sit well
#: below the 2e9 system band — 1000 marks "interactive" by convention)
DEFAULT_LANE_PRIORITY = 1000
#: adaptive sizing never shrinks the drain below this (tiny batches
#: thrash the launch/commit fixed costs without helping latency)
MIN_ADAPTIVE_BATCH = 64
#: bulk-bind POSTs allowed in flight before the drain blocks on the
#: oldest — the bounded hub<->scheduler bind pipeline (serving mode)
MAX_INFLIGHT_BINDS = 2
#: express-occupancy EWMA blend: old weight per sized cycle (0.8 keeps
#: the signal hot ~3 cycles after an express burst drains)
EXPRESS_EWMA_DECAY = 0.8
#: EWMA of the express share of queue depth above which bulk caps take
#: an extra shrink unit — express bands have been queueing recently,
#: so the next arrival should not wait out a mega-batch commit
EXPRESS_EWMA_HOT = 0.05


def resolve_mesh(mesh=None):
    """The reference's drain runs on a device mesh when given one (the
    argument, or KTPU_MESH naming one). The port runs on one card:
    anything but no mesh raises."""
    import os
    env = os.environ.get("KTPU_MESH", "")
    if mesh is None and env in ("", "0", "none"):
        return None
    source = "the mesh argument" if mesh is not None else f"KTPU_MESH={env}"
    raise NotImplementedError(
        f"Scheduler: a device mesh ({source}) needs the sharded class "
        "scan, which is not ported yet (ROADMAP: Queue A item 7, sharded "
        "scan)")


class Scheduler:
    def __init__(self, client: Client,
                 informer_factory: Optional[SharedInformerFactory] = None,
                 batch_size: int = DEFAULT_BATCH_SIZE,
                 scheduler_name: str = "default-scheduler",
                 clock: Clock = REAL_CLOCK,
                 disable_preemption: bool = False,
                 framework=None, extenders=None, metrics=None,
                 mesh=None, async_bind: Optional[bool] = None,
                 adaptive_batch: Optional[bool] = None,
                 min_batch: int = MIN_ADAPTIVE_BATCH,
                 lane_priority: int = DEFAULT_LANE_PRIORITY,
                 max_inflight_binds: int = MAX_INFLIGHT_BINDS,
                 tracer=None,
                 speculative: Optional[bool] = None,
                 device=None):
        from .framework import Framework
        from .metrics import SchedulerMetrics
        self.metrics = metrics if metrics is not None else SchedulerMetrics()
        # span tracer (observability/tracer.py): pod-lifecycle milestones
        # sampled 1-in-N by UID, batch/stage spans always on; rides the
        # scheduler's clock so FakeClock harnesses get deterministic span
        # logs. Callers share one tracer across components by passing it.
        from ..observability import SpanTracer
        self.tracer = tracer if tracer is not None else SpanTracer(clock=clock)
        self.client = client
        self.scheduler_name = scheduler_name
        self.batch_size = batch_size
        self.clock = clock
        # one card: a mesh (argument or KTPU_MESH) raises
        self.mesh = resolve_mesh(mesh)
        self.disable_preemption = disable_preemption
        #: Reserve/Prebind plugin runner (ref: framework/v1alpha1)
        self.framework = framework or Framework()
        if extenders:
            raise NotImplementedError(
                "Scheduler: scheduler extenders (scheduler/extender.py) are "
                "not ported yet (ROADMAP: Queue A item 8, harnesses and "
                "commands)")
        self.extenders = []
        # ---- pipelined-drain state (drain_pipelined) ----
        #: chain-validity protocol: mutation_seq anchor + count of the
        #: pipeline's OWN tracked assumes since the anchor. The commit
        #: thread bumps the count under the cache lock together with each
        #: assume; _chain_intact compares under the same lock.
        self._pipe_base = 0
        self._pipe_assumes = 0
        #: sticky since the last anchor: some chained batch's usage counts
        #: a winner that was later lost (repair demotion, commit drop,
        #: permit reject/rollback) — in-flight chained batches must retry
        #: their unassigned pods instead of parking them
        self._pipe_phantom = False
        #: winners of the last two finished batches — the set whose commits
        #: may postdate an in-flight chained batch's snapshot (its repair
        #: validates against them exactly like same-batch winners)
        from collections import deque as _deque
        self._pipe_outcomes = _deque(maxlen=2)
        #: single-worker commit stage (created on first pipelined drain):
        #: FIFO, so batch N's commit completes before batch N+1's starts
        self._commit_pool_ = None
        #: None until first drain: run the commit stage on the commit
        #: thread only when it can overlap something outside this
        #: thread's GIL — a cross-process bind POST (wire path), a real
        #: accelerator's dispatch/fetch waits, or XLA CPU compute on a
        #: many-core host. On a GIL-starved small host (<=2 cores, CPU
        #: backend, in-process store) the thread only timeshares against
        #: tensorize, so the stage runs inline — same code, same
        #: bookkeeping. KTPU_COMMIT_THREAD=0/1 overrides.
        self._commit_async: Optional[bool] = None
        #: serializes the tensorize/launch/finish machinery (drain thread)
        #: against the rare commit-thread re-entries into the algorithm
        #: (explain / preempt refresh the snapshot+mirror)
        self._algo_lock = threading.RLock()
        import os as _os
        #: split pops at power-of-two boundaries when the scan pad would
        #: exceed 25% (see drain_pipelined); KTPU_ALIGN_SPLIT=0 disables
        self._align_split = _os.environ.get("KTPU_ALIGN_SPLIT", "1") != "0"
        # ---- serving-mode drain policy (adaptive batching + lanes) ----
        #: adaptive sizing: batch cap follows queue depth (small when
        #: shallow so interactive pods never wait out a mega-drain, full
        #: batch_size when deep), priority-lane cohorts pop as their own
        #: express batch, and hub backpressure halves the cap. OFF by
        #: default: one-shot drains keep the fixed batch_size (decision
        #: parity with the oracle benches). KTPU_ADAPTIVE_BATCH overrides.
        if adaptive_batch is None:
            adaptive_batch = _os.environ.get(
                "KTPU_ADAPTIVE_BATCH", "0") != "0"
        self.adaptive_batch = bool(adaptive_batch)
        self.min_batch = max(1, min(min_batch, batch_size))
        self.lane_priority = lane_priority
        self.max_inflight_binds = max(1, max_inflight_binds)
        #: (queue_depth, lane_depth, pressure, cap) per sized cycle —
        #: the serving smoke asserts caps are monotone in depth off this
        from collections import deque as _dq
        self.batch_cap_log = _dq(maxlen=4096)
        #: preemption_attempts counter value at the last sized cycle —
        #: a delta between cycles marks live capacity contention, which
        #: adds one unit of bulk-cap pressure (see _drain_cap)
        self._preempt_seen = 0.0
        #: EWMA of the express-band share of queue depth (BandCatalog
        #: occupancy: lane_priority is the lowest express band's floor,
        #: so drain_stats' lane count IS the express-band occupancy)
        self._express_ewma = 0.0
        #: bulk-bind POSTs currently in flight (binder threads); beyond
        #: max_inflight_binds the drain BLOCKS on the oldest instead of
        #: queueing unboundedly — and the count is the backpressure
        #: signal the adaptive cap reads
        self._binds_inflight = 0
        #: True while the pipelined commit stage was still running when
        #: its successor batch finished the device scan — the commit
        #: thread's shrink signal to the drain
        self._commit_lagging = False
        self.cache = Cache(clock=clock)
        self.queue = SchedulingQueue(clock=clock)
        self.informers = informer_factory or SharedInformerFactory(client)
        pvc_lister, pv_by_name, pv_all, sc_lister = self._volume_listers()
        from .volumebinder import VolumeBinder
        self.volume_binder = VolumeBinder(
            pvc_lister=pvc_lister, pv_lister=pv_all,
            sc_lister=sc_lister, client=client)
        self.algorithm = BatchScheduler(
            self.cache, listers=self._spread_listers(),
            volume_binder=self.volume_binder,
            pvc_lister=pvc_lister, pv_lister=pv_by_name,
            nominated=self.queue.nominated, device=device)
        #: in-scan fallback counters (scheduler_topo_inscan_fallbacks_total)
        self.algorithm.sched_metrics = self.metrics
        # speculative cohort assignment (kernels/speculative.py): the
        # constructor argument overrides KTPU_SPECULATIVE (which the
        # BatchScheduler read at construction) — explicit beats ambient
        if speculative is not None:
            self.algorithm.speculative = bool(speculative)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: the NotImplementedError that stopped the run loop, if any
        self._loop_error: Optional[BaseException] = None
        self._in_flight = 0  # pods popped but not yet decided this cycle
        #: async binding (the reference's bind goroutine, scheduler.go:521):
        #: assume synchronously, POST the bulk bind from a single binder
        #: thread so the hub chews batch N's binds while this process
        #: computes batch N+1. Enabled only across a REAL process boundary
        #: (HTTP client) — in-process binds are microseconds and the thread
        #: hop would cost more than it hides. Failures discovered on the
        #: binder thread forget the assumed pod + invalidate device usage
        #: (same self-heal as the reference's Forget on bind error,
        #: scheduler.go:556; assumed-TTL covers anything missed).
        # `async_bind` overrides the transport heuristic: a caller that
        # steps the scheduler synchronously (the chaos harness, whose
        # determinism contract cannot tolerate binder-thread timing)
        # passes False even over HTTP
        self._async_bind = async_bind if async_bind is not None else (
            getattr(client, "base_url", None) is not None)
        self._bind_pool = None
        self._bind_futures: list = []
        self._count_lock = threading.Lock()
        if self._async_bind:
            from concurrent.futures import ThreadPoolExecutor
            # two workers: consecutive batches' POSTs overlap in the hub
            # (binds of different batches touch disjoint pods, so
            # transaction order between them is immaterial)
            self._bind_pool = ThreadPoolExecutor(
                max_workers=2, thread_name_prefix="binder")
        # gang scheduling: one GangManager drives the queue's admission
        # gate, the all-or-nothing kernel routing, and the permit gate
        # (scheduler/gang.py); PodGroup specs come straight off the informer
        from ..api.scheduling import PodGroup
        from ..utils.metrics import GangMetrics
        from .gang import GangManager
        pg_informer = self.informers.informer_for(PodGroup)
        try:
            self.gang_metrics = GangMetrics(self.metrics.registry)
        except ValueError:
            # a sibling scheduler shares this registry: keep our own
            self.gang_metrics = GangMetrics()
        from ..utils.metrics import RobustnessMetrics
        try:
            self.robustness = RobustnessMetrics(self.metrics.registry)
        except ValueError:
            self.robustness = RobustnessMetrics()

        def _node_label(node_name, label_key):
            ni = self.algorithm.snapshot.node_infos.get(node_name)
            if ni is None or ni.node is None:
                return None
            return ni.node.metadata.labels.get(label_key)
        # multi-tenancy (tenancy/): per-tenant DRF usage carry (drain
        # ordering + preemption pricing) and the per-namespace
        # active-gang quota gate the gang manager consults at pop time
        from ..api.core import ResourceQuota
        from ..tenancy import (DRFAccount, GangQuotaGate, TenancyMetrics,
                               drf_enabled)
        try:
            self.tenancy_metrics = TenancyMetrics(self.metrics.registry)
        except ValueError:
            self.tenancy_metrics = TenancyMetrics()
        rq_informer = self.informers.informer_for(ResourceQuota)
        self.gang_quota = GangQuotaGate(
            lambda: rq_informer.indexer.list(),
            metrics=self.tenancy_metrics)
        self.drf = DRFAccount(device=self.algorithm.device)
        self._drf_on = drf_enabled()
        self.algorithm.drf = self.drf
        self.gang = GangManager(
            lambda ns, name: pg_informer.indexer.get_by_key(f"{ns}/{name}"),
            clock=clock, metrics=self.gang_metrics,
            node_label=_node_label, quota_gate=self.gang_quota)
        self.queue.gang = self.gang
        self.algorithm.gang = self.gang
        pg_informer.add_event_handlers(EventHandlers(
            on_add=lambda pg: self.queue.gang_group_changed(
                pg.metadata.key()),
            on_update=lambda old, new: self.queue.gang_group_changed(
                new.metadata.key())))
        # a raised (or deleted) quota may unpark quota-held gangs: mark
        # the gate's freed flag so the queue's next flush re-evaluates.
        # Spec changes only — the reconciler's status.used writes would
        # otherwise re-trigger the sweep every tick.
        rq_informer.add_event_handlers(EventHandlers(
            on_update=lambda old, new: (
                self.gang.quota_changed()
                if dict(old.spec.hard) != dict(new.spec.hard) else None),
            on_delete=lambda rq: self.gang.quota_changed()))
        # PriorityClass bands: stored PriorityClasses define the named
        # band catalog; the express-lane threshold DERIVES from it
        # (lowest express band) instead of staying a hard-coded integer.
        # No PriorityClass objects -> the legacy two-lane default, so the
        # constructor argument keeps its exact old meaning.
        from ..api.policy import PriorityClass
        from ..tenancy import BandCatalog
        pc_informer = self.informers.informer_for(PriorityClass)
        self._lane_default = lane_priority
        self.bands = BandCatalog.default(lane_priority)

        def _rebuild_bands(*_args):
            pcs = pc_informer.indexer.list()
            self.bands = BandCatalog.from_priority_classes(pcs) \
                if pcs else BandCatalog.default(self._lane_default)
            self.lane_priority = self.bands.lane_threshold(
                self._lane_default)
        self._rebuild_bands = _rebuild_bands
        pc_informer.add_event_handlers(EventHandlers(
            on_add=_rebuild_bands, on_update=_rebuild_bands,
            on_delete=_rebuild_bands))
        from ..state.record import EventRecorder
        from .debugger import CacheDebugger, UnschedulableAttribution
        #: correlating recorder (ref: client-go tools/record): dedup by
        #: count-bumping, aggregation, spam filtering
        self.recorder = EventRecorder(client, component=scheduler_name,
                                      clock=clock, tracer=self.tracer)
        #: SIGUSR2 dump + cache-vs-informer comparer (install() to arm)
        self.debugger = CacheDebugger(self)
        #: per-pod last-failure records behind /debug/pending; the queue
        #: contributes park causes, the drain the explain() diagnosis
        self.attribution = UnschedulableAttribution(clock=clock)
        self.queue.tracer = self.tracer
        self.queue.attribution = self.attribution
        self.queue.unsched_reasons = self.metrics.unschedulable_reasons
        self.algorithm.tracer = self.tracer
        self.scheduled_count = 0
        self.unschedulable_count = 0
        self._add_all_event_handlers()

    # ------------------------------------------------- event handlers

    def _responsible(self, pod: Pod) -> bool:
        return pod.spec.scheduler_name == self.scheduler_name

    def _spread_listers(self):
        """SelectorSpread's selector sources, backed by informer indexers
        (ref: factory.go wires Service/RC/RS/SS listers into the priority
        metadata producer)."""
        from ..api.apps import ReplicaSet, StatefulSet
        from ..api.core import ReplicationController, Service
        from .priorities import SpreadListers
        svc_inf = self.informers.informer_for(Service)
        rc_inf = self.informers.informer_for(ReplicationController)
        rs_inf = self.informers.informer_for(ReplicaSet)
        ss_inf = self.informers.informer_for(StatefulSet)
        return SpreadListers(
            services=lambda ns: svc_inf.indexer.list(ns),
            rcs=lambda ns: rc_inf.indexer.list(ns),
            rss=lambda ns: rs_inf.indexer.list(ns),
            statefulsets=lambda ns: ss_inf.indexer.list(ns))

    def _volume_listers(self):
        from ..api.core import PersistentVolume, PersistentVolumeClaim
        from ..api.policy import StorageClass
        # capture the informers ONCE: these listers run inside per-pod
        # per-node predicate loops, so routing every lookup through the
        # factory (its lock + lazy-start check) would be pure overhead;
        # creating them here also means factory.start() syncs them
        pvc_inf = self.informers.informer_for(PersistentVolumeClaim)
        pv_inf = self.informers.informer_for(PersistentVolume)
        sc_inf = self.informers.informer_for(StorageClass)
        pvc_lister = lambda ns, name: pvc_inf.indexer.get_by_key(f"{ns}/{name}")
        pv_by_name = lambda name: pv_inf.indexer.get_by_key(name)
        pv_all = lambda: pv_inf.indexer.list()
        sc_lister = lambda name: sc_inf.indexer.get_by_key(name)
        return pvc_lister, pv_by_name, pv_all, sc_lister

    def _add_all_event_handlers(self) -> None:
        """Ref: eventhandlers.go:319-469 — unassigned pods feed the queue,
        assigned pods and nodes feed the cache; cache-affecting events move
        unschedulable pods back to active."""
        from ..api.core import Node
        pod_inf = self.informers.informer_for(Pod)
        pod_inf.add_event_handlers(EventHandlers(
            on_add=self._on_pod_add,
            on_update=self._on_pod_update,
            on_delete=self._on_pod_delete))
        node_inf = self.informers.informer_for(Node)
        node_inf.add_event_handlers(EventHandlers(
            on_add=lambda n: (self.cache.add_node(n),
                              self.queue.move_all_to_active_queue()),
            on_update=self._on_node_update,
            on_delete=self._on_node_delete))
        # services/controllers affect SelectorSpread; their events may make
        # parked pods schedulable-where-preferred (ref: eventhandlers.go
        # onServiceAdd -> MoveAllToActiveQueue) — and they invalidate the
        # scorer's per-template selector memo, which node epochs alone
        # would never refresh on a node-quiet cluster
        from ..api.apps import ReplicaSet, StatefulSet
        from ..api.core import ReplicationController, Service

        def move(*args):
            self.algorithm.scorer.invalidate_spread_selectors()
            self.queue.move_all_to_active_queue()
        for cls in (Service, ReplicationController, ReplicaSet, StatefulSet):
            self.informers.informer_for(cls).add_event_handlers(
                EventHandlers(on_add=move, on_update=move, on_delete=move))

    _DEAD_NODE_TAINTS = (wellknown.TAINT_NODE_NOT_READY,
                         wellknown.TAINT_NODE_UNREACHABLE)

    def _on_node_update(self, old, new) -> None:
        self.cache.update_node(old, new)
        if any(t.key in self._DEAD_NODE_TAINTS and t.effect == "NoExecute"
               for t in new.spec.taints):
            # the node-lifecycle controller declared the node dead:
            # reservations there are pinned to a broken slice NOW, not in
            # scheduleTimeoutSeconds
            self._gang_node_gone(new.metadata.name)
        self.queue.move_all_to_active_queue()

    def _on_node_delete(self, node) -> None:
        self.cache.remove_node(node)
        self._gang_node_gone(node.metadata.name)

    def _gang_node_gone(self, node_name: str) -> None:
        """Immediate gang-aware node-failure propagation: every permit
        reservation on the dead node — and its whole gang's — rolls off
        the cache, and the members requeue for a fresh placement (same
        mechanics as the permit-timeout sweep, without the wait)."""
        if self.gang is None:
            return
        rollbacks, requeue = self.gang.node_gone(node_name)
        if not rollbacks:
            return
        from ..utils.trace import Trace
        trace = Trace("gang_node_gone", node=node_name,
                      reservations=len(rollbacks))
        self.cache.forget_pods([clone for _, clone in rollbacks])
        # chained usage may count the rolled-back reservations: in-flight
        # chained batches must retry their losers (the untracked forgets
        # already force the next launch to flush and re-upload host truth)
        self._pipe_phantom = True
        trace.step("reservations rolled back from the cache")
        for pod in requeue:
            self.volume_binder.forget_pod_volumes(pod)
            self._record_event(
                pod, "FailedScheduling",
                f"gang reservation lost: node {node_name} died; "
                f"rescheduling the whole gang")
            self.queue.add(pod)
        trace.step("members requeued")
        trace.log_if_long(100.0)

    def _on_pod_add(self, pod: Pod) -> None:
        if pod.spec.node_name:
            if not helpers.pod_is_terminal(pod):
                self.cache.add_pod(pod)
                self.queue.assigned_pod_updated(pod)
        elif self._responsible(pod):
            if pod.metadata.deletion_timestamp is not None:
                return  # deleting pods never enter the queue (scheduleOne skip)
            # feature extraction on THIS (informer) thread: tensorization
            # then reads a cached signature instead of burning drain time
            from .tensorize import precompute_pod_features
            try:
                precompute_pod_features(pod)
            except Exception:
                pass  # tensorize recomputes inline if the cache is absent
            self.queue.add(pod)

    def _on_pod_update(self, old: Pod, new: Pod) -> None:
        if new.spec.node_name:
            if helpers.pod_is_terminal(new):
                self.cache.remove_pod(new)
                self.drf.release(new)
                if self.gang is not None:
                    # a terminal worker no longer completes its gang
                    self.gang.pod_dropped(new)
            elif old.spec.node_name:
                self.cache.update_pod(old, new)
            else:
                # bind confirmation path: pod transitioned to assigned
                self.cache.add_pod(new)
                self.queue.delete(new)
                self.queue.assigned_pod_updated(new)
        else:
            if old.spec.node_name:
                # the store UN-bound this pod: its rv clock regressed
                # (torn-WAL recovery) and a bind no longer exists. The
                # cache charges bound pods regardless of schedulerName
                # (_on_pod_add), so the cleanup must run BEFORE the
                # responsibility gate or a foreign scheduler's regressed
                # pod holds phantom capacity forever; only the requeue
                # below is ours-only.
                self._bind_regressed(old, new)
            if not self._responsible(new):
                return
            if new.metadata.deletion_timestamp is not None:
                self.queue.delete(new)
                return
            self.queue.update(old, new)

    def _bind_regressed(self, old: Pod, new: Pod) -> None:
        """A bound (or assumed) pod is Pending again in the store — the
        recovery path after a regressed restart. The cache's copy holds
        phantom capacity on a node the store no longer charges; chained
        device usage counts a winner that never survived; a gang sibling
        set may be torn mid-transaction. Roll all of it back (gangs
        whole-group, as gangs always roll back) and let the pod reschedule."""
        self.cache.remove_pod(old)  # drops the assumed flag too
        self.drf.release(old)
        self.algorithm.mirror.invalidate_usage()
        self._pipe_phantom = True
        self.volume_binder.forget_pod_volumes(old)
        self._record_event(
            new, "BindRegressed",
            "bind lost with the store's journal tail; rescheduling")
        if self.gang is None or not self.gang.is_member(old):
            return
        rollbacks, requeue = self.gang.bind_regressed(old)
        if not rollbacks:
            return
        self.cache.forget_pods([clone for _, clone in rollbacks])
        for pod in requeue:
            self.volume_binder.forget_pod_volumes(pod)
            self._record_event(
                pod, "FailedScheduling",
                "gang reservation rolled back: a sibling's bind "
                "regressed with the store; rescheduling the whole gang")
            self.queue.add(pod)

    def _on_pod_delete(self, pod: Pod) -> None:
        if pod.spec.node_name:
            self.cache.remove_pod(pod)
            self.drf.release(pod)
            if self.gang is not None:
                # prune the bound member: stale bound keys would let a
                # re-created gang release partially against old counts
                self.gang.pod_dropped(pod)
            self.queue.move_all_to_active_queue()
        else:
            self.queue.delete(pod)

    # ------------------------------------------------------ scheduling

    def _backpressure(self) -> int:
        """Units of downstream backlog the drain should respond to: each
        unit halves the adaptive batch cap. Sources: bulk-bind POSTs in
        flight beyond the first (the hub is chewing older transactions),
        and a pipelined commit stage that was still running when its
        successor's device scan finished."""
        with self._count_lock:
            p = max(0, self._binds_inflight - 1)
        if self._commit_lagging:
            p += 1
        return p

    def _drain_cap(self) -> int:
        """The serving drain's per-cycle batch cap (fixed batch_size when
        adaptive sizing is off — the one-shot-drain default):

          - grows with queue depth, rounded UP to the next power of two
            (reusing compiled kernel buckets), clamped to
            [min_batch, batch_size] — a shallow queue gets a small batch
            whose commit an interactive pod never waits long on, a deep
            one gets the full throughput batch;
          - when ANY pods at/above lane_priority are queued, the cap is
            the LANE cohort's bucket: the heap's top is exactly those
            pods, so the next pop is an express batch and high-priority
            arrivals jump ahead of the bulk drain instead of riding a
            16k batch's tail (an all-priority queue is one big express
            cohort — sized by its depth, never split by pressure);
          - each unit of bind/commit backpressure halves a bulk cap
            (never an express cap — urgency wins over pacing);
          - a preemption_attempts delta since the last sized cycle adds
            one pressure unit (live capacity contention: victims'
            evictions and express retries should not queue behind a
            mega-batch commit);
          - an EWMA of the express-band occupancy share (lane depth /
            queue depth, where lane_priority is the BandCatalog's lowest
            express floor) above EXPRESS_EWMA_HOT adds one shrink unit
            to BULK caps for a few cycles after an express burst — the
            next express arrival pops behind a small bulk commit."""
        if not self.adaptive_batch:
            return self.batch_size
        depth, lane = self.queue.drain_stats(self.lane_priority)
        if depth == 0:
            # idle wakeup (or a blocking pop about to wait): nothing to
            # size — return the floor WITHOUT recording, so idle polls
            # don't pollute the cap histogram/log. A burst landing during
            # the blocking wait drains its head as this small batch
            # (lowest latency for the first arrivals, by design) and the
            # next cycle sizes against the now-visible depth.
            return self.min_batch
        pressure = self._backpressure()
        pa = self.metrics.preemption_attempts.value()
        if pa > self._preempt_seen:
            pressure += 1
        self._preempt_seen = pa
        self._express_ewma = (EXPRESS_EWMA_DECAY * self._express_ewma
                              + (1.0 - EXPRESS_EWMA_DECAY)
                              * (lane / depth))
        is_lane = lane > 0
        if not is_lane and self._express_ewma > EXPRESS_EWMA_HOT:
            pressure += 1
        cap = lane if is_lane else depth
        cap = 1 << max(0, cap - 1).bit_length()
        cap = max(self.min_batch, min(self.batch_size, cap))
        if is_lane:
            self.metrics.lane_batches.inc()
        elif pressure:
            shrunk = max(self.min_batch, cap >> pressure)
            if shrunk < cap:
                self.metrics.backpressure_shrinks.inc()
            cap = shrunk
        self.metrics.adaptive_batch_cap.observe(cap)
        self.batch_cap_log.append((depth, lane, pressure, cap))
        return cap

    def _drf_order(self, pods: List[Pod]) -> List[Pod]:
        """DRF fair-share reorder of a popped batch BEFORE soft-score
        sub-chunking: priority still dominates (the express-lane
        contract), but within a band the tenants furthest below fair
        share tensorize first and win in-batch contention. Identity
        under KTPU_DRF=0 (the measured control) or for trivial pops."""
        if not self._drf_on or len(pods) < 2:
            return pods
        self.drf.ensure_capacity(self.algorithm.snapshot.node_infos)
        return self.drf.order_batch(pods)

    def schedule_pending(self, max_pods: Optional[int] = None,
                         timeout: float = 0.0) -> List[ScheduleResult]:
        """One scheduling cycle: drain a batch and decide it. Returns the
        results (callers: run loop, tests, benchmarks)."""
        self._gang_housekeeping()
        cycle = self.queue.scheduling_cycle
        def _mark_in_flight(n: int) -> None:
            self._in_flight = n
        pods = self.queue.pop_batch(max_pods or self._drain_cap(),
                                    timeout=timeout,
                                    on_pop=_mark_in_flight)
        if not pods:
            return []
        pods = self._drf_order(pods)
        if self.tracer.enabled:
            for pod in pods:
                self.tracer.pod_event("scheduler", "drain_member", pod,
                                      cycle=cycle)
        try:
            results: List[ScheduleResult] = []
            while pods:
                # spread-carrying pods sub-chunk so soft scores refresh
                # between chunks (core.soft_batch_limit)
                limit = self.algorithm.soft_batch_limit(pods)
                if limit < len(pods):
                    chunk, pods = pods[:limit], pods[limit:]
                else:
                    # keep the list object: soft_batch_limit's channel plan
                    # is memoized by list identity (core._soft_plan_cached)
                    chunk, pods = pods, []
                results.extend(self._schedule_batch_locked(chunk, cycle))
        finally:
            self._in_flight = 0
        return results

    def _schedule_batch_locked(self, pods: List[Pod], cycle: int
                               ) -> List[ScheduleResult]:
        import time as _time
        from ..utils.trace import Trace
        trace = Trace("schedule_batch", pods=len(pods), cycle=cycle)
        tr = self.tracer
        ts0 = tr.now() if tr.enabled else 0.0
        t0 = _time.perf_counter()
        results = self.algorithm.schedule(pods)
        trace.step("batch decided (tensorize + kernel + repair)")
        ts1 = tr.now() if tr.enabled else 0.0
        t1 = _time.perf_counter()
        self._commit_results(results, cycle)
        trace.step("results committed (volumes + plugins + bind + assume)")
        t2 = _time.perf_counter()
        if tr.enabled:
            ts2 = tr.now()
            tr.record("scheduler", "algorithm", ts0, ts1,
                      pods=len(pods), cycle=cycle)
            tr.record("scheduler", "commit", ts1, ts2,
                      pods=len(pods), cycle=cycle)
        # per-attempt step tracing, logged only when slow (ref: utiltrace
        # in generic_scheduler.go:185 with the same 100ms threshold)
        trace.log_if_long(100.0)
        m = self.metrics
        m.scheduling_duration.observe(t1 - t0, operation="algorithm")
        m.scheduling_duration.observe(t2 - t1, operation="commit")
        m.e2e_scheduling_duration.observe(t2 - t0)
        m.batch_size.observe(len(pods))
        m.observe_queue(self.queue)
        return results

    def _commit_results(self, results: List[ScheduleResult], cycle: int) -> int:
        """Requeue retries, park unschedulables, bind+assume winners.
        Returns the number of successful assumes (one cache mutation each —
        the pipelined drain's chain_seq bookkeeping)."""
        bound: List[ScheduleResult] = []
        for res in results:
            if res.node_name is None:
                if res.retry:
                    # lost an in-batch conflict; immediately rescheduleable
                    self.queue.add(res.pod)
                else:
                    self._handle_unschedulable(res.pod, cycle + 1)
            else:
                bound.append(res)
        if bound:
            return self._assume_and_bind_all(bound)
        return 0

    # ------------------------------------------------- pipelined drain

    @property
    def _commit_pool(self):
        if self._commit_pool_ is None:
            from concurrent.futures import ThreadPoolExecutor
            self._commit_pool_ = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="commit")
        return self._commit_pool_

    def _commit_overlaps(self) -> bool:
        if self._commit_async is None:
            import os as _os
            flag = _os.environ.get("KTPU_COMMIT_THREAD")
            if flag is not None:
                self._commit_async = flag != "0"
            elif self._async_bind:
                self._commit_async = True
            else:
                # a card's launch/fetch waits release the GIL, and on a
                # many-core host the CPU tensors run on cores the commit
                # thread doesn't contend; only a GIL-starved small host
                # loses to the extra thread
                self._commit_async = \
                    self.algorithm.device.type == "cuda" or \
                    (_os.cpu_count() or 1) >= 4
        return self._commit_async

    def _pipe_anchor(self) -> None:
        """(Re)anchor the chain-validity protocol. Callers guarantee no
        finish or commit is in flight. From here on, every cache mutation
        must be one of the pipeline's own tracked assumes for device-usage
        chaining to continue."""
        with self.cache.lock:
            self._pipe_base = self.cache.mutation_seq
            self._pipe_assumes = 0
        self._pipe_phantom = False
        self._pipe_outcomes.clear()

    def _chain_intact(self) -> bool:
        """True while every mutation since the anchor was our own tracked
        assume. Read atomically vs the commit thread (both counters only
        grow, so a foreign mutation breaks the equality permanently).
        core.schedule_launch calls this as its chain_seq check."""
        with self.cache.lock:
            return self.cache.mutation_seq == \
                self._pipe_base + self._pipe_assumes

    def _tracked_assume(self, pod: Pod) -> None:
        """cache.assume_pod plus the pipeline's own-mutation accounting in
        ONE cache-lock critical section — the commit thread assumes while
        the drain thread launches, and a torn read of (mutation_seq,
        assume count) would refuse every overlapped chain."""
        with self.cache.lock:
            self.cache.assume_pod(pod)
            self._pipe_assumes += 1

    def drain_pipelined(self) -> int:
        """Drain the queue with a three-stage pipeline:

            drain thread   pop -> tensorize -> device dispatch   (batch N+1)
            device         filter+score+assign scan              (batch N+1)
            commit thread  volumes + plugins + bind + assume     (batch N)

        Batch N+1's kernel runs against batch N's post-batch device usage
        (chained ahead of the host commit) so its scan sees N's placements
        without waiting for the commit, and the commit itself overlaps the
        next batch's tensorization and device compute instead of
        serializing the loop (BENCH_r05: host_commit was ~40% of batch
        wall time with the device idle). Gang batches chain like singleton
        batches — the gang kernel's trial/commit carry isolates rejected
        gangs, so its post-batch usage holds only committed placements.

        Chaining is refused — and the pipeline flushed back to the
        sequential path — whenever any cache mutation since the anchor was
        not the pipeline's own tracked assume (_chain_intact), the
        previous batch could be repaired on host, static scores are in
        play, or device state was resized/invalidated. A commit failure
        (lost bind, permit reject) forgets the assumed pod, invalidates
        chained device usage, and marks the pipeline phantom so in-flight
        chained batches retry their unassigned pods. Returns pods bound."""
        self._gang_housekeeping()
        with self._count_lock:
            start = self.scheduled_count
        prev: Optional[tuple] = None        # (PendingBatch, cycle)
        commit_fut = None                   # in-flight commit stage
        carry: List[Pod] = []               # soft-score sub-batch tail
        self._pipe_anchor()
        def _mark(n: int) -> None:
            with self._count_lock:
                self._in_flight += n
        try:
            while True:
                # per-cycle like schedule_pending's loop: a long drain must
                # still roll back permit-timeout reservations mid-stream
                # (the untracked forgets break the chain -> flush, which is
                # exactly the self-heal the rollback needs)
                self._gang_housekeeping()
                cycle = self.queue.scheduling_cycle
                if carry:
                    pods, carry = carry, []
                else:
                    pods = self.queue.pop_batch(self._drain_cap(), timeout=0,
                                                on_pop=_mark)
                    pods = self._drf_order(pods)
                if pods:
                    # spread-carrying pods schedule in sub-chunks so their
                    # soft scores refresh as winners land (core.soft_batch_limit)
                    limit = self.algorithm.soft_batch_limit(pods)
                    if limit < len(pods):
                        pods, carry = pods[:limit], pods[limit:]
                if pods and self._align_split and \
                        self.algorithm.topo_scan_likely(pods):
                    # bucket alignment for TOPOLOGY scans only: the
                    # class-indexed scan cut the per-step cost ~6x (r06),
                    # but topology steps still pay the [K, N] counter
                    # gathers per pad step, so trimming a 5000-pod pop to
                    # 4096+904 still beats one padded 8192-step scan
                    # (measured r06: +24%, down from +33% at r05). Plain
                    # batches keep the padded single launch: their grouped
                    # steps amortize padding better than a second launch
                    # costs (measured: splitting LOSES ~20% node-affinity)
                    P = len(pods)
                    aligned = 1 << (P.bit_length() - 1)
                    if aligned >= 4096 and P != aligned and \
                            P < (aligned << 1) - (aligned >> 2):
                        pods, extra = pods[:aligned], pods[aligned:]
                        carry = extra + carry
                if pods:
                    self.metrics.batch_size.observe(len(pods))
                    if self.tracer.enabled:
                        for pod in pods:
                            self.tracer.pod_event("scheduler",
                                                  "drain_member", pod,
                                                  cycle=cycle)
                if not pods and prev is None:
                    if commit_fut is not None:
                        # a failed commit may have requeued pods — settle
                        # it and re-check the queue
                        commit_fut.result()
                        commit_fut = None
                        continue
                    # drain the binder thread before declaring done: a
                    # failed async bind may have requeued its pod
                    if self._flush_binds():
                        continue
                    break
                pending = None
                if pods:
                    tl0 = self.tracer.now() if self.tracer.enabled else 0.0
                    if prev is not None:
                        with self._algo_lock:
                            pending = self.algorithm.schedule_launch(
                                pods, chain=prev[0],
                                chain_seq=self._chain_intact)
                    if pending is None:
                        # pipeline flush: settle every in-flight stage,
                        # then relaunch sequentially from host truth
                        if prev is not None:
                            commit_fut = self._finish_pipelined(
                                prev[0], prev[1], commit_fut)
                            prev = None
                        if commit_fut is not None:
                            commit_fut.result()
                            commit_fut = None
                        self._pipe_anchor()
                        with self._algo_lock:
                            pending = self.algorithm.schedule_launch(pods)
                    if self.tracer.enabled:
                        self.tracer.record(
                            "scheduler", "launch", tl0, self.tracer.now(),
                            pods=len(pods), cycle=cycle,
                            chained=bool(pending is not None
                                         and pending.chained))
                if prev is not None:
                    commit_fut = self._finish_pipelined(prev[0], prev[1],
                                                        commit_fut)
                prev = (pending, cycle) if pending is not None else None
        finally:
            if commit_fut is not None:
                try:
                    commit_fut.result()
                except Exception:
                    pass
            self._commit_lagging = False
            with self._count_lock:
                self._in_flight = 0
        with self._count_lock:
            return self.scheduled_count - start

    def _finish_pipelined(self, pending, cycle: int, commit_fut):
        """Fetch+repair `pending` on the drain thread, then hand its
        results to the commit stage (returns the new commit future). The
        PREDECESSOR's commit is joined first: this batch's repair
        validates against its final winners and losses."""
        import time as _time
        # commit thread -> drain signal: a stage still running when its
        # successor's scan finished means the hub side is the bottleneck
        # — the adaptive cap halves the next bulk batch until it catches
        # up (cleared here on a caught-up stage and on drain exit)
        self._commit_lagging = commit_fut is not None \
            and not commit_fut.done()
        if commit_fut is not None:
            commit_fut.result()
        if pending.chained:
            # winners the snapshot/mask predate: the last two finished
            # batches (their commits may postdate this batch's launch);
            # a conservative double-count only makes the repair stricter
            stale: list = []
            for winners in self._pipe_outcomes:
                stale.extend(winners)
            pending.stale_winners = stale or None
            pending.phantom = self._pipe_phantom
            if pending.phantom:
                # the chained usage permanently carries the lost winners;
                # drop device usage so the next launch re-uploads host
                # truth (and this batch's own adopt is epoch-refused)
                self.algorithm.mirror.invalidate_usage()
        tf0 = self.tracer.now() if self.tracer.enabled else 0.0
        t0 = _time.perf_counter()
        with self._algo_lock:
            results = self.algorithm.schedule_finish(pending)
        t1 = _time.perf_counter()
        self.metrics.scheduling_duration.observe(t1 - t0, operation="fetch")
        if self.tracer.enabled:
            self.tracer.record("scheduler", "fetch", tf0, self.tracer.now(),
                               pods=len(pending.pods), cycle=cycle)
        if any(r.retry for r in results):
            # losers the chained usage already counted: in-flight chained
            # successors must retry their unassigned pods, not park them
            self._pipe_phantom = True
        self._pipe_outcomes.append(
            [(r.pod, r.node_name) for r in results
             if r.node_name is not None])
        if self._commit_overlaps():
            return self._commit_pool.submit(self._commit_stage, results,
                                            cycle, t0)
        self._commit_stage(results, cycle, t0)
        return None

    def _commit_stage(self, results: List[ScheduleResult], cycle: int,
                      t_start: float) -> int:
        """The commit half, on the commit thread: requeue retries, park
        unschedulables, volume-bind + plugins + bind + assume winners. A
        loss discovered here (failed bind, duplicate, permit rollback)
        invalidates chained device usage; the epoch bump is folded into
        the pipeline's phantom flag so in-flight chained batches retry
        their unassigned pods. Returns the number of assumes."""
        import time as _time
        epoch_before = self.algorithm.mirror.usage_epoch
        tc0 = self.tracer.now() if self.tracer.enabled else 0.0
        t1 = _time.perf_counter()
        try:
            return self._commit_results(results, cycle)
        finally:
            if self.algorithm.mirror.usage_epoch != epoch_before:
                self._pipe_phantom = True
                self.robustness.commit_rollbacks.inc()
            t2 = _time.perf_counter()
            m = self.metrics
            m.scheduling_duration.observe(t2 - t1, operation="commit")
            m.commit_overlap_duration.observe(t2 - t1)
            m.e2e_scheduling_duration.observe(t2 - t_start)
            if self.tracer.enabled:
                self.tracer.record("scheduler", "commit", tc0,
                                   self.tracer.now(), pods=len(results),
                                   cycle=cycle)
            with self._count_lock:
                self._in_flight -= len(results)

    def _assume_and_bind_all(self, bound: List[ScheduleResult]) -> int:
        """Ref: scheduler.go assume :382 + bind :411 — batched and inverted:
        the whole batch is bound as ONE store transaction (bind_bulk), then
        each successfully bound pod is assumed into the cache using the
        store's own bound object — one clone per pod instead of two, and no
        forget path (a pod whose bind failed was never assumed).

        The reference assumes *before* its async bind goroutine so the next
        scheduleOne sees the pod; here bind is synchronous within the same
        cycle, so assume-after-bind exposes the same states to observers."""
        from ..state.store import ConflictError, NotFoundError
        from .framework import PluginContext, Status
        fresh: List[ScheduleResult] = []
        for res in bound:
            if self.cache.assigned_node(res.pod.metadata.key()) is not None:
                # duplicate event: the pod is already in the cache (assumed
                # or confirmed) from an earlier cycle — never re-bind; the
                # kernel double-counted it and no forget will repair that
                self.algorithm.mirror.invalidate_usage()
                continue
            if self._pod_wants_volumes(res.pod):
                # reserve PVs for unbound WaitForFirstConsumer claims before
                # the pod is committed anywhere (ref: scheduler.go:499
                # assumeVolumes before assume; bindVolumes :524 before bind).
                # Gang members only ASSUME here (reversible): the PV API
                # write is deferred past the permit gate — a timed-out
                # gang's rollback could not undo it, and a PV pinned to the
                # wrong ICI domain would wedge the gang's retry.
                gang_member = self.gang is not None \
                    and self.gang.is_member(res.pod)
                ni = self.algorithm.snapshot.node_infos.get(res.node_name)
                try:
                    if ni is None or ni.node is None:
                        raise ValueError(f"node {res.node_name} vanished")
                    self.volume_binder.assume_pod_volumes(res.pod, ni.node)
                    if not gang_member:
                        self.volume_binder.bind_pod_volumes(res.pod)
                except Exception:
                    # the kernel counted this pod as a winner; it will never
                    # be assumed — adopted device usage is unrepairable
                    self.volume_binder.forget_pod_volumes(res.pod)
                    self.algorithm.mirror.invalidate_usage()
                    self.queue.add_unschedulable_if_not_present(
                        res.pod, self.queue.scheduling_cycle)
                    continue
            # Reserve -> Permit -> Prebind plugin points (ref:
            # scheduler.go:507,:533 plus the later framework's Permit); a
            # failure rejects the pod for this cycle. One context PER POD,
            # matching the reference's per-scheduleOne pluginContext —
            # plugins key their scratch by fixed names, so sharing across
            # pods would leak one pod's reserve state into another's
            # prebind. With NO plugins registered (the common deployment)
            # the context and all three runner calls are skipped — at 16k
            # pods/batch the empty-runner round trips were measurable
            # commit-stage time.
            has_plugins = bool(self.framework.plugins)
            ctx = PluginContext() if has_plugins else None
            st = Status.ok()
            if has_plugins:
                st = self.framework.run_reserve_plugins(ctx, res.pod,
                                                        res.node_name)
                if st.success:
                    st = self.framework.run_permit_plugins(ctx, res.pod,
                                                           res.node_name)
            if st.success and not st.is_wait:
                gang_out = self._gang_permit(res)
                if gang_out is not None:
                    # the gang gate decided: [] = reserved & waiting for the
                    # rest of the gang; otherwise the whole released gang
                    # joins this bind transaction — ALL of it or NONE of it
                    # (one failed member must not leave a 3-of-4 slice).
                    # Reversible prebind plugins run first — the triggering
                    # pod with its own cycle context, earlier-cycle members
                    # with a fresh one (their reserve contexts are gone;
                    # never leak this pod's scratch into theirs) — and only
                    # then the deferred PV writes, so a plugin veto costs
                    # nothing irreversible.
                    fail_msg = None
                    if has_plugins:
                        for r, clone in gang_out:
                            rctx = ctx if r is res else PluginContext()
                            st2 = self.framework.run_prebind_plugins(
                                rctx, r.pod, r.node_name)
                            if not st2.success:
                                fail_msg = st2.message
                                break
                    if fail_msg is None:
                        # the deferred PV writes commit as ONE all-or-
                        # nothing multi-claim transaction: a mid-txn store
                        # failure (deleted-PV race) rolls back every claim
                        # already written, so no member's retry is ever
                        # volume-pinned to the old slice while the gang
                        # rolls back (the common veto — plugins — still
                        # runs before any write)
                        vol_pods = [r.pod for r, _ in gang_out
                                    if self._pod_wants_volumes(r.pod)]
                        if vol_pods:
                            try:
                                self.volume_binder.bind_pods_volumes(
                                    vol_pods)
                            except Exception as e:
                                fail_msg = str(e)
                    if fail_msg is None:
                        fresh.extend(r for r, _ in gang_out)
                    else:
                        for r, clone in gang_out:
                            self._gang_rollback_one(
                                r.pod, clone,
                                f"gang member rejected before bind: "
                                f"{fail_msg}")
                    continue
            if st.is_wait:
                # a generic permit plugin asked to wait: only the gang gate
                # has release machinery — park the pod for this cycle
                st = Status.error(st.message or "permit plugin asked to "
                                  "wait without a gang release path")
            if st.success and has_plugins:
                st = self.framework.run_prebind_plugins(ctx, res.pod,
                                                        res.node_name)
            if not st.success:
                self.volume_binder.forget_pod_volumes(res.pod)
                self.algorithm.mirror.invalidate_usage()
                self._record_event(res.pod, "FailedScheduling", st.message)
                self.queue.add_unschedulable_if_not_present(
                    res.pod, self.queue.scheduling_cycle)
                continue
            fresh.append(res)
        bound = fresh
        import time as _time
        if self._async_bind and self._bind_pool is not None:
            return self._assume_then_bind_async(bound)
        t_bind = _time.perf_counter()
        outs = self._bind_items_with_retry(
            [(res.pod.metadata.namespace, res.pod.metadata.name,
              res.node_name) for res in bound])
        self.metrics.binding_duration.observe(_time.perf_counter() - t_bind)
        nom_live = bool(self.queue.nominated.by_node())
        n_assumed = 0
        for res, out in zip(bound, outs):
            if not isinstance(out, Exception):
                if not hasattr(out, "metadata"):
                    # slim wire success (the server answers Status, like
                    # the reference's bind): assume our own local clone —
                    # the informer's MODIFIED echo carries the real object
                    out = serde.shallow_bind_clone(res.pod)
                    out.spec.node_name = res.node_name
                # ref: scheduler.go assume :382-409 — the nomination is
                # consumed the moment the pod lands (skipped wholesale
                # while the map is empty: nominations for pods in THIS
                # bind list can only predate the batch)
                if nom_live:
                    self.queue.nominated.delete(out)
                try:
                    self._tracked_assume(out)
                    n_assumed += 1
                except ValueError:
                    if self.cache.assigned_node(
                            out.metadata.key()) == res.node_name:
                        # our own bind's MODIFIED event raced ahead through
                        # the informer thread, or this is a gang member's
                        # permit-gate reservation: the cache already counts
                        # the pod exactly once on the right node — just arm
                        # the lost-confirmation TTL (no-op once confirmed)
                        self.cache.finish_binding(out)
                    else:
                        # a true duplicate: the kernel counted this pod once
                        # more than assume/forget ever will — adopted device
                        # usage is unrepairable
                        self.algorithm.mirror.invalidate_usage()
                else:
                    self.cache.finish_binding(out)
                if self.gang is not None:
                    self.gang.pod_bound(out)
                # winner commit: the DRF usage carry charges here
                # (idempotent by key; released on terminal/delete)
                self.drf.charge(out)
                with self._count_lock:
                    self.scheduled_count += 1
                self.metrics.schedule_attempts.inc(result="scheduled")
                self.tracer.pod_event("scheduler", "bound", out,
                                      node=res.node_name)
                self.attribution.discard(out.metadata.key())
                continue
            # any failed bind is a kernel winner that will never be assumed:
            # no dirty row can repair its phantom usage on device
            # (tensorize.adopt_usage contract) — drop the adopted tensors
            self.algorithm.mirror.invalidate_usage()
            if self.gang is not None and self.gang.is_member(res.pod):
                # a released gang member's reservation is still assumed;
                # drop it (dirty rows repair the mirror) before requeueing
                self.gang.bind_failed(res.pod)
                try:
                    self.cache.forget_pod(res.pod)
                except ValueError:
                    pass
            if isinstance(out, (NotFoundError, ConflictError)):
                # deleted while in flight, or a racing duplicate already
                # bound it elsewhere: drop, don't requeue forever
                if self.gang is not None:
                    self.gang.pod_dropped(res.pod)
                continue
            pod = res.pod
            self.metrics.schedule_attempts.inc(result="error")
            self.metrics.pod_scheduling_errors.inc()
            if pod.metadata.deletion_timestamp is not None:
                continue
            self.queue.add_unschedulable_if_not_present(
                pod, self.queue.scheduling_cycle)
        return n_assumed

    def _assume_then_bind_async(self, bound: List[ScheduleResult]) -> int:
        """Assume local clones NOW (the batch analog of scheduler.go:382's
        assume-releases-the-loop), ship the bulk bind from the binder
        thread. Returns the number of assumes (chain bookkeeping)."""
        import time as _time
        n_assumed = 0
        nom_live = bool(self.queue.nominated.by_node())
        pairs = []  # (result, assumed clone)
        for res in bound:
            out = serde.shallow_bind_clone(res.pod)
            out.spec.node_name = res.node_name
            if nom_live:
                self.queue.nominated.delete(out)
            try:
                self._tracked_assume(out)
                n_assumed += 1
            except ValueError:
                if self.cache.assigned_node(
                        out.metadata.key()) == res.node_name:
                    pass  # already counted once on the right node
                else:
                    self.algorithm.mirror.invalidate_usage()
                    continue
            pairs.append((res, out))
            self.drf.charge(out)
            with self._count_lock:
                self.scheduled_count += 1
            self.metrics.schedule_attempts.inc(result="scheduled")
            self.tracer.pod_event("scheduler", "bound", out,
                                  node=res.node_name)
            self.attribution.discard(out.metadata.key())
        if not pairs:
            return n_assumed
        items = [(res.pod.metadata.namespace, res.pod.metadata.name,
                  res.node_name) for res, _ in pairs]

        def job():
            t0 = _time.perf_counter()
            try:
                outs = self._bind_items_with_retry(items)
                self.metrics.binding_duration.observe(
                    _time.perf_counter() - t0)
                self._reconcile_bind_outcomes(pairs, outs)
            finally:
                with self._count_lock:
                    self._binds_inflight -= 1
        # prune settled futures, then BOUND the in-flight POSTs: at the
        # bound the drain blocks on the oldest transaction instead of
        # queueing binds unboundedly in the pool — the hub's backlog
        # becomes the drain's pacing (and _backpressure's shrink signal)
        self._bind_futures = [f for f in self._bind_futures
                              if not f.done()]
        while len(self._bind_futures) >= self.max_inflight_binds:
            oldest = self._bind_futures.pop(0)
            try:
                oldest.result()
            except Exception:
                pass
        with self._count_lock:
            self._binds_inflight += 1
        self._bind_futures.append(self._bind_pool.submit(job))
        return n_assumed

    def _bind_items_with_retry(self, items) -> list:
        """The bulk bind, from (namespace, podName, nodeName) tuples —
        issued as BindList PAIRS when the client supports them, so the
        hot path constructs no per-pod Binding/ObjectMeta/ObjectReference
        at all (3 dataclass inits per pod at 16k pods/batch was a
        measurable slice of the commit stage). Retried with backoff on
        transport-level failures (hub hiccup, injected chaos) — per-slot
        rejections (NotFound/Conflict) come back inside the result list
        and are NOT retried. A bind that still fails after the policy
        returns the error in every slot; the caller's forget/requeue
        machinery self-heals exactly as for any failed bind."""
        from ..utils import backoff
        tb0 = self.tracer.now() if self.tracer.enabled else 0.0
        try:
            return self._bind_items_inner(items, backoff)
        finally:
            if self.tracer.enabled:
                self.tracer.record("scheduler", "bind_txn", tb0,
                                   self.tracer.now(), pods=len(items))

    def _bind_items_inner(self, items, backoff) -> list:
        pc = self.client.pods()
        if not hasattr(pc, "bind_bulk_pairs"):
            bindings = [Binding(
                metadata=ObjectMeta(name=name, namespace=ns),
                target=ObjectReference(kind="Node", name=node))
                for ns, name, node in items]
            try:
                return backoff.retry(
                    lambda: self.client.pods().bind_bulk(bindings),
                    clock=self.clock, metrics=self.robustness,
                    component="scheduler", op="bind_bulk")
            except Exception as e:
                return [e] * len(items)
        by_ns: dict = {}
        for i, (ns, name, node) in enumerate(items):
            by_ns.setdefault(ns, []).append((i, name, node))
        out: list = [None] * len(items)
        for ns, slots in by_ns.items():
            pair_list = [(name, node) for _, name, node in slots]
            try:
                rs = backoff.retry(
                    lambda ns=ns, pl=pair_list:
                    self.client.pods().bind_bulk_pairs(ns, pl),
                    clock=self.clock, metrics=self.robustness,
                    component="scheduler", op="bind_bulk")
            except Exception as e:
                rs = [e] * len(pair_list)
            for (i, _, _), r in zip(slots, rs):
                out[i] = r
        return out

    def _reconcile_bind_outcomes(self, pairs, outs) -> None:
        """Binder-thread half: a failed slot's pod was optimistically
        assumed and counted — forget it, drop the adopted device usage
        (a kernel winner that never lands is unrepairable by dirty rows),
        and requeue unless it vanished."""
        from ..state.store import ConflictError, NotFoundError
        for (res, clone), out in zip(pairs, outs):
            if not isinstance(out, Exception):
                self.cache.finish_binding(clone)
                if self.gang is not None:
                    self.gang.pod_bound(clone)
                continue
            try:
                self.cache.forget_pod(clone)
            except Exception:
                pass
            if self.gang is not None:
                self.gang.bind_failed(res.pod)
            self.drf.release(clone)
            self.algorithm.mirror.invalidate_usage()
            with self._count_lock:
                self.scheduled_count -= 1
            self.metrics.schedule_attempts.inc(result="error")
            self.metrics.pod_scheduling_errors.inc()
            if isinstance(out, (NotFoundError, ConflictError)):
                continue  # deleted in flight / already bound elsewhere
            if res.pod.metadata.deletion_timestamp is not None:
                continue
            self.queue.add_unschedulable_if_not_present(
                res.pod, self.queue.scheduling_cycle)

    def _flush_binds(self) -> bool:
        """Wait out every in-flight bind POST. True if any bind failed
        (its pod may have been requeued — the drain loop re-checks)."""
        futures, self._bind_futures = self._bind_futures, []
        if not futures:
            return False
        before = self.metrics.pod_scheduling_errors.value()
        for f in futures:
            try:
                f.result()
            except Exception:
                pass
        return self.metrics.pod_scheduling_errors.value() > before

    # ------------------------------------------------------------ gang

    @staticmethod
    def _pod_wants_volumes(pod: Pod) -> bool:
        return any(v.persistent_volume_claim for v in pod.spec.volumes)

    def _gang_permit(self, res: ScheduleResult):
        """The gang permit gate for one winner. Returns None for non-gang
        pods (normal flow), [] when the pod RESERVED its node (assumed in
        the cache, bind deferred until the gang completes), or the list of
        (ScheduleResult, reservation clone) for every released member —
        the whole gang, ready to join this cycle's bind transaction."""
        if self.gang is None or not self.gang.is_member(res.pod):
            return None
        from ..utils.trace import Trace
        trace = Trace("gang_permit", pod=res.pod.metadata.name,
                      node=res.node_name)
        clone = serde.shallow_bind_clone(res.pod)
        clone.spec.node_name = res.node_name
        try:
            # the RESERVATION: the gang member's space is held on its node
            # so later batches cannot steal it while the rest of the gang
            # is still scheduling (rolled back by expire on timeout).
            # Tracked: the kernel counted the member in the chained usage,
            # so the reservation keeps the chain account balanced.
            self._tracked_assume(clone)
        except ValueError:
            if self.cache.assigned_node(
                    clone.metadata.key()) != res.node_name:
                # duplicate on another node: kernel double-counted
                self.algorithm.mirror.invalidate_usage()
                self.gang.pod_dropped(res.pod)
                return []
            # already reserved here (re-permit after a requeue race): fall
            # through and let the gate recount it
        trace.step("reservation assumed into cache")
        decision, released = self.gang.permit(res.pod, clone, res.node_name)
        trace.step(f"permit: {decision}, {len(released)} member(s) released")
        trace.log_if_long(100.0)
        if decision == "reject":
            # the node breaks the gang's cross-batch ICI-domain pin: drop
            # the reservation — cache clone AND the cycle's PV assumption,
            # which would otherwise pin a PV outside the gang's slice —
            # and retry; the next launch seeds the kernel with the pin.
            # The UNtracked forget breaks the chain equality (next launch
            # flushes); the kernel counted this member in chained usage,
            # so drop device usage and phantom-mark in-flight batches.
            try:
                self.cache.forget_pod(clone)
            except ValueError:
                pass
            self.algorithm.mirror.invalidate_usage()
            self._pipe_phantom = True
            self.volume_binder.forget_pod_volumes(res.pod)
            self.queue.add(res.pod)
            return []
        if decision == "wait":
            return []
        out = []
        for rpod, rclone, rnode in released:
            if rpod.metadata.key() == res.pod.metadata.key():
                out.append((res, rclone))
            else:
                out.append((ScheduleResult(rpod, rnode), rclone))
        return out

    def _gang_rollback_one(self, pod: Pod, clone: Pod, message: str) -> None:
        """A released member failed prebind: drop its reservation and park
        it; assume/forget dirty rows repair the device mirror. Chained
        device usage counted the member — invalidate it and phantom-mark
        the pipeline (in-flight chained batches retry, not park)."""
        try:
            self.cache.forget_pod(clone)
        except ValueError:
            pass
        if self.gang is not None:
            self.gang.bind_failed(pod)
        self.algorithm.mirror.invalidate_usage()
        self._pipe_phantom = True
        self.volume_binder.forget_pod_volumes(pod)
        self._record_event(pod, "FailedScheduling", message)
        self.queue.add_unschedulable_if_not_present(
            pod, self.queue.scheduling_cycle)

    def _gang_housekeeping(self) -> None:
        """Roll back permit-gate reservations whose gang missed its
        scheduleTimeoutSeconds: the WHOLE gang's assumed pods leave the
        cache in one sweep (forget bumps node generations, so the next
        dirty scatter repairs device usage) and the members requeue."""
        if self.gang is None:
            return
        if self._drf_on:
            # refresh the per-tenant dominant-share gauge once per cycle
            self.tenancy_metrics.sample_shares(self.drf)
        rollbacks, requeue = self.gang.expire(self.clock.now())
        if not rollbacks and not requeue:
            return
        from ..utils.trace import Trace
        trace = Trace("gang_rollback", reservations=len(rollbacks))
        if self.cache.forget_pods([clone for _, clone in rollbacks]):
            self._pipe_phantom = True
        trace.step("gang reservations rolled back from the cache")
        cycle = self.queue.scheduling_cycle
        for pod in requeue:
            # assumed volume state is reversible — the PV API write was
            # deferred past the permit gate, so this undoes everything
            self.volume_binder.forget_pod_volumes(pod)
            self._record_event(
                pod, "FailedScheduling",
                "gang permit wait timed out; reservations rolled back")
            self.queue.add_unschedulable_if_not_present(pod, cycle)
        trace.step("members requeued")
        trace.log_if_long(100.0)

    def _handle_unschedulable(self, pod: Pod, cycle: int) -> None:
        self.unschedulable_count += 1
        self.metrics.schedule_attempts.inc(result="unschedulable")
        self.queue.add_unschedulable_if_not_present(pod, cycle)
        # _algo_lock: this may run on the COMMIT thread while the drain
        # thread tensorizes the next batch — explain iterates the snapshot
        # and preempt refreshes it, both of which would race the launch
        with self._algo_lock:
            try:
                fit_err = self.algorithm.explain(pod)
                # per-reason attribution: one tally per distinct reason
                # in this attempt's diagnosis, the dominant reason (most
                # nodes) as the pod's last-failure record, and the full
                # rendering as a FailedScheduling event — "why is my pod
                # pending" answerable from /metrics, /debug/pending, and
                # the event stream respectively
                counts: dict = {}
                for reasons in fit_err.failed_predicates.values():
                    for r in reasons:
                        counts[r] = counts.get(r, 0) + 1
                for r in counts:
                    self.metrics.unschedulable_reasons.inc(reason=r)
                top = max(counts, key=lambda r: (counts[r], r)) \
                    if counts else "NoNodesAvailable"
                message = fit_err.error()
                self.attribution.record(pod.metadata.key(), top, message,
                                        cycle=cycle)
                self._record_event(pod, "FailedScheduling", message)
            except Exception:
                pass
            self._try_preempt(pod)

    def _try_preempt(self, pod: Pod) -> None:
        """Ref: scheduler.go preempt (:292-380). The victim-pricing and
        domain-pricing kernels are not ported: algorithm.preempt and
        preempt_gang raise NotImplementedError, and the port lets it
        through where the reference prints an exception and carries on.
        The nominate/evict half of the reference follows the kernels in
        (ROADMAP, Queue A item 4)."""
        if self.disable_preemption:
            return
        if self.gang is not None and self.gang.is_member(pod):
            # single-member preemption cannot help a gang: the reference
            # routes the WHOLE gang through the domain-pricing kernel
            self.metrics.preemption_gang_routed.inc()
            self._try_preempt_gang(pod)
            return
        self.algorithm.preempt(pod)

    def _try_preempt_gang(self, pod: Pod) -> None:
        """Whole-gang preemption: price every ICI domain for the parked
        gang's demand shape (core.preempt_gang, not ported: raises)."""
        from ..api.scheduling import pod_group_key
        gkey = pod_group_key(pod)
        if gkey is None or self.gang is None:
            return
        members = self.gang.pending_members(gkey)
        if not members:
            return
        mm = self.gang.min_member(gkey)
        if mm is None:
            return  # PodGroup object gone; members park until it returns
        self.algorithm.preempt_gang(members, mm, self.gang.topology_key(gkey))

    def _record_event(self, pod: Pod, reason: str, message: str) -> None:
        """Ref: client-go tools/record EventRecorder -> apiserver Events;
        the recorder correlates (count-bump + aggregation + spam filter) so
        a hot failure loop cannot flood the store with Event objects."""
        try:
            self.recorder.event(pod, "Warning", reason, message)
        except Exception:
            pass

    # ------------------------------------------------------------- run

    def start(self) -> None:
        """Start informers and the scheduling loop (ref: Scheduler.Run)."""
        self.informers.start()
        self.informers.wait_for_cache_sync()
        self._thread = threading.Thread(target=self._run_loop, daemon=True)
        self._thread.start()

    def _run_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.schedule_pending(timeout=0.2)
            except NotImplementedError as e:
                # an unported route: keep the error and stop the loop;
                # stop() and wait_for_idle() raise it
                self._loop_error = e
                self._stop.set()
                return
            except Exception:
                import traceback
                traceback.print_exc()
            self.cache.cleanup_expired_assumed_pods()

    def _raise_loop_error(self) -> None:
        if self._loop_error is not None:
            raise self._loop_error

    def stop(self) -> None:
        self._stop.set()
        self.queue.close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self._commit_pool_ is not None:
            self._commit_pool_.shutdown(wait=True)
        if self._bind_pool is not None:
            self._flush_binds()
            self._bind_pool.shutdown(wait=True)
        self.informers.stop()
        self._raise_loop_error()

    def crash(self) -> None:
        """Abandon this scheduler as a dead process would: worker pools
        shut down WITHOUT draining — in-flight binds and commits are
        lost, assumed pods and permit reservations die with the object.
        The replacement rebuilds all of that from a fresh informer sync
        (the chaos harness's restart_scheduler drives exactly this).
        Informers are the factory's to stop; stop() stays the graceful
        path that drains everything."""
        self._stop.set()
        if self._commit_pool_ is not None:
            self._commit_pool_.shutdown(wait=False)
        if self._bind_pool is not None:
            self._bind_pool.shutdown(wait=False)

    def wait_for_idle(self, timeout: float = 30.0, settle: float = 0.25,
                      clock: Clock = REAL_CLOCK) -> bool:
        """Test helper: wait until no pod is pending OR in flight, and that
        stays true for `settle` seconds (creations reach the queue through
        the async informer, so a single instantaneous check can observe
        "idle" before deliveries land).

        `clock` defaults to REAL time, deliberately NOT self.clock:
        queue deliveries ride informer threads that run in real time
        even when the scheduler's own clock is a FakeClock, and
        sleeping on a shared virtual clock would STEP it from this
        helper and perturb the deterministic event timeline."""
        deadline = clock.now() + timeout
        idle_since: Optional[float] = None
        while clock.now() < deadline:
            self._raise_loop_error()
            if self.queue.num_pending() == 0 and self._in_flight == 0:
                now = clock.now()
                if idle_since is None:
                    idle_since = now
                elif now - idle_since >= settle:
                    return True
            else:
                idle_since = None
            clock.sleep(0.01)
        return self.queue.num_pending() == 0 and self._in_flight == 0
