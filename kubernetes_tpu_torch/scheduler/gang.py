"""Gang scheduling — PodGroup grouping, queue admission, and the permit gate.

The coscheduling subsystem (ref: the Kueue/JobSet lineage in PAPERS.md;
mechanism modeled on sigs.k8s.io/scheduler-plugins' coscheduling plugin,
adapted to the batch kernel). Three gates keep a multi-host TPU slice's
workers ALL-OR-NOTHING:

  1. Queue admission (pop_gate): a gang member popped before `minMember`
     members are pending is PARKED — removed from the active heap but kept
     pending — so a starved gang can never head-of-line-block singletons.
     The arrival that completes the gang releases every parked member in
     the same queue-lock critical section (pod_pending), so one batch pop
     sees the whole gang.

  2. All-or-nothing placement: gang-carrying batches route through
     kernels/gang.py, which places each gang atomically against running
     usage (every member lands, on one ICI topology domain) or rejects the
     whole gang — no partial gang ever reaches the bind path from a single
     batch.

  3. Permit gate (permit/expire): when a gang still straddles batches
     (gang larger than a batch, retry races), winners RESERVE their nodes
     — assumed into the scheduler cache so the space is held — but bind
     only once `minMember` members hold reservations. A reservation older
     than the PodGroup's scheduleTimeoutSeconds rolls the WHOLE gang back
     (cache.forget_pods, one atomic sweep) and requeues the members.

Pods labeled into a PodGroup that does not exist yet are parked until it
appears (group_changed releases them) — scheduling them as singletons
would wedge the slice the moment the PodGroup arrives.

Lock order: callers holding the SchedulingQueue lock may call into the
manager (pop/add hooks); the manager never calls back into the queue, so
queue-lock -> manager-lock is the only ordering.

Pipelined-drain interplay: permit-gate reservations are TRACKED assumes
(scheduler._tracked_assume), so a gang straddling batches keeps the
device-usage chain account balanced; every rollback path here (reject,
timeout expire, node_gone, bind_failed) forgets reservations UNtracked —
by design, that breaks the chain equality so the drain flushes and
relaunches from host truth, and the scheduler shell phantom-marks
in-flight chained batches whose usage counted the rolled-back members.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple

from ..api.core import Pod
from ..api.scheduling import (DEFAULT_SCHEDULE_TIMEOUT, PodGroup,
                              pod_group_key)
from ..utils.clock import Clock, REAL_CLOCK

#: seconds a parked (below-minMember) member waits before it is handed to
#: the queue's unschedulable backoff machinery — the slow-path retry that
#: re-evaluates a PodGroup whose spec changed under a parked gang
PARK_TIMEOUT = 60.0

#: pop_gate verdicts
ADMIT = "admit"
PARK = "park"
#: parked for an exhausted per-namespace active-gang quota — its own
#: verdict so the queue can attribute it as QuotaExhausted, not as a
#: gang that merely has not formed yet
PARK_QUOTA = "park-quota"


class _Gang:
    """Per-PodGroup member bookkeeping. States are disjoint key sets:
    pending (in the queue, parked subset marked separately), inflight
    (popped, being decided), waiting (node reserved at the permit gate),
    bound (bind committed). Admissibility counts them all — a gang is
    schedulable when enough members EXIST to complete it, not only when
    all of them happen to sit in the queue at once."""

    __slots__ = ("key", "pending", "parked", "inflight", "waiting", "bound",
                 "first_wait", "dom_pin")

    def __init__(self, key: str):
        self.key = key
        self.pending: Dict[str, Pod] = {}
        self.parked: Dict[str, float] = {}          # pod key -> parked at
        self.inflight: Dict[str, float] = {}        # pod key -> popped at
        # pod key -> (queue pod, assumed clone, node name, reserved at)
        self.waiting: Dict[str, Tuple[Pod, Pod, str, float]] = {}
        self.bound: set = set()
        self.first_wait: Optional[float] = None
        #: topology-label VALUE the gang's reservations agree on — the
        #: kernel pins a domain only within one batch; this is the
        #: cross-batch pin (None until the first constrained reservation)
        self.dom_pin: Optional[str] = None

    def member_count(self) -> int:
        return (len(self.pending) + len(self.inflight)
                + len(self.waiting) + len(self.bound))

    def reserved_count(self) -> int:
        return len(self.waiting) + len(self.bound)

    def empty(self) -> bool:
        return self.member_count() == 0


class GangManager:
    """Groups pending pods by PodGroup and drives all three gang gates.

    `group_lookup(namespace, name) -> Optional[PodGroup]` is consulted on
    every decision (an informer indexer get), so spec changes — minMember
    lowered, timeout raised — take effect without replumbing.
    """

    def __init__(self, group_lookup: Callable[[str, str], Optional[PodGroup]],
                 clock: Clock = REAL_CLOCK, metrics=None,
                 node_label: Optional[Callable[[str, str],
                                              Optional[str]]] = None,
                 quota_gate=None):
        self._lookup = group_lookup
        self._clock = clock
        self.metrics = metrics
        #: node_label(node_name, label_key) -> value | None; the permit
        #: gate's cross-batch ICI-domain check (None disables it)
        self._node_label = node_label
        #: tenancy.GangQuotaGate (optional): per-namespace active-gang
        #: slots claimed at pop admission, returned when the gang's last
        #: member leaves the books (_gc)
        self.quota_gate = quota_gate
        self._lock = threading.RLock()
        self._gangs: Dict[str, _Gang] = {}
        #: gang key -> the QuotaBlock that last parked it (attribution)
        self._quota_blocks: Dict[str, object] = {}
        #: a slot was returned since the last quota_released() sweep
        self._quota_freed = False
        #: reservations invalidated outside the permit flow (their pod was
        #: deleted while waiting); drained by expire() for cache rollback
        self._orphaned: List[Tuple[Pod, Pod]] = []

    # ----------------------------------------------------------- lookup

    def _spec(self, gkey: str) -> Optional[PodGroup]:
        ns, _, name = gkey.partition("/")
        return self._lookup(ns, name)

    def _min_member(self, gkey: str) -> Optional[int]:
        """None while the PodGroup object does not exist (members park)."""
        pg = self._spec(gkey)
        return None if pg is None else max(1, pg.spec.min_member)

    def _timeout(self, gkey: str) -> float:
        pg = self._spec(gkey)
        if pg is None:
            return float(DEFAULT_SCHEDULE_TIMEOUT)
        return float(pg.spec.schedule_timeout_seconds)

    def topology_key(self, gkey: str) -> str:
        pg = self._spec(gkey)
        return pg.spec.topology_key if pg is not None else ""

    def _gang(self, gkey: str) -> _Gang:
        g = self._gangs.get(gkey)
        if g is None:
            g = _Gang(gkey)
            self._gangs[gkey] = g
        return g

    def _admissible(self, g: _Gang) -> bool:
        mm = self._min_member(g.key)
        return mm is not None and g.member_count() >= mm

    def _gc(self, g: _Gang) -> None:
        if not g.waiting and not g.bound:
            # no reservation left to agree with: the next generation of
            # reservations picks its own domain
            g.dom_pin = None
        if g.empty():
            self._gangs.pop(g.key, None)
            self._quota_blocks.pop(g.key, None)
            if self.quota_gate is not None \
                    and self.quota_gate.release(g.key):
                self._quota_freed = True

    def _observe_pending(self) -> None:
        if self.metrics is not None:
            self.metrics.gangs_pending.set(
                sum(1 for g in self._gangs.values() if g.parked),
                stage="queue")
            self.metrics.gangs_pending.set(
                sum(1 for g in self._gangs.values() if g.waiting),
                stage="permit")

    def min_member(self, gkey: str) -> Optional[int]:
        """Public minMember lookup (None while the PodGroup is absent)."""
        return self._min_member(gkey)

    def pending_members(self, gkey: str) -> List[Pod]:
        """The gang's pending (incl. parked) member pods in sorted-key
        order — whole-gang preemption's placement list."""
        with self._lock:
            g = self._gangs.get(gkey)
            if g is None:
                return []
            return [g.pending[k] for k in sorted(g.pending)]

    def demand_shapes(self) -> List[dict]:
        """Every stuck gang as a capacity-demand SHAPE: minMember x the
        representative member request x one ICI domain (topology key).
        The autoscaler's scale-up signal and /debug/pending's parked-gang
        report both read this — a parked gang is not just a queue state,
        it is a slice the cluster does not have."""
        from .nodeinfo import pod_resource
        out: List[dict] = []
        with self._lock:
            for gkey in sorted(self._gangs):
                g = self._gangs[gkey]
                if not g.pending:
                    continue
                pg = self._spec(gkey)
                if pg is None:
                    continue
                rep = g.pending[sorted(g.pending)[0]]
                r = pod_resource(rep)
                out.append({
                    "gang": gkey,
                    "min_member": max(1, pg.spec.min_member),
                    "pending": len(g.pending),
                    "parked": len(g.parked),
                    "reserved": g.reserved_count(),
                    "members": sorted(g.pending),
                    "topology_key": pg.spec.topology_key,
                    "cpu_m": r.milli_cpu,
                    "memory": r.memory,
                    "scalars": dict(r.scalar_resources)})
        return out

    # ------------------------------------------------------ queue hooks

    def pod_pending(self, pod: Pod) -> List[str]:
        """A gang member (re)entered the pending set. Returns the parked
        member keys to reactivate when this arrival makes the gang
        admissible — the caller (queue, under its lock) pushes them back
        onto the active heap so one batch pop sees the whole gang."""
        gkey = pod_group_key(pod)
        if gkey is None:
            return []
        with self._lock:
            g = self._gang(gkey)
            key = pod.metadata.key()
            g.inflight.pop(key, None)
            if key not in g.waiting and key not in g.bound:
                g.pending[key] = pod
            released: List[str] = []
            if g.parked and self._admissible(g):
                released = list(g.parked)
                g.parked.clear()
            self._observe_pending()
            return released

    def pod_gone(self, pod: Pod) -> None:
        """Queue delete: the pod was removed while unbound. A waiting
        member's reservation is orphaned for the next expire() sweep to
        roll back; bound members are kept — they still count toward the
        gang until the controller takes over."""
        gkey = pod_group_key(pod)
        if gkey is None:
            return
        with self._lock:
            g = self._gangs.get(gkey)
            if g is None:
                return
            key = pod.metadata.key()
            if key in g.bound:
                return
            g.pending.pop(key, None)
            g.parked.pop(key, None)
            g.inflight.pop(key, None)
            entry = g.waiting.pop(key, None)
            if entry is not None:
                self._orphaned.append((entry[0], entry[1]))
            if not g.waiting:
                g.first_wait = None
            self._gc(g)
            self._observe_pending()

    def pop_gate(self, pod: Pod) -> str:
        """Pop-time admission (called under the queue lock, pod still in
        the queue's pending map). ADMIT marks the member in flight; PARK
        tells the queue to hold the pod out of the active heap;
        PARK_QUOTA is the same hold but because the namespace's
        active-gang quota is exhausted (the block is retrievable via
        quota_block_for until a slot frees up)."""
        gkey = pod_group_key(pod)
        if gkey is None:
            return ADMIT
        with self._lock:
            g = self._gang(gkey)
            key = pod.metadata.key()
            if key not in g.pending:
                g.pending[key] = pod
            if self._admissible(g):
                # an admissible gang additionally needs an active-gang
                # slot — unless it already holds reservations or bound
                # members (a started gang must be allowed to finish;
                # try_admit is idempotent while the slot is held)
                if self.quota_gate is not None and g.reserved_count() == 0:
                    block = self.quota_gate.try_admit(gkey)
                    if block is not None:
                        self._quota_blocks[gkey] = block
                        g.parked.setdefault(key, self._clock.now())
                        self._observe_pending()
                        return PARK_QUOTA
                self._quota_blocks.pop(gkey, None)
                g.pending.pop(key, None)
                g.parked.pop(key, None)
                g.inflight[key] = self._clock.now()
                return ADMIT
            g.parked.setdefault(key, self._clock.now())
            self._observe_pending()
            return PARK

    def quota_block_for(self, pod: Pod):
        """The QuotaBlock that parked this member's gang (None when the
        gang is not quota-parked) — the queue's attribution source."""
        gkey = pod_group_key(pod)
        if gkey is None:
            return None
        with self._lock:
            return self._quota_blocks.get(gkey)

    def quota_changed(self) -> None:
        """A ResourceQuota was raised/deleted: treat it like a freed
        slot so the next quota_released() sweep re-evaluates parked
        gangs against the new limit."""
        with self._lock:
            self._quota_freed = True

    def quota_released(self) -> List[str]:
        """Reactivation sweep after an active-gang slot was returned:
        every parked member of an admissible gang goes back to the
        active heap (optimistic — pop_gate re-checks the quota, so a
        gang that still cannot get a slot simply re-parks). Returns
        nothing when no slot was freed since the last sweep."""
        with self._lock:
            if not self._quota_freed:
                return []
            self._quota_freed = False
            out: List[str] = []
            for g in self._gangs.values():
                if g.parked and self._admissible(g):
                    out.extend(g.parked)
                    g.parked.clear()
            self._observe_pending()
            return out

    def group_changed(self, gkey: str) -> List[str]:
        """A PodGroup was created/updated: parked members may now clear
        the (possibly lowered) minMember bar."""
        with self._lock:
            g = self._gangs.get(gkey)
            if g is None or not g.parked or not self._admissible(g):
                return []
            released = list(g.parked)
            g.parked.clear()
            self._observe_pending()
            return released

    def expired_parked(self, now: float) -> List[str]:
        """Parked members older than PARK_TIMEOUT, handed to the queue's
        unschedulable backoff machinery (the gang's slow-path retry). The
        park marks are cleared; the pods stay pending members."""
        with self._lock:
            out: List[str] = []
            for g in self._gangs.values():
                for key, ts in list(g.parked.items()):
                    if now - ts >= PARK_TIMEOUT:
                        del g.parked[key]
                        out.append(key)
            return out

    # ------------------------------------------------------ permit gate

    def is_member(self, pod: Pod) -> bool:
        return pod_group_key(pod) is not None

    def permit(self, pod: Pod, clone: Pod, node_name: str
               ) -> Tuple[str, List[Tuple[Pod, Pod, str]]]:
        """A gang member won a node and its reservation (`clone`) is
        assumed in the cache. Returns ("allow", released) with EVERY
        waiting reservation (this one included) when the gang reached
        minMember — the caller binds them as one transaction —
        ("wait", []) while the gang is still short, or ("reject", [])
        when this node breaks the gang's cross-batch ICI-domain pin (the
        caller must drop the reservation and requeue the pod: the kernel
        pins a domain only within one batch, so a gang split across
        batches could otherwise reserve on two slices and bind straddled)."""
        gkey = pod_group_key(pod)
        assert gkey is not None
        now = self._clock.now()
        with self._lock:
            g = self._gang(gkey)
            key = pod.metadata.key()
            tk = self.topology_key(gkey)
            if tk and self._node_label is not None:
                val = self._node_label(node_name, tk)
                if val is None or (g.dom_pin is not None
                                   and val != g.dom_pin):
                    g.pending.pop(key, None)
                    g.inflight.pop(key, None)
                    return "reject", []
                if g.dom_pin is None:
                    g.dom_pin = val
            g.pending.pop(key, None)
            g.inflight.pop(key, None)
            g.waiting[key] = (pod, clone, node_name, now)
            if g.first_wait is None:
                g.first_wait = now
            mm = self._min_member(gkey)
            if mm is not None and g.reserved_count() >= mm:
                released = [(p, c, n) for p, c, n, _ in g.waiting.values()]
                if self.metrics is not None:
                    for _, _, _, since in g.waiting.values():
                        self.metrics.gang_permit_wait.observe(now - since)
                    self.metrics.gangs_admitted.inc()
                g.bound.update(g.waiting)
                g.waiting.clear()
                g.first_wait = None
                self._observe_pending()
                return "allow", released
            self._observe_pending()
            return "wait", []

    def bind_failed(self, pod: Pod) -> Optional[Pod]:
        """A released member's bind failed: hand back its assumed clone so
        the caller can roll the reservation off the cache. The member
        leaves the bound set; requeueing (or dropping) it is the bind
        path's decision, and its re-add flows through pod_pending."""
        gkey = pod_group_key(pod)
        if gkey is None:
            return None
        with self._lock:
            g = self._gangs.get(gkey)
            if g is None:
                return None
            g.bound.discard(pod.metadata.key())
            self._gc(g)
            return None  # clone already handed out with the release

    def pod_bound(self, pod: Pod) -> None:
        """A member's bind committed (also reached via the normal
        singleton path when a whole gang bound in one batch)."""
        gkey = pod_group_key(pod)
        if gkey is None:
            return
        with self._lock:
            g = self._gangs.get(gkey)
            if g is None:
                return
            key = pod.metadata.key()
            g.pending.pop(key, None)
            g.inflight.pop(key, None)
            g.waiting.pop(key, None)
            g.bound.add(key)
            if not g.waiting:
                g.first_wait = None

    def bind_regressed(self, pod: Pod
                       ) -> Tuple[List[Tuple[Pod, Pod]], List[Pod]]:
        """The store REGRESSED this member's bind (torn-WAL recovery:
        the journal lost the bind transaction's tail and the pod is
        Pending again). The member leaves the bound set — its re-add
        flows through pod_pending like any requeue — and, per the gangs'
        whole-group convention, every reservation the gang still holds
        at the permit gate rolls back NOW: the group's placement
        integrity is in doubt (sibling binds may be torn too, the
        dom_pin may reference a placement the store no longer records),
        and waiting out scheduleTimeoutSeconds just delays the retry.
        Returns (rollbacks, requeue) in node_gone's shape."""
        gkey = pod_group_key(pod)
        if gkey is None:
            return [], []
        with self._lock:
            g = self._gangs.get(gkey)
            if g is None:
                return [], []
            g.bound.discard(pod.metadata.key())
            rollbacks: List[Tuple[Pod, Pod]] = []
            requeue: List[Pod] = []
            now = self._clock.now()
            for p, clone, _node, since in g.waiting.values():
                rollbacks.append((p, clone))
                requeue.append(p)
                if self.metrics is not None:
                    self.metrics.gang_permit_wait.observe(now - since)
            g.waiting.clear()
            g.first_wait = None
            self._gc(g)  # clears dom_pin with the last reservation
            self._observe_pending()
            return rollbacks, requeue

    def pod_dropped(self, pod: Pod) -> None:
        """A member left the system for good: deleted in flight, deleted or
        terminal after binding, duplicate bind. Unlike pod_gone (queue
        deletes, where bound members must keep counting toward the gang),
        this removes the key from EVERY state including bound — a deleted
        worker must not inflate reserved_count forever, or a re-created
        gang would release partially against stale counts."""
        gkey = pod_group_key(pod)
        if gkey is None:
            return
        with self._lock:
            g = self._gangs.get(gkey)
            if g is None:
                return
            key = pod.metadata.key()
            g.pending.pop(key, None)
            g.parked.pop(key, None)
            g.inflight.pop(key, None)
            g.waiting.pop(key, None)
            g.bound.discard(key)
            self._gc(g)

    def node_gone(self, node_name: str
                  ) -> Tuple[List[Tuple[Pod, Pod]], List[Pod]]:
        """A node vanished (deleted, or NoExecute-tainted dead): every
        permit-gate reservation on it is pinned to a broken slice.
        Unlike pod_gone — where only the deleted pod's reservation is
        orphaned — the WHOLE affected gang rolls back NOW: the surviving
        members' reservations hold space the gang can no longer use
        (the dom_pin may point at the dead slice), and waiting out
        scheduleTimeoutSeconds just delays the retry. Returns
        (rollbacks, requeue) in expire()'s shape: (pod, assumed clone)
        pairs to forget from the cache, and the surviving member pods to
        requeue — all of them still exist (the node died, not the pods),
        so all of them go back to the queue."""
        with self._lock:
            rollbacks: List[Tuple[Pod, Pod]] = []
            requeue: List[Pod] = []
            for g in list(self._gangs.values()):
                if not any(n == node_name
                           for _, _, n, _ in g.waiting.values()):
                    continue
                now = self._clock.now()
                for pod, clone, _, since in g.waiting.values():
                    rollbacks.append((pod, clone))
                    requeue.append(pod)
                    if self.metrics is not None:
                        self.metrics.gang_permit_wait.observe(now - since)
                g.waiting.clear()
                g.first_wait = None
                if self.metrics is not None:
                    self.metrics.gangs_node_lost.inc()
                self._gc(g)  # clears dom_pin with the last reservation
            self._observe_pending()
            return rollbacks, requeue

    def reservations(self) -> List[Tuple[str, str, str]]:
        """(gang key, pod key, node name) for every live permit-gate
        reservation — the invariant checker sweeps these against the set
        of live, untainted nodes."""
        with self._lock:
            return [(g.key, key, node)
                    for g in self._gangs.values()
                    for key, (_p, _c, node, _t) in g.waiting.items()]

    def expire(self, now: float
               ) -> Tuple[List[Tuple[Pod, Pod]], List[Pod]]:
        """The permit-timeout sweep. Returns (rollbacks, requeue):
        `rollbacks` are (pod, assumed clone) reservations to forget from
        the cache — a timed-out gang's ENTIRE waiting set plus any orphaned
        reservations — and `requeue` the pods to put back in the queue.
        Also drops stale in-flight marks (a pod the commit path lost track
        of must not inflate the gang's member count forever)."""
        with self._lock:
            rollbacks = list(self._orphaned)
            self._orphaned = []
            requeue: List[Pod] = []
            for g in list(self._gangs.values()):
                for key, ts in list(g.inflight.items()):
                    if now - ts >= PARK_TIMEOUT:
                        del g.inflight[key]
                if g.first_wait is None or not g.waiting:
                    self._gc(g)
                    continue
                if now - g.first_wait < self._timeout(g.key):
                    continue
                for pod, clone, _, since in g.waiting.values():
                    rollbacks.append((pod, clone))
                    requeue.append(pod)
                    if self.metrics is not None:
                        self.metrics.gang_permit_wait.observe(now - since)
                g.waiting.clear()
                g.first_wait = None
                if self.metrics is not None:
                    self.metrics.gangs_timed_out.inc()
                self._gc(g)
            self._observe_pending()
            return rollbacks, requeue

    # ----------------------------------------------------- batch groups

    def batch_groups(self, pods: List[Pod]
                     ) -> Optional[List[Tuple[List[int], str, bool,
                                              Optional[str]]]]:
        """Partition one batch into placement units for the all-or-nothing
        kernel: each unit is (member indices, topology key, is_gang,
        pinned domain value), gangs in first-appearance order and every
        non-member a singleton unit. The pin is the label VALUE earlier
        batches' reservations already agreed on (None when free) — the
        kernel seeds its domain carry with it, so stragglers of a split
        gang can only place inside the slice the rest reserved. Returns
        None when the batch carries no gang members — the caller keeps
        the plain schedule_batch path."""
        units: List[Tuple[List[int], str, bool, Optional[str]]] = []
        by_group: Dict[str, int] = {}
        any_gang = False
        with self._lock:
            for i, pod in enumerate(pods):
                gkey = pod_group_key(pod)
                if gkey is None or self._spec(gkey) is None:
                    units.append(([i], "", False, None))
                    continue
                any_gang = True
                u = by_group.get(gkey)
                if u is None:
                    by_group[gkey] = len(units)
                    g = self._gangs.get(gkey)
                    units.append(([i], self.topology_key(gkey), True,
                                  g.dom_pin if g is not None else None))
                else:
                    units[u][0].append(i)
        return units if any_gang else None
