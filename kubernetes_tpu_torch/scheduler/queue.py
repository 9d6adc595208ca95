"""SchedulingQueue — activeQ / backoffQ / unschedulableQ.

Ref: pkg/scheduler/internal/queue/scheduling_queue.go (917 LoC) and
pod_backoff.go. Three sub-queues:
  - activeQ: heap ordered by (priority desc, enqueue-timestamp asc)
    (scheduling_queue.go:157-166)
  - podBackoffQ: heap by backoff expiry; exponential 1s -> 10s cap
    (pod_backoff.go)
  - unschedulableQ: map; flushed to active/backoff when >= 60s old or when a
    cluster event invalidates previous failures (MoveAllToActiveQueue)

The moveRequestCycle / schedulingCycle race repair (:126-133,294-325) is kept:
a pod that failed in a cycle started before the last move request goes to
backoff instead of unschedulable, because an event it never saw might have
made it schedulable.

The TPU extension over the reference is `pop_batch`: the batch collector
drains up to B pods in one call instead of Pop()ing one, preserving the heap's
priority-then-FIFO order — this is what feeds the pods-axis of the kernels.

Gang awareness (`self.gang`, a scheduler.gang.GangManager): a popped pod
whose PodGroup is below minMember is PARKED — it stays pending but leaves
the active heap, so a starved gang cannot head-of-line-block the singleton
pods behind it. The member arrival that completes the gang releases every
parked member inside the same add() critical section, so the next
pop_batch drains the whole gang as one batch. Parked members older than
the park timeout cycle through the unschedulable/backoff machinery (the
slow-path re-evaluation for PodGroups whose spec changed).

Release ordering contract: EVERY path that returns a held pod to the
active heap — backoff expiry, unschedulable flush, gang park release,
move-all events — re-sorts it by (priority, arrival) at release time
(`_push_active` recomputes the pod's CURRENT priority and keeps its
original arrival timestamp), so a released gang can never pop ahead of a
newer higher-priority singleton, and a priority raised while a pod was
held is honored the moment it re-enters the heap. The serving-mode
priority lane reads the same invariant: `lane_depth`/`top_priority` are
maintained per-priority counts of the live heap, so the drain can size an
express batch as exactly the high-priority cohort at the heap's top.
"""

from __future__ import annotations

import heapq
import itertools
import threading
from typing import Dict, List, Optional, Tuple

from ..api import helpers
from ..api.core import Pod
from ..api.scheduling import pod_group_key
from ..utils.clock import Clock, REAL_CLOCK
from .gang import ADMIT, PARK_QUOTA

DEFAULT_UNSCHEDULABLE_DURATION = 60.0  # unschedulableQTimeInterval (:49-51)
INITIAL_BACKOFF = 1.0                  # pod_backoff.go initialDuration
MAX_BACKOFF = 10.0                     # pod_backoff.go maxDuration


class PodBackoffMap:
    """Per-pod attempt counter -> exponential backoff (ref: pod_backoff.go)."""

    def __init__(self, clock: Clock):
        self._clock = clock
        self._attempts: Dict[str, int] = {}
        self._last_update: Dict[str, float] = {}

    def boost(self, key: str) -> None:
        self._attempts[key] = self._attempts.get(key, 0) + 1
        self._last_update[key] = self._clock.now()

    def backoff_time(self, key: str) -> float:
        """Absolute time the pod may be retried."""
        n = self._attempts.get(key, 0)
        if n == 0:
            return 0.0
        return self._last_update[key] + min(INITIAL_BACKOFF * 2 ** (n - 1), MAX_BACKOFF)

    def clear(self, key: str) -> None:
        self._attempts.pop(key, None)
        self._last_update.pop(key, None)


class _PodInfo:
    __slots__ = ("pod", "timestamp", "unsched_since")

    def __init__(self, pod: Pod, timestamp: float):
        self.pod = pod
        self.timestamp = timestamp
        #: when the pod entered unschedulableQ (None while elsewhere);
        #: the flush-leftover timer measures THIS stay, not queue age —
        #: keying it to the original enqueue time released long-queued
        #: pods instantly instead of parking them the full interval
        self.unsched_since: Optional[float] = None


class NominatedPodMap:
    """node name -> pods nominated to it by preemption
    (ref: scheduling_queue.go nominatedPodMap). Thread-safe: the informer
    thread mutates it while the scheduling thread reads it to build the
    kernel's reservation tensors; `version` lets readers cache by change."""

    def __init__(self):
        self._lock = threading.Lock()
        self._by_node: Dict[str, List[Pod]] = {}
        self._node_of: Dict[str, str] = {}
        self.version = 0

    def add(self, pod: Pod, node_name: str = "") -> None:
        with self._lock:
            self._delete_locked(pod)
            nn = node_name or pod.status.nominated_node_name
            if not nn:
                return
            self._node_of[pod.metadata.key()] = nn
            self._by_node.setdefault(nn, []).append(pod)
            self.version += 1

    def delete(self, pod: Pod) -> None:
        with self._lock:
            self._delete_locked(pod)

    def _delete_locked(self, pod: Pod) -> None:
        key = pod.metadata.key()
        nn = self._node_of.pop(key, None)
        if nn is None:
            return
        pods = self._by_node.get(nn, [])
        self._by_node[nn] = [p for p in pods if p.metadata.key() != key]
        if not self._by_node[nn]:
            del self._by_node[nn]
        self.version += 1

    def pods_for_node(self, node_name: str) -> List[Pod]:
        with self._lock:
            return list(self._by_node.get(node_name, ()))

    def node_for(self, pod_key: str) -> Optional[str]:
        with self._lock:
            return self._node_of.get(pod_key)

    def by_node(self) -> Dict[str, List[Pod]]:
        with self._lock:
            return {n: list(ps) for n, ps in self._by_node.items()}


class SchedulingQueue:
    """The PriorityQueue (ref: scheduling_queue.go:106-138)."""

    def __init__(self, clock: Clock = REAL_CLOCK):
        self._clock = clock
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._seq = itertools.count()  # FIFO tiebreak within equal priority
        # activeQ heap entries: (-priority, timestamp, seq, key)
        self._active: List[Tuple[int, float, int, str]] = []
        # backoffQ heap entries: (expiry, seq, key)
        self._backoff: List[Tuple[float, int, str]] = []
        self._unschedulable: Dict[str, _PodInfo] = {}
        self._pod_info: Dict[str, _PodInfo] = {}
        self._in_active: set = set()
        # key -> the one live heap entry; a priority update re-pushes and
        # repoints this, turning the old tuple into a skipped stale entry
        # (ref: activeQ.Update reorders the heap, scheduling_queue.go:268)
        self._active_entry: Dict[str, Tuple[int, float, int, str]] = {}
        #: live-heap census by priority (stale heap entries excluded):
        #: the serving drain reads it to size priority-lane batches
        self._prio_counts: Dict[int, int] = {}
        self._in_backoff: set = set()
        #: gang-parked pods: pending (in _pod_info) but held off the active
        #: heap until their PodGroup reaches minMember (scheduler/gang.py)
        self._parked: Dict[str, _PodInfo] = {}
        #: GangManager, installed by the scheduler shell; None = no gating
        self.gang = None
        #: observability hooks, installed by the scheduler shell: span
        #: tracer (admit/park/backoff/unschedulable pod milestones), the
        #: per-pod last-failure attribution store, and the park-cause
        #: tally counter (scheduler_unschedulable_reasons_total)
        self.tracer = None
        self.attribution = None
        self.unsched_reasons = None
        self.backoff_map = PodBackoffMap(clock)
        self.nominated = NominatedPodMap()
        self._scheduling_cycle = 0
        self._move_request_cycle = -1
        #: last clock instant the lazy flush ran (see _flush_locked)
        self._last_flush_now: Optional[float] = None
        self._closed = False

    # ----------------------------------------------------------- feeding

    def add(self, pod: Pod) -> None:
        with self._cond:
            key = pod.metadata.key()
            info = _PodInfo(pod, self._clock.now())
            self._pod_info[key] = info
            self._unschedulable.pop(key, None)
            self._in_backoff.discard(key)
            self._parked.pop(key, None)
            self._push_active(key, info)
            self.nominated.add(pod)
            self._gang_notify_locked(pod)
            if self.tracer is not None:
                self.tracer.pod_event("queue", "admit", pod)
            self._cond.notify_all()

    def _gang_notify_locked(self, pod: Pod) -> None:
        """Register a (re)pending pod with the gang manager; an arrival
        that completes its gang releases the parked members right here, so
        the whole gang is poppable before the lock drops."""
        if self.gang is None:
            return
        for rkey in self.gang.pod_pending(pod):
            parked = self._parked.pop(rkey, None)
            if parked is not None:
                self._push_active(rkey, parked)

    def gang_group_changed(self, group_key: str) -> None:
        """A PodGroup appeared or its spec changed: reactivate any parked
        members its (new) minMember now admits."""
        with self._cond:
            if self.gang is None:
                return
            released = self.gang.group_changed(group_key)
            for rkey in released:
                parked = self._parked.pop(rkey, None)
                if parked is not None:
                    self._push_active(rkey, parked)
            if released:
                self._cond.notify_all()

    def update(self, old: Optional[Pod], new: Pod) -> None:
        with self._cond:
            key = new.metadata.key()
            info = self._pod_info.get(key)
            if info is not None:
                old_prio = helpers.pod_priority(info.pod)
                prev_pod = info.pod
                info.pod = new
                self.nominated.add(new)
                if self.gang is not None and \
                        pod_group_key(prev_pod) != pod_group_key(new):
                    # re-labeled into a different (or no) gang: purge the
                    # old membership — its key would otherwise inflate the
                    # old gang's member count forever — and reactivate a
                    # parked pod so the pop gate re-evaluates it fresh
                    self.gang.pod_gone(prev_pod)
                    parked = self._parked.pop(key, None)
                    if parked is not None:
                        self._push_active(key, parked)
                    self._gang_notify_locked(new)
                    self._cond.notify_all()
                if key in self._unschedulable and _spec_changed(old, new):
                    # updated pods get another chance immediately (:268-292)
                    del self._unschedulable[key]
                    self._push_active(key, info)
                    self._cond.notify_all()
                elif key in self._in_active and \
                        helpers.pod_priority(new) != old_prio:
                    # re-heapify: stale entry is invalidated by repointing
                    # _active_entry (ref: activeQ.Update reorders the heap)
                    self._drop_active(key)
                    self._push_active(key, info)
                    self._cond.notify_all()
            else:
                self.add(new)

    def delete(self, pod: Pod) -> None:
        with self._cond:
            key = pod.metadata.key()
            self._pod_info.pop(key, None)
            self._unschedulable.pop(key, None)
            self._drop_active(key)
            self._in_backoff.discard(key)
            self._parked.pop(key, None)
            if self.gang is not None:
                self.gang.pod_gone(pod)
            self.nominated.delete(pod)
            self.backoff_map.clear(key)
            if self.attribution is not None:
                self.attribution.discard(key)

    def _push_active(self, key: str, info: _PodInfo) -> None:
        """(Re)enter the active heap sorted by (priority, arrival): the
        pod's CURRENT priority is read here — at release time, for held
        pods — and its arrival timestamp is preserved, so backoff/park
        release can never order a stale cohort ahead of a newer
        higher-priority pod."""
        if key in self._in_active:
            return
        info.unsched_since = None
        prio = helpers.pod_priority(info.pod)
        entry = (-prio, info.timestamp, next(self._seq), key)
        heapq.heappush(self._active, entry)
        self._active_entry[key] = entry
        self._in_active.add(key)
        self._prio_counts[prio] = self._prio_counts.get(prio, 0) + 1

    def _drop_active(self, key: str) -> None:
        """Remove a pod from the live-heap census; its heap entry goes
        stale (skipped at pop by the _active_entry identity check)."""
        if key not in self._in_active:
            return
        self._in_active.discard(key)
        entry = self._active_entry.pop(key, None)
        if entry is not None:
            prio = -entry[0]
            n = self._prio_counts.get(prio, 0) - 1
            if n > 0:
                self._prio_counts[prio] = n
            else:
                self._prio_counts.pop(prio, None)

    # ----------------------------------------------------------- popping

    @property
    def scheduling_cycle(self) -> int:
        with self._lock:
            return self._scheduling_cycle

    def pop(self, timeout: Optional[float] = None) -> Optional[Pod]:
        pods = self.pop_batch(1, timeout=timeout)
        return pods[0] if pods else None

    def pop_batch(self, max_pods: int, timeout: Optional[float] = None,
                  on_pop=None) -> List[Pod]:
        """Drain up to max_pods from activeQ in priority-then-FIFO order.
        Blocks until at least one pod is available (or timeout/close). Each
        call is one scheduling cycle (the whole batch shares it).

        on_pop(n) runs under the queue lock before the pods are returned, so
        a caller can record them as in-flight atomically with their removal
        from the pending set (idle detection would otherwise see a window
        where popped pods are neither pending nor in-flight)."""
        deadline = None if timeout is None else self._clock.now() + timeout
        with self._cond:
            while True:
                self._flush_locked()
                if self._active or self._closed:
                    break
                wait = 0.05
                if deadline is not None:
                    remaining = deadline - self._clock.now()
                    if remaining <= 0:
                        return []
                    wait = min(wait, remaining)
                self._cond.wait(wait)
            if self._closed and not self._active:
                return []
            self._scheduling_cycle += 1
            out: List[Pod] = []
            while self._active and len(out) < max_pods:
                entry = heapq.heappop(self._active)
                key = entry[3]
                if key not in self._in_active or \
                        self._active_entry.get(key) is not entry:
                    continue  # stale entry (pod deleted or re-prioritized)
                self._drop_active(key)
                info = self._pod_info.get(key)
                if info is None:
                    continue
                if info.pod.metadata.deletion_timestamp is not None:
                    # deleting pods never schedule (ref: scheduleOne skips
                    # pods with a DeletionTimestamp, scheduler.go:445-455)
                    del self._pod_info[key]
                    self.backoff_map.clear(key)
                    self.nominated.delete(info.pod)
                    continue
                verdict = ADMIT if self.gang is None \
                    else self.gang.pop_gate(info.pod)
                if verdict != ADMIT:
                    # gang member held OUT of the heap but kept pending;
                    # a completing arrival, PodGroup change, or freed
                    # quota slot reactivates it. The pods behind it keep
                    # popping — no head-of-line blocking. A quota park
                    # gets its own attribution naming the blocking quota
                    # so it never reads as a scheduler failure.
                    self._parked[key] = info
                    if self.tracer is not None:
                        self.tracer.pod_event("queue", "park", info.pod)
                    if verdict == PARK_QUOTA:
                        block = self.gang.quota_block_for(info.pod)
                        reason = "QuotaExhausted"
                        msg = block.message(pod_group_key(info.pod)) \
                            if block is not None else \
                            f"gang {pod_group_key(info.pod)} parked: " \
                            f"active-gang quota exhausted"
                    else:
                        reason = "PodGroupNotReady"
                        msg = (f"gang {pod_group_key(info.pod)} below "
                               f"minMember; parked off the active heap")
                    if self.unsched_reasons is not None:
                        self.unsched_reasons.inc(reason=reason)
                    if self.attribution is not None:
                        self.attribution.record(
                            key, reason, msg,
                            cycle=self._scheduling_cycle)
                    continue
                # popped pods leave the pending set; a failed attempt re-adds
                # them via add_unschedulable_if_not_present (ref: Pop removes
                # from activeQ; in-flight pods live only in the cycle)
                del self._pod_info[key]
                out.append(info.pod)
            if on_pop is not None and out:
                on_pop(len(out))
            return out

    # ------------------------------------------------- failure / requeue

    def add_unschedulable_if_not_present(self, pod: Pod, pod_scheduling_cycle: int
                                         ) -> None:
        """Ref: AddUnschedulableIfNotPresent (:294-325). If a move request
        arrived during this pod's cycle, it goes to backoff (retry soon) rather
        than parking in unschedulableQ."""
        with self._cond:
            key = pod.metadata.key()
            if key in self._in_active or key in self._in_backoff:
                return
            info = self._pod_info.get(key)
            if info is None:
                info = _PodInfo(pod, self._clock.now())
                self._pod_info[key] = info
            info.pod = pod
            self.backoff_map.boost(key)
            self.nominated.add(pod)
            if self._move_request_cycle >= pod_scheduling_cycle:
                self._push_backoff(key)
                if self.tracer is not None:
                    self.tracer.pod_event("queue", "backoff", pod)
            else:
                info.unsched_since = self._clock.now()
                self._unschedulable[key] = info
                if self.tracer is not None:
                    self.tracer.pod_event("queue", "unschedulable", pod)
            self._gang_notify_locked(pod)
            self._cond.notify_all()

    def _push_backoff(self, key: str) -> None:
        expiry = self.backoff_map.backoff_time(key)
        heapq.heappush(self._backoff, (expiry, next(self._seq), key))
        self._in_backoff.add(key)

    def move_all_to_active_queue(self) -> None:
        """A cluster event may have made unschedulable pods schedulable
        (ref: MoveAllToActiveQueue — still-in-backoff pods go to backoffQ)."""
        with self._cond:
            for key, info in list(self._unschedulable.items()):
                if self.backoff_map.backoff_time(key) > self._clock.now():
                    self._push_backoff(key)
                else:
                    self._push_active(key, info)
            self._unschedulable.clear()
            self._move_request_cycle = self._scheduling_cycle
            self._cond.notify_all()

    def assigned_pod_updated(self, pod: Pod) -> None:
        """An assigned pod changed; pods with affinity may now fit
        (ref: movePodsToActiveQueue on AssignedPodAdded/Updated)."""
        self.move_all_to_active_queue()

    def _flush_locked(self) -> None:
        """flushBackoffQCompleted (1s ticker) + flushUnschedulableQLeftover
        (30s ticker) collapsed into lazy flushing at pop time. Idempotent
        per clock instant: every hold created at time T expires strictly
        after T (backoff >= +1s, unschedulable +60s, park +PARK_TIMEOUT),
        so a repeat flush at the same `now` can release nothing — skipped,
        which spares the adaptive drain's drain_stats+pop_batch pair the
        second O(unschedulable) scan per cycle."""
        now = self._clock.now()
        if now == self._last_flush_now:
            return
        self._last_flush_now = now
        while self._backoff and self._backoff[0][0] <= now:
            _, _, key = heapq.heappop(self._backoff)
            if key not in self._in_backoff:
                continue
            self._in_backoff.discard(key)
            info = self._pod_info.get(key)
            if info is not None:
                self._push_active(key, info)
        for key, info in list(self._unschedulable.items()):
            since = info.unsched_since if info.unsched_since is not None \
                else info.timestamp
            if now - since >= DEFAULT_UNSCHEDULABLE_DURATION:
                del self._unschedulable[key]
                if self.backoff_map.backoff_time(key) > now:
                    self._push_backoff(key)
                else:
                    self._push_active(key, info)
        if self.gang is not None and self._parked:
            # quota fast path: an active-gang slot freed since the last
            # flush reactivates quota-parked gangs immediately (pop_gate
            # re-checks the quota, so an unlucky gang just re-parks)
            for key in self.gang.quota_released():
                info = self._parked.pop(key, None)
                if info is not None:
                    self._push_active(key, info)
            # starved gang slow path: long-parked members cycle through the
            # standard backoff machinery (boosted, so repeats decay) and
            # re-park on pop if their gang is still short
            for key in self.gang.expired_parked(now):
                info = self._parked.pop(key, None)
                if info is not None:
                    self.backoff_map.boost(key)
                    self._push_backoff(key)

    # ----------------------------------------------------------- admin

    def pending_pods(self) -> List[Pod]:
        with self._lock:
            return [i.pod for i in self._pod_info.values()]

    def num_pending(self) -> int:
        with self._lock:
            return len(self._pod_info)

    # ------------------------------------------------ lane introspection

    def active_depth(self) -> int:
        """Pods poppable RIGHT NOW (expired backoff/unschedulable holds
        are flushed first) — the queue-depth signal the serving drain's
        adaptive batch sizing reads."""
        with self._lock:
            self._flush_locked()
            return len(self._in_active)

    def lane_depth(self, min_priority: int) -> int:
        """How many poppable pods sit at/above `min_priority` — the
        express-lane cohort size. They are by construction the heap's
        top, so a pop of at least this many always drains the whole
        lane first (a cap floored above the cohort pops bulk pods
        behind it in the same batch)."""
        with self._lock:
            self._flush_locked()
            return sum(n for p, n in self._prio_counts.items()
                       if p >= min_priority)

    def drain_stats(self, min_priority: int) -> Tuple[int, int]:
        """(active_depth, lane_depth) under ONE lock with ONE lazy
        flush — the adaptive drain reads both every cycle, and separate
        calls would repeat the O(unschedulable) flush scan on the hot
        path."""
        with self._lock:
            self._flush_locked()
            lane = sum(n for p, n in self._prio_counts.items()
                       if p >= min_priority)
            return len(self._in_active), lane

    def top_priority(self) -> Optional[int]:
        """Highest priority among poppable pods (None when idle)."""
        with self._lock:
            self._flush_locked()
            return max(self._prio_counts) if self._prio_counts else None

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()


def _spec_changed(old: Optional[Pod], new: Pod) -> bool:
    if old is None:
        return True
    return (old.spec != new.spec or
            old.metadata.labels != new.metadata.labels or
            old.status.nominated_node_name != new.status.nominated_node_name)
