"""Cache debugger — dump, cache-vs-informer comparer, and unschedulable
attribution.

Ref: pkg/scheduler/internal/cache/debugger (CacheComparer compares the
scheduler cache's nodes/pods against the informer's truth; CacheDumper
writes a snapshot of cached state + the pending queue on SIGUSR2). The
comparer is the structural race-detection defense: a divergence means an
event was dropped or double-applied somewhere between informer and cache.

`UnschedulableAttribution` is the per-pod half of "why is my pod
pending": the drain records each pod's LAST failure (top predicate
reason + the full FitError rendering, or the queue's park cause) and
`pending_report` joins it against the live pending set — the payload the
APIServer's /debug/pending endpoint serves.
"""

from __future__ import annotations

import signal
import sys
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..utils.clock import Clock, REAL_CLOCK


class UnschedulableAttribution:
    """Bounded per-pod last-failure records (insertion-ordered LRU —
    oldest evicts; a re-record moves the pod to the fresh end)."""

    MAX_RECORDS = 8192

    def __init__(self, clock: Clock = REAL_CLOCK,
                 max_records: int = MAX_RECORDS):
        self.clock = clock
        self.max_records = max_records
        self._lock = threading.Lock()
        self._records: Dict[str, dict] = {}

    def record(self, key: str, reason: str, message: str,
               cycle: int = 0) -> None:
        with self._lock:
            prev = self._records.pop(key, None)
            count = prev["count"] + 1 \
                if prev is not None and prev["reason"] == reason else 1
            self._records[key] = {
                "reason": reason, "message": message, "cycle": cycle,
                "time": self.clock.now(), "count": count}
            while len(self._records) > self.max_records:
                self._records.pop(next(iter(self._records)))

    def discard(self, key: str) -> None:
        """Cheap on the bind hot path: no lock taken while empty."""
        if not self._records:
            return
        with self._lock:
            self._records.pop(key, None)

    def get(self, key: str) -> Optional[dict]:
        with self._lock:
            rec = self._records.get(key)
            return dict(rec) if rec is not None else None

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            return {k: dict(v) for k, v in self._records.items()}

    def __len__(self) -> int:
        return len(self._records)


@dataclass
class ComparisonResult:
    missing_pods: List[str] = field(default_factory=list)    # informer only
    redundant_pods: List[str] = field(default_factory=list)  # cache only
    missing_nodes: List[str] = field(default_factory=list)
    redundant_nodes: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not (self.missing_pods or self.redundant_pods
                    or self.missing_nodes or self.redundant_nodes)


class CacheDebugger:
    def __init__(self, scheduler):
        self.scheduler = scheduler

    def compare(self) -> ComparisonResult:
        """Ref: debugger/comparer.go CompareNodes/ComparePods. Assumed pods
        are cache-only BY DESIGN (in-flight binds) and excluded."""
        from ..api.core import Node, Pod
        sched = self.scheduler
        res = ComparisonResult()
        informer_nodes = {n.metadata.name for n in
                          sched.informers.informer_for(Node).indexer.list()}
        cache_nodes = set(sched.cache.node_names())
        res.missing_nodes = sorted(informer_nodes - cache_nodes)
        res.redundant_nodes = sorted(cache_nodes - informer_nodes)
        from ..api import helpers
        informer_pods = {p.metadata.key() for p in
                         sched.informers.informer_for(Pod).indexer.list()
                         if p.spec.node_name
                         and not helpers.pod_is_terminal(p)}
        cache_pods, assumed = sched.cache.pod_keys_snapshot()
        res.missing_pods = sorted(informer_pods - cache_pods - assumed)
        res.redundant_pods = sorted(cache_pods - informer_pods)
        return res

    def dump(self) -> str:
        """Ref: debugger/dumper.go — cached nodes with usage, assumed pods,
        pending queue (with each pod's last-failure attribution)."""
        sched = self.scheduler
        lines = ["Dump of cached NodeInfo:"]
        # snapshot the dict: a SIGUSR2 handler races the scheduler thread's
        # update_snapshot, and a mid-iteration resize would raise INTO
        # whatever main-thread code the signal interrupted
        infos = dict(sched.algorithm.snapshot.node_infos)
        for name, ni in sorted(infos.items()):
            lines.append(
                f"  {name}: pods={len(ni.pods)} "
                f"cpu={ni.requested.milli_cpu}/{ni.allocatable.milli_cpu}m "
                f"mem={ni.requested.memory}/{ni.allocatable.memory}")
        lines.append("Dump of scheduling queue:")
        attribution = getattr(sched, "attribution", None)
        for pod in sched.queue.pending_pods():
            key = pod.metadata.key()
            rec = attribution.get(key) if attribution is not None else None
            if rec is not None:
                lines.append(f"  {key} ({rec['reason']} x{rec['count']})")
            else:
                lines.append(f"  {key}")
        return "\n".join(lines)

    def pending_report(self, limit: int = 500) -> dict:
        """Why each pending pod is pending — the /debug/pending payload:
        the live pending set (sorted by key) joined with the last-failure
        attribution the drain recorded. A pod with no record yet simply
        hasn't completed a failed attempt (freshly arrived, or mid-batch).
        """
        sched = self.scheduler
        pods = sorted(sched.queue.pending_pods(),
                      key=lambda p: p.metadata.key())
        attribution = getattr(sched, "attribution", None)
        out = []
        for pod in pods[:limit]:
            key = pod.metadata.key()
            rec = attribution.get(key) if attribution is not None else None
            entry = {"pod": key, "uid": pod.metadata.uid,
                     "reason": rec["reason"] if rec else "NotYetAttempted",
                     "message": rec["message"] if rec else "",
                     "attempts": rec["count"] if rec else 0,
                     "lastCycle": rec["cycle"] if rec else None,
                     "lastFailureTime": rec["time"] if rec else None}
            out.append(entry)
        report = {"component": sched.scheduler_name,
                  "pending": len(pods),
                  "truncated": max(0, len(pods) - limit),
                  "pods": out}
        # parked-gang demand shapes (minMember x member request x ICI
        # domain): the signal the autoscaler consumes, surfaced here so
        # "why is my slice pending" is answerable next to the per-pod
        # attribution
        gang = getattr(sched, "gang", None)
        if gang is not None:
            report["gangDemand"] = [
                {k: v for k, v in s.items() if k != "members"}
                for s in gang.demand_shapes()]
        # tenancy: per-namespace quota headroom (which cap is binding),
        # the gang-quota gate's active/parked view, and each tenant's DRF
        # dominant share — together the full "why is my tenant throttled"
        # answer in one payload
        self._tenancy_report(report)
        return report

    def _tenancy_report(self, report: dict) -> None:
        sched = self.scheduler
        try:
            from ..api.core import ResourceQuota
            quotas = sched.informers.informer_for(
                ResourceQuota).indexer.list()
        except Exception:
            quotas = []
        if quotas:
            raise NotImplementedError(
                "pending_report: the quota headroom of ResourceQuotas needs "
                "tenancy/quota.py, which is not ported yet (ROADMAP: "
                "harnesses and commands)")
        gate = getattr(sched, "gang_quota", None)
        if gate is not None:
            gq = gate.report()
            if gq:
                report["gangQuota"] = gq
        drf = getattr(sched, "drf", None)
        if drf is not None:
            rep = drf.report()
            if rep.get("tenants"):
                report["drf"] = rep

    def install(self, signum: int = signal.SIGUSR2) -> None:
        """SIGUSR2 -> dump + comparison to stderr (ref: debugger.go
        ListenForSignal)."""
        def handler(_sig, _frame):
            print(self.dump(), file=sys.stderr)
            cmp = self.compare()
            if not cmp.ok:
                print(f"cache comparison FAILED: {cmp}", file=sys.stderr)
        signal.signal(signum, handler)


