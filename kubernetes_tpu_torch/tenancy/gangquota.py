"""Per-namespace gang quota — whole PodGroups admitted or parked as units.

ResourceQuota's ``count/podgroups`` caps how many PodGroup OBJECTS a
namespace may create; it says nothing about how many gangs may be
in flight at once, and a tenant that creates its gangs early can still
interleave-starve everyone else at the scheduling queue. This gate
enforces the hard key ``scheduling.ktpu/active-gangs`` at the queue's
pop gate instead: an admissible gang (minMember reached) additionally
needs an active-gang slot in its namespace before its members may leave
the parked state. A gang denied a slot parks with its OWN attribution
reason (``QuotaExhausted``) so it never reads as a scheduler failure,
and the slot is returned when the gang's last member leaves the
manager's books (bound members terminal, pods deleted, or the gang
rolled back).

The gate is consulted UNDER the gang manager's lock (queue-lock ->
manager-lock is the documented order; the gate takes no lock of its
own beyond its internal one and never calls back into either).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Set

from ..utils.errlog import SwallowedErrors

#: ResourceQuota hard key the gate enforces
ACTIVE_GANGS_KEY = "scheduling.ktpu/active-gangs"


@dataclass
class QuotaBlock:
    """Why a gang is parked: the blocking quota, named."""
    namespace: str
    resource: str
    quota: str
    used: int
    hard: int

    def reason(self) -> str:
        return "QuotaExhausted"

    def message(self, gkey: str) -> str:
        return (f"gang {gkey} parked: namespace '{self.namespace}' "
                f"{self.resource} quota exhausted "
                f"({self.used}/{self.hard} via quota "
                f"'{self.quota}')")


class GangQuotaGate:
    """Tracks active (admitted, not yet finished) gangs per namespace
    against the tightest ``scheduling.ktpu/active-gangs`` hard cap.

    ``quota_lister()`` returns the live ResourceQuota objects (an
    informer indexer list or a client list); namespaces carrying no
    such hard key are unlimited — the gate no-ops for them, the same
    contract the admission plugins keep for quota-less namespaces.
    """

    def __init__(self, quota_lister: Callable[[], list],
                 metrics=None):
        self._lister = quota_lister
        self.metrics = metrics
        self._swallowed = SwallowedErrors("gangquota")
        self._lock = threading.Lock()
        #: namespace -> active gang keys holding a slot
        self._active: Dict[str, Set[str]] = {}
        #: gang key -> namespace (release without re-parsing)
        self._held: Dict[str, str] = {}

    # ----------------------------------------------------------- limits

    def _limit(self, ns: str) -> Optional[tuple]:
        """(limit, quota name) — the tightest active-gangs cap in `ns`,
        or None when unlimited."""
        best = None
        try:
            quotas = self._lister()
            self._swallowed.ok("list_quotas")
        except Exception as e:
            # listing failed: fail open, admission still caps
            self._swallowed.swallow("list_quotas", e)
            return None
        for q in quotas:
            if q.metadata.namespace != ns:
                continue
            cap = q.spec.hard.get(ACTIVE_GANGS_KEY)
            if cap is None:
                continue
            val = int(float(str(cap)))
            if best is None or val < best[0]:
                best = (val, q.metadata.name)
        return best

    # ------------------------------------------------------ gate verbs

    def try_admit(self, gkey: str) -> Optional[QuotaBlock]:
        """Claim an active-gang slot for `gkey` (idempotent while
        held). None = admitted; a QuotaBlock = parked, with the
        blocking quota named."""
        ns, _, _ = gkey.partition("/")
        with self._lock:
            if gkey in self._held:
                return None
            lim = self._limit(ns)
            if lim is None:
                self._active.setdefault(ns, set()).add(gkey)
                self._held[gkey] = ns
                return None
            limit, qname = lim
            active = self._active.setdefault(ns, set())
            if len(active) >= limit:
                if self.metrics is not None:
                    self.metrics.gang_quota_parked.inc(namespace=ns)
                return QuotaBlock(namespace=ns,
                                  resource=ACTIVE_GANGS_KEY,
                                  quota=qname, used=len(active),
                                  hard=limit)
            active.add(gkey)
            self._held[gkey] = ns
            if self.metrics is not None:
                self.metrics.gang_quota_admitted.inc(namespace=ns)
            return None

    def release(self, gkey: str) -> bool:
        """Return `gkey`'s slot (no-op when it holds none). True when a
        slot was actually freed — the caller's cue to re-evaluate
        quota-parked gangs."""
        with self._lock:
            ns = self._held.pop(gkey, None)
            if ns is None:
                return False
            active = self._active.get(ns)
            if active is not None:
                active.discard(gkey)
                if not active:
                    del self._active[ns]
            return True

    def holds(self, gkey: str) -> bool:
        with self._lock:
            return gkey in self._held

    # -------------------------------------------------------- reporting

    def report(self) -> Dict[str, dict]:
        """Per-namespace active counts + the cap (for /debug/pending's
        quota headroom section)."""
        with self._lock:
            namespaces = sorted(set(self._active) | {
                q.metadata.namespace
                for q in self._safe_list()
                if ACTIVE_GANGS_KEY in q.spec.hard})
            out: Dict[str, dict] = {}
            for ns in namespaces:
                lim = self._limit(ns)
                active = sorted(self._active.get(ns, ()))
                out[ns] = {
                    "active": len(active),
                    "gangs": active,
                    "limit": lim[0] if lim is not None else None,
                    "quota": lim[1] if lim is not None else None,
                }
            return out

    def _safe_list(self) -> List:
        try:
            out = list(self._lister())
            self._swallowed.ok("list_quotas")
            return out
        except Exception as e:
            self._swallowed.swallow("list_quotas", e)
            return []
