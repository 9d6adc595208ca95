"""Incremental topology-bucket index for inter-pod (anti-)affinity.

The M3 component of the north-star redesign (SURVEY §7.4). The reference
rebuilds its `topologyPairsMaps` from scratch for EVERY pod in EVERY
scheduling cycle by scanning every pod on every node
(pkg/scheduler/algorithm/predicates/metadata.go:71-94 — O(nodes × pods ×
terms) per attempt, the cost the 16-way ParallelizeUntil fan-out exists to
hide). Here the same maps are maintained INCREMENTALLY from the scheduler
cache's dirty-node feed (the same O(Δ) generation scan that drives the
tensor mirror) as sparse (term × topology-domain) count matrices:

    term      = interned (namespaces, selector, topologyKey) — the unit the
                reference re-derives per pod; pods stamped from one
                controller template share every term
    domain    = interned (topologyKey, value) bucket — "zone-3",
                "host node-17" (ref: the (topologyKey, value) pairs of
                topologyPairsMaps)
    counts    = #pods matching a term per domain (match side) and
                #pods carrying a term per domain (carry side, weighted for
                preferred terms)

A batch then evaluates required (anti-)affinity for ALL its constraint
templates at once: per-term count vectors are gathered over the node→domain
arrays into [T, N] presence matrices and combined per template — on host
numpy for small T, or as masked matmuls on device
(kernels/affinity.py) when templates × nodes is large. Either way the
per-batch cost is O(T·N) array work instead of O(templates × nodes × pods)
python, and the cluster-wide scan is gone entirely.

Semantics parity: predicates.match_inter_pod_affinity /
priorities.interpod_affinity_scores over a fresh PredicateMetadata are the
oracle; tests/test_topology.py fuzzes this module against them.

Port copy of kubernetes_tpu/scheduler/topology.py: the host side is
unchanged, and the template evaluation's device route runs kernel K13
(kernels/affinity.py) on the index's mirror device. Only the sharded
term table (term_table_device) still raises NotImplementedError, until
the sharded scan is ported.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ..api import labels as labelsmod
from ..api.core import Pod
from ..api.meta import LabelSelector

# count matrices maintained per term (carry side: pods CARRYING the term;
# match side: pods MATCHED by the term)
K_MATCH = "match"            # match counts (required + preferred, own terms)
K_CARRY_ANTI = "carry_anti"  # pods carrying the term as required anti-affinity
K_CARRY_AFF = "carry_aff"    # ... as required affinity (symmetric hard credit)
K_CARRY_PAFF = "carry_paff"  # preferred affinity, weight-summed
K_CARRY_PANTI = "carry_panti"  # preferred anti-affinity, weight-summed

#: route template evaluation through the device kernel (K13) at or above
#: this many (templates × terms × nodes). The reference's constant, kept so
#: that a batch takes the same route in both packages; where the crossover
#: lies on the GPU is not measured yet
DEVICE_EVAL_THRESHOLD = 2_000_000_000


class _Term:
    """One interned (namespaces, selector, topologyKey) term."""

    __slots__ = ("tid", "tk", "namespaces", "selector", "match_registered")

    def __init__(self, tid: int, tk: str, namespaces: Tuple[str, ...],
                 selector: Optional[LabelSelector]):
        self.tid = tid
        self.tk = tk
        self.namespaces = namespaces
        self.selector = selector
        #: match counts are maintained only after a query-side registration
        #: (ensure_match backfills, then the incremental feed keeps it fresh)
        self.match_registered = False

    def matches_pod(self, pod: Pod) -> bool:
        return pod.metadata.namespace in self.namespaces and \
            labelsmod.matches(self.selector, pod.metadata.labels)


class _NodeRec:
    """Per-node bookkeeping for incremental updates."""

    __slots__ = ("labels", "pods", "contrib")

    def __init__(self, labels: Dict[str, str]):
        self.labels = labels
        # pod key -> (resourceVersion fingerprint, pod ref)
        self.pods: Dict[str, Tuple[str, Pod]] = {}
        # pod key -> [(kind, tid, dom, weight)] — exactly what was added to
        # the count matrices for this pod, so removal is an exact inverse
        self.contrib: Dict[str, List[Tuple[str, int, int, float]]] = {}


class AffinityProfile:
    """One constraint template's resolved terms (the batch-evaluation unit;
    pods sharing a residual signature share the profile)."""

    __slots__ = ("req_aff", "req_anti", "carried_anti", "constrained")

    def __init__(self):
        self.req_aff: List[Tuple[int, bool]] = []   # (tid, waived)
        self.req_anti: List[int] = []
        self.carried_anti: List[int] = []           # carry-side tids matching the pod
        self.constrained = False


class TopologyIndex:
    def __init__(self, mirror):
        self.mirror = mirror  # row_of / capacity alignment for [N] vectors
        self._terms: Dict[Tuple, _Term] = {}
        self._by_id: List[_Term] = []
        # tk -> (value -> per-tk domain id); doms never shrink
        self._doms: Dict[str, Dict[str, int]] = {}
        # tk -> [capacity] int32 node-row -> dom id (-1 = label absent)
        self._node_dom: Dict[str, np.ndarray] = {}
        # kind -> tid -> (dom -> count/weight)
        self._counts: Dict[str, Dict[int, Dict[int, float]]] = {
            K_MATCH: {}, K_CARRY_ANTI: {}, K_CARRY_AFF: {},
            K_CARRY_PAFF: {}, K_CARRY_PANTI: {}}
        self._nodes: Dict[str, _NodeRec] = {}
        #: bumped on every mutating apply; invalidates materialized vectors
        self.version = 0
        #: bumped only when a node->domain mapping changes (node add /
        #: relabel / row reuse, new domain value, new topology key) — the
        #: invalidation key for cached [T, N] term tables, which pod-only
        #: churn (the steady-state batch stream) never touches
        self.dom_epoch = 0
        #: bumped only on profile-relevant transitions: a new registered
        #: term, a match total crossing zero (waived bits), or the set of
        #: ACTIVE required-anti carry terms changing (carried_anti lists).
        #: Per-pod count increments beyond the first never bump it, so
        #: template profiles cache across a whole drain
        self.profile_epoch = 0
        #: registered-term match totals, maintained incrementally for the
        #: zero-crossing detection above
        self._match_total: Dict[int, float] = {}
        self._anti_active: Set[int] = set()
        #: term-id tuple -> (dom_epoch, capacity, [T, N] dom table, n_doms)
        self._table_cache: Dict[Tuple, Tuple[int, int, np.ndarray, int]] = {}
        self.table_builds = 0
        self.table_hits = 0
        #: (term-id tuple, padded T) -> (dom_epoch, capacity, device
        #: table sharded by the name rules, n_doms) — the sharded drain's
        #: upload cache: repeat batches over a stable node topology reuse
        #: ONE device-resident [T, N] table instead of re-uploading per
        #: batch (term_table_device)
        self._table_dev_cache: Dict[Tuple, Tuple[int, int, object, int]] = {}
        self.table_dev_builds = 0
        self.table_dev_hits = 0
        self._vec_cache: Dict[Tuple, np.ndarray] = {}
        self._vec_cache_version = -1
        #: (kind, tid) -> [capacity] bool "some pod of `kind` sits in this
        #: node's domain" — the required_masks building block, maintained
        #: INCREMENTALLY from (term, domain) count zero-crossings instead
        #: of being regathered from count vectors every batch. Pod churn
        #: that only moves a count between two positive values touches
        #: nothing; a 0<->positive crossing rewrites the crossing domain's
        #: rows of the one affected vector. Node-topology changes
        #: (dom_epoch) and capacity growth invalidate wholesale.
        self._presence: Dict[Tuple[str, int], np.ndarray] = {}
        #: per-vector change counters (the mask-row cache's dependency key)
        self._presence_ver: Dict[Tuple[str, int], int] = {}
        self._presence_key: Tuple[int, int] = (-1, -1)
        #: bumped on every wholesale presence invalidation (dom_epoch /
        #: capacity) so stale mask-row deps can never alias fresh ones
        self._presence_gen = 0
        #: profile-term-content -> (deps, [capacity] bool row): the final
        #: per-template [N] mask row, reused across batches while none of
        #: its terms' presence vectors moved — the steady-state cost of
        #: required_masks drops to dict lookups
        self._mask_row_cache: Dict[Tuple, Tuple[Tuple, np.ndarray]] = {}
        self.mask_row_builds = 0
        self.mask_row_hits = 0
        # (namespace, labels-canon) -> frozenset of matching tids; pods
        # stamped from one template share the entry, so selector matching
        # runs once per template, not once per pod (invalidated when the
        # term table grows)
        self._match_cache: Dict[Tuple, frozenset] = {}
        self._match_cache_nterms = 0
        #: lazy activation: an affinity-free cluster pays only a cheap
        #: `spec.affinity is not None` scan per dirty node — the per-pod
        #: rv-diff bookkeeping starts at the FIRST affinity carrier or
        #: term (one O(cluster) rebuild), not on every uniform batch
        self._active = False
        self._last_snapshot = None

    # ------------------------------------------------------------ interning

    def _intern(self, tk: str, namespaces: Tuple[str, ...],
                selector: Optional[LabelSelector]) -> _Term:
        key = (tk, tuple(sorted(namespaces)),
               labelsmod.canonical_selector(selector))
        term = self._terms.get(key)
        if term is None:
            term = _Term(len(self._by_id), tk, tuple(sorted(namespaces)),
                         selector)
            self._terms[key] = term
            self._by_id.append(term)
            if tk not in self._doms:
                self._doms[tk] = {}
                nd = np.full((self.mirror.t.capacity,), -1, np.int32)
                for name, rec in self._nodes.items():
                    row = self.mirror.row_of.get(name)
                    if row is not None:
                        nd[row] = self._dom_id(tk, rec.labels.get(tk))
                self._node_dom[tk] = nd
                self.dom_epoch += 1
        return term

    def _dom_id(self, tk: str, value: Optional[str]) -> int:
        if value is None:
            return -1
        doms = self._doms[tk]
        d = doms.get(value)
        if d is None:
            d = len(doms)
            doms[value] = d
            self.dom_epoch += 1  # new domain: n_domains in tables grew
        return d

    def match_set(self, pod: Pod) -> frozenset:
        """tids of ALL interned terms matching this pod, cached per
        (namespace, labels) template."""
        key = (pod.metadata.namespace,
               tuple(sorted(pod.metadata.labels.items())))
        if self._match_cache_nterms != len(self._by_id):
            self._match_cache.clear()
            self._match_cache_nterms = len(self._by_id)
        hit = self._match_cache.get(key)
        if hit is None:
            hit = frozenset(t.tid for t in self._by_id if t.matches_pod(pod))
            self._match_cache[key] = hit
        return hit

    def _resolved_ns(self, term, owner: Pod) -> Tuple[str, ...]:
        """Empty namespaces means the term owner's namespace (ref:
        priorityutil.PodMatchesTermsNamespaceAndSelector)."""
        return tuple(term.namespaces) if term.namespaces \
            else (owner.metadata.namespace,)

    def ensure_match(self, tk: str, namespaces: Tuple[str, ...],
                     selector: Optional[LabelSelector]) -> _Term:
        """Register a term for match-count maintenance, backfilling from the
        pods the index already holds (one O(pods) scan per NEW term — the
        amortized replacement for the reference's per-cycle full scan)."""
        # a term arriving from a PENDING pod is the other activation edge:
        # the index must hold records before the backfill scan below
        self._activate()
        term = self._intern(tk, namespaces, selector)
        if term.match_registered:
            return term
        term.match_registered = True
        counts = self._counts[K_MATCH].setdefault(term.tid, {})
        total = 0.0
        for name, rec in self._nodes.items():
            dom = self._dom_id(tk, rec.labels.get(tk))
            if dom < 0:
                continue
            for key, (_rv, pod) in rec.pods.items():
                if term.matches_pod(pod):
                    counts[dom] = counts.get(dom, 0) + 1
                    total += 1.0
                    rec.contrib.setdefault(key, []).append(
                        (K_MATCH, term.tid, dom, 1.0))
        if total:
            self._match_total[term.tid] = \
                self._match_total.get(term.tid, 0) + total
        self.version += 1
        #: a newly registered term starts maintaining counts: profiles
        #: resolved before this registration never referenced it, but the
        #: bump keeps the invariant simple (registration is rare — once
        #: per new template term, not per batch)
        self.profile_epoch += 1
        return term

    # ------------------------------------------------------ incremental feed

    def apply(self, snapshot, dirty_names) -> None:
        """Consume the cache's dirty-node list (call right after
        TensorMirror.apply — row_of must already reflect the delta)."""
        self._last_snapshot = snapshot
        if not self._active:
            if not self._dirty_has_affinity(snapshot, dirty_names):
                return
            self._activate()  # rebuilds from the FULL snapshot
            return
        self._apply_records(snapshot, dirty_names)

    def _dirty_has_affinity(self, snapshot, dirty_names) -> bool:
        for name in dirty_names:
            ni = snapshot.node_infos.get(name)
            if ni is None:
                continue
            for p in ni.pods:
                aff = p.spec.affinity
                if aff is not None and (aff.pod_affinity is not None or
                                        aff.pod_anti_affinity is not None):
                    return True
        return False

    def _activate(self) -> None:
        """First affinity carrier/term seen: switch to incremental
        maintenance, seeded by one full-cluster pass."""
        if self._active:
            return
        self._active = True
        snap = self._last_snapshot
        if snap is not None:
            self._apply_records(snap, list(snap.node_infos))

    def _apply_records(self, snapshot, dirty_names) -> None:
        changed = False
        for name in dirty_names:
            ni = snapshot.node_infos.get(name)
            if ni is None or ni.node is None:
                changed |= self._drop_node(name)
                continue
            labels = ni.node.metadata.labels
            rec = self._nodes.get(name)
            if rec is not None and rec.labels != labels:
                # topology labels moved: every contribution's dom is stale
                self._drop_node(name)
                rec = None
                changed = True
            if rec is None:
                rec = _NodeRec(dict(labels))
                self._nodes[name] = rec
                changed = True
            row = self.mirror.row_of.get(name)
            if row is not None:
                for tk, nd in self._node_dom.items():
                    if len(nd) < self.mirror.t.capacity:
                        grown = np.full((self.mirror.t.capacity,), -1,
                                        np.int32)
                        grown[:len(nd)] = nd
                        nd = self._node_dom[tk] = grown
                    new_dom = self._dom_id(tk, labels.get(tk))
                    if nd[row] != new_dom:
                        nd[row] = new_dom
                        self.dom_epoch += 1  # row's domain moved
            # pod diff by (key, resourceVersion): rebinds/updates recompute,
            # untouched pods keep their recorded contributions
            fresh = {p.metadata.key(): (p.metadata.resource_version, p)
                     for p in ni.pods}
            for key in list(rec.pods):
                if fresh.get(key, (None,))[0] != rec.pods[key][0]:
                    self._sub_pod(rec, key)
                    changed = True
            for key, (rv, pod) in fresh.items():
                if key not in rec.pods:
                    self._add_pod(rec, key, rv, pod)
                    changed = True
        if changed:
            self.version += 1

    def _drop_node(self, name: str) -> bool:
        rec = self._nodes.pop(name, None)
        if rec is None:
            return False
        for key in list(rec.pods):
            self._sub_pod(rec, key)
        return True

    def _sub_pod(self, rec: _NodeRec, key: str) -> None:
        rec.pods.pop(key, None)
        for kind, tid, dom, w in rec.contrib.pop(key, ()):
            counts = self._counts[kind].get(tid)
            if counts is None:
                continue
            v = counts.get(dom, 0) - w
            if v <= 0:
                counts.pop(dom, None)
                self._presence_update(kind, tid, dom, False)
            else:
                counts[dom] = v
            if kind == K_MATCH:
                t = self._match_total.get(tid, 0) - w
                if t <= 0:
                    self._match_total.pop(tid, None)
                    self.profile_epoch += 1  # waived bits may flip back
                else:
                    self._match_total[tid] = t
            elif kind == K_CARRY_ANTI and not counts and \
                    tid in self._anti_active:
                self._anti_active.discard(tid)
                self.profile_epoch += 1  # carried_anti lists shrink

    def _add_pod(self, rec: _NodeRec, key: str, rv: str, pod: Pod) -> None:
        rec.pods[key] = (rv, pod)
        contrib: List[Tuple[str, int, int, float]] = []

        def credit(kind: str, term: _Term, dom: int, w: float) -> None:
            counts = self._counts[kind].setdefault(term.tid, {})
            prev = counts.get(dom, 0)
            counts[dom] = prev + w
            if prev <= 0:
                self._presence_update(kind, term.tid, dom, True)
            contrib.append((kind, term.tid, dom, w))
            if kind == K_MATCH:
                t = self._match_total.get(term.tid)
                if t is None:
                    self.profile_epoch += 1  # total crossed zero: waived
                    self._match_total[term.tid] = w
                else:
                    self._match_total[term.tid] = t + w
            elif kind == K_CARRY_ANTI and term.tid not in self._anti_active:
                self._anti_active.add(term.tid)
                self.profile_epoch += 1  # carried_anti lists grow

        aff = pod.spec.affinity
        if aff is not None:
            pa, paa = aff.pod_affinity, aff.pod_anti_affinity
            for kind, terms in (
                    (K_CARRY_AFF, pa.required_during_scheduling_ignored_during_execution if pa else ()),
                    (K_CARRY_ANTI, paa.required_during_scheduling_ignored_during_execution if paa else ())):
                for t in terms or ():
                    term = self._intern(
                        t.topology_key, self._resolved_ns(t, pod),
                        t.label_selector)
                    dom = self._dom_id(term.tk, rec.labels.get(term.tk))
                    if dom >= 0:
                        credit(kind, term, dom, 1.0)
            for kind, wterms in (
                    (K_CARRY_PAFF, pa.preferred_during_scheduling_ignored_during_execution if pa else ()),
                    (K_CARRY_PANTI, paa.preferred_during_scheduling_ignored_during_execution if paa else ())):
                for wt in wterms or ():
                    t = wt.pod_affinity_term
                    term = self._intern(
                        t.topology_key, self._resolved_ns(t, pod),
                        t.label_selector)
                    dom = self._dom_id(term.tk, rec.labels.get(term.tk))
                    if dom >= 0 and wt.weight:
                        credit(kind, term, dom, float(wt.weight))
        for tid in self.match_set(pod):
            term = self._by_id[tid]
            if term.match_registered:
                dom = self._dom_id(term.tk, rec.labels.get(term.tk))
                if dom >= 0:
                    credit(K_MATCH, term, dom, 1.0)
        if contrib:
            rec.contrib[key] = contrib

    # ------------------------------------------------------------- queries

    def has_required_anti_carriers(self) -> bool:
        """True when any pod in the cluster carries required anti-affinity —
        the only carried constraint that can mask OTHER pods' feasibility."""
        return any(self._counts[K_CARRY_ANTI].values())

    def has_score_carriers(self) -> bool:
        """True when any carried term can contribute to the inter-pod
        affinity PRIORITY: required affinity (symmetric hard credit) or
        preferred terms. Required anti-affinity carriers mask feasibility
        but never score — a cluster holding only those skips the static
        scorer entirely."""
        c = self._counts
        return (any(c[K_CARRY_AFF].values()) or any(c[K_CARRY_PAFF].values())
                or any(c[K_CARRY_PANTI].values()))

    def dom_of(self, node_name: str, tk: str) -> int:
        rec = self._nodes.get(node_name)
        if rec is None or tk not in self._doms:
            return -1
        val = rec.labels.get(tk)
        if val is None:
            return -1  # label absent ≠ empty-string label value
        return self._doms[tk].get(val, -1)

    def term(self, tid: int) -> _Term:
        return self._by_id[tid]

    def required_profile(self, pod: Pod) -> AffinityProfile:
        """Resolve a pod template's required-(anti-)affinity evaluation plan
        (registers match terms as needed)."""
        prof = AffinityProfile()
        aff = pod.spec.affinity
        if aff is not None and aff.pod_affinity is not None:
            for t in aff.pod_affinity.required_during_scheduling_ignored_during_execution or ():
                term = self.ensure_match(
                    t.topology_key, self._resolved_ns(t, pod),
                    t.label_selector)
                total = sum(self._counts[K_MATCH].get(term.tid, {}).values())
                # special case (predicates.go:1476-1497 / the oracle's
                # match_inter_pod_affinity): a term matching the incoming pod
                # itself with no match anywhere is waived (first pod of a
                # self-affine group can land; the node still needs the key)
                waived = total == 0 and term.matches_pod(pod)
                prof.req_aff.append((term.tid, waived))
                prof.constrained = True
        if aff is not None and aff.pod_anti_affinity is not None:
            for t in aff.pod_anti_affinity.required_during_scheduling_ignored_during_execution or ():
                term = self.ensure_match(
                    t.topology_key, self._resolved_ns(t, pod),
                    t.label_selector)
                prof.req_anti.append(term.tid)
                prof.constrained = True
        if any(self._counts[K_CARRY_ANTI].values()):
            mset = self.match_set(pod)
            for tid, counts in self._counts[K_CARRY_ANTI].items():
                if counts and tid in mset:
                    prof.carried_anti.append(tid)
                    prof.constrained = True
        return prof

    def _presence_sync(self) -> bool:
        """Wholesale-invalidate the presence vectors when the node->domain
        layout or the row capacity moved (the only changes the per-domain
        delta updates cannot express). Returns True when a flush happened."""
        key = (self.dom_epoch, self.mirror.t.capacity)
        if self._presence_key == key:
            return False
        self._presence_key = key
        self._presence.clear()
        self._presence_ver.clear()
        self._presence_gen += 1
        return True

    def _presence_update(self, kind: str, tid: int, dom: int,
                         present: bool) -> None:
        """A (term, domain) count crossed zero: rewrite that domain's rows
        of the materialized presence vector (if one exists). O(N) per
        CROSSING — steady pod churn within occupied domains costs zero,
        where the per-batch regather this replaces paid O(terms × N)
        per batch unconditionally."""
        if self._presence_key != (self.dom_epoch, self.mirror.t.capacity):
            return  # stale wholesale; the next access rebuilds anyway
        vec = self._presence.get((kind, tid))
        if vec is None:
            return
        nd = self._node_dom_vec(self._by_id[tid].tk)
        vec[nd[:len(vec)] == dom] = present
        self._presence_ver[(kind, tid)] = \
            self._presence_ver.get((kind, tid), 0) + 1

    def presence_vec(self, kind: str, tid: int) -> np.ndarray:
        """[capacity] bool — `kind` count > 0 in this node's domain for
        term `tid` (False where the topology label is absent). Built once,
        then maintained by _presence_update deltas. Callers must not
        mutate the returned array."""
        self._presence_sync()
        key = (kind, tid)
        vec = self._presence.get(key)
        if vec is not None:
            return vec
        term = self._by_id[tid]
        nd = self._node_dom_vec(term.tk)
        cap = self.mirror.t.capacity
        counts = self._counts[kind].get(tid)
        if not counts:
            vec = np.zeros((cap,), bool)
        else:
            ndom = len(self._doms[term.tk])
            dense = np.zeros((ndom + 1,), bool)
            for dom, v in counts.items():
                dense[dom] = v > 0
            vec = dense[np.where(nd >= 0, nd, ndom)[:cap]]
        self._presence[key] = vec
        self._presence_ver.setdefault(key, 0)
        return vec

    def _vec(self, kind: str, tid: int) -> np.ndarray:
        """[capacity] f32 counts of `kind` for term `tid`, gathered over the
        term's topology-key node→domain array. Cached per index version."""
        if self._vec_cache_version != self.version:
            self._vec_cache.clear()
            self._vec_cache_version = self.version
        key = (kind, tid)
        hit = self._vec_cache.get(key)
        if hit is not None and len(hit) == self.mirror.t.capacity:
            return hit
        term = self._by_id[tid]
        nd = self._node_dom_vec(term.tk)
        counts = self._counts[kind].get(tid)
        if not counts:
            vec = np.zeros((self.mirror.t.capacity,), np.float32)
        else:
            ndom = len(self._doms[term.tk])
            dense = np.zeros((ndom + 1,), np.float32)
            for dom, v in counts.items():
                dense[dom] = v
            vec = dense[np.where(nd >= 0, nd, ndom)]
        self._vec_cache[key] = vec
        return vec

    def _node_dom_vec(self, tk: str) -> np.ndarray:
        nd = self._node_dom.get(tk)
        cap = self.mirror.t.capacity
        if nd is None:
            # tk interned but never registered through _intern's dom init
            self._doms.setdefault(tk, {})
            nd = np.full((cap,), -1, np.int32)
            for name, rec in self._nodes.items():
                row = self.mirror.row_of.get(name)
                if row is not None:
                    nd[row] = self._dom_id(tk, rec.labels.get(tk))
            self._node_dom[tk] = nd
        elif len(nd) < cap:
            grown = np.full((cap,), -1, np.int32)
            grown[:len(nd)] = nd
            nd = self._node_dom[tk] = grown
        return nd

    def has_dom_vec(self, tk: str) -> np.ndarray:
        return self._node_dom_vec(tk) >= 0

    def term_table(self, terms: Tuple[int, ...],
                   use_cache: bool = True) -> Tuple[np.ndarray, int]:
        """([T, capacity] int32 node->domain row per term, n_domains) for
        an in-scan term set — the host half of the kernel's (anti-)affinity
        tables. Cached by (term tuple, dom_epoch, capacity): pod churn
        between batches never rebuilds it, only an actual node-topology
        change does (the O(epoch changes) rebuild contract the bench's
        phase breakdown asserts). Callers must not mutate the returned
        array (PodBatchTensors copies it into padded device tables)."""
        cap = self.mirror.t.capacity
        if use_cache:
            hit = self._table_cache.get(terms)
            if hit is not None and hit[0] == self.dom_epoch \
                    and hit[1] == cap:
                self.table_hits += 1
                return hit[2], hit[3]
        T = len(terms)
        dom = np.full((T, cap), -1, np.int32)
        n_domains = 1
        for j, tid in enumerate(terms):
            term = self._by_id[tid]
            # _node_dom_vec handles missing/short entries (capacity-sized,
            # -1 for label-absent rows)
            nd = self._node_dom_vec(term.tk)
            dom[j] = nd[:cap]
            if len(nd):
                n_domains = max(n_domains, int(nd.max()) + 1)
        self.table_builds += 1
        if use_cache:
            if len(self._table_cache) > 64:
                self._table_cache.clear()
            self._table_cache[terms] = (self.dom_epoch, cap, dom, n_domains)
        return dom, n_domains

    def term_table_device(self, terms: Tuple[int, ...], mesh,
                          use_cache: bool = True, dom=None,
                          n_domains: Optional[int] = None):
        """(padded [T, capacity] dom table ON DEVICE sharded by the
        name-keyed rules, n_domains) — the device half of term_table for
        the sharded drain. T is bucketed exactly like
        PodBatchTensors.set_topology_terms (power of two, min 8) so the
        cached upload can be handed to it as dom_dev. Epoch-cached with
        the same (dom_epoch, capacity) key as the host table: steady
        pod churn re-uses one device-resident table across every batch
        of a drain; only a node-topology change re-uploads. A caller
        that already built the host table passes (dom, n_domains) so a
        cache-disabled run (KTPU_TOPO_TABLE_CACHE=0) does not build it
        twice.

        Not ported: the port has no sharded mesh (ROADMAP, last slice)."""
        raise NotImplementedError(
            "term_table_device: the sharded mesh route is not ported yet "
            "(ROADMAP: sharded class scan)")

    def node_domain_vector(self, tk: str) -> np.ndarray:
        """[capacity] int32 node-row -> topology-domain id for `tk` (-1
        where the node lacks the label). The gang scheduler's ICI-domain
        constraint (kernels/gang.py) rides the same incrementally-
        maintained node→domain arrays the (anti-)affinity masks gather
        over. Forces activation: domain interning needs per-node records
        even in an affinity-free cluster."""
        self._activate()
        self._doms.setdefault(tk, {})
        return self._node_dom_vec(tk)

    def _profile_mask_row(self, prof: AffinityProfile) -> np.ndarray:
        """One profile's [capacity] feasible-node mask from the
        incrementally maintained presence vectors, cached until any of
        its terms' vectors move (a count-delta zero-crossing or a
        wholesale node-topology flush). Steady-state batches pay dict
        lookups instead of the O(k·N) boolean recombination; callers
        must not mutate the returned row."""
        self._presence_sync()   # settle the gen BEFORE recording deps
        key = (tuple(prof.req_aff), tuple(prof.req_anti),
               tuple(prof.carried_anti))
        deps = [self._presence_gen, self.mirror.t.capacity]
        for tid, _waived in prof.req_aff:
            deps.append(self._presence_ver.get((K_MATCH, tid), 0))
        for tid in prof.req_anti:
            deps.append(self._presence_ver.get((K_MATCH, tid), 0))
        for tid in prof.carried_anti:
            deps.append(self._presence_ver.get((K_CARRY_ANTI, tid), 0))
        deps = tuple(deps)
        hit = self._mask_row_cache.get(key)
        if hit is not None and hit[0] == deps:
            self.mask_row_hits += 1
            return hit[1]
        row = np.ones((self.mirror.t.capacity,), bool)
        for tid, waived in prof.req_aff:
            # presence is False wherever the label is absent, but a
            # WAIVED term still requires the node to carry the key
            row &= self.has_dom_vec(self._by_id[tid].tk)
            if not waived:
                row &= self.presence_vec(K_MATCH, tid)
        for tid in prof.req_anti:
            row &= ~self.presence_vec(K_MATCH, tid)
        for tid in prof.carried_anti:
            row &= ~self.presence_vec(K_CARRY_ANTI, tid)
        if len(self._mask_row_cache) > 4096:
            self._mask_row_cache.clear()
        self._mask_row_cache[key] = (deps, row)
        self.mask_row_builds += 1
        return row

    def required_masks(self, profiles: List[AffinityProfile]) -> np.ndarray:
        """[U, capacity] bool — each profile's feasible-node mask, from
        the incrementally maintained (term, domain) presence vectors
        (count-delta zero-crossings, not per-batch regathers). Routes
        through the device kernel K13 (kernels/affinity.py) on the
        mirror's device when templates × terms × nodes reaches
        DEVICE_EVAL_THRESHOLD. Callers must not mutate the returned
        rows."""
        U = len(profiles)
        cap = self.mirror.t.capacity
        terms: List[Tuple[str, int]] = []
        t_index: Dict[Tuple[str, int], int] = {}
        for prof in profiles:
            for tid, waived in prof.req_aff:
                for k in ((K_MATCH, tid),):
                    if k not in t_index:
                        t_index[k] = len(terms)
                        terms.append(k)
            for tid in prof.req_anti:
                k = (K_MATCH, tid)
                if k not in t_index:
                    t_index[k] = len(terms)
                    terms.append(k)
            for tid in prof.carried_anti:
                k = (K_CARRY_ANTI, tid)
                if k not in t_index:
                    t_index[k] = len(terms)
                    terms.append(k)
        T = len(terms)
        if T == 0:
            return np.ones((U, cap), bool)
        if U * T * cap >= DEVICE_EVAL_THRESHOLD:
            present = np.stack([self.presence_vec(kind, tid)
                                for kind, tid in terms])
            has_dom = np.stack([self.has_dom_vec(self._by_id[tid].tk)
                                for _, tid in terms])
            sel_dom = np.zeros((U, T), np.float32)   # aff: node needs tk
            sel_present = np.zeros((U, T), np.float32)  # non-waived: match
            sel_absent = np.zeros((U, T), np.float32)   # anti: match forbids
            for u, prof in enumerate(profiles):
                for tid, waived in prof.req_aff:
                    t = t_index[(K_MATCH, tid)]
                    sel_dom[u, t] = 1.0
                    if not waived:
                        sel_present[u, t] = 1.0
                for tid in prof.req_anti:
                    sel_absent[u, t_index[(K_MATCH, tid)]] = 1.0
                for tid in prof.carried_anti:
                    sel_absent[u, t_index[(K_CARRY_ANTI, tid)]] = 1.0
            from .kernels import affinity
            return affinity.affinity_masks(
                has_dom, present, sel_dom, sel_present, sel_absent,
                device=self.mirror.device)
        # host path: per-profile cached mask rows — a batch whose
        # templates' presence vectors haven't moved since the last batch
        # recombines NOTHING (the stacked copy is the only O(U·N) left)
        return np.stack([self._profile_mask_row(prof)
                         for prof in profiles])

    def score_vector(self, pod: Pod,
                     hard_pod_affinity_weight: float) -> Optional[np.ndarray]:
        """[capacity] f32 raw inter-pod affinity priority — the
        interpod_affinity_scores oracle as count-matrix gathers:
          + w × matches for the pod's preferred affinity terms
          - w × matches for its preferred anti-affinity terms
          + carried preferred weights (±) for terms matching the pod
          + hard_pod_affinity_weight × carried required-affinity matches
        Returns None when nothing can contribute."""
        total: Optional[np.ndarray] = None

        def acc(vec: np.ndarray, w: float):
            nonlocal total
            if total is None:
                total = np.zeros((self.mirror.t.capacity,), np.float32)
            total += w * vec

        aff = pod.spec.affinity
        if aff is not None:
            for sign, wterms in (
                    (1.0, aff.pod_affinity.preferred_during_scheduling_ignored_during_execution
                     if aff.pod_affinity else ()),
                    (-1.0, aff.pod_anti_affinity.preferred_during_scheduling_ignored_during_execution
                     if aff.pod_anti_affinity else ())):
                for wt in wterms or ():
                    t = wt.pod_affinity_term
                    if not wt.weight:
                        continue
                    term = self.ensure_match(
                        t.topology_key, self._resolved_ns(t, pod),
                        t.label_selector)
                    acc(self._vec(K_MATCH, term.tid), sign * float(wt.weight))
        mset = None
        for kind, w in ((K_CARRY_AFF, float(hard_pod_affinity_weight)),
                        (K_CARRY_PAFF, 1.0), (K_CARRY_PANTI, -1.0)):
            if kind == K_CARRY_AFF and not w:
                continue
            for tid, counts in self._counts[kind].items():
                if not counts:
                    continue
                if mset is None:
                    mset = self.match_set(pod)
                if tid in mset:
                    acc(self._vec(kind, tid), w)
        if total is None or not total.any():
            return None
        return total


class BatchOverlay:
    """In-batch winner tracking for the repair pass — the serial reference
    sees each earlier bind via cache.AssumePod between iterations
    (scheduler.go:514); the batch kernel's mask is frozen at batch start, so
    (anti-)affinity created by EARLIER WINNERS IN THE SAME BATCH is
    validated here with O(terms) dict lookups per winner (the PredicateMetadata
    clone+add_pod machinery this replaces was O(winners × pairs))."""

    def __init__(self, index: TopologyIndex):
        self.index = index
        self._match: Dict[Tuple[int, int], int] = {}      # (tid, dom) -> n
        self._match_total: Dict[int, int] = {}
        self._carry_anti: Dict[Tuple[int, int], int] = {}
        self._anti_terms: List[int] = []                  # tids added in-batch
        self._anti_term_seen: Set[int] = set()

    @property
    def has_anti(self) -> bool:
        return bool(self._anti_terms)

    def add_winner(self, pod: Pod, node_name: str) -> None:
        idx = self.index
        for tid in idx.match_set(pod):
            term = idx._by_id[tid]
            if term.match_registered:
                dom = idx.dom_of(node_name, term.tk)
                if dom >= 0:
                    k = (term.tid, dom)
                    self._match[k] = self._match.get(k, 0) + 1
                    self._match_total[term.tid] = \
                        self._match_total.get(term.tid, 0) + 1
        aff = pod.spec.affinity
        if aff is not None and aff.pod_anti_affinity is not None:
            for t in aff.pod_anti_affinity.required_during_scheduling_ignored_during_execution or ():
                term = idx._intern(t.topology_key,
                                   idx._resolved_ns(t, pod), t.label_selector)
                dom = idx.dom_of(node_name, term.tk)
                if dom >= 0:
                    k = (term.tid, dom)
                    self._carry_anti[k] = self._carry_anti.get(k, 0) + 1
                    if term.tid not in self._anti_term_seen:
                        self._anti_term_seen.add(term.tid)
                        self._anti_terms.append(term.tid)

    def conflicts(self, pod: Pod, prof: AffinityProfile,
                  node_name: str) -> bool:
        """Would earlier winners invalidate this pod's assignment? (The
        batch-start mask already enforced pre-batch state; only ADDITIONS
        can break an assignment — affinity matches never disappear
        in-batch.)"""
        idx = self.index
        for tid in prof.req_anti:
            term = idx._by_id[tid]
            dom = idx.dom_of(node_name, term.tk)
            if dom >= 0 and self._match.get((tid, dom), 0) > 0:
                return True
        for tid, waived in prof.req_aff:
            # a waived term activates once an in-batch winner matches it:
            # later pods must co-locate (the serial semantics — pod 2 of a
            # self-affine group follows pod 1)
            if waived and self._match_total.get(tid, 0) > 0:
                term = idx._by_id[tid]
                dom = idx.dom_of(node_name, term.tk)
                if dom < 0 or self._match.get((tid, dom), 0) == 0:
                    return True
        if self._anti_terms:
            # only terms some in-batch winner carries have overlay entries;
            # prof.carried_anti needs no separate pass (same interned tids)
            mset = idx.match_set(pod)
            for tid in self._anti_terms:
                if tid not in mset:
                    continue
                term = idx._by_id[tid]
                dom = idx.dom_of(node_name, term.tk)
                if dom >= 0 and self._carry_anti.get((tid, dom), 0) > 0:
                    return True
        return False
