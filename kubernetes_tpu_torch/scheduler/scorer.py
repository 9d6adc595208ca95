"""Static score compilation: the non-resource priorities as deduplicated
per-node score rows.

Ref: pkg/scheduler/algorithm/priorities/ and PrioritizeNodes
(generic_scheduler.go:672-812). The reference runs Map per (priority, node)
then Reduce per priority over the FILTERED node list. Here:

  - raw per-node vectors are compiled on the host through the same term
    cache as the filter terms (pods sharing tolerations/affinity/images hit
    the cache),
  - Reduce (NormalizeReduce / reversed / min-max / spread's zone blend) is
    vectorized numpy over the pod's statically-feasible node set,
  - the weighted sum is computed ONCE per unique score key (pods of one
    controller share terms, labels, and requests) and ships to the kernel as
    pod_batch["unique_scores"] [S, N] + ["score_idx"] [P], added on device to
    the resource scores (LeastRequested/Balanced, which the scan recomputes
    per step because they vary with in-batch usage).

Priorities whose contribution is CONSTANT over a pod's feasible nodes (e.g.
TaintToleration when no node has PreferNoSchedule taints: all 10) are
selection-invariant and dropped — ScheduleResult.score is therefore the
selection score, not the reference's absolute weighted sum.

In-batch drift: SelectorSpread counts and InterPodAffinity terms are frozen
at batch start (the reference re-runs them after every one-pod bind). Hard
(anti-)affinity stays exact via core._repair_batch; soft scores may lag by
one batch — the documented batching tradeoff.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..api import helpers, labels as labelsmod, wellknown
from ..api.core import Pod
from ..api.meta import controller_ref
from . import priorities as prios
from .nodeinfo import NodeInfo
from .tensorize import TensorMirror, TermCompiler, _canon_tolerations

MAXP = float(prios.MAX_PRIORITY)


def _canon_preferred_node_affinity(pod: Pod) -> Tuple:
    aff = pod.spec.affinity
    if not aff or not aff.node_affinity:
        return ()
    return tuple(
        (t.weight,
         tuple((r.key, r.operator, tuple(r.values))
               for r in t.preference.match_expressions),
         tuple((r.key, r.operator, tuple(r.values))
               for r in t.preference.match_fields))
        for t in aff.node_affinity.preferred_during_scheduling_ignored_during_execution)


def _canon_pod_affinity(pod: Pod) -> Tuple:
    """Canonical form of the pod's preferred (anti-)affinity terms — part of
    the static-score dedupe key (scorer rows are shared across pods whose
    affinity terms, labels, and namespace coincide)."""
    aff = pod.spec.affinity
    if not aff:
        return ()

    def canon_weighted(terms):
        out = []
        for wt in terms or []:
            t = wt.pod_affinity_term
            sel = labelsmod.canonical_selector(t.label_selector) \
                if t.label_selector is not None else None
            out.append((wt.weight, sel, t.topology_key,
                        tuple(sorted(t.namespaces))))
        return tuple(out)

    pa = canon_weighted(
        aff.pod_affinity.preferred_during_scheduling_ignored_during_execution
        if aff.pod_affinity else None)
    paa = canon_weighted(
        aff.pod_anti_affinity.preferred_during_scheduling_ignored_during_execution
        if aff.pod_anti_affinity else None)
    return (pa, paa)


def _has_preferred_pod_affinity(pod: Pod) -> bool:
    aff = pod.spec.affinity
    return bool(aff and (
        (aff.pod_affinity and
         aff.pod_affinity.preferred_during_scheduling_ignored_during_execution) or
        (aff.pod_anti_affinity and
         aff.pod_anti_affinity.preferred_during_scheduling_ignored_during_execution)))


class ScoreCompiler:
    """Builds the static [P, N] score matrix for a batch."""

    def __init__(self, mirror: TensorMirror, terms: TermCompiler,
                 listers: Optional[prios.SpreadListers] = None,
                 weights: Optional[Dict[str, int]] = None,
                 hard_pod_affinity_weight: int = prios.HARD_POD_AFFINITY_WEIGHT,
                 topology=None):
        self.mirror = mirror
        self.terms = terms
        #: scheduler/topology.py TopologyIndex — when present, inter-pod
        #: affinity scoring is count-matrix gathers instead of the
        #: O(existing pods × terms) python scan per template
        self.topology = topology
        self.listers = listers
        self.weights = dict(weights if weights is not None
                            else prios.DEFAULT_PRIORITY_WEIGHTS)
        self.hard_pod_affinity_weight = hard_pod_affinity_weight
        self._epoch = -1
        self._vec_cache: Dict[Tuple, np.ndarray] = {}
        self._zone_ids: Optional[np.ndarray] = None
        self._any_prefer_taints = False
        self._any_avoid_annotations = False
        self._cluster_has_affinity_pods = False
        #: bumped by invalidate_spread_selectors (Service/RC/RS/SS
        #: events): part of the spread chain signature, so a selector
        #: source changing mid-chain refuses the chained spread carry
        self.spread_sel_gen = 0

    def set_weights(self, weights: Dict[str, int],
                    hard_pod_affinity_weight: Optional[int] = None) -> None:
        """Install Policy weights (ref: CreateFromConfig applying
        policy.Priorities); invalidates the static-vector cache."""
        self.weights = dict(weights)
        if hard_pod_affinity_weight is not None:
            self.hard_pod_affinity_weight = hard_pod_affinity_weight
        self._epoch = -1
        self._vec_cache.clear()

    # ------------------------------------------------------- cached vectors

    def _refresh_epoch(self) -> None:
        if self._epoch == self.mirror.epoch:
            return
        self._epoch = self.mirror.epoch
        self._vec_cache.clear()
        self._spread_sel_memo: Dict[Tuple, bool] = {}
        cap = self.mirror.t.capacity
        zone_ids = np.zeros((cap,), np.int32)
        zones: Dict[str, int] = {"": 0}
        any_taints = False
        any_avoid = False
        any_images = False
        for row, ni in enumerate(self.mirror.infos):
            if ni is None or ni.node is None:
                continue
            z = ni.node.metadata.labels.get(wellknown.LABEL_ZONE, "")
            zid = zones.get(z)
            if zid is None:
                zid = len(zones)
                zones[z] = zid
            zone_ids[row] = zid
            if any(t.effect == "PreferNoSchedule" for t in ni.taints):
                any_taints = True
            if prios.PREFER_AVOID_PODS_ANNOTATION in ni.node.metadata.annotations:
                any_avoid = True
            if ni.image_sizes:
                any_images = True
        self._zone_ids = zone_ids
        self._n_zones = len(zones)
        self._any_prefer_taints = any_taints
        self._any_avoid_annotations = any_avoid
        self._any_images = any_images

    def _vec(self, key: Tuple, fn) -> np.ndarray:
        hit = self._vec_cache.get(key)
        if hit is not None:
            return hit
        cap = self.mirror.t.capacity
        vec = np.zeros((cap,), np.float32)
        for row, ni in enumerate(self.mirror.infos):
            if ni is not None and ni.node is not None:
                vec[row] = fn(ni)
        self._vec_cache[key] = vec
        return vec

    def _node_affinity_raw(self, pod: Pod, meta: prios.PriorityMetadata
                           ) -> Optional[np.ndarray]:
        key = ("nodeaff", _canon_preferred_node_affinity(pod))
        if not key[1]:
            return None
        return self._vec(key, lambda ni: prios.node_affinity_map(pod, meta, ni))

    def _taint_raw(self, pod: Pod, meta: prios.PriorityMetadata
                   ) -> Optional[np.ndarray]:
        if not self._any_prefer_taints:
            return None  # all counts 0 -> reversed reduce gives constant 10
        key = ("tainttol", _canon_tolerations(pod))
        return self._vec(key, lambda ni: prios.taint_toleration_map(pod, meta, ni))

    def _image_raw(self, pod: Pod, meta: prios.PriorityMetadata
                   ) -> Optional[np.ndarray]:
        if not self._any_images:
            return None  # no node reports images -> all zeros
        images = tuple(sorted({c.image for c in pod.spec.containers if c.image}))
        if not images:
            return None
        key = ("img", images)
        return self._vec(key, lambda ni: prios.image_locality_map(pod, meta, ni))

    def _avoid_raw(self, pod: Pod, meta: prios.PriorityMetadata
                   ) -> Optional[np.ndarray]:
        if not self._any_avoid_annotations:
            return None  # constant 10 everywhere
        ref = controller_ref(pod.metadata)
        if ref is None or ref.kind not in ("ReplicationController", "ReplicaSet"):
            return None
        key = ("avoid", ref.kind, ref.name)
        return self._vec(key, lambda ni: prios.node_prefer_avoid_map(pod, meta, ni))

    def _spread_counts(self, pod: Pod, meta: prios.PriorityMetadata
                       ) -> Optional[np.ndarray]:
        if not meta.pod_selectors:
            return None
        # selectors derive from the pod's owning service/controller; key by
        # namespace + its labels (pods of one controller share both)
        key = ("spread", pod.metadata.namespace,
               tuple(sorted(pod.metadata.labels.items())))
        return self._vec(key, lambda ni: prios.selector_spread_map(pod, meta, ni))

    # ------------------------------------------------------------- compile

    def _pod_score_key(self, pod: Pod) -> Optional[Tuple]:
        """Canonical key of everything that can make this pod's static score
        row differ from another pod's — None when no priority can contribute
        (the common resource-only case). Pods from one controller share the
        key, so rows are computed once per controller, not once per pod."""
        w = self.weights
        parts = []
        contributes = False
        if w.get("NodeAffinityPriority"):
            k = _canon_preferred_node_affinity(pod)
            parts.append(k)
            contributes = contributes or bool(k)
        if w.get("TaintTolerationPriority") and self._any_prefer_taints:
            parts.append(_canon_tolerations(pod))
            contributes = True
        if w.get("ImageLocalityPriority") and self._any_images:
            images = tuple(sorted({c.image for c in pod.spec.containers
                                   if c.image}))
            parts.append(images)
            contributes = contributes or bool(images)
        if w.get("NodePreferAvoidPodsPriority") and self._any_avoid_annotations:
            ref = controller_ref(pod.metadata)
            if ref is not None and ref.kind in ("ReplicationController",
                                                "ReplicaSet"):
                parts.append((ref.kind, ref.name))
                contributes = True
            else:
                parts.append(None)
        spread_or_interpod = False
        if w.get("SelectorSpreadPriority") and self.listers is not None \
                and self._pod_has_spread_selectors(pod):
            spread_or_interpod = True
        if w.get("InterPodAffinityPriority") and (
                _has_preferred_pod_affinity(pod) or
                self._cluster_has_affinity_pods):
            spread_or_interpod = True
        if spread_or_interpod:
            parts.append((pod.metadata.namespace,
                          tuple(sorted(pod.metadata.labels.items())),
                          _canon_pod_affinity(pod)))
            contributes = True
        if not contributes:
            return None
        return tuple(parts)

    def invalidate_spread_selectors(self) -> None:
        """Drop the per-template spread-selector memo. The scheduler shell
        calls this on Service/RC/RS/StatefulSet informer events (the same
        events that move parked pods back to active): mirror.epoch only
        moves on node changes, so without this a Service created mid-run
        on a node-quiet cluster would leave its templates memoized as
        selector-less and silently skip spread scoring."""
        self._spread_sel_memo = {}
        self.spread_sel_gen += 1

    def _pod_has_spread_selectors(self, pod: Pod) -> bool:
        """SelectorSpread contributes only when some service/controller
        selector matches the pod; without one, the whole (ns, labels)
        score-key component — and its per-template fits_row +
        PriorityMetadata work — is dead weight. Memoized per template,
        invalidated by node epoch AND selector-source events
        (invalidate_spread_selectors), so a selector-less 16k-pod burst
        skips static scoring entirely."""
        memo = getattr(self, "_spread_sel_memo", None)
        if memo is None:
            memo = self._spread_sel_memo = {}
        key = (pod.metadata.namespace,
               tuple(sorted(pod.metadata.labels.items())))
        hit = memo.get(key)
        if hit is None:
            hit = bool(self.listers.selectors_for_pod(pod))
            memo[key] = hit
        return hit

    def static_scores(self, pods: List[Pod], batch
                      ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Deduplicated static scores: (score_idx [P], unique_rows [S, N]),
        or None when no priority contributes for any pod (resource-only
        batch — the device kernel needs no static term at all).

        Each unique (score key, feasibility row) computes ONE weighted row;
        reduces normalize over the representative pod's batch-start feasible
        set (the reference normalizes over filtered nodes,
        generic_scheduler.go PrioritizeNodes). `batch` is the
        PodBatchTensors (for mask_idx/req identity and fits_row)."""
        self._refresh_epoch()
        P = len(pods)
        score_idx = np.zeros((P,), np.int32)
        rows: List[np.ndarray] = [np.zeros((self.mirror.t.capacity,),
                                           np.float32)]
        row_of: Dict[Tuple, int] = {}
        any_contrib = False
        for i, pod in enumerate(pods):
            skey = self._pod_score_key(pod)
            if skey is None:
                continue
            # pods in an in-scan spread group get their spread component
            # from the kernel's running counts — the static row must not
            # double-count it; same for inter-pod affinity when the batch
            # carries in-scan soft credit tables (core._assign_soft_terms)
            kernel_spread = bool(batch.spread_gidx[i] >= 0)
            kernel_interpod = getattr(batch, "soft_dom", None) is not None
            # the feasible set (normalization domain) depends on the mask
            # row, the request columns, and the pressure flag
            key = (skey, int(batch.mask_idx[i]), batch.req[i].tobytes(),
                   bool(batch.mem_pressure_blocked[i]), kernel_spread,
                   kernel_interpod)
            u = row_of.get(key)
            if u is None:
                row = self._compute_row(pod, batch.fits_row(i),
                                        skip_spread=kernel_spread,
                                        skip_interpod=kernel_interpod)
                if row is None:
                    u = 0
                else:
                    rows.append(row)
                    u = len(rows) - 1
                row_of[key] = u
            if u:
                any_contrib = True
            score_idx[i] = u
        if not any_contrib:
            return None
        return score_idx, np.stack(rows)

    def _compute_row(self, pod: Pod, fits: np.ndarray,
                     skip_spread: bool = False,
                     skip_interpod: bool = False) -> Optional[np.ndarray]:
        """One pod's weighted static score row [N] (None = all-constant)."""
        w = self.weights
        meta = prios.PriorityMetadata(pod, self.listers)
        total: Optional[np.ndarray] = None

        def acc(vec: np.ndarray, weight: float):
            nonlocal total
            if total is None:
                total = np.zeros((self.mirror.t.capacity,), np.float32)
            total += weight * vec

        def feas_max(raw: np.ndarray) -> float:
            vals = raw[fits]
            return float(vals.max()) if vals.size else 0.0

        if w.get("NodeAffinityPriority"):
            raw = self._node_affinity_raw(pod, meta)
            if raw is not None:
                mx = feas_max(raw)
                if mx > 0:
                    acc(np.floor(MAXP * raw / mx), w["NodeAffinityPriority"])
        if w.get("TaintTolerationPriority"):
            raw = self._taint_raw(pod, meta)
            if raw is not None:
                mx = feas_max(raw)
                if mx > 0:  # reversed NormalizeReduce
                    acc(MAXP - np.floor(MAXP * raw / mx),
                        w["TaintTolerationPriority"])
        if w.get("ImageLocalityPriority"):
            raw = self._image_raw(pod, meta)
            if raw is not None and raw.any():
                acc(raw, w["ImageLocalityPriority"])  # no reduce
        if w.get("NodePreferAvoidPodsPriority"):
            raw = self._avoid_raw(pod, meta)
            if raw is not None:
                acc(raw, w["NodePreferAvoidPodsPriority"])
        if w.get("SelectorSpreadPriority") and not skip_spread:
            counts = self._spread_counts(pod, meta)
            if counts is not None and counts.any():
                acc(self._spread_reduce(counts, fits),
                    w["SelectorSpreadPriority"])
        if w.get("InterPodAffinityPriority") and not skip_interpod:
            raw = self._interpod_raw(pod)
            if raw is not None:
                mn = float(raw[fits].min()) if fits.any() else 0.0
                mx = float(raw[fits].max()) if fits.any() else 0.0
                if mx > mn:
                    acc(np.floor(MAXP * (raw - mn) / (mx - mn)),
                        w["InterPodAffinityPriority"])
        return total

    def _spread_reduce(self, counts: np.ndarray, feas: np.ndarray
                       ) -> np.ndarray:
        """CalculateSpreadPriorityReduce with zone blending
        (selector_spreading.go zoneWeighting=2/3)."""
        max_count = float(counts[feas].max()) if feas.any() else 0.0
        if max_count > 0:
            node_score = MAXP * (max_count - counts) / max_count
        else:
            node_score = np.full_like(counts, MAXP)
        zid = self._zone_ids
        have_zones = (zid[feas] > 0).any() if feas.any() else False
        if not have_zones:
            return np.floor(node_score)
        zcounts = np.bincount(zid, weights=counts * feas,
                              minlength=self._n_zones)
        max_zone = float(zcounts[1:].max()) if self._n_zones > 1 else 0.0
        zone_of_node = zcounts[zid]
        # zone-less nodes keep the default MaxPriority zone score
        # (selector_spreading.go: zoneScore initialized to MaxPriority and
        # only recomputed for nodes with a zone id)
        zone_score = np.where((zid > 0) & (max_zone > 0),
                              MAXP * (max_zone - zone_of_node) /
                              max(max_zone, 1.0),
                              MAXP)
        blended = node_score * (1 - prios.ZONE_WEIGHTING) + \
            prios.ZONE_WEIGHTING * zone_score
        return np.floor(blended)

    def _interpod_raw(self, pod: Pod) -> Optional[np.ndarray]:
        """Preferred inter-pod (anti-)affinity + symmetric hard credit.
        Through the topology index when available (count-matrix gathers);
        the O(existing pods × terms) python scan over the snapshot is the
        fallback and the parity oracle. Only runs when the pod or the
        cluster carries (anti-)affinity terms."""
        if not _has_preferred_pod_affinity(pod) and \
                not self._cluster_has_affinity_pods:
            return None
        if self.topology is not None:
            return self.topology.score_vector(
                pod, self.hard_pod_affinity_weight)
        node_infos = {name: self.mirror.infos[row]
                      for name, row in self.mirror.row_of.items()
                      if self.mirror.infos[row] is not None}
        raw_by_name = prios.interpod_affinity_scores(
            pod, self.hard_pod_affinity_weight, node_infos)
        if not any(raw_by_name.values()):
            return None
        raw = np.zeros((self.mirror.t.capacity,), np.float32)
        for name, v in raw_by_name.items():
            raw[self.mirror.row_of[name]] = v
        return raw

    def set_cluster_has_affinity_pods(self, flag: bool) -> None:
        self._cluster_has_affinity_pods = flag
