"""Score priorities — python semantic reference.

Ref: pkg/scheduler/algorithm/priorities/ (~1,700 LoC). The default provider
registers 8 (algorithmprovider/defaults/defaults.go:126-137), each weight 1
except NodePreferAvoidPods (weight 10000). Scores are 0-10 per (priority,
node) in Map/Reduce form (priorities/types.go), then weight-summed
(generic_scheduler.go:767-772).

The TPU path computes the same arithmetic as a pods x nodes f32 matrix
(scorer.py + kernels/batch.py); these functions are the parity oracle.
"""

from __future__ import annotations

import json
from typing import Callable, Dict, List, Optional, Tuple

from ..api import helpers, labels as labelsmod, wellknown
from ..api.core import Pod
from .nodeinfo import NodeInfo, pod_resource_nonzero
from .predicates import _term_matches_pod

MAX_PRIORITY = 10  # schedulerapi.MaxPriority

# image locality thresholds (ref: image_locality.go:23-31)
MIN_IMG_SIZE = 23 * 1024 * 1024
MAX_IMG_SIZE = 1000 * 1024 * 1024

#: annotation consulted by NodePreferAvoidPods (ref: v1helper
#: GetAvoidPodsFromNodeAnnotations)
PREFER_AVOID_PODS_ANNOTATION = "scheduler.alpha.kubernetes.io/preferAvoidPods"

# zone spreading weight (ref: selector_spreading.go zoneWeighting = 2.0/3.0)
ZONE_WEIGHTING = 2.0 / 3.0


class PriorityMetadata:
    """Per-pod precompute (ref: priorities/metadata.go:115 priorityMetadata):
    non-zero request, pod limits, affinity, spread selectors."""

    def __init__(self, pod: Pod, listers: Optional["SpreadListers"] = None):
        self.pod = pod
        self.non_zero_request = pod_resource_nonzero(pod)
        self.pod_selectors = listers.selectors_for_pod(pod) if listers else []
        self.pod_tolerations = [t for t in pod.spec.tolerations
                                if t.effect in ("", "PreferNoSchedule")]
        aff = pod.spec.affinity
        self.preferred_node_affinity = (
            aff.node_affinity.preferred_during_scheduling_ignored_during_execution
            if aff and aff.node_affinity else [])


class SpreadListers:
    """Selector sources for SelectorSpread: services, RCs, RSs, StatefulSets
    (ref: selector_spreading.go getSelectors)."""

    def __init__(self, services=None, rcs=None, rss=None, statefulsets=None):
        self.services = services or (lambda ns: [])
        self.rcs = rcs or (lambda ns: [])
        self.rss = rss or (lambda ns: [])
        self.statefulsets = statefulsets or (lambda ns: [])

    def selectors_for_pod(self, pod: Pod) -> List[Callable[[Dict[str, str]], bool]]:
        ns = pod.metadata.namespace
        out = []
        for svc in self.services(ns):
            sel = svc.spec.selector
            if sel and all(pod.metadata.labels.get(k) == v for k, v in sel.items()):
                out.append(lambda lbls, s=dict(sel): all(
                    lbls.get(k) == v for k, v in s.items()))
        for rc in self.rcs(ns):
            sel = rc.spec.selector
            if sel and all(pod.metadata.labels.get(k) == v for k, v in sel.items()):
                out.append(lambda lbls, s=dict(sel): all(
                    lbls.get(k) == v for k, v in s.items()))
        for rs in self.rss(ns):
            if rs.spec.selector and labelsmod.matches(rs.spec.selector, pod.metadata.labels):
                out.append(lambda lbls, s=rs.spec.selector: labelsmod.matches(s, lbls))
        for ss in self.statefulsets(ns):
            if ss.spec.selector and labelsmod.matches(ss.spec.selector, pod.metadata.labels):
                out.append(lambda lbls, s=ss.spec.selector: labelsmod.matches(s, lbls))
        return out


# ------------------------------------------------------------- map funcs

def least_requested_map(pod: Pod, meta: PriorityMetadata, ni: NodeInfo) -> int:
    """Ref: least_requested.go:53 — ((cap-req)*10/cap averaged over cpu+mem),
    integer math."""
    cpu_req, mem_req = meta.non_zero_request
    cpu_score = _unused_score(ni.allocatable.milli_cpu,
                              ni.non_zero_requested.milli_cpu + cpu_req)
    mem_score = _unused_score(ni.allocatable.memory,
                              ni.non_zero_requested.memory + mem_req)
    return (cpu_score + mem_score) // 2


def _unused_score(capacity: int, requested: int) -> int:
    if capacity == 0:
        return 0
    if requested > capacity:
        return 0
    return ((capacity - requested) * MAX_PRIORITY) // capacity


def balanced_allocation_map(pod: Pod, meta: PriorityMetadata, ni: NodeInfo) -> int:
    """Ref: balanced_resource_allocation.go:77 — 10 - |cpuFrac - memFrac|*10
    (volume fraction variant gated off in the default build)."""
    cpu_req, mem_req = meta.non_zero_request
    cpu_frac = _fraction(ni.non_zero_requested.milli_cpu + cpu_req,
                         ni.allocatable.milli_cpu)
    mem_frac = _fraction(ni.non_zero_requested.memory + mem_req,
                         ni.allocatable.memory)
    if cpu_frac >= 1 or mem_frac >= 1:
        return 0
    diff = abs(cpu_frac - mem_frac)
    return int((1 - diff) * float(MAX_PRIORITY))


def _fraction(req: int, cap: int) -> float:
    return float(req) / float(cap) if cap > 0 else 1.0


def node_affinity_map(pod: Pod, meta: PriorityMetadata, ni: NodeInfo) -> int:
    """Ref: node_affinity.go CalculateNodeAffinityPriorityMap — sum of weights
    of matching preferred terms (normalized by reduce)."""
    score = 0
    for term in meta.preferred_node_affinity:
        if term.weight == 0:
            continue
        if helpers.match_node_selector_terms([term.preference], ni.node):
            score += term.weight
    return score


def taint_toleration_map(pod: Pod, meta: PriorityMetadata, ni: NodeInfo) -> int:
    """Ref: taint_toleration.go — count of intolerable PreferNoSchedule taints
    (reduce inverts + normalizes)."""
    count = 0
    for taint in ni.taints:
        if taint.effect != "PreferNoSchedule":
            continue
        if not any(t.tolerates(taint) for t in meta.pod_tolerations):
            count += 1
    return count


def image_locality_map(pod: Pod, meta: PriorityMetadata, ni: NodeInfo) -> int:
    """Ref: image_locality.go:109 — scaled sum of present image sizes."""
    total = 0
    for c in pod.spec.containers:
        total += ni.image_sizes.get(c.image, 0)
    return _scale_image_score(total)


def _scale_image_score(size: int) -> int:
    if size < MIN_IMG_SIZE:
        return 0
    if size > MAX_IMG_SIZE:
        return MAX_PRIORITY
    return int(MAX_PRIORITY * (size - MIN_IMG_SIZE) / (MAX_IMG_SIZE - MIN_IMG_SIZE))


def node_prefer_avoid_map(pod: Pod, meta: PriorityMetadata, ni: NodeInfo) -> int:
    """Ref: node_prefer_avoid_pods.go — 0 if the node's preferAvoidPods
    annotation targets this pod's controller (RC/RS), else 10."""
    from ..api.meta import controller_ref
    ref = controller_ref(pod.metadata)
    if ref is None or ref.kind not in ("ReplicationController", "ReplicaSet"):
        return MAX_PRIORITY
    if ni.node is None:
        return MAX_PRIORITY
    ann = ni.node.metadata.annotations.get(PREFER_AVOID_PODS_ANNOTATION)
    if not ann:
        return MAX_PRIORITY
    try:
        avoid = json.loads(ann)
    except ValueError:
        return MAX_PRIORITY
    for entry in avoid.get("preferAvoidPods", []):
        sig = entry.get("podSignature", {}).get("podController", {})
        if sig.get("kind") == ref.kind and sig.get("name") == ref.name:
            return 0
    return MAX_PRIORITY


def selector_spread_map(pod: Pod, meta: PriorityMetadata, ni: NodeInfo) -> int:
    """Ref: selector_spreading.go CalculateSpreadPriorityMap — count existing
    pods on the node matched by the pod's controller/service selectors."""
    if not meta.pod_selectors:
        return 0
    count = 0
    for p in ni.pods:
        if p.metadata.namespace != pod.metadata.namespace:
            continue
        if p.metadata.deletion_timestamp is not None:
            continue
        if all(sel(p.metadata.labels) for sel in meta.pod_selectors):
            count += 1
    return count


def selector_spread_reduce(pod: Pod, meta: PriorityMetadata,
                           node_infos: Dict[str, NodeInfo],
                           counts: Dict[str, int]) -> Dict[str, int]:
    """Ref: CalculateSpreadPriorityReduce — invert counts to 0-10, then blend
    zone-level counts with weight 2/3 when zones are present."""
    max_count = max(counts.values()) if counts else 0
    zone_counts: Dict[str, int] = {}
    have_zones = False
    for name, ni in node_infos.items():
        if ni.node is None:
            continue
        zone = ni.node.metadata.labels.get(wellknown.LABEL_ZONE, "")
        if zone:
            have_zones = True
            zone_counts[zone] = zone_counts.get(zone, 0) + counts.get(name, 0)
    max_zone = max(zone_counts.values()) if zone_counts else 0
    out: Dict[str, int] = {}
    for name, ni in node_infos.items():
        score = float(MAX_PRIORITY)
        if max_count > 0:
            score = MAX_PRIORITY * (max_count - counts.get(name, 0)) / max_count
        if have_zones and ni.node is not None:
            zone = ni.node.metadata.labels.get(wellknown.LABEL_ZONE, "")
            # zone-less nodes keep the default MaxPriority zone score
            # (selector_spreading.go: zoneScore only recomputed with a zone id)
            zone_score = float(MAX_PRIORITY)
            if zone and max_zone > 0:
                zone_score = MAX_PRIORITY * (max_zone - zone_counts.get(zone, 0)) / max_zone
            score = score * (1 - ZONE_WEIGHTING) + ZONE_WEIGHTING * zone_score
        out[name] = int(score)
    return out


def interpod_affinity_scores(pod: Pod, hard_pod_affinity_weight: int,
                             node_infos: Dict[str, NodeInfo],
                             score_nodes: Optional[Dict[str, NodeInfo]] = None
                             ) -> Dict[str, float]:
    """Ref: interpod_affinity.go CalculateInterPodAffinityPriority — for every
    existing pod, accumulate onto all nodes in the same topology:
      + weight of the incoming pod's preferred-affinity terms it matches
      - weight of the incoming pod's preferred-anti-affinity terms it matches
      + weight of the existing pod's preferred-affinity terms the incoming
        pod matches (symmetry), and - for its preferred anti-affinity
      + hard_pod_affinity_weight for existing pods whose REQUIRED affinity
        terms the incoming pod matches (symmetric hard-affinity credit)
    """
    aff = pod.spec.affinity
    pref_aff = (aff.pod_affinity.preferred_during_scheduling_ignored_during_execution
                if aff and aff.pod_affinity else [])
    pref_anti = (aff.pod_anti_affinity.preferred_during_scheduling_ignored_during_execution
                 if aff and aff.pod_anti_affinity else [])
    # topology pair -> accumulated weight
    pair_weights: Dict[Tuple[str, str], float] = {}

    def credit(term_owner: Pod, term, weight: float, node_labels: Dict[str, str]):
        tk = term.topology_key
        if weight == 0 or tk not in node_labels:
            return
        pair = (tk, node_labels[tk])
        pair_weights[pair] = pair_weights.get(pair, 0.0) + weight

    for ni in node_infos.values():
        if ni.node is None:
            continue
        node_labels = ni.node.metadata.labels
        for existing in ni.pods:
            for wt in pref_aff:
                if _term_matches_pod(wt.pod_affinity_term, pod, existing):
                    credit(pod, wt.pod_affinity_term, float(wt.weight), node_labels)
            for wt in pref_anti:
                if _term_matches_pod(wt.pod_affinity_term, pod, existing):
                    credit(pod, wt.pod_affinity_term, -float(wt.weight), node_labels)
            ea = existing.spec.affinity
            if ea and ea.pod_affinity:
                for term in ea.pod_affinity.required_during_scheduling_ignored_during_execution:
                    if hard_pod_affinity_weight > 0 and \
                            _term_matches_pod(term, existing, pod):
                        credit(existing, term, float(hard_pod_affinity_weight), node_labels)
                for wt in ea.pod_affinity.preferred_during_scheduling_ignored_during_execution:
                    if _term_matches_pod(wt.pod_affinity_term, existing, pod):
                        credit(existing, wt.pod_affinity_term, float(wt.weight), node_labels)
            if ea and ea.pod_anti_affinity:
                for wt in ea.pod_anti_affinity.preferred_during_scheduling_ignored_during_execution:
                    if _term_matches_pod(wt.pod_affinity_term, existing, pod):
                        credit(existing, wt.pod_affinity_term, -float(wt.weight), node_labels)

    raw: Dict[str, float] = {}
    for name, ni in (score_nodes if score_nodes is not None else node_infos).items():
        if ni.node is None:
            continue
        total = 0.0
        for (tk, tv), w in pair_weights.items():
            if ni.node.metadata.labels.get(tk) == tv:
                total += w
        raw[name] = total
    return raw


def normalize_reduce(scores: Dict[str, float], reverse: bool = False
                     ) -> Dict[str, int]:
    """Ref: priorities/reduce.go:63 NormalizeReduce(MaxPriority, reverse):
    score = MaxPriority * score / max; reversed: MaxPriority - that.
    max == 0 -> all 0 (all MaxPriority when reversed)."""
    if not scores:
        return {}
    max_v = max(scores.values())
    if max_v == 0:
        fill = MAX_PRIORITY if reverse else 0
        return {n: fill for n in scores}
    out = {}
    for name, v in scores.items():
        norm = int(MAX_PRIORITY * v / max_v)
        if reverse:
            norm = MAX_PRIORITY - norm
        out[name] = norm
    return out


def minmax_normalize(scores: Dict[str, float]) -> Dict[str, int]:
    """InterPodAffinity's in-place normalization (interpod_affinity.go:
    MaxPriority * (count - min) / (max - min); all equal -> 0)."""
    if not scores:
        return {}
    max_v = max(scores.values())
    min_v = min(scores.values())
    if max_v - min_v <= 0:
        return {n: 0 for n in scores}
    return {n: int(MAX_PRIORITY * (v - min_v) / (max_v - min_v))
            for n, v in scores.items()}


# --------------------------------------------------------- whole-cycle API

#: (name, map_fn, weight); reduce behavior is priority-specific
DEFAULT_PRIORITY_WEIGHTS = {
    "SelectorSpreadPriority": 1,
    "InterPodAffinityPriority": 1,
    "LeastRequestedPriority": 1,
    "BalancedResourceAllocation": 1,
    "NodePreferAvoidPodsPriority": 10000,
    "NodeAffinityPriority": 1,
    "TaintTolerationPriority": 1,
    "ImageLocalityPriority": 1,
}

HARD_POD_AFFINITY_WEIGHT = 1  # DefaultHardPodAffinitySymmetricWeight


def prioritize_nodes(pod: Pod, meta: PriorityMetadata,
                     node_infos: Dict[str, NodeInfo],
                     weights: Optional[Dict[str, int]] = None,
                     all_node_infos: Optional[Dict[str, NodeInfo]] = None
                     ) -> Dict[str, int]:
    """Full Map/Reduce + weighted sum for one pod over a node set
    (ref: generic_scheduler.go:672-812 PrioritizeNodes — node_infos is the
    FILTERED set the reduces normalize over; all_node_infos supplies the
    whole cluster's pods for inter-pod topology pair accumulation). Parity
    oracle for the TPU score kernel."""
    w = weights if weights is not None else DEFAULT_PRIORITY_WEIGHTS
    live = {n: ni for n, ni in node_infos.items() if ni.node is not None}
    totals: Dict[str, float] = {n: 0.0 for n in live}

    def acc(per_node: Dict[str, int], weight: int):
        for n, s in per_node.items():
            totals[n] += s * weight

    if w.get("LeastRequestedPriority"):
        acc({n: least_requested_map(pod, meta, ni) for n, ni in live.items()},
            w["LeastRequestedPriority"])
    if w.get("BalancedResourceAllocation"):
        acc({n: balanced_allocation_map(pod, meta, ni) for n, ni in live.items()},
            w["BalancedResourceAllocation"])
    if w.get("NodePreferAvoidPodsPriority"):
        acc({n: node_prefer_avoid_map(pod, meta, ni) for n, ni in live.items()},
            w["NodePreferAvoidPodsPriority"])
    if w.get("ImageLocalityPriority"):
        acc({n: image_locality_map(pod, meta, ni) for n, ni in live.items()},
            w["ImageLocalityPriority"])
    if w.get("NodeAffinityPriority"):
        raw = {n: float(node_affinity_map(pod, meta, ni)) for n, ni in live.items()}
        acc(normalize_reduce(raw), w["NodeAffinityPriority"])
    if w.get("TaintTolerationPriority"):
        raw = {n: float(taint_toleration_map(pod, meta, ni)) for n, ni in live.items()}
        acc(normalize_reduce(raw, reverse=True), w["TaintTolerationPriority"])
    if w.get("SelectorSpreadPriority"):
        counts = {n: selector_spread_map(pod, meta, ni) for n, ni in live.items()}
        acc(selector_spread_reduce(pod, meta, live, counts),
            w["SelectorSpreadPriority"])
    if w.get("InterPodAffinityPriority"):
        raw = interpod_affinity_scores(
            pod, HARD_POD_AFFINITY_WEIGHT,
            all_node_infos if all_node_infos is not None else live,
            score_nodes=live)
        acc(minmax_normalize(raw), w["InterPodAffinityPriority"])
    return {n: int(v) for n, v in totals.items()}
