"""Preemption — host-side victim search over tensor-screened candidates.

A copy of kubernetes_tpu/scheduler/preemption.py (host code, no device
calls): both the victim-pricing kernel path (kernels/preempt.py, K6) and
the serial reprieve control (KTPU_PREEMPT_KERNEL=0) use it. The
reference's description follows.

Ref: pkg/scheduler/core/generic_scheduler.go Preempt (:310-369),
selectNodesForPreemption (:996), selectVictimsOnNode (:1054-1128),
pickOneNodeForPreemption (:837-962, six tie-break criteria), and
pkg/scheduler/scheduler.go preempt (:292-380).

The reference fans the per-node victim search over 16 goroutines; here the
candidate set is cut first by the SAME cached per-node boolean vectors the
kernel uses (TermCompiler): only nodes whose pod-independent constraints
(taints, selectors, conditions, hostname) pass are examined, because those
failures are exactly the ones evicting other pods cannot fix
(ref: nodesWherePreemptionMightHelp's unresolvable-reason list). A second
O(pods-on-node) resource screen — could evicting every lower-priority pod
even free enough? — runs before any NodeInfo clone, so the expensive
clone + full-predicate reprieve loop touches only plausible nodes.

Victim selection is inherently serial per node (the reprieve loop's fit
checks depend on prior re-adds), so it stays on host, consuming the python
predicate oracle (predicates.py) — the same functions the kernel is
parity-tested against.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..api import helpers, labels as labelsmod
from ..api.core import Pod
from ..api.policy import PodDisruptionBudget
from . import predicates as preds
from .nodeinfo import NodeInfo, pod_resource


@dataclass
class PreemptionPlan:
    node_name: str
    victims: List[Pod]
    num_pdb_violations: int
    # nominated pods on node_name with lower priority whose nomination the
    # shell must clear (ref: getLowerPriorityNominatedPods, :371-388)
    nominated_to_clear: List[Pod] = field(default_factory=list)


@dataclass
class GangPreemptionPlan:
    """Whole-gang preemption (kernels/preempt.py price_domains): evict
    `victims` (whole PodGroups expanded) and nominate each member to its
    node inside the winning ICI domain — the freed space is shielded by
    the nominated-reservation overlay until the gang binds."""
    domain: str
    victims: List[Pod]
    nominations: List[Tuple[Pod, str]]   # (member, node name)
    num_pdb_violations: int


def pod_eligible_to_preempt_others(pod: Pod,
                                   node_infos: Dict[str, NodeInfo]) -> bool:
    """Ref: podEligibleToPreemptOthers (:1130-1150) — a pod that already
    preempted (nominated node set) must wait while its victims terminate."""
    nn = pod.status.nominated_node_name
    if not nn:
        return True
    ni = node_infos.get(nn)
    if ni is None:
        return True
    prio = helpers.pod_priority(pod)
    for p in ni.pods:
        if p.metadata.deletion_timestamp is not None and \
                helpers.pod_priority(p) < prio:
            return False
    return True


def _more_important(p: Pod) -> Tuple[int, str]:
    """Sort key: higher priority first, then earlier start
    (ref: pkg/scheduler/util.MoreImportantPod)."""
    return (-helpers.pod_priority(p), p.status.start_time or "")


def filter_pods_with_pdb_violation(pods: Sequence[Pod],
                                   pdbs: Sequence[PodDisruptionBudget]
                                   ) -> Tuple[List[Pod], List[Pod]]:
    """Split would-be victims into (violating, non_violating) with cumulative
    per-PDB accounting (ref: filterPodsWithPDBViolation :964-994): each
    non-violating eviction consumes one disruptionsAllowed."""
    allowed = {id(pdb): pdb.status.disruptions_allowed for pdb in pdbs}
    violating: List[Pod] = []
    ok: List[Pod] = []
    for pod in pods:
        matched = []
        for pdb in pdbs:
            if pdb.metadata.namespace != pod.metadata.namespace:
                continue
            sel = pdb.spec.selector
            if sel is None or not labelsmod.matches(sel, pod.metadata.labels):
                continue
            matched.append(pdb)
        if any(allowed[id(p)] <= 0 for p in matched):
            violating.append(pod)
        else:
            for p in matched:
                allowed[id(p)] -= 1
            ok.append(pod)
    return violating, ok


def select_victims_on_node(pod: Pod, ni: NodeInfo,
                           node_infos: Dict[str, NodeInfo],
                           fits: Callable[[Pod, preds.PredicateMetadata,
                                           NodeInfo], bool],
                           pdbs: Sequence[PodDisruptionBudget],
                           base_meta: Optional[preds.PredicateMetadata] = None
                           ) -> Optional[Tuple[List[Pod], int]]:
    """Ref: selectVictimsOnNode (:1054-1128). Remove every lower-priority
    pod; if the preemptor still doesn't fit, the node is hopeless. Otherwise
    reprieve pods one at a time — most important first, PDB-violating pods
    first so as many of them as possible are spared — keeping each one that
    doesn't break the fit. Returns (victims, numPDBViolations) or None.

    `base_meta` is the preemptor's cluster-wide metadata, built ONCE by the
    caller and cloned here per candidate node (ref: selectNodesForPreemption
    metaCopy) — rebuilding it per node would rescan every pod in the
    cluster for each candidate."""
    prio = helpers.pod_priority(pod)
    potential = [p for p in ni.pods if helpers.pod_priority(p) < prio]
    if not potential:
        return None
    ni = ni.clone()
    meta = base_meta.clone() if base_meta is not None \
        else preds.PredicateMetadata(pod, node_infos)
    for v in potential:
        ni.remove_pod(v)
        meta.remove_pod(v, ni)
    if not fits(pod, meta, ni):
        return None
    potential.sort(key=_more_important)
    violating, non_violating = filter_pods_with_pdb_violation(potential, pdbs)
    victims: List[Pod] = []

    def reprieve(p: Pod) -> bool:
        ni.add_pod(p)
        meta.add_pod(p, ni)
        if fits(pod, meta, ni):
            return True
        ni.remove_pod(p)
        meta.remove_pod(p, ni)
        victims.append(p)
        return False

    num_violations = sum(0 if reprieve(p) else 1 for p in violating)
    for p in non_violating:
        reprieve(p)
    if not victims:
        # everything was reprieved: the preemptor fit all along; scheduling
        # (not preemption) should have placed it — treat as no-op candidate
        return None
    return victims, num_violations


def pick_one_node_for_preemption(
        nodes_to_victims: Dict[str, Tuple[List[Pod], int]]) -> Optional[str]:
    """Ref: pickOneNodeForPreemption (:837-962) — six criteria applied in
    order, each narrowing the candidate list:
      1. fewest PDB violations
      2. lowest highest-victim priority
      3. smallest sum of victim priorities
      4. fewest victims
      5. latest start time among each node's highest-priority victims
      6. first remaining
    """
    if not nodes_to_victims:
        return None
    candidates = list(nodes_to_victims.keys())

    def narrow(key_fn, minimize=True):
        nonlocal candidates
        if len(candidates) == 1:
            return
        vals = {n: key_fn(*nodes_to_victims[n]) for n in candidates}
        best = min(vals.values()) if minimize else max(vals.values())
        candidates = [n for n in candidates if vals[n] == best]

    narrow(lambda v, nviol: nviol)
    narrow(lambda v, _: max(helpers.pod_priority(p) for p in v))
    narrow(lambda v, _: sum(helpers.pod_priority(p) for p in v))
    narrow(lambda v, _: len(v))

    def latest_high_priority_start(v: List[Pod], _) -> str:
        hi = max(helpers.pod_priority(p) for p in v)
        return max((p.status.start_time or "")
                   for p in v if helpers.pod_priority(p) == hi)
    narrow(latest_high_priority_start, minimize=False)
    return candidates[0]


def nominated_pods_to_clear(pod: Pod, node_name: str,
                            nominated_on_node: Sequence[Pod]) -> List[Pod]:
    """Lower-priority pods nominated to the chosen node lose their
    nomination — their space estimate is invalidated by the eviction
    (ref: getLowerPriorityNominatedPods :371-388)."""
    prio = helpers.pod_priority(pod)
    return [p for p in nominated_on_node
            if helpers.pod_priority(p) < prio]


def node_could_ever_fit(pod: Pod, ni: NodeInfo) -> bool:
    """Could the pod fit on this node with NOTHING else running? Used to
    decide whether a standing nomination is still worth waiting on."""
    req = pod_resource(pod)
    alloc = ni.allocatable
    return (req.milli_cpu <= alloc.milli_cpu
            and req.memory <= alloc.memory
            and alloc.allowed_pod_number >= 1)


def resource_screen(pod: Pod, ni: NodeInfo) -> bool:
    """Cheap pre-clone check: with EVERY lower-priority pod evicted, could
    the preemptor's resources fit? O(pods-on-node), no clones."""
    prio = helpers.pod_priority(pod)
    freed_cpu = freed_mem = 0
    freed_count = 0
    for p in ni.pods:
        if helpers.pod_priority(p) < prio:
            r = pod_resource(p)
            freed_cpu += r.milli_cpu
            freed_mem += r.memory
            freed_count += 1
    if freed_count == 0:
        return False
    req = pod_resource(pod)
    alloc = ni.allocatable
    used = ni.requested
    if req.milli_cpu > alloc.milli_cpu - used.milli_cpu + freed_cpu:
        return False
    if req.memory > alloc.memory - used.memory + freed_mem:
        return False
    if len(ni.pods) - freed_count + 1 > alloc.allowed_pod_number:
        return False
    return True
