"""Semantic helpers over the API types.

Pod resource accounting follows the reference exactly:
GetResourceRequest = sum over containers + max over init containers + overhead
(ref: pkg/scheduler/nodeinfo/node_info.go CalculateResource via
pkg/apis/core/v1/resource helpers, and predicates.go GetResourceRequest).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from . import wellknown
from .core import Node, NodeSelector, NodeSelectorRequirement, NodeSelectorTerm, Pod, Taint, Toleration
from .quantity import Quantity

#: priority given to pods with no explicit priority (ref: scheduling api
#: DefaultPriorityWhenNoDefaultClassExists = 0)
DEFAULT_POD_PRIORITY = 0


def pod_priority(pod: Pod) -> int:
    """Ref: pkg/scheduler/util.GetPodPriority."""
    if pod.spec.priority is not None:
        return pod.spec.priority
    return DEFAULT_POD_PRIORITY


def pod_requests(pod: Pod) -> Dict[str, int]:
    """Aggregate resource requests in scheduler units: cpu in millicores,
    memory/ephemeral-storage in bytes, other resources in integer units
    (extended resources are whole numbers; hugepages in bytes).

    sum(containers) elementwise-max max(initContainers), plus overhead.
    Ref: nodeinfo.CalculateResource (node_info.go:443-470).

    Memoized per PodSpec (requests are immutable once created; the memo
    rides along on shallow bind clones, which share containers). Callers
    must treat the returned dict as read-only.
    """
    spec = pod.spec
    cached = spec.__dict__.get("_req_cache")
    if cached is not None:
        return cached
    totals: Dict[str, int] = {}
    for c in pod.spec.containers:
        for name, q in c.resources.requests.items():
            totals[name] = totals.get(name, 0) + _scheduler_units(name, q)
    for c in pod.spec.init_containers:
        for name, q in c.resources.requests.items():
            v = _scheduler_units(name, q)
            if v > totals.get(name, 0):
                totals[name] = v
    for name, q in pod.spec.overhead.items():
        totals[name] = totals.get(name, 0) + _scheduler_units(name, q)
    spec.__dict__["_req_cache"] = totals
    return totals


def pod_limits(pod: Pod) -> Dict[str, int]:
    totals: Dict[str, int] = {}
    for c in pod.spec.containers:
        for name, q in c.resources.limits.items():
            totals[name] = totals.get(name, 0) + _scheduler_units(name, q)
    return totals


def _scheduler_units(name: str, q: Quantity) -> int:
    if name == wellknown.RESOURCE_CPU:
        return q.milli_value()
    return q.value()


#: default requests credited for pods that specify none, so 0-request pods
#: still occupy capacity in spreading scores (ref: priorities/util/non_zero.go
#: DefaultMilliCPURequest=100, DefaultMemoryRequest=200Mi)
DEFAULT_MILLI_CPU_REQUEST = 100
DEFAULT_MEMORY_REQUEST = 200 * 1024 * 1024


def pod_requests_nonzero(pod: Pod) -> Dict[str, int]:
    r = pod_requests(pod)
    out = dict(r)
    if out.get(wellknown.RESOURCE_CPU, 0) == 0:
        out[wellknown.RESOURCE_CPU] = DEFAULT_MILLI_CPU_REQUEST
    if out.get(wellknown.RESOURCE_MEMORY, 0) == 0:
        out[wellknown.RESOURCE_MEMORY] = DEFAULT_MEMORY_REQUEST
    return out


def node_allocatable(node: Node) -> Dict[str, int]:
    alloc = node.status.allocatable or node.status.capacity
    return {name: _scheduler_units(name, q) for name, q in alloc.items()}


def pod_host_ports(pod: Pod) -> List[tuple]:
    """(protocol, hostIP, hostPort) triples (ref: host_ports.go).
    Memoized per PodSpec; treat the returned list as read-only."""
    spec = pod.spec
    cached = spec.__dict__.get("_ports_cache")
    if cached is not None:
        return cached
    out = []
    for c in spec.containers:
        for p in c.ports:
            if p.host_port > 0:
                out.append((p.protocol or "TCP", p.host_ip or "0.0.0.0", p.host_port))
    spec.__dict__["_ports_cache"] = out
    return out


def tolerates_taints(tolerations: List[Toleration], taints: List[Taint],
                     effects: Optional[List[str]] = None) -> bool:
    """All taints (with an effect in `effects`, default NoSchedule+NoExecute
    for scheduling) must be tolerated.
    Ref: v1helper.TolerationsTolerateTaintsWithFilter."""
    for taint in taints:
        if effects is not None and taint.effect not in effects:
            continue
        if not any(t.tolerates(taint) for t in tolerations):
            return False
    return True


def untolerated_taints(tolerations: List[Toleration], taints: List[Taint],
                       effects: List[str]) -> List[Taint]:
    return [taint for taint in taints
            if taint.effect in effects
            and not any(t.tolerates(taint) for t in tolerations)]


def match_node_selector_terms(terms: List[NodeSelectorTerm], node: Node) -> bool:
    """OR of terms, AND of a term's expressions; empty term list matches nothing.
    Ref: v1helper.MatchNodeSelectorTerms."""
    from . import labels as labelsmod
    from .meta import LabelSelectorRequirement

    for term in terms:
        if not term.match_expressions and not term.match_fields:
            continue
        ok = True
        for req in term.match_expressions:
            lreq = LabelSelectorRequirement(key=req.key, operator=req.operator,
                                            values=req.values)
            if not labelsmod.match_requirement(lreq, node.metadata.labels):
                ok = False
                break
        if ok:
            for req in term.match_fields:
                # only metadata.name is a supported field selector (ref:
                # nodeFieldSelectorKeys in predicates.go)
                if req.key != "metadata.name":
                    ok = False
                    break
                lreq = LabelSelectorRequirement(key="metadata.name",
                                                operator=req.operator,
                                                values=req.values)
                if not labelsmod.match_requirement(lreq, {"metadata.name": node.metadata.name}):
                    ok = False
                    break
        if ok:
            return True
    return False


def pod_matches_node_selector_and_affinity(pod: Pod, node: Node) -> bool:
    """nodeSelector AND required node affinity
    (ref: predicates.go podMatchesNodeSelectorAndAffinityTerms)."""
    for k, v in pod.spec.node_selector.items():
        if node.metadata.labels.get(k) != v:
            return False
    aff = pod.spec.affinity
    if aff and aff.node_affinity and \
            aff.node_affinity.required_during_scheduling_ignored_during_execution is not None:
        sel = aff.node_affinity.required_during_scheduling_ignored_during_execution
        if not match_node_selector_terms(sel.node_selector_terms, node):
            return False
    return True


def is_node_ready(node: Node) -> bool:
    for cond in node.status.conditions:
        if cond.type == "Ready":
            return cond.status == "True"
    return False


def pod_is_terminal(pod: Pod) -> bool:
    return pod.status.phase in ("Succeeded", "Failed")


def pod_qos(pod: Pod) -> str:
    """Ref: pkg/apis/core/v1/helper/qos.GetPodQOS — the ONE QoS
    classifier (scheduler predicates, admission scopes and kubelet
    eviction all consume this; diverging copies would class the same pod
    differently per subsystem)."""
    requests: Dict[str, int] = {}
    limits: Dict[str, int] = {}
    guaranteed = True
    for c in pod.spec.containers:
        for name, q in c.resources.requests.items():
            if name in (wellknown.RESOURCE_CPU, wellknown.RESOURCE_MEMORY):
                requests[name] = requests.get(name, 0) + q.value()
        for name, q in c.resources.limits.items():
            if name in (wellknown.RESOURCE_CPU, wellknown.RESOURCE_MEMORY):
                limits[name] = limits.get(name, 0) + q.value()
        cl = {n for n in c.resources.limits
              if n in (wellknown.RESOURCE_CPU, wellknown.RESOURCE_MEMORY)}
        if cl != {wellknown.RESOURCE_CPU, wellknown.RESOURCE_MEMORY}:
            guaranteed = False
    if not requests and not limits:
        return "BestEffort"
    if guaranteed and requests == limits:
        return "Guaranteed"
    return "Burstable"
