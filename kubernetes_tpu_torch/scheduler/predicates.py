"""Filter predicates — python semantic reference.

Ref: pkg/scheduler/algorithm/predicates/{predicates.go (1,706 LoC),
metadata.go, csi_volume_predicate.go}. The default provider registers 14
(algorithmprovider/defaults/defaults.go:40-56); evaluation order is
predicates.Ordering() (predicates.go:143-149).

On TPU the same semantics run as a pods x nodes mask kernel
(tensorize.py + kernels/batch.py); these functions are the parity oracle
and the host path
for preemption's AddPod/RemovePod incremental re-evaluation.

Each predicate: (pod, meta, node_info) -> (fits: bool, reasons: list[str]).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Set, Tuple

from ..api import helpers, labels as labelsmod, wellknown
from ..api.core import Pod, PodAffinityTerm
from .nodeinfo import NodeInfo, Resource, pod_resource

# failure reasons (ref: predicates/error.go)
ERR_INSUFFICIENT = "Insufficient {}"
ERR_POD_COUNT = "Too many pods"
ERR_NODE_SELECTOR = "node(s) didn't match node selector"
ERR_HOST = "node(s) didn't match the requested hostname"
ERR_PORTS = "node(s) didn't have free ports for the requested pod ports"
ERR_TAINTS = "node(s) had taints that the pod didn't tolerate"
ERR_MEMORY_PRESSURE = "node(s) had memory pressure"
ERR_DISK_PRESSURE = "node(s) had disk pressure"
ERR_PID_PRESSURE = "node(s) had pid pressure"
ERR_NODE_CONDITION = "node(s) had condition"
ERR_UNSCHEDULABLE = "node(s) were unschedulable"
ERR_AFFINITY = "node(s) didn't match pod affinity rules"
ERR_ANTI_AFFINITY = "node(s) didn't satisfy existing pods anti-affinity rules"
ERR_DISK_CONFLICT = "node(s) had no available disk"
ERR_VOLUME_ZONE = "node(s) had no available volume zone"
ERR_VOLUME_BIND = "node(s) had volume node affinity conflict"


class PredicateMetadata:
    """Per-pod precompute shared across all nodes in one cycle
    (ref: metadata.go:71-94 predicateMetadata)."""

    def __init__(self, pod: Pod, all_node_infos: Dict[str, NodeInfo]):
        self.pod = pod
        self.pod_request = pod_resource(pod)
        self.pod_ports = helpers.pod_host_ports(pod)
        # scratch for predicates to stash pod-invariant precomputes that are
        # reused across the node loop (e.g. Max*VolumeCount wanted-sets,
        # which resolve PVC->PV through listers once per pod, not per node)
        self.memo: Dict[object, object] = {}
        # topology pair -> set of existing pod keys whose anti-affinity terms
        # match this (incoming) pod, i.e. pairs forbidden for the pod
        # (ref: topologyPairsAntiAffinityPodsMap)
        self.anti_affinity_pairs: Set[Tuple[str, str]] = set()
        # for the pod's own (anti)affinity terms: per term, the set of
        # topology pairs where matching pods exist
        self.affinity_term_pairs: List[Tuple[PodAffinityTerm, Set[Tuple[str, str]]]] = []
        self.anti_term_pairs: List[Tuple[PodAffinityTerm, Set[Tuple[str, str]]]] = []
        self._compute_topology_maps(all_node_infos)

    def _compute_topology_maps(self, all_node_infos: Dict[str, NodeInfo]) -> None:
        pod = self.pod
        aff = pod.spec.affinity
        own_aff_terms = _required_terms(
            aff.pod_affinity.required_during_scheduling_ignored_during_execution
            if aff and aff.pod_affinity else [])
        own_anti_terms = _required_terms(
            aff.pod_anti_affinity.required_during_scheduling_ignored_during_execution
            if aff and aff.pod_anti_affinity else [])
        aff_pairs: List[Set[Tuple[str, str]]] = [set() for _ in own_aff_terms]
        anti_pairs: List[Set[Tuple[str, str]]] = [set() for _ in own_anti_terms]
        for ni in all_node_infos.values():
            if ni.node is None:
                continue
            node_labels = ni.node.metadata.labels
            for existing in ni.pods:
                # existing pods' anti-affinity vs the incoming pod
                ea = existing.spec.affinity
                if ea and ea.pod_anti_affinity:
                    for term in _required_terms(
                            ea.pod_anti_affinity.required_during_scheduling_ignored_during_execution):
                        if _term_matches_pod(term, existing, pod) and \
                                term.topology_key in node_labels:
                            self.anti_affinity_pairs.add(
                                (term.topology_key, node_labels[term.topology_key]))
                # incoming pod's terms vs existing pods
                for i, term in enumerate(own_aff_terms):
                    if _term_matches_pod(term, pod, existing) and \
                            term.topology_key in node_labels:
                        aff_pairs[i].add((term.topology_key, node_labels[term.topology_key]))
                for i, term in enumerate(own_anti_terms):
                    if _term_matches_pod(term, pod, existing) and \
                            term.topology_key in node_labels:
                        anti_pairs[i].add((term.topology_key, node_labels[term.topology_key]))
        self.affinity_term_pairs = list(zip(own_aff_terms, aff_pairs))
        self.anti_term_pairs = list(zip(own_anti_terms, anti_pairs))

    def clone(self) -> "PredicateMetadata":
        """Ref: metadata.go ShallowCopy — preemption's per-candidate-node
        what-if mutations need an isolated copy without re-scanning the
        cluster's topology maps."""
        c = object.__new__(PredicateMetadata)
        c.pod = self.pod
        c.pod_request = self.pod_request
        c.pod_ports = self.pod_ports
        c.memo = dict(self.memo)
        c.anti_affinity_pairs = set(self.anti_affinity_pairs)
        c.affinity_term_pairs = [(t, set(p)) for t, p in self.affinity_term_pairs]
        c.anti_term_pairs = [(t, set(p)) for t, p in self.anti_term_pairs]
        return c

    # incremental update for preemption what-if evaluation (ref: metadata.go
    # AddPod/RemovePod)
    def remove_pod(self, deleted: Pod, node_info: NodeInfo) -> None:
        self._adjust(deleted, node_info, add=False)

    def add_pod(self, added: Pod, node_info: NodeInfo) -> None:
        self._adjust(added, node_info, add=True)

    def _adjust(self, other: Pod, node_info: NodeInfo, add: bool) -> None:
        if node_info.node is None:
            return
        node_labels = node_info.node.metadata.labels
        oa = other.spec.affinity
        if oa and oa.pod_anti_affinity:
            for term in _required_terms(
                    oa.pod_anti_affinity.required_during_scheduling_ignored_during_execution):
                if _term_matches_pod(term, other, self.pod) and \
                        term.topology_key in node_labels:
                    pair = (term.topology_key, node_labels[term.topology_key])
                    if add:
                        self.anti_affinity_pairs.add(pair)
                    else:
                        # conservative: a full recompute would check whether
                        # another pod still pins this pair; preemption removes
                        # victims from one node only, where this is exact if
                        # no other pod on the node matches
                        still = any(
                            _term_matches_pod(t, p, self.pod) and
                            t.topology_key == pair[0] and
                            node_labels.get(t.topology_key) == pair[1]
                            for p in node_info.pods
                            if p.metadata.key() != other.metadata.key()
                            and p.spec.affinity and p.spec.affinity.pod_anti_affinity
                            for t in _required_terms(
                                p.spec.affinity.pod_anti_affinity.required_during_scheduling_ignored_during_execution))
                        if not still:
                            self.anti_affinity_pairs.discard(pair)
        for term, pairs in self.affinity_term_pairs + self.anti_term_pairs:
            if _term_matches_pod(term, self.pod, other) and \
                    term.topology_key in node_labels:
                pair = (term.topology_key, node_labels[term.topology_key])
                if add:
                    pairs.add(pair)
                # removal from term pairs is handled conservatively the same way


def _required_terms(terms: List[PodAffinityTerm]) -> List[PodAffinityTerm]:
    return [t for t in terms if t is not None]


def _term_matches_pod(term: PodAffinityTerm, term_owner: Pod, candidate: Pod) -> bool:
    """Does `candidate` match `term` of `term_owner`? Namespace semantics:
    empty namespaces list means the term-owner's namespace
    (ref: priorityutil.PodMatchesTermsNamespaceAndSelector)."""
    namespaces = term.namespaces or [term_owner.metadata.namespace]
    if candidate.metadata.namespace not in namespaces:
        return False
    return labelsmod.matches(term.label_selector, candidate.metadata.labels)


# ------------------------------------------------------------ predicates

def pod_fits_resources(pod: Pod, meta: PredicateMetadata, ni: NodeInfo
                       ) -> Tuple[bool, List[str]]:
    """Ref: predicates.go:769-840 PodFitsResources."""
    reasons: List[str] = []
    alloc = ni.allocatable
    if len(ni.pods) + 1 > alloc.allowed_pod_number:
        reasons.append(ERR_POD_COUNT)
    req = meta.pod_request if meta is not None else pod_resource(pod)
    if req.milli_cpu == 0 and req.memory == 0 and req.ephemeral_storage == 0 \
            and not req.scalar_resources:
        return len(reasons) == 0, reasons
    if req.milli_cpu > alloc.milli_cpu - ni.requested.milli_cpu:
        reasons.append(ERR_INSUFFICIENT.format("cpu"))
    if req.memory > alloc.memory - ni.requested.memory:
        reasons.append(ERR_INSUFFICIENT.format("memory"))
    if req.ephemeral_storage > alloc.ephemeral_storage - ni.requested.ephemeral_storage:
        reasons.append(ERR_INSUFFICIENT.format("ephemeral-storage"))
    for name, v in req.scalar_resources.items():
        if v > alloc.scalar_resources.get(name, 0) - ni.requested.scalar_resources.get(name, 0):
            reasons.append(ERR_INSUFFICIENT.format(name))
    return len(reasons) == 0, reasons


def pod_fits_host(pod: Pod, meta: PredicateMetadata, ni: NodeInfo
                  ) -> Tuple[bool, List[str]]:
    """Ref: predicates.go PodFitsHost."""
    if not pod.spec.node_name:
        return True, []
    if ni.node is not None and pod.spec.node_name == ni.node.metadata.name:
        return True, []
    return False, [ERR_HOST]


def pod_fits_host_ports(pod: Pod, meta: PredicateMetadata, ni: NodeInfo
                        ) -> Tuple[bool, List[str]]:
    """Ref: predicates.go PodFitsHostPorts + host_ports.go CheckConflict
    (wildcard 0.0.0.0 conflicts with any IP on same proto/port)."""
    wanted = meta.pod_ports if meta is not None else helpers.pod_host_ports(pod)
    if not wanted:
        return True, []
    for proto, ip, port in wanted:
        for uproto, uip, uport in ni.used_ports:
            if proto != uproto or port != uport:
                continue
            if ip == uip or ip == "0.0.0.0" or uip == "0.0.0.0":
                return False, [ERR_PORTS]
    return True, []


def pod_match_node_selector(pod: Pod, meta: PredicateMetadata, ni: NodeInfo
                            ) -> Tuple[bool, List[str]]:
    """Ref: predicates.go PodMatchNodeSelector."""
    if ni.node is None:
        return False, [ERR_NODE_SELECTOR]
    if helpers.pod_matches_node_selector_and_affinity(pod, ni.node):
        return True, []
    return False, [ERR_NODE_SELECTOR]


def pod_tolerates_node_taints(pod: Pod, meta: PredicateMetadata, ni: NodeInfo
                              ) -> Tuple[bool, List[str]]:
    """Ref: predicates.go PodToleratesNodeTaints — only NoSchedule/NoExecute
    matter for scheduling."""
    if helpers.tolerates_taints(pod.spec.tolerations, ni.taints,
                                effects=["NoSchedule", "NoExecute"]):
        return True, []
    return False, [ERR_TAINTS]


def check_node_unschedulable(pod: Pod, meta: PredicateMetadata, ni: NodeInfo
                             ) -> Tuple[bool, List[str]]:
    """Ref: CheckNodeConditionPredicate's unschedulable spec field part."""
    if ni.node is not None and ni.node.spec.unschedulable:
        return False, [ERR_UNSCHEDULABLE]
    return True, []


def check_node_condition(pod: Pod, meta: PredicateMetadata, ni: NodeInfo
                         ) -> Tuple[bool, List[str]]:
    """Ref: predicates.go CheckNodeConditionPredicate — NotReady,
    NetworkUnavailable, or unschedulable fail."""
    if ni.node is None:
        return False, [ERR_NODE_CONDITION]
    reasons = []
    for cond in ni.node.status.conditions:
        if cond.type == "Ready" and cond.status != "True":
            reasons.append(ERR_NODE_CONDITION)
        elif cond.type == "NetworkUnavailable" and cond.status == "True":
            reasons.append(ERR_NODE_CONDITION)
    if ni.node.spec.unschedulable:
        reasons.append(ERR_UNSCHEDULABLE)
    return len(reasons) == 0, reasons


def check_node_memory_pressure(pod: Pod, meta: PredicateMetadata, ni: NodeInfo
                               ) -> Tuple[bool, List[str]]:
    """Ref: CheckNodeMemoryPressurePredicate — only BestEffort pods blocked,
    unless they tolerate the memory-pressure taint."""
    if not ni.memory_pressure:
        return True, []
    if _pod_qos(pod) != "BestEffort":
        return True, []
    if helpers.tolerates_taints(
            pod.spec.tolerations,
            [_pressure_taint(wellknown.TAINT_NODE_MEMORY_PRESSURE)],
            effects=["NoSchedule"]):
        return True, []
    return False, [ERR_MEMORY_PRESSURE]


def check_node_disk_pressure(pod: Pod, meta: PredicateMetadata, ni: NodeInfo
                             ) -> Tuple[bool, List[str]]:
    if not ni.disk_pressure:
        return True, []
    return False, [ERR_DISK_PRESSURE]


def check_node_pid_pressure(pod: Pod, meta: PredicateMetadata, ni: NodeInfo
                            ) -> Tuple[bool, List[str]]:
    if not ni.pid_pressure:
        return True, []
    return False, [ERR_PID_PRESSURE]


def no_disk_conflict(pod: Pod, meta: PredicateMetadata, ni: NodeInfo
                     ) -> Tuple[bool, List[str]]:
    """Ref: predicates.go NoDiskConflict — GCE PD / EBS / RBD / ISCSI volumes
    may not be mounted read-write by two pods on one node."""
    for vol in pod.spec.volumes:
        for existing in ni.pods:
            for evol in existing.spec.volumes:
                if _disks_conflict(vol, evol):
                    return False, [ERR_DISK_CONFLICT]
    return True, []


def _disks_conflict(v1, v2) -> bool:
    if v1.gce_persistent_disk and v2.gce_persistent_disk:
        if v1.gce_persistent_disk.get("pdName") == v2.gce_persistent_disk.get("pdName"):
            if not (v1.gce_persistent_disk.get("readOnly") and
                    v2.gce_persistent_disk.get("readOnly")):
                return True
    if v1.aws_elastic_block_store and v2.aws_elastic_block_store:
        if v1.aws_elastic_block_store.get("volumeID") == \
                v2.aws_elastic_block_store.get("volumeID"):
            return True
    if v1.rbd and v2.rbd:
        if (v1.rbd.get("monitors"), v1.rbd.get("image"), v1.rbd.get("pool")) == \
                (v2.rbd.get("monitors"), v2.rbd.get("image"), v2.rbd.get("pool")):
            return True
    if v1.iscsi and v2.iscsi:
        if (v1.iscsi.get("targetPortal"), v1.iscsi.get("iqn")) == \
                (v2.iscsi.get("targetPortal"), v2.iscsi.get("iqn")):
            return True
    return False


def match_inter_pod_affinity(pod: Pod, meta: PredicateMetadata, ni: NodeInfo
                             ) -> Tuple[bool, List[str]]:
    """Ref: predicates.go InterPodAffinityMatches via topologyPairsMaps:
    1. no existing pod's anti-affinity forbids this node's topology pairs
    2. every required affinity term of the pod has a matching pod in this
       node's topology (or, per the reference's special case, the term matches
       the incoming pod itself and no pod anywhere matches it yet)
    3. the pod's own anti-affinity terms have no match in this topology
    """
    if ni.node is None:
        return False, [ERR_AFFINITY]
    node_labels = ni.node.metadata.labels
    for tk, tv in meta.anti_affinity_pairs:
        if node_labels.get(tk) == tv:
            return False, [ERR_ANTI_AFFINITY]
    for term, pairs in meta.affinity_term_pairs:
        tk = term.topology_key
        if tk not in node_labels:
            return False, [ERR_AFFINITY]
        if (tk, node_labels[tk]) not in pairs:
            # special case (predicates.go:1476-1497): the term matches the
            # incoming pod itself and matches no existing pod anywhere
            if not pairs and _term_matches_pod(term, pod, pod):
                continue
            return False, [ERR_AFFINITY]
    for term, pairs in meta.anti_term_pairs:
        tk = term.topology_key
        if tk in node_labels and (tk, node_labels[tk]) in pairs:
            return False, [ERR_ANTI_AFFINITY]
    return True, []


def no_volume_zone_conflict_factory(pvc_lister, pv_lister, sc_lister=None):
    """Ref: predicates.go NewVolumeZonePredicate — a bound PV's zone/region
    labels must match the node's."""
    zone_labels = (wellknown.LABEL_ZONE, wellknown.LABEL_REGION)

    def predicate(pod: Pod, meta: PredicateMetadata, ni: NodeInfo
                  ) -> Tuple[bool, List[str]]:
        if ni.node is None:
            return False, [ERR_VOLUME_ZONE]
        node_labels = ni.node.metadata.labels
        for vol in pod.spec.volumes:
            if not vol.persistent_volume_claim:
                continue
            pvc = pvc_lister(pod.metadata.namespace, vol.persistent_volume_claim.claim_name)
            if pvc is None or not pvc.spec.volume_name:
                continue
            pv = pv_lister(pvc.spec.volume_name)
            if pv is None:
                continue
            for lk in zone_labels:
                lv = pv.metadata.labels.get(lk)
                if lv is None:
                    continue
                # PV zone labels may hold __ -separated sets (volume helpers)
                allowed = set(lv.split("__"))
                if node_labels.get(lk) not in allowed:
                    return False, [ERR_VOLUME_ZONE]
        return True, []

    return predicate


def check_volume_binding_factory(volume_binder):
    """Ref: predicates.go NewVolumeBindingPredicate → FindPodVolumes."""
    def predicate(pod: Pod, meta: PredicateMetadata, ni: NodeInfo
                  ) -> Tuple[bool, List[str]]:
        if ni.node is None:
            return False, [ERR_VOLUME_BIND]
        ok = volume_binder.find_pod_volumes(pod, ni.node)
        return (True, []) if ok else (False, [ERR_VOLUME_BIND])
    return predicate


def max_volume_count_factory(filter_fn: Callable, max_volumes: int,
                             pvc_lister=None):
    """Ref: predicates.go MaxPDVolumeCountChecker — EBS/GCEPD/AzureDisk and
    csi_volume_predicate.go. filter_fn(volume, pod_namespace) returns a unique
    volume id or None."""
    memo_key = object()  # unique per factory instance

    def predicate(pod: Pod, meta: PredicateMetadata, ni: NodeInfo
                  ) -> Tuple[bool, List[str]]:
        memo = getattr(meta, "memo", None) if meta is not None else None
        wanted: Optional[Set[str]] = \
            memo.get(memo_key) if memo is not None else None
        if wanted is None:
            wanted = set()
            for vol in pod.spec.volumes:
                vid = filter_fn(vol, pod.metadata.namespace)
                if vid is not None:
                    wanted.add(vid)
            if memo is not None:
                memo[memo_key] = wanted
        if not wanted:
            return True, []
        existing: Set[str] = set()
        for p in ni.pods:
            for vol in p.spec.volumes:
                vid = filter_fn(vol, p.metadata.namespace)
                if vid is not None:
                    existing.add(vid)
        if len(existing | wanted) > max_volumes:
            return False, ["node(s) exceed max volume count"]
        return True, []
    return predicate


# Ref: predicates.go DefaultMaxEBSVolumes / DefaultMaxGCEPDVolumes /
# getMaxAzureDiskVolumes (KUBE_MAX_PD_VOLS env override not carried over)
DEFAULT_MAX_EBS_VOLUMES = 39
DEFAULT_MAX_GCE_PD_VOLUMES = 16
DEFAULT_MAX_AZURE_DISK_VOLUMES = 16


def pd_volume_filter_factory(attr: str, id_keys: Tuple[str, ...],
                             pvc_lister=None, pv_lister=None) -> Callable:
    """A max_volume_count_factory filter for one PD flavor: matches direct
    volume sources and PVC-referenced PVs of that flavor (ref: predicates.go
    EBSVolumeFilter/GCEPDVolumeFilter/AzureDiskVolumeFilter — FilterVolume +
    FilterPersistentVolume)."""
    def _vid(src: Optional[dict]) -> Optional[str]:
        if not src:
            return None
        for k in id_keys:
            v = src.get(k)
            if v:
                return f"{attr}:{v}"
        return None

    def filter_fn(vol, ns: str) -> Optional[str]:
        vid = _vid(getattr(vol, attr, None))
        if vid is not None:
            return vid
        ref = vol.persistent_volume_claim
        if ref and pvc_lister is not None and pv_lister is not None:
            pvc = pvc_lister(ns, ref.claim_name)
            if pvc is not None and pvc.spec.volume_name:
                pv = pv_lister(pvc.spec.volume_name)
                if pv is not None:
                    return _vid(getattr(pv.spec, attr, None))
        return None
    return filter_fn


def csi_max_volume_count_factory(pvc_lister=None, pv_lister=None) -> Callable:
    """Ref: csi_volume_predicate.go CSIMaxVolumeLimitChecker — per-driver
    attach limits read from node allocatable `attachable-volumes-csi-<driver>`
    scalars; CSI volumes reach pods only through PVCs."""
    def _driver_handle(vol, ns: str) -> Optional[Tuple[str, str]]:
        ref = vol.persistent_volume_claim
        if not ref or pvc_lister is None or pv_lister is None:
            return None
        pvc = pvc_lister(ns, ref.claim_name)
        if pvc is None or not pvc.spec.volume_name:
            return None
        pv = pv_lister(pvc.spec.volume_name)
        if pv is None or not pv.spec.csi:
            return None
        drv = pv.spec.csi.get("driver")
        if not drv:
            return None
        return drv, pv.spec.csi.get("volumeHandle", pvc.spec.volume_name)

    memo_key = object()

    def predicate(pod: Pod, meta: PredicateMetadata, ni: NodeInfo
                  ) -> Tuple[bool, List[str]]:
        memo = getattr(meta, "memo", None) if meta is not None else None
        wanted: Optional[Dict[str, Set[str]]] = \
            memo.get(memo_key) if memo is not None else None
        if wanted is None:
            wanted = {}
            for vol in pod.spec.volumes:
                dh = _driver_handle(vol, pod.metadata.namespace)
                if dh is not None:
                    wanted.setdefault(dh[0], set()).add(dh[1])
            if memo is not None:
                memo[memo_key] = wanted
        if not wanted:
            return True, []
        existing: Dict[str, Set[str]] = {}
        for p in ni.pods:
            for vol in p.spec.volumes:
                dh = _driver_handle(vol, p.metadata.namespace)
                if dh is not None:
                    existing.setdefault(dh[0], set()).add(dh[1])
        for drv, handles in wanted.items():
            limit = ni.allocatable.scalar_resources.get(
                f"attachable-volumes-csi-{drv}")
            if limit is None:
                continue  # node exposes no limit for this driver
            if len(handles | existing.get(drv, set())) > limit:
                return False, ["node(s) exceed max volume count"]
        return True, []
    return predicate


def default_max_volume_count_predicates(pvc_lister=None, pv_lister=None
                                        ) -> Dict[str, Callable]:
    """The four attach-limit members of the default predicate set
    (ref: algorithmprovider/defaults/defaults.go:40-56)."""
    return {
        "MaxEBSVolumeCount": max_volume_count_factory(
            pd_volume_filter_factory("aws_elastic_block_store", ("volumeID",),
                                     pvc_lister, pv_lister),
            DEFAULT_MAX_EBS_VOLUMES),
        "MaxGCEPDVolumeCount": max_volume_count_factory(
            pd_volume_filter_factory("gce_persistent_disk", ("pdName",),
                                     pvc_lister, pv_lister),
            DEFAULT_MAX_GCE_PD_VOLUMES),
        "MaxAzureDiskVolumeCount": max_volume_count_factory(
            pd_volume_filter_factory("azure_disk", ("diskURI", "diskName"),
                                     pvc_lister, pv_lister),
            DEFAULT_MAX_AZURE_DISK_VOLUMES),
        "MaxCSIVolumeCountPred": csi_max_volume_count_factory(
            pvc_lister, pv_lister),
    }


#: canonical GetPodQOS lives in api/helpers (shared with admission and
#: kubelet eviction); the old name stays for in-package callers
_pod_qos = helpers.pod_qos


def _pressure_taint(key: str):
    from ..api.core import Taint
    return Taint(key=key, effect="NoSchedule")


#: evaluation order (ref: predicates.go:143-149 Ordering()); short-circuit on
#: first failure is the host path; the TPU kernel computes all and ANDs
#: (the reference's alwaysCheckAllPredicates mode, generic_scheduler.go:652)
ORDERING = [
    "CheckNodeCondition",
    "CheckNodeUnschedulable",
    "GeneralPredicates",
    "HostName",
    "PodFitsHostPorts",
    "MatchNodeSelector",
    "PodFitsResources",
    "NoDiskConflict",
    "PodToleratesNodeTaints",
    "MaxEBSVolumeCount",
    "MaxGCEPDVolumeCount",
    "MaxCSIVolumeCountPred",
    "MaxAzureDiskVolumeCount",
    "CheckNodeMemoryPressure",
    "CheckNodePIDPressure",
    "CheckNodeDiskPressure",
    "MatchInterPodAffinity",
]

DEFAULT_PREDICATES: Dict[str, Callable] = {
    "CheckNodeCondition": check_node_condition,
    "HostName": pod_fits_host,
    "PodFitsHostPorts": pod_fits_host_ports,
    "MatchNodeSelector": pod_match_node_selector,
    "PodFitsResources": pod_fits_resources,
    "NoDiskConflict": no_disk_conflict,
    "PodToleratesNodeTaints": pod_tolerates_node_taints,
    "CheckNodeMemoryPressure": check_node_memory_pressure,
    "CheckNodePIDPressure": check_node_pid_pressure,
    "CheckNodeDiskPressure": check_node_disk_pressure,
    "MatchInterPodAffinity": match_inter_pod_affinity,
}


def pod_fits_on_node(pod: Pod, meta: PredicateMetadata, ni: NodeInfo,
                     predicates: Optional[Dict[str, Callable]] = None
                     ) -> Tuple[bool, List[str]]:
    """Run predicates in Ordering() with short-circuit
    (ref: generic_scheduler.go:598-664 podFitsOnNode single-pass)."""
    preds = predicates if predicates is not None else DEFAULT_PREDICATES
    for name in ORDERING:
        fn = preds.get(name)
        if fn is None:
            continue
        ok, reasons = fn(pod, meta, ni)
        if not ok:
            return False, reasons
    for name, fn in preds.items():
        if name not in ORDERING:
            ok, reasons = fn(pod, meta, ni)
            if not ok:
                return False, reasons
    return True, []
