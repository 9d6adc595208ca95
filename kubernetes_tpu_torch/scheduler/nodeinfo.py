"""Per-node scheduling aggregate.

Ref: pkg/scheduler/nodeinfo/node_info.go — NodeInfo (:47-86), Resource
(:139-148), AddPod/RemovePod/Clone, and host_ports.go HostPortInfo.

Resource carries exactly the columns the tensor mirror exports per node:
milli_cpu, memory, ephemeral_storage, allowed_pod_number, plus a scalar map
for extended resources — the reference's column schema.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from ..api import helpers, wellknown
from ..api.core import Node, Pod


@dataclass
class Resource:
    """Ref: node_info.go:139-148."""

    milli_cpu: int = 0
    memory: int = 0
    ephemeral_storage: int = 0
    allowed_pod_number: int = 0
    scalar_resources: Dict[str, int] = field(default_factory=dict)

    @classmethod
    def from_request_map(cls, req: Dict[str, int]) -> "Resource":
        r = cls()
        for name, v in req.items():
            r.add(name, v)
        return r

    def add(self, name: str, v: int) -> None:
        if name == wellknown.RESOURCE_CPU:
            self.milli_cpu += v
        elif name == wellknown.RESOURCE_MEMORY:
            self.memory += v
        elif name == wellknown.RESOURCE_EPHEMERAL_STORAGE:
            self.ephemeral_storage += v
        elif name == wellknown.RESOURCE_PODS:
            self.allowed_pod_number += v
        else:
            self.scalar_resources[name] = self.scalar_resources.get(name, 0) + v

    def sub(self, other: "Resource") -> None:
        self.milli_cpu -= other.milli_cpu
        self.memory -= other.memory
        self.ephemeral_storage -= other.ephemeral_storage
        for k, v in other.scalar_resources.items():
            self.scalar_resources[k] = self.scalar_resources.get(k, 0) - v

    def add_resource(self, other: "Resource") -> None:
        self.milli_cpu += other.milli_cpu
        self.memory += other.memory
        self.ephemeral_storage += other.ephemeral_storage
        for k, v in other.scalar_resources.items():
            self.scalar_resources[k] = self.scalar_resources.get(k, 0) + v

    def clone(self) -> "Resource":
        return Resource(self.milli_cpu, self.memory, self.ephemeral_storage,
                        self.allowed_pod_number, dict(self.scalar_resources))


def pod_resource(pod: Pod) -> Resource:
    """Memoized per PodSpec — callers treat the Resource as read-only."""
    spec = pod.spec
    cached = spec.__dict__.get("_res_cache")
    if cached is None:
        cached = Resource.from_request_map(helpers.pod_requests(pod))
        spec.__dict__["_res_cache"] = cached
    return cached


def pod_resource_nonzero(pod: Pod) -> Tuple[int, int]:
    """(milliCPU, memory) with non-zero defaults (ref: non_zero.go)."""
    spec = pod.spec
    cached = spec.__dict__.get("_nz_cache")
    if cached is None:
        r = helpers.pod_requests_nonzero(pod)
        cached = (r.get(wellknown.RESOURCE_CPU, 0),
                  r.get(wellknown.RESOURCE_MEMORY, 0))
        spec.__dict__["_nz_cache"] = cached
    return cached


def pod_has_affinity_constraints(pod: Pod) -> bool:
    a = pod.spec.affinity
    return a is not None and (a.pod_affinity is not None or a.pod_anti_affinity is not None)


class NodeInfo:
    """Dense per-node aggregate; `generation` is bumped on every mutation so
    snapshots copy only changed nodes (ref: node_info.go:83-99)."""

    __slots__ = ("node", "pods", "pods_with_affinity", "requested",
                 "non_zero_requested", "allocatable", "used_ports",
                 "taints", "memory_pressure", "disk_pressure", "pid_pressure",
                 "image_sizes", "generation")

    def __init__(self, node: Optional[Node] = None):
        self.node: Optional[Node] = None
        self.pods: List[Pod] = []
        self.pods_with_affinity: List[Pod] = []
        self.requested = Resource()
        self.non_zero_requested = Resource()
        self.allocatable = Resource()
        # {(protocol, ip, port)} (ref: host_ports.go; wildcard-IP overlap is
        # resolved in predicates/tensorize, storage keeps the raw triples)
        self.used_ports: Set[Tuple[str, str, int]] = set()
        self.taints = []
        self.memory_pressure = False
        self.disk_pressure = False
        self.pid_pressure = False
        self.image_sizes: Dict[str, int] = {}
        self.generation = 0
        if node is not None:
            self.set_node(node)

    @property
    def name(self) -> str:
        return self.node.metadata.name if self.node else ""

    def set_node(self, node: Node) -> None:
        self.node = node
        self.allocatable = Resource.from_request_map(helpers.node_allocatable(node))
        self.taints = list(node.spec.taints)
        self.memory_pressure = _cond(node, "MemoryPressure")
        self.disk_pressure = _cond(node, "DiskPressure")
        self.pid_pressure = _cond(node, "PIDPressure")
        self.image_sizes = {name: img.size_bytes
                            for img in node.status.images for name in img.names}

    def add_pod(self, pod: Pod) -> None:
        res = pod_resource(pod)
        self.requested.add_resource(res)
        cpu0, mem0 = pod_resource_nonzero(pod)
        self.non_zero_requested.milli_cpu += cpu0
        self.non_zero_requested.memory += mem0
        self.pods.append(pod)
        if pod_has_affinity_constraints(pod):
            self.pods_with_affinity.append(pod)
        for hp in helpers.pod_host_ports(pod):
            self.used_ports.add(hp)

    def remove_pod(self, pod: Pod) -> bool:
        """Returns False if the pod was not present (ref: RemovePod error)."""
        key = pod.metadata.key()
        for i, p in enumerate(self.pods):
            if p.metadata.key() == key:
                del self.pods[i]
                break
        else:
            return False
        self.pods_with_affinity = [p for p in self.pods_with_affinity
                                   if p.metadata.key() != key]
        res = pod_resource(pod)
        self.requested.sub(res)
        cpu0, mem0 = pod_resource_nonzero(pod)
        self.non_zero_requested.milli_cpu -= cpu0
        self.non_zero_requested.memory -= mem0
        for hp in helpers.pod_host_ports(pod):
            self.used_ports.discard(hp)
        return True

    def clone(self) -> "NodeInfo":
        c = NodeInfo()
        c.node = self.node
        c.pods = list(self.pods)
        c.pods_with_affinity = list(self.pods_with_affinity)
        c.requested = self.requested.clone()
        c.non_zero_requested = self.non_zero_requested.clone()
        c.allocatable = self.allocatable.clone()
        c.used_ports = set(self.used_ports)
        c.taints = list(self.taints)
        c.memory_pressure = self.memory_pressure
        c.disk_pressure = self.disk_pressure
        c.pid_pressure = self.pid_pressure
        c.image_sizes = dict(self.image_sizes)
        c.generation = self.generation
        return c


def _cond(node: Node, ctype: str) -> bool:
    for c in node.status.conditions:
        if c.type == ctype:
            return c.status == "True"
    return False
