"""Core API types (the core/v1 group).

Ref: pkg/apis/core/types.go and staging/src/k8s.io/api/core/v1/types.go.
This carries the full scheduling-relevant surface (Pod, Node, affinity,
taints/tolerations, volumes/PV/PVC, Service/Endpoints, Namespace, Event) plus
the status types controllers and the node agent drive. Fields follow the
reference's names (camelCase on the wire via api.serde).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .meta import LabelSelector, ObjectMeta
from .quantity import Quantity

# ---------------------------------------------------------------- pods

@dataclass
class ResourceRequirements:
    limits: Dict[str, Quantity] = field(default_factory=dict)
    requests: Dict[str, Quantity] = field(default_factory=dict)


@dataclass
class ContainerPort:
    name: str = ""
    host_port: int = 0
    container_port: int = 0
    protocol: str = "TCP"
    host_ip: str = ""


@dataclass
class VolumeMount:
    name: str = ""
    mount_path: str = ""
    read_only: Optional[bool] = None


@dataclass
class Probe:
    # exec/httpGet/tcpSocket collapsed to a descriptor string; the node agent
    # only needs timing semantics (ref: v1.Probe)
    handler: str = ""
    initial_delay_seconds: int = 0
    timeout_seconds: int = 1
    period_seconds: int = 10
    success_threshold: int = 1
    failure_threshold: int = 3


@dataclass
class Container:
    name: str = ""
    image: str = ""
    command: List[str] = field(default_factory=list)
    args: List[str] = field(default_factory=list)
    ports: List[ContainerPort] = field(default_factory=list)
    env: Dict[str, str] = field(default_factory=dict)
    resources: ResourceRequirements = field(default_factory=ResourceRequirements)
    volume_mounts: List[VolumeMount] = field(default_factory=list)
    liveness_probe: Optional[Probe] = None
    readiness_probe: Optional[Probe] = None


@dataclass
class Toleration:
    key: str = ""
    operator: str = "Equal"  # Exists | Equal
    value: str = ""
    effect: str = ""  # "" (all) | NoSchedule | PreferNoSchedule | NoExecute
    toleration_seconds: Optional[int] = None

    def tolerates(self, taint: "Taint") -> bool:
        """Ref: staging/src/k8s.io/api/core/v1/toleration.go ToleratesTaint."""
        if self.effect and self.effect != taint.effect:
            return False
        if self.key and self.key != taint.key:
            return False
        if self.operator in ("", "Equal"):
            return self.value == taint.value
        if self.operator == "Exists":
            return True
        return False


@dataclass
class NodeSelectorRequirement:
    key: str = ""
    operator: str = ""  # In|NotIn|Exists|DoesNotExist|Gt|Lt
    values: List[str] = field(default_factory=list)


@dataclass
class NodeSelectorTerm:
    match_expressions: List[NodeSelectorRequirement] = field(default_factory=list)
    match_fields: List[NodeSelectorRequirement] = field(default_factory=list)


@dataclass
class NodeSelector:
    # OR of terms; AND within a term (ref: v1.NodeSelector)
    node_selector_terms: List[NodeSelectorTerm] = field(default_factory=list)


@dataclass
class PreferredSchedulingTerm:
    weight: int = 0  # 1-100
    preference: NodeSelectorTerm = field(default_factory=NodeSelectorTerm)


@dataclass
class NodeAffinity:
    required_during_scheduling_ignored_during_execution: Optional[NodeSelector] = None
    preferred_during_scheduling_ignored_during_execution: List[PreferredSchedulingTerm] = field(default_factory=list)


@dataclass
class PodAffinityTerm:
    label_selector: Optional[LabelSelector] = None
    namespaces: List[str] = field(default_factory=list)
    topology_key: str = ""


@dataclass
class WeightedPodAffinityTerm:
    weight: int = 0  # 1-100
    pod_affinity_term: PodAffinityTerm = field(default_factory=PodAffinityTerm)


@dataclass
class PodAffinity:
    required_during_scheduling_ignored_during_execution: List[PodAffinityTerm] = field(default_factory=list)
    preferred_during_scheduling_ignored_during_execution: List[WeightedPodAffinityTerm] = field(default_factory=list)


@dataclass
class PodAntiAffinity:
    required_during_scheduling_ignored_during_execution: List[PodAffinityTerm] = field(default_factory=list)
    preferred_during_scheduling_ignored_during_execution: List[WeightedPodAffinityTerm] = field(default_factory=list)


@dataclass
class Affinity:
    node_affinity: Optional[NodeAffinity] = None
    pod_affinity: Optional[PodAffinity] = None
    pod_anti_affinity: Optional[PodAntiAffinity] = None


@dataclass
class PersistentVolumeClaimVolumeSource:
    claim_name: str = ""
    read_only: Optional[bool] = None


@dataclass
class Volume:
    name: str = ""
    # one-of volume sources, reduced to the ones scheduling cares about
    persistent_volume_claim: Optional[PersistentVolumeClaimVolumeSource] = None
    empty_dir: Optional[dict] = None
    host_path: Optional[dict] = None
    config_map: Optional[dict] = None
    secret: Optional[dict] = None
    # disk sources with scheduler NoDiskConflict semantics
    gce_persistent_disk: Optional[dict] = None
    aws_elastic_block_store: Optional[dict] = None
    rbd: Optional[dict] = None
    iscsi: Optional[dict] = None
    # attach-limited sources counted by Max*VolumeCount predicates
    azure_disk: Optional[dict] = None
    csi: Optional[dict] = None


@dataclass
class PodSpec:
    containers: List[Container] = field(default_factory=list)
    init_containers: List[Container] = field(default_factory=list)
    volumes: List[Volume] = field(default_factory=list)
    node_selector: Dict[str, str] = field(default_factory=dict)
    node_name: str = ""
    affinity: Optional[Affinity] = None
    tolerations: List[Toleration] = field(default_factory=list)
    scheduler_name: str = "default-scheduler"
    priority: Optional[int] = None
    priority_class_name: str = ""
    restart_policy: str = "Always"
    termination_grace_period_seconds: Optional[int] = None
    active_deadline_seconds: Optional[int] = None
    host_network: Optional[bool] = None
    service_account_name: str = ""
    overhead: Dict[str, Quantity] = field(default_factory=dict)
    hostname: str = ""     # stable identity (StatefulSet pods)
    subdomain: str = ""    # headless service domain


@dataclass
class ContainerStateRunning:
    started_at: Optional[str] = None


@dataclass
class ContainerStateTerminated:
    exit_code: int = 0
    reason: str = ""
    finished_at: Optional[str] = None


@dataclass
class ContainerStateWaiting:
    reason: str = ""
    message: str = ""


@dataclass
class ContainerState:
    waiting: Optional[ContainerStateWaiting] = None
    running: Optional[ContainerStateRunning] = None
    terminated: Optional[ContainerStateTerminated] = None


@dataclass
class ContainerStatus:
    name: str = ""
    ready: bool = False
    restart_count: int = 0
    image: str = ""
    state: ContainerState = field(default_factory=ContainerState)


@dataclass
class PodCondition:
    type: str = ""  # PodScheduled | Ready | Initialized | ContainersReady
    status: str = ""  # True | False | Unknown
    reason: str = ""
    message: str = ""
    last_transition_time: Optional[str] = None


@dataclass
class PodStatus:
    phase: str = "Pending"  # Pending|Running|Succeeded|Failed|Unknown
    conditions: List[PodCondition] = field(default_factory=list)
    host_ip: str = ""
    pod_ip: str = ""
    start_time: Optional[str] = None
    container_statuses: List[ContainerStatus] = field(default_factory=list)
    reason: str = ""
    message: str = ""
    nominated_node_name: str = ""
    qos_class: str = ""


@dataclass
class Pod:
    api_version: str = "v1"
    kind: str = "Pod"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)


# ---------------------------------------------------------------- nodes

@dataclass
class Taint:
    key: str = ""
    value: str = ""
    effect: str = ""  # NoSchedule | PreferNoSchedule | NoExecute
    time_added: Optional[str] = None


@dataclass
class NodeSpec:
    pod_cidr: str = ""
    provider_id: str = ""
    unschedulable: Optional[bool] = None
    taints: List[Taint] = field(default_factory=list)


@dataclass
class NodeCondition:
    type: str = ""  # Ready | MemoryPressure | DiskPressure | PIDPressure | NetworkUnavailable
    status: str = ""  # True | False | Unknown
    reason: str = ""
    message: str = ""
    last_heartbeat_time: Optional[str] = None
    last_transition_time: Optional[str] = None


@dataclass
class ContainerImage:
    names: List[str] = field(default_factory=list)
    size_bytes: int = 0


@dataclass
class NodeSystemInfo:
    machine_id: str = ""
    kernel_version: str = ""
    os_image: str = ""
    container_runtime_version: str = ""
    kubelet_version: str = ""
    operating_system: str = "linux"
    architecture: str = "amd64"


@dataclass
class AttachedVolume:
    name: str = ""         # "kubernetes.io/<plugin>/<volume-name>"
    device_path: str = ""


@dataclass
class NodeStatus:
    capacity: Dict[str, Quantity] = field(default_factory=dict)
    allocatable: Dict[str, Quantity] = field(default_factory=dict)
    phase: str = ""
    conditions: List[NodeCondition] = field(default_factory=list)
    addresses: List[dict] = field(default_factory=list)
    #: {"kubeletEndpoint": {"Port": N}} — the apiserver->kubelet proxy's
    #: dial target (ref: NodeDaemonEndpoints)
    daemon_endpoints: Optional[dict] = None
    node_info: NodeSystemInfo = field(default_factory=NodeSystemInfo)
    images: List[ContainerImage] = field(default_factory=list)
    volumes_attached: List[AttachedVolume] = field(default_factory=list)
    volumes_in_use: List[str] = field(default_factory=list)


@dataclass
class Node:
    api_version: str = "v1"
    kind: str = "Node"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodeSpec = field(default_factory=NodeSpec)
    status: NodeStatus = field(default_factory=NodeStatus)


# ---------------------------------------------------------------- services

@dataclass
class ServicePort:
    name: str = ""
    protocol: str = "TCP"
    port: int = 0
    target_port: Optional[int] = None
    node_port: int = 0


@dataclass
class ServiceSpec:
    selector: Dict[str, str] = field(default_factory=dict)
    ports: List[ServicePort] = field(default_factory=list)
    cluster_ip: str = ""
    type: str = "ClusterIP"


@dataclass
class ServiceStatus:
    load_balancer: Optional[dict] = None


@dataclass
class Service:
    api_version: str = "v1"
    kind: str = "Service"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ServiceSpec = field(default_factory=ServiceSpec)
    status: ServiceStatus = field(default_factory=ServiceStatus)


@dataclass
class EndpointAddress:
    ip: str = ""
    node_name: str = ""
    target_ref: Optional[dict] = None


@dataclass
class EndpointPort:
    name: str = ""
    port: int = 0
    protocol: str = "TCP"


@dataclass
class EndpointSubset:
    addresses: List[EndpointAddress] = field(default_factory=list)
    not_ready_addresses: List[EndpointAddress] = field(default_factory=list)
    ports: List[EndpointPort] = field(default_factory=list)


@dataclass
class Endpoints:
    api_version: str = "v1"
    kind: str = "Endpoints"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    subsets: List[EndpointSubset] = field(default_factory=list)


# ---------------------------------------------------------------- storage

@dataclass
class PersistentVolumeClaimSpec:
    access_modes: List[str] = field(default_factory=list)
    selector: Optional[LabelSelector] = None
    resources: ResourceRequirements = field(default_factory=ResourceRequirements)
    volume_name: str = ""
    storage_class_name: Optional[str] = None
    volume_mode: Optional[str] = None


@dataclass
class PersistentVolumeClaimStatus:
    phase: str = "Pending"  # Pending | Bound | Lost
    access_modes: List[str] = field(default_factory=list)
    capacity: Dict[str, Quantity] = field(default_factory=dict)


@dataclass
class PersistentVolumeClaim:
    api_version: str = "v1"
    kind: str = "PersistentVolumeClaim"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PersistentVolumeClaimSpec = field(default_factory=PersistentVolumeClaimSpec)
    status: PersistentVolumeClaimStatus = field(default_factory=PersistentVolumeClaimStatus)


@dataclass
class PersistentVolumeSpec:
    capacity: Dict[str, Quantity] = field(default_factory=dict)
    access_modes: List[str] = field(default_factory=list)
    persistent_volume_reclaim_policy: str = "Retain"
    storage_class_name: str = ""
    claim_ref: Optional[dict] = None
    node_affinity: Optional[dict] = None  # VolumeNodeAffinity{required: NodeSelector}
    # volume sources resolved by Max*VolumeCount / NoDiskConflict through PVCs
    gce_persistent_disk: Optional[dict] = None
    aws_elastic_block_store: Optional[dict] = None
    azure_disk: Optional[dict] = None
    csi: Optional[dict] = None  # {driver, volumeHandle}


@dataclass
class PersistentVolumeStatus:
    phase: str = "Available"  # Pending | Available | Bound | Released | Failed


@dataclass
class PersistentVolume:
    api_version: str = "v1"
    kind: str = "PersistentVolume"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PersistentVolumeSpec = field(default_factory=PersistentVolumeSpec)
    status: PersistentVolumeStatus = field(default_factory=PersistentVolumeStatus)


# ---------------------------------------------------------------- misc

@dataclass
class NamespaceSpec:
    finalizers: List[str] = field(default_factory=list)


@dataclass
class NamespaceStatus:
    phase: str = "Active"  # Active | Terminating


@dataclass
class Namespace:
    api_version: str = "v1"
    kind: str = "Namespace"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NamespaceSpec = field(default_factory=NamespaceSpec)
    status: NamespaceStatus = field(default_factory=NamespaceStatus)


@dataclass
class ObjectReference:
    kind: str = ""
    namespace: str = ""
    name: str = ""
    uid: str = ""
    api_version: str = ""
    resource_version: str = ""
    field_path: str = ""


@dataclass
class Event:
    api_version: str = "v1"
    kind: str = "Event"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    involved_object: ObjectReference = field(default_factory=ObjectReference)
    reason: str = ""
    message: str = ""
    source: Dict[str, str] = field(default_factory=dict)
    first_timestamp: Optional[str] = None
    last_timestamp: Optional[str] = None
    count: int = 0
    type: str = "Normal"  # Normal | Warning


@dataclass
class Binding:
    """The bind subresource body the scheduler POSTs
    (ref: pkg/registry/core/pod/rest BindingREST)."""
    api_version: str = "v1"
    kind: str = "Binding"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    target: ObjectReference = field(default_factory=ObjectReference)


@dataclass
class ReplicationControllerSpec:
    replicas: int = 1
    selector: Dict[str, str] = field(default_factory=dict)
    template: Optional["PodTemplateSpec"] = None


@dataclass
class PodTemplateSpec:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)


@dataclass
class ReplicationControllerStatus:
    replicas: int = 0
    ready_replicas: int = 0
    available_replicas: int = 0
    observed_generation: int = 0


@dataclass
class ReplicationController:
    api_version: str = "v1"
    kind: str = "ReplicationController"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ReplicationControllerSpec = field(default_factory=ReplicationControllerSpec)
    status: ReplicationControllerStatus = field(default_factory=ReplicationControllerStatus)


# ------------------------------------------------- quota & limits

@dataclass
class ResourceQuotaSpec:
    """Ref: core/v1 ResourceQuotaSpec (types.go) — hard caps per resource
    name ("pods", "requests.cpu", "limits.memory", "count/{resource}", ...)
    plus the scope selectors restricting which pods the quota tracks."""
    hard: Dict[str, Quantity] = field(default_factory=dict)
    scopes: List[str] = field(default_factory=list)  # Terminating | NotTerminating | BestEffort | NotBestEffort


@dataclass
class ResourceQuotaStatus:
    hard: Dict[str, Quantity] = field(default_factory=dict)
    used: Dict[str, Quantity] = field(default_factory=dict)


@dataclass
class ResourceQuota:
    api_version: str = "v1"
    kind: str = "ResourceQuota"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ResourceQuotaSpec = field(default_factory=ResourceQuotaSpec)
    status: ResourceQuotaStatus = field(default_factory=ResourceQuotaStatus)


@dataclass
class LimitRangeItem:
    """Ref: core/v1 LimitRangeItem — per-type (Container/Pod/
    PersistentVolumeClaim) min/max bounds and container defaults."""
    type: str = "Container"
    max: Dict[str, Quantity] = field(default_factory=dict)
    min: Dict[str, Quantity] = field(default_factory=dict)
    default: Dict[str, Quantity] = field(default_factory=dict)
    default_request: Dict[str, Quantity] = field(default_factory=dict)
    max_limit_request_ratio: Dict[str, Quantity] = field(default_factory=dict)


@dataclass
class LimitRangeSpec:
    limits: List[LimitRangeItem] = field(default_factory=list)


@dataclass
class LimitRange:
    api_version: str = "v1"
    kind: str = "LimitRange"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: LimitRangeSpec = field(default_factory=LimitRangeSpec)


# ------------------------------------------------- config & identity

@dataclass
class ConfigMap:
    """Ref: core/v1 ConfigMap (types.go:4952)."""
    api_version: str = "v1"
    kind: str = "ConfigMap"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    data: Dict[str, str] = field(default_factory=dict)
    binary_data: Dict[str, str] = field(default_factory=dict)  # base64
    immutable: Optional[bool] = None


@dataclass
class Secret:
    """Ref: core/v1 Secret (types.go:4790). `data` values are base64 on
    the wire per convention; stringData is write-only convenience merged
    into data by defaulting."""
    api_version: str = "v1"
    kind: str = "Secret"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    type: str = "Opaque"
    data: Dict[str, str] = field(default_factory=dict)
    string_data: Dict[str, str] = field(default_factory=dict)
    immutable: Optional[bool] = None


@dataclass
class ServiceAccount:
    """Ref: core/v1 ServiceAccount (types.go:3980)."""
    api_version: str = "v1"
    kind: str = "ServiceAccount"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    secrets: List[ObjectReference] = field(default_factory=list)
    automount_service_account_token: Optional[bool] = None
