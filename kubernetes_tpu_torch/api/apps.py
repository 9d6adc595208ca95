"""apps/v1 workload types. Ref: staging/src/k8s.io/api/apps/v1/types.go."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from .core import PodTemplateSpec
from .meta import LabelSelector, ObjectMeta


@dataclass
class RollingUpdateDeployment:
    max_unavailable: Optional[str] = None  # int or percent string, k8s IntOrString
    max_surge: Optional[str] = None


@dataclass
class DeploymentStrategy:
    type: str = "RollingUpdate"  # Recreate | RollingUpdate
    rolling_update: Optional[RollingUpdateDeployment] = None


@dataclass
class DeploymentSpec:
    replicas: int = 1
    selector: Optional[LabelSelector] = None
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)
    strategy: DeploymentStrategy = field(default_factory=DeploymentStrategy)
    min_ready_seconds: int = 0
    revision_history_limit: Optional[int] = None
    paused: Optional[bool] = None
    progress_deadline_seconds: Optional[int] = None


@dataclass
class DeploymentCondition:
    type: str = ""
    status: str = ""
    reason: str = ""
    message: str = ""
    last_update_time: Optional[str] = None
    last_transition_time: Optional[str] = None


@dataclass
class DeploymentStatus:
    observed_generation: int = 0
    replicas: int = 0
    updated_replicas: int = 0
    ready_replicas: int = 0
    available_replicas: int = 0
    unavailable_replicas: int = 0
    conditions: List[DeploymentCondition] = field(default_factory=list)


@dataclass
class Deployment:
    api_version: str = "apps/v1"
    kind: str = "Deployment"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: DeploymentSpec = field(default_factory=DeploymentSpec)
    status: DeploymentStatus = field(default_factory=DeploymentStatus)


@dataclass
class ReplicaSetSpec:
    replicas: int = 1
    selector: Optional[LabelSelector] = None
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)
    min_ready_seconds: int = 0


@dataclass
class ReplicaSetStatus:
    replicas: int = 0
    fully_labeled_replicas: int = 0
    ready_replicas: int = 0
    available_replicas: int = 0
    observed_generation: int = 0


@dataclass
class ReplicaSet:
    api_version: str = "apps/v1"
    kind: str = "ReplicaSet"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ReplicaSetSpec = field(default_factory=ReplicaSetSpec)
    status: ReplicaSetStatus = field(default_factory=ReplicaSetStatus)


@dataclass
class StatefulSetSpec:
    replicas: int = 1
    selector: Optional[LabelSelector] = None
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)
    service_name: str = ""
    pod_management_policy: str = "OrderedReady"  # OrderedReady | Parallel
    update_strategy: Optional[dict] = None
    volume_claim_templates: List[dict] = field(default_factory=list)


@dataclass
class StatefulSetStatus:
    observed_generation: int = 0
    replicas: int = 0
    ready_replicas: int = 0
    current_replicas: int = 0
    updated_replicas: int = 0
    current_revision: str = ""
    update_revision: str = ""


@dataclass
class StatefulSet:
    api_version: str = "apps/v1"
    kind: str = "StatefulSet"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: StatefulSetSpec = field(default_factory=StatefulSetSpec)
    status: StatefulSetStatus = field(default_factory=StatefulSetStatus)


@dataclass
class DaemonSetSpec:
    selector: Optional[LabelSelector] = None
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)
    update_strategy: Optional[dict] = None
    min_ready_seconds: int = 0


@dataclass
class DaemonSetStatus:
    current_number_scheduled: int = 0
    number_misscheduled: int = 0
    desired_number_scheduled: int = 0
    number_ready: int = 0
    observed_generation: int = 0
    updated_number_scheduled: int = 0
    number_available: int = 0
    number_unavailable: int = 0


@dataclass
class DaemonSet:
    api_version: str = "apps/v1"
    kind: str = "DaemonSet"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: DaemonSetSpec = field(default_factory=DaemonSetSpec)
    status: DaemonSetStatus = field(default_factory=DaemonSetStatus)
