"""policy/v1beta1 (PodDisruptionBudget), scheduling/v1 (PriorityClass),
storage/v1 (StorageClass), coordination/v1 (Lease).

Ref: staging/src/k8s.io/api/{policy/v1beta1,scheduling/v1,storage/v1,
coordination/v1}/types.go.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .meta import LabelSelector, ObjectMeta


@dataclass
class PodDisruptionBudgetSpec:
    min_available: Optional[str] = None   # IntOrString
    max_unavailable: Optional[str] = None
    selector: Optional[LabelSelector] = None


@dataclass
class PodDisruptionBudgetStatus:
    observed_generation: int = 0
    disrupted_pods: Dict[str, str] = field(default_factory=dict)
    disruptions_allowed: int = 0
    current_healthy: int = 0
    desired_healthy: int = 0
    expected_pods: int = 0


@dataclass
class PodDisruptionBudget:
    api_version: str = "policy/v1beta1"
    kind: str = "PodDisruptionBudget"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodDisruptionBudgetSpec = field(default_factory=PodDisruptionBudgetSpec)
    status: PodDisruptionBudgetStatus = field(default_factory=PodDisruptionBudgetStatus)


@dataclass
class Eviction:
    """The pods/eviction subresource body (ref: policy/v1beta1 Eviction,
    pkg/registry/core/pod/storage/eviction.go — the PDB-guarded delete)."""
    api_version: str = "policy/v1beta1"
    kind: str = "Eviction"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)


@dataclass
class PriorityClass:
    api_version: str = "scheduling.k8s.io/v1"
    kind: str = "PriorityClass"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    value: int = 0
    global_default: Optional[bool] = None
    description: str = ""
    preemption_policy: Optional[str] = None  # Never | PreemptLowerPriority


@dataclass
class StorageClass:
    api_version: str = "storage.k8s.io/v1"
    kind: str = "StorageClass"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    provisioner: str = ""
    parameters: Dict[str, str] = field(default_factory=dict)
    reclaim_policy: str = "Delete"
    volume_binding_mode: str = "Immediate"  # Immediate | WaitForFirstConsumer
    allowed_topologies: List[dict] = field(default_factory=list)


@dataclass
class LeaseSpec:
    holder_identity: str = ""
    lease_duration_seconds: int = 0
    acquire_time: Optional[str] = None
    renew_time: Optional[str] = None
    lease_transitions: int = 0


@dataclass
class Lease:
    api_version: str = "coordination.k8s.io/v1"
    kind: str = "Lease"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: LeaseSpec = field(default_factory=LeaseSpec)
