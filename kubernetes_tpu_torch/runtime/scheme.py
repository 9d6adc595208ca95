"""Scheme — kind registry mapping (apiVersion, kind) <-> python type and
resource (plural) names, with decode dispatch on TypeMeta.

Copy of kubernetes_tpu/runtime/scheme.py; default_scheme registers only
the kinds of the scheduler loop.

Ref: staging/src/k8s.io/apimachinery/pkg/runtime/scheme.go, reduced: there is
one internal representation (the dataclasses) and one wire version per group,
so conversion collapses to serde.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Type

from ..api import serde
from ..api.apps import DaemonSet, Deployment, ReplicaSet, StatefulSet
from ..api.core import (Binding, ConfigMap, Endpoints, Event, LimitRange,
                        Namespace, Node, PersistentVolume,
                        PersistentVolumeClaim, Pod, ReplicationController,
                        ResourceQuota, Secret, Service, ServiceAccount)
from ..api.policy import Lease, PodDisruptionBudget, PriorityClass, StorageClass


class Scheme:
    def __init__(self):
        self._by_gvk: Dict[Tuple[str, str], Type] = {}
        self._by_type: Dict[Type, Tuple[str, str]] = {}
        self._resource_by_type: Dict[Type, str] = {}
        self._type_by_resource: Dict[str, Type] = {}
        self._namespaced: Dict[Type, bool] = {}

    def register(self, cls: Type, api_version: str, kind: str, resource: str,
                 namespaced: bool = True) -> None:
        self._by_gvk[(api_version, kind)] = cls
        self._by_type[cls] = (api_version, kind)
        self._resource_by_type[cls] = resource
        self._type_by_resource[resource] = cls
        self._namespaced[cls] = namespaced
        if not namespaced:
            # keep generic validation's scope knowledge in sync (it cannot
            # import the scheme: api <- runtime would cycle); keyed by
            # CLASS — a kind-name key would collide with builtins
            from ..api import validation
            validation.CLUSTER_SCOPED_TYPES.add(cls)

    def unregister(self, api_version: str, kind: str, resource: str) -> None:
        """Remove a dynamically-registered kind (CRD deletion)."""
        cls = self._by_gvk.pop((api_version, kind), None)
        if cls is None:
            return
        self._by_type.pop(cls, None)
        self._resource_by_type.pop(cls, None)
        if self._type_by_resource.get(resource) is cls:
            del self._type_by_resource[resource]
        self._namespaced.pop(cls, None)
        from ..api import validation
        validation.CLUSTER_SCOPED_TYPES.discard(cls)

    def type_for(self, api_version: str, kind: str) -> Optional[Type]:
        return self._by_gvk.get((api_version, kind)) or \
            next((cls for (v, k), cls in self._by_gvk.items() if k == kind), None)

    def type_for_exact(self, api_version: str, kind: str) -> Optional[Type]:
        """Exact-gvk lookup, no kind-only fallback — same-kind CRDs in
        different groups must not resolve to each other."""
        return self._by_gvk.get((api_version, kind))

    def type_for_resource(self, resource: str) -> Optional[Type]:
        return self._type_by_resource.get(resource)

    def resource_for(self, cls_or_obj) -> str:
        cls = cls_or_obj if isinstance(cls_or_obj, type) else type(cls_or_obj)
        return self._resource_by_type[cls]

    def gvk_for(self, cls_or_obj) -> Tuple[str, str]:
        cls = cls_or_obj if isinstance(cls_or_obj, type) else type(cls_or_obj)
        return self._by_type[cls]

    def is_namespaced(self, cls_or_obj) -> bool:
        cls = cls_or_obj if isinstance(cls_or_obj, type) else type(cls_or_obj)
        return self._namespaced[cls]

    def resources(self):
        return list(self._type_by_resource)

    def decode_any(self, data: Dict[str, Any]):
        """Decode arbitrary manifest data by its TypeMeta."""
        kind = data.get("kind", "")
        api_version = data.get("apiVersion", "")
        cls = self.type_for(api_version, kind)
        if cls is None:
            raise KeyError(f"no kind registered for {api_version}/{kind}")
        return serde.decode(cls, data)


def default_scheme() -> Scheme:
    """The kinds the scheduler loop's client and informers read and write.
    rbac, batch, autoscaling, certificates, admission webhooks, API
    aggregation and CRDs are not served by the port yet (ROADMAP, the
    harnesses and commands item)."""
    s = Scheme()
    s.register(Pod, "v1", "Pod", "pods")
    s.register(Node, "v1", "Node", "nodes", namespaced=False)
    s.register(Service, "v1", "Service", "services")
    s.register(Endpoints, "v1", "Endpoints", "endpoints")
    s.register(Namespace, "v1", "Namespace", "namespaces", namespaced=False)
    s.register(Event, "v1", "Event", "events")
    s.register(Binding, "v1", "Binding", "bindings")
    s.register(PersistentVolume, "v1", "PersistentVolume",
               "persistentvolumes", namespaced=False)
    s.register(PersistentVolumeClaim, "v1", "PersistentVolumeClaim",
               "persistentvolumeclaims")
    s.register(ReplicationController, "v1", "ReplicationController",
               "replicationcontrollers")
    s.register(ResourceQuota, "v1", "ResourceQuota", "resourcequotas")
    s.register(LimitRange, "v1", "LimitRange", "limitranges")
    s.register(ConfigMap, "v1", "ConfigMap", "configmaps")
    s.register(Secret, "v1", "Secret", "secrets")
    s.register(ServiceAccount, "v1", "ServiceAccount", "serviceaccounts")
    s.register(Deployment, "apps/v1", "Deployment", "deployments")
    s.register(ReplicaSet, "apps/v1", "ReplicaSet", "replicasets")
    s.register(StatefulSet, "apps/v1", "StatefulSet", "statefulsets")
    s.register(DaemonSet, "apps/v1", "DaemonSet", "daemonsets")
    s.register(PodDisruptionBudget, "policy/v1beta1", "PodDisruptionBudget",
               "poddisruptionbudgets")
    s.register(PriorityClass, "scheduling.k8s.io/v1", "PriorityClass",
               "priorityclasses", namespaced=False)
    s.register(StorageClass, "storage.k8s.io/v1", "StorageClass",
               "storageclasses", namespaced=False)
    s.register(Lease, "coordination.k8s.io/v1", "Lease", "leases")
    from ..api.scheduling import PodGroup
    s.register(PodGroup, "scheduling.k8s.io/v1alpha1", "PodGroup",
               "podgroups")
    return s


#: process-wide scheme, mirroring the reference's legacyscheme.Scheme
SCHEME = default_scheme()
