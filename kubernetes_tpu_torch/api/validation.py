"""Object validation (copy of kubernetes_tpu/api/validation.py without
the batch/v1 Job checks: the port does not serve Jobs yet).

Ref: pkg/apis/core/validation/validation.go — reduced to the invariants the
control plane relies on (name formats, required fields, resource sanity,
selector/template agreement for workloads).
"""

from __future__ import annotations

import re
from typing import List, Optional

from . import labels as labelsmod
from .apps import DaemonSet, Deployment, ReplicaSet, StatefulSet
from .core import Node, Pod
from .meta import ObjectMeta

_DNS1123_LABEL = re.compile(r"^[a-z0-9]([-a-z0-9]*[a-z0-9])?$")
_DNS1123_SUBDOMAIN = re.compile(
    r"^[a-z0-9]([-a-z0-9]*[a-z0-9])?(\.[a-z0-9]([-a-z0-9]*[a-z0-9])?)*$")
_LABEL_VALUE = re.compile(r"^(([A-Za-z0-9][-A-Za-z0-9_.]*)?[A-Za-z0-9])?$")
_QUALIFIED_NAME_PART = re.compile(r"^([A-Za-z0-9][-A-Za-z0-9_.]*)?[A-Za-z0-9]$")


class ValidationError(ValueError):
    def __init__(self, errors: List[str]):
        self.errors = errors
        super().__init__("; ".join(errors))


def is_dns1123_label(s: str) -> bool:
    return len(s) <= 63 and bool(_DNS1123_LABEL.match(s))


def is_dns1123_subdomain(s: str) -> bool:
    return len(s) <= 253 and bool(_DNS1123_SUBDOMAIN.match(s))


def is_valid_label_value(s: str) -> bool:
    return len(s) <= 63 and bool(_LABEL_VALUE.match(s))


def is_qualified_name(s: str) -> bool:
    """prefix/name where prefix is a DNS subdomain (ref: validation.IsQualifiedName)."""
    parts = s.split("/")
    if len(parts) == 1:
        name = parts[0]
    elif len(parts) == 2:
        prefix, name = parts
        if not prefix or not is_dns1123_subdomain(prefix):
            return False
    else:
        return False
    return 0 < len(name) <= 63 and bool(_QUALIFIED_NAME_PART.match(name))


def validate_object_meta(meta: ObjectMeta, namespaced: bool, errs: List[str],
                         path: str = "metadata") -> None:
    if not meta.name and not meta.generate_name:
        errs.append(f"{path}.name: required")
    if meta.name and not is_dns1123_subdomain(meta.name):
        errs.append(f"{path}.name: invalid name {meta.name!r}")
    if namespaced:
        if meta.namespace and not is_dns1123_label(meta.namespace):
            errs.append(f"{path}.namespace: invalid namespace {meta.namespace!r}")
    elif meta.namespace:
        errs.append(f"{path}.namespace: not allowed on cluster-scoped object")
    for k, v in meta.labels.items():
        if not is_qualified_name(k):
            errs.append(f"{path}.labels: invalid key {k!r}")
        if not is_valid_label_value(v):
            errs.append(f"{path}.labels[{k}]: invalid value {v!r}")


def validate_pod(pod: Pod) -> None:
    errs: List[str] = []
    validate_object_meta(pod.metadata, namespaced=True, errs=errs)
    if not pod.spec.containers:
        errs.append("spec.containers: at least one container is required")
    seen = set()
    for i, c in enumerate(pod.spec.containers + pod.spec.init_containers):
        path = f"spec.containers[{i}]"
        if not c.name or not is_dns1123_label(c.name):
            errs.append(f"{path}.name: invalid container name {c.name!r}")
        elif c.name in seen:
            errs.append(f"{path}.name: duplicate container name {c.name!r}")
        seen.add(c.name)
        if not c.image:
            errs.append(f"{path}.image: required")
        for name, q in list(c.resources.requests.items()) + list(c.resources.limits.items()):
            if not is_qualified_name(name):
                errs.append(f"{path}.resources: invalid resource name {name!r}")
            if q < 0:
                errs.append(f"{path}.resources[{name}]: must be non-negative")
        for name, q in c.resources.requests.items():
            lim = c.resources.limits.get(name)
            if lim is not None and q > lim:
                errs.append(f"{path}.resources.requests[{name}]: exceeds limit")
    if pod.spec.restart_policy not in ("Always", "OnFailure", "Never"):
        errs.append(f"spec.restartPolicy: invalid {pod.spec.restart_policy!r}")
    for t in pod.spec.tolerations:
        if t.operator not in ("", "Equal", "Exists"):
            errs.append(f"spec.tolerations: invalid operator {t.operator!r}")
        if t.operator == "Exists" and t.value:
            errs.append("spec.tolerations: value must be empty when operator is Exists")
        if t.effect not in ("", "NoSchedule", "PreferNoSchedule", "NoExecute"):
            errs.append(f"spec.tolerations: invalid effect {t.effect!r}")
    if errs:
        raise ValidationError(errs)


def validate_node(node: Node) -> None:
    errs: List[str] = []
    validate_object_meta(node.metadata, namespaced=False, errs=errs)
    for t in node.spec.taints:
        if not is_qualified_name(t.key):
            errs.append(f"spec.taints: invalid key {t.key!r}")
        if t.effect not in ("NoSchedule", "PreferNoSchedule", "NoExecute"):
            errs.append(f"spec.taints: invalid effect {t.effect!r}")
    for name, q in node.status.allocatable.items():
        if q < 0:
            errs.append(f"status.allocatable[{name}]: must be non-negative")
    if errs:
        raise ValidationError(errs)


def validate_pod_group(pg) -> None:
    errs: List[str] = []
    validate_object_meta(pg.metadata, namespaced=True, errs=errs)
    if pg.spec.min_member < 1:
        errs.append("spec.minMember: must be >= 1")
    if pg.spec.topology_key and not is_qualified_name(pg.spec.topology_key):
        errs.append(
            f"spec.topologyKey: invalid key {pg.spec.topology_key!r}")
    if pg.spec.schedule_timeout_seconds < 0:
        errs.append("spec.scheduleTimeoutSeconds: must be non-negative")
    from .scheduling import (PHASE_FAILED, PHASE_PENDING, PHASE_RUNNING,
                             PHASE_SCHEDULING)
    if pg.status.phase not in (PHASE_PENDING, PHASE_SCHEDULING,
                               PHASE_RUNNING, PHASE_FAILED):
        errs.append(f"status.phase: invalid phase {pg.status.phase!r}")
    if pg.status.resubmissions < 0:
        errs.append("status.resubmissions: must be non-negative")
    if errs:
        raise ValidationError(errs)


def _validate_workload_selector(spec, kind: str, errs: List[str]) -> None:
    if spec.selector is None or labelsmod.selector_empty(spec.selector):
        errs.append("spec.selector: required and must not be empty")
        return
    tmpl_labels = spec.template.metadata.labels if spec.template else {}
    if spec.selector is not None and not labelsmod.matches(spec.selector, tmpl_labels):
        errs.append("spec.template.metadata.labels: must match spec.selector")


def validate_workload(obj) -> None:
    """Deployment/ReplicaSet/StatefulSet/DaemonSet common checks."""
    errs: List[str] = []
    validate_object_meta(obj.metadata, namespaced=True, errs=errs)
    spec = obj.spec
    if getattr(spec, "replicas", 0) is not None and getattr(spec, "replicas", 0) < 0:
        errs.append("spec.replicas: must be non-negative")
    _validate_workload_selector(spec, obj.kind, errs)
    if errs:
        raise ValidationError(errs)


#: BUILTIN kinds whose objects must NOT carry a namespace (static set);
#: dynamically-registered cluster-scoped types are tracked by CLASS in
#: CLUSTER_SCOPED_TYPES — keying dynamics by kind name would let a CRD
#: with kind "Service" poison validation of core Services
CLUSTER_SCOPED_KINDS = frozenset({
    "Node", "Namespace", "PersistentVolume", "StorageClass",
    "PriorityClass", "CustomResourceDefinition"})
CLUSTER_SCOPED_TYPES: set = set()


def validate(obj) -> None:
    from .scheduling import PodGroup
    if isinstance(obj, Pod):
        validate_pod(obj)
    elif isinstance(obj, Node):
        validate_node(obj)
    elif isinstance(obj, (Deployment, ReplicaSet, StatefulSet, DaemonSet)):
        validate_workload(obj)
    elif isinstance(obj, PodGroup):
        validate_pod_group(obj)
    else:
        errs: List[str] = []
        meta = getattr(obj, "metadata", None)
        if meta is not None:
            namespaced = (
                getattr(obj, "kind", "") not in CLUSTER_SCOPED_KINDS
                and type(obj) not in CLUSTER_SCOPED_TYPES)
            validate_object_meta(meta, namespaced=namespaced, errs=errs)
        if errs:
            raise ValidationError(errs)
