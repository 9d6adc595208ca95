"""Defaulting. Ref: pkg/apis/core/v1/defaults.go (SetDefaults_*).

Copy of kubernetes_tpu/api/defaults.py without the batch/v1 Job branch
(the port does not serve Jobs yet)."""

from __future__ import annotations

from .apps import DaemonSet, Deployment, ReplicaSet, StatefulSet
from .core import Pod, PodSpec
from .meta import LabelSelector
from .quantity import Quantity


def _coerce_quantities(resources) -> None:
    """Plain strings/ints in resource maps become Quantity — the decode
    path produces Quantity, and direct dataclass construction should not
    crash validation with a TypeError for the same input."""
    for m in (resources.requests, resources.limits):
        for name, q in list(m.items()):
            if not isinstance(q, Quantity):
                m[name] = Quantity(q)


def default_pod(pod: Pod) -> Pod:
    spec = pod.spec
    if not spec.restart_policy:
        spec.restart_policy = "Always"
    if spec.termination_grace_period_seconds is None:
        spec.termination_grace_period_seconds = 30
    if not spec.scheduler_name:
        spec.scheduler_name = "default-scheduler"
    for c in spec.containers + spec.init_containers:
        for p in c.ports:
            if not p.protocol:
                p.protocol = "TCP"
        _coerce_quantities(c.resources)
        # requests default from limits (ref: SetDefaults_ResourceList semantics
        # in defaults.go: limits set + requests unset -> requests = limits)
        for name, q in c.resources.limits.items():
            if name not in c.resources.requests:
                c.resources.requests[name] = Quantity(q)
    if not pod.metadata.namespace:
        pod.metadata.namespace = "default"
    return pod


def _default_workload(obj, kind_labels_from_template: bool = True):
    if not obj.metadata.namespace:
        obj.metadata.namespace = "default"
    spec = obj.spec
    if hasattr(spec, "replicas") and spec.replicas is None:
        spec.replicas = 1
    # apps/v1 requires an explicit selector; default it from template labels
    # only for convenience in tests (v1beta legacy behavior)
    if getattr(spec, "selector", None) is None and kind_labels_from_template:
        tmpl = getattr(spec, "template", None)
        if tmpl is not None and tmpl.metadata.labels:
            spec.selector = LabelSelector(match_labels=dict(tmpl.metadata.labels))
    tmpl = getattr(spec, "template", None)
    if tmpl is not None:
        shell = Pod(metadata=tmpl.metadata, spec=tmpl.spec)
        default_pod(shell)
        shell.metadata.namespace = ""
    return obj


def default(obj):
    if isinstance(obj, Pod):
        return default_pod(obj)
    if isinstance(obj, (Deployment, ReplicaSet, StatefulSet, DaemonSet)):
        return _default_workload(obj)
    if getattr(obj, "kind", "") == "Secret":
        merge_secret_string_data(obj)
    if getattr(obj, "kind", "") == "Namespace":
        # the kubernetes finalizer gates deletion on content cleanup
        # (ref: pkg/registry/core/namespace strategy + the namespace
        # controller's finalization dance)
        if "kubernetes" not in obj.spec.finalizers:
            obj.spec.finalizers.append("kubernetes")
        if "kubernetes" not in obj.metadata.finalizers:
            obj.metadata.finalizers.append("kubernetes")
        return obj
    if getattr(obj, "kind", "") == "Service":
        if not obj.metadata.namespace:
            obj.metadata.namespace = "default"  # BEFORE the ip hash
        # ClusterIP allocation (ref: the service REST's ipallocator); a
        # stable hash-derived address from the 10.96/12 service range.
        # Collisions are resolved at create time (client.create salts).
        if obj.spec.type == "ClusterIP" and not obj.spec.cluster_ip:
            obj.spec.cluster_ip = service_cluster_ip(
                obj.metadata.namespace, obj.metadata.name)
    meta = getattr(obj, "metadata", None)
    if meta is not None and not meta.namespace and getattr(obj, "kind", "") in (
            "Service", "Endpoints", "PersistentVolumeClaim", "Job", "CronJob",
            "PodDisruptionBudget", "Event", "ConfigMap", "Lease", "ReplicationController",
            "ResourceQuota", "LimitRange", "Secret", "ServiceAccount",
            "Role", "RoleBinding", "HorizontalPodAutoscaler"):
        meta.namespace = "default"
    return obj


def merge_secret_string_data(obj) -> None:
    """stringData is write-only convenience, merged into data as base64 on
    BOTH create and update (ref: pkg/registry/core/secret strategy
    PrepareForCreate AND PrepareForUpdate)."""
    if getattr(obj, "string_data", None):
        import base64
        for k, v in obj.string_data.items():
            obj.data[k] = base64.b64encode(v.encode()).decode()
        obj.string_data = {}


def service_cluster_ip(namespace: str, name: str, salt: int = 0) -> str:
    """Deterministic address in the 10.96/12 service range."""
    import hashlib
    h = int(hashlib.md5(
        f"{namespace}/{name}/{salt}".encode()).hexdigest(), 16)
    return f"10.{96 + (h >> 16) % 16}.{(h >> 8) % 256}.{h % 254 + 1}"
