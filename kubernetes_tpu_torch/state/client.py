"""Typed client over the Store — the clientset analog.

Ref: staging/src/k8s.io/client-go generated clientsets. One generic
ResourceClient per registered kind (vs 34,948 generated LoC in the reference);
pods get the bind/status subresources the scheduler and node agent use.

Copy of kubernetes_tpu/state/client.py, in-process only. The accessors
and subresources outside the scheduler loop (merge patches, /scale, Jobs,
RBAC, autoscalers, CSRs) raise NotImplementedError until the port serves
those kinds (ROADMAP, the harnesses and commands item).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple, Type

from ..api import core as corev1
from ..api import labels as labelsmod
from ..api import serde
from ..api.defaults import default as apply_defaults
from ..api.meta import LabelSelector
from ..api.validation import validate as validate_obj
from ..runtime.scheme import SCHEME, Scheme
from .store import Store, Watch


def _unported(what: str):
    return NotImplementedError(
        f"Client: {what} is not ported yet (ROADMAP: harnesses and "
        f"commands)")


class ResourceClient:
    def __init__(self, store: Store, scheme: Scheme, cls: Type,
                 namespace: Optional[str] = None, *, validate: bool = True):
        self._store = store
        self._scheme = scheme
        self._cls = cls
        self._resource = scheme.resource_for(cls)
        self._namespaced = scheme.is_namespaced(cls)
        self._ns = namespace if self._namespaced else ""
        self._validate = validate

    def _effective_ns(self, obj=None) -> str:
        if not self._namespaced:
            return ""
        if obj is not None and obj.metadata.namespace:
            return obj.metadata.namespace
        return self._ns or "default"

    def create(self, obj):
        obj = serde.deepcopy_obj(obj)
        if self._namespaced and not obj.metadata.namespace:
            obj.metadata.namespace = self._effective_ns()
        apply_defaults(obj)
        if isinstance(obj, corev1.Service) and obj.spec.cluster_ip:
            self._resolve_cluster_ip_collision(obj)
        if self._validate:
            validate_obj(obj)
        return self._store.create(self._resource, obj)

    def create_bulk(self, objs) -> list:
        """N creates, one store transaction (defaulting/validation still
        per item). Result slots are stored objects or the Exception that
        rejected that slot — a bad item does not abort its siblings."""
        prepared = []
        slots = []  # index into prepared, or an Exception
        for obj in objs:
            try:
                obj = serde.deepcopy_obj(obj)
                if self._namespaced and not obj.metadata.namespace:
                    obj.metadata.namespace = self._effective_ns()
                apply_defaults(obj)
                if isinstance(obj, corev1.Service) and obj.spec.cluster_ip:
                    self._resolve_cluster_ip_collision(obj)
                if self._validate:
                    validate_obj(obj)
            except Exception as e:
                slots.append(e)
                continue
            slots.append(len(prepared))
            prepared.append(obj)
        stored = self._store.create_bulk(self._resource, prepared)
        return [s if isinstance(s, Exception) else stored[s] for s in slots]

    def _resolve_cluster_ip_collision(self, svc) -> None:
        """The ipallocator's uniqueness guarantee: the hash-derived default
        is salted until it collides with no existing service."""
        from ..api.defaults import service_cluster_ip
        taken = {s.spec.cluster_ip
                 for s, _ in ((o, None) for o in
                              self._store.list("services")[0])
                 if s.metadata.key() != svc.metadata.key()}
        salt = 0
        while svc.spec.cluster_ip in taken and salt < 64:
            salt += 1
            svc.spec.cluster_ip = service_cluster_ip(
                svc.metadata.namespace, svc.metadata.name, salt)

    def get(self, name: str, namespace: Optional[str] = None):
        ns = namespace if namespace is not None else self._effective_ns()
        return self._store.get(self._resource, ns if self._namespaced else "", name)

    def list(self, namespace: Optional[str] = None,
             label_selector: Optional[LabelSelector] = None) -> List[Any]:
        ns = namespace if namespace is not None else (self._ns or None)
        pred: Optional[Callable[[Any], bool]] = None
        if label_selector is not None:
            pred = lambda o: labelsmod.matches(label_selector, o.metadata.labels)
        items, _ = self._store.list(self._resource,
                                    ns if self._namespaced else None, pred)
        return items

    def update(self, obj):
        if isinstance(obj, corev1.Secret):
            obj = serde.deepcopy_obj(obj)
            from ..api.defaults import merge_secret_string_data
            merge_secret_string_data(obj)
        if self._validate:
            validate_obj(obj)
        return self._store.update(self._resource, serde.deepcopy_obj(obj))

    def update_status(self, obj):
        """Status subresource: only .status is applied onto the live object
        (ref: registry strategies split spec/status update paths)."""
        def mutate(cur):
            cur.status = serde.deepcopy_obj(obj.status)
            return cur
        return self._store.guaranteed_update(
            self._resource, self._effective_ns(obj) if self._namespaced else "",
            obj.metadata.name, mutate)

    def patch(self, name: str, mutate: Callable[[Any], Any],
              namespace: Optional[str] = None):
        """Read-modify-write with CAS retry (strategic-merge-patch stand-in)."""
        ns = namespace if namespace is not None else self._effective_ns()
        return self._store.guaranteed_update(
            self._resource, ns if self._namespaced else "", name, mutate)

    def merge_patch(self, name: str, patch: dict,
                    namespace: Optional[str] = None, subresource: str = "",
                    strategic: bool = True):
        """Server-side (strategic) merge patch: needs api/patch.py."""
        raise _unported("merge_patch (api/patch.py)")

    def get_scale(self, name: str, namespace: Optional[str] = None):
        """The /scale subresource: needs api/autoscaling.py."""
        raise _unported("the /scale subresource (api/autoscaling.py)")

    def update_scale(self, name: str, scale,
                     namespace: Optional[str] = None):
        raise _unported("the /scale subresource (api/autoscaling.py)")

    #: ref: the lifecycle plugin's immortalNamespaces — a finalizer-gated
    #: Terminating system namespace would be unrecoverable
    IMMORTAL_NAMESPACES = ("default", "kube-system", "kube-node-lease",
                           "kube-public")

    def delete(self, name: str, namespace: Optional[str] = None,
               resource_version: Optional[str] = None):
        if self._resource == "namespaces" and name in self.IMMORTAL_NAMESPACES:
            raise PermissionError(
                f'namespace "{name}" cannot be deleted')
        ns = namespace if namespace is not None else self._effective_ns()
        return self._store.delete(self._resource, ns if self._namespaced else "",
                                  name, resource_version=resource_version)

    def watch(self, namespace: Optional[str] = None,
              resource_version: Optional[int] = None,
              bookmarks: bool = False) -> Watch:
        # `bookmarks` is accepted for signature parity with the HTTP
        # client and ignored: an in-process watch queue has no heartbeat
        # (and no wire to go quiet on), so there is nothing to bookmark
        ns = namespace if namespace is not None else (self._ns or None)
        return self._store.watch(self._resource,
                                 ns if self._namespaced else None,
                                 resource_version)

    def list_rv(self, namespace: Optional[str] = None):
        """(items, resourceVersion) for reflector list-then-watch."""
        ns = namespace if namespace is not None else (self._ns or None)
        return self._store.list(self._resource, ns if self._namespaced else None)


def _bind_pair_mutator(name: str, node: str, now: Optional[str] = None):
    """Mutator for the slim (name, node) bind form — no Binding object."""
    def mutate(pod):
        if pod.spec.node_name and pod.spec.node_name != node:
            from .store import ConflictError
            raise ConflictError(
                f"pod {name} is already bound to {pod.spec.node_name}")
        apply_bind_fields(pod, node, now)
        return pod
    return mutate


def _slim_bind_record(now: str):
    """slim_fn for bulk bind transactions: the compact {who, where, when}
    record journaled to the WAL ("BIND" op) and served as the negotiated
    slim watch frame — ONE shape consumed by three decoders (WAL replay,
    server watch framing, informer materialization)."""
    def slim(updated):
        return {"namespace": updated.metadata.namespace,
                "name": updated.metadata.name,
                "node": updated.spec.node_name, "ts": now}
    return slim


def apply_bind_fields(pod, node: str, ts: Optional[str] = None) -> None:
    """The exact field set a bind mutates — spec.nodeName + the
    PodScheduled condition. Shared by the bind mutator, WAL replay of
    slim BIND records, and the watch client's slim-frame application, so
    all three produce byte-identical objects for one bind."""
    pod.spec.node_name = node
    _set_pod_condition(pod, "PodScheduled", "True", "", now=ts)


def _bind_mutator(binding: corev1.Binding, now: Optional[str] = None):
    return _bind_pair_mutator(binding.metadata.name, binding.target.name,
                              now)


class TooManyDisruptions(Exception):
    """Eviction refused by a PodDisruptionBudget (HTTP 429 analog —
    callers back off and retry, ref: eviction.go's TooManyRequests)."""


class PodClient(ResourceClient):
    def bind(self, binding: corev1.Binding):
        """The scheduler's bind subresource: sets spec.nodeName
        (ref: pkg/registry/core/pod/rest BindingREST.Create). The bind
        mutator only touches spec.nodeName + status.conditions, so the
        read-side copy is the shallow bind clone, not a full deepcopy."""
        ns = binding.metadata.namespace or self._effective_ns()
        return self._store.guaranteed_update("pods", ns, binding.metadata.name,
                                             _bind_mutator(binding),
                                             copy_fn=serde.shallow_bind_clone)

    def evict(self, name: str, namespace: Optional[str] = None):
        """The pods/eviction subresource: a PDB-guarded delete (ref:
        pkg/registry/core/pod/storage/eviction.go:51-85). With a matching
        PodDisruptionBudget, the delete is admitted only while
        status.disruptions_allowed > 0 — decremented atomically (CAS) with
        the pod recorded in status.disrupted_pods — else it raises
        TooManyDisruptions (HTTP 429, the drain retries). Without a PDB
        the eviction is a plain delete."""
        from ..api import labels as labelsmod
        from ..api.policy import PodDisruptionBudget
        from ..utils.clock import now_iso
        ns = namespace if namespace is not None else self._effective_ns()
        pod = self.get(name, namespace=ns)
        pdbs = []
        for pdb in ResourceClient(self._store, self._scheme,
                                  PodDisruptionBudget, ns).list(namespace=ns):
            if pdb.spec.selector is not None and labelsmod.matches(
                    pdb.spec.selector, pod.metadata.labels):
                pdbs.append(pdb)
        if len(pdbs) > 1:
            # the reference refuses to guess which budget governs
            raise ValueError(
                f"pod {name} matches multiple PodDisruptionBudgets")
        if pdbs:
            pdb = pdbs[0]

            def mutate(cur):
                if cur.status.disruptions_allowed < 1:
                    raise TooManyDisruptions(
                        f"cannot evict pod {name}: disruption budget "
                        f"{cur.metadata.name} needs "
                        f"{cur.spec.min_available or cur.spec.max_unavailable}"
                        f" and has no disruptions allowed")
                cur.status.disruptions_allowed -= 1
                cur.status.disrupted_pods[name] = now_iso()
                return cur
            self._store.guaranteed_update(
                "poddisruptionbudgets", ns, pdb.metadata.name, mutate)
            try:
                return self.delete(name, namespace=ns)
            except Exception:
                # the budget slot was consumed but no disruption happened
                # (pod deleted concurrently, store error): hand it back,
                # or sibling evictions stay blocked until the disruption
                # controller resyncs — the reference only charges a
                # SUCCESSFUL eviction

                def refund(cur):
                    # only while OUR charge is still outstanding: if the
                    # disruption controller resynced in between it already
                    # recomputed the budget from live pods, and a blind
                    # +1 would over-credit past the PDB
                    if name in cur.status.disrupted_pods:
                        cur.status.disruptions_allowed += 1
                        del cur.status.disrupted_pods[name]
                    return cur
                from .store import NotFoundError as _NF
                try:
                    self._store.guaranteed_update(
                        "poddisruptionbudgets", ns, pdb.metadata.name,
                        refund)
                except _NF:
                    pass  # PDB itself deleted mid-flight: nothing to refund
                except Exception:
                    # unexpected refund failure (CAS exhaustion under
                    # contention): the slot leaks until the disruption
                    # controller resyncs — surface it, don't hide it
                    import logging
                    logging.getLogger("eviction").warning(
                        "failed to refund disruption budget %s/%s after "
                        "a failed eviction delete", ns, pdb.metadata.name)
                raise
        return self.delete(name, namespace=ns)

    def bind_bulk_pairs(self, namespace: str,
                        pairs: List[Tuple[str, str]]) -> List[Any]:
        """bind_bulk without per-item Binding objects: (podName, nodeName)
        pairs straight into one store transaction — the server's BindList
        fast path (3 dataclass constructions per pod saved on the hot
        wire path)."""
        from ..utils.clock import now_iso
        now = now_iso()
        items = [(namespace, name, _bind_pair_mutator(name, node, now))
                 for name, node in pairs]
        return self._store.bulk_apply("pods", items,
                                      copy_fn=serde.shallow_bind_clone,
                                      slim_fn=_slim_bind_record(now))

    def bind_bulk(self, bindings: List[corev1.Binding]) -> List[Any]:
        """N binds in one store transaction (the batch scheduler's bind
        phase). Result slots are bound Pods or the Exception that rejected
        that slot (NotFound for deleted-in-flight, Conflict for double
        bind)."""
        from ..utils.clock import now_iso
        now = now_iso()  # one timestamp per transaction, not one per pod
        items = [(b.metadata.namespace or self._effective_ns(),
                  b.metadata.name, _bind_mutator(b, now=now)) for b in bindings]
        return self._store.bulk_apply("pods", items,
                                      copy_fn=serde.shallow_bind_clone,
                                      slim_fn=_slim_bind_record(now))


def _set_pod_condition(pod, ctype: str, status: str, reason: str,
                       now: Optional[str] = None) -> None:
    from ..utils.clock import now_iso
    for cond in pod.status.conditions:
        if cond.type == ctype:
            if cond.status != status:
                cond.status = status
                cond.reason = reason
                cond.last_transition_time = now or now_iso()
            return
    pod.status.conditions.append(corev1.PodCondition(
        type=ctype, status=status, reason=reason,
        last_transition_time=now or now_iso()))


class Client:
    """The clientset: one accessor per resource, namespace-scoped views."""

    def __init__(self, store: Optional[Store] = None, scheme: Scheme = SCHEME,
                 *, validate: bool = True):
        self.store = store if store is not None else Store()
        self.scheme = scheme
        self._validate = validate

    def resource(self, cls: Type, namespace: Optional[str] = None) -> ResourceClient:
        if cls is corev1.Pod:
            return PodClient(self.store, self.scheme, cls, namespace,
                             validate=self._validate)
        return ResourceClient(self.store, self.scheme, cls, namespace,
                              validate=self._validate)

    # convenience accessors, mirroring clientset.CoreV1().Pods(ns) etc.
    def pods(self, namespace: Optional[str] = None) -> PodClient:
        return self.resource(corev1.Pod, namespace)  # type: ignore[return-value]

    def nodes(self) -> ResourceClient:
        return self.resource(corev1.Node)

    def services(self, namespace: Optional[str] = None) -> ResourceClient:
        return self.resource(corev1.Service, namespace)

    def endpoints(self, namespace: Optional[str] = None) -> ResourceClient:
        return self.resource(corev1.Endpoints, namespace)

    def namespaces(self) -> ResourceClient:
        return self.resource(corev1.Namespace)

    def events(self, namespace: Optional[str] = None) -> ResourceClient:
        return self.resource(corev1.Event, namespace)

    def persistent_volumes(self) -> ResourceClient:
        return self.resource(corev1.PersistentVolume)

    def persistent_volume_claims(self, namespace: Optional[str] = None) -> ResourceClient:
        return self.resource(corev1.PersistentVolumeClaim, namespace)

    def replication_controllers(self, namespace: Optional[str] = None) -> ResourceClient:
        return self.resource(corev1.ReplicationController, namespace)

    def deployments(self, namespace: Optional[str] = None) -> ResourceClient:
        from ..api.apps import Deployment
        return self.resource(Deployment, namespace)

    def replica_sets(self, namespace: Optional[str] = None) -> ResourceClient:
        from ..api.apps import ReplicaSet
        return self.resource(ReplicaSet, namespace)

    def stateful_sets(self, namespace: Optional[str] = None) -> ResourceClient:
        from ..api.apps import StatefulSet
        return self.resource(StatefulSet, namespace)

    def daemon_sets(self, namespace: Optional[str] = None) -> ResourceClient:
        from ..api.apps import DaemonSet
        return self.resource(DaemonSet, namespace)

    def jobs(self, namespace: Optional[str] = None) -> ResourceClient:
        raise _unported("the jobs accessor (api/batch.py)")

    def pod_disruption_budgets(self, namespace: Optional[str] = None) -> ResourceClient:
        from ..api.policy import PodDisruptionBudget
        return self.resource(PodDisruptionBudget, namespace)

    def priority_classes(self) -> ResourceClient:
        from ..api.policy import PriorityClass
        return self.resource(PriorityClass)

    def storage_classes(self) -> ResourceClient:
        from ..api.policy import StorageClass
        return self.resource(StorageClass)

    def leases(self, namespace: Optional[str] = None) -> ResourceClient:
        from ..api.policy import Lease
        return self.resource(Lease, namespace)

    def resource_quotas(self, namespace: Optional[str] = None) -> ResourceClient:
        from ..api.core import ResourceQuota
        return self.resource(ResourceQuota, namespace)

    def limit_ranges(self, namespace: Optional[str] = None) -> ResourceClient:
        from ..api.core import LimitRange
        return self.resource(LimitRange, namespace)

    def config_maps(self, namespace: Optional[str] = None) -> ResourceClient:
        from ..api.core import ConfigMap
        return self.resource(ConfigMap, namespace)

    def secrets(self, namespace: Optional[str] = None) -> ResourceClient:
        from ..api.core import Secret
        return self.resource(Secret, namespace)

    def service_accounts(self, namespace: Optional[str] = None) -> ResourceClient:
        from ..api.core import ServiceAccount
        return self.resource(ServiceAccount, namespace)

    def pod_groups(self, namespace: Optional[str] = None) -> ResourceClient:
        from ..api.scheduling import PodGroup
        return self.resource(PodGroup, namespace)

    def roles(self, namespace: Optional[str] = None) -> ResourceClient:
        raise _unported("the roles accessor (api/rbac.py)")

    def cluster_roles(self) -> ResourceClient:
        raise _unported("the cluster_roles accessor (api/rbac.py)")

    def role_bindings(self, namespace: Optional[str] = None) -> ResourceClient:
        raise _unported("the role_bindings accessor (api/rbac.py)")

    def cluster_role_bindings(self) -> ResourceClient:
        raise _unported("the cluster_role_bindings accessor (api/rbac.py)")

    def horizontal_pod_autoscalers(self, namespace: Optional[str] = None) -> ResourceClient:
        raise _unported("the horizontal_pod_autoscalers accessor "
                        "(api/autoscaling.py)")

    def certificate_signing_requests(self) -> ResourceClient:
        raise _unported("the certificate_signing_requests accessor "
                        "(api/certificates.py)")
