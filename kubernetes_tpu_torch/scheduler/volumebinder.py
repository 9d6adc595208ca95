"""Volume binding for the scheduler — delayed PV topology check & bind.

Ref: pkg/scheduler/volumebinder/volume_binder.go (66 LoC wrapper) over
pkg/controller/volume/scheduling SchedulerVolumeBinder (scheduler_binder.go):
  FindPodVolumes    -> the CheckVolumeBinding predicate
  AssumePodVolumes  -> pick PVs for unbound claims in scheduleOne, pre-bind
  BindPodVolumes    -> API writes in the async bind path
plus the reference's PV matching rules (pkg/controller/volume/persistentvolume
pv_controller: findBestMatchForClaim — capacity, access modes, storage class,
selector, node affinity, phase).

Unbound PVCs whose StorageClass uses volumeBindingMode=WaitForFirstConsumer
bind here (topology-aware); Immediate-mode claims are the PV controller's job
and FindPodVolumes only requires them to already be bound.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple

from ..api import helpers, labels as labelsmod, wellknown
from ..api.core import (Node, NodeSelector, NodeSelectorRequirement,
                        NodeSelectorTerm, PersistentVolume,
                        PersistentVolumeClaim, Pod)
from ..api.quantity import Quantity


def _pv_node_affinity_matches(pv: PersistentVolume, node: Node) -> bool:
    """VolumeNodeAffinity.required (ref: CheckNodeAffinity,
    pkg/volume/util.CheckNodeAffinity)."""
    na = pv.spec.node_affinity
    if not na or not na.get("required"):
        return True
    terms = []
    for t in na["required"].get("nodeSelectorTerms", []):
        terms.append(NodeSelectorTerm(
            match_expressions=[NodeSelectorRequirement(
                key=r.get("key", ""), operator=r.get("operator", ""),
                values=list(r.get("values", [])))
                for r in t.get("matchExpressions", [])],
            match_fields=[NodeSelectorRequirement(
                key=r.get("key", ""), operator=r.get("operator", ""),
                values=list(r.get("values", [])))
                for r in t.get("matchFields", [])]))
    return helpers.match_node_selector_terms(terms, node)


def _pv_matches_claim(pv: PersistentVolume, pvc: PersistentVolumeClaim,
                      node: Optional[Node]) -> bool:
    """findBestMatchForClaim's per-PV check."""
    if pv.status.phase != "Available":
        return False
    if pv.spec.claim_ref is not None:
        return False
    pv_class = pv.spec.storage_class_name or ""
    pvc_class = pvc.spec.storage_class_name or ""
    if pv_class != pvc_class:
        return False
    if not set(pvc.spec.access_modes) <= set(pv.spec.access_modes):
        return False
    if pvc.spec.selector is not None and \
            not labelsmod.matches(pvc.spec.selector, pv.metadata.labels):
        return False
    want = pvc.spec.resources.requests.get(wellknown.RESOURCE_STORAGE)
    have = pv.spec.capacity.get(wellknown.RESOURCE_STORAGE)
    if want is not None:
        if have is None or have.value() < want.value():
            return False
    if node is not None and not _pv_node_affinity_matches(pv, node):
        return False
    return True


class VolumeBinder:
    """In-process SchedulerVolumeBinder. Listers are callables so both
    informer indexers and test fakes plug in."""

    def __init__(self,
                 pvc_lister: Callable[[str, str], Optional[PersistentVolumeClaim]],
                 pv_lister: Callable[[], List[PersistentVolume]],
                 sc_lister: Callable[[str], Optional[object]] = lambda name: None,
                 client=None):
        self.pvc_lister = pvc_lister
        self.pv_lister = pv_lister
        self.sc_lister = sc_lister
        self.client = client
        self._lock = threading.Lock()
        # pod key -> [(pvc, pv_name)] assumed provisional bindings
        self._assumed: Dict[str, List[Tuple[PersistentVolumeClaim, str]]] = {}
        # pv name -> pod key holding a provisional claim on it
        self._reserved: Dict[str, str] = {}

    # ------------------------------------------------------------- queries

    def _pod_claims(self, pod: Pod) -> List[PersistentVolumeClaim]:
        claims = []
        for vol in pod.spec.volumes:
            if not vol.persistent_volume_claim:
                continue
            pvc = self.pvc_lister(pod.metadata.namespace,
                                  vol.persistent_volume_claim.claim_name)
            if pvc is not None:
                claims.append(pvc)
        return claims

    def _is_wait_for_first_consumer(self, pvc: PersistentVolumeClaim) -> bool:
        sc = self.sc_lister(pvc.spec.storage_class_name or "")
        mode = getattr(sc, "volume_binding_mode", None) if sc else None
        return mode == "WaitForFirstConsumer"

    def _select_unbound_locked(self, pod: Pod, node: Node,
                               exclude: Optional[set] = None
                               ) -> Optional[List[Tuple[PersistentVolumeClaim, str]]]:
        """One (pvc, pv_name) per unbound claim, or None when any claim has
        no candidate. The single source of PV-selection truth shared by
        find/preview/assume so they can never diverge. An unbound claim whose
        StorageClass is not WaitForFirstConsumer always fails here: Immediate
        binding is the PV controller's job (ref: FindPodVolumes)."""
        taken = set(exclude or ())
        pvs = self.pv_lister()
        chosen: List[Tuple[PersistentVolumeClaim, str]] = []
        for pvc in self._pod_claims(pod):
            if pvc.spec.volume_name:
                continue
            if not self._is_wait_for_first_consumer(pvc):
                return None
            found = None
            for pv in pvs:
                name = pv.metadata.name
                if pv.spec.claim_ref is not None or \
                        pv.status.phase != "Available":
                    # the informer caught up with a completed bind: the
                    # post-bind reservation (kept so the lagging lister
                    # can't re-offer the PV) is no longer needed
                    self._reserved.pop(name, None)
                    continue
                if name in taken:
                    continue
                holder = self._reserved.get(name)
                if holder is not None and holder != pod.metadata.key():
                    continue
                if _pv_matches_claim(pv, pvc, node):
                    found = name
                    break
            if found is None:
                return None
            chosen.append((pvc, found))
            taken.add(found)
        return chosen

    def find_pod_volumes(self, pod: Pod, node: Node) -> bool:
        """CheckVolumeBinding: every bound PV is compatible with the node and
        every unbound WaitForFirstConsumer claim has a candidate PV there
        (ref: scheduler_binder.go FindPodVolumes)."""
        with self._lock:
            pvs = {pv.metadata.name: pv for pv in self.pv_lister()}
            for pvc in self._pod_claims(pod):
                if pvc.spec.volume_name:
                    pv = pvs.get(pvc.spec.volume_name)
                    if pv is None or not _pv_node_affinity_matches(pv, node):
                        return False
            return self._select_unbound_locked(pod, node) is not None

    def preview_bindings(self, pod: Pod, node: Node,
                         exclude: Optional[set] = None) -> Optional[List[str]]:
        """The PV names assume_pod_volumes would reserve, without reserving
        (in-batch repair's cross-pod PV accounting: two winners in one batch
        must not count the same PV). None = some claim has no candidate."""
        with self._lock:
            sel = self._select_unbound_locked(pod, node, exclude)
            return None if sel is None else [name for _, name in sel]

    # ----------------------------------------------------- assume and bind

    def assume_pod_volumes(self, pod: Pod, node: Node) -> bool:
        """Reserve matching PVs for the pod's unbound claims
        (ref: AssumePodVolumes). Returns all_bound (True = nothing to do at
        bind time)."""
        with self._lock:
            bindings = self._select_unbound_locked(pod, node)
            if bindings is None:
                raise ValueError(
                    f"no matching PVs for pod {pod.metadata.key()}")
            for _, pv_name in bindings:
                self._reserved[pv_name] = pod.metadata.key()
            if not bindings:
                return True
            self._assumed[pod.metadata.key()] = bindings
            return False

    def _release(self, pod_key: str,
                 bindings: List[Tuple[PersistentVolumeClaim, str]]) -> None:
        for _, pv_name in bindings:
            if self._reserved.get(pv_name) == pod_key:
                del self._reserved[pv_name]

    def forget_pod_volumes(self, pod: Pod) -> None:
        with self._lock:
            bindings = self._assumed.pop(pod.metadata.key(), [])
            self._release(pod.metadata.key(), bindings)

    def bind_pod_volumes(self, pod: Pod) -> None:
        """API writes: PV.claimRef + PVC.volumeName/Bound
        (ref: BindPodVolumes -> bindAPIUpdate). If the PVC patch fails after
        its PV was claimed (e.g. the claim was deleted in flight), the PV
        patch is rolled back best-effort so the volume is not leaked as
        Bound-to-nothing — the reference leaves this to the PV controller's
        reconcile, which has no equivalent here yet."""
        with self._lock:
            bindings = self._assumed.pop(pod.metadata.key(), [])
        if not bindings or self.client is None:
            return
        claimed: List[str] = []
        try:
            for pvc, pv_name in bindings:
                def set_claim(pv, _pvc=pvc):
                    pv.spec.claim_ref = {
                        "kind": "PersistentVolumeClaim",
                        "namespace": _pvc.metadata.namespace,
                        "name": _pvc.metadata.name,
                        "uid": _pvc.metadata.uid}
                    pv.status.phase = "Bound"
                    return pv
                self.client.persistent_volumes().patch(pv_name, set_claim)
                claimed.append(pv_name)

                def set_volume(cur, _pv=pv_name):
                    cur.spec.volume_name = _pv
                    cur.status.phase = "Bound"
                    return cur
                self.client.persistent_volume_claims(
                    pvc.metadata.namespace).patch(pvc.metadata.name, set_volume)
                claimed.pop()
        except Exception:
            for pv_name in claimed:
                def unclaim(pv):
                    pv.spec.claim_ref = None
                    pv.status.phase = "Available"
                    return pv
                try:
                    self.client.persistent_volumes().patch(pv_name, unclaim)
                except Exception:
                    pass
            with self._lock:
                self._release(pod.metadata.key(), bindings)
            raise
        # success: reservations are NOT released here — the pv_lister reads
        # the informer's (async) view, so an immediate release would let the
        # next pod re-match a PV whose bind it can't see yet. The entries are
        # dropped lazily in _select_unbound_locked once the informer-visible
        # PV shows Bound.

    def bind_pods_volumes(self, pods: List[Pod]) -> None:
        """Atomic multi-claim bind for a released GANG: every member's PV
        claimRef + PVC volumeName write commits, or — on ANY mid-stream
        store failure (deleted-PV race, hub error) — every write already
        made is rolled back: claimed PVs return to Available and bound
        PVCs are unbound again. Without this, a failure on member k left
        members 1..k-1's claims bound while the gang itself rolled back,
        and their retries were volume-pinned to the abandoned slice (the
        scheduler.py RESIDUAL this transaction resolves).

        On failure the members' assumed state and reservations are
        released here (the callers' forget_pod_volumes then no-ops), and
        the original exception is re-raised for the gang rollback path."""
        with self._lock:
            all_bindings = [(pod, self._assumed.pop(pod.metadata.key(), []))
                            for pod in pods]
        if self.client is None or not any(b for _, b in all_bindings):
            return
        #: (kind, pv_name | (ns, pvc_name)) journal of completed writes,
        #: undone in reverse on failure
        done: List[Tuple[str, object]] = []
        try:
            for pod, bindings in all_bindings:
                for pvc, pv_name in bindings:
                    def set_claim(pv, _pvc=pvc):
                        pv.spec.claim_ref = {
                            "kind": "PersistentVolumeClaim",
                            "namespace": _pvc.metadata.namespace,
                            "name": _pvc.metadata.name,
                            "uid": _pvc.metadata.uid}
                        pv.status.phase = "Bound"
                        return pv
                    self.client.persistent_volumes().patch(pv_name,
                                                           set_claim)
                    done.append(("pv", pv_name))

                    def set_volume(cur, _pv=pv_name):
                        cur.spec.volume_name = _pv
                        cur.status.phase = "Bound"
                        return cur
                    self.client.persistent_volume_claims(
                        pvc.metadata.namespace).patch(pvc.metadata.name,
                                                      set_volume)
                    done.append(("pvc", (pvc.metadata.namespace,
                                         pvc.metadata.name)))
        except Exception:
            for kind, ref in reversed(done):
                try:
                    if kind == "pv":
                        def unclaim(pv):
                            pv.spec.claim_ref = None
                            pv.status.phase = "Available"
                            return pv
                        self.client.persistent_volumes().patch(ref, unclaim)
                    else:
                        ns, name = ref
                        def unbind(cur):
                            cur.spec.volume_name = ""
                            cur.status.phase = "Pending"
                            return cur
                        self.client.persistent_volume_claims(ns).patch(
                            name, unbind)
                except Exception:
                    pass  # best effort; the PV controller reconciles
            with self._lock:
                for pod, bindings in all_bindings:
                    self._release(pod.metadata.key(), bindings)
            raise
        # success: reservations stay until the informer shows the PVs Bound
        # (same lazy drop as bind_pod_volumes)


class FakeVolumeBinder:
    """Ref: scheduler_binder_fake.go:66 — everything binds."""

    def find_pod_volumes(self, pod, node) -> bool:
        return True

    def preview_bindings(self, pod, node, exclude=None):
        return []

    def assume_pod_volumes(self, pod, node) -> bool:
        return True

    def forget_pod_volumes(self, pod) -> None:
        pass

    def bind_pod_volumes(self, pod) -> None:
        pass

    def bind_pods_volumes(self, pods) -> None:
        pass
