"""Dominant-resource fair share (DRF) across tenants, on the GPU.

Port of kubernetes_tpu/tenancy/drf.py: the account, its numpy parity
oracles and the drain ordering are the reference's; the two device
programs are the port's CUDA kernels K4 (dominant shares) and K5 (the
batch permutation), launched through tenancy/kernels.py on the
account's device (CUDA unless the caller asks for the CPU, where the
plain versions run). The reference's description follows.

Ghodsi et al.'s DRF assigns each tenant a *dominant share* — the maximum,
over resource kinds, of the tenant's usage divided by cluster capacity —
and a work-conserving fair scheduler serves the tenant with the LOWEST
dominant share first. This module carries that computation the way the
repo carries every scheduling decision: a per-tenant usage tensor
``[T, R]`` updated at each winner commit (one more carried tensor, like
the spread group counts that ride the class carry), a jitted kernel that
turns it into dominant shares and a drain ordering, and a serial numpy
mirror (``dominant_shares_reference`` / ``drf_order_reference``) in the
same parity-oracle role ``price_nodes_reference`` plays for preemption.

The account feeds two consumers:

  - **drain batch ordering** (``order_batch``): a popped batch is
    reordered (priority desc, dominant share asc, pop position) so
    pods of tenants furthest BELOW fair share tensorize first and win
    in-batch contention — priority still dominates (the express-lane
    contract is untouched), DRF only arbitrates within a band. The
    permutation is computed on device and is bit-identical to the
    numpy mirror (f32 arithmetic, same op order, position as the
    unique final sort key).
  - **preemption pricing** (``overshare_ranks``): tenants above fair
    share (1/T of every resource) get a quantized over-share rank; the
    victim tables sort those tenants' pods into a cheaper band, so a
    gang storm's own pods are priced first when capacity must be
    reclaimed.

``KTPU_DRF=0`` disables both consumers — today's priority-then-FIFO
drain and tenant-blind pricing stay byte-identical as the measured
control (the flag pattern of KTPU_CLASS_SCAN / KTPU_PREEMPT_KERNEL).

Charging is idempotent by pod key (charge at assume/bind, release at
terminal/delete/bind-failure), so replays and informer echoes can never
double-count a tenant.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..api import helpers
from ..api.core import Pod

#: the label a workload generator stamps tenants with; pods without it
#: fall back to their namespace (the reference's tenancy boundary)
TENANT_LABEL = "serving.ktpu/tenant"

#: resource columns of the usage tensor: cpu (milli), memory (bytes),
#: TPU devices (summed over tpu-suffixed extended resources)
RESOURCES: Tuple[str, ...] = ("cpu", "memory", "tpu")


def drf_enabled() -> bool:
    """KTPU_DRF=0 pins the drain to priority-then-FIFO and preemption
    to tenant-blind pricing — the measured control."""
    return os.environ.get("KTPU_DRF", "1") != "0"


def tenant_of(pod: Pod) -> str:
    """The pod's tenant: the explicit label, else its namespace."""
    return pod.metadata.labels.get(TENANT_LABEL) \
        or pod.metadata.namespace or "default"


def _pod_vec(pod: Pod) -> np.ndarray:
    """[R] f32 usage row for one pod (requests; max with init
    containers is immaterial at this granularity — the scan's own
    nodeinfo accounting stays the placement truth)."""
    from ..scheduler.nodeinfo import pod_resource
    r = pod_resource(pod)
    tpu = sum(v for k, v in r.scalar_resources.items()
              if k.endswith("tpu") or "/tpu" in k)
    return np.array([r.milli_cpu, r.memory, tpu], np.float32)


# ------------------------------------------------------------- kernels
# _dominant_kernel and _order_kernel of the reference are K4 and K5:
# tenancy/kernels.py drf_dominant / drf_order and csrc/drf_*.cu.


def dominant_shares_reference(usage: np.ndarray,
                              cap: np.ndarray) -> np.ndarray:
    """Numpy mirror of the dominant-share kernel — same op order, f32
    throughout (the parity oracle)."""
    shares = usage.astype(np.float32) \
        / np.maximum(cap.astype(np.float32), np.float32(1.0))
    return np.max(shares, axis=1)


def drf_order_reference(prio: np.ndarray, share: np.ndarray,
                        pos: np.ndarray) -> np.ndarray:
    """Numpy mirror of the drain-order kernel (np.lexsort: last key is
    primary, identical key tuple)."""
    return np.lexsort((pos, share.astype(np.float32), -prio))


class DRFAccount:
    """The per-tenant usage ledger and its device-resident carry.

    Tenants are registered on first sight (index order is first-charge
    order, which is deterministic under the harnesses' sorted-key
    stepping); the usage tensor grows by doubling so the jitted kernels
    recompile O(log T) times. All mutation is under one lock — charges
    come from the commit path, releases from informer event handlers.
    """

    def __init__(self, device=None):
        from ..scheduler.core import resolve_device
        self._lock = threading.Lock()
        #: where K4/K5 run (CUDA unless the caller asks for the CPU)
        self.device = resolve_device(device)
        self._idx: Dict[str, int] = {}
        self._names: List[str] = []
        self._usage = np.zeros((4, len(RESOURCES)), np.float32)
        #: pod key -> (tenant index, charged [R] vector): idempotence
        #: and exact-release bookkeeping in one map
        self._charged: Dict[str, Tuple[int, np.ndarray]] = {}
        self._capacity = np.ones((len(RESOURCES),), np.float32)
        self._cap_nodes = -1  # node-count fingerprint of _capacity

    # ------------------------------------------------------- registry

    def tenant_index(self, tenant: str) -> int:
        i = self._idx.get(tenant)
        if i is None:
            i = len(self._names)
            self._idx[tenant] = i
            self._names.append(tenant)
            if i >= self._usage.shape[0]:
                grown = np.zeros((self._usage.shape[0] * 2,
                                  len(RESOURCES)), np.float32)
                grown[:self._usage.shape[0]] = self._usage
                self._usage = grown
        return i

    @property
    def tenants(self) -> List[str]:
        with self._lock:
            return list(self._names)

    # ------------------------------------------------------- capacity

    def set_capacity(self, cap: Sequence[float]) -> None:
        with self._lock:
            self._capacity = np.asarray(cap, np.float32)
            self._cap_nodes = -2  # pinned: ensure_capacity won't overwrite

    def ensure_capacity(self, node_infos: Dict[str, object]) -> None:
        """Refresh cluster capacity from the snapshot's node set. Cheap
        re-entry guard: recompute only when the node COUNT changed
        (allocatable churn without add/remove is rare and self-corrects
        on the next topology change)."""
        with self._lock:
            if self._cap_nodes == -2 or len(node_infos) == self._cap_nodes:
                return
            cap = np.zeros((len(RESOURCES),), np.float32)
            for ni in node_infos.values():
                alloc = ni.allocatable
                cap[0] += alloc.milli_cpu
                cap[1] += alloc.memory
                cap[2] += sum(
                    v for k, v in alloc.scalar_resources.items()
                    if k.endswith("tpu") or "/tpu" in k)
            self._capacity = np.maximum(cap, np.float32(1.0))
            self._cap_nodes = len(node_infos)

    # ------------------------------------------------------ the ledger

    def charge(self, pod: Pod) -> None:
        """Winner commit: add the pod's vector to its tenant's row
        (no-op when this key is already charged)."""
        key = pod.metadata.key()
        with self._lock:
            if key in self._charged:
                return
            vec = _pod_vec(pod)
            t = self.tenant_index(tenant_of(pod))
            self._usage[t] += vec
            self._charged[key] = (t, vec)

    def release(self, pod: Pod) -> None:
        self.release_key(pod.metadata.key())

    def release_key(self, key: str) -> None:
        """Terminal phase / delete / failed bind: return the charged
        vector (exact — the vector that was charged, not a recompute)."""
        with self._lock:
            rec = self._charged.pop(key, None)
            if rec is None:
                return
            t, vec = rec
            self._usage[t] = np.maximum(
                self._usage[t] - vec, np.float32(0.0))

    # ------------------------------------------------------- consumers

    def _snapshot(self) -> Tuple[np.ndarray, np.ndarray, Dict[str, int]]:
        with self._lock:
            T = max(1, len(self._names))
            return (self._usage[:T].copy(), self._capacity.copy(),
                    dict(self._idx))

    def dominant_shares(self) -> np.ndarray:
        """[T] dominant shares via the device kernel (K4)."""
        from .kernels import drf_dominant
        usage, cap, _ = self._snapshot()
        return drf_dominant(torch.from_numpy(usage).to(self.device),
                            torch.from_numpy(cap).to(self.device)
                            ).cpu().numpy()

    def share_of(self, tenant: str) -> float:
        usage, cap, idx = self._snapshot()
        i = idx.get(tenant)
        if i is None or i >= usage.shape[0]:
            return 0.0
        return float(dominant_shares_reference(usage, cap)[i])

    #: below this batch size the numpy mirror runs instead of the device
    #: kernel — the permutation is identical (the parity contract), and
    #: a device round-trip per tiny batch costs more than it parallelizes
    DEVICE_FLOOR = 64

    def order_batch(self, pods: List[Pod]) -> List[Pod]:
        """Reorder a popped batch: priority desc (the express-lane
        contract), dominant share asc (tenants furthest below fair
        share first), pop position as the unique tie-break. Bit-
        identical to order_batch_reference over the same inputs."""
        if len(pods) < 2:
            return list(pods)
        if len(pods) < self.DEVICE_FLOOR:
            return self.order_batch_reference(pods)
        with self._lock:
            tidx = np.array([self.tenant_index(tenant_of(p))
                             for p in pods], np.int32)
            T = max(1, len(self._names))
            usage = self._usage[:T].copy()
            cap = self._capacity.copy()
        from .kernels import drf_dominant, drf_order
        dev = self.device
        shares = drf_dominant(torch.from_numpy(usage).to(dev),
                              torch.from_numpy(cap).to(dev))
        prio = np.array([helpers.pod_priority(p) for p in pods], np.int32)
        pos = np.arange(len(pods), dtype=np.int32)
        # K5 gathers shares[tidx] on the card; every index was registered
        # above, so it lies in [0, T)
        perm = drf_order(torch.from_numpy(prio).to(dev), shares,
                         torch.from_numpy(tidx).to(dev),
                         torch.from_numpy(pos).to(dev)).cpu().numpy()
        return [pods[int(i)] for i in perm]

    def order_batch_reference(self, pods: List[Pod]) -> List[Pod]:
        """The serial numpy mirror of order_batch (parity surface)."""
        if len(pods) < 2:
            return list(pods)
        with self._lock:
            tidx = np.array([self.tenant_index(tenant_of(p))
                             for p in pods], np.int32)
            T = max(1, len(self._names))
            usage = self._usage[:T].copy()
            cap = self._capacity.copy()
        shares = dominant_shares_reference(usage, cap)[tidx]
        prio = np.array([helpers.pod_priority(p) for p in pods], np.int32)
        pos = np.arange(len(pods), dtype=np.int32)
        perm = drf_order_reference(prio, shares, pos)
        return [pods[int(i)] for i in perm]

    def overshare_ranks(self) -> Dict[str, int]:
        """tenant -> quantized rank ABOVE the equal fair share (1/T per
        resource); tenants at/below fair share are absent. The victim
        tables fold this into the eviction band order — integer
        quantization (1e6 steps) keeps the host sort exact."""
        usage, cap, idx = self._snapshot()
        if not idx:
            return {}
        shares = dominant_shares_reference(usage, cap)
        fair = np.float32(1.0) / np.float32(max(1, len(idx)))
        out: Dict[str, int] = {}
        for name, i in idx.items():
            q = int(round(float(shares[i] - fair) * 1_000_000))
            if q > 0:
                out[name] = q
        return out

    def report(self) -> dict:
        """Per-tenant usage/share snapshot for /debug/pending and the
        bench's isolation section."""
        usage, cap, idx = self._snapshot()
        shares = dominant_shares_reference(usage, cap)
        return {
            "capacity": {r: float(cap[i])
                         for i, r in enumerate(RESOURCES)},
            "tenants": {
                name: {
                    "dominant_share": round(float(shares[i]), 6),
                    "usage": {r: float(usage[i, j])
                              for j, r in enumerate(RESOURCES)},
                } for name, i in sorted(idx.items())},
        }
