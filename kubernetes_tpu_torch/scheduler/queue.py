"""The nominated-pod map of the scheduling queue.

Copy of kubernetes_tpu/scheduler/queue.py's NominatedPodMap: the only part
of the queue the batch scheduler reads (its reservation overlay). The
SchedulingQueue itself belongs to the scheduler loop (ROADMAP, port
slice 2).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from ..api.core import Pod


class NominatedPodMap:
    """node name -> pods nominated to it by preemption
    (ref: scheduling_queue.go nominatedPodMap). Thread-safe: the informer
    thread mutates it while the scheduling thread reads it to build the
    kernel's reservation tensors; `version` lets readers cache by change."""

    def __init__(self):
        self._lock = threading.Lock()
        self._by_node: Dict[str, List[Pod]] = {}
        self._node_of: Dict[str, str] = {}
        self.version = 0

    def add(self, pod: Pod, node_name: str = "") -> None:
        with self._lock:
            self._delete_locked(pod)
            nn = node_name or pod.status.nominated_node_name
            if not nn:
                return
            self._node_of[pod.metadata.key()] = nn
            self._by_node.setdefault(nn, []).append(pod)
            self.version += 1

    def delete(self, pod: Pod) -> None:
        with self._lock:
            self._delete_locked(pod)

    def _delete_locked(self, pod: Pod) -> None:
        key = pod.metadata.key()
        nn = self._node_of.pop(key, None)
        if nn is None:
            return
        pods = self._by_node.get(nn, [])
        self._by_node[nn] = [p for p in pods if p.metadata.key() != key]
        if not self._by_node[nn]:
            del self._by_node[nn]
        self.version += 1

    def pods_for_node(self, node_name: str) -> List[Pod]:
        with self._lock:
            return list(self._by_node.get(node_name, ()))

    def node_for(self, pod_key: str) -> Optional[str]:
        with self._lock:
            return self._node_of.get(pod_key)

    def by_node(self) -> Dict[str, List[Pod]]:
        with self._lock:
            return {n: list(ps) for n, ps in self._by_node.items()}

