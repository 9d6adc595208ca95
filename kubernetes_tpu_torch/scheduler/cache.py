"""Scheduler cache — authoritative in-memory cluster state with assumed pods.

Ref: pkg/scheduler/internal/cache/{cache.go,interface.go,node_tree.go}.

Pod state machine (interface.go:40-120):
    informer Add/Update/Delete  ->  add_pod / update_pod / remove_pod
    assume_pod  ->  (in-flight bind; counted against the node immediately)
    finish_binding  ->  starts the assumed-pod TTL
    confirmed by informer add  ->  assumed flag cleared
    TTL expiry without confirmation  ->  expired, removed (self-heal for lost
    bind confirmations)
    forget_pod  ->  bind failed, undo

Snapshots are O(delta): every NodeInfo mutation bumps a global monotonic
generation; `update_snapshot` copies only nodes whose generation exceeds the
snapshot's (ref: cache.go:210-246 UpdateNodeInfoSnapshot). The same dirty feed
drives the incremental tensor mirror (tensorize.py).
"""

from __future__ import annotations

import itertools
import threading
from typing import Callable, Dict, List, Optional, Set

from ..api.core import Node, Pod
from ..utils.clock import Clock, REAL_CLOCK
from .nodeinfo import NodeInfo

DEFAULT_ASSUMED_POD_TTL = 30.0  # ref: factory.go podInitialBackoff... 30s TTL


class Snapshot:
    """A frozen view of the cache the scheduling cycle works against
    (ref: NodeInfoSnapshot). node_infos maps name -> cloned NodeInfo."""

    def __init__(self):
        self.node_infos: Dict[str, NodeInfo] = {}
        self.generation = 0

    @property
    def node_names(self) -> List[str]:
        return list(self.node_infos)


class Cache:
    def __init__(self, clock: Clock = REAL_CLOCK, ttl: float = DEFAULT_ASSUMED_POD_TTL):
        self._clock = clock
        self._ttl = ttl
        self._lock = threading.RLock()
        self.mutation_seq = 0
        self._generation = itertools.count(1)
        self._nodes: Dict[str, NodeInfo] = {}
        # pod key -> (pod, node_name); membership in _assumed marks in-flight
        self._pod_states: Dict[str, Pod] = {}
        self._assumed: Set[str] = set()
        self._assumed_deadline: Dict[str, float] = {}
        self._node_tree = NodeTree()

    @property
    def lock(self):
        """The cache's RLock (reentrant). The pipelined drain takes it to
        make {assume_pod + its own-mutation counter bump} and
        {mutation_seq vs counter comparison} atomic steps — the chain
        validity protocol between the commit thread and the launch path
        (scheduler._tracked_assume / _chain_intact)."""
        return self._lock

    def node_names(self) -> List[str]:
        with self._lock:
            return list(self._nodes)

    def pod_keys(self, include_assumed: bool = True) -> List[str]:
        """Cached pod keys (debugger/comparer introspection)."""
        with self._lock:
            if include_assumed:
                return list(self._pod_states)
            return [k for k in self._pod_states if k not in self._assumed]

    def pod_keys_snapshot(self):
        """(confirmed, assumed) under ONE lock acquisition — the comparer
        needs both from the same instant or a bind between two calls makes
        the race detector itself report a phantom divergence."""
        with self._lock:
            assumed = set(self._assumed)
            confirmed = {k for k in self._pod_states if k not in assumed}
            return confirmed, assumed

    def _bump(self, ni: NodeInfo) -> None:
        ni.generation = next(self._generation)
        # monotonic mutation counter: the pipelined drain chains device usage
        # only while every mutation since its last launch came from its own
        # assume_pod calls (scheduler.drain_pipelined's chain_seq check)
        self.mutation_seq += 1

    def _node_info(self, name: str) -> NodeInfo:
        ni = self._nodes.get(name)
        if ni is None:
            ni = NodeInfo()
            self._nodes[name] = ni
        return ni

    # ------------------------------------------------------------- pods

    def assume_pod(self, pod: Pod) -> None:
        with self._lock:
            key = pod.metadata.key()
            if key in self._pod_states:
                raise ValueError(f"pod {key} is already in the cache")
            ni = self._node_info(pod.spec.node_name)
            ni.add_pod(pod)
            self._bump(ni)
            self._pod_states[key] = pod
            self._assumed.add(key)

    def assigned_node(self, key: str) -> Optional[str]:
        """Node the cache currently holds this pod on (None if absent) —
        the bind path uses it to tell its own racing confirm event apart
        from a genuine duplicate."""
        with self._lock:
            pod = self._pod_states.get(key)
            return pod.spec.node_name if pod is not None else None

    def finish_binding(self, pod: Pod) -> None:
        with self._lock:
            key = pod.metadata.key()
            if key in self._assumed:
                self._assumed_deadline[key] = self._clock.now() + self._ttl

    def forget_pod(self, pod: Pod) -> None:
        with self._lock:
            key = pod.metadata.key()
            if key not in self._assumed:
                raise ValueError(f"pod {key} is not assumed")
            self._remove_pod_state(key)

    def forget_pods(self, pods) -> int:
        """Roll back a set of assumed reservations in ONE lock acquisition
        — the gang permit-timeout path drops a whole gang's reservations
        atomically, so no scheduling cycle can observe a half-rolled-back
        gang. Pods no longer assumed (confirmed or already forgotten) are
        skipped; returns the number actually rolled back."""
        with self._lock:
            n = 0
            for pod in pods:
                key = pod.metadata.key()
                if key in self._assumed:
                    self._remove_pod_state(key)
                    n += 1
            return n

    def _remove_pod_state(self, key: str) -> None:
        pod = self._pod_states.pop(key)
        self._assumed.discard(key)
        self._assumed_deadline.pop(key, None)
        ni = self._nodes.get(pod.spec.node_name)
        if ni is not None:
            ni.remove_pod(pod)
            self._bump(ni)
            if ni.node is None and not ni.pods:
                del self._nodes[pod.spec.node_name]

    def add_pod(self, pod: Pod) -> None:
        """Informer confirmed an assigned pod (ref: cache.go AddPod)."""
        with self._lock:
            key = pod.metadata.key()
            if key in self._assumed:
                cached = self._pod_states[key]
                if cached.spec.node_name != pod.spec.node_name:
                    # assumed to the wrong node; fix up
                    self._remove_pod_state(key)
                    ni = self._node_info(pod.spec.node_name)
                    ni.add_pod(pod)
                    self._bump(ni)
                    self._pod_states[key] = pod
                else:
                    self._assumed.discard(key)
                    self._assumed_deadline.pop(key, None)
                    self._pod_states[key] = pod
                return
            if key in self._pod_states:
                return  # duplicate add
            ni = self._node_info(pod.spec.node_name)
            ni.add_pod(pod)
            self._bump(ni)
            self._pod_states[key] = pod

    def update_pod(self, old: Pod, new: Pod) -> None:
        with self._lock:
            key = old.metadata.key()
            if key in self._assumed:
                return  # informer lag; the Add confirmation handles it
            if key in self._pod_states:
                self._remove_pod_state(key)
            ni = self._node_info(new.spec.node_name)
            ni.add_pod(new)
            self._bump(ni)
            self._pod_states[key] = new

    def remove_pod(self, pod: Pod) -> None:
        with self._lock:
            key = pod.metadata.key()
            if key in self._pod_states:
                self._remove_pod_state(key)

    def is_assumed_pod(self, pod: Pod) -> bool:
        with self._lock:
            return pod.metadata.key() in self._assumed

    def assumed_pods(self) -> List[Pod]:
        """The in-flight (assumed, unconfirmed) pods — the set the chaos
        invariant checker sweeps for reservations pinned to dead nodes."""
        with self._lock:
            return [self._pod_states[k] for k in self._assumed]

    def get_pod(self, pod: Pod) -> Optional[Pod]:
        with self._lock:
            return self._pod_states.get(pod.metadata.key())

    # ------------------------------------------------------------- nodes

    def add_node(self, node: Node) -> None:
        with self._lock:
            ni = self._node_info(node.metadata.name)
            ni.set_node(node)
            self._bump(ni)
            self._node_tree.add(node)

    def update_node(self, old: Node, new: Node) -> None:
        with self._lock:
            ni = self._node_info(new.metadata.name)
            ni.set_node(new)
            self._bump(ni)
            self._node_tree.update(old, new)

    def remove_node(self, node: Node) -> None:
        with self._lock:
            name = node.metadata.name
            ni = self._nodes.get(name)
            if ni is None:
                return
            ni.node = None
            self._bump(ni)
            if not ni.pods:
                del self._nodes[name]
            self._node_tree.remove(node)

    def node_count(self) -> int:
        with self._lock:
            return sum(1 for ni in self._nodes.values() if ni.node is not None)

    # ---------------------------------------------------------- snapshot

    def cleanup_expired_assumed_pods(self) -> int:
        """Ref: cache.go cleanupAssumedPods (run periodically). Returns the
        number of expired pods removed."""
        with self._lock:
            now = self._clock.now()
            expired = [k for k, dl in self._assumed_deadline.items() if dl <= now]
            for key in expired:
                self._remove_pod_state(key)
            return len(expired)

    def update_snapshot(self, snapshot: Snapshot) -> List[str]:
        """Copy nodes whose generation > snapshot.generation into the
        snapshot; remove deleted nodes. Returns the dirty node names —
        the delta feed for the tensor mirror (ref: cache.go:210-246)."""
        with self._lock:
            dirty: List[str] = []
            max_gen = snapshot.generation
            for name, ni in self._nodes.items():
                if ni.generation > snapshot.generation:
                    if ni.node is not None:
                        snapshot.node_infos[name] = ni.clone()
                        dirty.append(name)
                    max_gen = max(max_gen, ni.generation)
            if len(snapshot.node_infos) > self.node_count():
                live = {n for n, ni in self._nodes.items() if ni.node is not None}
                for name in list(snapshot.node_infos):
                    if name not in live:
                        del snapshot.node_infos[name]
                        dirty.append(name)
            snapshot.generation = max_gen
            return dirty

    def dump(self) -> Dict[str, NodeInfo]:
        """Debug snapshot (ref: internal/cache/debugger SIGUSR2 dump)."""
        with self._lock:
            return {n: ni.clone() for n, ni in self._nodes.items()}


class NodeTree:
    """Zone -> node-name lists with round-robin iteration, so node enumeration
    interleaves zones (ref: node_tree.go:31-46). ordered_names() is the
    zone-strided order intended for the tensor mirror's row layout (so node
    shards stay zone-balanced across TPU cores); the mirror currently assigns
    rows from a free list and does NOT consume this yet."""

    def __init__(self):
        self._zones: Dict[str, List[str]] = {}
        self._zone_of: Dict[str, str] = {}

    @staticmethod
    def _zone_key(node: Node) -> str:
        from ..api import wellknown
        labels = node.metadata.labels
        region = labels.get(wellknown.LABEL_REGION, "")
        zone = labels.get(wellknown.LABEL_ZONE, "")
        return f"{region}:\x00:{zone}"

    def add(self, node: Node) -> None:
        name = node.metadata.name
        if name in self._zone_of:
            self.remove(node)
        zone = self._zone_key(node)
        self._zones.setdefault(zone, []).append(name)
        self._zone_of[name] = zone

    def remove(self, node: Node) -> None:
        name = node.metadata.name
        zone = self._zone_of.pop(name, None)
        if zone is None:
            return
        lst = self._zones.get(zone, [])
        if name in lst:
            lst.remove(name)
        if not lst:
            self._zones.pop(zone, None)

    def update(self, old: Node, new: Node) -> None:
        if self._zone_key(old) != self._zone_key(new) or \
                old.metadata.name not in self._zone_of:
            self.remove(old)
            self.add(new)

    def ordered_names(self) -> List[str]:
        """Round-robin across zones (zone-strided order)."""
        lists = [list(v) for v in self._zones.values()]
        out: List[str] = []
        i = 0
        while any(i < len(l) for l in lists):
            for l in lists:
                if i < len(l):
                    out.append(l[i])
            i += 1
        return out

    def num_nodes(self) -> int:
        return len(self._zone_of)
