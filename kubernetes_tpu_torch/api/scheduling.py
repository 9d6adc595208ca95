"""scheduling.k8s.io types — PodGroup, the gang-scheduling unit.

Ref: the coscheduling lineage cited in PAPERS.md (sig-scheduling's PodGroup
CRD from kubernetes-sigs/scheduler-plugins, the ancestor of Kueue/JobSet
admission). A PodGroup names a set of pods that must be placed
ALL-OR-NOTHING: a multi-host TPU slice wedges if only some of its workers
land, so the scheduler holds the group back until `minMember` pods are
pending, places them atomically (scheduler/kernels/gang.py), and gates
binding on the whole group having reserved nodes (scheduler/gang.py).

Membership convention: a pod joins the group named by its
`scheduling.k8s.io/pod-group` label (wellknown.LABEL_POD_GROUP) in its own
namespace — the label convention the coscheduling plugin uses, so real
manifests carry over unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from .meta import ObjectMeta
from .wellknown import LABEL_POD_GROUP

# PodGroup phases (ref: scheduler-plugins apis/scheduling/v1alpha1)
PHASE_PENDING = "Pending"        # fewer than minMember pods exist/are queued
PHASE_SCHEDULING = "Scheduling"  # members are being placed / reserved
PHASE_RUNNING = "Running"        # >= minMember members run
PHASE_FAILED = "Failed"          # too many members failed to ever reach minMember

#: seconds a partially-reserved gang may hold node reservations at the
#: permit gate before they are rolled back (spec default)
DEFAULT_SCHEDULE_TIMEOUT = 60


@dataclass
class PodGroupSpec:
    #: the gang threshold: members are held in the queue until this many are
    #: pending, and binds are gated until this many have reserved nodes
    min_member: int = 1
    #: node-label key every member's node must agree on — one ICI-connected
    #: TPU slice is one label value (e.g. cloud.google.com/tpu-slice), so
    #: "same value" == "same interconnect domain". Empty = no constraint.
    topology_key: str = ""
    #: permit-gate timeout: how long reserved members wait for the rest of
    #: the gang before every reservation is rolled back
    schedule_timeout_seconds: int = DEFAULT_SCHEDULE_TIMEOUT


@dataclass
class PodGroupStatus:
    phase: str = PHASE_PENDING
    #: members with a node assigned (bound or reserved)
    scheduled: int = 0
    running: int = 0
    succeeded: int = 0
    failed: int = 0
    #: times the controller rebuilt this gang from Failed back to Pending
    #: (every member recreated as a unit after a node death or member
    #: crash wedged the slice)
    resubmissions: int = 0
    #: member pod templates keyed by pod name — serde-encoded CLEAN
    #: clones (no node, no status, no server-stamped metadata) recorded
    #: by the PodGroup controller when each member is first observed.
    #: Resubmission rebuilds from these, so a member DELETED before the
    #: rebuild (its spec would otherwise exist nowhere) is still
    #: recreated and the gang can reach minMember again.
    member_templates: Dict[str, dict] = field(default_factory=dict)


@dataclass
class PodGroup:
    api_version: str = "scheduling.k8s.io/v1alpha1"
    kind: str = "PodGroup"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodGroupSpec = field(default_factory=PodGroupSpec)
    status: PodGroupStatus = field(default_factory=PodGroupStatus)


def pod_group_name(pod) -> Optional[str]:
    """The PodGroup this pod belongs to (its own namespace), or None."""
    name = pod.metadata.labels.get(LABEL_POD_GROUP)
    return name or None


def pod_group_key(pod) -> Optional[str]:
    """namespace/name key of the pod's group (cache/indexer key format)."""
    name = pod_group_name(pod)
    if name is None:
        return None
    ns = pod.metadata.namespace or "default"
    return f"{ns}/{name}"
