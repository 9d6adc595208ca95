"""Well-known label/taint/resource names.

Ref: staging/src/k8s.io/api/core/v1/well_known_labels.go and
pkg/apis/core/types.go resource name constants.
"""

# topology labels (ref: v1.LabelHostname / v1.LabelZoneFailureDomain /
# v1.LabelZoneRegion — used by zone-spread and topology predicates)
LABEL_HOSTNAME = "kubernetes.io/hostname"
LABEL_ZONE = "failure-domain.beta.kubernetes.io/zone"
LABEL_REGION = "failure-domain.beta.kubernetes.io/region"
LABEL_INSTANCE_TYPE = "beta.kubernetes.io/instance-type"
LABEL_OS = "kubernetes.io/os"
LABEL_ARCH = "kubernetes.io/arch"

# resource names (ref: pkg/apis/core/types.go ResourceName consts)
RESOURCE_CPU = "cpu"
RESOURCE_MEMORY = "memory"
RESOURCE_EPHEMERAL_STORAGE = "ephemeral-storage"
RESOURCE_PODS = "pods"
RESOURCE_STORAGE = "storage"
HUGEPAGES_PREFIX = "hugepages-"
DEFAULT_NS_PREFIX = "kubernetes.io/"

# extended-resource example the TPU build cares about
RESOURCE_TPU = "google.com/tpu"

# taint keys applied by the node lifecycle controller
# (ref: pkg/scheduler/algorithm/well_known_labels.go)
TAINT_NODE_NOT_READY = "node.kubernetes.io/not-ready"
TAINT_NODE_UNREACHABLE = "node.kubernetes.io/unreachable"
TAINT_NODE_MEMORY_PRESSURE = "node.kubernetes.io/memory-pressure"
TAINT_NODE_DISK_PRESSURE = "node.kubernetes.io/disk-pressure"
TAINT_NODE_PID_PRESSURE = "node.kubernetes.io/pid-pressure"
TAINT_NODE_UNSCHEDULABLE = "node.kubernetes.io/unschedulable"
TAINT_NODE_NETWORK_UNAVAILABLE = "node.kubernetes.io/network-unavailable"

# annotation used for preemption nominations (ref NominatedNodeName field)
DEFAULT_SCHEDULER_NAME = "default-scheduler"

# gang scheduling: the pod label naming its PodGroup (the coscheduling
# plugin's convention — ref: sigs.k8s.io/scheduler-plugins coscheduling)
LABEL_POD_GROUP = "scheduling.k8s.io/pod-group"


def is_extended_resource(name: str) -> bool:
    """A resource name outside the default kubernetes.io namespace.

    Ref: pkg/apis/core/v1/helper/helpers.go IsExtendedResourceName.
    """
    if name in (RESOURCE_CPU, RESOURCE_MEMORY, RESOURCE_EPHEMERAL_STORAGE,
                RESOURCE_PODS, RESOURCE_STORAGE):
        return False
    if name.startswith(HUGEPAGES_PREFIX):
        return False
    return "/" in name and not name.startswith(DEFAULT_NS_PREFIX)
