"""Typed API object model: copies of kubernetes_tpu/api's device-free
modules, trimmed to what the batch scheduler reads."""

from . import helpers, labels, wellknown
from .core import (Affinity, Container, ContainerImage, ContainerPort,
                   Node, NodeAffinity, NodeCondition, NodeSelector,
                   NodeSelectorRequirement, NodeSelectorTerm, NodeSpec,
                   NodeStatus, PersistentVolumeClaimVolumeSource, Pod,
                   PodAffinity, PodAffinityTerm, PodAntiAffinity, PodSpec,
                   PodStatus, PreferredSchedulingTerm, ResourceRequirements,
                   Service, ServiceSpec, Taint, Toleration, Volume,
                   WeightedPodAffinityTerm)
from .meta import (LabelSelector, LabelSelectorRequirement, ObjectMeta,
                   OwnerReference, controller_ref)
from .quantity import Quantity

__all__ = [n for n in dir() if not n.startswith("_")]
