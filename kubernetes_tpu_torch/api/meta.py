"""Object metadata — the identity/versioning spine of every API object.

Ref: staging/src/k8s.io/apimachinery/pkg/apis/meta/v1/types.go
(ObjectMeta, OwnerReference, LabelSelector, ListMeta).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class OwnerReference:
    api_version: str = ""
    kind: str = ""
    name: str = ""
    uid: str = ""
    controller: Optional[bool] = None
    block_owner_deletion: Optional[bool] = None


@dataclass
class ObjectMeta:
    name: str = ""
    generate_name: str = ""
    namespace: str = ""
    uid: str = ""
    resource_version: str = ""
    generation: int = 0
    creation_timestamp: Optional[str] = None
    deletion_timestamp: Optional[str] = None
    deletion_grace_period_seconds: Optional[int] = None
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    owner_references: List[OwnerReference] = field(default_factory=list)
    finalizers: List[str] = field(default_factory=list)

    def key(self) -> str:
        """namespace/name cache key (ref: cache.MetaNamespaceKeyFunc)."""
        return f"{self.namespace}/{self.name}" if self.namespace else self.name


@dataclass
class LabelSelectorRequirement:
    key: str = ""
    operator: str = ""  # In | NotIn | Exists | DoesNotExist
    values: List[str] = field(default_factory=list)


@dataclass
class LabelSelector:
    match_labels: Dict[str, str] = field(default_factory=dict)
    match_expressions: List[LabelSelectorRequirement] = field(default_factory=list)


def controller_ref(meta: ObjectMeta) -> Optional[OwnerReference]:
    """The owning controller reference, if any (ref: GetControllerOf)."""
    for ref in meta.owner_references:
        if ref.controller:
            return ref
    return None


def new_controller_ref(owner_kind: str, owner_api_version: str,
                       owner_meta: ObjectMeta) -> OwnerReference:
    return OwnerReference(api_version=owner_api_version, kind=owner_kind,
                         name=owner_meta.name, uid=owner_meta.uid,
                         controller=True, block_owner_deletion=True)


def is_dataclass_obj(obj) -> bool:
    return dataclasses.is_dataclass(obj) and not isinstance(obj, type)
