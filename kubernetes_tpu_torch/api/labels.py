"""Label selector semantics.

Ref: staging/src/k8s.io/apimachinery/pkg/labels (Selector / Requirement) and
pkg/apis/meta/v1 LabelSelectorAsSelector. Operators: In, NotIn, Exists,
DoesNotExist, plus node-affinity extras Gt/Lt
(ref: pkg/scheduler/algorithm/predicates nodeMatchesNodeSelectorTerms via
v1helper.MatchNodeSelectorTerms).

The scheduler's kernel path doesn't call these per (pod, node): selectors are
compiled once against an interned label vocabulary (scheduler/tensorize.py)
into bitset requirements evaluated on-device. These python implementations are
the semantic source of truth the kernels are parity-tested against.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .meta import LabelSelector, LabelSelectorRequirement

IN = "In"
NOT_IN = "NotIn"
EXISTS = "Exists"
DOES_NOT_EXIST = "DoesNotExist"
GT = "Gt"
LT = "Lt"


def match_requirement(req: LabelSelectorRequirement, labels: Dict[str, str]) -> bool:
    has = req.key in labels
    val = labels.get(req.key)
    op = req.operator
    if op == IN:
        return has and val in req.values
    if op == NOT_IN:
        return not has or val not in req.values
    if op == EXISTS:
        return has
    if op == DOES_NOT_EXIST:
        return not has
    if op == GT or op == LT:
        # numeric comparison; non-integer labels never match (ref Requirement.Matches)
        if not has or len(req.values) != 1:
            return False
        try:
            lv, rv = int(val), int(req.values[0])
        except (TypeError, ValueError):
            return False
        return lv > rv if op == GT else lv < rv
    raise ValueError(f"unknown selector operator {op!r}")


def matches(selector: Optional[LabelSelector], labels: Dict[str, str]) -> bool:
    """LabelSelectorAsSelector().Matches(labels). A nil selector matches nothing;
    an empty selector matches everything (ref: metav1 semantics)."""
    if selector is None:
        return False
    for k, v in selector.match_labels.items():
        if labels.get(k) != v:
            return False
    for req in selector.match_expressions:
        if not match_requirement(req, labels):
            return False
    return True


def selector_from_map(match_labels: Dict[str, str]) -> LabelSelector:
    return LabelSelector(match_labels=dict(match_labels))


def selector_empty(selector: Optional[LabelSelector]) -> bool:
    return selector is not None and not selector.match_labels and not selector.match_expressions


def requirements_of(selector: LabelSelector) -> List[LabelSelectorRequirement]:
    """Normalize matchLabels into In-requirements (ref LabelSelectorAsSelector)."""
    reqs = [LabelSelectorRequirement(key=k, operator=IN, values=[v])
            for k, v in sorted(selector.match_labels.items())]
    reqs.extend(selector.match_expressions)
    return reqs


def canonical_selector(selector: Optional[LabelSelector]):
    """Hashable canonical form of a selector (cache/dedupe keys)."""
    if selector is None:
        return None
    return (tuple(sorted(selector.match_labels.items())),
            tuple(sorted((r.key, r.operator, tuple(sorted(r.values)))
                         for r in selector.match_expressions)))
