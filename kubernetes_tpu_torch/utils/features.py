"""Feature gates.

Ref: pkg/features/kube_features.go (144 gates with maturity levels) +
staging/src/k8s.io/apiserver/pkg/util/feature/feature_gate.go: a mutable
global gate set from --feature-gates=K=true,K2=false; GA features are
locked on and cannot be disabled (feature_gate.go's
lockToDefault/specialFeatures handling).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict

ALPHA = "ALPHA"
BETA = "BETA"
GA = "GA"


@dataclass(frozen=True)
class FeatureSpec:
    default: bool
    prerelease: str = ALPHA
    lock_to_default: bool = False


class FeatureGate:
    def __init__(self, known: Dict[str, FeatureSpec]):
        self._lock = threading.Lock()
        self._known = dict(known)
        self._enabled: Dict[str, bool] = {}

    def enabled(self, name: str) -> bool:
        with self._lock:
            if name in self._enabled:
                return self._enabled[name]
            spec = self._known.get(name)
            if spec is None:
                raise KeyError(f"unknown feature gate {name}")
            return spec.default

    def set(self, name: str, value: bool) -> None:
        with self._lock:
            spec = self._known.get(name)
            if spec is None:
                raise KeyError(f"unknown feature gate {name}")
            if spec.lock_to_default and value != spec.default:
                raise ValueError(
                    f"feature {name} is {spec.prerelease} and locked to "
                    f"{spec.default}")
            self._enabled[name] = value

    def set_from_map(self, flags: Dict[str, bool]) -> None:
        for k, v in flags.items():
            self.set(k, v)

    def parse(self, flag: str) -> None:
        """--feature-gates=A=true,B=false."""
        for part in flag.split(","):
            if not part:
                continue
            k, _, v = part.partition("=")
            self.set(k.strip(), v.strip().lower() in ("true", "1", "yes"))

    def known(self) -> Dict[str, FeatureSpec]:
        with self._lock:
            return dict(self._known)


#: the gate set this framework consults (the kube_features.go analog,
#: scoped to behaviors that actually branch here)
DEFAULT_FEATURES: Dict[str, FeatureSpec] = {
    # pod priority & preemption (GA in the reference era; locked on)
    "PodPriority": FeatureSpec(default=True, prerelease=GA,
                               lock_to_default=True),
    # taint-based evictions by the node lifecycle controller
    "TaintBasedEvictions": FeatureSpec(default=True, prerelease=BETA),
    # delayed volume binding (WaitForFirstConsumer)
    "VolumeScheduling": FeatureSpec(default=True, prerelease=GA,
                                    lock_to_default=True),
    # node leases as heartbeats
    "NodeLease": FeatureSpec(default=True, prerelease=BETA),
    # ttlSecondsAfterFinished cleanup
    "TTLAfterFinished": FeatureSpec(default=True, prerelease=ALPHA),
    # device-usage chaining across batches in the scheduler drain
    # (batch extension; no reference analog)
    "SchedulerDeviceChaining": FeatureSpec(default=True, prerelease=BETA),
    # nominated-pod reservation tensors in the assignment kernel
    "SchedulerNominatedReservations": FeatureSpec(default=True,
                                                  prerelease=BETA),
}

#: process-wide gate (ref: utilfeature.DefaultFeatureGate)
DEFAULT_FEATURE_GATE = FeatureGate(DEFAULT_FEATURES)
