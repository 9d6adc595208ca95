"""PriorityClass bands — named priority ranges replacing the single lane
threshold.

The scheduler's express lane has been one integer (`lane_priority`): at
or above it you ride the express drain, below it you batch. PriorityClass
objects (scheduling/v1) already carry richer intent — a name, a value,
preemption policy — so the band catalog derives the lane structure FROM
them: each PriorityClass opens a band at its value, a pod belongs to the
highest band whose value it reaches, and pods under every band fall into
the implicit ``best-effort`` band at value 0. Per-band SLO targets ride a
PriorityClass annotation (``serving.ktpu/slo-p99-bind-seconds``) so the
SLOTracker can judge each band against ITS promise instead of one global
gate; ``serving.ktpu/express`` marks which bands drain on the express
lane, and the catalog's ``lane_threshold()`` is the lowest express value
— the same integer the scheduler always took, now derived instead of
hard-coded.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from ..api import helpers
from ..api.policy import PriorityClass

#: PriorityClass annotation: this band's p99 bind-latency target, seconds
SLO_ANNOTATION = "serving.ktpu/slo-p99-bind-seconds"
#: PriorityClass annotation ("true"): this band drains on the express lane
EXPRESS_ANNOTATION = "serving.ktpu/express"
#: the implicit bottom band pods under every PriorityClass fall into
BEST_EFFORT = "best-effort"


@dataclass(frozen=True)
class Band:
    name: str
    value: int                      # band floor (PriorityClass.value)
    express: bool = False
    slo_p99_bind_s: Optional[float] = None
    description: str = ""


class BandCatalog:
    """Bands sorted by floor, descending; ``band_of(priority)`` is the
    first whose floor the priority reaches."""

    def __init__(self, bands: Sequence[Band]):
        named = {b.name: b for b in bands}
        if BEST_EFFORT not in named:
            named[BEST_EFFORT] = Band(BEST_EFFORT, 0)
        self.bands: List[Band] = sorted(
            named.values(), key=lambda b: (-b.value, b.name))

    @classmethod
    def from_priority_classes(cls, pcs: Sequence[PriorityClass],
                              ) -> "BandCatalog":
        bands = []
        for pc in sorted(pcs, key=lambda p: p.metadata.key()):
            ann = pc.metadata.annotations
            slo = ann.get(SLO_ANNOTATION)
            bands.append(Band(
                name=pc.metadata.name,
                value=pc.value,
                express=ann.get(EXPRESS_ANNOTATION) == "true",
                slo_p99_bind_s=float(slo) if slo is not None else None,
                description=pc.description))
        return cls(bands)

    @classmethod
    def default(cls, lane_priority: int = 1000) -> "BandCatalog":
        """The legacy two-lane split expressed as bands — what a cluster
        without PriorityClass objects behaves like."""
        return cls([
            Band("express", lane_priority, express=True,
                 description="the express drain lane"),
            Band(BEST_EFFORT, 0,
                 description="batch: everything under the lane"),
        ])

    # ---------------------------------------------------------- lookups

    def band_of(self, priority: int) -> Band:
        for b in self.bands:
            if priority >= b.value:
                return b
        return self.bands[-1]  # negative priority: the bottom band

    def band_of_pod(self, pod) -> Band:
        return self.band_of(helpers.pod_priority(pod))

    def lane_threshold(self, default: int = 1000) -> int:
        """The express-lane integer the scheduler consumes: the lowest
        express band's floor (the legacy single threshold when no band
        is marked express)."""
        express = [b.value for b in self.bands if b.express]
        return min(express) if express else default

    def names(self) -> List[str]:
        return [b.name for b in self.bands]

    def targets(self) -> Dict[str, float]:
        """band name -> p99 bind SLO target (bands without one absent)."""
        return {b.name: b.slo_p99_bind_s for b in self.bands
                if b.slo_p99_bind_s is not None}
