"""Multi-tenancy for the scheduler loop: gang quota at the queue gate,
DRF fair share on the card, and PriorityClass bands.

  - gangquota.py per-namespace active-gang slots enforced at the gang
                 manager's pop gate (copy)
  - drf.py       per-tenant usage carry + the dominant-share and
                 drain-order kernels (K4, K5) and their numpy parity
                 oracles (ported)
  - kernels.py   K4/K5 launch wrappers and their plain versions
  - bands.py     PriorityClass-derived named bands (copy)
  - metrics.py   QuotaMetrics / TenancyMetrics families (copy)

The ResourceQuota reconciler (quota.py) is not ported yet: it needs the
API server's admission and the controllers (ROADMAP).
"""

from .bands import Band, BandCatalog, BEST_EFFORT, EXPRESS_ANNOTATION, \
    SLO_ANNOTATION
from .drf import DRFAccount, RESOURCES, TENANT_LABEL, \
    dominant_shares_reference, drf_enabled, drf_order_reference, tenant_of
from .gangquota import ACTIVE_GANGS_KEY, GangQuotaGate, QuotaBlock
from .metrics import QuotaMetrics, TenancyMetrics

__all__ = [
    "ACTIVE_GANGS_KEY", "BEST_EFFORT", "Band", "BandCatalog",
    "DRFAccount", "EXPRESS_ANNOTATION", "GangQuotaGate", "QuotaBlock",
    "QuotaMetrics", "RESOURCES", "SLO_ANNOTATION", "TENANT_LABEL",
    "TenancyMetrics", "dominant_shares_reference", "drf_enabled",
    "drf_order_reference", "tenant_of",
]
