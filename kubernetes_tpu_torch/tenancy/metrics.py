"""Tenancy metric families: quota enforcement and DRF fair share.

Same contract as the families in utils/metrics.py — constructed over the
caller's registry so they ride the owning component's /metrics
exposition, with a private-registry fallback for standalone use; names
follow the prometheus conventions ktpulint enforces (counters end in
``_total``). Both classes are part of the registry-completeness gate
(tests/test_observability.py), so a family declared here but never
exposed fails CI.
"""

from __future__ import annotations

from typing import Optional

from ..utils.metrics import Registry


class QuotaMetrics:
    """ResourceQuota enforcement: admission rejections (the apiserver's
    view) and reconcile writes (the controller's view)."""

    def __init__(self, registry: Optional[Registry] = None):
        self.registry = registry if registry is not None else Registry()
        r = self.registry
        #: CREATEs denied by the quota validator, named by the namespace
        #: and the hard key that was exhausted
        self.admission_rejections = r.counter(
            "quota_admission_rejections_total",
            "Object creations denied by ResourceQuota admission, by "
            "namespace and exhausted resource")
        #: status.used writes the reconciler made (0 on a converged pass)
        self.reconcile_writes = r.counter(
            "quota_reconcile_writes_total",
            "ResourceQuota status writes by the reconciler, by namespace")


class TenancyMetrics:
    """DRF fair share and the gang-quota gate."""

    def __init__(self, registry: Optional[Registry] = None):
        self.registry = registry if registry is not None else Registry()
        r = self.registry
        #: each tenant's current dominant share (max over resources of
        #: usage/capacity), sampled at scheduler commit points
        self.dominant_share = r.gauge(
            "tenancy_dominant_share",
            "Dominant resource share per tenant (DRF)")
        #: gangs parked at the queue gate because their namespace's
        #: active-gang quota was exhausted
        self.gang_quota_parked = r.counter(
            "tenancy_gang_quota_parked_total",
            "Gangs parked for an exhausted active-gang quota, "
            "by namespace")
        self.gang_quota_admitted = r.counter(
            "tenancy_gang_quota_admitted_total",
            "Gangs granted an active-gang quota slot, by namespace")

    def sample_shares(self, account) -> None:
        """Refresh the per-tenant dominant-share gauge from a
        DRFAccount (called at scheduler commit points)."""
        rep = account.report()
        for tenant, rec in rep["tenants"].items():
            self.dominant_share.set(rec["dominant_share"], tenant=tenant)
