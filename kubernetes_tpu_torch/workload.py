"""The scheduler_perf-shaped cluster and pods of the batch drain.

The same shapes as the repository's bench.py (make_node / make_pod, its
`uniform`, `node-affinity`, `taints` and `spread` variants): nodes of 4
CPU, 32Gi and 110 pods in 16 zones; pods of three request shapes. Every
builder takes the API module to build with, so one seeded fixture can
be built in this package's types and in the reference package's.
"""

from __future__ import annotations

VARIANTS = ("uniform", "node-affinity", "taints", "spread")


def make_node(api, i: int, variant: str = "uniform", zones: int = 16):
    alloc = {"cpu": api.Quantity("4"), "memory": api.Quantity("32Gi"),
             "pods": api.Quantity(110)}
    node = api.Node(
        metadata=api.ObjectMeta(
            name=f"node-{i}",
            labels={api.wellknown.LABEL_HOSTNAME: f"node-{i}",
                    api.wellknown.LABEL_ZONE: f"zone-{i % zones}"}),
        status=api.NodeStatus(capacity=dict(alloc), allocatable=dict(alloc),
                              conditions=[api.NodeCondition(type="Ready",
                                                            status="True")]))
    if variant == "taints" and i % 2:
        # half the cluster dedicated
        node.spec.taints = [api.Taint(key="dedicated", value="gpu",
                                      effect="NoSchedule")]
    return node


def make_pod(api, i: int, variant: str = "uniform", shape: int = None):
    """Pod i; `shape` (0-2) picks its request shape, default i % 3."""
    s = i % 3 if shape is None else shape
    cpu = ["100m", "250m", "500m"][s]
    mem = ["128Mi", "512Mi", "1Gi"][s]
    pod = api.Pod(
        metadata=api.ObjectMeta(name=f"pod-{i}", namespace="default",
                                labels={"app": "bench", "color": "blue"}),
        spec=api.PodSpec(containers=[api.Container(
            name="c", image="pause",
            resources=api.ResourceRequirements(
                requests={"cpu": api.Quantity(cpu),
                          "memory": api.Quantity(mem)}))]))
    if variant == "node-affinity":
        # required affinity matching half the zones
        pod.spec.affinity = api.Affinity(node_affinity=api.NodeAffinity(
            required_during_scheduling_ignored_during_execution=api.NodeSelector(
                node_selector_terms=[api.NodeSelectorTerm(
                    match_expressions=[api.NodeSelectorRequirement(
                        key=api.wellknown.LABEL_ZONE, operator="In",
                        values=[f"zone-{z}" for z in range(8)])])])))
    elif variant == "taints":
        # two thirds tolerate the dedicated taint; one third is confined
        # to the untainted half
        if i % 3 != 2:
            pod.spec.tolerations = [api.Toleration(
                key="dedicated", operator="Equal", value="gpu",
                effect="NoSchedule")]
    return pod


def spread_service(api):
    """The Service selecting every pod: SelectorSpread groups them."""
    return api.Service(
        metadata=api.ObjectMeta(name="bench", namespace="default"),
        spec=api.ServiceSpec(selector={"app": "bench"}))


def build(api, cache_cls, scheduler_cls, listers_cls, n_nodes: int,
          variant: str, zones: int = 16, **sched_kw):
    """(scheduler, cache): a cache holding n_nodes nodes and a batch
    scheduler over it, with the spread Service wired for `spread`."""
    cache = cache_cls()
    for i in range(n_nodes):
        cache.add_node(make_node(api, i, variant, zones))
    listers = None
    if variant == "spread":
        svc = spread_service(api)
        listers = listers_cls(services=lambda ns: [svc])
    return scheduler_cls(cache, listers=listers, **sched_kw), cache
