"""The scheduler_perf-shaped cluster and pods of the batch drain.

The same shapes as the repository's bench.py (make_node / make_pod, its
`uniform`, `node-affinity`, `taints` and `spread` variants, and the
inter-pod ones `pod-affinity`, `pod-anti-affinity` and
`preferred-affinity`): nodes of 4 CPU, 32Gi and 110 pods in 16 zones;
pods of three request shapes. Every function here takes the API module to
build with, so one seeded fixture can be built in this package's types
and in the reference package's.
"""

from __future__ import annotations

VARIANTS = ("uniform", "node-affinity", "taints", "spread")
#: the inter-pod (anti-)affinity variants: their batches carry the
#: scan's topology counters or soft credit tables
AFFINITY_VARIANTS = ("pod-affinity", "pod-anti-affinity",
                     "preferred-affinity")


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
    elif variant == "pod-affinity":
        # required affinity to pods sharing the app label, zone topology
        pod.spec.affinity = api.Affinity(pod_affinity=api.PodAffinity(
            required_during_scheduling_ignored_during_execution=[
                api.PodAffinityTerm(
                    label_selector=api.LabelSelector(
                        match_labels={"app": "bench"}),
                    topology_key=api.wellknown.LABEL_ZONE)]))
    elif variant == "pod-anti-affinity":
        # required anti-affinity within one of 100 colors, hostname
        # topology: no two pods of a color on one node
        pod.metadata.labels["color"] = f"c{i % 100}"
        pod.spec.affinity = api.Affinity(
            pod_anti_affinity=api.PodAntiAffinity(
                required_during_scheduling_ignored_during_execution=[
                    api.PodAffinityTerm(
                        label_selector=api.LabelSelector(
                            match_labels={"color": f"c{i % 100}"}),
                        topology_key=api.wellknown.LABEL_HOSTNAME)]))
    elif variant == "preferred-affinity":
        # preferred anti-affinity (weight 10) within one of 16 groups,
        # hostname topology: the soft credit workload
        pod.metadata.labels["grp"] = f"g{i % 16}"
        pod.spec.affinity = api.Affinity(
            pod_anti_affinity=api.PodAntiAffinity(
                preferred_during_scheduling_ignored_during_execution=[
                    api.WeightedPodAffinityTerm(
                        weight=10,
                        pod_affinity_term=api.PodAffinityTerm(
                            label_selector=api.LabelSelector(
                                match_labels={"grp": f"g{i % 16}"}),
                            topology_key=api.wellknown.LABEL_HOSTNAME))]))
    elif variant == "taints":
        # two thirds tolerate the dedicated taint; one third is confined
        # to the untainted half
        if i % 3 != 2:
            pod.spec.tolerations = [api.Toleration(
                key="dedicated", operator="Equal", value="gpu",
                effect="NoSchedule")]
    return pod


def seed_pods(api, variant: str, n_nodes: int):
    """The bound pods bench.py's run_config places before a drain of an
    inter-pod variant: one pod of each of the first 100 colors on nodes
    0..99 for `pod-anti-affinity`, one affine pod on node 0 for
    `pod-affinity`, none otherwise."""
    n = {"pod-anti-affinity": 100, "pod-affinity": 1}.get(variant, 0)
    out = []
    for i in range(min(n, n_nodes)):
        pod = make_pod(api, 3_000_000 + i, variant)
        pod.spec.node_name = f"node-{i}"
        out.append(pod)
    return out


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
