"""The scheduler_perf-shaped cluster and pods of the batch drain.

The same shapes as the repository's bench.py (make_node / make_pod, its
`uniform`, `node-affinity`, `taints` and `spread` variants, the inter-pod
ones `pod-affinity`, `pod-anti-affinity` and `preferred-affinity`, and
`nominated`, whose uniform pods schedule beside ghost nominations on
every fourth node): nodes of 4 CPU, 32Gi and 110 pods in 16 zones; pods
of three request shapes. Also BASELINE.json config 5's gang mix (the same
pods in PodGroups of 8 on one tpu/slice, PodGroups of 4 without a
topology key, and singletons), and bench.py preempt_main's preemption
storm: a full cluster of bound low-priority victims under a
PodDisruptionBudget, the high-priority pods that must preempt them, and
its gangs that must preempt a whole slice. And `service-anti-affinity`:
services that keep one replica per host (pod i in service svc-{i % 1000},
each with required anti-affinity to its own service on the hostname, the
"Assigning Pods to Nodes" web-store pattern at scheduler_perf's
BenchmarkSchedulingPodAntiAffinity topology). Every function here
takes the API module to build with, so one seeded fixture can be built in
this package's types and in the reference package's.
"""

from __future__ import annotations

import importlib
import queue as queue_mod

import numpy as np

VARIANTS = ("uniform", "node-affinity", "taints", "spread", "nominated")
#: the inter-pod (anti-)affinity variants: their batches carry the
#: scan's topology counters or soft credit tables
AFFINITY_VARIANTS = ("pod-affinity", "pod-anti-affinity",
                     "preferred-affinity")
#: the services of the `service-anti-affinity` variant: 50 replicas each
#: at 50,000 pods
SERVICE_GROUPS = 1000


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
    elif variant == "service-anti-affinity":
        return service_pod(api, i, SERVICE_GROUPS, shape)
    elif variant == "taints":
        # two thirds tolerate the dedicated taint; one third is confined
        # to the untainted half
        if i % 3 != 2:
            pod.spec.tolerations = [api.Toleration(
                key="dedicated", operator="Equal", value="gpu",
                effect="NoSchedule")]
    return pod


def service_pod(api, i: int, groups: int, shape: int = None):
    """Pod i of the `service-anti-affinity` variant: a replica of service
    svc-{i % groups} (label app) in bench.py's request shape i % 3, with
    required anti-affinity to its own service on kubernetes.io/hostname,
    so no two replicas of a service share a node."""
    pod = make_pod(api, i, shape=shape)
    app = f"svc-{i % groups}"
    pod.metadata.labels["app"] = app
    pod.spec.affinity = api.Affinity(
        pod_anti_affinity=api.PodAntiAffinity(
            required_during_scheduling_ignored_during_execution=[
                api.PodAffinityTerm(
                    label_selector=api.LabelSelector(
                        match_labels={"app": app}),
                    topology_key=api.wellknown.LABEL_HOSTNAME)]))
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


def install_nominated(api, nominated, n_nodes: int) -> None:
    """bench.py's `nominated` variant: a ghost preemptor (a uniform pod
    that is never created) nominated to every fourth node, so the scan's
    phantom-usage overlay is live on every batch."""
    for i in range(0, n_nodes, 4):
        ghost = make_pod(api, 4_000_000 + i)
        ghost.metadata.name = f"ghost-{i}"
        nominated.add(ghost, f"node-{i}")


def build(api, cache_cls, scheduler_cls, listers_cls, n_nodes: int,
          variant: str, zones: int = 16, **sched_kw):
    """(scheduler, cache): a cache holding n_nodes nodes and a batch
    scheduler over it, with the spread Service wired for `spread` and
    the ghost nominations installed for `nominated`."""
    cache = cache_cls()
    for i in range(n_nodes):
        cache.add_node(make_node(api, i, variant, zones))
    listers = None
    if variant == "spread":
        svc = spread_service(api)
        listers = listers_cls(services=lambda ns: [svc])
    sched = scheduler_cls(cache, listers=listers, **sched_kw)
    if variant == "nominated":
        install_nominated(api, sched.nominated, n_nodes)
    return sched, cache


# ------------------------------------------------------------ gangs

#: the node label grouping 8 nodes into one ICI slice (bench.py SLICE)
STORM_SLICE = "tpu/slice"
#: nodes per slice
SLICE_NODES = 8


def slice_node(api, i: int):
    """Node i of make_node, labelled with its slice (tpu/slice = s{i//8})
    as bench.py preempt_main labels its nodes."""
    node = make_node(api, i)
    node.metadata.labels[STORM_SLICE] = f"s{i // SLICE_NODES}"
    return node


def pod_group(api, name: str, min_member: int, topology_key: str = "",
              timeout: int = None):
    """A PodGroup in the default namespace (the scheduler's default permit
    timeout unless `timeout` is given)."""
    sched = importlib.import_module(api.__name__ + ".scheduling")
    spec = sched.PodGroupSpec(min_member=min_member,
                              topology_key=topology_key)
    if timeout is not None:
        spec.schedule_timeout_seconds = timeout
    return sched.PodGroup(
        metadata=api.ObjectMeta(name=name, namespace="default"), spec=spec)


def gang_objects(api, n_nodes: int, n_pods: int, slice_gangs: int,
                 plain_gangs: int, seed: int = 0):
    """(nodes, groups, pods) of BASELINE.json config 5, "batched gang
    assignment, 50k pending pods x 5k nodes, mixed resource shapes":
    n_nodes slice_node nodes; `slice_gangs` PodGroups of 8 (minMember 8,
    topologyKey tpu/slice), `plain_gangs` PodGroups of 4 (minMember 4, no
    topology key) and singletons up to n_pods, the units in one seeded
    shuffle; pod i (make_pod, request shape i % 3) is created in that
    order, so a gang's members mix shapes."""
    nodes = [slice_node(api, i) for i in range(n_nodes)]
    units = ([("sg", 8)] * slice_gangs + [("pg", 4)] * plain_gangs
             + [(None, 1)] * (n_pods - 8 * slice_gangs - 4 * plain_gangs))
    order = np.random.default_rng(seed).permutation(len(units))
    groups, pods = [], []
    for u in order:
        kind, size = units[u]
        name = None
        if kind is not None:
            name = f"{kind}{len(groups)}"
            groups.append(pod_group(api, name, size,
                                    STORM_SLICE if kind == "sg" else ""))
        for _ in range(size):
            pod = make_pod(api, len(pods))
            if name is not None:
                pod.metadata.labels[api.wellknown.LABEL_POD_GROUP] = name
            pods.append(pod)
    return nodes, groups, pods


# ------------------------------------------------------------ preemption


def storm_objects(api, n_nodes: int, seed: int = 0):
    """(nodes, victims, pdb) of bench.py preempt_main's storm, drawn in
    its order from one seed: every node full of 3 bound victims of
    priority 0, 10 or 100 (label band=b<priority>, 1.0-1.3 CPU and 2Gi
    each), the first victim on every fourth node a member of a PodGroup
    of its own, and one PodDisruptionBudget over band b0 allowing
    n_nodes // 2 disruptions."""
    policy = importlib.import_module(api.__name__ + ".policy")
    rng = np.random.default_rng(seed)
    nodes, victims = [], []
    k = 0
    for i in range(n_nodes):
        nodes.append(slice_node(api, i))
        for j in range(3):
            prio = int(rng.choice((0, 10, 100)))
            labels = {"band": f"b{prio}"}
            if i % 4 == 0 and j == 0:
                labels[api.wellknown.LABEL_POD_GROUP] = f"vg{i // 4}"
            pod = api.Pod(
                metadata=api.ObjectMeta(name=f"v{k}", namespace="default",
                                        labels=labels),
                spec=api.PodSpec(
                    node_name=f"node-{i}", priority=prio,
                    containers=[api.Container(
                        name="c", image="img",
                        resources=api.ResourceRequirements(requests={
                            "cpu": api.Quantity(
                                f"{int(rng.integers(10, 14))}00m"),
                            "memory": api.Quantity("2Gi")}))]))
            pod.status.start_time = f"2026-08-01T00:{k % 60:02d}:00Z"
            victims.append(pod)
            k += 1
    pdb = policy.PodDisruptionBudget(
        metadata=api.ObjectMeta(name="pdb-b0", namespace="default"),
        spec=policy.PodDisruptionBudgetSpec(
            selector=api.LabelSelector(match_labels={"band": "b0"})),
        status=policy.PodDisruptionBudgetStatus(
            disruptions_allowed=n_nodes // 2))
    return nodes, victims, pdb


def storm_cache(api, cache_cls, n_nodes: int, seed: int = 0):
    """(cache, [pdb]): the storm cluster straight in a scheduler cache,
    as bench.py's run_storm builds it."""
    nodes, victims, pdb = storm_objects(api, n_nodes, seed)
    cache = cache_cls()
    for node in nodes:
        cache.add_node(node)
    for pod in victims:
        cache.add_pod(pod)
    return cache, [pdb]


def storm_client(api, client, n_nodes: int, seed: int = 0):
    """The storm cluster created through a Client: the nodes, the bound
    victims and the PodDisruptionBudget object. Returns the victims."""
    nodes, victims, pdb = storm_objects(api, n_nodes, seed)
    for node in nodes:
        client.nodes().create(node)
    created = [client.pods().create(pod) for pod in victims]
    client.pod_disruption_budgets("default").create(pdb)
    return created


def storm_preemptor(api, i: int):
    """Preemptor i of the storm: 2 CPU and 3Gi at priority 1000, more
    than any node has free."""
    return api.Pod(
        metadata=api.ObjectMeta(name=f"hi{i}", namespace="default"),
        spec=api.PodSpec(priority=1000, containers=[api.Container(
            name="c", image="img",
            resources=api.ResourceRequirements(requests={
                "cpu": api.Quantity("2"),
                "memory": api.Quantity("3Gi")}))]))


def storm_gang(api, g: int, size: int = 8, topology_key: str = STORM_SLICE):
    """(PodGroup, members) of gang g of the storm: `size` members of
    storm_preemptor's shape (2 CPU, 3Gi, priority 1000), minMember `size`,
    topologyKey tpu/slice — bench.py preempt_main's gang_preempt demand
    (`topology_key` "" makes it a gang with no topology key, which prices
    the whole cluster as one domain)."""
    group = pod_group(api, f"gang{g}", size, topology_key)
    members = []
    for j in range(size):
        pod = storm_preemptor(api, 0)
        pod.metadata.name = f"gang{g}-{j}"
        pod.metadata.labels = {api.wellknown.LABEL_POD_GROUP: f"gang{g}"}
        members.append(pod)
    return group, members


class InformerPump:
    """Delivers a scheduler's informer events on the calling thread, in
    place of starting its SharedInformerFactory: each informer lists once
    here, then pump() hands it every event the store published since, in
    store order. A drain driven this way sees every earlier write
    (a preemption's evictions before the next preemption prices), whatever
    the thread timing, so two runs of one fixture decide alike."""

    def __init__(self, factory):
        self._pairs = []
        for inf in list(factory._informers.values()):
            inf._relist()
            self._pairs.append(
                (inf, inf._rc.watch(resource_version=inf.last_sync_rv)))

    def pump(self) -> int:
        """Deliver every pending event; returns how many."""
        n = 0
        for inf, watch in self._pairs:
            while True:
                try:
                    ev = watch.events.get_nowait()
                except queue_mod.Empty:
                    break
                if ev is None:
                    break
                inf._process_event(ev)
                n += 1
        return n

    def close(self) -> None:
        for _inf, watch in self._pairs:
            watch.stop()


#: how far drain_until_idle steps the clock when nothing is poppable: the
#: queue's longest backoff (queue.py MAX_BACKOFF)
BACKOFF_STEP_S = 10.0


def drain_until_idle(sched, pump: "InformerPump", clock,
                     max_rounds: int = 64) -> int:
    """Drive Scheduler.drain_pipelined with preemption on until no pod
    is pending: after each preemption and each drain the pump delivers
    the store's events (evictions, nominations, binds), and when nothing
    is poppable the FakeClock steps past the pods' backoff. Returns the
    pods bound."""
    try_preempt = sched._try_preempt

    def preempt_then_deliver(pod):
        try_preempt(pod)
        pump.pump()
    sched._try_preempt = preempt_then_deliver
    bound = 0
    try:
        for _ in range(max_rounds):
            bound += sched.drain_pipelined()
            pump.pump()
            if sched.queue.num_pending() == 0:
                break
            if sched.queue.active_depth() == 0:
                clock.step(BACKOFF_STEP_S)
    finally:
        del sched._try_preempt
    return bound
