"""The port's scheduler loop against the JAX package's, end to end.

kubernetes_tpu_torch.scheduler.Scheduler(device="cpu") and
kubernetes_tpu.scheduler.Scheduler get the same cluster through their own
Client(validate=False) and must bind every pod to the same node, through
schedule_pending and through drain_pipelined:

- the tests/test_pipeline.py fixture (16 nodes, 96 pods, batch 16);
- a spread fixture (a Service selecting every pod, nine label groups) whose
  batches sub-chunk by soft_batch_limit;
- a multi-tenant fixture (nine tenants, priorities 0, 0, 0, 1000, batch
  128) whose pops go through the DRF kernels. The pipelined drain's order
  depends on commit-thread timing when tenants differ, so both sides run
  with KTPU_COMMIT_THREAD=0; the DRF report must agree too;
- a fixture wired through started informers (client create -> informer
  -> queue).

Then the boundary: an unschedulable pod with preemption off, and with
preemption on but nothing to evict, gives the same attribution,
FailedScheduling event and pending state in both packages; a
NotImplementedError in a launch (what an unported route raises) stops
the run loop and is raised, not printed; extenders raise, and a mesh
(argument or KTPU_MESH) builds a sharded scheduler of at most 8 shards.
"""

import time

import pytest
import torch

from kubernetes_tpu import api as japi
from kubernetes_tpu.scheduler import Scheduler as JScheduler
from kubernetes_tpu.scheduler import priorities as jprios
from kubernetes_tpu.state import Client as JClient
from kubernetes_tpu_torch import api as tapi
from kubernetes_tpu_torch.scheduler import Scheduler as TScheduler
from kubernetes_tpu_torch.scheduler import priorities as tprios
from kubernetes_tpu_torch.state import Client as TClient
from kubernetes_tpu_torch.tenancy import TENANT_LABEL

JAX = (japi, JScheduler, JClient, jprios, {})
PORT = (tapi, TScheduler, TClient, tprios, {"device": "cpu"})
SHAPES = (("100m", "128Mi"), ("250m", "512Mi"), ("500m", "1Gi"))
#: (cpu, memory, pods) of the nodes of the fixtures of a few hundred pods
BIG_NODE = ("4", "16Gi", 32)


def make_pod(api, i, cpu="100m", mem="128Mi", labels=None, priority=None):
    return api.Pod(
        metadata=api.ObjectMeta(name=f"pod-{i}", namespace="default",
                                labels=dict(labels or {})),
        spec=api.PodSpec(priority=priority, containers=[api.Container(
            name="c", image="img",
            resources=api.ResourceRequirements(
                requests={"cpu": api.Quantity(cpu),
                          "memory": api.Quantity(mem)}))]))


def make_node(api, i, cpu="2", mem="4Gi", pods=16, zones=4):
    alloc = {"cpu": api.Quantity(cpu), "memory": api.Quantity(mem),
             "pods": api.Quantity(pods)}
    return api.Node(
        metadata=api.ObjectMeta(
            name=f"node-{i}",
            labels={api.wellknown.LABEL_HOSTNAME: f"node-{i}",
                    api.wellknown.LABEL_ZONE: f"zone-{i % zones}"}),
        status=api.NodeStatus(capacity=dict(alloc), allocatable=dict(alloc),
                              conditions=[api.NodeCondition(type="Ready",
                                                            status="True")]))


def build(side, n_nodes, pods, batch_size, service=None, node=(), **kw):
    """The test_pipeline.py wiring: nodes and pods created through the
    client, fed straight into the cache and the queue."""
    api, Scheduler, Client, prios, dev = side
    client = Client(validate=False)
    sched = Scheduler(client, batch_size=batch_size, **dev, **kw)
    if service is not None:
        svc = api.Service(metadata=api.ObjectMeta(name="svc",
                                                  namespace="default"),
                          spec=api.ServiceSpec(selector=service))
        client.services().create(svc)
        sched.algorithm.scorer.listers = prios.SpreadListers(
            services=lambda ns: [svc])
    for i in range(n_nodes):
        n = make_node(api, i, *node)
        client.nodes().create(n)
        sched.cache.add_node(n)
    for spec in pods:
        sched.queue.add(client.pods().create(make_pod(api, *spec)))
    return client, sched


def bind_map(client):
    pods, _ = client.pods().list_rv(namespace=None)
    return {p.metadata.name: p.spec.node_name for p in pods}


def drain(sched, how):
    if how == "pipelined":
        return sched.drain_pipelined()
    n = 0
    while True:
        res = sched.schedule_pending(timeout=0)
        if not res:
            return n
        n += sum(r.node_name is not None for r in res)


def pipeline_pods(n):
    return [(i, *SHAPES[i % 3]) for i in range(n)]


def spread_pods(n, groups=9):
    return [(i, *SHAPES[i % 3], {"app": "m", "grp": f"g{i % groups}"})
            for i in range(n)]


def tenant_pods(n, tenants=9):
    return [(i, *SHAPES[(i // tenants) % 3], {TENANT_LABEL: f"t{i % tenants}"},
             1000 if i % 4 == 3 else 0) for i in range(n)]


@pytest.mark.parametrize("how", ["pending", "pipelined"])
def test_pipeline_fixture_binds_like_jax(how):
    runs = []
    for side in (JAX, PORT):
        client, sched = build(side, 16, pipeline_pods(96), 16)
        assert drain(sched, how) == 96
        runs.append(bind_map(client))
    assert runs[0] == runs[1]
    assert all(runs[1].values())


@pytest.mark.parametrize("how", ["pending", "pipelined"])
def test_spread_fixture_binds_like_jax(how):
    runs = []
    for side in (JAX, PORT):
        client, sched = build(side, 32, spread_pods(300), 300,
                              service={"app": "m"}, node=BIG_NODE)
        pods = [p for p in sched.queue.pending_pods()]
        # nine spread groups overflow the in-scan cap: the drain chunks
        assert sched.algorithm.soft_batch_limit(pods) == \
            sched.algorithm.SOFT_SCORE_CHUNK < len(pods)
        assert drain(sched, how) == 300
        runs.append(bind_map(client))
    assert runs[0] == runs[1]


@pytest.mark.parametrize("how", ["pending", "pipelined"])
def test_multi_tenant_fixture_binds_like_jax(how, monkeypatch):
    monkeypatch.setenv("KTPU_COMMIT_THREAD", "0")
    runs, reports = [], []
    for side in (JAX, PORT):
        client, sched = build(side, 32, tenant_pods(400), 128,
                              node=BIG_NODE)
        assert drain(sched, how) == 400
        runs.append(bind_map(client))
        reports.append(sched.drf.report())
    assert runs[0] == runs[1]
    assert reports[0] == reports[1]
    assert len(reports[1]["tenants"]) == 9


def test_multi_tenant_batches_reach_the_drf_kernels(monkeypatch):
    """Pops of 64 pods or more go through K4 and K5 (their plain
    versions here, as the tensors are on the CPU)."""
    from kubernetes_tpu_torch.tenancy import kernels as tk
    calls = []
    for name in ("drf_dominant", "drf_order"):
        orig = getattr(tk, name)
        monkeypatch.setattr(tk, name, lambda *a, _o=orig, _n=name:
                            calls.append(_n) or _o(*a))
    monkeypatch.setenv("KTPU_COMMIT_THREAD", "0")
    client, sched = build(PORT, 32, tenant_pods(300), 128, node=BIG_NODE)
    assert sched.drain_pipelined() == 300
    # 128 + 128 + 44: two pops reach the device path
    assert calls.count("drf_dominant") == 2
    assert calls.count("drf_order") == 2


def _wired(side):
    """test_sharded.py's wiring: objects reach the scheduler only
    through its started informers."""
    api, Scheduler, Client, _prios, dev = side
    client = Client()
    client.services().create(api.Service(
        metadata=api.ObjectMeta(name="m", namespace="default"),
        spec=api.ServiceSpec(selector={"app": "m"})))
    sched = Scheduler(client, batch_size=32, **dev)
    sched.informers.start()
    try:
        sched.informers.wait_for_cache_sync()
        for i in range(12):
            client.nodes().create(make_node(api, i, *BIG_NODE))
        pods = [client.pods().create(make_pod(api, i, *SHAPES[i % 3],
                                              labels={"app": "m"}))
                for i in range(100)]
        deadline = time.time() + 60
        while sched.queue.num_pending() < len(pods) or \
                len(sched.cache.node_names()) < 12:
            if time.time() > deadline:
                raise RuntimeError("informer sync stalled")
            time.sleep(0.01)
        assert sched.algorithm.scorer.listers.selectors_for_pod(pods[0])
        sched.algorithm.refresh()
        n = sched.drain_pipelined()
        return n, bind_map(client)
    finally:
        sched.informers.stop()


def test_informer_wired_drain_binds_like_jax():
    nj, jbinds = _wired(JAX)
    nt, tbinds = _wired(PORT)
    assert nj == nt == 100
    assert jbinds == tbinds


# ------------------------------------------------------------ boundary


def _unschedulable(side, **kw):
    client, sched = build(side, 2, [(0, "100m", "128Mi"),
                                    (1, "64", "1Gi")], 8, **kw)
    return client, sched


def test_unschedulable_attribution_matches_jax():
    out = []
    for side in (JAX, PORT):
        client, sched = _unschedulable(side, disable_preemption=True)
        sched.schedule_pending(timeout=0)
        rec = sched.attribution.get("default/pod-1")
        events = [(e.reason, e.message, e.involved_object.name)
                  for e in client.events().list()]
        out.append((rec["reason"], rec["message"], events,
                    sched.unschedulable_count, bind_map(client)))
    assert out[0] == out[1]
    assert out[1][2] and out[1][2][0][0] == "FailedScheduling"


@pytest.mark.parametrize("how", ["pending", "pipelined"])
@pytest.mark.parametrize("thread", ["0", "1"])
def test_preemption_raises_instead_of_printing(how, thread, monkeypatch):
    """Preemption is ported (slice 4): with it on, a pod that fits
    nowhere and has no lower-priority pod to evict gets the same
    attribution, events and pending state as in the JAX package, and no
    preemption attempt is counted."""
    monkeypatch.setenv("KTPU_COMMIT_THREAD", thread)
    out = []
    for side in (JAX, PORT):
        client, sched = _unschedulable(side)
        drain(sched, how)
        sched.stop()
        rec = sched.attribution.get("default/pod-1")
        events = sorted((e.reason, e.message, e.involved_object.name)
                        for e in client.events().list())
        out.append((rec["reason"], rec["message"], events,
                    sched.unschedulable_count, sched.queue.num_pending(),
                    sorted(p.metadata.name
                           for p in sched.queue.pending_pods()),
                    sched.metrics.preemption_attempts.value(),
                    dict(sched.queue.nominated.by_node()),
                    bind_map(client)))
    assert out[0] == out[1]
    assert out[1][4] == 1 and out[1][6] == 0.0
    assert out[1][8]["pod-0"] and not out[1][8]["pod-1"]


def test_run_loop_keeps_the_error_and_stop_raises_it(monkeypatch):
    """A route that is still unported stops the run loop; wait_for_idle
    and stop raise the error. (Gang batches drove this test until slice 6
    ported them, KTPU_SPECULATIVE=1 until slice 7, the affinity-mask
    device route until slice 8.) The loop reaches no unported route any
    more (extenders and the WAL raise when they are built), so the
    launch raises here, as an unported route inside it would."""
    from kubernetes_tpu_torch.scheduler.core import BatchScheduler

    def unported(self, pods, *a, **kw):
        raise NotImplementedError("schedule_launch: an unported route")
    monkeypatch.setattr(BatchScheduler, "schedule_launch", unported)
    client = TClient(validate=False)
    sched = TScheduler(client, batch_size=8, device="cpu")
    client.nodes().create(make_node(tapi, 0))
    sched.start()
    try:
        client.pods().create(make_pod(tapi, 0))
        # the pod reaches the loop through the informer thread
        deadline = time.time() + 60
        while sched._loop_error is None and time.time() < deadline:
            time.sleep(0.01)
        with pytest.raises(NotImplementedError, match="unported route"):
            sched.wait_for_idle(timeout=30)
    finally:
        with pytest.raises(NotImplementedError):
            sched.stop()


def test_mesh_and_extenders_raise(monkeypatch):
    """Since slice 9 a mesh is the sharded class scan's shards on the
    card: mesh=2 builds a 2-shard scheduler (its mirror and DRF account
    on the mesh), KTPU_MESH=auto an 8-shard one, and more shards than a
    thread-block cluster takes raise. Extenders still raise."""
    client = TClient(validate=False)
    sched = TScheduler(client, device="cpu", mesh=2)
    assert sched.mesh.shape["nodes"] == 2
    assert sched.algorithm.mirror.mesh is sched.mesh
    assert sched.drf.device == sched.mesh.device
    with pytest.raises(ValueError, match="shards"):
        TScheduler(client, device="cpu", mesh=10_000)
    with pytest.raises(NotImplementedError, match="extender"):
        TScheduler(client, device="cpu", extenders=[object()])
    monkeypatch.setenv("KTPU_MESH", "auto")
    assert TScheduler(client, device="cpu").mesh.shape["nodes"] == 8


def test_scheduler_runs_on_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TScheduler(TClient())
    sched = TScheduler(TClient(), device="cpu")
    assert sched.algorithm.device.type == sched.drf.device.type == "cpu"


def test_commit_thread_follows_the_device(monkeypatch):
    monkeypatch.delenv("KTPU_COMMIT_THREAD", raising=False)
    sched = TScheduler(TClient(), device="cpu")
    monkeypatch.setattr(sched.algorithm, "device", torch.device("cuda"))
    assert sched._commit_overlaps() is True
    monkeypatch.setenv("KTPU_COMMIT_THREAD", "0")
    sched = TScheduler(TClient(), device="cpu")
    assert sched._commit_overlaps() is False


def test_unported_client_routes_raise():
    from kubernetes_tpu_torch.state import Store
    client = TClient()
    for call in (client.jobs, client.roles, client.cluster_roles,
                 client.horizontal_pod_autoscalers,
                 client.certificate_signing_requests,
                 lambda: client.pods().merge_patch("p", {})):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()
    with pytest.raises(NotImplementedError, match="write-ahead"):
        Store(wal_path="unused")
    with pytest.raises(NotImplementedError, match="write-ahead"):
        Store().restart()
