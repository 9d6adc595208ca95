"""Preemption in the port against the JAX package (port slice 4).

Here on the CPU, with the same seeded fixtures built in both packages'
types:

- price_nodes_plain (K6's plain version) against the JAX `price_nodes`
  and the numpy oracle `price_nodes_reference`: winner, chosen units,
  prefix lengths and PDB violations equal, no tolerance, on the
  reference test's randomized clusters and on fixtures with priorities
  near 2·10^9, memory requests that are not powers of two and rows of
  up to 32 and 128 units, where the f32 sums depend on their order; and
  past the caps K6 once had: rows of 2,048 units and of 24 resources, and
  a preemption on a bench.py make_wide_node-sized node (V = 2,048)
  through BatchScheduler.preempt;
- build_victim_tables: the port's arrays equal the JAX package's, key by
  key (group units, PDB last-resort units, over-share ranks, a unit
  cache hit and a generation-invalidated miss);
- BatchScheduler.preempt plans equal JAX's on bench.py's storm fixture,
  through the kernel route and the serial reprieve control;
- the scheduler loop end to end: the reference's end-to-end preemption
  test, and a storm through Scheduler.drain_pipelined (binds, evicted
  victims, nominations, Preempted events, metrics);
- K6's one-pass lexicographic fold with its NaN flag (a Python model of
  csrc/price_nodes.cu's, under random splits into CTAs) against the
  five narrowing passes of _lexi_winner_plain and the JAX _lexi_winner,
  and its design choice.

Every multi-pod loop comparison runs with KTPU_COMMIT_THREAD=0 on both
sides; the storm loop delivers informer events on the test's thread
(workload.InformerPump) and steps a FakeClock past backoffs.
"""

import time

import numpy as np
import pytest
import torch

from kubernetes_tpu import api as japi
from kubernetes_tpu.api import policy as jpolicy
from kubernetes_tpu.scheduler import Scheduler as JScheduler
from kubernetes_tpu.scheduler.cache import Cache as JCache
from kubernetes_tpu.scheduler.core import BatchScheduler as JBatch
from kubernetes_tpu.scheduler.kernels import preempt as jpk
from kubernetes_tpu.scheduler.nodeinfo import NodeInfo as JNodeInfo
from kubernetes_tpu.scheduler.queue import NominatedPodMap as JNominated
from kubernetes_tpu.state import Client as JClient
from kubernetes_tpu.utils.clock import FakeClock as JFakeClock

from kubernetes_tpu_torch import api as tapi
from kubernetes_tpu_torch import workload
from kubernetes_tpu_torch.api import policy as tpolicy
from kubernetes_tpu_torch.convert import victim_tables_from_numpy
from kubernetes_tpu_torch.scheduler import Scheduler as TScheduler
from kubernetes_tpu_torch.scheduler.cache import Cache as TCache
from kubernetes_tpu_torch.scheduler.core import BatchScheduler as TBatch
from kubernetes_tpu_torch.scheduler.kernels import batch as tb
from kubernetes_tpu_torch.scheduler.kernels import preempt as tpk
from kubernetes_tpu_torch.scheduler.nodeinfo import NodeInfo as TNodeInfo
from kubernetes_tpu_torch.scheduler.queue import NominatedPodMap as TNominated
from kubernetes_tpu_torch.state import Client as TClient
from kubernetes_tpu_torch.tenancy import TENANT_LABEL
from kubernetes_tpu_torch.utils.clock import FakeClock as TFakeClock

JAX = dict(api=japi, policy=jpolicy, NodeInfo=JNodeInfo, Cache=JCache,
           Batch=JBatch, pk=jpk, Nominated=JNominated, Scheduler=JScheduler,
           Client=JClient, FakeClock=JFakeClock, kw={})
PORT = dict(api=tapi, policy=tpolicy, NodeInfo=TNodeInfo, Cache=TCache,
            Batch=TBatch, pk=tpk, Nominated=TNominated, Scheduler=TScheduler,
            Client=TClient, FakeClock=TFakeClock, kw={"device": "cpu"})


def make_pod(api, name, cpu="100m", mem="200Mi", node="", priority=None,
             labels=None, group=None, start=None):
    labels = dict(labels or {})
    if group is not None:
        labels[api.wellknown.LABEL_POD_GROUP] = group
    pod = api.Pod(
        metadata=api.ObjectMeta(name=name, namespace="default",
                                labels=labels),
        spec=api.PodSpec(
            node_name=node, priority=priority,
            containers=[api.Container(
                name="c", image="img",
                resources=api.ResourceRequirements(
                    requests={"cpu": api.Quantity(cpu),
                              "memory": api.Quantity(mem)}))]))
    if start is not None:
        pod.status.start_time = start
    return pod


def make_node(api, name, cpu="4", mem="8Gi", pods=12):
    alloc = {"cpu": api.Quantity(cpu), "memory": api.Quantity(mem),
             "pods": api.Quantity(pods)}
    return api.Node(
        metadata=api.ObjectMeta(name=name,
                                labels={api.wellknown.LABEL_HOSTNAME: name}),
        status=api.NodeStatus(
            capacity=dict(alloc), allocatable=dict(alloc),
            conditions=[api.NodeCondition(type="Ready", status="True")]))


def make_pdb(side, name, match, allowed):
    api, policy = side["api"], side["policy"]
    return policy.PodDisruptionBudget(
        metadata=api.ObjectMeta(name=name, namespace="default"),
        spec=policy.PodDisruptionBudgetSpec(
            selector=api.LabelSelector(match_labels=dict(match))),
        status=policy.PodDisruptionBudgetStatus(disruptions_allowed=allowed))


def rand_cluster(side, rng, n_nodes=12, pods_per_node=5, n_groups=3,
                 mem=None, prio=None, tenants=0, node_mem="8Gi",
                 node_pods=12):
    """tests/test_preempt.py _rand_cluster in either package's types (the
    same draws in the same order): mixed priorities, some pods in
    PodGroups, start times shuffled. `mem` / `prio` replace the memory
    and priority draws, `tenants` labels every pod with one of that many
    tenants."""
    api = side["api"]
    infos = {}
    k = 0
    for i in range(n_nodes):
        ni = side["NodeInfo"](make_node(api, f"n{i}", mem=node_mem,
                                        pods=node_pods))
        for _ in range(int(rng.integers(0, pods_per_node + 1))):
            grp = None
            if rng.random() < 0.3:
                grp = f"g{int(rng.integers(0, n_groups))}"
            labels = {"band": f"b{int(rng.integers(0, 3))}"}
            if tenants:
                labels[TENANT_LABEL] = f"t{k % tenants}"
            p = make_pod(
                api, f"v{k}", cpu=f"{int(rng.integers(2, 12)) * 100}m",
                mem=mem(rng) if mem else
                f"{int(rng.integers(1, 8)) * 128}Mi",
                node=f"n{i}",
                priority=prio(rng) if prio else int(rng.integers(0, 50)),
                labels=labels, group=grp,
                start=f"2026-08-0{int(rng.integers(1, 5))}T00:00:0"
                      f"{int(rng.integers(0, 10))}Z")
            ni.add_pod(p)
            k += 1
        infos[f"n{i}"] = ni
    return infos


def _price_all(a):
    """(JAX price_nodes, numpy oracle, port plain) on one table."""
    j = jpk.price_nodes(*(a[k] for k in tpk.PRICE_KEYS))
    r = jpk.price_nodes_reference(a)
    ta = victim_tables_from_numpy(a, "cpu")
    t = tpk.price_nodes(*(ta[k] for k in tpk.PRICE_KEYS))
    return (tuple(np.asarray(x) for x in j), tuple(np.asarray(x) for x in r),
            tuple(x.numpy() for x in t))


def _assert_decisions(ref, got):
    for name, x, y in zip(("winner", "chosen", "k", "nviol"), ref, got):
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)


def _tables(seed, preemptor_prio=100, need_mem="1Gi", **kw):
    rng = np.random.default_rng(seed)
    infos = rand_cluster(JAX, rng, **kw)
    pdbs = [make_pdb(JAX, "pdb0", {"band": "b0"}, int(rng.integers(0, 3))),
            make_pdb(JAX, "pdb1", {"band": "b1"}, 0)]
    pod = make_pod(japi, "high", cpu=f"{int(rng.integers(10, 40)) * 100}m",
                   mem=need_mem, priority=preemptor_prio)
    return jpk.build_victim_tables(pod, sorted(infos.items()), infos, pdbs)


@pytest.mark.parametrize("seed", range(12))
def test_price_nodes_plain_matches_jax(seed):
    """tests/test_preempt.py's randomized fixture: the port's plain
    version decides as the JAX kernel and the numpy oracle decide."""
    tabs = _tables(seed)
    if tabs is None:
        pytest.fail("the fixture has no candidate")
    j, r, t = _price_all(tabs.arrays)
    _assert_decisions(j, t)
    _assert_decisions(r, t)


def _system_prio(rng):
    return 2_000_000_000 - int(rng.integers(0, 1000))


def _odd_mem(rng):
    # byte counts that f32 cannot hold exactly
    return str(int(rng.integers(100_000_001, 999_999_999)) | 1)


#: fixtures whose f32 sums depend on the order they are added in:
#: (cluster kwargs, preemptor memory); each runs over several seeds
HARD = {
    "system-priorities": (dict(prio=_system_prio,
                               preemptor_prio=2_000_001_000), "1Gi"),
    "odd-memory": (dict(mem=_odd_mem, node_mem="8000000007"), "1234567891"),
    "v32-odd-memory": (dict(mem=_odd_mem, pods_per_node=30, node_pods=64,
                            node_mem="30000000001", n_nodes=16),
                       "4321098765"),
    "v32-system-priorities": (dict(prio=_system_prio, mem=_odd_mem,
                                   preemptor_prio=2_000_001_000,
                                   pods_per_node=30, node_pods=64,
                                   node_mem="30000000001", n_nodes=16),
                              "4321098765"),
}


@pytest.mark.parametrize("case", sorted(HARD))
def test_price_nodes_plain_matches_jax_on_inexact_sums(case):
    kw, need_mem = HARD[case]
    seen_v = set()
    for seed in range(6):
        tabs = _tables(100 + seed, need_mem=need_mem, **kw)
        if tabs is None:
            continue
        seen_v.add(tabs.arrays["valid"].shape[1])
        j, r, t = _price_all(tabs.arrays)
        _assert_decisions(j, t)
    if case.startswith("v32"):
        assert 32 in seen_v


@pytest.mark.parametrize("V", [32, 128])
def test_prefix_order_follows_the_reference_kernel(V):
    """Rows of V units whose freed bytes (1e8-2e9 each) make the prefix
    sums inexact, with each row's free space set so the preemptor fits at
    a boundary unit: the JAX kernel's sums (XLA on the CPU: blocks of 16
    for the prefix, chunks of 32 for the priority sum) decide some rows
    unlike a sequential sum, which the reference's numpy oracle takes.
    The port follows the kernel."""
    rng = np.random.default_rng(V)
    n, f32 = 64, np.float32
    freed = rng.integers(10**8, 2 * 10**9, (n, V, 2)).astype(f32)
    seq = np.cumsum(freed, axis=1, dtype=f32)
    t = rng.integers(0, V, n)
    need = np.full((2,), f32(3e9))
    top = rng.integers(2 * 10**9 - 100, 2 * 10**9, (n, V)).astype(np.int32)
    a = {"free0": (need[None, :] - seq[np.arange(n), t]).astype(f32),
         "cfree0": np.zeros(n, f32), "need": need, "need_cnt": f32(1),
         "freed": freed, "fcnt": np.ones((n, V), f32),
         "valid": np.ones((n, V), bool), "pdb": rng.random((n, V)) < 0.1,
         "top": top, "psum": top.astype(f32),
         "gcnt": np.ones((n, V), np.int32),
         "startr": rng.integers(0, 50, (n, V)).astype(np.int32),
         "row_valid": np.ones(n, bool)}
    j, r, t = _price_all(a)
    _assert_decisions(j, t)
    assert not np.array_equal(j[2], r[2])   # the oracle's order differs


def _inexact_rows(V, R, n, seed):
    """n rows of V units over R resources, the fixture of the prefix-order
    test above (freed values that make the f32 sums inexact, each row's
    free space set so the preemptor fits at a boundary unit), with a few
    invalid units."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    freed = rng.integers(10**8, 2 * 10**9, (n, V, R)).astype(f32)
    seq = np.cumsum(freed, axis=1, dtype=f32)
    t = rng.integers(0, V, n)
    need = np.full((R,), f32(3e9))
    top = rng.integers(2 * 10**9 - 100, 2 * 10**9, (n, V)).astype(np.int32)
    return {"free0": (need[None, :] - seq[np.arange(n), t]).astype(f32),
            "cfree0": np.zeros(n, f32), "need": need, "need_cnt": f32(1),
            "freed": freed, "fcnt": np.ones((n, V), f32),
            "valid": rng.random((n, V)) < 0.97,
            "pdb": rng.random((n, V)) < 0.1, "top": top,
            "psum": top.astype(f32), "gcnt": np.ones((n, V), np.int32),
            "startr": rng.integers(0, 50, (n, V)).astype(np.int32),
            "row_valid": np.ones(n, bool)}


@pytest.mark.parametrize("V,R,n", [(2048, 2, 6), (64, 24, 16),
                                   (2048, 24, 4)])
def test_price_nodes_plain_matches_jax_past_the_old_caps(V, R, n):
    """K6's plain version prices what it refused before: rows of 2,048
    units (bench.py's 1,200-pod wide node buckets there) and 24-resource
    rows, deciding as the JAX kernel does at inexact sums (the prefix and
    priority sums recurse in XLA's order past 1,024 units)."""
    j, _r, t = _price_all(_inexact_rows(V, R, n, V + R))
    _assert_decisions(j, t)
    assert j[0] >= 0 and (j[2] > 1).sum() > n // 2


def _wide_node_side(side):
    """bench.py's make_wide_node (64 CPU, 256Gi, 1,200 pods) holding 1,150
    bound victims of 50m / 200Mi at priorities 0-49, in either package's
    types, and a preemptor of 10 CPU at priority 1000."""
    api = side["api"]
    rng = np.random.default_rng(11)
    cache = side["Cache"]()
    cache.add_node(make_node(api, "wide", cpu="64", mem="256Gi", pods=1200))
    for k in range(1150):
        cache.add_pod(make_pod(
            api, f"v{k}", cpu="50m", node="wide",
            priority=int(rng.integers(0, 50)),
            start=f"2026-08-0{int(rng.integers(1, 5))}T00:00:"
                  f"{int(rng.integers(0, 60)):02d}Z"))
    sched = side["Batch"](cache, pdb_lister=lambda: [], **side["kw"])
    return sched, make_pod(api, "high", cpu="10", mem="1Gi", priority=1000)


def test_wide_node_preemption_yields_a_plan():
    """A preemptor on a make_wide_node-sized node: 1,150 victim units
    bucket to V = 2,048, which K6 refused. BatchScheduler.preempt now
    plans it, and the plan equals the JAX package's."""
    plans = []
    for side in (JAX, PORT):
        sched, pod = _wide_node_side(side)
        plans.append(_plan_key(sched.preempt(pod)))
    assert plans[0] == plans[1]
    assert plans[1] is not None and plans[1][0] == "wide"
    # 7.5 CPU free: at least 50 victims of 50m go
    assert len(plans[1][1]) >= 50
    sched, pod = _wide_node_side(PORT)
    sched.refresh()
    infos = sched.snapshot.node_infos
    tabs = tpk.build_victim_tables(pod, sorted(infos.items()), infos, [])
    assert tabs.arrays["valid"].shape[1] == 2048


# ------------------------------------------------------------ tables


def _overshare_cluster(side, rng):
    return rand_cluster(side, rng, tenants=3)


def _case_tables(side, case):
    """(tables, unit cache) for one build_victim_tables case, built from
    the same draws in `side`'s types."""
    api, pk = side["api"], side["pk"]
    rng = np.random.default_rng({"groups": 1, "pdb": 2, "overshare": 3,
                                 "cache-hit": 4, "generation": 5}[case])
    infos = rand_cluster(side, rng, tenants=3 if case == "overshare" else 0,
                         n_groups=2 if case == "groups" else 3)
    pdbs = [make_pdb(side, "pdb0", {"band": "b0"},
                     0 if case == "pdb" else 1)]
    pod = make_pod(api, "high", cpu="2500m", mem="2Gi", priority=100)
    cands = sorted(infos.items())
    overshare = {"t0": 2, "t1": 0, "t2": 1} if case == "overshare" else None
    cache = {} if case in ("cache-hit", "generation") else None
    tabs = pk.build_victim_tables(pod, cands, infos, pdbs, unit_cache=cache,
                                  overshare=overshare)
    if case == "cache-hit":
        tabs = pk.build_victim_tables(pod, cands, infos, pdbs,
                                      unit_cache=cache)
    elif case == "generation":
        ni = infos["n3"]
        ni.remove_pod(ni.pods[0])
        ni.generation += 1
        ni.add_pod(make_pod(api, "late", cpu="700m", node="n3", priority=7,
                            start="2026-08-09T00:00:00Z"))
        tabs = pk.build_victim_tables(pod, cands, infos, pdbs,
                                      unit_cache=cache)
    return tabs, cache


@pytest.mark.parametrize("case", ["groups", "pdb", "overshare", "cache-hit",
                                  "generation"])
def test_build_victim_tables_matches_jax(case):
    (jt, jc), (tt, tc) = (_case_tables(side, case) for side in (JAX, PORT))
    assert jt.names == tt.names and jt.res_names == tt.res_names
    assert [[u.key for u in row] for row in jt.units] == \
        [[u.key for u in row] for row in tt.units]
    assert set(jt.arrays) == set(tt.arrays)
    for k, v in jt.arrays.items():
        w = tt.arrays[k]
        assert np.asarray(v).dtype == np.asarray(w).dtype, k
        np.testing.assert_array_equal(np.atleast_1d(v).view(np.uint8),
                                      np.atleast_1d(w).view(np.uint8), k)
    if jc is not None:
        assert len(jc) == len(tc) > 0
    if case == "groups":
        assert any(u.is_group for row in tt.units for u in row)
    if case == "pdb":
        assert tt.arrays["pdb"].any()
    if case == "overshare":
        assert {u.oshare for row in tt.units for u in row} == {0, 1, 2}
    j, _r, t = _price_all(jt.arrays)
    _assert_decisions(j, t)


# ------------------------------------------------------------ plans


def _plan_key(plan):
    if plan is None:
        return None
    return (plan.node_name, [v.metadata.key() for v in plan.victims],
            plan.num_pdb_violations,
            [p.metadata.key() for p in plan.nominated_to_clear])


@pytest.mark.parametrize("kernel", ["1", "0"])
def test_preempt_plans_match_jax(kernel, monkeypatch):
    """bench.py's storm at 64 nodes: 20 preemptors in turn, each plan's
    victims removed from the cache before the next, a ghost nomination on
    every node (lower priority on the odd ones); the kernel route and the
    serial control (KTPU_PREEMPT_KERNEL=0) plan as JAX plans."""
    monkeypatch.setenv("KTPU_PREEMPT_KERNEL", kernel)
    runs = []
    for side in (JAX, PORT):
        api = side["api"]
        cache, pdbs = workload.storm_cache(api, side["Cache"], 64)
        nominated = side["Nominated"]()
        for i in range(64):
            ghost = workload.make_pod(api, 5_000_000 + i)
            ghost.spec.priority = 500 if i % 2 else 2000
            nominated.add(ghost, f"node-{i}")
        sched = side["Batch"](cache, pdb_lister=lambda p=pdbs: p,
                              nominated=nominated, **side["kw"])
        assert sched.preempt_kernel is (kernel == "1")
        plans = []
        for i in range(20):
            plan = sched.preempt(workload.storm_preemptor(api, i))
            plans.append(_plan_key(plan))
            if plan is not None:
                for v in plan.victims:
                    cache.remove_pod(v)
        runs.append(plans)
    assert runs[0] == runs[1]
    assert all(p is not None for p in runs[1])
    # lower nominations cleared on some chosen nodes, kept on others
    assert any(p[3] for p in runs[1]) and not all(p[3] for p in runs[1])


# ------------------------------------------------------------ end to end


def test_end_to_end_preemption_matches_jax(monkeypatch):
    """tests/test_scheduler.py test_end_to_end_preemption in both
    packages, informers and run loop started: the high-priority pod
    evicts the low one and lands; the evicted pod, the Preempted event
    and the counters agree."""
    monkeypatch.setenv("KTPU_COMMIT_THREAD", "0")
    out = []
    for side in (JAX, PORT):
        api = side["api"]
        client = side["Client"]()
        client.nodes().create(make_node(api, "only", cpu="1", mem="1Gi",
                                        pods=5))
        sched = side["Scheduler"](client, batch_size=8, **side["kw"])
        sched.start()
        try:
            client.pods().create(make_pod(api, "low", cpu="700m",
                                          priority=1))
            deadline = time.time() + 30
            while time.time() < deadline and \
                    not client.pods().get("low").spec.node_name:
                time.sleep(0.02)
            client.pods().create(make_pod(api, "high", cpu="700m",
                                          priority=100))
            deadline = time.time() + 30
            while time.time() < deadline and \
                    not client.pods().get("high").spec.node_name:
                time.sleep(0.02)
            pods = {p.metadata.name: p for p in client.pods().list()}
            events = sorted((e.reason, e.message, e.involved_object.name)
                            for e in client.events("default").list()
                            if e.reason == "Preempted")
            out.append(({k: p.spec.node_name for k, p in pods.items()},
                        pods["high"].status.nominated_node_name, events,
                        sched.metrics.preemption_attempts.value(),
                        sched.metrics.preemption_victims.value()))
        finally:
            sched.stop()
    assert out[0] == out[1]
    assert out[1][:2] == ({"high": "only"}, "only")
    assert out[1][3:] == (1.0, 1.0)


def _storm_loop(side, n_nodes, n_pods):
    api = side["api"]
    clock = side["FakeClock"]()
    client = side["Client"](validate=False)
    victims = workload.storm_client(api, client, n_nodes)
    sched = side["Scheduler"](client, batch_size=64, clock=clock,
                              **side["kw"])
    pump = workload.InformerPump(sched.informers)
    try:
        for i in range(n_pods):
            client.pods().create(workload.storm_preemptor(api, i))
        pump.pump()
        bound = workload.drain_until_idle(sched, pump, clock)
    finally:
        pump.close()
    pods = {p.metadata.name: p for p in client.pods().list()}
    events = sorted((e.involved_object.name, e.message)
                    for e in client.events("default").list()
                    if e.reason == "Preempted")
    return {"bound": bound,
            "binds": {k: p.spec.node_name for k, p in pods.items()},
            "evicted": sorted(v.metadata.name for v in victims
                              if v.metadata.name not in pods),
            "nominated": {k: p.status.nominated_node_name
                          for k, p in pods.items() if k.startswith("hi")},
            "events": events,
            "metrics": (sched.metrics.preemption_attempts.value(),
                        sched.metrics.preemption_victims.value()),
            "prio": {v.metadata.name: v.spec.priority for v in victims}}


def test_storm_through_the_scheduler_matches_jax(monkeypatch):
    """A 32-node storm of 12 preemptors through each package's
    Scheduler.drain_pipelined with preemption on: every preemptor is
    priced (K6's plain version), nominated, evicts, and lands through the
    nominated overlay (K2's nominated instance); binds, evicted victims,
    nominations, Preempted events and counters equal JAX's."""
    monkeypatch.setenv("KTPU_COMMIT_THREAD", "0")
    calls = []
    orig = tb._class_scan_plain
    monkeypatch.setattr(tb, "_class_scan_plain", lambda *a: calls.append(
        a[7] is not None) or orig(*a))
    priced = []
    orig_price = tpk.price_nodes_plain
    monkeypatch.setattr(tpk, "price_nodes_plain", lambda *a: priced.append(
        a[4].shape) or orig_price(*a))
    j = _storm_loop(JAX, 32, 12)
    t = _storm_loop(PORT, 32, 12)
    prio = t.pop("prio")
    j.pop("prio")
    assert t == j
    assert t["bound"] == 12
    assert all(t["binds"][f"hi{i}"] for i in range(12))
    assert t["metrics"][0] == 12.0 and t["evicted"]
    assert all(prio[v] < 1000 for v in t["evicted"])
    assert len(priced) == 12 and any(calls)


# ------------------------------------------------- K6's lexicographic fold


_NONE = (np.iinfo(np.int32).max,) * 2 + (np.float32(0.0), 0, 0,
                                         np.iinfo(np.int32).max, False)


def _lexi_min(a, b):
    """csrc/price_nodes.cu ktpu_lexi_min on (nviol, topv, psumv, cntv,
    -startv, row, nan) candidates: the lesser in pickOneNodeForPreemption's
    order (psumv as f32, so +0.0 and -0.0 tie), the NaN flags of a tied
    (nviol, topv) merged."""
    if b[5] == _NONE[5]:
        return a
    if a[5] == _NONE[5]:
        return b
    if a[0] != b[0]:
        return a if a[0] < b[0] else b
    if a[1] != b[1]:
        return a if a[1] < b[1] else b
    if a[2] < b[2]:
        take_a = True
    elif b[2] < a[2]:
        take_a = False
    elif a[3] != b[3]:
        take_a = a[3] < b[3]
    elif a[4] != b[4]:
        take_a = a[4] < b[4]
    else:
        take_a = a[5] < b[5]
    c = a if take_a else b
    return c[:6] + (a[6] or b[6],)


def _fold(cands, rng):
    """The candidates folded in a random association order (a thread's
    rows, a warp's shuffle tree, the CTA's and the cluster's folds)."""
    cands = list(cands)
    while len(cands) > 1:
        i = int(rng.integers(0, len(cands) - 1))
        cands[i:i + 2] = [_lexi_min(cands[i], cands[i + 1])]
    return cands[0] if cands else _NONE


def _fold_winner(feasible, crits, rng, ctas):
    """K6's fold over rows split into `ctas` contiguous slices of random
    sizes: each slice folded, then the slices' candidates; -1 when no
    row is feasible or the winner's (nviol, topv) had a NaN psumv."""
    nviol, topv, psumv, cntv, nstart = crits
    N = len(feasible)
    cuts = np.sort(rng.integers(0, N + 1, ctas - 1))
    bounds = np.concatenate([[0], cuts, [N]])
    parts = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        rows = [(int(nviol[i]), int(topv[i]), np.float32(psumv[i]),
                 int(cntv[i]), int(nstart[i]), i, bool(np.isnan(psumv[i])))
                for i in range(lo, hi) if feasible[i]]
        parts.append(_fold(rows, rng))
    c = _fold(parts, rng)
    return -1 if c[5] == _NONE[5] or c[6] else c[5]


@pytest.mark.parametrize("seed", range(8))
def test_price_fold_matches_the_narrowing(seed):
    """The one-pass fold of (nviol, topv, psumv, cntv, -startv, row) with
    the NaN flag, under random splits into CTAs and random fold orders,
    picks the row the five narrowing passes pick (the port's
    _lexi_winner_plain and the JAX _lexi_winner): on heavy ties, +0.0
    against -0.0, NaN psumv in and out of the winning (nviol, topv), and
    tables with no feasible row."""
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    for trial in range(60):
        N = int(rng.integers(1, 40))
        feasible = rng.random(N) < (0.0 if trial % 10 == 0 else 0.7)
        nviol = rng.integers(0, 2, N).astype(np.int32)
        topv = rng.choice([5, 7, 2_000_000_000], N).astype(np.int32)
        psumv = rng.choice(np.array([0.0, -0.0, 1.5, 3.0, np.nan],
                                    np.float32), N,
                           p=[0.3, 0.3, 0.2, 0.15, 0.05])
        cntv = rng.integers(0, 3, N).astype(np.int32)
        nstart = -rng.integers(-1, 3, N).astype(np.int32)
        crits = (nviol, topv, psumv, cntv, nstart)
        want = int(tpk._lexi_winner_plain(
            torch.from_numpy(feasible),
            tuple(torch.from_numpy(c) for c in crits)))
        jax_w = int(jpk._lexi_winner(jnp.asarray(feasible),
                                     tuple(jnp.asarray(c) for c in crits)))
        assert jax_w == want, trial
        for ctas in (1, 3, 16):
            assert _fold_winner(feasible, crits, rng, ctas) == want, \
                (trial, ctas)
