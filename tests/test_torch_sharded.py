"""The sharded class scan of the port (slice 9) against the JAX package.

On the CPU the port's sharded route runs its plain version
(kernels/batch.py _shard_scan_plain: the D shards modelled as [D, Nl]
slices, the reductions and the election folded across them in rank
order). The JAX side runs the reference's shard_map kernel on a mesh of
D of the 8 virtual CPU devices conftest.py forces. Compared:

- the plain schedule_batch_sharded against JAX's schedule_batch_sharded,
  D in {2, 3, 4, 8}, on every term instance (none, spread, topology with
  and without direction 2, soft credits, the nominated overlay, all
  together): assign and score bits of every pod, pads included, and the
  post-batch usage bit for bit;
- sharding never changes a decision: the plain sharded scan against the
  port's unsharded class scan on the same inputs;
- the election's -0.0 / +0.0 tie (the lower global row wins);
- Scheduler(mesh=D, device="cpu") against the JAX Scheduler(mesh=Mesh(D))
  on tests/test_sharded.py's fixtures, KTPU_COMMIT_THREAD=0 on both: the
  binds, and the port's sharded_batches counter;
- the D = 3 grow, the KTPU_SHARD_MAP=0 control, the resolve_mesh forms,
  and a sharded JAX mirror's state carried across by convert.py.

Inputs are made with numpy from seeds and handed to both packages.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from kubernetes_tpu import api as japi
from kubernetes_tpu.scheduler import Scheduler as JScheduler
from kubernetes_tpu.scheduler.kernels import batch as jb
from kubernetes_tpu.state import Client as JClient
from kubernetes_tpu_torch import api as tapi
from kubernetes_tpu_torch.convert import nom_from_numpy, tables_from_numpy
from kubernetes_tpu_torch.scheduler import Scheduler as TScheduler
from kubernetes_tpu_torch.scheduler import sharding
from kubernetes_tpu_torch.scheduler.kernels import batch as tb
from kubernetes_tpu_torch.state import Client as TClient
from kubernetes_tpu_torch.workload import InformerPump

GiB = float(2 ** 30)
#: nodes (divisible by 2, 3, 4 and 8) and pods of the kernel fixtures
N, P, R, C = 48, 64, 4, 4
ZONES = 4


def _jmesh(D):
    if len(jax.devices()) < D:
        pytest.skip(f"needs {D} virtual devices")
    return Mesh(np.array(jax.devices()[:D]), ("nodes",))


def _bits(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_equal(ref, got):
    for r, g in zip(ref[:2], got[:2]):
        np.testing.assert_array_equal(_bits(r), _bits(g))
    assert set(ref[2]) == set(got[2])
    for k in ref[2]:
        np.testing.assert_array_equal(_bits(ref[2][k]), _bits(got[2][k]))


# ------------------------------------------------------------ fixtures


def _lists(rng, n_terms, K, frac):
    out = rng.integers(0, n_terms, (P, K)).astype(np.int32)
    out[rng.random((P, K)) >= frac] = -1
    return out


def _dom(rng, n_terms, T):
    """Even terms on hostname (domain = row), odd ones on zone; a tenth of
    the nodes lack the label, pad term rows are -1."""
    dom = np.full((T, N), -1, np.int32)
    for t in range(n_terms):
        dom[t] = np.arange(N) if t % 2 == 0 else np.arange(N) % ZONES
        dom[t, rng.random(N) < 0.1] = -1
    return dom


def _instance(name, seed=0):
    """(node_cfg, usage, pod batch, nom) of one term instance: 48 nodes in
    4 zones, the last 4 rows pads (valid False), usage near capacity on
    some, four classes, the last 2 pods inactive; the term tables as
    core.py installs them (tests/test_torch_affinity.py's shapes)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    valid = np.arange(N) < N - 4
    alloc = np.zeros((N, R), f32)
    alloc[:, 0] = 4000
    alloc[:, 1] = 32 * GiB
    alloc[:, 2] = 100 * GiB
    used = np.zeros((N, R), f32)
    used[:, 0] = rng.choice([0, 1000, 2500, 3700], N)
    used[:, 1] = rng.choice([0, 4, 16], N) * GiB
    node_cfg = {"alloc": alloc * valid[:, None],
                "max_pods": np.where(valid, 110, 0).astype(f32),
                "node_ok": (rng.random(N) > 0.05) & valid,
                "mem_pressure": np.zeros(N, bool), "valid": valid}
    usage = {"used": used * valid[:, None],
             "nonzero_used": used[:, :2] * valid[:, None],
             "pod_count": rng.integers(0, 20, N).astype(f32)}
    req = np.zeros((C, R), f32)
    req[:, 0] = [100, 250, 500, 1000]
    req[:, 1] = np.array([128, 512, 1024, 2048]) * 2 ** 20
    um = np.ones((2, N), bool)
    um[1] = rng.random(N) < 0.5
    pb = {"class_req": req, "class_nz": req[:, :2].copy(),
          "class_blocked": np.zeros(C, bool),
          "class_mask_idx": np.array([0, 0, 1, 0], np.int32),
          "class_score_idx": np.array([0, 1, 0, 1], np.int32),
          "unique_masks": um,
          "unique_scores": np.stack([np.zeros(N, f32),
                                     rng.integers(0, 3, N).astype(f32)]),
          "resource_weights": np.ones(2, f32),
          "class_idx": rng.integers(0, C, P).astype(np.int32),
          "seq": (seed * 977 + np.arange(P)).astype(np.int32),
          "active": np.arange(P) < P - 2}
    kw = INSTANCES[name]
    if kw.get("spread"):
        G = 2
        gidx = rng.integers(-1, G, P).astype(np.int32)
        match = np.zeros((P, G), f32)
        match[np.arange(P)[gidx >= 0], gidx[gidx >= 0]] = 1.0
        pb.update({"spread_gidx": gidx, "spread_match": match,
                   "spread_base": rng.integers(0, 4, (G, N)).astype(f32),
                   "spread_zone": (np.arange(N) % ZONES + 1).astype(
                       np.int32),
                   "spread_zinit": np.zeros((8,), f32),
                   "spread_weight": np.float32(1.0)})
    if kw.get("topo"):
        T, D, K, n_terms = 8, 64, 2, 5
        color = rng.integers(0, n_terms, P).astype(np.int32)
        anti = _lists(rng, n_terms, K, 0.0)
        anti[:, 0] = np.where(rng.random(P) < 0.8, color, -1)
        match = _lists(rng, n_terms, K, 0.3)
        match[:, 0] = color
        pb.update({"anti_dom": _dom(rng, n_terms, T),
                   "anti_cnt0": np.zeros((T, D), f32),
                   "anti_tids": anti,
                   "aff_tids": _lists(rng, n_terms, K, 0.25),
                   "match_tids": match})
        if kw.get("dir2"):
            pb["cmatch_tids"] = _lists(rng, n_terms, K, 0.3)
            pb["canti_tids"] = _lists(rng, n_terms, K, 0.3)
    if kw.get("soft"):
        Ts, Ds, Ks, n_ch = 8, 64, 2, 4
        base_idx = rng.integers(0, 3, P).astype(np.int32)
        base_idx[::5] = -1
        pb.update({
            "soft_dom": _dom(rng, n_ch, Ts),
            "soft_cnt0": np.zeros((Ts, Ds), f32),
            "soft_base": np.concatenate([
                rng.integers(-20, 21, (3, N)), np.zeros((1, N))]).astype(f32),
            "soft_base_idx": base_idx,
            "soft_read_tids": _lists(rng, n_ch, Ks, 0.7),
            "soft_read_w": rng.choice([10.0, -10.0, 1.0, -1.0, 2.0],
                                      (P, Ks)).astype(f32),
            "soft_write_tids": _lists(rng, n_ch, Ks, 0.7),
            "soft_write_w": rng.choice([1.0, 10.0], (P, Ks)).astype(f32),
            "soft_weight": np.float32(2.0)})
    nom = None
    if kw.get("nom"):
        # a quarter of the rows reserved, row 5 to its allocatable, and
        # four pods holding their own nomination (the self-exemption rows
        # on three different shards at D = 8)
        nused = np.zeros((N, R), f32)
        count = np.zeros((N,), f32)
        for row in range(0, N - 4, 4):
            nused[row] += req[int(rng.integers(0, C))]
            count[row] += 1.0
        node_cfg["node_ok"][5] = True
        nused[5] = node_cfg["alloc"][5] - usage["used"][5]
        count[5] += 1.0
        nom_row = np.full((P,), -1, np.int32)
        for p, row in {0: 5, 1: 9, 7: 9, 30: 41}.items():
            nom_row[p] = row
            if row != 5:
                nused[row] += req[pb["class_idx"][p]]
                count[row] += 1.0
        pb["nom_row"] = nom_row
        nom = {"used": nused, "count": count}
    return node_cfg, usage, pb, nom


#: the term instances of K15 (and of the reference's sharded scan)
INSTANCES = {"none": {}, "spread": dict(spread=True),
             "topo": dict(topo=True), "topo-dir2": dict(topo=True,
                                                         dir2=True),
             "soft": dict(soft=True), "nominated": dict(nom=True),
             "all": dict(spread=True, topo=True, dir2=True, soft=True,
                         nom=True)}


def _port(node_cfg, usage, pb, nom):
    tc, tu, tpb = tables_from_numpy(node_cfg, usage, pb, "cpu")
    return tc, tu, tpb, nom_from_numpy(nom, "cpu")


@pytest.mark.parametrize("D", [2, 3, 4, 8])
@pytest.mark.parametrize("name", sorted(INSTANCES))
def test_plain_sharded_scan_matches_jax(name, D):
    node_cfg, usage, pb, nom = _instance(name)
    ref = jb.schedule_batch_sharded(_jmesh(D), node_cfg, usage, pb, nom)
    got = tb.schedule_batch_sharded(D, *_port(node_cfg, usage, pb, nom))
    _assert_equal(ref, got)
    assign = np.asarray(ref[0])
    assert (assign >= 0).sum() > P // 2
    if nom is not None:
        # only the nominee takes the fully reserved row
        assert set(np.nonzero(assign == 5)[0]) <= {0}


@pytest.mark.parametrize("D", [2, 3, 8])
@pytest.mark.parametrize("name", sorted(INSTANCES))
def test_sharding_never_changes_a_decision(name, D):
    """The plain sharded scan equals the port's unsharded class scan where
    the capacities coincide (the contract tests/test_sharded.py pins for
    the reference), the plain versions both."""
    args = _port(*_instance(name, seed=D))
    _assert_equal(tb.schedule_batch(*args),
                  tb.schedule_batch_sharded(D, *args))


def test_election_ties_negative_zero():
    """A -0.0 and a +0.0 maximum on two shards tie (float ==, as the
    reference's pmax then pmin compares): the lower global row wins,
    whichever shard holds which sign; a strict maximum wins outright."""
    for lmax in ([-0.0, 0.0], [0.0, -0.0]):
        best = tb.shard_elect(torch.tensor(lmax), torch.tensor([7, 1]), 8)
        assert int(best) == 7
        best = tb.shard_elect(torch.tensor(lmax), torch.tensor([1, 7]), 2)
        assert int(best) == 1
    best = tb.shard_elect(torch.tensor([-0.5, 0.0, -0.0]),
                          torch.tensor([0, 3, 0]), 4)
    assert int(best) == 7
    assert int(tb.shard_elect(torch.tensor([1.0, 2.0]),
                              torch.tensor([0, 3]), 4)) == 7


def test_sharded_scan_refuses_what_it_cannot_shard():
    tc, tu, tpb, _ = _port(*_instance("none"))
    with pytest.raises(ValueError, match="shards"):
        tb.schedule_batch_sharded(5, tc, tu, tpb)        # 48 % 5
    with pytest.raises(ValueError, match="shards"):
        tb.schedule_batch_sharded(16, tc, tu, tpb)       # above 8
    classic = {k: v for k, v in tpb.items()
               if k not in tb._CLASS_KEYS + ("class_idx",)}
    with pytest.raises(ValueError, match="class tables"):
        tb.schedule_batch_sharded(2, tc, tu, classic)


# ------------------------------------------------------------ end to end


def _fixture(api, client, variant, n_nodes=24, n_pods=96):
    """tests/test_sharded.py's _fixture in either package: nodes in 4
    zones, pods of three request shapes, the variant's terms."""
    Q = api.Quantity
    nodes = []
    for i in range(n_nodes):
        alloc = {"cpu": Q("4"), "memory": Q("8Gi"), "pods": Q(110)}
        nodes.append(client.nodes().create(api.Node(
            metadata=api.ObjectMeta(
                name=f"n{i}",
                labels={api.wellknown.LABEL_HOSTNAME: f"n{i}",
                        api.wellknown.LABEL_ZONE: f"z{i % 4}"}),
            status=api.NodeStatus(
                capacity=dict(alloc), allocatable=dict(alloc),
                conditions=[api.NodeCondition(type="Ready",
                                              status="True")]))))
    pods = []
    for i in range(n_pods):
        pod = api.Pod(
            metadata=api.ObjectMeta(name=f"p{i}", namespace="default",
                                    labels={"app": "m", "g": f"g{i % 8}"}),
            spec=api.PodSpec(containers=[api.Container(
                name="c", image="img",
                resources=api.ResourceRequirements(requests={
                    "cpu": Q(["100m", "250m", "500m"][i % 3]),
                    "memory": Q("128Mi")}))]))
        hostname = api.wellknown.LABEL_HOSTNAME
        if variant == "node-affinity":
            pod.spec.affinity = api.Affinity(node_affinity=api.NodeAffinity(
                required_during_scheduling_ignored_during_execution=api
                .NodeSelector(node_selector_terms=[api.NodeSelectorTerm(
                    match_expressions=[api.NodeSelectorRequirement(
                        key=api.wellknown.LABEL_ZONE, operator="In",
                        values=["z0", "z1"])])])))
        elif variant == "anti-affinity":
            pod.spec.affinity = api.Affinity(
                pod_anti_affinity=api.PodAntiAffinity(
                    required_during_scheduling_ignored_during_execution=[
                        api.PodAffinityTerm(
                            label_selector=api.LabelSelector(
                                match_labels={"g": f"g{i % 8}"}),
                            topology_key=hostname)]))
        elif variant == "soft-affinity":
            pod.spec.affinity = api.Affinity(
                pod_anti_affinity=api.PodAntiAffinity(
                    preferred_during_scheduling_ignored_during_execution=[
                        api.WeightedPodAffinityTerm(
                            weight=10,
                            pod_affinity_term=api.PodAffinityTerm(
                                label_selector=api.LabelSelector(
                                    match_labels={"g": f"g{i % 8}"}),
                                topology_key=hostname))]))
        elif variant == "anti-affinity-dir2" and i % 2 == 0:
            pod.spec.affinity = api.Affinity(
                pod_anti_affinity=api.PodAntiAffinity(
                    required_during_scheduling_ignored_during_execution=[
                        api.PodAffinityTerm(
                            label_selector=api.LabelSelector(
                                match_labels={"app": "m"}),
                            topology_key=hostname)]))
        pods.append(client.pods().create(pod))
    return nodes, pods


def _drain(side, mesh, variant, n_nodes=24, n_pods=96, grow=False):
    """One package's Scheduler over the fixture, test_sharded.py's _drain
    (and with `grow`, its mid-drain grow past the first capacity):
    (pods bound, binds, scheduler)."""
    api, Scheduler, Client, dev = side
    client = Client()
    nodes, pods = _fixture(api, client, variant, n_nodes, n_pods)
    sched = Scheduler(client, batch_size=32, mesh=mesh, **dev)
    for n in nodes:
        sched.cache.add_node(n)
    if variant == "nominated":
        ghost = api.Pod(
            metadata=api.ObjectMeta(name="ghost", namespace="default"),
            spec=api.PodSpec(containers=[api.Container(
                name="c", image="img",
                resources=api.ResourceRequirements(requests={
                    "cpu": api.Quantity("3500m"),
                    "memory": api.Quantity("7Gi")}))]))
        sched.queue.nominated.add(ghost, "n0")
        sched.queue.nominated.add(pods[0], "n1")
        sched.queue.nominated.add(pods[1], "n2")
    first = pods[:32] if grow else pods
    for p in first:
        sched.queue.add(p)
    sched.algorithm.refresh()
    n = sched.drain_pipelined()
    if grow:
        Q = api.Quantity
        alloc = {"cpu": Q("4"), "memory": Q("8Gi"), "pods": Q(110)}
        for i in range(n_nodes, 140):
            node = client.nodes().create(api.Node(
                metadata=api.ObjectMeta(
                    name=f"n{i}",
                    labels={api.wellknown.LABEL_HOSTNAME: f"n{i}",
                            api.wellknown.LABEL_ZONE: f"z{i % 4}"}),
                status=api.NodeStatus(
                    capacity=dict(alloc), allocatable=dict(alloc),
                    conditions=[api.NodeCondition(type="Ready",
                                                  status="True")])))
            sched.cache.add_node(node)
        for p in pods[32:]:
            sched.queue.add(p)
        sched.algorithm.refresh()
        n += sched.drain_pipelined()
    binds = {p.metadata.name: p.spec.node_name
             for p in client.pods().list()}
    return n, binds, sched


JAX = (japi, JScheduler, JClient, {})
PORT = (tapi, TScheduler, TClient, {"device": "cpu"})


def _both(monkeypatch, variant, D, **kw):
    monkeypatch.setenv("KTPU_COMMIT_THREAD", "0")
    mesh = _jmesh(D)
    with mesh:
        nj, jbinds, _ = _drain(JAX, mesh, variant, **kw)
    nt, tbinds, sched = _drain(PORT, D, variant, **kw)
    return (nj, jbinds), (nt, tbinds), sched


@pytest.mark.parametrize("variant,D", [
    ("uniform", 8), ("node-affinity", 8), ("anti-affinity", 8),
    ("anti-affinity-dir2", 8), ("soft-affinity", 4), ("soft-affinity", 8),
    ("nominated", 4), ("nominated", 8)])
def test_sharded_scheduler_binds_like_jax(variant, D, monkeypatch):
    (nj, jbinds), (nt, tbinds), sched = _both(monkeypatch, variant, D)
    assert nj == nt > 0
    assert jbinds == tbinds
    assert sched.metrics.sharded_batches.value() > 0
    assert sched.mesh.shape["nodes"] == D
    assert sched.drf.device == sched.mesh.device


def _spread_drain(side, mesh):
    """test_sharded.py's spread wiring (a Service over every pod, objects
    through the scheduler's informers), with the informer events delivered
    on this thread (workload.InformerPump, whose informer calls both
    packages share) so that no bind echo races the drain."""
    api, Scheduler, Client, dev = side
    client = Client()
    client.services().create(api.Service(
        metadata=api.ObjectMeta(name="m", namespace="default"),
        spec=api.ServiceSpec(selector={"app": "m"})))
    sched = Scheduler(client, batch_size=32, mesh=mesh, **dev)
    nodes, pods = _fixture(api, client, "uniform")
    pump = InformerPump(sched.informers)
    try:
        assert sched.queue.num_pending() == len(pods)
        assert len(sched.cache.node_names()) == len(nodes)
        assert sched.algorithm.scorer.listers.selectors_for_pod(pods[0])
        sched.algorithm.refresh()
        n = sched.drain_pipelined()
    finally:
        pump.close()
    binds = {p.metadata.name: p.spec.node_name for p in client.pods().list()}
    return n, binds, sched.metrics.sharded_batches.value()


@pytest.mark.parametrize("D", [4, 8])
def test_sharded_spread_binds_like_jax(D, monkeypatch):
    monkeypatch.setenv("KTPU_COMMIT_THREAD", "0")
    mesh = _jmesh(D)
    with mesh:
        nj, jbinds, _ = _spread_drain(JAX, mesh)
    nt, tbinds, sharded = _spread_drain(PORT, D)
    assert nj == nt > 0
    assert jbinds == tbinds
    assert sharded > 0


def test_grow_pads_shard_divisible_like_jax(monkeypatch):
    """D = 3: the capacity pads shard-divisibly (256 -> 258 after the
    mid-drain grow), the pad is counted in the gauge, and the binds equal
    both the KTPU_SHARD_MAP=0 control (K2 over the padded mirror) and the
    JAX sharded drain."""
    (nj, jbinds), (nt, tbinds), sched = _both(monkeypatch, "uniform", 3,
                                              n_pods=64, grow=True)
    m = sched.algorithm.mirror
    assert m.t.capacity % 3 == 0 and m.t.capacity == 258
    assert m.shard_pad_rows == 2
    assert sched.metrics.mirror_shard_pad_rows.value() == m.shard_pad_rows
    assert sched.metrics.sharded_batches.value() > 0
    monkeypatch.setenv("KTPU_SHARD_MAP", "0")
    nc, cbinds, ctrl = _drain(PORT, 3, "uniform", n_pods=64, grow=True)
    assert ctrl.metrics.sharded_batches.value() == 0
    assert nj == nt == nc == 64
    assert jbinds == tbinds == cbinds


def test_shard_map_off_keeps_the_unsharded_scan(monkeypatch):
    monkeypatch.setenv("KTPU_COMMIT_THREAD", "0")
    monkeypatch.delenv("KTPU_SHARD_MAP", raising=False)
    n1, sharded, s1 = _drain(PORT, 8, "uniform")
    assert s1.metrics.sharded_batches.value() > 0
    monkeypatch.setenv("KTPU_SHARD_MAP", "0")
    n2, ctrl, s2 = _drain(PORT, 8, "uniform")
    assert s2.metrics.sharded_batches.value() == 0
    assert n1 == n2 > 0 and sharded == ctrl


def test_resolve_mesh_forms(monkeypatch):
    monkeypatch.delenv("KTPU_MESH", raising=False)
    assert sharding.resolve_mesh(None, "cpu") is None
    monkeypatch.setenv("KTPU_MESH", "0")
    assert sharding.resolve_mesh(None, "cpu") is None
    monkeypatch.setenv("KTPU_MESH", "auto")
    assert sharding.resolve_mesh(None, "cpu").shape["nodes"] == 8
    monkeypatch.setenv("KTPU_MESH", "4")
    m = sharding.resolve_mesh(None, "cpu")
    assert m.shape["nodes"] == 4 and m.axis_names == ("nodes",)
    assert m.device.type == "cpu"
    # an explicit single shard is immune to the env; a mesh passes
    assert sharding.resolve_mesh(1, "cpu") is None
    assert sharding.resolve_mesh(m, "cpu") is m
    with pytest.raises(ValueError):
        sharding.resolve_mesh(10_000, "cpu")
    monkeypatch.delenv("KTPU_MESH")
    # a mesh runs on the card unless the caller asks for the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        sharding.resolve_mesh(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        TScheduler(TClient(), mesh=2)


def test_sharding_rules_and_divisibility(monkeypatch):
    """The mirror's pad rule, and the route choice: a mesh takes the
    sharded scan unless KTPU_SHARD_MAP=0; a capacity the shards do not
    divide is a fault (the mirror always pads), never a quiet K2."""
    assert sharding.shard_divisible(8192, 3) == 8193
    assert sharding.shard_divisible(256, 8) == 256
    m = sharding.ShardMesh(8, "cpu")
    assert sharding.n_shards(m) == 8 and sharding.n_shards(None) == 1
    assert sharding.use_shard_map(m, 8192)
    with pytest.raises(ValueError, match="multiple"):
        sharding.use_shard_map(m, 8193)
    assert not sharding.use_shard_map(None, 8193)
    monkeypatch.setenv("KTPU_SHARD_MAP", "0")
    assert not sharding.use_shard_map(m, 8192)
    with pytest.raises(ValueError, match="2 to 8"):
        sharding.ShardMesh(9, "cpu")


def test_sharded_jax_mirror_carries_across(monkeypatch):
    """convert.py: np.asarray of a JAX array with a NamedSharding gathers
    it whole, so a sharded JAX mirror's state carries into the port's
    tensors; after the same drain on both sides the mirrors' usage and
    cfg agree bit for bit."""
    monkeypatch.setenv("KTPU_COMMIT_THREAD", "0")
    mesh = _jmesh(8)
    with mesh:
        _, jbinds, js = _drain(JAX, mesh, "uniform")
        jcfg, jusage = js.algorithm.mirror.device_cfg_usage()
        assert len(jusage["used"].sharding.device_set) == 8
        host = ({k: np.asarray(v) for k, v in jcfg.items()},
                {k: np.asarray(v) for k, v in jusage.items()})
    _, tbinds, ts = _drain(PORT, 8, "uniform")
    assert jbinds == tbinds
    tcfg, tusage = ts.algorithm.mirror.device_cfg_usage()
    ccfg, cusage, _ = tables_from_numpy(*host, None, "cpu")
    for got, want in ((ccfg, tcfg), (cusage, tusage)):
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
