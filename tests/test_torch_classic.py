"""The classic per-pod scan and filter_score in the port, against JAX.

Port slice 5: a batch without class tables (KTPU_CLASS_SCAN=0) takes the
classic per-pod branch of schedule_batch (K7 on the card), and
filter_score gives the [P, N] fits and scores (K8). Here on the CPU, with
no tolerance (every comparison is bit for bit):

- the port's plain classic scan against the JAX `schedule_batch` on a
  batch without class tables: assign rows, chosen-score bits and every
  post-batch usage table, over uniform pods, overlapping spread groups,
  the topology counters (direction 1, direction 2, waived affinity), soft
  credits, nominated reservations (pods holding their own nomination and
  others shielded), all four together, and a state whose fits and score
  floors sit on their boundaries; a chained launch seeded from the
  previous launch's spread and soft finals;
- the port's classic route against its class route on the same fixtures:
  the reference states that the two decide alike;
- filter_score_plain against the JAX `filter_score` (fits and score
  bits), with and without spread groups;
- the padding pods tensorize adds: each route's chosen score there is
  its JAX route's (the two routes score a pad differently, in the
  reference too, and neither binds one);
- csrc/pod.cuh's claim, through the plain versions: the per-pod score
  (_pod_score_plain) equals the class score (class_resource_score plus
  the static row) at every (pod, row) of a fixture on the
  BalancedAllocation floor boundaries, and the per-pod fits equal the
  class table's;
- BatchScheduler with KTPU_CLASS_SCAN=0 against the JAX one across two
  batches with node add/delete/relabel churn between them, and
  Scheduler.drain_pipelined with KTPU_CLASS_SCAN=0 against JAX.

Everything is small (N <= 256, P <= 64 for the kernels' fixtures) and
changes no process-wide state (monkeypatch only).
"""

import random

import jax
import numpy as np
import pytest
import torch

from kubernetes_tpu import api as japi
from kubernetes_tpu.scheduler.cache import Cache as JCache
from kubernetes_tpu.scheduler.core import BatchScheduler as JBatch
from kubernetes_tpu.scheduler.kernels import batch as jb
from kubernetes_tpu.scheduler.priorities import SpreadListers as JListers
from kubernetes_tpu.scheduler.queue import NominatedPodMap as JNominated
from kubernetes_tpu.scheduler.tensorize import PodBatchTensors as JTensors

from kubernetes_tpu_torch import api as tapi
from kubernetes_tpu_torch import workload
from kubernetes_tpu_torch.convert import nom_from_numpy, tables_from_numpy
from kubernetes_tpu_torch.scheduler.cache import Cache as TCache
from kubernetes_tpu_torch.scheduler.core import BatchScheduler as TBatch
from kubernetes_tpu_torch.scheduler.kernels import batch as tb
from kubernetes_tpu_torch.scheduler.priorities import SpreadListers as TListers
from kubernetes_tpu_torch.scheduler.queue import NominatedPodMap as TNominated
from kubernetes_tpu_torch.scheduler.tensorize import \
    PodBatchTensors as TTensors

from test_torch_affinity import (FULL_ROW, JAX, PORT, _assert_equal, _base,
                                 _case, _drain, _nom)
from test_torch_kernels import _batch

GiB = float(2 ** 30)
MiB = float(2 ** 20)
CLASS_TABLES = ("class_req", "class_nz", "class_blocked", "class_mask_idx",
                "class_score_idx", "class_idx")


def _classic(pb):
    """The same batch without class tables: each pod's rows taken from
    its class, as tensorize builds them (PodBatchTensors without
    enable_class_scan)."""
    ci = pb["class_idx"]
    out = {k: v for k, v in pb.items() if k not in CLASS_TABLES}
    out.update(req=pb["class_req"][ci], nonzero_req=pb["class_nz"][ci],
               mem_pressure_blocked=pb["class_blocked"][ci],
               mask_idx=pb["class_mask_idx"][ci],
               score_idx=pb["class_score_idx"][ci])
    return out


def _overlapping_spread(pb, rng):
    """Three spread groups; a third of the grouped pods also match the
    next group, so a winner bumps more than its own group's counts."""
    P, N = pb["class_idx"].shape[0], pb["unique_masks"].shape[1]
    G = 4
    gidx = rng.integers(-1, 3, P).astype(np.int32)
    match = np.zeros((P, G), np.float32)
    for i, g in enumerate(gidx):
        if g >= 0:
            match[i, g] = 1.0
            if rng.random() < 0.35:
                match[i, (g + 1) % 3] = 1.0
    pb.update({"spread_gidx": gidx, "spread_match": match,
               "spread_base": rng.integers(0, 4, (G, N)).astype(np.float32),
               "spread_zone": (np.arange(N) % 5).astype(np.int32),
               "spread_zinit": np.zeros((8,), np.float32),
               "spread_weight": np.float32(1.0)})


def _fixture(name):
    """(node_cfg, usage, class-route batch, nom or None) of each case."""
    nom = None
    if name == "uniform":
        node_cfg, usage, pb = _base(0)
    elif name == "spread":
        node_cfg, usage, pb = _base(1)
        _overlapping_spread(pb, np.random.default_rng(11))
    elif name == "boundary":
        # tests/test_torch_kernels.py's state: R = 8, usage at 0-100% of
        # capacity in 50m / 1Mi steps, memory pressure, blocked classes
        node_cfg, usage, pb = _batch(1, True, P=64)
    elif name == "nominated":
        node_cfg, usage, pb = _base(0)
        nom = _nom(node_cfg, usage, pb, 0)
    elif name == "all-four":
        node_cfg, usage, pb = _case("topo-soft-spread")
        nom = _nom(node_cfg, usage, pb, 0)
    else:
        node_cfg, usage, pb = _case(name)
    return node_cfg, usage, pb, nom


CASES = ["uniform", "spread", "boundary", "anti", "anti-dir2",
         "waived-affinity", "soft", "nominated", "all-four"]


def _port(node_cfg, usage, pb, nom, t_usage=None):
    tc, tu, tpb = tables_from_numpy(node_cfg, usage, pb, "cpu")
    return tb.schedule_batch(tc, tu if t_usage is None else t_usage, tpb,
                             nom_from_numpy(nom, "cpu"))


@pytest.mark.parametrize("name", CASES)
def test_classic_plain_matches_jax(name, monkeypatch):
    node_cfg, usage, pb, nom = _fixture(name)
    cpb = _classic(pb)
    calls = []
    orig = tb._pod_scan_plain
    monkeypatch.setattr(tb, "_pod_scan_plain",
                        lambda *a: calls.append(1) or orig(*a))
    ref = jb.schedule_batch(node_cfg, usage, cpb, nom)
    got = _port(node_cfg, usage, cpb, nom)
    assert calls == [1]
    _assert_equal(ref, got)
    assign = np.asarray(ref[0])
    assert (assign >= 0).sum() > len(assign) // 2
    assert (assign == -1).any()          # the inactive pods, at least
    if nom is not None:
        # only the nominee takes the fully reserved row
        assert set(np.nonzero(assign == FULL_ROW)[0]) <= {0}


@pytest.mark.parametrize("name", CASES)
def test_classic_and_class_routes_decide_alike(name):
    """The port's two routes on one batch: assign, score bits and usage
    equal (the reference's claim, tests/test_class_fastpath.py)."""
    node_cfg, usage, pb, nom = _fixture(name)
    _assert_equal(_port(node_cfg, usage, pb, nom),
                  _port(node_cfg, usage, _classic(pb), nom))


def test_chained_classic_launch_seeds_spread_and_soft():
    """A second classic launch takes the first one's usage, spread and
    soft finals included, as a chained drain does; the port chained on
    its own finals gives the same bits."""
    node_cfg, usage, pb = _case("topo-soft-spread", seed=2)
    cpb = _classic(pb)
    ref1 = jb.schedule_batch(node_cfg, usage, cpb)
    got1 = _port(node_cfg, usage, cpb, None)
    _assert_equal(ref1, got1)
    assert np.asarray(ref1[2]["soft_cnt"]).any()
    usage2 = {k: np.asarray(v) for k, v in ref1[2].items()}
    rng = np.random.default_rng(9)
    pb2 = dict(pb, class_idx=rng.integers(0, 4, pb["seq"].shape[0]).astype(
        np.int32), seq=(pb["seq"] + pb["seq"].shape[0]).astype(np.int32))
    cpb2 = _classic(pb2)
    ref2 = jb.schedule_batch(node_cfg, usage2, cpb2)
    _assert_equal(ref2, _port(node_cfg, usage2, cpb2, None))
    _assert_equal(ref2, _port(node_cfg, usage, cpb2, None, t_usage=got1[2]))


@pytest.mark.parametrize("name", ["uniform", "spread", "boundary"])
def test_filter_score_plain_matches_jax(name):
    node_cfg, usage, pb, _ = _fixture(name)
    cpb = _classic(pb)
    ref = jb.filter_score(node_cfg, usage, cpb)
    tc, tu, tpb = tables_from_numpy(node_cfg, usage, cpb, "cpu")
    fits, score = tb.filter_score(tc, tu, tpb)
    np.testing.assert_array_equal(np.asarray(ref[0]), fits.numpy())
    np.testing.assert_array_equal(np.asarray(ref[1]).view(np.int32),
                                  score.numpy().view(np.int32))
    assert fits.any() and not fits.all()
    if name != "uniform":
        # the spread term moved some scores against the same batch without
        # spread tables
        plain = {k: v for k, v in tpb.items() if not k.startswith("spread_")}
        assert not torch.equal(tb.filter_score(tc, tu, plain)[1], score)


def _boundary_state():
    """Nodes whose non-zero usage plus a pod's request lands on exact
    fractions of capacity (cpuFrac .7875 against memFrac .1875, where the
    4e-6 nudge decides BalancedAllocation's floor), some full, some
    past capacity, with a static score row."""
    N, P, R = 256, 32, 4
    f32 = np.float32
    i = np.arange(N)
    cap_cpu = np.array([1000.0, 2000.0, 4000.0, 8000.0])[i % 4]
    cap_mem = np.array([4 * GiB, 16 * GiB])[(i // 4) % 2]
    alloc = np.zeros((N, R), f32)
    alloc[:, 0], alloc[:, 1], alloc[:, 2] = cap_cpu, cap_mem, 100 * GiB
    alloc[-3:] = 0.0                       # capacity 0 takes the guards
    nz = np.stack([cap_cpu * ((i * 7) % 81) / 80.0,
                   cap_mem * np.array([0.0, 0.1875, 0.25, 0.5, 0.7875,
                                       1.0])[(i // 8) % 6]], 1).astype(f32)
    used = np.zeros((N, R), f32)
    used[:, :2] = nz
    node_cfg = {"alloc": alloc, "max_pods": np.full(N, 110, f32),
                "node_ok": np.ones(N, bool), "mem_pressure": i % 9 == 0,
                "valid": np.ones(N, bool)}
    usage = {"used": used, "nonzero_used": nz,
             "pod_count": (i % 112).astype(f32)}
    p = np.arange(P)
    req = np.zeros((P, R), f32)
    req[:, 0] = np.array([0.0, 12.5, 25.0, 50.0, 100.0, 200.0, 400.0,
                          1000.0])[p % 8]
    req[:, 1] = np.array([0.0, 16 * MiB, 64 * MiB, 256 * MiB])[(p // 8) % 4]
    rng = np.random.default_rng(5)
    return node_cfg, usage, {
        "req": req, "nonzero_req": req[:, :2].copy(),
        "mem_pressure_blocked": p % 3 == 0,
        "mask_idx": (p % 2).astype(np.int32),
        "score_idx": (p % 2).astype(np.int32),
        "unique_masks": rng.random((2, N)) < 0.9,
        "unique_scores": np.stack([np.zeros(N, f32),
                                   rng.integers(0, 7, N).astype(f32)]),
        "resource_weights": np.array([1.0, 2.0], f32)}


def test_pod_score_equals_the_class_score():
    """csrc/pod.cuh's claim that the per-pod step is the class route's
    arithmetic (ktpu_pod_base calls ktpu_resource_score): the plain
    per-pod score and fits equal the class score and the class table's
    fits at every (pod, row) — the pods as classes of one — and the JAX
    _pod_score / _pod_feasible give the same bits."""
    node_cfg, usage, pods = _boundary_state()
    tc, tu, tp = tables_from_numpy(node_cfg, usage, pods, "cpu")
    alloc = tc["alloc"]
    us, rw = tp["unique_scores"], tp["resource_weights"]
    score_idx, mask_idx = tp["score_idx"].long(), tp["mask_idx"].long()
    per_pod = tb._pod_score_plain(tc, tu["nonzero_used"], tp["nonzero_req"],
                                  us[score_idx], rw)
    cls_score = tb.class_resource_score(
        alloc[:, 0][None, :], alloc[:, 1][None, :],
        tu["nonzero_used"][:, 0][None, :] + tp["nonzero_req"][:, 0][:, None],
        tu["nonzero_used"][:, 1][None, :] + tp["nonzero_req"][:, 1][:, None],
        rw) + us[score_idx]
    assert torch.equal(per_pod.view(torch.int32), cls_score.view(torch.int32))
    fits = tb._pod_feasible_plain(tc, tu["used"], tu["pod_count"], tp["req"],
                                  tp["mem_pressure_blocked"],
                                  tp["unique_masks"][mask_idx])
    cls = {"class_req": tp["req"], "class_nz": tp["nonzero_req"],
           "class_blocked": tp["mem_pressure_blocked"],
           "class_mask_idx": tp["mask_idx"],
           "class_score_idx": tp["score_idx"]}
    ms = tb.class_ms_init_plain(tc, tu, cls, tp["unique_masks"], us, rw)
    assert torch.equal(fits, ms > tb.NEG_THRESHOLD)
    assert fits.any() and not fits.all()
    # the JAX per-pod functions, pod by pod
    j_score = jax.jit(jb._pod_score)
    j_fits = jax.jit(jb._pod_feasible)
    for p in range(pods["req"].shape[0]):
        pod = {k: pods[k][p] for k in ("req", "nonzero_req",
                                       "mem_pressure_blocked")}
        ref = j_score(node_cfg, usage["nonzero_used"], pod,
                      pods["unique_scores"][pods["score_idx"][p]],
                      pods["resource_weights"])
        np.testing.assert_array_equal(np.asarray(ref).view(np.int32),
                                      per_pod[p].numpy().view(np.int32))
        ref = j_fits(node_cfg, usage["used"], usage["pod_count"], pod,
                     pods["unique_masks"][pods["mask_idx"][p]])
        np.testing.assert_array_equal(np.asarray(ref), fits[p].numpy())
    # the fixture reaches the floor boundary: somewhere the nudge decides
    frac = (tu["nonzero_used"][:, None, :] + tp["nonzero_req"][None, :, :]) \
        / torch.clamp_min(alloc[:, None, :2], 1.0)
    assert ((frac[..., 0] == 0.7875) & (frac[..., 1] == 0.1875)).any()


def _padded_batch(api, cache_cls, sched_cls, listers_cls, tensors_cls, kw):
    """Five uniform pods tensorized as each package's BatchScheduler does
    it, padded to the bucket of 8 with inactive rows: (mirror tables,
    classic batch, class batch) as each package's device() gives them."""
    sched, _ = workload.build(api, cache_cls, sched_cls, listers_cls, 16,
                              "uniform", **kw)
    sched.refresh()
    pods = [workload.make_pod(api, i) for i in range(5)]
    batch = tensors_cls(pods, sched.mirror, sched.terms)
    dev = ("cpu",) if kw else ()
    classic = batch.device(*dev)
    batch.enable_class_scan()
    return sched.mirror.device_cfg_usage(), classic, batch.device(*dev)


def test_padding_pods_score_by_route_as_in_jax():
    """tensorize pads a batch with inactive pods. The class route scores
    a pad as class 0 (its class_idx is 0), the classic route as a pod of
    zero request (its rows are zeros), so the two routes' chosen scores
    differ on pads, in the reference too; no pad binds. Each port route
    gives its JAX route's bits on every row, pads included, and the two
    routes agree on every active pod."""
    (jcfg, jusage), jclassic, jclass = _padded_batch(
        japi, JCache, JBatch, JListers, JTensors, {})
    (tcfg, tusage), tclassic, tclass = _padded_batch(
        tapi, TCache, TBatch, TListers, TTensors, {"device": "cpu"})
    out = {}
    for route, jpb, tpb in (("classic", jclassic, tclassic),
                            ("class", jclass, tclass)):
        ref = jb.schedule_batch(jcfg, jusage, jpb)
        got = tb.schedule_batch(tcfg, tusage, tpb)
        _assert_equal(ref, got)
        out[route] = (got[0].numpy(), got[1].numpy().view(np.int32))
    active = tclassic["active"].numpy()
    assert active.sum() == 5 and not active.all()
    np.testing.assert_array_equal(out["classic"][0], out["class"][0])
    assert (out["classic"][0][~active] == -1).all()
    np.testing.assert_array_equal(out["classic"][1][active],
                                  out["class"][1][active])
    assert (out["classic"][1][~active] != out["class"][1][~active]).all()


# ------------------------------------------------------------ end to end


WEIGHTS = {"LeastRequestedPriority": 1, "BalancedResourceAllocation": 1,
           "SelectorSpreadPriority": 1, "InterPodAffinityPriority": 1}


def _mk_node(api, i, zone):
    labels = {api.wellknown.LABEL_HOSTNAME: f"n{i}",
              api.wellknown.LABEL_ZONE: zone}
    alloc = {"cpu": api.Quantity("8"), "memory": api.Quantity("16Gi"),
             "pods": api.Quantity(110)}
    return api.Node(
        metadata=api.ObjectMeta(name=f"n{i}", labels=labels),
        status=api.NodeStatus(capacity=dict(alloc), allocatable=dict(alloc),
                              conditions=[api.NodeCondition(
                                  type="Ready", status="True")]))


def _mk_pod(api, i, labels, cpu="100m", mem="64Mi"):
    return api.Pod(
        metadata=api.ObjectMeta(name=f"p{i}", namespace="default",
                                labels=dict(labels)),
        spec=api.PodSpec(containers=[api.Container(
            name="c", image="img", resources=api.ResourceRequirements(
                requests={"cpu": api.Quantity(cpu),
                          "memory": api.Quantity(mem)}))]))


def _term(api, key, value):
    return api.PodAffinityTerm(
        label_selector=api.LabelSelector(match_labels={key: value}),
        topology_key=api.wellknown.LABEL_HOSTNAME)


def _mixed_pod(api, rng, i):
    """tests/test_class_fastpath.py's mixed batch: spread carriers, soft
    anti-affinity, required anti-affinity and plain pods."""
    kind = rng.randrange(4)
    if kind == 0:
        return _mk_pod(api, i, {"app": "web"})
    if kind == 1:
        g = f"g{rng.randrange(3)}"
        pod = _mk_pod(api, i, {"grp": g})
        pod.spec.affinity = api.Affinity(pod_anti_affinity=api.PodAntiAffinity(
            preferred_during_scheduling_ignored_during_execution=[
                api.WeightedPodAffinityTerm(
                    weight=10, pod_affinity_term=_term(api, "grp", g))]))
        return pod
    if kind == 2:
        c = f"c{rng.randrange(6)}"
        pod = _mk_pod(api, i, {"color": c})
        pod.spec.affinity = api.Affinity(pod_anti_affinity=api.PodAntiAffinity(
            required_during_scheduling_ignored_during_execution=[
                _term(api, "color", c)]))
        return pod
    return _mk_pod(api, i, {"plain": "x"})


def _churn_run(api, cache_cls, sched_cls, listers_cls, nom_cls, kw):
    """tests/test_class_fastpath.py TestRandomizedChurnParity._run in one
    package: 24 nodes in 3 zones, a ghost nominated to n1, two mixed
    batches of 60 pods (two of each holding their own nomination) with
    two nodes added, one deleted and one relabeled between them."""
    svc = api.Service(metadata=api.ObjectMeta(name="web",
                                              namespace="default"),
                      spec=api.ServiceSpec(selector={"app": "web"}))
    rng = random.Random(77)
    cache = cache_cls()
    for i in range(24):
        cache.add_node(_mk_node(api, i, f"z{i % 3}"))
    nominated = nom_cls()
    ghost = _mk_pod(api, 900, {}, cpu="6", mem="12Gi")
    ghost.status.nominated_node_name = "n1"
    nominated.add(ghost)
    sched = sched_cls(cache, listers=listers_cls(services=lambda ns: [svc]),
                      weights=dict(WEIGHTS), nominated=nominated, **kw)
    decisions = []
    nxt = [0]

    def one_batch(n):
        pods = [_mixed_pod(api, rng, nxt[0] + j) for j in range(n)]
        nxt[0] += n
        for p in pods[:2]:
            p.status.nominated_node_name = f"n{2 + nxt[0] % 5}"
            nominated.add(p)
        for res in sched.schedule(pods):
            decisions.append((res.pod.metadata.name, res.node_name,
                              np.float32(res.score).view(np.int32)
                              if res.node_name else None))
            if res.node_name is not None:
                nominated.delete(res.pod)
                bound = api.serde.deepcopy_obj(res.pod)
                bound.spec.node_name = res.node_name
                cache.add_pod(bound)

    one_batch(60)
    for i in (50, 51):
        cache.add_node(_mk_node(api, i, f"z{i % 3}"))
    cache.remove_node(sched.snapshot.node_infos["n7"].node)
    old = sched.snapshot.node_infos["n11"].node
    relabeled = api.serde.deepcopy_obj(old)
    relabeled.metadata.labels[api.wellknown.LABEL_ZONE] = "z9"
    cache.update_node(old, relabeled)
    one_batch(60)
    return decisions


def test_batch_scheduler_classic_matches_jax_under_churn(monkeypatch):
    """BatchScheduler with KTPU_CLASS_SCAN=0 in both packages, across two
    batches with node churn between them: the same node and score bits
    for every pod, and the port's class route decides alike."""
    calls = []
    orig = tb._pod_scan_plain
    monkeypatch.setattr(tb, "_pod_scan_plain",
                        lambda *a: calls.append(1) or orig(*a))
    monkeypatch.setenv("KTPU_CLASS_SCAN", "0")
    jax_side = _churn_run(japi, JCache, JBatch, JListers, JNominated, {})
    port = _churn_run(tapi, TCache, TBatch, TListers, TNominated,
                      {"device": "cpu"})
    assert len(port) == 120 and calls
    assert port == jax_side
    assert sum(n is not None for _, n, _ in port) > 100
    monkeypatch.setenv("KTPU_CLASS_SCAN", "1")
    n_classic = len(calls)
    by_class = _churn_run(tapi, TCache, TBatch, TListers, TNominated,
                          {"device": "cpu"})
    assert len(calls) == n_classic
    assert [d[:2] for d in by_class] == [d[:2] for d in port]


@pytest.mark.parametrize("variant", ["uniform", "pod-anti-affinity",
                                     "preferred-affinity"])
def test_scheduler_drain_classic_matches_jax(variant, monkeypatch):
    """Scheduler.drain_pipelined with KTPU_CLASS_SCAN=0 in both packages
    (64 nodes, 512 pods, KTPU_COMMIT_THREAD=0): the same node for every
    pod, every batch on the classic route."""
    monkeypatch.setenv("KTPU_COMMIT_THREAD", "0")
    monkeypatch.setenv("KTPU_CLASS_SCAN", "0")
    calls = []
    orig = tb._pod_scan_plain
    monkeypatch.setattr(tb, "_pod_scan_plain", lambda *a: calls.append(
        tb._scan_terms(a[1])) or orig(*a))
    monkeypatch.setattr(tb, "_class_scan_plain", None)
    jbinds = _drain(JAX, variant)
    tbinds = _drain(PORT, variant)
    assert tbinds == jbinds
    assert calls
    if variant == "pod-anti-affinity":
        assert any(t[1] for t in calls)       # topology counters rode K7
        assert len([n for n in tbinds.values() if n]) == 512
    if variant == "preferred-affinity":
        assert any(t[3] for t in calls)       # soft credits rode K7


def _ragged_filter_batch(seed, P, N, Z, R=4, G=3):
    """A per-pod batch at counts no tile divides: pods with different
    mask, score and spread rows side by side, every fifth pod in no
    spread group (-1), zone ids up to Z + 1 (past the zone columns)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    alloc = np.zeros((N, R), f32)
    alloc[:, 0] = rng.choice([1000, 2000, 4000], N)
    alloc[:, 1] = rng.choice([4, 16], N) * GiB
    alloc[:, 2:] = rng.integers(0, 3, (N, R - 2))
    frac = rng.choice([0.0, 0.5, 0.9], N)
    used = np.zeros((N, R), f32)
    used[:, 0] = np.floor(alloc[:, 0] * frac / 50) * 50
    used[:, 1] = np.floor(alloc[:, 1] * frac / MiB) * MiB
    node_cfg = {"alloc": alloc, "max_pods": np.full(N, 110, f32),
                "node_ok": rng.random(N) > 0.05,
                "mem_pressure": rng.random(N) < 0.1,
                "valid": np.ones(N, bool)}
    usage = {"used": used, "nonzero_used": used[:, :2].copy(),
             "pod_count": rng.integers(0, 111, N).astype(f32)}
    req = np.zeros((P, R), f32)
    req[:, 0] = rng.choice([100, 500, 1500], P)
    req[:, 1] = rng.choice([128, 1024, 8192], P) * MiB
    req[:, 2:] = rng.integers(0, 2, (P, R - 2))
    gidx = rng.integers(0, G, P).astype(np.int32)
    gidx[::5] = -1
    pb = {"req": req, "nonzero_req": req[:, :2].copy(),
          "mem_pressure_blocked": rng.random(P) < 0.3,
          "mask_idx": rng.integers(0, 3, P).astype(np.int32),
          "score_idx": rng.integers(0, 3, P).astype(np.int32),
          "unique_masks": rng.random((3, N)) < 0.85,
          "unique_scores": rng.integers(0, 7, (3, N)).astype(f32),
          "resource_weights": np.ones(2, f32),
          "seq": np.arange(P, dtype=np.int32),
          "spread_gidx": gidx,
          "spread_base": rng.integers(0, 5, (G, N)).astype(f32),
          "spread_zone": rng.integers(0, Z + 2, N).astype(np.int32),
          "spread_zinit": rng.integers(0, 3, Z).astype(f32),
          "spread_weight": np.float32(1.0)}
    return node_cfg, usage, pb


@pytest.mark.parametrize("P,N,Z", [(300, 513, 8), (65, 257, 1),
                                   (31, 130, 300)])
@pytest.mark.parametrize("spread", [False, True])
def test_filter_score_plain_matches_jax_ragged(P, N, Z, spread):
    """filter_score_plain against the JAX filter_score at the ragged
    shapes K8's tiles are held at on the card (fits and score bits)."""
    node_cfg, usage, pb = _ragged_filter_batch(P + N + Z, P, N, Z)
    if not spread:
        pb = {k: v for k, v in pb.items() if not k.startswith("spread_")}
    ref = jb.filter_score(node_cfg, usage, pb)
    tc, tu, tpb = tables_from_numpy(node_cfg, usage, pb, "cpu")
    fits, score = tb.filter_score(tc, tu, tpb)
    np.testing.assert_array_equal(np.asarray(ref[0]), fits.numpy())
    np.testing.assert_array_equal(np.asarray(ref[1]).view(np.int32),
                                  score.numpy().view(np.int32))
    assert fits.any() and not fits.all()
