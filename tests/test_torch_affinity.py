"""The class scan's inter-pod affinity carries in the port, against JAX.

Port slice 3: the required (anti-)affinity counters (_topo_bad /
_topo_scatter) and the preferred credits (_soft_raw / _soft_score /
_soft_write) ride the class scan. Here on the CPU:

- the port's plain scan against the JAX `schedule_batch` on batches made
  from a seed with numpy: assign rows, chosen-score bits and post-batch
  usage bits equal, no tolerance; over direction-1 anti-affinity, the
  direction-2 carry table, waived required affinity, signed soft credits
  with a pod that fits nowhere, all three carries with spread in one
  batch, and a chained launch seeded from the previous launch's soft
  credits;
- the port's Scheduler against the JAX Scheduler on bench.py's
  pod-anti-affinity, pod-affinity and preferred-affinity pods (64 nodes,
  512 pods, KTPU_COMMIT_THREAD=0): the same node for every pod;
- the in-scan fallback counters against the reference's when a batch
  overflows the term cap, the per-pod fan-out or the soft channel cap;
- port slice 4's nominated-reservation overlay: the plain scan with
  phantom reservations (a fully reserved node, pods holding their own
  nomination) against the JAX `schedule_batch(..., nom)`, with and
  without each carry, and the reference's nominated BatchScheduler tests
  against the JAX class route;
- the routes of port slice 5 (the classic per-pod branch and
  filter_score) against the JAX ones on the same inter-pod batch.

Everything is small and changes no process-wide state (monkeypatch
only), as these tests share worker processes with the rest of the suite.
"""

import numpy as np
import pytest
import torch

from kubernetes_tpu import api as japi
from kubernetes_tpu.scheduler import Scheduler as JScheduler
from kubernetes_tpu.scheduler.cache import Cache as JCache
from kubernetes_tpu.scheduler.core import BatchScheduler as JBatch
from kubernetes_tpu.scheduler.kernels import batch as jb
from kubernetes_tpu.scheduler.metrics import SchedulerMetrics as JMetrics
from kubernetes_tpu.scheduler.queue import NominatedPodMap as JNominatedPodMap
from kubernetes_tpu.state import Client as JClient

from kubernetes_tpu_torch import api as tapi
from kubernetes_tpu_torch import workload
from kubernetes_tpu_torch.convert import nom_from_numpy, tables_from_numpy
from kubernetes_tpu_torch.scheduler import Scheduler as TScheduler
from kubernetes_tpu_torch.scheduler.cache import Cache as TCache
from kubernetes_tpu_torch.scheduler.core import BatchScheduler as TBatch
from kubernetes_tpu_torch.scheduler.kernels import batch as tb
from kubernetes_tpu_torch.scheduler.metrics import SchedulerMetrics as TMetrics
from kubernetes_tpu_torch.scheduler.queue import NominatedPodMap
from kubernetes_tpu_torch.state import Client as TClient

GiB = float(2 ** 30)
N, P, R, C = 64, 64, 4, 4
ZONES = 4


def _bits(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_equal(ref, got):
    for r, g in zip(ref[:2], got[:2]):
        np.testing.assert_array_equal(_bits(r), _bits(g))
    assert set(ref[2]) == set(got[2])
    for k in ref[2]:
        np.testing.assert_array_equal(_bits(ref[2][k]), _bits(got[2][k]))


def _base(seed):
    """(node_cfg, usage, pod batch): 64 nodes in 4 zones, usage near
    capacity on some, four classes; the last 4 rows are pads and the last
    2 pods inactive."""
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
    return node_cfg, usage, pb


def _dom(rng, n_terms, T):
    """[T, N] term -> domain rows: even terms on hostname (domain = row),
    odd terms on zone (row % 4); a tenth of the nodes lack the label
    (-1), and pad term rows are -1 throughout."""
    dom = np.full((T, N), -1, np.int32)
    for t in range(n_terms):
        dom[t] = np.arange(N) if t % 2 == 0 else np.arange(N) % ZONES
        dom[t, rng.random(N) < 0.1] = -1
    return dom


def _lists(rng, n_terms, K, frac):
    """[P, K] term lists, -1 padded: each slot holds a term with
    probability `frac`."""
    out = rng.integers(0, n_terms, (P, K)).astype(np.int32)
    out[rng.random((P, K)) >= frac] = -1
    return out


def _topo(pb, rng, dir2, waived):
    """Required (anti-)affinity tables as core._assign_topology_terms
    installs them: five real terms, T bucketed to 8, D to 64, K = 2.
    Most pods carry the anti term of their own color and match it (the
    self-anti shape); some match further terms."""
    T, D, K, n_terms = 8, 64, 2, 5
    color = rng.integers(0, n_terms, P).astype(np.int32)
    anti = _lists(rng, n_terms, K, 0.0)
    anti[:, 0] = np.where(rng.random(P) < 0.8, color, -1)
    match = _lists(rng, n_terms, K, 0.3)
    match[:, 0] = color
    aff = _lists(rng, n_terms, K, 0.25 if waived else 0.0)
    pb.update({"anti_dom": _dom(rng, n_terms, T),
               "anti_cnt0": np.zeros((T, D), np.float32),
               "anti_tids": anti, "aff_tids": aff, "match_tids": match})
    if dir2:
        pb["cmatch_tids"] = _lists(rng, n_terms, K, 0.3)
        pb["canti_tids"] = _lists(rng, n_terms, K, 0.3)


def _soft(pb, rng):
    """Preferred credit tables as core._assign_soft_terms installs them:
    four channels (Ts bucketed to 8, Ds 64), three template base rows of
    signed integers, Ks = 2 read and write slots with signed read weights;
    every fifth pod takes no soft term, and pod 5 fits nowhere (class 2's
    mask row cleared below)."""
    Ts, Ds, Ks, n_ch = 8, 64, 2, 4
    base_idx = rng.integers(0, 3, P).astype(np.int32)
    base_idx[::5] = -1
    pb.update({
        "soft_dom": _dom(rng, n_ch, Ts),
        "soft_cnt0": np.zeros((Ts, Ds), np.float32),
        "soft_base": np.concatenate([
            rng.integers(-20, 21, (3, N)), np.zeros((1, N))]).astype(
                np.float32),
        "soft_base_idx": base_idx,
        "soft_read_tids": _lists(rng, n_ch, Ks, 0.7),
        "soft_read_w": rng.choice([10.0, -10.0, 1.0, -1.0, 2.0],
                                  (P, Ks)).astype(np.float32),
        "soft_write_tids": _lists(rng, n_ch, Ks, 0.7),
        "soft_write_w": rng.choice([1.0, 10.0], (P, Ks)).astype(
            np.float32),
        "soft_weight": np.float32(2.0)})
    pb["class_idx"][5] = 2
    pb["class_mask_idx"][2] = 1
    pb["unique_masks"][1] = False


def _spread(pb, rng):
    G = 2
    gidx = rng.integers(-1, G, P).astype(np.int32)
    match = np.zeros((P, G), np.float32)
    match[np.arange(P)[gidx >= 0], gidx[gidx >= 0]] = 1.0
    pb.update({"spread_gidx": gidx, "spread_match": match,
               "spread_base": rng.integers(0, 4, (G, N)).astype(np.float32),
               "spread_zone": (np.arange(N) % ZONES + 1).astype(np.int32),
               "spread_zinit": np.zeros((8,), np.float32),
               "spread_weight": np.float32(1.0)})


CASES = {"anti": dict(topo=True),
         "anti-dir2": dict(topo=True, dir2=True),
         "waived-affinity": dict(topo=True, waived=True),
         "soft": dict(soft=True),
         "topo-soft-spread": dict(topo=True, dir2=True, waived=True,
                                  soft=True, spread=True)}


def _case(name, seed=0):
    kw = CASES[name]
    node_cfg, usage, pb = _base(seed)
    rng = np.random.default_rng(seed + 100)
    if kw.get("topo"):
        _topo(pb, rng, kw.get("dir2", False), kw.get("waived", False))
    if kw.get("soft"):
        _soft(pb, rng)
    if kw.get("spread"):
        _spread(pb, rng)
    return node_cfg, usage, pb


def _both(node_cfg, usage, pb, t_usage=None, nom=None):
    ref = jb.schedule_batch(node_cfg, usage, pb, nom)
    tc, tu, tpb = tables_from_numpy(node_cfg, usage, pb, "cpu")
    got = tb.schedule_batch(tc, tu if t_usage is None else t_usage, tpb,
                            nom_from_numpy(nom, "cpu"))
    return ref, got


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_scan_matches_jax(name):
    node_cfg, usage, pb = _case(name)
    ref, got = _both(node_cfg, usage, pb)
    _assert_equal(ref, got)
    assign = np.asarray(ref[0])
    assert (assign >= 0).sum() > P // 2
    if CASES[name].get("topo"):
        # the counters refused some rows: no two same-color self-anti
        # pods share a hostname among those bound on hostname terms
        dom, anti = pb["anti_dom"], pb["anti_tids"]
        for t in range(0, 5, 2):
            carriers = [i for i in range(P) if assign[i] >= 0
                        and t in anti[i] and t in pb["match_tids"][i]]
            doms = [dom[t, assign[i]] for i in carriers
                    if dom[t, assign[i]] >= 0]
            assert len(doms) == len(set(doms)), (t, doms)
    if CASES[name].get("soft"):
        # pod 5 fits nowhere: no NaN leaks, the score is NEG exactly
        assert assign[5] == -1
        assert np.asarray(ref[1])[5] == np.float32(-1e30)


def test_chained_launch_seeds_soft_credits():
    """A second launch takes the first one's usage, soft credit finals
    included, as a chained drain does; the port chained on its own finals
    gives the same bits."""
    node_cfg, usage, pb = _case("soft", seed=1)
    ref1, got1 = _both(node_cfg, usage, pb)
    _assert_equal(ref1, got1)
    assert np.asarray(ref1[2]["soft_cnt"]).any()
    usage2 = {k: np.asarray(v) for k, v in ref1[2].items()}
    pb2 = dict(pb)
    rng = np.random.default_rng(7)
    pb2["class_idx"] = rng.integers(0, C, P).astype(np.int32)
    pb2["seq"] = (pb["seq"] + P).astype(np.int32)
    ref2, got2 = _both(node_cfg, usage2, pb2)
    _assert_equal(ref2, got2)
    got3 = _both(node_cfg, usage2, pb2, t_usage=got1[2])[1]
    _assert_equal(ref2, got3)


# ------------------------------------------------------------ nominated


#: the row every reservation of _nom leaves no room on, and the pods that
#: hold their own nomination (the self-exemption rows)
FULL_ROW = 5
SELF_PODS = {0: FULL_ROW, 1: 9, 7: 9, 30: 17}


def _nom(node_cfg, usage, pb, seed):
    """Phantom reservations as core._nominated_device builds them: a
    quarter of the nodes carry one or two nominated pods of the batch's
    request shapes, FULL_ROW is reserved to its allocatable (only its
    nominee fits there), and four pods hold their own nomination,
    SELF_PODS (pod -> row): their own request is part of the row's
    reservation, as the reference charges it."""
    rng = np.random.default_rng(seed + 200)
    req = pb["class_req"]
    used = np.zeros((N, R), np.float32)
    count = np.zeros((N,), np.float32)
    for row in range(0, N - 4, 4):
        for _ in range(int(rng.integers(1, 3))):
            used[row] += req[int(rng.integers(0, C))]
            count[row] += 1.0
    pb["class_idx"][0] = 2
    used[FULL_ROW] = node_cfg["alloc"][FULL_ROW] - usage["used"][FULL_ROW]
    count[FULL_ROW] += 1.0
    nom_row = np.full((P,), -1, np.int32)
    for p, row in SELF_PODS.items():
        nom_row[p] = row
        if row != FULL_ROW:
            used[row] += req[pb["class_idx"][p]]
            count[row] += 1.0
    pb["nom_row"] = nom_row
    node_cfg["node_ok"][FULL_ROW] = True
    return {"used": used, "count": count}


NOM_CASES = {"plain": {}, **CASES}


@pytest.mark.parametrize("name", sorted(NOM_CASES))
def test_nominated_scan_matches_jax(name):
    """The nominated overlay in the plain scan, bit for bit against the
    JAX class route: feasibility on used + nom (K1's fold), each
    nominee's own row recomputed with its reservation taken out, the
    winner column refreshed with the reservations added; with no carry
    and with each carry of slice 3."""
    if name == "plain":
        node_cfg, usage, pb = _base(0)
    else:
        node_cfg, usage, pb = _case(name)
    nom = _nom(node_cfg, usage, pb, 0)
    ref, got = _both(node_cfg, usage, pb, nom=nom)
    _assert_equal(ref, got)
    assign = np.asarray(ref[0])
    # only the nominee takes the fully reserved row; the overlay keeps
    # every other pod off it
    assert set(np.nonzero(assign == FULL_ROW)[0]) <= {0}
    # and the overlay changed decisions against the same batch without it
    pb_free = {k: v for k, v in pb.items() if k != "nom_row"}
    free = jb.schedule_batch(node_cfg, usage, pb_free)
    assert not np.array_equal(np.asarray(free[0]), assign)


def test_nominee_takes_its_fully_reserved_row():
    """The self-exemption row alone: pod 0 nominated to FULL_ROW lands
    there in both packages when it is the best row left to it."""
    node_cfg, usage, pb = _base(3)
    nom = _nom(node_cfg, usage, pb, 3)
    um = pb["unique_masks"]
    um[:] = False
    um[:, FULL_ROW] = True
    um[0, 9] = True
    ref, got = _both(node_cfg, usage, pb, nom=nom)
    _assert_equal(ref, got)
    assert int(np.asarray(ref[0])[0]) == FULL_ROW


def _mk_node(api, i, cpu="1", mem="1Gi"):
    alloc = {"cpu": api.Quantity(cpu), "memory": api.Quantity(mem),
             "pods": api.Quantity(110)}
    return api.Node(
        metadata=api.ObjectMeta(
            name=f"n{i}", labels={api.wellknown.LABEL_HOSTNAME: f"n{i}"}),
        status=api.NodeStatus(capacity=dict(alloc), allocatable=dict(alloc),
                              conditions=[api.NodeCondition(type="Ready",
                                                            status="True")]))


def _mk_pod(api, name, cpu, mem="256Mi", priority=None):
    return api.Pod(
        metadata=api.ObjectMeta(name=name, namespace="default"),
        spec=api.PodSpec(priority=priority, containers=[api.Container(
            name="c", image="img", resources=api.ResourceRequirements(
                requests={"cpu": api.Quantity(cpu),
                          "memory": api.Quantity(mem)}))]))


def _nom_sides():
    return ((japi, JCache, JBatch, JNominatedPodMap, {}),
            (tapi, TCache, TBatch, NominatedPodMap, {"device": "cpu"}))


def test_nominated_reservation_shields_space_like_jax():
    """tests/test_scheduler.py test_nominated_reservation_shields_space
    in both packages: a nominated pod's space is invisible to a thief
    but usable by the nominee."""
    out = []
    for api, cache_cls, sched_cls, nom_cls, kw in _nom_sides():
        cache = cache_cls()
        cache.add_node(_mk_node(api, 0))
        nominated = nom_cls()
        nominee = _mk_pod(api, "nominee", "600m", priority=100)
        nominee.status.nominated_node_name = "n0"
        nominated.add(nominee)
        sched = sched_cls(cache, nominated=nominated, **kw)
        (thief,) = sched.schedule([_mk_pod(api, "thief", "600m",
                                           priority=1)])
        (own,) = sched.schedule([nominee])
        out.append((thief.node_name, own.node_name,
                    np.float32(own.score).view(np.int32)))
    assert out[0] == out[1]
    assert out[1][:2] == (None, "n0")


def test_nominated_batch_rides_class_scan_like_jax():
    """tests/test_class_fastpath.py test_nominated_batch_rides_class_scan
    against the JAX class route: a ghost reserves all of n0, one batch
    pod holds its own nomination on n2; the overlay is live, nobody lands
    on n0, and every decision and score equals JAX's."""
    out = []
    for api, cache_cls, sched_cls, nom_cls, kw in _nom_sides():
        nominated = nom_cls()
        cache = cache_cls()
        for i in range(4):
            cache.add_node(_mk_node(api, i))
        ghost = _mk_pod(api, "ghost", "1", "1Gi")
        ghost.status.nominated_node_name = "n0"
        nominated.add(ghost)
        sched = sched_cls(cache, nominated=nominated, **kw)
        pods = [_mk_pod(api, f"p{i}", "600m") for i in range(6)]
        pods[0].status.nominated_node_name = "n2"
        nominated.add(pods[0])
        pending = sched.schedule_launch(pods)
        assert sched._nom_dev is not None
        assert {k: sched.mirror.name_of[r] for k, r in
                sched._nom_rows_by_key.items()} == {"default/ghost": "n0",
                                                    "default/p0": "n2"}
        res = sched.schedule_finish(pending)
        out.append([(r.pod.metadata.name, r.node_name,
                     np.float32(r.score).view(np.int32)) for r in res])
    assert out[0] == out[1]
    assert "n0" not in {n for _, n, _ in out[1]}
    assert dict((p, n) for p, n, _ in out[1])["p0"] == "n2"


# ------------------------------------------------------------ end to end


JAX = (japi, JScheduler, JClient, {})
PORT = (tapi, TScheduler, TClient, {"device": "cpu"})


def _drain(side, variant, n_nodes=64, n_pods=512, batch=128):
    """bench.py run_config's cluster (its seeded variant pods included)
    through each package's own Client and Scheduler, drained with
    drain_pipelined."""
    api, Scheduler, Client, dev = side
    client = Client(validate=False)
    sched = Scheduler(client, batch_size=batch, disable_preemption=True,
                      **dev)
    for i in range(n_nodes):
        node = workload.make_node(api, i)
        client.nodes().create(node)
        sched.cache.add_node(node)
    for pod in workload.seed_pods(api, variant, n_nodes):
        sched.cache.add_pod(pod)
    for i in range(n_pods):
        sched.queue.add(client.pods().create(
            workload.make_pod(api, i, variant)))
    sched.algorithm.refresh()
    sched.drain_pipelined()
    pods, _ = client.pods().list_rv(namespace=None)
    return {p.metadata.name: p.spec.node_name for p in pods}


@pytest.mark.parametrize("variant", workload.AFFINITY_VARIANTS)
def test_scheduler_binds_like_jax(variant, monkeypatch):
    monkeypatch.setenv("KTPU_COMMIT_THREAD", "0")
    calls = []
    orig = tb._class_scan_plain
    monkeypatch.setattr(tb, "_class_scan_plain", lambda *a: calls.append(
        tb._scan_terms(a[1])) or orig(*a))
    jbinds = _drain(JAX, variant)
    tbinds = _drain(PORT, variant)
    assert tbinds == jbinds
    bound = [n for n in tbinds.values() if n]
    if variant == "pod-affinity":
        # the seeded affine pod pins every pod to zone-0's four nodes
        assert bound and all(int(n.split("-")[1]) % 16 == 0 for n in bound)
    else:
        assert len(bound) == len(tbinds) == 512
    if variant == "pod-anti-affinity":
        color = {f"pod-{i}": i % 100 for i in range(512)}
        pairs = {(color[p], n) for p, n in tbinds.items()}
        assert len(pairs) == 512
        assert any(t[1] for t in calls)       # topology counters rode K2
    if variant == "preferred-affinity":
        assert any(t[3] for t in calls)       # soft credits rode K2


# ------------------------------------------------------------ fallbacks


def _anti(api, i, colors):
    pod = workload.make_pod(api, i)
    pod.metadata.labels.update({f"k{c}": "x" for c in colors})
    pod.spec.affinity = api.Affinity(pod_anti_affinity=api.PodAntiAffinity(
        required_during_scheduling_ignored_during_execution=[
            api.PodAffinityTerm(
                label_selector=api.LabelSelector(match_labels={f"k{c}": "x"}),
                topology_key=api.wellknown.LABEL_HOSTNAME)
            for c in colors]))
    return pod


def _preferred(api, i, groups):
    pod = workload.make_pod(api, i)
    pod.metadata.labels.update({f"g{g}": "x" for g in groups})
    pod.spec.affinity = api.Affinity(pod_anti_affinity=api.PodAntiAffinity(
        preferred_during_scheduling_ignored_during_execution=[
            api.WeightedPodAffinityTerm(
                weight=5, pod_affinity_term=api.PodAffinityTerm(
                    label_selector=api.LabelSelector(
                        match_labels={f"g{g}": "x"}),
                    topology_key=api.wellknown.LABEL_HOSTNAME))
            for g in groups]))
    return pod


#: (reason, cap overrides, pods as (maker, i, terms))
OVERFLOWS = {
    "term_cap": ({"TOPO_TERM_CAP": 2},
                 [(_anti, i, (i,)) for i in range(4)]),
    "kmax": ({"TOPO_KMAX": 2}, [(_anti, 0, (0, 1, 2)), (_anti, 1, (0,))]),
    "soft_terms": ({"SOFT_TERM_CAP": 3, "soft_score_chunk": 2},
                   [(_preferred, i, (i,)) for i in range(4)]),
    "soft_kmax": ({"SOFT_KMAX": 2, "soft_score_chunk": 2},
                  [(_preferred, 0, (0, 1, 2)), (_preferred, 1, (0,)),
                   (_preferred, 2, (1,))]),
}


@pytest.mark.parametrize("reason", sorted(OVERFLOWS))
def test_inscan_fallback_counters_match_jax(reason, monkeypatch):
    caps, specs = OVERFLOWS[reason]
    out = []
    for api, cache_cls, sched_cls, metrics_cls, kw in (
            (japi, JCache, JBatch, JMetrics, {}),
            (tapi, TCache, TBatch, TMetrics, {"device": "cpu"})):
        sched, _ = workload.build(api, cache_cls, sched_cls, None, 16,
                                  "uniform", **kw)
        sched.sched_metrics = metrics_cls()
        for k, v in caps.items():
            monkeypatch.setattr(sched, k, v)
        pods = [maker(api, i, terms) for maker, i, terms in specs]
        limit = sched.soft_batch_limit(pods)
        res = sched.schedule(pods)
        m = sched.sched_metrics
        out.append((limit, [r.node_name for r in res],
                    {r: m.topo_inscan_fallbacks.value(reason=r)
                     for r in OVERFLOWS},
                    dict(sched._fallback_streak)))
        if reason.startswith("soft"):
            assert limit == 2 < len(pods)
    assert out[0] == out[1]
    assert out[1][2][reason] >= 1


def test_capped_scan_counter_matches_jax():
    out = []
    for cache_cls, sched_cls, metrics_cls, kw in (
            (JCache, JBatch, JMetrics, {}),
            (TCache, TBatch, TMetrics, {"device": "cpu"})):
        sched = sched_cls(cache_cls(), **kw)
        sched.sched_metrics = metrics_cls()
        sched._count_capped_scan("preempt_candidates", 9)
        sched._count_capped_scan("preempt_candidates", 9)
        sched._end_inscan_streak("preempt_candidates")
        out.append((sched.sched_metrics.capped_scans.value(
            cap="preempt_candidates"), dict(sched._fallback_streak)))
    assert out[0] == out[1] == (2.0, {"preempt_candidates": 0})


# ------------------------------------------------------------ slice 4


def _batch_sched(**kw):
    sched, _ = workload.build(tapi, TCache, TBatch, None, 16, "uniform",
                              device="cpu", **kw)
    return sched


@pytest.mark.parametrize("route", ["classic", "nominated", "filter_score"])
def test_slice4_routes_still_raise(route, monkeypatch):
    """The routes outside slice 4 when it landed now schedule as JAX
    does. The nominated overlay (slice 4): a batch of inter-pod pods
    beside a ghost nomination schedules as the JAX BatchScheduler
    schedules it. The classic per-pod branch (slice 5): the same batch
    with KTPU_CLASS_SCAN=0 in both packages. filter_score (slice 5): the
    anti-affinity fixture's [P, N] fits and scores equal JAX's."""
    if route == "filter_score":
        node_cfg, usage, pb = _case("anti")
        ci = pb["class_idx"]
        classic = {k: v for k, v in pb.items() if not k.startswith("class_")}
        classic.update(req=pb["class_req"][ci],
                       nonzero_req=pb["class_nz"][ci],
                       mem_pressure_blocked=pb["class_blocked"][ci],
                       mask_idx=pb["class_mask_idx"][ci],
                       score_idx=pb["class_score_idx"][ci])
        ref = jb.filter_score(node_cfg, usage, classic)
        got = tb.filter_score(*tables_from_numpy(node_cfg, usage, classic,
                                                 "cpu"))
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(_bits(r), _bits(g))
        return
    if route == "classic":
        monkeypatch.setenv("KTPU_CLASS_SCAN", "0")
    out = []
    for api, cache_cls, sched_cls, nom_cls, kw in (
            (japi, JCache, JBatch, JNominatedPodMap, {}),
            (tapi, TCache, TBatch, NominatedPodMap, {"device": "cpu"})):
        nominated = nom_cls()
        if route == "nominated":
            nominated.add(workload.make_pod(api, 99), "node-0")
        sched, _ = workload.build(api, cache_cls, sched_cls, None, 16,
                                  "uniform", nominated=nominated, **kw)
        assert sched.class_scan == (route != "classic")
        res = sched.schedule([_anti(api, 0, (0,)),
                              _preferred(api, 1, (0,))])
        out.append([(r.node_name, np.float32(r.score).view(np.int32))
                    for r in res])
    assert out[0] == out[1]
    assert all(n for n, _ in out[1])
