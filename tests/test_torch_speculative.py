"""Speculative cohorts in the port, against JAX (port slice 7).

The contract is the reference's: KTPU_SPECULATIVE=1 routes class-table
batches to the cohort scan, and every decision equals the serial class
scan's, pod for pod. Here on the CPU, with the same inputs in both
packages:

- schedule_batch_speculative_plain against the JAX
  schedule_batch_speculative (assign, f32 score bits, the per-cohort
  stats and every post-batch usage final, no tolerance): on a uniform
  batch whose cohorts are all clean, at widths 8, 16 and 32; on a batch
  with node contention where both collision types fire; on a batch with
  the nominated overlay; and on the randomized mixed batches of the
  reference's tests/test_speculative.py (_mk_mixed_pod: spread carriers,
  soft credits, required anti colors, plain pods, two namespaces,
  nominated pods), taken from the JAX BatchScheduler's own launches;
- the plain version against the port's own serial schedule_batch (the
  contract);
- BatchScheduler end to end with speculative=True against the JAX one:
  the same node for every pod, the same scheduler_speculative_* counter
  values, the same spec_plain and cohort_id vectors, and no divergence
  under the oracle; and the reference's TestSpeculativeParity /
  TestSpeculativeScheduler cases on the port: contending cohorts repair
  and still match, narrow cohorts on a wide fleet are accepted, the
  contention gate routes an all-anti-affinity batch to the serial scan,
  the flag off ships nothing speculative, and the constructor beats the
  environment.

Only monkeypatch changes process-wide state. The JAX programs compile
per cohort width and carried terms, so the fixtures share their shapes
(widths of 8 where the width is not under test).
"""

import random

import numpy as np
import pytest
import torch

from kubernetes_tpu import api as japi
from kubernetes_tpu.scheduler import priorities as jprios
from kubernetes_tpu.scheduler.cache import Cache as JCache
from kubernetes_tpu.scheduler.core import BatchScheduler as JBatch
from kubernetes_tpu.scheduler.kernels import speculative as jspec
from kubernetes_tpu.scheduler.metrics import SchedulerMetrics as JMetrics
from kubernetes_tpu.scheduler.queue import NominatedPodMap as JNominated

from kubernetes_tpu_torch import api as tapi
from kubernetes_tpu_torch.convert import nom_from_numpy, tables_from_numpy
from kubernetes_tpu_torch.scheduler import Scheduler as TScheduler
from kubernetes_tpu_torch.scheduler import priorities as tprios
from kubernetes_tpu_torch.scheduler.cache import Cache as TCache
from kubernetes_tpu_torch.scheduler.core import BatchScheduler as TBatch
from kubernetes_tpu_torch.scheduler.kernels import batch as tb
from kubernetes_tpu_torch.scheduler.kernels import speculative as tspec
from kubernetes_tpu_torch.scheduler.metrics import SchedulerMetrics as TMetrics
from kubernetes_tpu_torch.scheduler.queue import NominatedPodMap as TNominated
from kubernetes_tpu_torch.state import Client as TClient

from test_torch_affinity import _assert_equal, _base, _bits, _nom

JAX = dict(api=japi, prios=jprios, Cache=JCache, Batch=JBatch,
           Metrics=JMetrics, Nominated=JNominated, spec=jspec, kw={})
PORT = dict(api=tapi, prios=tprios, Cache=TCache, Batch=TBatch,
            Metrics=TMetrics, Nominated=TNominated, spec=tspec,
            kw={"device": "cpu"})

WEIGHTS = {"LeastRequestedPriority": 1, "BalancedResourceAllocation": 1,
           "SelectorSpreadPriority": 1, "InterPodAffinityPriority": 1}


# ------------------------------------------------------------ kernel level


def _spec_plain(pb):
    """tensorize.set_speculative's rule on a numpy batch: a pod is plain
    iff it reads no carried term and holds no nomination of its own."""
    P = pb["seq"].shape[0]
    plain = np.ones(P, bool)
    if "nom_row" in pb:
        plain &= pb["nom_row"] < 0
    for k in ("anti_tids", "aff_tids", "cmatch_tids"):
        if k in pb:
            plain &= (pb[k] < 0).all(axis=1)
    if "spread_gidx" in pb:
        plain &= pb["spread_gidx"] < 0
    if "soft_base_idx" in pb:
        plain &= pb["soft_base_idx"] < 0
    return plain


def _uniform():
    """Empty nodes (tests/test_torch_affinity.py's _base: 60 valid of 64,
    every valid node up), 48 active pods of one class of 1,000m / 2Gi on
    4 CPU / 32Gi nodes, no static score: a bind drops the node's score,
    so no winner's write reaches a later member's maximum and at width 8
    every cohort is clean."""
    cfg, use, pb = _base(0)
    cfg["node_ok"][:] = cfg["valid"]
    for k in use:
        use[k][:] = 0
    pb["class_idx"][:] = 3
    pb["class_mask_idx"][3] = 0
    pb["class_score_idx"][3] = 0
    pb["active"] = np.arange(64) < 48
    return cfg, use, pb


def _both(cfg, use, pb, nom=None, width=8):
    """(JAX schedule_batch_speculative, the port's plain version, the
    port's serial schedule_batch) on the same numpy inputs."""
    pb = dict(pb, spec_plain=_spec_plain(pb))
    ref = jspec.schedule_batch_speculative(cfg, use, pb, nom, width=width)
    tc, tu, tpb = tables_from_numpy(cfg, use, pb, "cpu")
    tnom = nom_from_numpy(nom, "cpu")
    got = tspec.schedule_batch_speculative_plain(tc, tu, tpb, tnom, width)
    serial = tb.schedule_batch(tc, tu, tpb, tnom)
    return ref, got, serial


def _assert_spec_equal(ref, got, serial, active):
    _assert_equal(ref[:3], got[:3])
    np.testing.assert_array_equal(np.asarray(ref[3]), got[3].numpy())
    assert got[3].dtype == torch.int32
    # the contract: the serial scan's decisions, the active pods' scores
    # and the usage (a padding pod is never checked for collisions: its
    # score is its frozen pick's, in the JAX speculative kernel too)
    np.testing.assert_array_equal(_bits(serial[0]), _bits(got[0]))
    np.testing.assert_array_equal(_bits(serial[1])[active],
                                  _bits(got[1])[active])
    assert set(serial[2]) == set(got[2])
    for k in serial[2]:
        np.testing.assert_array_equal(_bits(serial[2][k]), _bits(got[2][k]))


@pytest.mark.parametrize("width", [8, 16, 32])
def test_uniform_batch_matches_jax(width):
    cfg, use, pb = _uniform()
    ref, got, serial = _both(cfg, use, pb, width=width)
    _assert_spec_equal(ref, got, serial, pb["active"])
    st = got[3].numpy()
    assert st.shape == (64 // width, 2)
    if width == 8:
        # every cohort clean: accepted, first collider = width
        assert (st[:, 0] == 1).all() and (st[:, 1] == 8).all()
    assert (got[0].numpy()[:48] >= 0).all()


def test_contention_batch_matches_jax(monkeypatch):
    """_base's used nodes and four classes on 60 rows: cohorts contend.
    Both collision types fire (type 2 without type 1 on some member:
    an earlier winner's write raised the member's value at that row),
    every cohort repairs, and the result is still JAX's and the serial
    scan's."""
    fired = {"t1": False, "t2": False}
    orig = tspec._cohort_checks

    def record(*a):
        t1, t2, collide = orig(*a)
        fired["t1"] |= bool(t1.any())
        fired["t2"] |= bool((t2 & ~t1).any())
        return t1, t2, collide
    monkeypatch.setattr(tspec, "_cohort_checks", record)
    cfg, use, pb = _base(0)
    ref, got, serial = _both(cfg, use, pb)
    _assert_spec_equal(ref, got, serial, pb["active"])
    assert fired == {"t1": True, "t2": True}
    assert (got[3].numpy()[:, 0] == 0).all()


def test_nominated_batch_matches_jax():
    """The nominated overlay (test_torch_affinity.py's _nom: a fully
    reserved row, four pods holding their own nomination, fenced as
    non-plain): the winner columns and the repair carry the reservations
    as the JAX kernel's do."""
    cfg, use, pb = _base(0)
    nom = _nom(cfg, use, pb, 0)
    ref, got, serial = _both(cfg, use, pb, nom=nom)
    _assert_spec_equal(ref, got, serial, pb["active"])
    assert not _spec_plain(pb)[[0, 1, 7, 30]].any()


def test_width_must_tile_the_batch():
    tc, tu, tpb = tables_from_numpy(*_uniform(), "cpu")
    tpb["spec_plain"] = torch.ones(64, dtype=torch.bool)
    with pytest.raises(ValueError, match="divide"):
        tspec.schedule_batch_speculative(tc, tu, tpb, width=24)
    assert tspec.cohort_width(8) == 8
    assert tspec.cohort_width(64) == 16


def test_divergence_report_attributes_pods():
    got = tspec.divergence_report(np.array([1, 2, 3, 4]),
                                  np.array([1, 5, 3, 6]), 2)
    assert got == [{"pod": 1, "cohort": 0, "speculative": 2, "serial": 5},
                   {"pod": 3, "cohort": 1, "speculative": 4, "serial": 6}]
    assert tspec.divergence_report(np.arange(4), np.arange(4), 16) == []


# ------------------------------------------------------------ schedulers


def mk_node(api, i, zone=None, cpu="8", mem="16Gi"):
    labels = {api.wellknown.LABEL_HOSTNAME: f"n{i}"}
    if zone is not None:
        labels[api.wellknown.LABEL_ZONE] = zone
    alloc = {"cpu": api.Quantity(cpu), "memory": api.Quantity(mem),
             "pods": api.Quantity(110)}
    return api.Node(
        metadata=api.ObjectMeta(name=f"n{i}", labels=labels),
        status=api.NodeStatus(capacity=dict(alloc), allocatable=dict(alloc),
                              conditions=[api.NodeCondition(
                                  type="Ready", status="True")]))


def mk_pod(api, i, labels, cpu="100m", mem="64Mi"):
    return api.Pod(
        metadata=api.ObjectMeta(name=f"p{i}", namespace="default",
                                labels=dict(labels)),
        spec=api.PodSpec(containers=[api.Container(
            name="c", image="img",
            resources=api.ResourceRequirements(
                requests={"cpu": api.Quantity(cpu),
                          "memory": api.Quantity(mem)}))]))


def _term(api, key, value):
    return api.PodAffinityTerm(
        label_selector=api.LabelSelector(match_labels={key: value}),
        topology_key=api.wellknown.LABEL_HOSTNAME)


def soft_anti(api, pod, group, weight=10):
    pod.spec.affinity = api.Affinity(pod_anti_affinity=api.PodAntiAffinity(
        preferred_during_scheduling_ignored_during_execution=[
            api.WeightedPodAffinityTerm(
                weight=weight, pod_affinity_term=_term(api, "grp", group))]))
    return pod


def req_anti(api, pod, color):
    pod.spec.affinity = api.Affinity(pod_anti_affinity=api.PodAntiAffinity(
        required_during_scheduling_ignored_during_execution=[
            _term(api, "color", color)]))
    return pod


def mixed_pod(api, rng, i):
    """tests/test_speculative.py _mk_mixed_pod in either package's types
    (the same draws): spread carriers, soft credits, required anti
    colors and plain pods across two namespaces."""
    kind = rng.randrange(5)
    ns = ("default", "tenant-b")[i % 2]
    if kind == 0:
        p = mk_pod(api, i, {"app": "web"})
    elif kind == 1:
        g = f"g{rng.randrange(3)}"
        p = soft_anti(api, mk_pod(api, i, {"grp": g}), g)
    elif kind == 2:
        c = f"c{rng.randrange(6)}"
        p = req_anti(api, mk_pod(api, i, {"color": c}), c)
    else:
        p = mk_pod(api, i, {"plain": "x"})
    p.metadata.namespace = ns
    return p


def plain_pod(api, rng, i):
    return mk_pod(api, i, {"plain": "x"})


def anti_pod(api, rng, i):
    return req_anti(api, mk_pod(api, i, {"color": f"c{i % 6}"}),
                    f"c{i % 6}")


def _run_batches(side, speculative, factory, n_nodes=16, batches=(60, 60),
                 oracle=True, nominate=False, seed=9):
    """tests/test_speculative.py _run_batches in either package: the
    BatchScheduler over consecutive batches, binding the winners between
    them. Returns (decisions, metrics, scheduler, [(spec_plain,
    cohort_id)] per launch)."""
    api = side["api"]
    svc = api.Service(
        metadata=api.ObjectMeta(name="web", namespace="default"),
        spec=api.ServiceSpec(selector={"app": "web"}))
    listers = side["prios"].SpreadListers(services=lambda ns: [svc])
    rng = random.Random(seed)
    cache = side["Cache"]()
    for i in range(n_nodes):
        cache.add_node(mk_node(api, i, zone=f"z{i % 3}"))
    nominated = side["Nominated"]()
    if nominate:
        ghost = mk_pod(api, 900, {}, cpu="6", mem="12Gi")
        ghost.status.nominated_node_name = "n1"
        nominated.add(ghost)
    sched = side["Batch"](cache, listers=listers, weights=dict(WEIGHTS),
                          nominated=nominated, **side["kw"])
    sched.speculative = speculative
    sched.spec_oracle = oracle and speculative
    sched.sched_metrics = side["Metrics"]()
    vectors = []
    launch = sched.schedule_launch

    def recorded(pods, *a, **kw):
        pending = launch(pods, *a, **kw)
        b = pending.batch
        vectors.append(None if b.spec_plain is None else
                       (np.asarray(b.spec_plain), np.asarray(b.cohort_id)))
        return pending
    sched.schedule_launch = recorded
    decisions = []
    next_i = 0
    for n_pods in batches:
        pods = [factory(api, rng, next_i + j) for j in range(n_pods)]
        next_i += n_pods
        if nominate:
            for p in pods[:2]:
                p.status.nominated_node_name = f"n{2 + next_i % 5}"
                nominated.add(p)
        for res in sched.schedule(pods):
            decisions.append((res.pod.metadata.name, res.node_name,
                              np.float32(res.score).view(np.int32)))
            if res.node_name is not None:
                nominated.delete(res.pod)
                bound = api.serde.deepcopy_obj(res.pod)
                bound.spec.node_name = res.node_name
                cache.add_pod(bound)
    return decisions, sched.sched_metrics, sched, vectors


def _counters(m):
    return (m.speculative_cohorts.value(), m.speculative_collisions.value(),
            m.speculative_repaired.value(), m.speculative_divergences.value())


@pytest.fixture(scope="module")
def mixed_runs():
    """The reference's randomized mixed fixture (nominations on, the
    contention gate forced open, cohorts of 8) through the JAX and the
    port BatchScheduler (the port's with the oracle), each launch of the JAX kernel's
    inputs and outputs kept; and the port's serial run of the same
    fixture."""
    mp = pytest.MonkeyPatch()
    calls = []
    orig = jspec.schedule_batch_speculative

    def kept(node_cfg, usage, pod_batch, nom=None, width=16):
        out = orig(node_cfg, usage, pod_batch, nom, width=width)

        def host(d):
            # copies: the JAX drain donates device buffers it reuses
            return None if d is None else {k: np.array(v)
                                           for k, v in d.items()}
        calls.append(((host(node_cfg), host(usage), host(pod_batch),
                       host(nom), width),
                      tuple(np.array(x) for x in out[:2])
                      + (host(out[2]), np.array(out[3]))))
        return out
    try:
        for spec in (jspec, tspec):
            mp.setattr(spec, "_SPEC_MIN_PLAIN", 0.0)
            mp.setattr(spec, "_SPEC_COHORT", 8)
        mp.setattr(jspec, "schedule_batch_speculative", kept)
        # the oracle runs on the port's side (the JAX one would only add
        # a compile of the JAX serial scan)
        runs = {"jax": _run_batches(JAX, True, mixed_pod, nominate=True,
                                    oracle=False),
                "port": _run_batches(PORT, True, mixed_pod, nominate=True),
                "serial": _run_batches(PORT, False, mixed_pod,
                                       nominate=True)}
    finally:
        mp.undo()
    return runs, calls


def test_mixed_batches_plain_matches_jax(mixed_runs):
    """Each launch of the JAX kernel on the mixed fixture, replayed
    through the port's plain version on the same inputs."""
    _, calls = mixed_runs
    assert len(calls) == 2
    for (cfg, use, pb, nom, width), ref in calls:
        tc, tu, tpb = tables_from_numpy(cfg, use, pb, "cpu")
        got = tspec.schedule_batch_speculative_plain(
            tc, tu, tpb, nom_from_numpy(nom, "cpu"), width)
        _assert_equal(ref[:3], got[:3])
        np.testing.assert_array_equal(ref[3], got[3].numpy())
        # every carry rode the batch, and some cohort repaired
        assert {"spread_base", "soft_dom", "anti_dom"} <= set(pb)
        assert (ref[3][:, 0] == 0).any()


def test_mixed_scheduler_matches_jax(mixed_runs):
    """ACCEPTANCE: the port's speculative BatchScheduler puts every pod
    where the JAX one does, with the same score bits, counters and
    speculation vectors, and its oracle counts no divergence."""
    runs, _ = mixed_runs
    jd, jm, js, jv = runs["jax"]
    td, tm, ts, tv = runs["port"]
    assert len(td) == 120
    assert td == jd
    assert _counters(tm) == _counters(jm)
    assert tm.speculative_cohorts.value() > 0
    assert tm.speculative_divergences.value() == 0
    assert list(ts.spec_divergence_log) == []
    assert list(ts.spec_batch_log) == list(js.spec_batch_log)
    assert len(tv) == len(jv) == 2
    for (jp, jc), (tp, tc) in zip(jv, tv):
        np.testing.assert_array_equal(jp, tp)
        np.testing.assert_array_equal(jc, tc)
        assert tp.any() and not tp.all()
        assert (tc[~tp] == -1).all()


def test_mixed_speculative_equals_serial(mixed_runs):
    """The contract on the port: speculative decisions equal the serial
    scan's on the same fixture, and the serial run ships nothing
    speculative."""
    runs, _ = mixed_runs
    assert runs["port"][0] == runs["serial"][0]
    assert runs["serial"][1].speculative_cohorts.value() == 0
    assert runs["serial"][3] == [None, None]


def test_conflict_cohorts_repair_and_still_match():
    """Plain uniform pods over two nodes: every cohort's picks contend
    (type 1), the serial repair replays them, and the decisions still
    equal the serial scan's."""
    spec, m, sched, _ = _run_batches(PORT, True, plain_pod, n_nodes=2,
                                     batches=(64,))
    serial, _, _, _ = _run_batches(PORT, False, plain_pod, n_nodes=2,
                                   batches=(64,))
    assert spec == serial
    assert m.speculative_collisions.value() > 0
    assert m.speculative_repaired.value() > 0
    assert m.speculative_divergences.value() == 0
    width, n, collided, repaired = sched.spec_batch_log[0]
    assert (width, n) == (16, 4) and collided > 0 and repaired > 0


def test_clean_cohorts_accepted(monkeypatch):
    """Narrow cohorts (4) on a wide fleet (256 nodes): some cohorts clear
    the checks and land in one shot."""
    monkeypatch.setattr(tspec, "_SPEC_COHORT", 4)
    spec, m, _, _ = _run_batches(PORT, True, plain_pod, n_nodes=256,
                                 batches=(64,))
    serial, _, _, _ = _run_batches(PORT, False, plain_pod, n_nodes=256,
                                   batches=(64,))
    assert spec == serial
    assert m.speculative_cohorts.value() - \
        m.speculative_collisions.value() > 0
    assert m.speculative_divergences.value() == 0


def test_contention_gate_routes_serial():
    """An all-anti-affinity batch under the default KTPU_SPEC_MIN_PLAIN
    (0.25): no plain pod, so the launch routes to the serial scan (K2's
    route): no cohort, no stats, no vectors, the serial decisions."""
    assert tspec._SPEC_MIN_PLAIN == 0.25
    spec, m, sched, vectors = _run_batches(PORT, True, anti_pod,
                                           batches=(48,))
    serial, _, _, _ = _run_batches(PORT, False, anti_pod, batches=(48,))
    assert spec == serial
    assert m.speculative_cohorts.value() == 0
    assert list(sched.spec_batch_log) == []
    assert vectors == [None]


def test_flag_off_is_inert():
    """With the flag off nothing speculative ships: no spec_plain on the
    batch or its tensors, no stats on the pending batch, no counter."""
    cache = TCache()
    for i in range(4):
        cache.add_node(mk_node(tapi, i))
    sched = TBatch(cache, weights=dict(WEIGHTS), device="cpu")
    assert sched.speculative is False
    sched.sched_metrics = TMetrics()
    pending = sched.schedule_launch(
        [mk_pod(tapi, i, {"plain": "x"}) for i in range(12)])
    assert pending.batch.spec_plain is None
    assert "spec_plain" not in pending.batch.device("cpu")
    assert pending.spec_stats is None and pending.spec_inputs is None
    sched.schedule_finish(pending)
    assert sched.sched_metrics.speculative_cohorts.value() == 0


def test_constructor_param_overrides_env(monkeypatch):
    monkeypatch.delenv("KTPU_SPECULATIVE", raising=False)
    s = TScheduler(TClient(validate=False), async_bind=False,
                   speculative=True, device="cpu")
    assert s.algorithm.speculative is True
    monkeypatch.setenv("KTPU_SPECULATIVE", "1")
    s = TScheduler(TClient(validate=False), async_bind=False,
                   speculative=False, device="cpu")
    assert s.algorithm.speculative is False
    s = TScheduler(TClient(validate=False), async_bind=False, device="cpu")
    assert s.algorithm.speculative is True
