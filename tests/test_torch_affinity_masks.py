"""The required-affinity mask route of the port (K13, K14), against JAX.

Port slice 8: `TopologyIndex.required_masks` evaluates a batch's
constraint templates on the device (kernels/affinity.py) once U·T·N
reaches DEVICE_EVAL_THRESHOLD. Here on the CPU, with inputs made from a
seed with numpy:

- `affinity_masks_plain` and the port's `affinity_masks(..., device=
  "cpu")` against the reference's `_affinity_masks_jit` and
  `affinity_masks` at shapes that cross the power-of-two buckets: bool
  equality, no tolerance;
- `affinity_scores_plain` and the `affinity_scores` wrapper against the
  reference's: bit-exact on integer-valued inputs (preferred weights in
  [-100, 100], counts in [0, 50]); on random f32 within the error bound
  of a length-T f32 sum in any order, T · 2^-24 · sum|w·c| for each of
  the two orders, so |Δ| ≤ T · 2^-23 · sum|w·c| per element (the
  product's term order differs between the two);
- the port's `required_masks` against the reference's on the clusters of
  tests/test_topology.py (rebuilt here for either package's types), both
  modules' DEVICE_EVAL_THRESHOLD patched to 0, and the port's device
  route against its own host route;
- the port's Scheduler against the JAX Scheduler on a small
  `service-anti-affinity` cluster (48 nodes, 400 pods in 40 services,
  threshold 0 on both sides): the same node for every pod, with the
  in-scan topology tables installed and with them overflowing the term
  cap (the route of the 1,000-service drain on the card);
- no fallback: pointed at a CUDA device where there is none, the
  wrappers raise.
"""

import random

import numpy as np
import pytest
import torch

from kubernetes_tpu import api as japi
from kubernetes_tpu.scheduler import Scheduler as JScheduler
from kubernetes_tpu.scheduler import topology as jtopo
from kubernetes_tpu.scheduler.cache import Cache as JCache
from kubernetes_tpu.scheduler.cache import Snapshot as JSnapshot
from kubernetes_tpu.scheduler.core import BatchScheduler as JBatch
from kubernetes_tpu.scheduler.kernels import affinity as jaff
from kubernetes_tpu.scheduler.tensorize import TensorMirror as JMirror
from kubernetes_tpu.state import Client as JClient

from kubernetes_tpu_torch import api as tapi
from kubernetes_tpu_torch import workload
from kubernetes_tpu_torch.scheduler import Scheduler as TScheduler
from kubernetes_tpu_torch.scheduler import topology as ttopo
from kubernetes_tpu_torch.scheduler.cache import Cache as TCache
from kubernetes_tpu_torch.scheduler.cache import Snapshot as TSnapshot
from kubernetes_tpu_torch.scheduler.core import BatchScheduler as TBatch
from kubernetes_tpu_torch.scheduler.kernels import affinity as taff
from kubernetes_tpu_torch.scheduler.tensorize import TensorMirror as TMirror
from kubernetes_tpu_torch.state import Client as TClient

#: U and T of the bucket-crossing cases (_bucket: 8, 8, 16, 64)
SIZES = (1, 7, 9, 33)


def _mask_inputs(seed, U, T, N):
    """has_dom, present [T, N] bool and the three 0/1 selectors [U, T]
    f32 as required_masks builds them: each template takes one or two
    terms, each as required affinity (sel_dom and sel_present), waived
    affinity (sel_dom only) or anti-affinity (sel_absent). A term's
    has_dom row may be partly False, and present may be True off the
    domain, which the kernel masks."""
    rng = np.random.default_rng(seed)
    has_dom = rng.random((T, N)) < 0.9
    present = rng.random((T, N)) < 0.5
    sels = [np.zeros((U, T), np.float32) for _ in range(3)]
    for u in range(U):
        for t in rng.choice(T, size=min(T, rng.integers(1, 3)),
                            replace=False):
            kind = rng.integers(3)
            if kind < 2:
                sels[0][u, t] = 1.0
                sels[1][u, t] = float(kind == 0)
            else:
                sels[2][u, t] = 1.0
    return (has_dom, present, *sels)


def _padded(arrays, U, T):
    Tb, Ub = jaff._bucket(T), jaff._bucket(U)
    out = []
    for a in arrays:
        shape = (Tb, a.shape[1]) if a.dtype == bool else (Ub, Tb)
        p = np.zeros(shape, a.dtype)
        p[tuple(slice(0, s) for s in a.shape)] = a
        out.append(p)
    return out


@pytest.mark.parametrize("N", [24, 128])
@pytest.mark.parametrize("T", SIZES)
@pytest.mark.parametrize("U", SIZES)
def test_plain_masks_match_jax(U, T, N):
    args = _mask_inputs(1000 * U + 10 * T + N, U, T, N)
    pad = _padded(args, U, T)
    ref = np.asarray(jaff._affinity_masks_jit(*pad))
    got = taff.affinity_masks_plain(*(torch.from_numpy(a) for a in pad))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), ref)
    ref_u = jaff.affinity_masks(*args)
    got_u = taff.affinity_masks(*args, device="cpu")
    assert got_u.shape == (U, N) and got_u.dtype == np.bool_
    np.testing.assert_array_equal(got_u, ref_u)
    # padded templates are all-True, padded terms add nothing
    assert ref[U:].all()
    assert 0 < ref_u.sum() < ref_u.size


def _score_inputs(seed, U, T, N, integer):
    rng = np.random.default_rng(seed)
    if integer:
        w = rng.integers(-100, 101, (U, T)).astype(np.float32)
        c = rng.integers(0, 51, (T, N)).astype(np.float32)
    else:
        w = rng.standard_normal((U, T)).astype(np.float32)
        c = (rng.standard_normal((T, N)) * 10).astype(np.float32)
    return w, c


@pytest.mark.parametrize("U,T,N", [(1, 1, 24), (7, 9, 24), (9, 33, 128),
                                   (33, 7, 128), (64, 300, 256)])
def test_plain_scores_match_jax_on_integers(U, T, N):
    w, c = _score_inputs(U + T + N, U, T, N, integer=True)
    ref = jaff.affinity_scores(w, c)
    got = taff.affinity_scores(w, c, device="cpu")
    assert got.shape == (U, N) and got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    pw = np.zeros((jaff._bucket(U), jaff._bucket(T)), np.float32)
    pw[:U, :T] = w
    pc = np.zeros((jaff._bucket(T), N), np.float32)
    pc[:T] = c
    plain = taff.affinity_scores_plain(torch.from_numpy(pw),
                                       torch.from_numpy(pc)).numpy()
    np.testing.assert_array_equal(
        plain.view(np.int32),
        np.asarray(jaff._affinity_scores_jit(pw, pc)).view(np.int32))


@pytest.mark.parametrize("U,T,N", [(7, 9, 24), (9, 33, 128), (33, 300, 64)])
def test_plain_scores_match_jax_on_f32(U, T, N):
    w, c = _score_inputs(7 * U + T + N, U, T, N, integer=False)
    ref = jaff.affinity_scores(w, c).astype(np.float64)
    got = taff.affinity_scores(w, c, device="cpu").astype(np.float64)
    Tb = jaff._bucket(T)
    tol = Tb * 2.0 ** -23 * (np.abs(w).astype(np.float64)
                             @ np.abs(c).astype(np.float64))
    assert (np.abs(got - ref) <= tol).all()


# ------------------------------------------------------------ required_masks
# tests/test_topology.py's random clusters, built for either package


ZONES = ["z1", "z2", "z3"]
APPS = ["web", "db", "cache", "batch"]
NAMESPACES = ["default", "prod"]


def rnd_node(api, rng, i):
    labels = {api.wellknown.LABEL_HOSTNAME: f"n{i}"}
    if rng.random() < 0.8:  # some nodes miss the zone label on purpose
        labels[api.wellknown.LABEL_ZONE] = rng.choice(ZONES)
    alloc = {"cpu": api.Quantity("8"), "memory": api.Quantity("16Gi"),
             "pods": api.Quantity(110)}
    return api.Node(
        metadata=api.ObjectMeta(name=f"n{i}", labels=labels),
        status=api.NodeStatus(capacity=dict(alloc), allocatable=dict(alloc),
                              conditions=[api.NodeCondition(
                                  type="Ready", status="True")]))


def rnd_term(api, rng):
    sel = api.LabelSelector(match_labels={"app": rng.choice(APPS)})
    if rng.random() < 0.3:
        sel = api.LabelSelector(match_expressions=[
            api.LabelSelectorRequirement(
                key="app", operator="In",
                values=sorted(rng.sample(APPS, 2)))])
    tk = rng.choice([api.wellknown.LABEL_ZONE, api.wellknown.LABEL_HOSTNAME])
    namespaces = []
    if rng.random() < 0.25:
        namespaces = [rng.choice(NAMESPACES)]
    return api.PodAffinityTerm(label_selector=sel, topology_key=tk,
                               namespaces=namespaces)


def rnd_pod(api, rng, i, with_affinity=0.5):
    pod = api.Pod(
        metadata=api.ObjectMeta(
            name=f"p{i}", namespace=rng.choice(NAMESPACES),
            labels={"app": rng.choice(APPS)}),
        spec=api.PodSpec(containers=[api.Container(
            name="c", image="img",
            resources=api.ResourceRequirements(
                requests={"cpu": api.Quantity("100m")}))]))
    if rng.random() < with_affinity:
        aff = api.Affinity()
        r = rng.random()
        if r < 0.4:
            aff.pod_affinity = api.PodAffinity(
                required_during_scheduling_ignored_during_execution=[
                    rnd_term(api, rng)])
        elif r < 0.8:
            aff.pod_anti_affinity = api.PodAntiAffinity(
                required_during_scheduling_ignored_during_execution=[
                    rnd_term(api, rng)])
        else:
            aff.pod_affinity = api.PodAffinity(
                required_during_scheduling_ignored_during_execution=[
                    rnd_term(api, rng)])
            aff.pod_anti_affinity = api.PodAntiAffinity(
                required_during_scheduling_ignored_during_execution=[
                    rnd_term(api, rng)])
        if rng.random() < 0.5:
            wt = api.WeightedPodAffinityTerm(
                weight=rng.randint(1, 100),
                pod_affinity_term=rnd_term(api, rng))
            if aff.pod_affinity is None:
                aff.pod_affinity = api.PodAffinity()
            aff.pod_affinity.preferred_during_scheduling_ignored_during_execution = [wt]
        if rng.random() < 0.3:
            wt = api.WeightedPodAffinityTerm(
                weight=rng.randint(1, 100),
                pod_affinity_term=rnd_term(api, rng))
            if aff.pod_anti_affinity is None:
                aff.pod_anti_affinity = api.PodAntiAffinity()
            aff.pod_anti_affinity.preferred_during_scheduling_ignored_during_execution = [wt]
        pod.spec.affinity = aff
    return pod


JSIDE = (japi, JCache, JSnapshot, JMirror, jtopo, {})
TSIDE = (tapi, TCache, TSnapshot, TMirror, ttopo, {"device": "cpu"})


def _cluster(side, seed, n_nodes=24, n_pods=60, incoming=12):
    """(mirror, index, profiles of `incoming` new pods) on one side, the
    same seeded cluster as tests/test_topology.py build_cluster."""
    api, cache_cls, snap_cls, mirror_cls, topo, kw = side
    rng = random.Random(seed)
    cache = cache_cls()
    mirror = mirror_cls(**kw)
    index = topo.TopologyIndex(mirror)
    snap = snap_cls()
    for i in range(n_nodes):
        cache.add_node(rnd_node(api, rng, i))
    for i in range(n_pods):
        p = rnd_pod(api, rng, i)
        p.spec.node_name = f"n{rng.randrange(n_nodes)}"
        cache.add_pod(p)
    dirty = cache.update_snapshot(snap)
    mirror.apply(snap, dirty)
    index.apply(snap, dirty)
    pods = [rnd_pod(api, rng, 1000 + k, with_affinity=0.9)
            for k in range(incoming)]
    return mirror, index, [index.required_profile(p) for p in pods]


@pytest.mark.parametrize("seed", [7, 11, 13, 29])
def test_required_masks_device_route_matches_jax(seed, monkeypatch):
    calls = []
    orig = taff.affinity_masks
    monkeypatch.setattr(taff, "affinity_masks",
                        lambda *a, **kw: calls.append(a[0].shape)
                        or orig(*a, **kw))
    _, jidx, jprofs = _cluster(JSIDE, seed)
    tmirror, tidx, tprofs = _cluster(TSIDE, seed)
    host = tidx.required_masks(tprofs)
    assert not calls
    monkeypatch.setattr(jtopo, "DEVICE_EVAL_THRESHOLD", 0)
    monkeypatch.setattr(ttopo, "DEVICE_EVAL_THRESHOLD", 0)
    ref = jidx.required_masks(jprofs)
    got = tidx.required_masks(tprofs)
    assert len(calls) == 1
    assert calls[0][0] > 1                 # T terms for U = 12 templates
    assert got.shape == (len(tprofs), tmirror.t.capacity)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, host)
    assert 0 < got.sum() < got.size


# ------------------------------------------------------------ end to end

SVC_NODES, SVC_PODS, SVC_GROUPS, SVC_BATCH = 48, 400, 40, 128


def _svc_drain(side, term_cap=None):
    """The service-anti-affinity cluster through one package's Scheduler:
    bench.py nodes created through the Client and fed to the cache, pods
    created and queued, drain_pipelined. `term_cap` overrides the
    BatchScheduler's in-scan term cap (TOPO_TERM_CAP)."""
    api, Scheduler, Client, batch_cls, kw = side
    client = Client(validate=False)
    sched = Scheduler(client, batch_size=SVC_BATCH, disable_preemption=True,
                      **kw)
    if term_cap is not None:
        sched.algorithm.TOPO_TERM_CAP = term_cap
    for i in range(SVC_NODES):
        node = workload.make_node(api, i)
        client.nodes().create(node)
        sched.cache.add_node(node)
    for i in range(SVC_PODS):
        sched.queue.add(client.pods().create(
            workload.service_pod(api, i, SVC_GROUPS)))
    sched.algorithm.refresh()
    sched.drain_pipelined()
    pods, _ = client.pods().list_rv(namespace=None)
    fallbacks = sched.algorithm.sched_metrics.topo_inscan_fallbacks
    return ({p.metadata.name: p.spec.node_name for p in pods},
            fallbacks.value(reason="term_cap"))


@pytest.mark.parametrize("term_cap", [None, 16])
def test_service_anti_affinity_binds_like_jax(term_cap, monkeypatch):
    monkeypatch.setenv("KTPU_COMMIT_THREAD", "0")
    monkeypatch.setattr(jtopo, "DEVICE_EVAL_THRESHOLD", 0)
    monkeypatch.setattr(ttopo, "DEVICE_EVAL_THRESHOLD", 0)
    calls = []
    orig = taff.affinity_masks_tensors
    monkeypatch.setattr(taff, "affinity_masks_tensors",
                        lambda *a: calls.append(tuple(a[0].shape))
                        or orig(*a))
    jbinds, jfall = _svc_drain((japi, JScheduler, JClient, JBatch, {}),
                               term_cap)
    tbinds, tfall = _svc_drain((tapi, TScheduler, TClient, TBatch,
                                {"device": "cpu"}), term_cap)
    assert tbinds == jbinds
    assert tfall == jfall and (tfall > 0) == (term_cap is not None)
    assert all(tbinds.values()) and len(tbinds) == SVC_PODS
    pairs = {(int(p.split("-")[1]) % SVC_GROUPS, n)
             for p, n in tbinds.items()}
    assert len(pairs) == SVC_PODS        # no two replicas share a node
    # every constrained batch took the device route; once replicas are
    # bound their carried anti terms join the match terms
    assert len(calls) >= SVC_PODS // SVC_BATCH
    assert max(t for t, _ in calls) > min(t for t, _ in calls)


@pytest.mark.parametrize("fn,args", [
    ("affinity_masks", lambda: _mask_inputs(0, 3, 5, 16)),
    ("affinity_scores", lambda: _score_inputs(0, 3, 5, 16, True))])
@pytest.mark.parametrize("device", ["cuda", None])
def test_wrappers_raise_without_cuda(fn, args, device, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = dict(taff.LAUNCHES)
    with pytest.raises(RuntimeError, match="CUDA"):
        getattr(taff, fn)(*args(), device=device)
    assert taff.LAUNCHES == before
