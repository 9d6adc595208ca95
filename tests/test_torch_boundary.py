"""The port's boundary: what it imports, where it runs, what it refuses.

- kubernetes_tpu_torch and chip_smoke.py import torch and numpy, never
  jax and never the kubernetes_tpu package (checked in a fresh
  interpreter, and in the source of every module);
- an entry point with the default device runs on CUDA, and raises when
  there is none (never a quiet run on the CPU);
- batches outside the ported slices raise NotImplementedError instead
  of scheduling differently; the routes a slice ported schedule as the
  JAX package does (the speculative cohort route since slice 7, the
  sharded class scan since slice 9: tests/test_torch_sharded.py).
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import kubernetes_tpu_torch.api as tapi
from kubernetes_tpu_torch import workload
from kubernetes_tpu_torch.scheduler.cache import Cache
from kubernetes_tpu_torch.scheduler.core import BatchScheduler
from kubernetes_tpu_torch.scheduler.kernels import batch as kb
from kubernetes_tpu_torch.scheduler.priorities import SpreadListers
from kubernetes_tpu_torch.scheduler.queue import NominatedPodMap

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "kubernetes_tpu_torch"
SLICE_MODULES = [
    "kubernetes_tpu_torch", "kubernetes_tpu_torch.api",
    "kubernetes_tpu_torch.api.serde", "kubernetes_tpu_torch.utils.features",
    "kubernetes_tpu_torch.scheduler", "kubernetes_tpu_torch.scheduler.core",
    "kubernetes_tpu_torch.scheduler.tensorize",
    "kubernetes_tpu_torch.scheduler.topology",
    "kubernetes_tpu_torch.scheduler.priorities",
    "kubernetes_tpu_torch.scheduler.predicates",
    "kubernetes_tpu_torch.scheduler.nodeinfo",
    "kubernetes_tpu_torch.scheduler.cache",
    "kubernetes_tpu_torch.scheduler.metrics",
    "kubernetes_tpu_torch.scheduler.scorer",
    "kubernetes_tpu_torch.scheduler.volumebinder",
    "kubernetes_tpu_torch.scheduler.queue",
    "kubernetes_tpu_torch.scheduler.drain",
    "kubernetes_tpu_torch.scheduler.sharding",
    "kubernetes_tpu_torch.scheduler.kernels",
    "kubernetes_tpu_torch.scheduler.kernels.batch",
    "kubernetes_tpu_torch.scheduler.kernels.build",
    "kubernetes_tpu_torch.scheduler.kernels.gang",
    "kubernetes_tpu_torch.scheduler.kernels.preempt",
    "kubernetes_tpu_torch.scheduler.kernels.speculative",
    "kubernetes_tpu_torch.scheduler.preemption",
    "kubernetes_tpu_torch.convert", "kubernetes_tpu_torch.workload",
    "kubernetes_tpu_torch.scheduler.scheduler",
    "kubernetes_tpu_torch.scheduler.gang",
    "kubernetes_tpu_torch.scheduler.debugger",
    "kubernetes_tpu_torch.state", "kubernetes_tpu_torch.state.store",
    "kubernetes_tpu_torch.state.client",
    "kubernetes_tpu_torch.state.informer",
    "kubernetes_tpu_torch.state.record", "kubernetes_tpu_torch.runtime",
    "kubernetes_tpu_torch.observability", "kubernetes_tpu_torch.tenancy",
    "kubernetes_tpu_torch.tenancy.drf",
    "kubernetes_tpu_torch.tenancy.kernels"]


def test_port_loads_neither_jax_nor_the_reference_package():
    # only modules the imports below load count (not any the
    # interpreter's site setup may have loaded before them)
    code = ("import importlib, sys\n"
            "before = set(sys.modules)\n"
            f"for m in {SLICE_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "import chip_smoke\n"
            "bad = sorted(m for m in set(sys.modules) - before if m == 'jax'"
            " or m.startswith(('jax.', 'jaxlib')) or m == 'kubernetes_tpu'"
            " or m.startswith('kubernetes_tpu.'))\n"
            "print('BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "BAD []" in r.stdout, r.stdout


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in
    list(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]))
def test_no_module_names_jax_or_the_reference(path):
    for name in _imports(REPO / path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "kubernetes_tpu"), (path, name)


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchScheduler(Cache())
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchScheduler(Cache(), device="cuda")
    assert BatchScheduler(Cache(), device="cpu").device.type == "cpu"


def test_kernel_wrappers_refuse_other_devices():
    meta = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError, match="device"):
        kb.class_ms_init({"alloc": meta}, {}, {}, None, None, None)


def _sched(**kw):
    sched, _ = workload.build(tapi, Cache, BatchScheduler, SpreadListers,
                              16, "uniform", device="cpu", **kw)
    return sched


def _anti_pod(i, api=tapi):
    pod = workload.make_pod(api, i)
    pod.spec.affinity = api.Affinity(pod_anti_affinity=api.PodAntiAffinity(
        required_during_scheduling_ignored_during_execution=[
            api.PodAffinityTerm(
                label_selector=api.LabelSelector(
                    match_labels={"app": "bench"}),
                topology_key=api.wellknown.LABEL_HOSTNAME)]))
    return pod


def _preferred_pod(i, api=tapi):
    pod = workload.make_pod(api, i)
    pod.spec.affinity = api.Affinity(pod_anti_affinity=api.PodAntiAffinity(
        preferred_during_scheduling_ignored_during_execution=[
            api.WeightedPodAffinityTerm(
                weight=10, pod_affinity_term=api.PodAffinityTerm(
                    label_selector=api.LabelSelector(
                        match_labels={"app": "bench"}),
                    topology_key=api.wellknown.LABEL_HOSTNAME))]))
    return pod


def _jax_sched():
    import kubernetes_tpu.api as japi
    from kubernetes_tpu.scheduler.cache import Cache as JCache
    from kubernetes_tpu.scheduler.core import BatchScheduler as JBatch
    from kubernetes_tpu.scheduler.priorities import SpreadListers as JL
    sched, _ = workload.build(japi, JCache, JBatch, JL, 16, "uniform")
    return sched, japi


def _classic_like_jax(make):
    """The port's BatchScheduler and the JAX one, both built with the
    environment as it stands (KTPU_CLASS_SCAN=0 here), on the pods `make`
    builds with each package's api: (node, score bits) of each pod."""
    out = []
    for sched, api in (_jax_sched(), (_sched(), tapi)):
        assert not sched.class_scan
        res = sched.schedule(make(api))
        out.append([(r.node_name, np.float32(r.score).view(np.int32))
                    for r in res])
    assert out[0] == out[1]
    return [n for n, _ in out[1]]


def test_required_anti_affinity_batch_raises(monkeypatch):
    """Ported in slice 3: the batch schedules on the class route, with
    the counters in the scan (one pod per hostname). Ported in slice 5:
    with KTPU_CLASS_SCAN=0 the classic per-pod branch schedules it as the
    JAX classic branch does."""
    res = _sched().schedule([_anti_pod(i) for i in range(4)])
    nodes = [r.node_name for r in res]
    assert None not in nodes and len(set(nodes)) == 4
    monkeypatch.setenv("KTPU_CLASS_SCAN", "0")
    nodes = _classic_like_jax(lambda api: [_anti_pod(i, api)
                                           for i in range(4)])
    assert None not in nodes and len(set(nodes)) == 4


def test_preferred_pod_affinity_batch_raises(monkeypatch):
    """Ported in slice 3: the soft credit tables ride the class scan.
    Ported in slice 5: with KTPU_CLASS_SCAN=0 they ride the classic
    per-pod branch, as in the JAX package."""
    sched = _sched()
    pods = [_preferred_pod(i) for i in range(4)]
    assert sched._soft_plan(pods) is not None
    assert all(r.node_name for r in sched.schedule(pods))
    monkeypatch.setenv("KTPU_CLASS_SCAN", "0")
    nodes = _classic_like_jax(lambda api: [_preferred_pod(i, api)
                                           for i in range(4)])
    assert all(nodes)


def test_nominated_reservation_raises():
    """Ported in slice 4: a live nomination no longer raises. A ghost
    nominated to every node but one, holding as much as the node has
    free, keeps a batch off the reserved nodes, as the JAX BatchScheduler
    keeps it, bind for bind."""
    import kubernetes_tpu.api as japi
    from kubernetes_tpu.scheduler.cache import Cache as JCache
    from kubernetes_tpu.scheduler.core import BatchScheduler as JBatch
    from kubernetes_tpu.scheduler.queue import NominatedPodMap as JNom
    out = []
    for api, cache_cls, sched_cls, nom_cls, kw in (
            (japi, JCache, JBatch, JNom, {}),
            (tapi, Cache, BatchScheduler, NominatedPodMap,
             {"device": "cpu"})):
        nominated = nom_cls()
        for i in range(1, 16):
            ghost = workload.make_pod(api, 99 + i)
            ghost.metadata.name = f"ghost-{i}"
            ghost.spec.containers[0].resources.requests = {
                "cpu": api.Quantity("4"), "memory": api.Quantity("1Gi")}
            nominated.add(ghost, f"node-{i}")
        sched, _ = workload.build(api, cache_cls, sched_cls, None, 16,
                                  "uniform", nominated=nominated, **kw)
        res = sched.schedule([workload.make_pod(api, i) for i in range(4)])
        out.append([r.node_name for r in res])
    assert out[0] == out[1] == ["node-0"] * 4


def test_gang_batch_raises(monkeypatch):
    """Gang batches are ported in slice 6 (tests/test_torch_gang.py).
    Ported in slice 7: KTPU_SPECULATIVE=1 no longer raises, and a gang
    batch keeps the gang route under it, as the reference routes only
    class-table batches that are neither gang nor sharded to the
    speculative scan (reference core.py:1650-1684)."""
    monkeypatch.setenv("KTPU_SPECULATIVE", "1")
    sched = _sched()
    assert sched.speculative

    class Gangs:
        def batch_groups(self, pods):
            return [([0], "", True, None)]
    sched.gang = Gangs()
    pending = sched.schedule_launch([workload.make_pod(tapi, 0)])
    assert pending.gang_units and pending.spec_stats is None
    assert pending.batch.spec_plain is None
    assert sched.schedule_finish(pending)[0].node_name


@pytest.mark.parametrize("env", [("KTPU_CLASS_SCAN", "0"),
                                 ("KTPU_SPECULATIVE", "1")])
def test_unported_kernel_switches_raise(monkeypatch, env):
    """KTPU_CLASS_SCAN=0 selects the classic per-pod kernel, ported in
    slice 5, and KTPU_SPECULATIVE=1 the speculative cohort kernel, ported
    in slice 7: each schedules as the JAX package does (node and score
    bits of each pod)."""
    monkeypatch.setenv(*env)
    if env[0] == "KTPU_CLASS_SCAN":
        assert all(_classic_like_jax(lambda api: [workload.make_pod(api, 0)]))
        return
    out = []
    for sched, api in (_jax_sched(), (_sched(), tapi)):
        assert sched.speculative
        pending = sched.schedule_launch([workload.make_pod(api, i)
                                         for i in range(4)])
        assert pending.spec_stats is not None
        out.append([(r.node_name, np.float32(r.score).view(np.int32))
                    for r in sched.schedule_finish(pending)])
    assert out[0] == out[1] and all(n for n, _ in out[1])


def test_device_state_never_aliases_the_host_mirror():
    sched = _sched()
    sched.refresh()
    cfg, usage = sched.mirror.device_cfg_usage()
    host = sched.mirror.t.usage_arrays()["used"]
    host[0, 0] += 1.0
    assert usage["used"][0, 0].item() != host[0, 0]


def _cpu_batch():
    from kubernetes_tpu_torch.convert import tables_from_numpy
    sched = _sched()
    sched.refresh()
    pods = [workload.make_pod(tapi, i) for i in range(8)]
    from kubernetes_tpu_torch.scheduler.tensorize import PodBatchTensors
    batch = PodBatchTensors(pods, sched.mirror, sched.terms)
    batch.enable_class_scan()
    cfg, usage = sched.mirror.device_cfg_usage()
    return cfg, usage, batch.device("cpu")


def test_kernel_launchers_refuse_cpu_tensors():
    """The CUDA launchers never run the plain version: CPU tensors
    reaching them raise before any pointer is taken."""
    cfg, usage, pb = _cpu_batch()
    cls, rw, ms, carry, has_spread = kb._scan_setup(cfg, usage, pb)
    with pytest.raises(ValueError, match="CUDA"):
        kb._class_scan_cuda(cfg, pb, cls, rw, ms, carry, has_spread)


def test_kernel_launchers_check_shapes():
    cfg, usage, pb = _cpu_batch()
    cls, rw, ms, carry, has_spread = kb._scan_setup(cfg, usage, pb)
    bad = dict(carry, used=carry["used"][:, :2].contiguous())
    with pytest.raises(ValueError, match="used"):
        kb._class_scan_cuda(cfg, pb, cls, rw, ms, bad, has_spread)
    with pytest.raises(ValueError, match="seq"):
        kb._class_scan_cuda(cfg, dict(pb, seq=pb["seq"][:3]),
                            cls, rw, ms, carry, has_spread)
    with pytest.raises(ValueError, match="unique_masks"):
        kb._check_shapes(cfg, usage, cls, pb["unique_masks"][:, :5],
                         pb["unique_scores"], rw)


def test_shard_launcher_refuses_cpu_tensors_and_bad_shapes():
    """K15's launcher: CPU tensors raise before any pointer is taken, as
    do shapes it would index out of bounds; the entry refuses a shard
    count that does not divide the capacity."""
    cfg, usage, pb = _cpu_batch()
    cls, rw, ms, carry, terms = kb._scan_setup(cfg, usage, pb)
    with pytest.raises(ValueError, match="CUDA"):
        kb._shard_scan_cuda(2, cfg, pb, cls, rw, ms, carry, terms)
    with pytest.raises(ValueError, match="seq"):
        kb._shard_scan_cuda(2, cfg, dict(pb, seq=pb["seq"][:3]), cls, rw,
                            ms, carry, terms)
    with pytest.raises(ValueError, match="shards"):
        kb.schedule_batch_sharded_packed(3, cfg, usage, pb)


def test_classic_launchers_refuse_cpu_tensors_and_bad_shapes():
    """K7's and K8's launchers: CPU tensors raise before any pointer is
    taken, and shapes the kernels would index out of bounds raise."""
    cfg, usage, pb = _cpu_batch()
    pb = {k: v for k, v in pb.items() if not k.startswith("class_")}
    carry, terms = kb._carry_setup(usage, pb)
    with pytest.raises(ValueError, match="CUDA"):
        kb._pod_scan_cuda(cfg, pb, carry, terms)
    with pytest.raises(ValueError, match="req"):
        kb._pod_scan_cuda(cfg, dict(pb, req=pb["req"][:, :1]), carry, terms)
    with pytest.raises(ValueError, match="mask_idx"):
        kb._pod_scan_cuda(cfg, dict(pb, mask_idx=pb["mask_idx"][:2]), carry,
                          terms)
    with pytest.raises(ValueError, match="CUDA"):
        kb._launch("filter_score", "ktpu_filter_score", kb._FilterParams,
                   kb._FILTER_INTS, {}, {"alloc": (cfg["alloc"],
                                                   torch.float32)},
                   "filter_score")
