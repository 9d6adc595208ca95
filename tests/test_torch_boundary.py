"""The port's boundary: what it imports, where it runs, what it refuses.

- kubernetes_tpu_torch and chip_smoke.py import torch and numpy, never
  jax and never the kubernetes_tpu package (checked in a fresh
  interpreter, and in the source of every module);
- an entry point with the default device runs on CUDA, and raises when
  there is none (never a quiet run on the CPU);
- batches outside this slice raise NotImplementedError instead of
  scheduling differently.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

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
    "kubernetes_tpu_torch.scheduler.scorer",
    "kubernetes_tpu_torch.scheduler.volumebinder",
    "kubernetes_tpu_torch.scheduler.queue",
    "kubernetes_tpu_torch.scheduler.drain",
    "kubernetes_tpu_torch.scheduler.kernels",
    "kubernetes_tpu_torch.scheduler.kernels.batch",
    "kubernetes_tpu_torch.scheduler.kernels.build",
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


def test_required_anti_affinity_batch_raises():
    pod = workload.make_pod(tapi, 0)
    pod.spec.affinity = tapi.Affinity(pod_anti_affinity=tapi.PodAntiAffinity(
        required_during_scheduling_ignored_during_execution=[
            tapi.PodAffinityTerm(
                label_selector=tapi.LabelSelector(
                    match_labels={"app": "bench"}),
                topology_key=tapi.wellknown.LABEL_HOSTNAME)]))
    with pytest.raises(NotImplementedError, match="slice 3"):
        _sched().schedule([pod, workload.make_pod(tapi, 1)])


def test_preferred_pod_affinity_batch_raises():
    pod = workload.make_pod(tapi, 0)
    pod.spec.affinity = tapi.Affinity(pod_anti_affinity=tapi.PodAntiAffinity(
        preferred_during_scheduling_ignored_during_execution=[
            tapi.WeightedPodAffinityTerm(
                weight=10, pod_affinity_term=tapi.PodAffinityTerm(
                    label_selector=tapi.LabelSelector(
                        match_labels={"app": "bench"}),
                    topology_key=tapi.wellknown.LABEL_HOSTNAME))]))
    with pytest.raises(NotImplementedError, match="soft"):
        _sched().schedule([pod])


def test_nominated_reservation_raises():
    nominated = NominatedPodMap()
    ghost = workload.make_pod(tapi, 99)
    nominated.add(ghost, "node-0")
    with pytest.raises(NotImplementedError, match="nominated"):
        _sched(nominated=nominated).schedule([workload.make_pod(tapi, 0)])


def test_gang_batch_raises():
    sched = _sched()

    class Gangs:
        def batch_groups(self, pods):
            return [([0], None, True)]
    sched.gang = Gangs()
    with pytest.raises(NotImplementedError, match="gang"):
        sched.schedule([workload.make_pod(tapi, 0)])


@pytest.mark.parametrize("env", [("KTPU_CLASS_SCAN", "0"),
                                 ("KTPU_SPECULATIVE", "1")])
def test_unported_kernel_switches_raise(monkeypatch, env):
    monkeypatch.setenv(*env)
    with pytest.raises(NotImplementedError):
        _sched().schedule([workload.make_pod(tapi, 0)])


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
