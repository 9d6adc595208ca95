"""The port's batch scheduler against the JAX reference, end to end.

The same seeded cluster is built in both packages' API types (128 nodes
in 16 zones, 1,024 pods of bench.py's three request shapes) and drained
through each package's BatchScheduler — the port's on the CPU, where its
kernels take their plain versions — in batches of 256, so that batches
chain on the previous batch's device usage (the chained schedule_launch
-> schedule_finish drain) or run one after another (schedule). Every pod
must land on the same node in both, with the same score bits.
"""

import numpy as np
import pytest

import kubernetes_tpu.api as japi
from kubernetes_tpu.scheduler.cache import Cache as JCache
from kubernetes_tpu.scheduler.core import BatchScheduler as JScheduler
from kubernetes_tpu.scheduler.priorities import SpreadListers as JListers

import kubernetes_tpu_torch.api as tapi
from kubernetes_tpu_torch import workload
from kubernetes_tpu_torch.scheduler.cache import Cache as TCache
from kubernetes_tpu_torch.scheduler.core import BatchScheduler as TScheduler
from kubernetes_tpu_torch.scheduler.drain import drain
from kubernetes_tpu_torch.scheduler.priorities import SpreadListers as TListers

N_NODES, N_PODS, BATCH = 128, 1024, 256


def _drain_both(variant, chain):
    js, _ = workload.build(japi, JCache, JScheduler, JListers, N_NODES,
                           variant)
    ts, _ = workload.build(tapi, TCache, TScheduler, TListers, N_NODES,
                           variant, device="cpu")
    jres = drain(js, [workload.make_pod(japi, i, variant)
                      for i in range(N_PODS)], BATCH, chain=chain)
    tres = drain(ts, [workload.make_pod(tapi, i, variant)
                      for i in range(N_PODS)], BATCH, chain=chain)
    return js, ts, jres, tres


@pytest.mark.parametrize("chain", [True, False], ids=["chained", "schedule"])
@pytest.mark.parametrize("variant", workload.VARIANTS)
def test_port_binds_what_the_reference_binds(variant, chain):
    js, ts, jres, tres = _drain_both(variant, chain)
    assert len(tres.binds) == N_PODS
    assert tres.binds == jres.binds
    for k, s in jres.scores.items():
        assert np.float32(s).view(np.int32) == \
            np.float32(tres.scores[k]).view(np.int32), k
    bound = sum(v is not None for v in tres.binds.values())
    if variant == "node-affinity":
        # only the 8 zones the pods select carry them
        assert 0 < bound < N_PODS
        for node in filter(None, tres.binds.values()):
            assert int(node.split("-")[1]) % 16 < 8
    else:
        assert bound == N_PODS
    assert tres.batches == jres.batches == N_PODS // BATCH
    if chain:
        assert tres.chained == jres.chained == N_PODS // BATCH - 1
        assert ts.chained_launches == js.chained_launches > 0
    if variant == "spread":
        # the spread groups rode the scan as carried state
        assert ts.scorer.weights.get("SelectorSpreadPriority")


def test_schedule_entry_point_matches_reference():
    """BatchScheduler.schedule, one call per batch, no commits between:
    each batch sees only the mirror's state."""
    out = {}
    for name, api, cache_cls, sched_cls, lst in (
            ("jax", japi, JCache, JScheduler, JListers),
            ("torch", tapi, TCache, TScheduler, TListers)):
        kw = {"device": "cpu"} if name == "torch" else {}
        sched, _ = workload.build(api, cache_cls, sched_cls, lst, N_NODES,
                                  "uniform", **kw)
        res = sched.schedule([workload.make_pod(api, i, "uniform")
                              for i in range(300)])
        out[name] = [(r.pod.metadata.name, r.node_name,
                      np.float32(r.score).view(np.int32)) for r in res]
    assert out["torch"] == out["jax"]
