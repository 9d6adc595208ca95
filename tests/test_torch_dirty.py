"""The port mirror's packed dirty-row scatter, against the JAX mirror.

`TensorMirror.device_cfg_usage` ships the dirty rows of all eight cfg
and usage tables and their indices in one staging buffer (one copy to the
device), then scatters them with `apply_dirty` (K3 on the card, its
plain version here). Here on the CPU, with `device="cpu"`, each package's
mirror takes the same cluster and the same node changes, and after every
scatter the port's device tables must equal the JAX mirror's bit for bit:

- dirty sets smaller than their D bucket (pad slots, dropped);
- changes to all three bool tables (node_ok, mem_pressure, valid);
- a resize (more nodes than the capacity, and a new extended-resource
  column) followed by a scatter;
- scatters in a row that reuse the bucket's staging buffers.
"""

import numpy as np
import pytest
import torch

from kubernetes_tpu import api as japi
from kubernetes_tpu.scheduler.cache import Cache as JCache
from kubernetes_tpu.scheduler.cache import Snapshot as JSnapshot
from kubernetes_tpu.scheduler.tensorize import TensorMirror as JMirror

from kubernetes_tpu_torch import api as tapi
from kubernetes_tpu_torch.scheduler.cache import Cache as TCache
from kubernetes_tpu_torch.scheduler.cache import Snapshot as TSnapshot
from kubernetes_tpu_torch.scheduler.kernels import batch as tkb
from kubernetes_tpu_torch.scheduler.tensorize import TensorMirror as TMirror


def _node(api, i, cpu="8", ready=True, unschedulable=False,
          mem_pressure=False, gpu=None):
    alloc = {"cpu": api.Quantity(cpu), "memory": api.Quantity("16Gi"),
             "pods": api.Quantity(110)}
    if gpu is not None:
        alloc["example.com/gpu"] = api.Quantity(gpu)
    conds = [api.NodeCondition(type="Ready",
                               status="True" if ready else "False")]
    if mem_pressure:
        conds.append(api.NodeCondition(type="MemoryPressure", status="True"))
    return api.Node(
        metadata=api.ObjectMeta(name=f"n{i}"),
        spec=api.NodeSpec(unschedulable=unschedulable),
        status=api.NodeStatus(capacity=dict(alloc), allocatable=dict(alloc),
                              conditions=conds))


def _pod(api, i, node, cpu="250m"):
    return api.Pod(
        metadata=api.ObjectMeta(name=f"p{i}", namespace="default"),
        spec=api.PodSpec(node_name=node, containers=[api.Container(
            name="c", image="img",
            resources=api.ResourceRequirements(
                requests={"cpu": api.Quantity(cpu),
                          "memory": api.Quantity("1Gi")}))]))


class Side:
    """One package's cache, snapshot and mirror, driven by node changes."""

    def __init__(self, api, cache_cls, snap_cls, mirror_cls, kw):
        self.api, self.cache, self.snap = api, cache_cls(), snap_cls()
        self.mirror = mirror_cls(**kw)
        self.nodes = {}

    def add(self, i, **kw):
        self.nodes[i] = _node(self.api, i, **kw)
        self.cache.add_node(self.nodes[i])

    def update(self, i, **kw):
        new = _node(self.api, i, **kw)
        self.cache.update_node(self.nodes[i], new)
        self.nodes[i] = new

    def remove(self, i):
        self.cache.remove_node(self.nodes.pop(i))

    def bind(self, i, node):
        self.cache.add_pod(_pod(self.api, i, f"n{node}"))

    def sync(self):
        """The device tables after applying the cache's dirty nodes."""
        dirty = self.cache.update_snapshot(self.snap)
        self.mirror.apply(self.snap, dirty)
        return self.mirror.device_cfg_usage()


def _sides():
    return (Side(japi, JCache, JSnapshot, JMirror, {}),
            Side(tapi, TCache, TSnapshot, TMirror, {"device": "cpu"}))


def _do(sides, method, *args, **kw):
    for s in sides:
        getattr(s, method)(*args, **kw)


def _assert_same(sides):
    (jc, ju), (tc, tu) = (s.sync() for s in sides)
    assert set(jc) == set(tc) and set(ju) == set(tu)
    for ref, got in ((jc, tc), (ju, tu)):
        for k in ref:
            r, g = np.asarray(ref[k]), got[k].numpy()
            assert r.dtype == g.dtype and r.shape == g.shape, k
            if r.dtype == np.float32:
                r, g = r.view(np.int32), g.view(np.int32)
            np.testing.assert_array_equal(g, r, err_msg=k)


def _cluster(n=20):
    sides = _sides()
    for i in range(n):
        _do(sides, "add", i)
    for i in range(0, n, 3):
        _do(sides, "bind", i, i)
    _assert_same(sides)            # the full upload
    return sides


@pytest.mark.parametrize("n_dirty", [1, 5, 9])
def test_scatter_with_pad_slots_matches_jax(n_dirty):
    sides = _cluster()
    for i in range(n_dirty):
        _do(sides, "bind", 100 + i, i)
    _assert_same(sides)
    D = 1 << max(3, (n_dirty - 1).bit_length())
    assert D > n_dirty
    assert list(sides[1].mirror._stages) == [
        (D, tuple(a.shape[1:] for a in sides[1].mirror.t.arrays().values()))]


def test_scatter_of_every_bool_table_matches_jax():
    sides = _cluster()
    _do(sides, "update", 2, unschedulable=True)     # node_ok
    _do(sides, "update", 4, ready=False)            # node_ok
    _do(sides, "update", 5, mem_pressure=True)      # mem_pressure
    _do(sides, "remove", 7)                         # valid
    _assert_same(sides)
    t = sides[1].mirror.t
    assert (t.valid & ~t.node_ok).sum() == 2 and t.valid.sum() == 19
    assert t.mem_pressure.sum() == 1
    _do(sides, "update", 5, mem_pressure=False)
    _do(sides, "add", 7)                            # the row comes back
    _assert_same(sides)


def test_scatter_after_a_resize_matches_jax():
    sides = _cluster()
    cap = sides[1].mirror.t.capacity
    for i in range(20, cap + 5):                    # past the capacity
        _do(sides, "add", i)
    _assert_same(sides)                             # the full re-upload
    assert sides[1].mirror.t.capacity > cap
    _do(sides, "bind", 500, 3)
    _do(sides, "update", 9, cpu="4")
    _assert_same(sides)                             # a scatter
    _do(sides, "add", 999, gpu="2")                 # a new column
    _assert_same(sides)
    _do(sides, "update", 999, gpu="1")
    _do(sides, "bind", 501, 10)
    _assert_same(sides)
    widths = {k[1] for k in sides[1].mirror._stages}
    assert len(widths) == 1                         # the old layout dropped


def test_scatters_in_a_row_reuse_the_staging_buffers():
    sides = _cluster()
    stages = []
    for r in range(4):
        for i in range(6):
            _do(sides, "bind", 200 + 10 * r + i, (r * 5 + i) % 20)
        _assert_same(sides)
        stages.append(dict(sides[1].mirror._stages))
    assert len(stages[0]) == 1
    assert all(s == stages[0] for s in stages)
    (stage,) = stages[0].values()
    # the device rows are a second buffer, never the host's
    assert stage.dev.data_ptr() != stage.host.data_ptr()
    assert all(v.data_ptr() >= stage.dev.data_ptr() for v in stage.d.values())


def test_packed_rows_are_contiguous_16_byte_aligned_views():
    sides = _cluster()
    _do(sides, "bind", 300, 1)
    _assert_same(sides)
    (stage,) = sides[1].mirror._stages.values()
    base = stage.dev.data_ptr()
    for k, v in stage.d.items():
        assert v.is_contiguous() and v.shape[0] == 8, k
        assert (v.data_ptr() - base) % 16 == 0, k
        assert v.untyped_storage().data_ptr() == \
            stage.dev.untyped_storage().data_ptr()
    assert stage.d["idx"].dtype == torch.int32
    assert set(stage.d) == {"idx", *sides[1].mirror.t.arrays()}


def test_apply_dirty_cpu_tensors_take_the_plain_version():
    before = dict(tkb.LAUNCHES)
    sides = _cluster()
    _do(sides, "bind", 400, 2)
    _assert_same(sides)
    assert tkb.LAUNCHES == before
