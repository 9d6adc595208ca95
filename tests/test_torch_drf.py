"""The DRF drain-ordering kernels of the port against the JAX package.

K4 (dominant shares) and K5 (the batch permutation) run here as their
plain PyTorch versions (CPU tensors) and must give the bits of the JAX
programs `_dominant_kernel` / `_order_kernel` on the same numpy inputs:
f32 share bits and the identical permutation, no tolerance. The inputs
carry the parity hazards of the order: ties in share and in priority,
shares of 0.0 and -0.0, system-class priorities (2,000,001,000), and
priorities whose negation wraps (-2,147,483,647 and INT32_MIN). Then the
whole `DRFAccount.order_batch` of both packages on the same pods and the
same standing load, across the device floor (64 pods).
"""

import numpy as np
import pytest
import torch

from kubernetes_tpu import api as japi
from kubernetes_tpu.tenancy import drf as jdrf
from kubernetes_tpu_torch import api as tapi
from kubernetes_tpu_torch.tenancy import drf as tdrf
from kubernetes_tpu_torch.tenancy import kernels as tk

INT32_MIN = -2 ** 31
HAZARD_PRIOS = np.array([0, 1000, 2_000_001_000, -2_147_483_647, INT32_MIN],
                        np.int32)
#: ties, both zeros, and values one ulp apart
HAZARD_SHARES = np.array([0.0, -0.0, 0.25, 0.25, 1e-3,
                          np.nextafter(np.float32(0.25), np.float32(1)),
                          0.5, 1.0], np.float32)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32).tolist()


def _jax(fn, *args):
    return np.asarray(jdrf._jit(fn)(*args))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------------ K4


@pytest.mark.parametrize("seed", range(4))
def test_dominant_plain_matches_jax_bits(seed):
    rng = np.random.default_rng(seed)
    T = int(rng.integers(1, 40))
    usage = (rng.random((T, 3)) * rng.choice([1e2, 1e4, 1e10], 3)
             ).astype(np.float32)
    usage[rng.random((T, 3)) < 0.2] = 0.0
    # capacities below 1 are floored at 1 by both
    cap = np.array([rng.choice([0.0, 0.5, 4000.0 * 16]),
                    rng.choice([1.0, 2.0 ** 35]), 0.0], np.float32)
    want = _jax(jdrf._dominant_kernel, usage, cap)
    got = tk.drf_dominant(_t(usage), _t(cap)).numpy()
    assert _bits(got) == _bits(want)
    assert _bits(got) == _bits(jdrf.dominant_shares_reference(usage, cap))


# ------------------------------------------------------------------ K5


def _order_inputs(seed, P, T=None):
    rng = np.random.default_rng(seed)
    prio = rng.choice(np.concatenate([HAZARD_PRIOS, [0, 0, 1000]]),
                      P).astype(np.int32)
    shares = HAZARD_SHARES if T is None else HAZARD_SHARES[:T]
    tidx = rng.integers(0, len(shares), P).astype(np.int32)
    pos = np.arange(P, dtype=np.int32)
    return prio, shares, tidx, pos


@pytest.mark.parametrize("P", [64, 65, 200])
@pytest.mark.parametrize("seed", range(3))
def test_order_plain_matches_jax(P, seed):
    prio, shares, tidx, pos = _order_inputs(seed, P)
    want = _jax(jdrf._order_kernel, prio, shares[tidx], pos)
    got = tk.drf_order(_t(prio), _t(shares), _t(tidx), _t(pos)).numpy()
    assert got.dtype == np.int32
    assert got.tolist() == want.tolist()
    assert got.tolist() == jdrf.drf_order_reference(
        prio, shares[tidx], pos).tolist()


def test_order_negative_zero_ties_with_zero():
    """-0.0 and 0.0 are one share: position decides between them."""
    prio = np.zeros(4, np.int32)
    shares = np.array([0.0, -0.0], np.float32)
    tidx = np.array([1, 0, 1, 0], np.int32)
    pos = np.arange(4, dtype=np.int32)
    want = _jax(jdrf._order_kernel, prio, shares[tidx], pos)
    got = tk.drf_order(_t(prio), _t(shares), _t(tidx), _t(pos)).numpy()
    assert got.tolist() == want.tolist() == [0, 1, 2, 3]


def test_order_int32_min_wraps_like_jax():
    """-INT32_MIN wraps to INT32_MIN: the lowest priority sorts FIRST in
    the reference, ahead of the system class."""
    prio = np.array([0, INT32_MIN, 2_000_001_000, -2_147_483_647, 1000],
                    np.int32)
    shares = np.zeros(1, np.float32)
    tidx = np.zeros(5, np.int32)
    pos = np.arange(5, dtype=np.int32)
    want = _jax(jdrf._order_kernel, prio, shares[tidx], pos)
    got = tk.drf_order(_t(prio), _t(shares), _t(tidx), _t(pos)).numpy()
    assert got.tolist() == want.tolist() == [1, 2, 4, 0, 3]


@pytest.mark.parametrize("P", [64, 200])
def test_order_single_tenant_keeps_pop_order_within_a_band(P):
    prio, _, _, pos = _order_inputs(7, P)
    shares = np.array([0.375], np.float32)
    tidx = np.zeros(P, np.int32)
    got = tk.drf_order(_t(prio), _t(shares), _t(tidx), _t(pos)).numpy()
    assert got.tolist() == _jax(jdrf._order_kernel, prio, shares[tidx],
                                pos).tolist()
    for band in np.unique(prio):
        in_band = [int(i) for i in got if prio[i] == band]
        assert in_band == sorted(in_band)


def test_order_repeated_positions_break_ties_by_index():
    """A stable lexsort: equal keys keep their input order."""
    prio = np.array([5, 5, 5, 1], np.int32)
    shares = np.array([0.5], np.float32)
    tidx = np.zeros(4, np.int32)
    pos = np.array([2, 1, 1, 0], np.int32)
    got = tk.drf_order(_t(prio), _t(shares), _t(tidx), _t(pos)).numpy()
    assert got.tolist() == np.lexsort(
        (pos, shares[tidx], -prio)).tolist() == [1, 2, 0, 3]


def test_wrappers_check_shapes_and_devices():
    with pytest.raises(ValueError, match="agree"):
        tk.drf_dominant(torch.zeros(3, 3), torch.ones(2))
    with pytest.raises(ValueError, match="tidx"):
        tk.drf_order(torch.zeros(4, dtype=torch.int32), torch.zeros(1),
                     torch.zeros(3, dtype=torch.int32),
                     torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="device"):
        tk.drf_dominant(torch.empty((2, 3), device="meta"),
                        torch.empty((3,), device="meta"))


def test_cuda_launch_refuses_cpu_tensors(monkeypatch):
    """The CUDA route never takes the plain version: a CPU tensor that
    reaches the launch raises before any pointer is taken."""
    from kubernetes_tpu_torch.scheduler.kernels import batch as kb
    monkeypatch.setattr(tk, "_on_cuda", lambda t: True)
    with pytest.raises(ValueError, match="CUDA"):
        tk.drf_dominant(torch.zeros(2, 3), torch.ones(3))
    with pytest.raises(ValueError, match="CUDA"):
        tk.drf_order(torch.zeros(4, dtype=torch.int32), torch.zeros(1),
                     torch.zeros(4, dtype=torch.int32),
                     torch.zeros(4, dtype=torch.int32))
    assert kb._on_cuda(torch.zeros(1)) is False


# ------------------------------------------------------- DRFAccount


def _pod(api, i, tenant, prio, shape):
    cpu = ["100m", "250m", "500m", "2"][shape]
    mem = ["128Mi", "512Mi", "1Gi", "4Gi"][shape]
    return api.Pod(
        metadata=api.ObjectMeta(
            name=f"pod-{i}", namespace=f"ns-{i % 2}",
            labels={jdrf.TENANT_LABEL: tenant} if tenant else {}),
        spec=api.PodSpec(priority=int(prio), containers=[api.Container(
            name="c", image="img", resources=api.ResourceRequirements(
                requests={"cpu": api.Quantity(cpu),
                          "memory": api.Quantity(mem)}))]))


def _accounts(seed, P, n_tenants):
    """The same standing load and the same popped batch, in both
    packages' types."""
    rng = np.random.default_rng(seed)
    tenants = [f"t{k}" for k in range(n_tenants)] + [None]
    loads = [(int(rng.integers(0, len(tenants))), int(rng.integers(0, 4)))
             for _ in range(3 * n_tenants)]
    batch = [(int(rng.integers(0, len(tenants))),
              int(rng.choice(HAZARD_PRIOS[:4])), int(rng.integers(0, 4)))
             for _ in range(P)]
    out = []
    for api, mod, kw in ((japi, jdrf, {}), (tapi, tdrf, {"device": "cpu"})):
        acct = mod.DRFAccount(**kw)
        acct.set_capacity([64_000.0, 256.0 * 2 ** 30, 0.0])
        for j, (t, shape) in enumerate(loads):
            acct.charge(_pod(api, 10_000 + j, tenants[t], 0, shape))
        pods = [_pod(api, i, tenants[t], p, shape)
                for i, (t, p, shape) in enumerate(batch)]
        out.append((acct, pods))
    return out


@pytest.mark.parametrize("P", [10, 64, 65, 200])
@pytest.mark.parametrize("n_tenants", [1, 9])
def test_order_batch_matches_jax(P, n_tenants):
    (ja, jpods), (ta, tpods) = _accounts(P + n_tenants, P, n_tenants)
    want = [p.metadata.name for p in ja.order_batch(jpods)]
    got = [p.metadata.name for p in ta.order_batch(tpods)]
    assert got == want
    assert got == [p.metadata.name for p in ta.order_batch_reference(tpods)]
    assert _bits(ta.dominant_shares()) == _bits(ja.dominant_shares())
    assert ta.report() == ja.report()
    assert ta.overshare_ranks() == ja.overshare_ranks()


def test_release_returns_the_charged_vector():
    (ja, jpods), (ta, tpods) = _accounts(3, 8, 3)
    for acct, pods in ((ja, jpods), (ta, tpods)):
        for p in pods[:4]:
            acct.charge(p)
        acct.charge(pods[0])         # idempotent by key
        acct.release(pods[1])
    assert ta.report() == ja.report()


def test_account_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdrf.DRFAccount()
    assert tdrf.DRFAccount(device="cpu").device.type == "cpu"
