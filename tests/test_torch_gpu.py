"""The port's CUDA kernels against their plain versions, on the card.

Marked `gpu`: each test skips without a CUDA device (decided inside the
fixture, never at import). On the card run them with

    python -m pytest -m gpu tests/test_torch_gpu.py -q

Inputs are the seeded fixtures of the CPU parity tests; the kernel and
the plain version see the same tensors on the card and must agree bit
for bit.
"""

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch.convert import tables_from_numpy
from kubernetes_tpu_torch.scheduler.kernels import batch as kb

pytestmark = pytest.mark.gpu

MiB = float(2 ** 20)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _state(seed, N=1024, R=8, C=4, P=2048, G=2, Z=8):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    alloc = np.zeros((N, R), f32)
    alloc[:, 0] = rng.choice([2000, 4000, 8000], N)
    alloc[:, 1] = rng.choice([8, 16, 32], N) * 1024 * MiB
    frac = rng.choice([0.0, 0.3, 0.7, 0.95], N)
    used = np.zeros((N, R), f32)
    used[:, 0] = np.floor(alloc[:, 0] * frac / 50) * 50
    used[:, 1] = np.floor(alloc[:, 1] * frac / MiB) * MiB
    node_cfg = {"alloc": alloc, "max_pods": np.full(N, 110, f32),
                "node_ok": rng.random(N) > 0.05,
                "mem_pressure": rng.random(N) < 0.1,
                "valid": np.ones(N, bool)}
    usage = {"used": used, "nonzero_used": used[:, :2].copy(),
             "pod_count": rng.integers(0, 100, N).astype(f32)}
    req = np.zeros((C, R), f32)
    req[:, 0] = rng.choice([100, 250, 500], C)
    req[:, 1] = rng.choice([128, 512, 1024], C) * MiB
    gidx = rng.integers(-1, G, P).astype(np.int32)
    match = np.zeros((P, G), f32)
    match[np.arange(P)[gidx >= 0], gidx[gidx >= 0]] = 1.0
    pb = {"class_req": req, "class_nz": req[:, :2].copy(),
          "class_blocked": rng.random(C) < 0.3,
          "class_mask_idx": rng.integers(0, 2, C).astype(np.int32),
          "class_score_idx": np.zeros(C, np.int32),
          "unique_masks": rng.random((2, N)) < 0.9,
          "unique_scores": np.zeros((1, N), f32),
          "resource_weights": np.ones(2, f32),
          "class_idx": rng.integers(0, C, P).astype(np.int32),
          "seq": np.arange(P, dtype=np.int32),
          "active": np.arange(P) < P - 4,
          "spread_gidx": gidx, "spread_match": match,
          "spread_base": rng.integers(0, 5, (G, N)).astype(f32),
          "spread_zone": rng.integers(0, 6, N).astype(np.int32),
          "spread_zinit": np.zeros(Z, f32),
          "spread_weight": np.float32(1.0)}
    return node_cfg, usage, pb


def _plain(fn, *args):
    """Run `fn` with the kernels patched to their plain versions."""
    saved = (kb.class_ms_init, kb._class_scan_cuda)
    kb.class_ms_init, kb._class_scan_cuda = (kb.class_ms_init_plain,
                                             kb._class_scan_plain)
    try:
        return fn(*args)
    finally:
        kb.class_ms_init, kb._class_scan_cuda = saved


@pytest.mark.parametrize("spread", [False, True])
def test_scan_kernels_match_plain(cuda, spread):
    node_cfg, usage, pb = _state(1)
    if not spread:
        pb = {k: v for k, v in pb.items() if not k.startswith("spread_")}
    tc, tu, tpb = tables_from_numpy(node_cfg, usage, pb, cuda)
    before = dict(kb.LAUNCHES)
    packed, new_usage = kb.schedule_batch_packed(tc, tu, tpb)
    assert kb.LAUNCHES["class_scan"] == before["class_scan"] + 1
    assert kb.LAUNCHES["class_ms_init"] == before["class_ms_init"] + 1
    ref, ref_usage = _plain(kb.schedule_batch_packed, tc, tu, tpb)
    torch.cuda.synchronize()
    assert torch.equal(packed, ref)
    for k in ref_usage:
        assert torch.equal(new_usage[k].view(torch.int32),
                           ref_usage[k].view(torch.int32)), k


def test_apply_dirty_kernel_matches_plain(cuda):
    node_cfg, usage, _ = _state(2)
    cap = node_cfg["alloc"].shape[0]
    idx = np.full(16, cap, np.int32)
    idx[:5] = [3, 0, cap - 1, 17, 200]
    rng = np.random.default_rng(3)
    rows_c = {k: (rng.random((16,) + v.shape[1:]) < 0.5) if v.dtype == bool
              else (rng.random((16,) + v.shape[1:]) * 9).astype(v.dtype)
              for k, v in node_cfg.items()}
    rows_u = {k: (rng.random((16,) + v.shape[1:]) * 9).astype(v.dtype)
              for k, v in usage.items()}
    rc, ru, _ = tables_from_numpy(rows_c, rows_u, None, cuda)
    a = tables_from_numpy(node_cfg, usage, None, cuda)
    b = tables_from_numpy(node_cfg, usage, None, cuda)
    t_idx = torch.from_numpy(idx).to(cuda)
    kb.apply_dirty(a[0], a[1], t_idx, rc, ru)
    kb.apply_dirty_plain(b[0], b[1], t_idx, rc, ru)
    torch.cuda.synchronize()
    for x, y in ((a[0], b[0]), (a[1], b[1])):
        for k in x:
            assert torch.equal(x[k], y[k]), k


# ------------------------------------------------- DRF kernels K4, K5


def _drf_inputs(seed, P, T):
    """The hazard inputs of tests/test_torch_drf.py: share ties, 0.0 and
    -0.0, system-class priorities and the priorities whose negation
    wraps."""
    rng = np.random.default_rng(seed)
    prio = rng.choice(np.array([0, 0, 1000, 2_000_001_000, -2_147_483_647,
                                -2 ** 31], np.int32), P).astype(np.int32)
    shares = rng.choice(np.array([0.0, -0.0, 0.25, 1e-3, 0.5], np.float32),
                        T).astype(np.float32)
    tidx = rng.integers(0, T, P).astype(np.int32)
    pos = np.arange(P, dtype=np.int32)
    return prio, shares, tidx, pos


@pytest.mark.parametrize("T", [1, 9, 300])
def test_drf_dominant_kernel_matches_plain(cuda, T):
    from kubernetes_tpu_torch.tenancy import kernels as tk
    rng = np.random.default_rng(T)
    usage = torch.from_numpy((rng.random((T, 3)) * 1e9).astype(np.float32))
    usage[::3] = 0.0
    cap = torch.tensor([64_000.0, 0.5, 0.0])
    before = tk.LAUNCHES["drf_dominant"]
    got = tk.drf_dominant(usage.to(cuda), cap.to(cuda))
    assert tk.LAUNCHES["drf_dominant"] == before + 1
    want = tk.drf_dominant_plain(usage.to(cuda), cap.to(cuda))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("P", [64, 65, 200, 16_384])
def test_drf_order_kernel_matches_plain(cuda, P):
    from kubernetes_tpu_torch.tenancy import kernels as tk
    prio, shares, tidx, pos = (torch.from_numpy(a).to(cuda)
                               for a in _drf_inputs(P, P, 9))
    before = tk.LAUNCHES["drf_order"]
    got = tk.drf_order(prio, shares, tidx, pos)
    assert tk.LAUNCHES["drf_order"] == before + 1
    want = tk.drf_order_plain(prio, shares, tidx, pos)
    assert got.dtype == torch.int32
    assert torch.equal(got, want)
    # the CPU plain version agrees too
    assert torch.equal(got.cpu(), tk.drf_order_plain(
        prio.cpu(), shares.cpu(), tidx.cpu(), pos.cpu()))


def test_drf_order_kernel_single_tenant_keeps_pop_order(cuda):
    from kubernetes_tpu_torch.tenancy import kernels as tk
    prio, _, _, pos = _drf_inputs(5, 1000, 1)
    got = tk.drf_order(torch.from_numpy(prio).to(cuda),
                       torch.tensor([0.375], device=cuda),
                       torch.zeros(1000, dtype=torch.int32, device=cuda),
                       torch.from_numpy(pos).to(cuda)).cpu().numpy()
    assert got.tolist() == np.lexsort((pos, -prio)).tolist()
