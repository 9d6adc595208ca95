"""The port's kernel functions against the JAX reference, bit for bit.

Every case makes its inputs from a seed with numpy, runs the JAX function
(jitted, as the reference's scan runs it) and the port's plain PyTorch
version on the CPU (the version the CUDA kernels K1-K3 are held against on
the card), and requires equality: assign rows equal, score and usage f32
arrays equal as bit patterns. A scheduling decision depends on those
bits, so there is no tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.scheduler.kernels import batch as jb
from kubernetes_tpu_torch.convert import tables_from_numpy, to_tensor
from kubernetes_tpu_torch.scheduler.kernels import batch as tb

GiB = float(2 ** 30)
MiB = float(2 ** 20)
CLASS_KEYS = ("class_req", "class_nz", "class_blocked", "class_mask_idx",
              "class_score_idx")


def _state(seed, N=256, R=8, C=4, M=3, S=2):
    """(node_cfg, usage, class tables) numpy dicts: bench-like capacities
    with usage near them, so fits and the score floors sit on their
    boundaries; the last 16 rows are pads (valid=False)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    alloc = np.zeros((N, R), f32)
    alloc[:, 0] = rng.choice([2000, 4000, 8000], N)
    alloc[:, 1] = rng.choice([8, 16, 32], N) * GiB
    alloc[:, 2] = 100 * GiB
    alloc[:, 3] = rng.choice([0, 4], N)
    used = np.zeros((N, R), f32)
    frac = rng.choice([0.0, 0.3, 0.7, 0.95, 1.0], (N, 1))
    used[:, 0] = np.floor(alloc[:, 0] * frac[:, 0] / 50) * 50
    used[:, 1] = np.floor(alloc[:, 1] * frac[:, 0] / MiB) * MiB
    used[:, 3] = np.minimum(alloc[:, 3], rng.integers(0, 3, N))
    nz = np.stack([used[:, 0] + rng.choice([0, 100], N),
                   used[:, 1] + rng.choice([0, 200 * MiB], N)], 1).astype(f32)
    cnt = rng.integers(0, 110, N).astype(f32)
    valid = np.arange(N) < N - 16
    node_cfg = {"alloc": alloc * valid[:, None],
                "max_pods": np.where(valid, 110, 0).astype(f32),
                "node_ok": (rng.random(N) > 0.05) & valid,
                "mem_pressure": rng.random(N) < 0.1,
                "valid": valid}
    usage = {"used": used * valid[:, None], "nonzero_used": nz,
             "pod_count": cnt}
    req = np.zeros((C, R), f32)
    req[:, 0] = rng.choice([0, 100, 250, 500, 1000], C)
    req[:, 1] = rng.choice([0, 128, 512, 1024], C) * MiB
    req[:, 3] = rng.choice([0, 0, 1], C)
    cls = {"class_req": req,
           "class_nz": np.stack([np.where(req[:, 0] > 0, req[:, 0], 100),
                                 np.where(req[:, 1] > 0, req[:, 1],
                                          200 * MiB)], 1).astype(f32),
           "class_blocked": rng.random(C) < 0.3,
           "class_mask_idx": rng.integers(0, M, C).astype(np.int32),
           "class_score_idx": rng.integers(0, S, C).astype(np.int32)}
    um = rng.random((M, N)) < 0.85
    us = np.zeros((S, N), f32)
    us[1:] = rng.integers(0, 20, (S - 1, N))
    rw = np.array([1.0, 1.0] if seed % 2 == 0 else [2.0, 1.0], f32)
    return node_cfg, usage, cls, um, us, rw


def _pods(seed, C, N, P=512, G=2, Z=8, spread=True):
    """The pod axis of one class-route batch: class ids, seq, active
    (the last 8 are pads), and SelectorSpread tables."""
    rng = np.random.default_rng(seed + 1000)
    pb = {"class_idx": rng.integers(0, C, P).astype(np.int32),
          "seq": (seed * 7919 + np.arange(P)).astype(np.int32),
          "active": np.arange(P) < P - 8}
    if spread:
        gidx = rng.integers(-1, G, P).astype(np.int32)
        match = np.zeros((P, G), np.float32)
        for i, g in enumerate(gidx):
            if g >= 0:
                match[i, g] = 1.0
                if rng.random() < 0.2:
                    match[i, (g + 1) % G] = 1.0
        pb.update({"spread_gidx": gidx, "spread_match": match,
                   "spread_base": rng.integers(0, 6, (G, N)).astype(
                       np.float32),
                   "spread_zone": rng.integers(0, 6, N).astype(np.int32),
                   "spread_zinit": np.zeros((Z,), np.float32),
                   "spread_weight": np.float32(1.0)})
    return pb


def _batch(seed, spread, P=512):
    node_cfg, usage, cls, um, us, rw = _state(seed)
    N = node_cfg["alloc"].shape[0]
    pb = dict(cls)
    pb.update({"unique_masks": um, "unique_scores": us,
               "resource_weights": rw})
    pb.update(_pods(seed, cls["class_req"].shape[0], N, P=P, spread=spread))
    return node_cfg, usage, pb


def _t(d):
    return {k: to_tensor(v, "cpu") for k, v in d.items()}


def _bits_equal(a, b):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype,
                                                       a.shape, b.shape)
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ K1 + pieces


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_class_ms_init_bit_exact(seed):
    node_cfg, usage, cls, um, us, rw = _state(seed)
    ref = jax.jit(jb._class_ms_init)(node_cfg, usage, cls, um, us, rw)
    tc, tu, _ = tables_from_numpy(node_cfg, usage, None, "cpu")
    got = tb.class_ms_init(tc, tu, _t(cls), to_tensor(um, "cpu"),
                           to_tensor(us, "cpu"), to_tensor(rw, "cpu"))
    _bits_equal(ref, got)
    # both feasible and infeasible entries are exercised
    ref = np.asarray(ref)
    assert (ref > -1e29).any() and (ref < -1e29).any()


def test_resource_score_floor_boundaries_bit_exact():
    """LeastRequested + BalancedAllocation over a grid of requests that
    land on exact-integer fractions (e.g. cpuFrac .7875 against memFrac
    .1875, where the reference's 4e-6 epsilon decides the floor)."""
    cap_cpu, req_cpu, cap_mem, req_mem = [], [], [], []
    for cc in (1000.0, 2000.0, 4000.0, 8000.0):
        for rc in np.arange(0.0, cc + 1, cc / 80):
            for cm in (4 * GiB, 16 * GiB):
                for frac in (0.0, 0.1875, 0.25, 0.5, 0.7875, 1.0):
                    cap_cpu.append(cc)
                    req_cpu.append(rc)
                    cap_mem.append(cm)
                    req_mem.append(cm * frac)
    args = [np.asarray(v, np.float32)
            for v in (cap_cpu, cap_mem, req_cpu, req_mem)]
    rw = np.ones(2, np.float32)
    ref = jax.jit(jb._class_resource_score)(*args, rw)
    got = tb.class_resource_score(*(torch.from_numpy(a) for a in args),
                                  torch.from_numpy(rw))
    _bits_equal(ref, got)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_class_col_bit_exact(seed):
    node_cfg, usage, cls, um, us, rw = _state(seed)
    fn = jax.jit(jb._class_col)
    tc, tu, _ = tables_from_numpy(node_cfg, usage, None, "cpu")
    tcls = _t(cls)
    rng = np.random.default_rng(seed)
    for b in rng.integers(0, node_cfg["alloc"].shape[0], 12):
        b = int(b)
        ref = fn(node_cfg, cls, um, us, rw, usage["used"][b],
                 usage["nonzero_used"][b], usage["pod_count"][b],
                 np.int32(b))
        got = tb.class_col(tc, tcls, to_tensor(um, "cpu"),
                           to_tensor(us, "cpu"), to_tensor(rw, "cpu"),
                           tu["used"][b], tu["nonzero_used"][b],
                           tu["pod_count"][b], torch.tensor(b))
        _bits_equal(ref, got)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spread_score_bit_exact(seed):
    rng = np.random.default_rng(seed)
    N, Z = 256, 8
    cnt = rng.integers(0, 9, N).astype(np.float32)
    fits = rng.random(N) < (0.9 if seed else 0.02)
    zone = rng.integers(0, 6 if seed != 2 else 1, N).astype(np.int32)
    zinit = np.zeros((Z,), np.float32)
    ref = jax.jit(lambda c, f, z, zi: jb._spread_score(
        c, f, z, zi, jb._zone_onehot(z, zi)))(cnt, fits, zone, zinit)
    got = tb.spread_score(torch.from_numpy(cnt), torch.from_numpy(fits),
                          torch.from_numpy(zone), torch.from_numpy(zinit))
    _bits_equal(ref, got)


@pytest.mark.parametrize("seq", [0, 40503, 2 ** 31 - 1])
def test_tie_penalized_bit_exact(seq):
    rng = np.random.default_rng(seq % 97)
    N = 4096
    masked = np.where(rng.random(N) < 0.5,
                      rng.integers(0, 30, N), -1e30).astype(np.float32)
    rows = np.arange(N, dtype=np.int32)
    ref = jax.jit(jb._tie_penalized)(masked, rows, np.int32(seq))
    got = tb.tie_penalized(torch.from_numpy(masked), torch.from_numpy(rows),
                           torch.tensor(seq, dtype=torch.int32))
    _bits_equal(ref, got)


# ------------------------------------------------------------ K2


def _run_both(node_cfg, usage, pb):
    ref_a, ref_s, ref_u = jb.schedule_batch(node_cfg, usage, pb)
    tc, tu, tpb = tables_from_numpy(node_cfg, usage, pb, "cpu")
    got_a, got_s, got_u = tb.schedule_batch(tc, tu, tpb)
    return (ref_a, ref_s, ref_u), (got_a, got_s, got_u)


def _assert_scan_equal(ref, got):
    (ref_a, ref_s, ref_u), (got_a, got_s, got_u) = ref, got
    _bits_equal(ref_a, got_a)
    _bits_equal(ref_s, got_s)
    assert set(ref_u) == set(got_u)
    for k in ref_u:
        _bits_equal(ref_u[k], got_u[k])


@pytest.mark.parametrize("spread", [False, True], ids=["plain", "spread"])
@pytest.mark.parametrize("seed", [0, 1])
def test_schedule_batch_class_route_bit_exact(seed, spread):
    node_cfg, usage, pb = _batch(seed, spread)
    ref, got = _run_both(node_cfg, usage, pb)
    _assert_scan_equal(ref, got)
    assign = np.asarray(ref[0])
    # the batch places pods
    assert (assign >= 0).sum() > 100
    # the scan leaves its inputs as they were (chained launches rely on it)
    tc, tu, tpb = tables_from_numpy(node_cfg, usage, pb, "cpu")
    tb.schedule_batch(tc, tu, tpb)
    for k in usage:
        _bits_equal(usage[k], tu[k])


@pytest.mark.parametrize("spread", [False, True], ids=["plain", "spread"])
def test_schedule_batch_chained_launch_bit_exact(spread):
    """A second launch seeded from the first's usage and spread finals,
    as a chained drain does."""
    node_cfg, usage, pb = _batch(3, spread, P=256)
    ref1, got1 = _run_both(node_cfg, usage, pb)
    _assert_scan_equal(ref1, got1)
    usage2 = {k: np.asarray(v) for k, v in ref1[2].items()}
    pb2 = dict(pb)
    pb2.update(_pods(4, pb["class_req"].shape[0],
                     node_cfg["alloc"].shape[0], P=256, spread=spread))
    if spread:
        # the chained launch keeps the anchor's spread tables
        for k in ("spread_base", "spread_zone", "spread_zinit"):
            pb2[k] = pb[k]
    ref2, got2 = _run_both(node_cfg, usage2, pb2)
    _assert_scan_equal(ref2, got2)
    # and chaining on the port's own finals gives the same bits
    tc, _, tpb2 = tables_from_numpy(node_cfg, usage, pb2, "cpu")
    got3 = tb.schedule_batch(tc, got1[2], tpb2)
    _assert_scan_equal(ref2, got3)


def test_schedule_batch_routes_outside_the_slice_raise():
    node_cfg, usage, pb = _batch(0, False, P=64)
    tc, tu, tpb = tables_from_numpy(node_cfg, usage, pb, "cpu")
    classic = {k: v for k, v in tpb.items() if k not in CLASS_KEYS}
    with pytest.raises(NotImplementedError, match="classic"):
        tb.schedule_batch(tc, tu, classic)
    with pytest.raises(NotImplementedError, match="anti"):
        tb.schedule_batch(tc, tu, dict(tpb, anti_dom=torch.zeros(8, 256)))
    with pytest.raises(NotImplementedError, match="soft"):
        tb.schedule_batch(tc, tu, dict(tpb, soft_dom=torch.zeros(8, 256)))
    with pytest.raises(NotImplementedError, match="nominated"):
        tb.schedule_batch(tc, tu, tpb, nom={"used": tu["used"]})


# ------------------------------------------------------------ K3 + packing


@pytest.mark.parametrize("n_dirty", [1, 13])
def test_apply_dirty_bit_exact_and_drops_pad_rows(n_dirty):
    node_cfg, usage, _, _, _, _ = _state(5)
    cap = node_cfg["alloc"].shape[0]
    rng = np.random.default_rng(n_dirty)
    D = 16
    idx = np.full((D,), cap, np.int32)      # pads: one past the last row
    idx[:n_dirty] = rng.choice(cap, n_dirty, replace=False)
    cfg_rows = {k: np.asarray(rng.random((D,) + v.shape[1:]) * 100,
                              v.dtype) if v.dtype != bool else
                rng.random((D,) + v.shape[1:]) < 0.5
                for k, v in node_cfg.items()}
    use_rows = {k: (rng.random((D,) + v.shape[1:]) * 100).astype(v.dtype)
                for k, v in usage.items()}
    tc, tu, _ = tables_from_numpy(node_cfg, usage, None, "cpu")
    rc, ru, _ = tables_from_numpy(cfg_rows, use_rows, None, "cpu")
    ref_c, ref_u = jax.jit(jb.apply_dirty)(
        {k: jnp.asarray(v) for k, v in node_cfg.items()},
        {k: jnp.asarray(v) for k, v in usage.items()}, idx, cfg_rows,
        use_rows)
    got_c, got_u = tb.apply_dirty(tc, tu, torch.from_numpy(idx), rc, ru)
    for k in node_cfg:
        _bits_equal(ref_c[k], got_c[k])
        # the last row (where a clamped pad would land) is untouched
        _bits_equal(node_cfg[k][-1], got_c[k][-1])
    for k in usage:
        _bits_equal(ref_u[k], got_u[k])


def test_pack_unpack_results_bit_exact():
    rng = np.random.default_rng(7)
    assign = rng.integers(-1, 300, 64).astype(np.int32)
    scores = np.where(assign >= 0, rng.random(64) * 30 - 0.0001,
                      -1e30).astype(np.float32)
    scores[0] = -0.0
    ref = jb.pack_results(assign, scores)
    got = tb.pack_results(torch.from_numpy(assign), torch.from_numpy(scores))
    _bits_equal(ref, got)
    ra, rs = jb.unpack_results(ref)
    ga, gs = tb.unpack_results(got)
    _bits_equal(ra, ga)
    _bits_equal(rs, gs)
