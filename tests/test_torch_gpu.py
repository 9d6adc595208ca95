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

from kubernetes_tpu_torch.convert import (nom_from_numpy, tables_from_numpy,
                                           victim_tables_from_numpy)
from kubernetes_tpu_torch.scheduler.kernels import batch as kb
from kubernetes_tpu_torch.scheduler.kernels import preempt as pk
from kubernetes_tpu_torch.scheduler.kernels import speculative as sk

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
    saved = (kb.class_ms_init, kb._class_scan_cuda, kb._pod_scan_cuda)
    kb.class_ms_init, kb._class_scan_cuda, kb._pod_scan_cuda = (
        kb.class_ms_init_plain, kb._class_scan_plain, kb._pod_scan_plain)
    try:
        return fn(*args)
    finally:
        kb.class_ms_init, kb._class_scan_cuda, kb._pod_scan_cuda = saved


CLASS_TABLES = ("class_req", "class_nz", "class_blocked", "class_mask_idx",
                "class_score_idx", "class_idx")


def _classic(pb):
    """The same batch without class tables: each pod's rows taken from
    its class, as tensorize builds them (the classic route's input)."""
    ci = pb["class_idx"]
    out = {k: v for k, v in pb.items() if k not in CLASS_TABLES}
    out.update(req=pb["class_req"][ci], nonzero_req=pb["class_nz"][ci],
               mem_pressure_blocked=pb["class_blocked"][ci],
               mask_idx=pb["class_mask_idx"][ci],
               score_idx=pb["class_score_idx"][ci])
    return out


def _nom(node_cfg, usage, pb, seed):
    """Phantom reservations on a quarter of the rows, every 64th row
    reserved to its allocatable, and every 16th pod holding its own
    nomination (the self-exemption rows), half of them on a fully
    reserved row."""
    rng = np.random.default_rng(seed + 70)
    N, R = node_cfg["alloc"].shape
    P = pb["class_idx"].shape[0]
    req = pb["class_req"]
    used = np.zeros((N, R), np.float32)
    count = np.zeros((N,), np.float32)
    for row in range(0, N, 4):
        for _ in range(int(rng.integers(1, 3))):
            used[row] += req[int(rng.integers(0, req.shape[0]))]
            count[row] += 1.0
    full = np.arange(0, N, 64)
    used[full] = node_cfg["alloc"][full] - usage["used"][full]
    nom_row = np.full((P,), -1, np.int32)
    for j, p in enumerate(range(0, P, 16)):
        row = int(full[j % len(full)]) if j % 2 else int(
            rng.integers(0, N))
        nom_row[p] = row
        if j % 2 == 0:
            used[row] += req[pb["class_idx"][p]]
        count[row] += 1.0
    pb["nom_row"] = nom_row
    return {"used": used, "count": count}


def _lists(rng, n_terms, P, K, frac):
    out = rng.integers(0, n_terms, (P, K)).astype(np.int32)
    out[rng.random((P, K)) >= frac] = -1
    return out


def _dom(rng, n_terms, T, N):
    """Even terms on hostname (domain = row), odd ones on 16 zones; a
    tenth of the nodes lack the label; pad term rows are -1."""
    dom = np.full((T, N), -1, np.int32)
    for t in range(n_terms):
        dom[t] = np.arange(N) if t % 2 == 0 else np.arange(N) % 16
        dom[t, rng.random(N) < 0.1] = -1
    return dom


def _affinity(pb, seed, topo=False, dir2=False, soft=False):
    """The in-scan tables of tests/test_torch_affinity.py at the card's
    size: 100 self-anti colors (T 128, D 1024, K 2) with waived affinity
    and direction-2 lists; 16 soft channels (Ts 16, Ds 1024, Ks 2) with
    signed read weights."""
    rng = np.random.default_rng(seed + 50)
    P, N = pb["class_idx"].shape[0], pb["unique_masks"].shape[1]
    if topo:
        color = rng.integers(0, 100, P).astype(np.int32)
        anti = _lists(rng, 100, P, 2, 0.0)
        anti[:, 0] = np.where(rng.random(P) < 0.8, color, -1)
        match = _lists(rng, 100, P, 2, 0.3)
        match[:, 0] = color
        pb.update({"anti_dom": _dom(rng, 100, 128, N),
                   "anti_cnt0": np.zeros((128, 1024), np.float32),
                   "anti_tids": anti, "aff_tids": _lists(rng, 100, P, 2,
                                                         0.1),
                   "match_tids": match})
        if dir2:
            pb["cmatch_tids"] = _lists(rng, 100, P, 2, 0.2)
            pb["canti_tids"] = _lists(rng, 100, P, 2, 0.2)
    if soft:
        base_idx = rng.integers(0, 3, P).astype(np.int32)
        base_idx[::5] = -1
        pb.update({
            "soft_dom": _dom(rng, 16, 16, N),
            "soft_cnt0": np.zeros((16, 1024), np.float32),
            "soft_base": rng.integers(-20, 21, (4, N)).astype(np.float32),
            "soft_base_idx": base_idx,
            "soft_read_tids": _lists(rng, 16, P, 2, 0.7),
            "soft_read_w": rng.choice([10.0, -10.0, 1.0, -1.0], (P, 2))
            .astype(np.float32),
            "soft_write_tids": _lists(rng, 16, P, 2, 0.7),
            "soft_write_w": rng.choice([1.0, 10.0], (P, 2)).astype(
                np.float32),
            "soft_weight": np.float32(2.0)})
    return pb


#: (spread, topo, dir2, soft): every K2 instance, dir2 with and without
INSTANCES = [(False, False, False, False), (True, False, False, False),
             (False, True, False, False), (False, True, True, False),
             (False, False, False, True), (True, False, False, True),
             (False, True, True, True), (True, True, False, False),
             (True, True, True, True)]


@pytest.mark.parametrize("spread,topo,dir2,soft", INSTANCES)
def test_scan_kernels_match_plain(cuda, spread, topo, dir2, soft):
    node_cfg, usage, pb = _state(1)
    if not spread:
        pb = {k: v for k, v in pb.items() if not k.startswith("spread_")}
    pb = _affinity(pb, 1, topo, dir2, soft)
    tc, tu, tpb = tables_from_numpy(node_cfg, usage, pb, cuda)
    name = kb.scan_instance(spread, topo, soft)
    before = dict(kb.LAUNCHES)
    packed, new_usage = kb.schedule_batch_packed(tc, tu, tpb)
    assert kb.LAUNCHES[name] == before[name] + 1
    assert kb.LAUNCHES["class_ms_init"] == before["class_ms_init"] + 1
    ref, ref_usage = _plain(kb.schedule_batch_packed, tc, tu, tpb)
    torch.cuda.synchronize()
    assert torch.equal(packed, ref)
    assert set(new_usage) == set(ref_usage)
    for k in ref_usage:
        assert torch.equal(new_usage[k].view(torch.int32),
                           ref_usage[k].view(torch.int32)), k
    assert (packed[0] >= 0).sum() > 1000


@pytest.mark.parametrize("spread,topo,dir2,soft", INSTANCES)
def test_nominated_scan_kernels_match_plain(cuda, spread, topo, dir2, soft):
    """K1's nominated fold and each K2 instance with the NOM overlay (the
    self-exempt rows, the winner column refreshed with the reservations)
    against the plain versions."""
    node_cfg, usage, pb = _state(3)
    if not spread:
        pb = {k: v for k, v in pb.items() if not k.startswith("spread_")}
    pb = _affinity(pb, 3, topo, dir2, soft)
    nom = _nom(node_cfg, usage, pb, 3)
    tc, tu, tpb = tables_from_numpy(node_cfg, usage, pb, cuda)
    tnom = nom_from_numpy(nom, cuda)
    name = kb.scan_instance(spread, topo, soft, True)
    before = dict(kb.LAUNCHES)
    packed, new_usage = kb.schedule_batch_packed(tc, tu, tpb, tnom)
    assert kb.LAUNCHES[name] == before[name] + 1
    ref, ref_usage = _plain(kb.schedule_batch_packed, tc, tu, tpb, tnom)
    torch.cuda.synchronize()
    assert torch.equal(packed, ref)
    for k in ref_usage:
        assert torch.equal(new_usage[k].view(torch.int32),
                           ref_usage[k].view(torch.int32)), k
    # the overlay decided something: the same batch without it differs
    free, _ = kb.schedule_batch_packed(tc, tu, tpb)
    assert not torch.equal(free[0], packed[0])


def _speculative(pb):
    """The batch as set_speculative marks it, with the carried-term reads
    kept only on pods p % 64 < 4 (so some cohorts may land in one shot and
    the rest repair) and every write kept (match and carry lists, credit
    writes, spread_match): spec_plain true iff the pod reads no carried
    term and holds no nomination of its own."""
    P = pb["class_idx"].shape[0]
    off = np.arange(P) % 64 >= 4
    for k in ("anti_tids", "aff_tids", "cmatch_tids"):
        if k in pb:
            pb[k] = np.where(off[:, None], -1, pb[k]).astype(np.int32)
    for k in ("spread_gidx", "soft_base_idx"):
        if k in pb:
            pb[k] = np.where(off, -1, pb[k]).astype(np.int32)
    plain = np.ones(P, bool)
    if "nom_row" in pb:
        plain &= pb["nom_row"] < 0
    for k in ("anti_tids", "aff_tids", "cmatch_tids"):
        if k in pb:
            plain &= (pb[k] < 0).all(axis=1)
    for k in ("spread_gidx", "soft_base_idx"):
        if k in pb:
            plain &= pb[k] < 0
    pb["spec_plain"] = plain
    return pb


def _spec_case(cuda, seed, spread, topo, dir2, soft, nom):
    node_cfg, usage, pb = _state(seed)
    if not spread:
        pb = {k: v for k, v in pb.items() if not k.startswith("spread_")}
    pb = _affinity(pb, seed, topo, dir2, soft)
    tnom = nom_from_numpy(_nom(node_cfg, usage, pb, seed), cuda) if nom \
        else None
    tc, tu, tpb = tables_from_numpy(node_cfg, usage, _speculative(pb), cuda)
    return tc, tu, tpb, tnom


@pytest.mark.parametrize("nom", [False, True])
@pytest.mark.parametrize("spread,topo,dir2,soft", INSTANCES)
def test_spec_scan_kernel_matches_k2_and_plain(cuda, spread, topo, dir2,
                                               soft, nom):
    """K12, each instance with and without the nominated overlay, on a
    mixed batch (cohorts of 8): assign, the active pods' score bits and
    every post-batch usage table equal to K2's on the same batch, and
    everything, stats included, equal to its plain version on the card.
    (A padding pod is never checked for collisions: its score is the one
    of its frozen pick, as in the JAX speculative kernel, where the serial
    scan's may differ.)"""
    tc, tu, tpb, tnom = _spec_case(cuda, 6, spread, topo, dir2, soft, nom)
    name = kb.scan_instance(spread, topo, soft, nom, "spec_scan")
    before = dict(sk.LAUNCHES)
    packed, use, stats = sk.schedule_batch_speculative_packed(
        tc, tu, tpb, tnom, width=8)
    assert sk.LAUNCHES[name] == before[name] + 1
    serial, serial_use = kb.schedule_batch_packed(tc, tu, tpb, tnom)
    a, sc, p_use, p_stats = sk.schedule_batch_speculative_plain(
        tc, tu, tpb, tnom, width=8)
    torch.cuda.synchronize()
    active = tpb["active"]
    assert torch.equal(packed[0], serial[0])
    assert torch.equal(packed[1][active], serial[1][active])
    assert torch.equal(packed, kb.pack_results(a, sc))
    assert torch.equal(stats, p_stats)
    assert set(use) == set(serial_use) == set(p_use)
    for k in use:
        for other in (serial_use, p_use):
            assert torch.equal(use[k].view(torch.int32),
                               other[k].view(torch.int32)), k
    assert (packed[0] >= 0).sum() > 1000
    # some cohorts repaired (the first of every 64 pods reads terms, or
    # holds a nomination)
    assert not bool(stats[:, 0].all())


@pytest.mark.parametrize("width", [8, 32])
def test_spec_scan_kernel_accepts_clean_cohorts(cuda, width):
    """The uniform shape the class route sees most: one class on empty
    nodes, no carried term. Cohorts land in one shot (accepted), K12
    equals K2 and its plain version."""
    node_cfg, usage, pb = _state(7)
    pb = {k: v for k, v in pb.items() if not k.startswith("spread_")}
    for k in usage:
        usage[k][:] = 0
    node_cfg["node_ok"][:] = True
    node_cfg["mem_pressure"][:] = False
    pb["class_idx"][:] = 0
    pb["class_mask_idx"][0] = 0
    pb["unique_masks"][0] = True
    tc, tu, tpb = tables_from_numpy(node_cfg, usage, _speculative(pb), cuda)
    packed, use, stats = sk.schedule_batch_speculative_packed(
        tc, tu, tpb, width=width)
    serial, serial_use = kb.schedule_batch_packed(tc, tu, tpb)
    a, sc, _, p_stats = sk.schedule_batch_speculative_plain(
        tc, tu, tpb, width=width)
    torch.cuda.synchronize()
    active = tpb["active"]
    assert torch.equal(packed[0], serial[0])
    assert torch.equal(packed[1][active], serial[1][active])
    assert torch.equal(packed, kb.pack_results(a, sc))
    assert torch.equal(stats, p_stats)
    for k in use:
        assert torch.equal(use[k].view(torch.int32),
                           serial_use[k].view(torch.int32)), k
    assert bool(stats[:, 0].any())


@pytest.mark.parametrize("nom", [False, True])
@pytest.mark.parametrize("spread,topo,dir2,soft", INSTANCES)
def test_pod_scan_kernels_match_plain(cuda, spread, topo, dir2, soft, nom):
    """K7, each instance with and without the nominated overlay, against
    its plain version on the card (packed results and every post-batch
    usage table bit for bit), and deciding as K2 does on the same batch
    with class tables."""
    node_cfg, usage, pb = _state(4)
    if not spread:
        pb = {k: v for k, v in pb.items() if not k.startswith("spread_")}
    pb = _affinity(pb, 4, topo, dir2, soft)
    tnom = nom_from_numpy(_nom(node_cfg, usage, pb, 4), cuda) if nom \
        else None
    tc, tu, tpb = tables_from_numpy(node_cfg, usage, _classic(pb), cuda)
    name = kb.scan_instance(spread, topo, soft, nom, "pod_scan")
    before = dict(kb.LAUNCHES)
    packed, new_usage = kb.schedule_batch_packed(tc, tu, tpb, tnom)
    assert kb.LAUNCHES[name] == before[name] + 1
    assert kb.LAUNCHES["class_ms_init"] == before["class_ms_init"]
    ref, ref_usage = _plain(kb.schedule_batch_packed, tc, tu, tpb, tnom)
    torch.cuda.synchronize()
    assert torch.equal(packed, ref)
    assert set(new_usage) == set(ref_usage)
    for k in ref_usage:
        assert torch.equal(new_usage[k].view(torch.int32),
                           ref_usage[k].view(torch.int32)), k
    assert (packed[0] >= 0).sum() > 1000
    _, _, cpb = tables_from_numpy(node_cfg, usage, pb, cuda)
    by_class, _ = kb.schedule_batch_packed(tc, tu, cpb, tnom)
    assert torch.equal(by_class[0], packed[0])


@pytest.mark.parametrize("spread", [False, True])
def test_filter_score_kernel_matches_plain(cuda, spread):
    """K8 against filter_score_plain on the card: fits equal, masked
    score bits equal."""
    node_cfg, usage, pb = _state(5)
    if not spread:
        pb = {k: v for k, v in pb.items() if not k.startswith("spread_")}
    tc, tu, tpb = tables_from_numpy(node_cfg, usage, _classic(pb), cuda)
    name = "filter_score" + "_spread" * spread
    before = kb.LAUNCHES[name]
    fits, score = kb.filter_score(tc, tu, tpb)
    assert kb.LAUNCHES[name] == before + 1
    ref_fits, ref_score = kb.filter_score_plain(tc, tu, tpb)
    torch.cuda.synchronize()
    assert torch.equal(fits, ref_fits)
    assert torch.equal(score.view(torch.int32), ref_score.view(torch.int32))
    assert 0 < int(fits.sum()) < fits.numel()


def _storm_tables(n_nodes, preemptor):
    from kubernetes_tpu_torch import api, workload
    from kubernetes_tpu_torch.scheduler.cache import Cache, Snapshot
    cache, pdbs = workload.storm_cache(api, Cache, n_nodes)
    snap = Snapshot()
    cache.update_snapshot(snap)
    infos = snap.node_infos
    return pk.build_victim_tables(workload.storm_preemptor(api, preemptor),
                                  sorted(infos.items()), infos, pdbs).arrays


def _wide_tables(V, R=2, seed=0, fit_at_boundary=True):
    """Rows of V units whose freed bytes make the prefix sums inexact, the
    free space set so the preemptor fits at a boundary unit (the fixture
    of tests/test_torch_preempt.py's prefix-order test), with extended
    scalar columns when R > 2."""
    rng = np.random.default_rng(seed)
    n, f32 = 300, np.float32
    freed = rng.integers(10**8, 2 * 10**9, (n, V, R)).astype(f32)
    seq = np.cumsum(freed, axis=1, dtype=f32)
    t = rng.integers(0, V, n)
    need = np.full((R,), f32(3e9))
    top = rng.integers(2 * 10**9 - 100, 2 * 10**9, (n, V)).astype(np.int32)
    free0 = (need[None, :] - seq[np.arange(n), t]).astype(f32)
    if not fit_at_boundary:
        free0 -= f32(1e12)
    valid = rng.random((n, V)) < 0.95
    N = 512
    pad = N - n

    def rows(x, fill=0):
        return np.concatenate([x, np.full((pad,) + x.shape[1:], fill,
                                          x.dtype)])
    return {"free0": rows(free0), "cfree0": np.zeros(N, f32), "need": need,
            "need_cnt": f32(1), "freed": rows(freed),
            "fcnt": rows(np.ones((n, V), f32)), "valid": rows(valid),
            "pdb": rows(rng.random((n, V)) < 0.1), "top": rows(top, -2**31),
            "psum": rows(top.astype(f32)),
            "gcnt": rows(np.ones((n, V), np.int32)),
            "startr": rows(rng.integers(0, 50, (n, V)).astype(np.int32), -1),
            "row_valid": np.arange(N) < n}


PRICE_CASES = {"storm-512": lambda: _storm_tables(512, 0),
               "storm-5000": lambda: _storm_tables(5000, 3),
               "wide-32": lambda: _wide_tables(32),
               "wide-128-scalars": lambda: _wide_tables(128, R=4, seed=1),
               "nothing-fits": lambda: _wide_tables(16, fit_at_boundary=False),
               # the narrow instance at its caps, then the wide one past
               # them (V = 2,048: bench.py's 1,200-pod wide node; R to 64)
               "narrow-1024-r16": lambda: _wide_tables(1024, R=16, seed=2),
               "wide-2048": lambda: _wide_tables(2048, seed=3),
               "wide-64-r24": lambda: _wide_tables(64, R=24, seed=4),
               "wide-2048-r64": lambda: _wide_tables(2048, R=64, seed=5)}


@pytest.mark.parametrize("case", sorted(PRICE_CASES))
def test_price_nodes_kernel_matches_plain(cuda, case):
    """K6 against price_nodes_plain on the card: winner, chosen, k and
    nviol equal."""
    a = victim_tables_from_numpy(PRICE_CASES[case](), cuda)
    args = [a[k] for k in pk.PRICE_KEYS]
    before = pk.LAUNCHES["price_nodes"]
    got = pk.price_nodes(*args)
    assert pk.LAUNCHES["price_nodes"] == before + 1
    ref = pk.price_nodes_plain(*args)
    torch.cuda.synchronize()
    for name, x, y in zip(("winner", "chosen", "k", "nviol"), got, ref):
        assert x.dtype == y.dtype and torch.equal(x, y), name
    assert (int(got[0]) < 0) == (case == "nothing-fits")


def test_soft_chained_launch_matches_plain(cuda):
    """A second launch seeded from the first one's soft credit finals."""
    node_cfg, usage, pb = _state(2)
    pb = _affinity(pb, 2, soft=True)
    tc, tu, tpb = tables_from_numpy(node_cfg, usage, pb, cuda)
    _, use1 = kb.schedule_batch_packed(tc, tu, tpb)
    assert use1["soft_cnt"].any()
    tpb2 = dict(tpb, seq=tpb["seq"] + tpb["seq"].shape[0])
    packed, use2 = kb.schedule_batch_packed(tc, use1, tpb2)
    ref, ref2 = _plain(kb.schedule_batch_packed, tc, use1, tpb2)
    torch.cuda.synchronize()
    assert torch.equal(packed, ref)
    for k in ref2:
        assert torch.equal(use2[k].view(torch.int32),
                           ref2[k].view(torch.int32)), k


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


@pytest.mark.parametrize("P", [4, 64, 1000])
def test_drf_order_kernel_nan_shares_give_a_permutation(cuda, P):
    """NaN shares sort after every number and tie with one another; the
    result is a permutation equal to the plain version's (which the CPU
    tests hold against JAX's lexsort)."""
    from kubernetes_tpu_torch.tenancy import kernels as tk
    if P == 4:
        prio = np.zeros(4, np.int32)
        shares = np.array([0.5, np.nan, 0.1, 0.5], np.float32)
        tidx = np.arange(4, dtype=np.int32)
    else:
        prio, _, tidx, _ = _drf_inputs(P, P, 9)
        shares = np.array([np.nan, 0.0, -0.0, 0.25, np.nan, 0.25, -np.nan,
                           1e-3, 0.5], np.float32)
    pos = np.arange(P, dtype=np.int32)
    args = [torch.from_numpy(a).to(cuda) for a in (prio, shares, tidx, pos)]
    got = tk.drf_order(*args)
    want = tk.drf_order_plain(*args)
    assert sorted(got.cpu().tolist()) == list(range(P))
    assert torch.equal(got, want)
    if P == 4:
        assert got.cpu().tolist() == [2, 0, 3, 1]


def test_drf_order_kernel_single_tenant_keeps_pop_order(cuda):
    from kubernetes_tpu_torch.tenancy import kernels as tk
    prio, _, _, pos = _drf_inputs(5, 1000, 1)
    got = tk.drf_order(torch.from_numpy(prio).to(cuda),
                       torch.tensor([0.375], device=cuda),
                       torch.zeros(1000, dtype=torch.int32, device=cuda),
                       torch.from_numpy(pos).to(cuda)).cpu().numpy()
    assert got.tolist() == np.lexsort((pos, -prio)).tolist()


# ------------------------------------------------------------ gangs


def _gang_instance(seed, cap, soft, nom, N=512, P=256):
    """A gang batch of 16 gangs of 8 (half on one of 6 domains), 16 of 4
    and singletons, in kernels/gang.py's entry layout, with the capacity
    gate's need / greq (`cap`), soft credits and the nominated overlay
    (pods holding their own nomination)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    R = 3
    node_cfg = {"alloc": rng.uniform(1000, 8000, (N, R)).astype(f32),
                "max_pods": np.full((N,), 10, f32),
                "node_ok": rng.random(N) > 0.05,
                "mem_pressure": rng.random(N) > 0.9,
                "valid": np.ones((N,), bool)}
    usage = {"used": rng.uniform(0, 4000, (N, R)).astype(f32),
             "nonzero_used": rng.uniform(0, 4000, (N, 2)).astype(f32),
             "pod_count": rng.integers(0, 8, (N,)).astype(f32)}
    pb = {"req": rng.uniform(100, 2500, (P, R)).astype(f32),
          "nonzero_req": rng.uniform(100, 2500, (P, 2)).astype(f32),
          "mem_pressure_blocked": rng.random(P) > 0.8,
          "active": np.arange(P) < P - 3,
          "seq": np.arange(P, dtype=np.int32),
          "mask_idx": rng.integers(0, 3, (P,)).astype(np.int32),
          "score_idx": np.zeros((P,), np.int32),
          "nom_row": np.full((P,), -1, np.int32),
          "unique_masks": rng.random((3, N)) > 0.2,
          "unique_scores": rng.integers(0, 3, (1, N)).astype(f32),
          "resource_weights": np.ones((2,), f32)}
    dom_tab = rng.integers(-1, 6, (2, N)).astype(np.int32)
    keys = ("pod_idx", "start", "end", "gang_id", "entry_dom_idx",
            "pin_dom")
    gt = {k: [] for k in keys}
    need, greq = [], []
    order = list(rng.permutation(P))
    units = [8] * 16 + [4] * 16
    units += [1] * (P - sum(units))
    for u, size in enumerate(units):
        members = [order.pop() for _ in range(size)]
        d = int(rng.integers(0, 2)) if size == 8 and u % 2 == 0 else -1
        pin = 3 if d >= 0 and u % 8 == 0 else -1
        for j, i in enumerate(members):
            for k, v in zip(keys, (i, j == 0, j == size - 1, u, d, pin)):
                gt[k].append(v)
            need.append(size)
            greq.append(pb["req"][members].max(axis=0))
    gt = {k: np.asarray(v, np.int32 if k not in ("start", "end") else bool)
          for k, v in gt.items()}
    gt["dom_tab"] = dom_tab
    if cap:
        gt["need"] = np.asarray(need, f32)
        gt["greq"] = np.stack(greq).astype(f32)
    if soft:
        Ts, Ks, Ds, Sb = 4, 2, 8, 2
        pb.update(
            soft_dom=rng.integers(-1, Ds, (Ts, N)).astype(np.int32),
            soft_cnt0=rng.integers(0, 3, (Ts, Ds)).astype(f32),
            soft_base=rng.integers(-5, 6, (Sb, N)).astype(f32),
            soft_base_idx=rng.integers(-1, Sb, (P,)).astype(np.int32),
            soft_read_tids=rng.integers(-1, Ts, (P, Ks)).astype(np.int32),
            soft_read_w=rng.integers(-3, 4, (P, Ks)).astype(f32),
            soft_write_tids=rng.integers(-1, Ts, (P, Ks)).astype(np.int32),
            soft_write_w=rng.integers(0, 4, (P, Ks)).astype(f32),
            soft_weight=np.float32(1.0))
    nom_t = None
    if nom:
        nom_t = {"used": rng.uniform(0, 800, (N, R)).astype(f32),
                 "count": rng.integers(0, 2, (N,)).astype(f32)}
        pb["nom_row"][:40] = rng.integers(0, N, (40,))
    return node_cfg, usage, pb, gt, nom_t


@pytest.mark.parametrize("cap", [False, True])
@pytest.mark.parametrize("soft", [False, True])
@pytest.mark.parametrize("nom", [False, True])
def test_gang_scan_kernel_matches_plain(cuda, cap, soft, nom):
    """Every K9 instance against gang_schedule_plain: assign, the score
    bits of every pod and the committed usage bits."""
    from kubernetes_tpu_torch.convert import gang_table_from_numpy
    from kubernetes_tpu_torch.scheduler.kernels import gang as gk
    nc, us, pb, gt, nm = _gang_instance(int(cap) + 2 * soft + 4 * nom, cap,
                                        soft, nom)
    c, u, p = tables_from_numpy(nc, us, pb, cuda)
    g = gang_table_from_numpy(gt, cuda)
    n = nom_from_numpy(nm, cuda)
    name = gk.gang_instance(cap, soft, nom)
    before = gk.LAUNCHES[name]
    packed_k, use_k = gk.gang_schedule_packed(c, u, p, g, n)
    assert gk.LAUNCHES[name] == before + 1
    carry, _ = kb._carry_setup(u, p)
    packed_p = gk.gang_schedule_plain(c, p, g, carry, n)
    torch.cuda.synchronize()
    assert torch.equal(packed_k, packed_p)
    assert set(use_k) == set(carry)
    for k in carry:
        assert torch.equal(use_k[k].view(torch.int32),
                           carry[k].view(torch.int32)), k
    assert (packed_k[0] >= 0).any() and (packed_k[0] < 0).any()


@pytest.mark.parametrize("cap", [False, True])
def test_gang_scan_kernel_exempt_mates_matches_plain(cuda, cap):
    """K9 with the overlay's own-gang exemption, as the core launches it:
    every gang's members hold reservations, several on one node, and
    read the overlay less their unit's; singletons keep their own."""
    from kubernetes_tpu_torch.convert import gang_table_from_numpy
    from kubernetes_tpu_torch.scheduler.kernels import gang as gk
    nc, us, pb, gt, nm = _gang_instance(11 + int(cap), cap, True, True)
    rng = np.random.default_rng(3)
    multi = ~(gt["start"] & gt["end"])
    pb["nom_row"][gt["pod_idx"][multi]] = rng.integers(0, 16, multi.sum())
    c, u, p = tables_from_numpy(nc, us, pb, cuda)
    g = gang_table_from_numpy(gt, cuda)
    n = nom_from_numpy(nm, cuda)
    name = gk.gang_instance(cap, True, True)
    before = gk.LAUNCHES[name]
    packed_k, use_k = gk.gang_schedule_packed(c, u, p, g, n,
                                              exempt_mates=True)
    assert gk.LAUNCHES[name] == before + 1
    carry, _ = kb._carry_setup(u, p)
    packed_p = gk.gang_schedule_plain(c, p, g, carry, n, exempt_mates=True)
    torch.cuda.synchronize()
    assert torch.equal(packed_k, packed_p)
    for k in carry:
        assert torch.equal(use_k[k].view(torch.int32),
                           carry[k].view(torch.int32)), k
    # the exemption decides: the reference's overlay places otherwise
    ref, _ = gk.gang_schedule_packed(c, u, p, g, n)
    assert not torch.equal(ref, packed_k)
    assert (packed_k[0] >= 0).any() and (packed_k[0] < 0).any()


def test_gang_feasible_kernel_matches_plain(cuda):
    from kubernetes_tpu_torch.scheduler.kernels import gang as gk
    rng = np.random.default_rng(5)
    for P, N in ((300, 513), (64, 8192)):
        fits = rng.random((P, N)) < 0.01
        fits[::7] = False        # every seventh pod fits nowhere
        fits = torch.tensor(fits, device=cuda)
        members = torch.tensor(rng.integers(-1, P, (40, 8)),
                               dtype=torch.int32, device=cuda)
        got = gk.gang_feasible(fits, members)
        want = gk.gang_feasible_plain(fits, members)
        assert torch.equal(got, want)
        assert want.any() and not want.all()


@pytest.mark.parametrize("U", [4, 17, 32, 64, 2048, 16384])
def test_price_domains_kernel_matches_plain(cuda, U):
    """K11 against its plain version; from U = 2,048 on, a few domain
    rows as wide as a gang with no topology key prices (the whole cluster
    in one row), with a need that takes about half the units."""
    from kubernetes_tpu_torch.convert import domain_tables_from_numpy
    rng = np.random.default_rng(U)
    f32 = np.float32
    D = 700 if U <= 64 else 3
    n_units = rng.integers(1, U + 1, D)
    valid = np.arange(U)[None, :] < n_units[:, None]
    a = {"base": rng.integers(0, 3, D).astype(f32),
         "need": f32(8 if U <= 64 else U // 2),
         "dslots": np.where(valid, rng.integers(0, 3, (D, U)), 0)
         .astype(f32), "valid": valid,
         "pdb": (rng.random((D, U)) < 0.05) & valid,
         "top": np.where(valid, 2_000_000_000, np.iinfo(np.int32).min)
         .astype(np.int32),
         "psum": np.where(valid, rng.integers(1_999_999_000, 2_000_000_000,
                                              (D, U)), 0).astype(f32),
         "gcnt": rng.integers(1, 9, (D, U)).astype(np.int32),
         "startr": rng.integers(0, 4, (D, U)).astype(np.int32),
         "row_valid": rng.random(D) < 0.95}
    t = domain_tables_from_numpy(a, cuda)
    args = [t[k] for k in pk.DOMAIN_KEYS]
    got = pk.price_domains(*args)
    want = pk.price_domains_plain(*args)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert int(got[0]) >= 0


# ------------------------------------------------------------ K13, K14


def _affinity_inputs(seed, U, T, N):
    """has_dom, present [T, N] bool and the three 0/1 selectors [U, T]
    f32 as TopologyIndex.required_masks builds them: each template takes
    one or two terms, as required affinity, waived affinity or
    anti-affinity."""
    rng = np.random.default_rng(seed)
    has_dom = rng.random((T, N)) < 0.9
    present = rng.random((T, N)) < 0.5
    sels = [np.zeros((U, T), np.float32) for _ in range(3)]
    u = np.repeat(np.arange(U), 2)
    t = rng.integers(0, T, 2 * U)
    kind = rng.integers(0, 3, 2 * U)
    kind[1::2] = np.where(rng.random(U) < 0.5, kind[1::2], -1)
    for k, sel in ((0, (0, 1)), (1, (0,)), (2, (2,))):
        for j in sel:
            sels[j][u[kind == k], t[kind == k]] = 1.0
    return (has_dom, present, *sels)


#: bucket-crossing shapes, shapes no tile divides, and the
#: service-anti-affinity path's (U = 1,000 templates over T = 2,000 terms,
#: bucketed to 1,024 x 2,048, on 8,192 rows)
AFFINITY_SHAPES = [(1, 1, 24), (7, 9, 24), (9, 33, 128), (33, 7, 200),
                   (100, 300, 1000), (1024, 2048, 8192)]


@pytest.mark.parametrize("U,T,N", AFFINITY_SHAPES)
def test_affinity_masks_kernel_matches_plain(cuda, U, T, N):
    from kubernetes_tpu_torch.scheduler.kernels import affinity as ak
    args = _affinity_inputs(U + T + N, U, T, N)
    ts = [torch.from_numpy(a).to(cuda) for a in args]
    before = ak.LAUNCHES["affinity_masks"]
    got = ak.affinity_masks_tensors(*ts)
    want = ak.affinity_masks_plain(*ts)
    torch.cuda.synchronize()
    assert ak.LAUNCHES["affinity_masks"] == before + 1
    assert got.dtype == torch.bool and torch.equal(got, want)
    assert want.any() and not want.all()
    # the bucket-padded numpy wrapper on the card against the CPU
    np.testing.assert_array_equal(ak.affinity_masks(*args, device=cuda),
                                  ak.affinity_masks(*args, device="cpu"))


@pytest.mark.parametrize("U,T,N", AFFINITY_SHAPES)
def test_affinity_scores_kernel_matches_plain(cuda, U, T, N):
    """Bit for bit on integer inputs (weights in [-100, 100], counts in
    [0, 50]); on random f32 within T · 2^-23 · sum|w·c| (each term order
    within T · 2^-24 · sum|w·c| of the exact sum)."""
    from kubernetes_tpu_torch.scheduler.kernels import affinity as ak
    rng = np.random.default_rng(U * T + N)
    w = torch.from_numpy(rng.integers(-100, 101, (U, T)).astype(
        np.float32)).to(cuda)
    c = torch.from_numpy(rng.integers(0, 51, (T, N)).astype(
        np.float32)).to(cuda)
    got = ak.affinity_scores_tensors(w, c)
    want = ak.affinity_scores_plain(w, c)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    np.testing.assert_array_equal(
        ak.affinity_scores(w.cpu().numpy(), c.cpu().numpy(), device=cuda),
        ak.affinity_scores(w.cpu().numpy(), c.cpu().numpy(), device="cpu"))
    w = torch.randn((U, T), generator=torch.Generator().manual_seed(T)).to(
        cuda)
    c = torch.randn((T, N), generator=torch.Generator().manual_seed(N)).to(
        cuda)
    got = ak.affinity_scores_tensors(w, c).double()
    want = ak.affinity_scores_plain(w, c).double()
    tol = T * 2.0 ** -23 * (w.abs().double() @ c.abs().double())
    assert bool(((got - want).abs() <= tol).all())
