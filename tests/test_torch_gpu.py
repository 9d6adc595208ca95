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


#: (D, N) of K15's cases: N a multiple of D; at D = 3 each CTA owns 341
#: rows, not a multiple of its 352 threads
SHARD_CASES = [(2, 1024), (3, 1023), (8, 1024)]


def _shard_case(cuda, seed, N, spread, topo, dir2, soft, nom, pad_from=None):
    """A K15 batch of 256 pods (the plain sharded scan is slow on the
    card) over N rows; rows from `pad_from` on are shard pads
    (valid False, as TensorMirror pads a capacity)."""
    node_cfg, usage, pb = _state(seed, N=N, P=256)
    if pad_from is not None:
        for k in ("valid", "node_ok"):
            node_cfg[k][pad_from:] = False
    if not spread:
        pb = {k: v for k, v in pb.items() if not k.startswith("spread_")}
    pb = _affinity(pb, seed, topo, dir2, soft)
    tnom = nom_from_numpy(_nom(node_cfg, usage, pb, seed), cuda) if nom \
        else None
    tc, tu, tpb = tables_from_numpy(node_cfg, usage, pb, cuda)
    return tc, tu, tpb, tnom


def _hold_shard(D, name, tc, tu, tpb, tnom):
    """K15 on one batch: one launch of its instance, everything equal to
    the plain sharded scan on the card, and assign, the active pods'
    score bits and every usage final equal to K2's on the same batch."""
    before = dict(kb.LAUNCHES)
    packed, use = kb.schedule_batch_sharded_packed(D, tc, tu, tpb, tnom)
    assert kb.LAUNCHES[name] == before[name] + 1
    a, sc, p_use = kb.schedule_batch_sharded_plain(D, tc, tu, tpb, tnom)
    serial, serial_use = kb.schedule_batch_packed(tc, tu, tpb, tnom)
    torch.cuda.synchronize()
    active = tpb["active"]
    assert torch.equal(packed, kb.pack_results(a, sc))
    assert torch.equal(packed[0], serial[0])
    assert torch.equal(packed[1][active], serial[1][active])
    assert set(use) == set(p_use) == set(serial_use)
    for k in use:
        for other in (p_use, serial_use):
            assert torch.equal(use[k].view(torch.int32),
                               other[k].view(torch.int32)), k
    return packed


@pytest.mark.parametrize("nom", [False, True])
@pytest.mark.parametrize("spread,topo,dir2,soft", INSTANCES)
@pytest.mark.parametrize("D,N", SHARD_CASES)
def test_shard_scan_kernel_matches_plain_and_k2(cuda, D, N, spread, topo,
                                                dir2, soft, nom):
    """K15, each instance with and without the nominated overlay, at D =
    2, 3 and 8: one cluster of D CTAs against the plain sharded scan and
    against K2 on the same batch."""
    args = _shard_case(cuda, 8, N, spread, topo, dir2, soft, nom)
    packed = _hold_shard(D, kb.scan_instance(spread, topo, soft, nom,
                                             "shard_scan"), *args)
    assert (packed[0] >= 0).sum() > 128


@pytest.mark.parametrize("terms", [False, True])
@pytest.mark.parametrize("D,N", [(3, 1023), (8, 1024)])
def test_shard_scan_kernel_with_a_shard_of_pads(cuda, D, N, terms):
    """The last shard holds only pad rows (valid False): no pod lands
    there, and K15 still equals the plain sharded scan and K2."""
    pad_from = N - N // D
    args = _shard_case(cuda, 9, N, terms, terms, terms, terms, terms,
                       pad_from=pad_from)
    packed = _hold_shard(D, kb.scan_instance(terms, terms, terms, terms,
                                             "shard_scan"), *args)
    assert (packed[0] >= 0).sum() > 128
    assert int(packed[0].max()) < pad_from


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


def _dirty_rows(rng, node_cfg, usage, D, n_live):
    """idx [D] with n_live distinct live rows and pad slots (the capacity,
    -1 and past it), and random rows of every table."""
    cap = node_cfg["alloc"].shape[0]
    idx = rng.choice([cap, -1, cap + 7], D).astype(np.int32)
    idx[rng.permutation(D)[:n_live]] = rng.choice(cap, n_live,
                                                  replace=False)
    rows_c = {k: (rng.random((D,) + v.shape[1:]) < 0.5) if v.dtype == bool
              else (rng.random((D,) + v.shape[1:]) * 9).astype(v.dtype)
              for k, v in node_cfg.items()}
    rows_u = {k: (rng.random((D,) + v.shape[1:]) * 9).astype(v.dtype)
              for k, v in usage.items()}
    return idx, rows_c, rows_u


@pytest.mark.parametrize("D,n_live", [(8, 5), (16, 16), (8192, 5000)])
def test_apply_dirty_kernel_matches_plain_at_d(cuda, D, n_live):
    """Bit for bit against the plain scatter at the D buckets of a small
    and of the main path's largest dirty set (pad slots dropped, the last
    row untouched), and again on a second scatter into the same tables
    with the same buffers (K3's cached descriptor)."""
    node_cfg, usage, _ = _state(D, N=8192)
    rng = np.random.default_rng(D)
    a = tables_from_numpy(node_cfg, usage, None, cuda)
    b = tables_from_numpy(node_cfg, usage, None, cuda)
    idx, rows_c, rows_u = _dirty_rows(rng, node_cfg, usage, D, n_live)
    rc, ru, _ = tables_from_numpy(rows_c, rows_u, None, cuda)
    t_idx = torch.from_numpy(idx).to(cuda)
    before = kb.LAUNCHES["apply_dirty"]
    for rep in range(2):
        kb.apply_dirty(a[0], a[1], t_idx, rc, ru)
        kb.apply_dirty_plain(b[0], b[1], t_idx, rc, ru)
        torch.cuda.synchronize()
        for x, y in ((a[0], b[0]), (a[1], b[1])):
            for k in x:
                assert torch.equal(x[k], y[k]), (rep, k)
        # the second scatter: new rows and slots through the same buffers
        idx2, rows_c2, rows_u2 = _dirty_rows(rng, node_cfg, usage, D,
                                             n_live)
        t_idx.copy_(torch.from_numpy(idx2))
        for dst, src in ((rc, rows_c2), (ru, rows_u2)):
            for k in dst:
                dst[k].copy_(torch.from_numpy(src[k]))
    assert kb.LAUNCHES["apply_dirty"] == before + 2


def _port_node(api, i, cpu="8", ready=True, gpu=None):
    alloc = {"cpu": api.Quantity(cpu), "memory": api.Quantity("16Gi"),
             "pods": api.Quantity(110)}
    if gpu is not None:
        alloc["example.com/gpu"] = api.Quantity(gpu)
    return api.Node(
        metadata=api.ObjectMeta(name=f"n{i}"),
        status=api.NodeStatus(capacity=dict(alloc), allocatable=dict(alloc),
                              conditions=[api.NodeCondition(
                                  type="Ready",
                                  status="True" if ready else "False")]))


def test_mirror_scatter_on_the_card_matches_the_cpu(cuda):
    """TensorMirror.device_cfg_usage on the card (one packed upload, K3)
    leaves the tables the CPU mirror leaves: scatters with pad slots, two
    in a row through the same staging buffers, and after a resize (rows
    past the capacity, then a new column)."""
    from kubernetes_tpu_torch import api
    from kubernetes_tpu_torch.scheduler.cache import Cache, Snapshot
    from kubernetes_tpu_torch.scheduler.tensorize import TensorMirror
    sides = [(Cache(), Snapshot(), TensorMirror(device=d))
             for d in (cuda, "cpu")]
    nodes = {}

    def step(fn):
        for cache, snap, mirror in sides:
            fn(cache)
            mirror.apply(snap, cache.update_snapshot(snap))
        (gc, gu), (cc, cu) = (m.device_cfg_usage() for _, _, m in sides)
        torch.cuda.synchronize()
        for g, c in ((gc, cc), (gu, cu)):
            for k in c:
                assert torch.equal(g[k].cpu(), c[k]), k

    def add(i, **kw):
        def fn(cache):
            nodes[i] = _port_node(api, i, **kw)
            cache.add_node(nodes[i])
        return fn

    def update(i, **kw):
        def fn(cache):
            new = _port_node(api, i, **kw)
            cache.update_node(nodes[i], new)
        return fn

    for i in range(20):
        step(add(i))
    before = kb.LAUNCHES["apply_dirty"]
    step(update(3, cpu="4"))
    step(update(5, ready=False))
    stages = dict(sides[0][2]._stages)
    step(update(3, cpu="2"))
    assert sides[0][2]._stages == stages          # reused
    for i in range(20, 140):                      # past capacity 128
        step(add(i))
    step(update(7, cpu="6"))
    step(add(200, gpu="2"))                       # a new column
    step(update(9, cpu="1"))
    assert kb.LAUNCHES["apply_dirty"] > before + 3


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


#: one run (P <= 2,048 sorts in one block, perm written directly), the
#: run edges, and several runs merged by rank (up to 20 at 40,000)
ORDER_SIZES = [2, 63, 64, 2047, 2048, 2049, 6000, 16_384, 40_000]


def _order_hazards(seed, P):
    """Keys at every hazard at once: INT32_MIN / INT32_MAX and wrapping
    priorities, NaN of both signs, ±0.0 and ±inf shares, and pop
    positions repeated about four times each."""
    rng = np.random.default_rng(seed)
    prio = rng.choice(np.array([0, 1000, -2 ** 31, 2 ** 31 - 1,
                                -2_147_483_647, 2_000_001_000], np.int32),
                      P).astype(np.int32)
    shares = np.array([np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf, 0.25,
                       1e-3, 0.5, -0.25], np.float32)
    tidx = rng.integers(0, shares.shape[0], P).astype(np.int32)
    pos = rng.integers(0, max(P // 4, 1), P).astype(np.int32)
    return prio, shares, tidx, pos


@pytest.mark.parametrize("P", ORDER_SIZES)
@pytest.mark.parametrize("keys", ["drain", "hazards", "all-equal"])
def test_drf_order_kernel_runs_and_merge_match_plain(cuda, P, keys):
    """The run sort and the merged ranks against the plain version (held
    against JAX's lexsort on the CPU), at sizes on both sides of the
    2,048-pod run; one launch counted a call."""
    from kubernetes_tpu_torch.tenancy import kernels as tk
    if keys == "drain":
        arrays = _drf_inputs(P, P, 9)
    elif keys == "hazards":
        arrays = _order_hazards(P, P)
    else:
        arrays = (np.full(P, 7, np.int32), np.array([0.5], np.float32),
                  np.zeros(P, np.int32), np.full(P, 3, np.int32))
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    before = tk.LAUNCHES["drf_order"]
    got = tk.drf_order(*args)
    assert tk.LAUNCHES["drf_order"] == before + 1
    want = tk.drf_order_plain(*args)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32
    assert torch.equal(torch.sort(got.long()).values,
                       torch.arange(P, device=cuda))
    assert torch.equal(got, want)
    if keys == "all-equal":
        assert torch.equal(got.long(), torch.arange(P, device=cuda))


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


#: word boundaries of K13's 32-term words and 512-term chunks, and a
#: template tile of 64 plus one
MASK_WORD_SHAPES = [(5, 31, 40), (65, 32, 130), (9, 33, 257), (64, 65, 128),
                    (3, 511, 64), (7, 513, 129)]


@pytest.mark.parametrize("U,T,N", MASK_WORD_SHAPES + AFFINITY_SHAPES[-2:])
def test_affinity_masks_kernel_word_boundaries(cuda, U, T, N):
    """K13 against plain where T ends inside, at or just past a word; with
    template 0's selectors all ones (no chunk of its tile skipped), -0.0
    in place of every zero of template 1, and with all-zero selectors
    (every chunk skipped, every entry True)."""
    from kubernetes_tpu_torch.scheduler.kernels import affinity as ak
    has_dom, present, *sels = _affinity_inputs(U * T + N, U, T, N)
    for s in sels:
        s[0] = 1.0
        if U > 1:
            s[1] = np.where(s[1] == 0.0, np.float32(-0.0), s[1])
    ts = [torch.from_numpy(a).to(cuda) for a in (has_dom, present, *sels)]
    scratch = ak.mask_scratch(U, T, N, cuda)
    got = ak._affinity_masks_cuda(*ts, scratch=scratch)
    want = ak.affinity_masks_plain(*ts)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert not want[0].any()
    chunks = scratch["chunks"].view(-1, (3 * ((T + 31) // 32) + 15) // 16)
    assert bool(chunks[0].all())          # tile 0: no chunk skipped
    zero = [torch.zeros_like(t) for t in ts[2:]]
    got = ak._affinity_masks_cuda(*ts[:2], *zero, scratch=scratch)
    torch.cuda.synchronize()
    assert bool(got.all()) and not bool(scratch["chunks"].any())


@pytest.mark.parametrize("value", [0.5, 2.0, float("nan"), -1.0])
def test_affinity_masks_kernel_refuses_other_selectors(cuda, value):
    """A selector outside {0, -0, 1} on the card raises ValueError: K13's
    bit form has no answer for it, and the plain version is no fallback."""
    from kubernetes_tpu_torch.scheduler.kernels import affinity as ak
    args = [torch.from_numpy(a).to(cuda)
            for a in _affinity_inputs(3, 70, 100, 300)]
    args[3][69, 99] = value
    with pytest.raises(ValueError, match="selector"):
        ak.affinity_masks_tensors(*args)
    args[3][69, 99] = 1.0
    assert torch.equal(ak.affinity_masks_tensors(*args),
                       ak.affinity_masks_plain(*args))


#: K14's ragged edges: no tile divides U, T or N, rows that do not start
#: 16-byte aligned (T or N not a multiple of 4), one node, and the padded
#: service shape one node wider
SCORES_SHAPES = AFFINITY_SHAPES + [(8, 8, 27), (129, 17, 131), (33, 7, 1),
                                   (1024, 2048, 8193)]


@pytest.mark.parametrize("U,T,N", SCORES_SHAPES)
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


@pytest.mark.parametrize("U,T,N", [(130, 64, 256), (64, 33, 129)])
def test_affinity_scores_kernel_misaligned_bases(cuda, U, T, N):
    """Tensors that start 4 bytes past a 16-byte boundary take the 4-byte
    copies even where T and N are multiples of 4: bit for bit on integer
    inputs; one launch counted."""
    from kubernetes_tpu_torch.scheduler.kernels import affinity as ak
    rng = np.random.default_rng(U + T + N)
    wbuf = torch.from_numpy(rng.integers(-100, 101, U * T + 1).astype(
        np.float32)).to(cuda)
    cbuf = torch.from_numpy(rng.integers(0, 51, T * N + 1).astype(
        np.float32)).to(cuda)
    w = wbuf[1:].view(U, T)
    c = cbuf[1:].view(T, N)
    assert w.data_ptr() % 16 and c.data_ptr() % 16
    before = ak.LAUNCHES["affinity_scores"]
    got = ak.affinity_scores_tensors(w, c)
    want = ak.affinity_scores_plain(w, c)
    torch.cuda.synchronize()
    assert ak.LAUNCHES["affinity_scores"] == before + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# ------------------------------------------------------------ K2 designs


def _k2_run(tc, tu, tpb, tnom, design):
    """One K2 design on the batch (the table built by K1): (packed,
    post-batch usage, the final [C, N] table)."""
    cls, rw, ms, carry, terms = kb._scan_setup(tc, tu, tpb, tnom)
    packed = kb._class_scan_cuda(tc, tpb, cls, rw, ms, carry, terms, tnom,
                                 design=design)
    return packed, kb._usage_out(carry), ms


def _k2_plain(tc, tu, tpb, tnom):
    def run():
        cls, rw, ms, carry, terms = kb._scan_setup(tc, tu, tpb, tnom)
        packed = kb._class_scan_plain(tc, tpb, cls, rw, ms, carry, terms,
                                      tnom)
        return packed, kb._usage_out(carry), ms
    return _plain(run)


def _hold_k2(got, ref):
    """Packed results, post-batch usage and the final table, bit for
    bit."""
    torch.cuda.synchronize()
    (packed, usage, ms), (rp, ru, rms) = got, ref
    assert torch.equal(packed, rp)
    assert set(usage) == set(ru)
    for k in ru:
        assert torch.equal(usage[k].view(torch.int32),
                           ru[k].view(torch.int32)), k
    assert torch.equal(ms.view(torch.int32), rms.view(torch.int32))


@pytest.mark.parametrize("design", kb.CLASS_SCAN_DESIGNS)
@pytest.mark.parametrize("nom", [False, True])
@pytest.mark.parametrize("spread,topo,dir2,soft", INSTANCES)
def test_scan_designs_match_plain(cuda, design, spread, topo, dir2, soft,
                                  nom):
    """Every K2 instance in both designs against the plain versions on a
    batch of 1,000 rows (not a multiple of the shared design's 512
    threads): packed results, usage and the final table."""
    node_cfg, usage, pb = _state(21, N=1000, P=512)
    if not spread:
        pb = {k: v for k, v in pb.items() if not k.startswith("spread_")}
    pb = _affinity(pb, 21, topo, dir2, soft)
    tnom = nom_from_numpy(_nom(node_cfg, usage, pb, 21), cuda) if nom \
        else None
    tc, tu, tpb = tables_from_numpy(node_cfg, usage, pb, cuda)
    name = kb.scan_instance(spread, topo, soft, nom)
    before = kb.DESIGN_LAUNCHES[f"{name}:{design}"]
    got = _k2_run(tc, tu, tpb, tnom, design)
    assert kb.DESIGN_LAUNCHES[f"{name}:{design}"] == before + 1
    _hold_k2(got, _k2_plain(tc, tu, tpb, tnom))
    assert (got[0][0] >= 0).sum() > 200


@pytest.mark.parametrize("design", kb.CLASS_SCAN_DESIGNS)
@pytest.mark.parametrize("spread", [False, True])
@pytest.mark.parametrize("N", [37, 8192])
def test_scan_designs_at_row_edges(cuda, design, spread, N):
    """Fewer rows than a warp, and the shared design's most rows (16 a
    thread of 512)."""
    node_cfg, usage, pb = _state(22, N=N, P=256)
    if not spread:
        pb = {k: v for k, v in pb.items() if not k.startswith("spread_")}
    tc, tu, tpb = tables_from_numpy(node_cfg, usage, pb, cuda)
    _hold_k2(_k2_run(tc, tu, tpb, None, design),
             _k2_plain(tc, tu, tpb, None))


@pytest.mark.parametrize("C,want", [(4, "shared"), (40, "global")])
def test_scan_takes_the_design_of_its_size(cuda, C, want):
    """The host's pick through the public entry: 4 classes take the
    shared table, 40 (more than the refresh's warp) the global one."""
    node_cfg, usage, pb = _state(23, N=1024, C=C, P=512)
    tc, tu, tpb = tables_from_numpy(node_cfg, usage, pb, cuda)
    name = kb.scan_instance(True, False, False)
    before = dict(kb.DESIGN_LAUNCHES)
    packed, new_usage = kb.schedule_batch_packed(tc, tu, tpb)
    assert kb.DESIGN_LAUNCHES[f"{name}:{want}"] == \
        before[f"{name}:{want}"] + 1
    ref, ref_usage = _plain(kb.schedule_batch_packed, tc, tu, tpb)
    torch.cuda.synchronize()
    assert torch.equal(packed, ref)
    for k in ref_usage:
        assert torch.equal(new_usage[k].view(torch.int32),
                           ref_usage[k].view(torch.int32)), k


@pytest.mark.parametrize("design", kb.CLASS_SCAN_DESIGNS)
@pytest.mark.parametrize("Z", [8, 40])
def test_spread_zone_ids_clamp_in_both_designs(cuda, design, Z):
    """Random zone ids with zone 0 (no label), negative ids and ids past
    Z (the reference's gather clamps them), and zinit counts; Z = 40 is
    past the shared step's shuffle table of 32 zones."""
    node_cfg, usage, pb = _state(24, N=1024, P=512, Z=Z)
    rng = np.random.default_rng(24)
    pb["spread_zone"] = rng.integers(-3, Z + 4, 1024).astype(np.int32)
    pb["spread_zinit"] = rng.integers(0, 30, Z).astype(np.float32)
    tc, tu, tpb = tables_from_numpy(node_cfg, usage, pb, cuda)
    _hold_k2(_k2_run(tc, tu, tpb, None, design),
             _k2_plain(tc, tu, tpb, None))


def _tie_seq(row):
    """A seq whose tie hash is 0 at `row`: (row * 2654435769 + seq *
    40503) mod 2^16 == 0."""
    return (-row * 2654435769 * pow(40503, -1, 1 << 16)) % (1 << 16)


def _tie_hash(row, seq):
    return ((row * 2654435769 + seq * 40503) & 0xFFFFFFFF) & 0xFFFF


@pytest.mark.parametrize("design", kb.CLASS_SCAN_DESIGNS)
@pytest.mark.parametrize("rows", [(300, 700), (700, 300)])
def test_scan_signed_zero_ties_go_to_the_lower_row(cuda, design, rows):
    """Penalized scores of +0.0 at row A and -0.0 at row B (resource
    weights -0.0, a static score of -0.0 where the tie hash is 0, and
    exactly the hash's penalty at A) tie; the lower row wins."""
    a_row, b_row = rows
    N, R, P = 1024, 2, 4
    f32 = np.float32
    seq0 = _tie_seq(b_row)
    stat = np.full((1, N), -0.0, f32)
    stat[0, a_row] = f32(_tie_hash(a_row, seq0) * 2.0 ** -17)
    mask = np.zeros((1, N), bool)
    mask[0, [a_row, b_row]] = True
    node_cfg = {"alloc": np.full((N, R), 8000, f32),
                "max_pods": np.full(N, 110, f32),
                "node_ok": np.ones(N, bool),
                "mem_pressure": np.zeros(N, bool),
                "valid": np.ones(N, bool)}
    usage = {"used": np.zeros((N, R), f32),
             "nonzero_used": np.zeros((N, 2), f32),
             "pod_count": np.zeros(N, f32)}
    req = np.full((1, R), 100, f32)
    pb = {"class_req": req, "class_nz": req.copy(),
          "class_blocked": np.zeros(1, bool),
          "class_mask_idx": np.zeros(1, np.int32),
          "class_score_idx": np.zeros(1, np.int32),
          "unique_masks": mask, "unique_scores": stat,
          "resource_weights": np.full(2, -0.0, f32),
          "class_idx": np.zeros(P, np.int32),
          "seq": np.array([seq0, 1, 2, 3], np.int32),
          "active": np.ones(P, bool)}
    tc, tu, tpb = tables_from_numpy(node_cfg, usage, pb, cuda)
    got = _k2_run(tc, tu, tpb, None, design)
    _hold_k2(got, _k2_plain(tc, tu, tpb, None))
    assert int(got[0][0, 0]) == min(rows)


# ------------------------------------------------------------ K9 designs


def _gang_hold(c, u, p, g, n, design, mates=False):
    """K9's `design` against gang_schedule_plain on fresh carries: packed
    results and committed usage bit for bit; returns (packed, carry)."""
    from kubernetes_tpu_torch.scheduler.kernels import gang as gk
    carry, _ = kb._carry_setup(u, p)
    name = gk.gang_instance("need" in g, p.get("soft_dom") is not None,
                            n is not None)
    before = gk.DESIGN_LAUNCHES[f"{name}:{design}"]
    packed = gk._gang_scan_cuda(c, p, g, carry, n, mates, design=design)
    assert gk.DESIGN_LAUNCHES[f"{name}:{design}"] == before + 1
    ref_carry, _ = kb._carry_setup(u, p)
    ref = gk.gang_schedule_plain(c, p, g, ref_carry, n, mates)
    torch.cuda.synchronize()
    assert torch.equal(packed, ref)
    assert set(carry) == set(ref_carry)
    for k in ref_carry:
        assert torch.equal(carry[k].view(torch.int32),
                           ref_carry[k].view(torch.int32)), k
    return packed, carry


def _gang_tensors(nc, us, pb, gt, nm, cuda):
    from kubernetes_tpu_torch.convert import gang_table_from_numpy
    c, u, p = tables_from_numpy(nc, us, pb, cuda)
    return c, u, p, gang_table_from_numpy(gt, cuda), nom_from_numpy(nm,
                                                                    cuda)


GANG_DESIGNS = ("cluster", "block")


@pytest.mark.parametrize("design", GANG_DESIGNS)
@pytest.mark.parametrize("N", [100, 1000])
@pytest.mark.parametrize("cap", [False, True])
@pytest.mark.parametrize("soft", [False, True])
@pytest.mark.parametrize("nom", [False, True])
def test_gang_scan_designs_match_plain(cuda, design, N, cap, soft, nom):
    """Every K9 instance in both designs, at 100 rows (7 a CTA: fewer
    than the cluster's threads, the last CTA without a row) and 1,000
    (not a multiple of the cluster's CTAs of threads), against
    gang_schedule_plain."""
    args = _gang_instance(30 + int(cap) + 2 * soft + 4 * nom, cap, soft,
                          nom, N=N)
    packed, _ = _gang_hold(*_gang_tensors(*args, cuda), design)
    assert (packed[0] >= 0).any() and (packed[0] < 0).any()


@pytest.mark.parametrize("design", GANG_DESIGNS)
@pytest.mark.parametrize("cap", [False, True])
def test_gang_scan_designs_exempt_mates(cuda, design, cap):
    """The own-gang exemption in both designs: gang members' reservations
    on rows of several CTAs, several on one row."""
    nc, us, pb, gt, nm = _gang_instance(41 + int(cap), cap, True, True,
                                        N=1000)
    rng = np.random.default_rng(4)
    multi = ~(gt["start"] & gt["end"])
    pb["nom_row"][gt["pod_idx"][multi]] = rng.integers(0, 1000,
                                                       multi.sum())
    pb["nom_row"][gt["pod_idx"][multi][::3]] = 7   # several on row 7
    _gang_hold(*_gang_tensors(nc, us, pb, gt, nm, cuda), design,
               mates=True)


def _flat_cluster(N, R, P, rng_seed=0):
    """Identical roomy nodes with zero usage, resource weights -0.0 (every
    resource score is -0.0) and one static score row a pod, so the
    penalized score of a row is what its static score makes it."""
    f32 = np.float32
    node_cfg = {"alloc": np.full((N, R), 8000, f32),
                "max_pods": np.full(N, 110, f32),
                "node_ok": np.ones(N, bool),
                "mem_pressure": np.zeros(N, bool),
                "valid": np.ones(N, bool)}
    usage = {"used": np.zeros((N, R), f32),
             "nonzero_used": np.zeros((N, 2), f32),
             "pod_count": np.zeros(N, f32)}
    pb = {"req": np.full((P, R), 100, f32),
          "nonzero_req": np.full((P, 2), 100, f32),
          "mem_pressure_blocked": np.zeros(P, bool),
          "active": np.ones(P, bool),
          "seq": np.arange(P, dtype=np.int32),
          "mask_idx": np.zeros(P, np.int32),
          "score_idx": np.arange(P, dtype=np.int32),
          "nom_row": np.full(P, -1, np.int32),
          "unique_masks": np.ones((1, N), bool),
          "unique_scores": np.zeros((P, N), f32),
          "resource_weights": np.full(2, -0.0, f32)}
    return node_cfg, usage, pb


def _singletons(P, N, pods=None):
    pods = list(range(P)) if pods is None else pods
    T = len(pods)
    return {"pod_idx": np.asarray(pods, np.int32),
            "start": np.ones(T, bool), "end": np.ones(T, bool),
            "gang_id": np.arange(T, dtype=np.int32),
            "entry_dom_idx": np.full(T, -1, np.int32),
            "pin_dom": np.full(T, -1, np.int32),
            "dom_tab": np.full((1, N), -1, np.int32)}


@pytest.mark.parametrize("design", GANG_DESIGNS)
def test_gang_scan_equal_scores_across_ctas_go_to_the_lowest_row(cuda,
                                                                  design):
    """Every feasible row ties exactly (a pod's static score at a row is
    the tie hash's penalty there, so every penalized score is the same
    constant); the first 256 rows (whole CTAs of the cluster) are masked
    off and a row takes one pod, so the pods fill rows 256, 257, ...
    across CTA boundaries, each to the lowest free row."""
    N, R, P = 1024, 3, 300
    node_cfg, usage, pb = _flat_cluster(N, R, P)
    node_cfg["max_pods"][:] = 1.0
    for p in range(P):
        pb["unique_scores"][p] = np.float32(1.0) + np.array(
            [_tie_hash(r, p) for r in range(N)], np.float32) * 2.0 ** -17
    pb["unique_masks"][0, :256] = False
    gt = _singletons(P, N)
    packed, _ = _gang_hold(*_gang_tensors(node_cfg, usage, pb, gt, None,
                                          cuda), design)
    assert packed[0].tolist() == list(range(256, 256 + P))


@pytest.mark.parametrize("design", GANG_DESIGNS)
@pytest.mark.parametrize("rows", [(300, 700), (700, 300)])
def test_gang_scan_signed_zero_ties_go_to_the_lower_row(cuda, design, rows):
    """+0.0 at row A and -0.0 at row B, in different CTAs, tie; the lower
    row wins."""
    a_row, b_row = rows
    N, R, P = 1024, 3, 1
    node_cfg, usage, pb = _flat_cluster(N, R, P)
    seq0 = _tie_seq(b_row)
    pb["seq"][0] = seq0
    pb["unique_scores"][0, :] = -0.0
    pb["unique_scores"][0, a_row] = np.float32(_tie_hash(a_row, seq0)
                                               * 2.0 ** -17)
    pb["unique_masks"][0, :] = False
    pb["unique_masks"][0, [a_row, b_row]] = True
    gt = _singletons(P, N)
    packed, _ = _gang_hold(*_gang_tensors(node_cfg, usage, pb, gt, None,
                                          cuda), design)
    assert int(packed[0, 0]) == min(rows)


@pytest.mark.parametrize("design", GANG_DESIGNS)
def test_gang_scan_rejected_gang_across_ctas_restores_the_bits(cuda,
                                                               design):
    """A gang of 4 whose first three members place on rows of three CTAs
    (10, 300, 700) and whose last fits nowhere: every placement is undone
    and the committed usage at those rows keeps its input bits; a
    singleton after it places as the plain version does."""
    N, R, P = 1024, 3, 5
    rng = np.random.default_rng(9)
    node_cfg, usage, pb = _flat_cluster(N, R, P)
    usage["used"] = rng.uniform(0, 3000, (N, R)).astype(np.float32)
    usage["nonzero_used"] = rng.uniform(0, 3000, (N, 2)).astype(np.float32)
    usage["pod_count"] = rng.integers(0, 8, N).astype(np.float32)
    pb["resource_weights"] = np.ones(2, np.float32)
    pb["unique_scores"] = rng.integers(0, 3, (P, N)).astype(np.float32)
    masks = np.zeros((5, N), bool)
    for k, r in enumerate((10, 300, 700)):
        masks[k, r] = True
    masks[4] = True                 # the singleton: anywhere
    pb["unique_masks"] = masks
    pb["mask_idx"] = np.array([0, 1, 2, 3, 4], np.int32)
    gt = {"pod_idx": np.arange(5, dtype=np.int32),
          "start": np.array([1, 0, 0, 0, 1], bool),
          "end": np.array([0, 0, 0, 1, 1], bool),
          "gang_id": np.array([0, 0, 0, 0, 1], np.int32),
          "entry_dom_idx": np.full(5, -1, np.int32),
          "pin_dom": np.full(5, -1, np.int32),
          "dom_tab": np.full((1, N), -1, np.int32)}
    packed, carry = _gang_hold(*_gang_tensors(node_cfg, usage, pb, gt, None,
                                              cuda), design)
    assert packed[0, :4].tolist() == [-1] * 4 and int(packed[0, 4]) >= 0
    used = carry["used"].cpu().numpy()
    for r in (10, 300, 700):
        if r != int(packed[0, 4]):
            assert used[r].view(np.int32).tolist() == \
                usage["used"][r].view(np.int32).tolist()


@pytest.mark.parametrize("design", GANG_DESIGNS)
def test_gang_scan_capacity_gate_with_domains_across_ctas(cuda, design):
    """Gangs of 4 under the capacity gate on 1,000 rows whose 7 domains
    (rows // 100 mod 7) each span CTA boundaries (63 rows a CTA), with a
    few free rows a domain: a gang goes to a domain that holds it whole,
    or places by the greedy pin when none does."""
    N, R = 1000, 3
    rng = np.random.default_rng(12)
    n_gangs = 12
    P = 4 * n_gangs
    node_cfg, usage, pb = _flat_cluster(N, R, P)
    node_cfg["max_pods"][:] = 1.0
    usage["pod_count"][:] = 1.0
    usage["pod_count"][rng.random(N) < 0.03] = 0.0
    pb["resource_weights"] = np.ones(2, np.float32)
    pb["unique_scores"] = rng.integers(0, 3, (P, N)).astype(np.float32)
    dom = ((np.arange(N) // 100) % 7).astype(np.int32)
    gt = {"pod_idx": np.arange(P, dtype=np.int32),
          "start": (np.arange(P) % 4) == 0, "end": (np.arange(P) % 4) == 3,
          "gang_id": (np.arange(P) // 4).astype(np.int32),
          "entry_dom_idx": np.zeros(P, np.int32),
          "pin_dom": np.full(P, -1, np.int32),
          "dom_tab": dom[None, :],
          "need": np.full(P, 4.0, np.float32),
          "greq": pb["req"].copy()}
    packed, _ = _gang_hold(*_gang_tensors(node_cfg, usage, pb, gt, None,
                                          cuda), design)
    placed = packed[0].cpu().numpy()
    assert (placed >= 0).any()
    for g in range(n_gangs):
        rows = placed[4 * g:4 * g + 4]
        if (rows >= 0).all():
            assert len(set(dom[rows].tolist())) == 1


# ------------------------------------------------------ K7 and K15 designs


def _k7_hold(tc, tu, tpb, tnom, design):
    """K7's `design` against _pod_scan_plain on fresh carries: packed
    results and every post-batch usage table bit for bit; returns the
    packed results."""
    carry, terms = kb._carry_setup(tu, tpb)
    name = kb.scan_instance(terms[0], terms[1], terms[3], tnom is not None,
                            "pod_scan")
    before = kb.DESIGN_LAUNCHES[f"{name}:{design}"]
    packed = kb._pod_scan_cuda(tc, tpb, carry, terms, tnom, design=design)
    assert kb.DESIGN_LAUNCHES[f"{name}:{design}"] == before + 1
    ref_carry, _ = kb._carry_setup(tu, tpb)
    ref = kb._pod_scan_plain(tc, tpb, ref_carry, terms, tnom)
    torch.cuda.synchronize()
    assert torch.equal(packed, ref)
    use, ref_use = kb._usage_out(carry), kb._usage_out(ref_carry)
    assert set(use) == set(ref_use)
    for k in ref_use:
        assert torch.equal(use[k].view(torch.int32),
                           ref_use[k].view(torch.int32)), k
    return packed


def _k15_run(D, tc, tu, tpb, tnom, design):
    """One K15 design on the batch: (packed, post-batch usage, the final
    [C, N] table)."""
    pb = kb._shard_setup(D, tc, tpb, tnom)
    cls, rw, ms, carry, terms = kb._scan_setup(tc, tu, pb, tnom)
    name = kb.scan_instance(terms[0], terms[1], terms[3], tnom is not None,
                            "shard_scan")
    before = kb.DESIGN_LAUNCHES[f"{name}:{design}"]
    packed = kb._shard_scan_cuda(D, tc, pb, cls, rw, ms, carry, terms, tnom,
                                 design=design)
    assert kb.DESIGN_LAUNCHES[f"{name}:{design}"] == before + 1
    return packed, kb._usage_out(carry), ms


def _k15_hold(D, tc, tu, tpb, tnom, plain=True):
    """K15's two designs on one batch: bit for bit equal to each other
    (packed, usage, table), to the plain sharded scan (with `plain`), and
    in assign, active score bits and usage to K2; returns the packed
    results."""
    got = {d: _k15_run(D, tc, tu, tpb, tnom, d)
           for d in kb.SHARD_SCAN_DESIGNS}
    serial, serial_use = kb.schedule_batch_packed(tc, tu, tpb, tnom)
    ref = kb.schedule_batch_sharded_plain(D, tc, tu, tpb, tnom) if plain \
        else None
    torch.cuda.synchronize()
    (packed, use, ms), (gp, gu, gms) = got["shared"], got["global"]
    assert torch.equal(packed, gp)
    assert set(use) == set(gu) == set(serial_use)
    for k in use:
        for other in (gu, serial_use):
            assert torch.equal(use[k].view(torch.int32),
                               other[k].view(torch.int32)), k
    assert torch.equal(ms.view(torch.int32), gms.view(torch.int32))
    if ref is not None:
        assert torch.equal(packed, kb.pack_results(ref[0], ref[1]))
    active = tpb["active"]
    assert torch.equal(packed[0], serial[0])
    assert torch.equal(packed[1][active], serial[1][active])
    return packed


@pytest.mark.parametrize("design", kb.POD_SCAN_DESIGNS)
@pytest.mark.parametrize("nom", [False, True])
@pytest.mark.parametrize("spread,topo,dir2,soft", INSTANCES)
def test_pod_scan_designs_match_plain(cuda, design, spread, topo, dir2,
                                      soft, nom):
    """Every K7 instance in both designs against its plain version on a
    batch of 1,000 rows (63 a CTA of the cluster: not a multiple of its
    threads, the last CTA short)."""
    node_cfg, usage, pb = _state(51, N=1000, P=512)
    if not spread:
        pb = {k: v for k, v in pb.items() if not k.startswith("spread_")}
    pb = _affinity(pb, 51, topo, dir2, soft)
    tnom = nom_from_numpy(_nom(node_cfg, usage, pb, 51), cuda) if nom \
        else None
    tc, tu, tpb = tables_from_numpy(node_cfg, usage, _classic(pb), cuda)
    packed = _k7_hold(tc, tu, tpb, tnom, design)
    assert (packed[0] >= 0).sum() > 200


@pytest.mark.parametrize("design", kb.POD_SCAN_DESIGNS)
@pytest.mark.parametrize("spread", [False, True])
@pytest.mark.parametrize("N", [37, 8192])
def test_pod_scan_designs_at_row_edges(cuda, design, spread, N):
    """Fewer rows than CTAs have warps (37: 3 rows a CTA, the last CTAs
    without a row), and the main paths' 8,192 (512 rows a CTA)."""
    node_cfg, usage, pb = _state(52, N=N, P=256)
    if not spread:
        pb = {k: v for k, v in pb.items() if not k.startswith("spread_")}
    tc, tu, tpb = tables_from_numpy(node_cfg, usage, _classic(pb), cuda)
    _k7_hold(tc, tu, tpb, None, design)


@pytest.mark.parametrize("Z", [8, 32])
@pytest.mark.parametrize("design", kb.POD_SCAN_DESIGNS)
def test_pod_scan_spread_zone_ids_clamp_in_both_designs(cuda, design, Z):
    """Random zone ids with zone 0, negative ids and ids past Z, and zinit
    counts, up to the exchange's 32 zones; past them the host takes the
    block design."""
    node_cfg, usage, pb = _state(53, N=1024, P=512, Z=Z)
    rng = np.random.default_rng(53)
    pb["spread_zone"] = rng.integers(-3, Z + 4, 1024).astype(np.int32)
    pb["spread_zinit"] = rng.integers(0, 30, Z).astype(np.float32)
    tc, tu, tpb = tables_from_numpy(node_cfg, usage, _classic(pb), cuda)
    _k7_hold(tc, tu, tpb, None, design)
    assert kb.pod_scan_design(1024, 8, 2, 33, (True, False, False,
                                               False)) == "block"


def _flat_classes(N, R, P):
    """_flat_cluster as a class batch: one class a pod (its own static
    score row), so the same batch runs the class route (K2, K15) and,
    through _classic, the classic route (K7)."""
    node_cfg, usage, cp = _flat_cluster(N, R, P)
    pb = {"class_req": cp["req"], "class_nz": cp["nonzero_req"],
          "class_blocked": np.zeros(P, bool),
          "class_mask_idx": np.zeros(P, np.int32),
          "class_score_idx": np.arange(P, dtype=np.int32),
          "unique_masks": cp["unique_masks"],
          "unique_scores": cp["unique_scores"],
          "resource_weights": cp["resource_weights"],
          "class_idx": np.arange(P, dtype=np.int32),
          "seq": cp["seq"], "active": cp["active"]}
    return node_cfg, usage, pb


def _equal_score_batch(N, P, masked):
    """Every feasible row ties exactly (a pod's static score at a row is
    the tie hash's penalty there); the first `masked` rows are masked
    off and a row takes one pod, so the pods fill rows masked, masked +
    1, ... each to the lowest free row, across CTA boundaries."""
    node_cfg, usage, pb = _flat_classes(N, 3, P)
    node_cfg["max_pods"][:] = 1.0
    for p in range(P):
        pb["unique_scores"][p] = np.float32(1.0) + np.array(
            [_tie_hash(r, p) for r in range(N)], np.float32) * 2.0 ** -17
    pb["unique_masks"][0, :masked] = False
    return node_cfg, usage, pb


def _signed_zero_batch(N, a_row, b_row):
    """+0.0 at row A and -0.0 at row B (resource weights -0.0, a static
    score of -0.0 where the tie hash is 0, exactly the hash's penalty at
    A): the two penalized scores tie and only those rows are feasible."""
    node_cfg, usage, pb = _flat_classes(N, 3, 1)
    seq0 = _tie_seq(b_row)
    pb["seq"][0] = seq0
    pb["unique_scores"][0, :] = -0.0
    pb["unique_scores"][0, a_row] = np.float32(_tie_hash(a_row, seq0)
                                               * 2.0 ** -17)
    pb["unique_masks"][0, :] = False
    pb["unique_masks"][0, [a_row, b_row]] = True
    return node_cfg, usage, pb


@pytest.mark.parametrize("design", kb.POD_SCAN_DESIGNS)
def test_pod_scan_equal_scores_across_ctas_go_to_the_lowest_row(cuda,
                                                                design):
    """Exact ties over 1,024 rows (64 a CTA), 4 CTAs masked off: the pods
    fill rows 256, 257, ... each to the lowest free row."""
    node_cfg, usage, pb = _equal_score_batch(1024, 300, 256)
    tc, tu, tpb = tables_from_numpy(node_cfg, usage, _classic(pb), cuda)
    packed = _k7_hold(tc, tu, tpb, None, design)
    assert packed[0].tolist() == list(range(256, 556))


@pytest.mark.parametrize("design", kb.POD_SCAN_DESIGNS)
@pytest.mark.parametrize("rows", [(300, 700), (700, 300), (63, 64),
                                  (64, 63)])
def test_pod_scan_signed_zero_ties_go_to_the_lower_row(cuda, design, rows):
    """+0.0 and -0.0 tie, in CTAs far apart and on either side of a CTA
    edge (rows 63 and 64); the lower row wins."""
    node_cfg, usage, pb = _signed_zero_batch(1024, *rows)
    tc, tu, tpb = tables_from_numpy(node_cfg, usage, _classic(pb), cuda)
    packed = _k7_hold(tc, tu, tpb, None, design)
    assert int(packed[0, 0]) == min(rows)


def _counter_batch(N=1024, P=64, seed=60):
    """Topology counters and soft credits on one term whose domains are
    rows // 100 (each spans a CTA edge at 64 rows a CTA): every pod
    matches the term and carries it as required anti-affinity, so a bind
    closes its 100 rows to the later pods, and writes and reads credits
    on it (positive read weights: later pods lean to the domains earlier
    ones took, where the anti term lets them). Each pod reads the counts
    the owner of the last winner's row wrote, in another CTA."""
    node_cfg, usage, pb = _state(seed, N=N, P=P)
    pb = {k: v for k, v in pb.items() if not k.startswith("spread_")}
    rng = np.random.default_rng(seed)
    dom = (np.arange(N) // 100).astype(np.int32)[None, :]
    zero = np.zeros((P, 1), np.int32)
    pb.update({"anti_dom": dom, "anti_cnt0": np.zeros((1, 16), np.float32),
               "anti_tids": np.where(rng.random((P, 1)) < 0.7, 0, -1)
               .astype(np.int32),
               "aff_tids": np.full((P, 1), -1, np.int32),
               "match_tids": zero,
               "soft_dom": dom, "soft_cnt0": np.zeros((1, 16), np.float32),
               "soft_base": rng.integers(-20, 21, (2, N)).astype(
                   np.float32),
               "soft_base_idx": rng.integers(0, 2, P).astype(np.int32),
               "soft_read_tids": zero, "soft_read_w": np.full(
                   (P, 1), 10.0, np.float32),
               "soft_write_tids": zero, "soft_write_w": np.full(
                   (P, 1), 10.0, np.float32),
               "soft_weight": np.float32(2.0)})
    return node_cfg, usage, pb


def _nominee_batch(N=1024):
    """Four pods, rows 5 (CTA 0) and 700 (CTA 10): pods 0 and 1 are
    nominated to row 5, which their two reservations fill. Pod 0 may
    take rows 5 or 700 and scores higher at 700: its own row (exempt
    from its own reservation) lies in another CTA than its winner. Pod 1
    may take only row 5 (it fits there by its exemption), pod 2, not
    nominated, only row 5 (reserved: it fails), pod 3 only row 700."""
    R, P = 2, 4
    f32 = np.float32
    node_cfg, usage, pb = _flat_classes(N, R, P)
    pb["resource_weights"] = np.ones(2, f32)
    req = pb["class_req"][0]
    node_cfg["alloc"][5] = 2 * req
    masks = np.zeros((3, N), bool)
    masks[0, [5, 700]] = True
    masks[1, 5] = True
    masks[2, 700] = True
    pb["unique_masks"] = masks
    pb["class_mask_idx"] = np.array([0, 1, 1, 2], np.int32)
    pb["unique_scores"][0, 700] = 5.0
    pb["nom_row"] = np.array([5, 5, -1, -1], np.int32)
    nom = {"used": np.zeros((N, R), f32), "count": np.zeros(N, f32)}
    nom["used"][5] = 2 * req
    nom["count"][5] = 2.0
    return node_cfg, usage, pb, nom


@pytest.mark.parametrize("design", kb.POD_SCAN_DESIGNS)
def test_pod_scan_counters_cross_ctas(cuda, design):
    """Topology counts and soft credits written for the winner's row by
    its owner and read by every CTA on the next pod: equal to the plain
    version, and no two placed pods in one domain."""
    node_cfg, usage, pb = _counter_batch()
    tc, tu, tpb = tables_from_numpy(node_cfg, usage, _classic(pb), cuda)
    packed = _k7_hold(tc, tu, tpb, None, design)
    rows = packed[0].cpu().numpy()
    anti = pb["anti_tids"][:, 0] >= 0
    placed = rows[(rows >= 0) & anti]
    assert len(placed) > 3
    assert len(set((placed // 100).tolist())) == len(placed)


@pytest.mark.parametrize("design", kb.POD_SCAN_DESIGNS)
def test_pod_scan_nominee_exempt_in_another_cta(cuda, design):
    """The nominee's own row (CTA 0) is exempt from its own reservation
    while its winner lies in CTA 10."""
    node_cfg, usage, pb, nom = _nominee_batch()
    tc, tu, tpb = tables_from_numpy(node_cfg, usage, _classic(pb), cuda)
    packed = _k7_hold(tc, tu, tpb, nom_from_numpy(nom, cuda), design)
    assert packed[0].tolist() == [700, 5, -1, 700]


@pytest.mark.parametrize("nom", [False, True])
@pytest.mark.parametrize("spread,topo,dir2,soft", INSTANCES)
@pytest.mark.parametrize("D,N", [(3, 1023), (8, 1000)])
def test_shard_scan_designs_agree(cuda, D, N, spread, topo, dir2, soft,
                                  nom):
    """Every K15 instance in its shared and its global design on one
    batch, bit for bit (packed, usage, table) and equal to K2: 3 shards
    of 341 rows over 15 CTAs of 69 (the last 65), and 8 of 125 rows over
    16 CTAs of 63 (the second of each shard 62)."""
    args = _shard_case(cuda, 61, N, spread, topo, dir2, soft, nom)
    packed = _k15_hold(D, *args, plain=False)
    assert (packed[0] >= 0).sum() > 128


@pytest.mark.parametrize("D,N", [(3, 1023), (8, 1024)])
def test_shard_scan_designs_with_a_shard_of_pads(cuda, D, N):
    """The last shard holds only pad rows: both designs equal the plain
    sharded scan and K2, and no pod lands on a pad."""
    args = _shard_case(cuda, 62, N, True, True, True, True, True,
                       pad_from=N - N // D)
    packed = _k15_hold(D, *args)
    assert int(packed[0].max()) < N - N // D


@pytest.mark.parametrize("Z", [8, 32])
def test_shard_scan_spread_zone_ids_clamp_in_both_designs(cuda, Z):
    """Clamped zone ids (zone 0, negative, past Z) and zinit counts."""
    node_cfg, usage, pb = _state(63, N=1024, P=256, Z=Z)
    rng = np.random.default_rng(63)
    pb["spread_zone"] = rng.integers(-3, Z + 4, 1024).astype(np.int32)
    pb["spread_zinit"] = rng.integers(0, 30, Z).astype(np.float32)
    tc, tu, tpb = tables_from_numpy(node_cfg, usage, pb, cuda)
    _k15_hold(8, tc, tu, tpb, None)


def test_shard_scan_equal_scores_across_ctas_go_to_the_lowest_row(cuda):
    """Exact ties over 1,024 rows on 8 shards (64 rows a CTA), the first
    four CTAs masked off: the pods fill rows 256, 257, ... in both
    designs."""
    node_cfg, usage, pb = _equal_score_batch(1024, 300, 256)
    tc, tu, tpb = tables_from_numpy(node_cfg, usage, pb, cuda)
    packed = _k15_hold(8, tc, tu, tpb, None, plain=False)
    assert packed[0].tolist() == list(range(256, 556))


@pytest.mark.parametrize("rows", [(300, 700), (700, 300), (63, 64),
                                  (127, 128)])
def test_shard_scan_signed_zero_ties_go_to_the_lower_row(cuda, rows):
    """+0.0 and -0.0 tie across shards, across the two CTAs of a shard
    (63, 64) and across a shard edge (127, 128); the lower row wins in
    both designs."""
    node_cfg, usage, pb = _signed_zero_batch(1024, *rows)
    tc, tu, tpb = tables_from_numpy(node_cfg, usage, pb, cuda)
    packed = _k15_hold(8, tc, tu, tpb, None)
    assert int(packed[0, 0]) == min(rows)


def test_shard_scan_counters_cross_ctas(cuda):
    """Topology counts and soft credits written by the winning warp's
    CTA and read by every CTA on the next pod, in both designs."""
    node_cfg, usage, pb = _counter_batch()
    tc, tu, tpb = tables_from_numpy(node_cfg, usage, pb, cuda)
    packed = _k15_hold(8, tc, tu, tpb, None)
    rows = packed[0].cpu().numpy()
    anti = pb["anti_tids"][:, 0] >= 0
    placed = rows[(rows >= 0) & anti]
    assert len(placed) > 3
    assert len(set((placed // 100).tolist())) == len(placed)


def test_shard_scan_nominee_exempt_in_another_cta(cuda):
    """The nominee's own row (shard 0) exempt while its winner lies in
    shard 5, in both designs."""
    node_cfg, usage, pb, nom = _nominee_batch()
    tc, tu, tpb = tables_from_numpy(node_cfg, usage, pb, cuda)
    packed = _k15_hold(8, tc, tu, tpb, nom_from_numpy(nom, cuda))
    assert packed[0].tolist() == [700, 5, -1, 700]


# ------------------------------------------------------------ K12 designs


def _k12_run(tc, tu, tpb, tnom, design, width):
    """One K12 design on the batch: (packed, post-batch usage, the final
    [C, N] table, stats)."""
    pb = sk._with_nom_row(tpb, tnom)
    cls, rw, ms, carry, terms = kb._scan_setup(tc, tu, pb, tnom)
    name = kb.scan_instance(terms[0], terms[1], terms[3], tnom is not None,
                            "spec_scan")
    before = kb.DESIGN_LAUNCHES[f"{name}:{design}"]
    packed, stats = sk._spec_scan_cuda(tc, pb, cls, rw, ms, carry, terms,
                                       tnom, width, design=design)
    assert kb.DESIGN_LAUNCHES[f"{name}:{design}"] == before + 1
    return packed, kb._usage_out(carry), ms, stats


def _k12_hold(tc, tu, tpb, tnom, width):
    """K12's two designs on one batch: bit for bit equal to each other
    (packed, usage, table, stats) and to the plain version (packed,
    usage, stats), and in assign, active score bits and usage to K2;
    returns (packed, stats)."""
    got = {d: _k12_run(tc, tu, tpb, tnom, d, width)
           for d in kb.SPEC_SCAN_DESIGNS}
    serial, serial_use = kb.schedule_batch_packed(tc, tu, tpb, tnom)
    a, sc, p_use, p_stats = sk.schedule_batch_speculative_plain(
        tc, tu, tpb, tnom, width=width)
    torch.cuda.synchronize()
    (packed, use, ms, stats), (bp, bu, bms, bst) = got["cluster"], \
        got["block"]
    assert torch.equal(packed, bp)
    assert torch.equal(stats, bst)
    assert torch.equal(ms.view(torch.int32), bms.view(torch.int32))
    assert torch.equal(packed, kb.pack_results(a, sc))
    assert torch.equal(stats, p_stats)
    assert set(use) == set(bu) == set(serial_use) == set(p_use)
    for k in use:
        for other in (bu, serial_use, p_use):
            assert torch.equal(use[k].view(torch.int32),
                               other[k].view(torch.int32)), k
    active = tpb["active"]
    assert torch.equal(packed[0], serial[0])
    assert torch.equal(packed[1][active], serial[1][active])
    return packed, stats


@pytest.mark.parametrize("nom", [False, True])
@pytest.mark.parametrize("spread,topo,dir2,soft", INSTANCES)
def test_spec_scan_designs_match_plain_and_k2(cuda, spread, topo, dir2,
                                              soft, nom):
    """Every K12 instance in both designs on a mixed batch of 1,000 rows
    (63 a CTA of the cluster, the last CTA short; winners in every CTA),
    cohorts of 8 with carried-term reads on a few pods, pads at the end:
    equal to each other, to the plain version and to K2."""
    node_cfg, usage, pb = _state(71, N=1000)
    if not spread:
        pb = {k: v for k, v in pb.items() if not k.startswith("spread_")}
    pb = _affinity(pb, 71, topo, dir2, soft)
    tnom = nom_from_numpy(_nom(node_cfg, usage, pb, 71), cuda) if nom \
        else None
    tc, tu, tpb = tables_from_numpy(node_cfg, usage, _speculative(pb), cuda)
    packed, stats = _k12_hold(tc, tu, tpb, tnom, 8)
    assert (packed[0] >= 0).sum() > 1000
    assert not bool(stats[:, 0].all())


@pytest.mark.parametrize("width", [8, 16, 32])
def test_spec_scan_designs_more_classes_than_members(cuda, width):
    """20 classes against cohorts of 8, 16 and 32: a winner's check
    columns are those of its later members' classes, the rest of its
    columns computed once the cohort is clean."""
    node_cfg, usage, pb = _state(72, N=1024, C=20)
    pb = {k: v for k, v in pb.items() if not k.startswith("spread_")}
    node_cfg["node_ok"][:] = True
    tc, tu, tpb = tables_from_numpy(node_cfg, usage, _speculative(pb), cuda)
    _, stats = _k12_hold(tc, tu, tpb, None, width)
    assert bool(stats[:, 0].any())


@pytest.mark.parametrize("width", [8, 16])
def test_spec_scan_designs_fence_positions(cuda, width):
    """A batch with no carried term, its fence marks moved: each cohort's
    fence at member 0, in the middle, last, or none. The first collider
    the stats record is the exact one (the plain version checks every
    member) and the decisions are K2's."""
    node_cfg, usage, pb = _state(73, N=1024)
    pb = {k: v for k, v in pb.items() if not k.startswith("spread_")}
    P = pb["class_idx"].shape[0]
    plain = np.ones(P, bool)
    for c in range(P // width):
        at = (0, width // 2, width - 1, width)[c % 4]
        if at < width:
            plain[c * width + at] = False
    pb["spec_plain"] = plain
    tc, tu, tpb = tables_from_numpy(node_cfg, usage, pb, cuda)
    _, stats = _k12_hold(tc, tu, tpb, None, width)
    st = stats.cpu().numpy()
    fenced_at_0 = st[0::4]
    assert (fenced_at_0[:, 1] == 0).all()
    assert (st[2::4, 1] <= width - 1).all()


def test_spec_scan_designs_equal_scores_across_ctas(cuda):
    """Exact ties over 1,024 rows (64 a CTA), 4 CTAs masked off: the pods
    fill rows 256, 257, ... each to the lowest free row (every cohort
    collides on its first row and repairs)."""
    node_cfg, usage, pb = _equal_score_batch(1024, 304, 256)
    pb["spec_plain"] = np.ones(304, bool)
    tc, tu, tpb = tables_from_numpy(node_cfg, usage, pb, cuda)
    packed, _ = _k12_hold(tc, tu, tpb, None, 16)
    assert packed[0].tolist() == list(range(256, 560))


@pytest.mark.parametrize("rows", [(300, 700), (700, 300), (63, 64),
                                  (64, 63)])
def test_spec_scan_designs_signed_zero_ties_go_to_the_lower_row(cuda, rows):
    """+0.0 and -0.0 tie in the election, in CTAs far apart and on either
    side of a CTA edge; the lower row wins in both designs."""
    node_cfg, usage, pb = _signed_zero_batch(1024, *rows)
    pb["spec_plain"] = np.ones(1, bool)
    tc, tu, tpb = tables_from_numpy(node_cfg, usage, pb, cuda)
    packed, stats = _k12_hold(tc, tu, tpb, None, 1)
    assert int(packed[0, 0]) == min(rows)
    assert stats.tolist() == [[1, 1]]


def test_spec_scan_designs_counters_cross_ctas(cuda):
    """Topology counts and soft credits written by a clean cohort (CTA 0
    in pod order in the cluster design) and read, in other CTAs, by a
    later cohort's repaired pods: pods 5, 21, ... read their term (each
    cohort of 8 fenced at 5 every other cohort), every pod writes it."""
    node_cfg, usage, pb = _counter_batch(P=128)
    reads = np.arange(128) % 16 == 5
    pb["anti_tids"] = np.where(reads[:, None], 0, -1).astype(np.int32)
    pb["soft_base_idx"] = np.where(reads, pb["soft_base_idx"], -1).astype(
        np.int32)
    pb["spec_plain"] = ~reads
    tc, tu, tpb = tables_from_numpy(node_cfg, usage, pb, cuda)
    _, stats = _k12_hold(tc, tu, tpb, None, 8)
    assert (stats[0::2, 1] <= 5).all()


@pytest.mark.parametrize("width", [2, 4])
def test_spec_scan_designs_nominee_exempt_in_another_cta(cuda, width):
    """The nominees (fenced: a nomination of their own) repair through
    the step whose owner of the nominee's row (CTA 0) is another CTA than
    the winner's (CTA 10)."""
    node_cfg, usage, pb, nom = _nominee_batch()
    pb["spec_plain"] = pb["nom_row"] < 0
    tc, tu, tpb = tables_from_numpy(node_cfg, usage, pb, cuda)
    packed, _ = _k12_hold(tc, tu, tpb, nom_from_numpy(nom, cuda), width)
    assert packed[0].tolist() == [700, 5, -1, 700]


# ---------------------------------------------------- K6's narrowing fold


def _lexi_table(N, seed=0, V=1):
    """A narrow table whose every valid row fits the preemptor after its
    first unit (one unit chosen a row): the rows' costs are the first
    unit's pdb, top, psum, gcnt and startr, set by each test."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    R = 2
    freed = np.zeros((N, V, R), f32)
    freed[:, 0, :] = 1.0
    fcnt = np.zeros((N, V), f32)
    fcnt[:, 0] = 1.0
    return {"free0": np.zeros((N, R), f32), "cfree0": np.zeros(N, f32),
            "need": np.ones(R, f32), "need_cnt": f32(1), "freed": freed,
            "fcnt": fcnt, "valid": np.ones((N, V), bool),
            "pdb": rng.random((N, V)) < 0.3,
            "top": rng.integers(0, 3, (N, V)).astype(np.int32),
            "psum": rng.integers(0, 3, (N, V)).astype(f32),
            "gcnt": rng.integers(1, 3, (N, V)).astype(np.int32),
            "startr": rng.integers(0, 3, (N, V)).astype(np.int32),
            "row_valid": np.ones(N, bool)}


def _widen(a, R):
    """The table with resources added up to R, each needing and freeing
    nothing: every fit, choice and cost as before, priced by K6's wide
    instance (R > 16)."""
    w = dict(a)
    n = R - a["need"].shape[0]
    w["free0"] = np.pad(a["free0"], ((0, 0), (0, n)))
    w["need"] = np.pad(a["need"], (0, n))
    w["freed"] = np.pad(a["freed"], ((0, 0), (0, 0), (0, n)))
    return w


def _k6_hold(cuda, a):
    """K6 against price_nodes_plain on the card (winner, chosen, k and
    nviol), on the table as it is (the narrow instance, a cluster of 16
    CTAs, at V <= 1,024 and R <= 16) and widened to 17 resources (the wide
    walk, one block): the same winner; returns it."""
    winners = []
    for t in (a, _widen(a, 17)):
        t = victim_tables_from_numpy(t, cuda)
        args = [t[k] for k in pk.PRICE_KEYS]
        ref = pk.price_nodes_plain(*args)
        before = pk.LAUNCHES["price_nodes"]
        got = pk.price_nodes(*args)
        assert pk.LAUNCHES["price_nodes"] == before + 1
        torch.cuda.synchronize()
        R = args[4].shape[2]
        for name, x, y in zip(("winner", "chosen", "k", "nviol"), got, ref):
            assert x.dtype == y.dtype and torch.equal(x, y), (R, name)
        winners.append(int(ref[0]))
    assert winners[0] == winners[1]
    return winners[0]


@pytest.mark.parametrize("N", [5, 17, 1000, 8193])
@pytest.mark.parametrize("seed", [0, 1])
def test_price_nodes_fold_ragged_rows(cuda, N, seed):
    """Row counts that 16 CTAs do not divide (and fewer rows than CTAs),
    random costs with ties, a quarter of the rows invalid."""
    a = _lexi_table(N, seed, V=4)
    a["row_valid"] = np.random.default_rng(seed).random(N) < 0.75
    _k6_hold(cuda, a)


def test_price_nodes_fold_tie_on_every_criterion(cuda):
    """Every row of CTAs 10-15 ties on all five criteria (the rows
    before them cannot host the preemptor): the lowest row wins."""
    a = _lexi_table(1024)
    for k in ("pdb", "top", "psum", "gcnt", "startr"):
        a[k][:] = a[k][0]
    a["row_valid"][:640] = False
    assert _k6_hold(cuda, a) == 640


@pytest.mark.parametrize("a_row,b_row", [(100, 900), (900, 100), (63, 64)])
def test_price_nodes_fold_signed_zero_psum(cuda, a_row, b_row):
    """psumv +0.0 at one row and -0.0 at another, tied before it on
    (nviol, topv): the zeros tie and cntv decides (b_row's is lower);
    with equal cntv the lower row wins."""
    a = _lexi_table(1024)
    a["row_valid"][:] = False
    a["row_valid"][[a_row, b_row]] = True
    a["pdb"][:] = False
    a["top"][:] = 1
    a["psum"][a_row, 0] = 0.0
    a["psum"][b_row, 0] = -0.0
    a["gcnt"][a_row, 0] = 2
    a["gcnt"][b_row, 0] = 1
    assert _k6_hold(cuda, a) == b_row
    a["gcnt"][a_row, 0] = 1
    a["startr"][[a_row, b_row], 0] = 0
    assert _k6_hold(cuda, a) == min(a_row, b_row)


def test_price_nodes_fold_nan_psum(cuda):
    """A NaN psumv in the least (nviol, topv) gives no winner (the
    reference's masked min is NaN and no row equals it); one outside it
    changes nothing."""
    a = _lexi_table(1024)
    a["pdb"][:] = False
    a["top"][:] = 5
    a["top"][300:310, 0] = 1            # the least topv, CTA 4
    a["psum"][700, 0] = np.nan          # outside it
    assert 300 <= _k6_hold(cuda, a) < 310
    a["psum"][305, 0] = np.nan          # inside it
    assert _k6_hold(cuda, a) == -1


def test_price_nodes_fold_no_feasible_row(cuda):
    """No row can host the preemptor: -1, nothing chosen."""
    a = _lexi_table(1024, V=4)
    a["row_valid"][:] = False
    assert _k6_hold(cuda, a) == -1
    a = _lexi_table(1024, V=4)
    a["free0"][:] = -5.0
    assert _k6_hold(cuda, a) == -1


# ------------------------------------------ K11's designs and its fold


def _domain_table(D, U, seed=0, frac=False):
    """[D, U] domain tables with priorities near 2·10^9 (their f32 sum
    depends on its order), ties on top, a few PDB units; `frac` makes
    dslots non-integer (the blocked order then decides the fit)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    n_units = rng.integers(1, U + 1, D)
    valid = np.arange(U)[None, :] < n_units[:, None]
    dslots = rng.integers(0, 3, (D, U)).astype(f32)
    if frac:
        dslots = (rng.random((D, U)) * rng.choice([1e-3, 0.7, 3e3], (D, U))
                  ).astype(f32)
    need = f32(np.median(np.where(valid, dslots, 0).sum(1)) / 2 + 0.1)
    return {"base": rng.integers(0, 3, D).astype(f32), "need": need,
            "dslots": np.where(valid, dslots, 0).astype(f32),
            "valid": valid, "pdb": (rng.random((D, U)) < 0.02) & valid,
            "top": np.where(valid, rng.integers(1_999_999_998, 2_000_000_000,
                                                (D, U)),
                            np.iinfo(np.int32).min).astype(np.int32),
            "psum": np.where(valid, rng.integers(1_999_999_000,
                                                 2_000_000_000, (D, U)),
                             0).astype(f32),
            "gcnt": rng.integers(1, 9, (D, U)).astype(np.int32),
            "startr": rng.integers(-3, 4, (D, U)).astype(np.int32),
            "row_valid": rng.random(D) < 0.95}


def _k11_hold(cuda, a):
    """K11 against price_domains_plain on the card, in the design its
    width takes (counted under it): winner, chosen and nviol equal;
    returns the winner."""
    from kubernetes_tpu_torch.convert import domain_tables_from_numpy
    t = domain_tables_from_numpy(a, cuda)
    args = [t[k] for k in pk.DOMAIN_KEYS]
    ref = pk.price_domains_plain(*args)
    key = f"price_domains:{pk.price_domains_design(args[2].shape[1])}"
    before = pk.LAUNCHES["price_domains"], pk.DESIGN_LAUNCHES[key]
    got = pk.price_domains(*args)
    assert (pk.LAUNCHES["price_domains"], pk.DESIGN_LAUNCHES[key]) == \
        (before[0] + 1, before[1] + 1)
    torch.cuda.synchronize()
    for name, x, y in zip(("winner", "chosen", "nviol"), got, ref):
        assert x.dtype == y.dtype and torch.equal(x, y), (key, name)
    return int(ref[0])


@pytest.mark.parametrize("D,U", [(1, 32), (5, 17), (700, 32), (1024, 32),
                                 (1025, 64), (48, 1000), (1, 1024),
                                 (1, 1025), (9, 2048)])
@pytest.mark.parametrize("frac", [False, True])
def test_price_domains_designs_match_plain(cuda, D, U, frac):
    """Both designs (a warp a row up to 1,024 units, one block a row
    past them) on ragged row counts and widths, integer and non-integer
    dslots (the blocked prefix's order decides the fit)."""
    _k11_hold(cuda, _domain_table(D, U, seed=D + U, frac=frac))


@pytest.mark.parametrize("U", [16384, 1 << 20])
@pytest.mark.parametrize("frac", [False, True])
def test_price_domains_keyless_row(cuda, U, frac):
    """One row of the whole cluster (a gang with no topology key): the
    wide design, one block over the row, against the plain version; a
    need past the row's slots leaves it infeasible."""
    a = _domain_table(1, U, seed=U, frac=frac)
    a["valid"][:] = True
    a["row_valid"][:] = True
    a["dslots"] = np.abs(a["dslots"]) + np.float32(0.25)
    a["need"] = np.float32(a["dslots"][0, : U // 3].sum())
    assert _k11_hold(cuda, a) == 0
    a["need"] = np.float32(a["dslots"].sum() * 2 + 10)
    assert _k11_hold(cuda, a) == -1


def _k11_lexi(D):
    """Every valid domain needs its first unit alone (one unit chosen a
    row): the rows' costs are that unit's pdb, top, psum, gcnt, startr."""
    a = _domain_table(D, 4, seed=3)
    a["valid"][:] = True
    a["base"][:] = 0.0
    a["need"] = np.float32(1.0)
    a["dslots"][:] = 1.0
    a["row_valid"][:] = True
    return a


def test_price_domains_fold_ties_lowest_row(cuda):
    """Rows tied on all five criteria across warps and CTAs (the rows
    before 640 infeasible): the lowest tied row wins."""
    a = _k11_lexi(1024)
    for k in ("pdb", "top", "psum", "gcnt", "startr"):
        a[k][:, 0] = a[k][0, 0]
    a["row_valid"][:640] = False
    assert _k11_hold(cuda, a) == 640
    a["row_valid"][:] = True
    a["psum"][[70, 900], 0] -= 128.0     # two tied rows in two CTAs
    assert _k11_hold(cuda, a) == 70


def test_price_domains_fold_nan_psum(cuda):
    """A NaN psumv among the rows tied on (nviol, topv) gives -1; one
    outside them changes nothing."""
    a = _k11_lexi(1024)
    a["pdb"][:] = False
    a["top"][:, 0] = 2_000_000_000
    a["top"][300:310, 0] = 1_999_999_999   # the least topv, CTA 4
    a["psum"][700, 0] = np.nan
    assert 300 <= _k11_hold(cuda, a) < 310
    a["psum"][305, 0] = np.nan
    assert _k11_hold(cuda, a) == -1


# ------------------------------------------------ K8's tiles and passes


def _filter_state(seed, P, N, R=8, G=3, Z=8, spread=True):
    """A per-pod batch (no class tables): pods of one tile with different
    mask, score and spread rows, a -1 spread group, zone ids past Z."""
    rng = np.random.default_rng(seed)
    node_cfg, usage, pb = _state(seed, N=N, R=R, C=4, P=P, G=G, Z=Z)
    pb = _classic(pb)
    pb.update(mask_idx=rng.integers(0, 3, P).astype(np.int32),
              score_idx=rng.integers(0, 3, P).astype(np.int32),
              unique_masks=rng.random((3, N)) < 0.85,
              unique_scores=rng.integers(0, 7, (3, N)).astype(np.float32),
              req=pb["req"] * rng.integers(1, 4, (P, 1)).astype(np.float32))
    pb["spread_gidx"][::5] = -1
    pb["spread_zone"] = rng.integers(0, Z + 2, N).astype(np.int32)
    pb["spread_zinit"] = rng.integers(0, 3, Z).astype(np.float32)
    if not spread:
        pb = {k: v for k, v in pb.items() if not k.startswith("spread_")}
    return node_cfg, usage, pb


def _k8_hold(cuda, node_cfg, usage, pb):
    tc, tu, tpb = tables_from_numpy(node_cfg, usage, pb, cuda)
    name = "filter_score" + "_spread" * ("spread_base" in pb)
    before = kb.LAUNCHES[name]
    fits, score = kb.filter_score(tc, tu, tpb)
    assert kb.LAUNCHES[name] == before + 1
    ref_fits, ref_score = kb.filter_score_plain(tc, tu, tpb)
    torch.cuda.synchronize()
    assert torch.equal(fits, ref_fits)
    assert torch.equal(score.view(torch.int32), ref_score.view(torch.int32))
    assert 0 < int(fits.sum()) < fits.numel()


@pytest.mark.parametrize("P,N", [(300, 513), (64, 512), (65, 1024),
                                 (1, 7), (257, 2048)])
@pytest.mark.parametrize("spread", [False, True])
def test_filter_score_tiles_ragged(cuda, P, N, spread):
    """Pod and row counts the tiles do not divide (N = 513: the scalar
    accesses), mixed mask / score / spread rows within a tile."""
    _k8_hold(cuda, *_filter_state(P + N, P, N, spread=spread))


@pytest.mark.parametrize("Z", [1, 17, 300])
def test_filter_score_spread_zones(cuda, Z):
    """One zone column (only the unlabelled zone), a few, and more than
    the tile's shared table holds (the zone sums straight into the
    scratch table)."""
    _k8_hold(cuda, *_filter_state(Z, 200, 1024, Z=Z))


@pytest.mark.parametrize("R", [2, 17, 64])
def test_filter_score_resource_columns(cuda, R):
    """The narrowest usage row, one past 16 and the widest (the staged
    columns shrink the block)."""
    _k8_hold(cuda, *_filter_state(R, 130, 1000, R=R))
