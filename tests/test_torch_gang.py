"""Gang scheduling in the port against the JAX package (port slice 6).

Here on the CPU, every comparison bit for bit (assign rows, the f32 score
bits of every pod, the usage bits), on the same seeded numpy inputs fed to
both packages:

- the port's plain gang scan against the JAX `gang_schedule_batch` on the
  reference test's randomized instances (tests/test_gang.py
  _random_instance), with pre-pinned domains, the nominated overlay with
  pods holding their own nomination, soft credits, and with and without
  the capacity gate's need / greq;
- a rejected gang hands back the input usage and credit bits; a gang
  whose second member fails still scores its third; an all-singleton
  batch equals the classic per-pod scan;
- gang_feasible_plain against the JAX `gang_feasible`;
- price_domains_plain against the JAX `price_domains` at U = 4 to 64
  units with priorities up to 2·10^9, where the priority sums depend on
  their order; build_domain_tables against the reference's tables on the
  storm fixture;
- the port's Scheduler(device="cpu") against the JAX Scheduler on the
  three end-to-end scenarios of tests/test_gang.py (a gang that cannot
  place binds nothing, a gang lands in one slice, a permit timeout rolls
  reservations back) and on the first drain of a gang preemption storm
  (the same victims, nominations and events), driven on the test's
  thread (workload.InformerPump, a FakeClock, drain_until_idle) so that
  no wall-clock deadline decides anything; then two storm gangs through
  the port alone, each landing whole in one slice (the reference keeps a
  gang's own reservations in the overlay and never lands them: ROADMAP
  Queue C).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu import api as japi
from kubernetes_tpu.scheduler import Scheduler as JScheduler
from kubernetes_tpu.scheduler.kernels import gang as jg
from kubernetes_tpu.scheduler.kernels import preempt as jpk
from kubernetes_tpu.scheduler.nodeinfo import NodeInfo as JNodeInfo
from kubernetes_tpu.state import Client as JClient
from kubernetes_tpu.utils.clock import FakeClock as JFakeClock

from kubernetes_tpu_torch import api as tapi
from kubernetes_tpu_torch import workload
from kubernetes_tpu_torch.convert import (domain_tables_from_numpy,
                                          gang_table_from_numpy,
                                          nom_from_numpy, tables_from_numpy)
from kubernetes_tpu_torch.scheduler import Scheduler as TScheduler
from kubernetes_tpu_torch.scheduler.kernels import batch as tb
from kubernetes_tpu_torch.scheduler.kernels import gang as tg
from kubernetes_tpu_torch.scheduler.kernels import preempt as tpk
from kubernetes_tpu_torch.scheduler.nodeinfo import NodeInfo as TNodeInfo
from kubernetes_tpu_torch.state import Client as TClient
from kubernetes_tpu_torch.utils.clock import FakeClock as TFakeClock

from test_gang import _random_instance

JAX = dict(api=japi, Scheduler=JScheduler, Client=JClient,
           FakeClock=JFakeClock, NodeInfo=JNodeInfo, pk=jpk, kw={})
PORT = dict(api=tapi, Scheduler=TScheduler, Client=TClient,
            FakeClock=TFakeClock, NodeInfo=TNodeInfo, pk=tpk,
            kw={"device": "cpu"})


def _dev(d):
    return None if d is None else {k: jnp.asarray(v) for k, v in d.items()}


def _bits(a):
    a = np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _add_cap(pb, gt):
    """The capacity gate's inputs as core._gang_device_table builds them:
    each entry carries its unit's member count and elementwise-max
    request."""
    T = gt["pod_idx"].shape[0]
    need = np.zeros((T,), np.float32)
    greq = np.zeros((T, pb["req"].shape[1]), np.float32)
    t = 0
    while t < T:
        e = t
        while not gt["end"][e]:
            e += 1
        idx = [i for i in gt["pod_idx"][t:e + 1] if i >= 0]
        if idx:
            need[t:e + 1] = len(idx)
            greq[t:e + 1] = pb["req"][idx].max(axis=0)
        t = e + 1
    gt["need"], gt["greq"] = need, greq


def _add_soft(pb, rng, N, P, Ts=4, Ks=2, Ds=8, Sb=2):
    """tests/test_gang.py's soft credit tables: integer-valued f32 tables
    (weights and counts are integers in production too)."""
    pb["soft_dom"] = rng.integers(-1, Ds, (Ts, N)).astype(np.int32)
    pb["soft_cnt0"] = np.zeros((Ts, Ds), np.float32)
    pb["soft_base"] = rng.integers(-5, 6, (Sb, N)).astype(np.float32)
    pb["soft_base_idx"] = rng.integers(-1, Sb, (P,)).astype(np.int32)
    pb["soft_read_tids"] = rng.integers(-1, Ts, (P, Ks)).astype(np.int32)
    pb["soft_read_w"] = rng.integers(-3, 4, (P, Ks)).astype(np.float32)
    pb["soft_write_tids"] = rng.integers(-1, Ts, (P, Ks)).astype(np.int32)
    pb["soft_write_w"] = rng.integers(0, 4, (P, Ks)).astype(np.float32)
    pb["soft_weight"] = np.float32(1.0)


def _instance(variant, seed):
    """(node_cfg, usage, pod batch, gang table, nom) of one randomized
    case: tests/test_gang.py's instance (16 nodes, 16 pods, gangs of 4,
    3, 2 and 1, two of them constrained) with the variant's terms."""
    rng = np.random.default_rng(1000 * seed + len(variant))
    nc, us, pb, gt = _random_instance(rng, N=16, P=16,
                                      gang_sizes=(4, 3, 2, 1),
                                      constrained=(0, 2))
    nom = None
    if "pin" in variant:
        # pre-pinned domains (a split gang's earlier reservations); 7 is
        # an interned id no row carries
        gt["pin_dom"] = np.where(gt["entry_dom_idx"] >= 0,
                                 1 if seed % 2 else 7, -1).astype(np.int32)
    if "nom" in variant:
        nom = {"used": rng.uniform(0, 800, (16, 3)).astype(np.float32),
               "count": rng.integers(0, 2, (16,)).astype(np.float32)}
        pb["nom_row"][:6] = rng.integers(0, 16, (6,))
    if "soft" in variant:
        _add_soft(pb, rng, 16, 16)
    if "cap" in variant:
        _add_cap(pb, gt)
    return nc, us, pb, gt, nom


def _both(nc, us, pb, gt, nom=None):
    """(JAX gang_schedule_batch, the port's gang_schedule_batch on the
    CPU) on the same numpy inputs."""
    j = jg.gang_schedule_batch(_dev(nc), _dev(us), _dev(pb), _dev(gt),
                               _dev(nom))
    c, u, p = tables_from_numpy(nc, us, pb)
    t = tg.gang_schedule_batch(c, u, p, gang_table_from_numpy(gt),
                               nom_from_numpy(nom))
    return j, t


def _assert_equal(j, t):
    """Assign rows, the score bits of EVERY pod (rejected gangs' members
    included) and every committed usage table, bit for bit."""
    np.testing.assert_array_equal(_bits(j[0]), _bits(t[0]))
    np.testing.assert_array_equal(_bits(j[1]), _bits(t[1]))
    assert set(j[2]) == set(t[2])
    for k in j[2]:
        np.testing.assert_array_equal(_bits(j[2][k]), _bits(t[2][k]),
                                      err_msg=k)


VARIANTS = ("plain", "pin", "nom", "soft", "cap", "cap-pin", "cap-nom",
            "cap-soft", "cap-soft-nom-pin")


@pytest.mark.parametrize("variant", VARIANTS)
def test_plain_gang_scan_matches_jax(variant):
    rejected = placed = 0
    for seed in range(6):
        nc, us, pb, gt, nom = _instance(variant, seed)
        j, t = _both(nc, us, pb, gt, nom)
        _assert_equal(j, t)
        a = _bits(t[0])
        placed += int((a >= 0).sum())
        rejected += int((a < 0).sum())
    # the fixtures exercise both verdicts
    assert placed and rejected


def _one_gang(seed, soft):
    """A batch holding one gang of 4 and nothing else (no singletons), so
    a rejection leaves the committed usage exactly as it came in."""
    rng = np.random.default_rng(seed)
    nc, us, pb, gt = _random_instance(rng, N=16, P=4, gang_sizes=(4,),
                                      constrained=())
    if soft:
        _add_soft(pb, rng, 16, 4)
        pb["soft_cnt0"] = rng.integers(0, 3, (4, 8)).astype(np.float32)
        pb["soft_write_tids"][:] = np.arange(2)[None, :]
    return nc, us, pb, gt


@pytest.mark.parametrize("soft", [False, True])
def test_rejected_gang_hands_back_its_input_bits(soft):
    nc, us, pb, gt = _one_gang(7, soft)
    # the gang's LAST member fits nowhere: its mask row refuses every node
    last = gt["pod_idx"][3]
    pb["mask_idx"][last] = 2
    pb["unique_masks"][2] = False
    j, t = _both(nc, us, pb, gt)
    _assert_equal(j, t)
    assert (_bits(t[0]) == -1).all()
    for k in ("used", "nonzero_used", "pod_count"):
        np.testing.assert_array_equal(_bits(t[2][k]), _bits(us[k]))
    if soft:
        np.testing.assert_array_equal(_bits(t[2]["soft_cnt"]),
                                      _bits(pb["soft_cnt0"]))
    # the first three members did place inside the trial before the veto
    assert (np.asarray(t[1])[gt["pod_idx"][:3]] > -1e29).all()


def test_second_member_fails_and_third_still_scores():
    nc, us, pb, gt = _one_gang(3, False)
    second, third = gt["pod_idx"][1], gt["pod_idx"][2]
    pb["mask_idx"][second] = 2
    pb["unique_masks"][2] = False
    # the third member fits on every ready node
    pb["mask_idx"][third] = 1
    pb["unique_masks"][1] = True
    pb["req"][third] = 1.0
    pb["mem_pressure_blocked"][third] = False
    j, t = _both(nc, us, pb, gt)
    _assert_equal(j, t)
    scores = np.asarray(t[1])
    assert (_bits(t[0]) == -1).all()
    assert scores[second] == np.float32(-1e30)
    assert scores[third] > -1e29


@pytest.mark.parametrize("cap", [False, True])
def test_exempt_mates_reads_the_overlay_without_the_units_reservations(cap):
    """The overlay's own-gang exemption (exempt_mates, as the core sets
    it): a batch of one gang whose members hold reservations (two of them
    often on one node) decides as the JAX scan does with those
    reservations left out of the overlay. Requests, usage and overlay are
    integer-valued, so the f32 sums and differences are exact and both
    routes read the same usage."""
    placed = 0
    for seed in range(6):
        rng = np.random.default_rng(500 + seed)
        nc, us, pb, gt = _random_instance(rng, N=16, P=16,
                                          gang_sizes=(4, 3, 2, 1),
                                          constrained=(0, 2))
        for d, k in ((nc, "alloc"), (us, "used"), (pb, "req")):
            d[k] = np.round(d[k])
        if cap:
            _add_cap(pb, gt)
        base = {"used": rng.integers(0, 800, (16, 3)).astype(np.float32),
                "count": rng.integers(0, 2, (16,)).astype(np.float32)}
        for u in range(3):       # the gangs of more than one member
            sel = gt["gang_id"] == u
            g = {k: v[sel] for k, v in gt.items() if k != "dom_tab"}
            g["gang_id"][:] = 0
            g["dom_tab"] = gt["dom_tab"]
            full = {k: v.copy() for k, v in base.items()}
            mine = dict(pb, nom_row=pb["nom_row"].copy())
            for i in g["pod_idx"]:
                r = int(rng.integers(0, 4))
                full["used"][r] += pb["req"][i]
                full["count"][r] += 1.0
                mine["nom_row"][i] = r
            j = jg.gang_schedule_batch(_dev(nc), _dev(us), _dev(pb),
                                       _dev(g), _dev(base))
            c, uu, p = tables_from_numpy(nc, us, mine)
            t = tg.gang_schedule_batch(c, uu, p, gang_table_from_numpy(g),
                                       nom_from_numpy(full),
                                       exempt_mates=True)
            _assert_equal(j, t)
            placed += int((_bits(t[0]) >= 0).any())
    assert placed


def _reserved_pair(third_member):
    """Two nodes of 2500 per resource; the preemption plan of a gang
    nominated its two members to node 0 (2 x 1000 reserved). With
    `third_member`, the gang has a third member that fits nowhere. A
    singleton after the gang fits only on node 0."""
    f32 = np.float32
    nc = {"alloc": np.full((2, 3), 2500, f32),
          "max_pods": np.full((2,), 10, f32),
          "node_ok": np.ones((2,), bool), "mem_pressure": np.zeros(2, bool),
          "valid": np.ones((2,), bool)}
    us = {"used": np.zeros((2, 3), f32),
          "nonzero_used": np.zeros((2, 2), f32),
          "pod_count": np.zeros((2,), f32)}
    pb = {"req": np.full((4, 3), 1000, f32),
          "nonzero_req": np.full((4, 2), 1000, f32),
          "mem_pressure_blocked": np.zeros((4,), bool),
          "active": np.ones((4,), bool),
          "seq": np.arange(4, dtype=np.int32),
          # pods 0, 1 and 3 fit on node 0 only, pod 2 nowhere
          "mask_idx": np.array([0, 0, 1, 0], np.int32),
          "score_idx": np.zeros((4,), np.int32),
          "nom_row": np.array([0, 0, -1, -1], np.int32),
          "unique_masks": np.array([[True, False], [False, False]]),
          "unique_scores": np.zeros((1, 2), f32),
          "resource_weights": np.ones((2,), f32)}
    nom = {"used": np.array([[2000] * 3, [0] * 3], f32),
           "count": np.array([2, 0], f32)}
    gang = [0, 1, 2] if third_member else [0, 1]
    gt = {"pod_idx": np.array(gang + [3], np.int32),
          "start": np.array([True] + [False] * (len(gang) - 1) + [True]),
          "end": np.array([False] * (len(gang) - 1) + [True, True]),
          "gang_id": np.array([0] * len(gang) + [1], np.int32),
          "entry_dom_idx": np.full((len(gang) + 1,), -1, np.int32),
          "pin_dom": np.full((len(gang) + 1,), -1, np.int32),
          "dom_tab": np.zeros((1, 2), np.int32)}
    return nc, us, pb, gt, nom


def test_gang_lands_on_its_own_reservations_with_exempt_mates():
    """Both members place on the node their plan reserved for them; the
    reference's self-exemption counts the gang-mate's reservation on top
    of the first member's trial placement and rejects the gang (ROADMAP
    Queue C)."""
    nc, us, pb, gt, nom = _reserved_pair(third_member=False)
    c, u, p = tables_from_numpy(nc, us, pb)
    got = tg.gang_schedule_batch(c, u, p, gang_table_from_numpy(gt),
                                 nom_from_numpy(nom), exempt_mates=True)
    assert got[0].tolist() == [0, 0, -1, -1]
    ref = jg.gang_schedule_batch(_dev(nc), _dev(us), _dev(pb), _dev(gt),
                                 _dev(nom))
    assert np.asarray(ref[0]).tolist() == [-1, -1, -1, -1]
    assert tg.gang_schedule_batch(c, u, p, gang_table_from_numpy(gt),
                                  nom_from_numpy(nom))[0].tolist() == \
        [-1, -1, -1, -1]


def test_rejected_gang_keeps_its_reservations_from_a_later_singleton():
    """The gang is rejected (its third member fits nowhere), its trial is
    dropped, and the singleton after it in the same batch still reads
    the gang's reservations on node 0: 2000 reserved + 1000 > 2500, so it
    does not take the space the gang's preemption freed."""
    nc, us, pb, gt, nom = _reserved_pair(third_member=True)
    c, u, p = tables_from_numpy(nc, us, pb)
    assign, score, usage = tg.gang_schedule_batch(
        c, u, p, gang_table_from_numpy(gt), nom_from_numpy(nom),
        exempt_mates=True)
    assert assign.tolist() == [-1, -1, -1, -1]
    # the first two members did place inside the dropped trial
    assert (score[:2] > -1e29).all() and score[3] == np.float32(-1e30)
    for k in ("used", "nonzero_used", "pod_count"):
        assert torch.equal(usage[k], torch.from_numpy(us[k]))
    # and without the gang's reservations the singleton would fit there
    free = {k: v * 0 for k, v in nom.items()}
    assert tg.gang_schedule_batch(
        c, u, p, gang_table_from_numpy(gt), nom_from_numpy(free),
        exempt_mates=True)[0].tolist() == [-1, -1, -1, 0]


def test_all_singleton_batch_equals_the_classic_scan():
    """The reference's claim (gang.py :30-33): a batch of singletons in
    pod order decides as schedule_batch's classic branch."""
    for seed in range(4):
        rng = np.random.default_rng(40 + seed)
        nc, us, pb, gt = _random_instance(rng, N=32, P=32, gang_sizes=(),
                                          constrained=())
        # every pod a unit of its own, in pod order
        gt["pod_idx"] = np.arange(32, dtype=np.int32)
        j, t = _both(nc, us, pb, gt)
        _assert_equal(j, t)
        c, u, p = tables_from_numpy(nc, us, pb)
        carry, terms = tb._carry_setup(u, p)
        packed = tb._pod_scan_plain(c, p, carry, terms)
        gang_packed, gang_usage = tg.gang_schedule_packed(
            c, u, p, gang_table_from_numpy(gt))
        assert torch.equal(packed, gang_packed)
        for k in ("used", "nonzero_used", "pod_count"):
            assert torch.equal(carry[k].view(torch.int32),
                               gang_usage[k].view(torch.int32))


@pytest.mark.parametrize("seed", range(4))
def test_gang_feasible_plain_matches_jax(seed):
    rng = np.random.default_rng(seed)
    P, N, G, M = 24, 10, 9, 5
    fits = rng.random((P, N)) < 0.08
    members = rng.integers(-1, P, (G, M)).astype(np.int32)
    members[0] = -1            # an empty gang is feasible
    want = np.asarray(jg.gang_feasible(jnp.asarray(fits),
                                       jnp.asarray(members)))
    got = tg.gang_feasible(torch.tensor(fits), torch.tensor(members))
    np.testing.assert_array_equal(want, got.numpy())
    assert want.any() and not want.all()


# ------------------------------------------------------------ domains


def _domain_arrays(rng, D, U):
    """[D, U] domain tables whose priority sums depend on their order:
    every unit near priority 2·10^9, all of one top priority and clean,
    so psumv (in f32) decides between domains of one prefix length."""
    f32 = np.float32
    n_units = rng.integers(1, U + 1, D)
    valid = np.arange(U)[None, :] < n_units[:, None]
    dslots = np.where(valid, rng.integers(0, 3, (D, U)), 0).astype(f32)
    top = np.where(valid, 2_000_000_000, np.iinfo(np.int32).min) \
        .astype(np.int32)
    psum = np.where(valid, rng.integers(1_999_999_000, 2_000_000_000,
                                        (D, U)), 0).astype(f32)
    base = rng.integers(0, 3, D).astype(f32)
    return {"base": base, "need": f32(max(4, U // 2)), "dslots": dslots,
            "valid": valid, "pdb": (rng.random((D, U)) < 0.02) & valid,
            "top": top, "psum": psum,
            "gcnt": np.where(valid, rng.integers(1, 9, (D, U)), 0)
            .astype(np.int32),
            "startr": np.where(valid, rng.integers(0, 4, (D, U)), -1)
            .astype(np.int32),
            "row_valid": rng.random(D) < 0.95}


def _price_both(a):
    j = jpk.price_domains(*(a[k] for k in tpk.DOMAIN_KEYS))
    t = tpk.price_domains(*(domain_tables_from_numpy(a)[k]
                            for k in tpk.DOMAIN_KEYS))
    return tuple(np.asarray(x) for x in j), tuple(x.numpy() for x in t)


@pytest.mark.parametrize("U", [4, 16, 17, 32, 64, 2048, 16384])
def test_price_domains_plain_matches_jax(U):
    winners = set()
    for seed in range(6):
        a = _domain_arrays(np.random.default_rng(U * 10 + seed), 48, U)
        j, t = _price_both(a)
        for name, x, y in zip(("winner", "chosen", "nviol"), j, t):
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)
        winners.add(int(t[0]))
    assert max(winners) >= 0


def _one_unit_domains(D):
    """Every valid domain needs exactly its first unit (one unit chosen a
    row): the rows' costs are that unit's pdb, top, psum, gcnt, startr."""
    a = _domain_arrays(np.random.default_rng(D), D, 4)
    a["valid"][:] = True
    a["base"][:] = 0.0
    a["need"] = np.float32(1.0)
    a["dslots"][:] = 1.0
    a["row_valid"][:] = True
    a["pdb"][:] = False
    return a


def _assert_same(a):
    j, t = _price_both(a)
    for name, x, y in zip(("winner", "chosen", "nviol"), j, t):
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    return int(t[0])


def test_price_domains_plain_nan_psum_matches_jax():
    """A NaN psumv among the rows tied on (nviol, topv) gives -1 in both
    packages; a NaN outside them changes nothing."""
    a = _one_unit_domains(64)
    a["top"][:, 0] = 2_000_000_000
    a["top"][20:24, 0] = 1_999_999_999      # the least topv
    a["psum"][50, 0] = np.nan
    assert 20 <= _assert_same(a) < 24
    a["psum"][22, 0] = np.nan
    assert _assert_same(a) == -1


def test_price_domains_plain_ties_lowest_row_matches_jax():
    """Rows tied on all five criteria: the lowest feasible one wins."""
    a = _one_unit_domains(64)
    for k in ("top", "psum", "gcnt", "startr"):
        a[k][:, 0] = a[k][0, 0]
    a["row_valid"][:37] = False
    assert _assert_same(a) == 37


@pytest.mark.parametrize("D,U", [(5, 17), (33, 100), (3, 1000)])
def test_price_domains_plain_fractional_slots_matches_jax(D, U):
    """Non-integer dslots at ragged widths: the blocked prefix order
    decides which unit first fits, in both packages."""
    rng = np.random.default_rng(D * U)
    a = _domain_arrays(rng, D, U)
    a["dslots"] = np.where(a["valid"], rng.random((D, U)) * rng.choice(
        [1e-3, 0.7, 3e3], (D, U)), 0).astype(np.float32)
    a["need"] = np.float32(np.median(a["dslots"].sum(1)) / 2 + 0.1)
    _assert_same(a)


def _storm_infos(side, n_nodes):
    """The storm cluster (workload.storm_objects) as NodeInfos."""
    api = side["api"]
    nodes, victims, pdb = workload.storm_objects(api, n_nodes)
    infos = {n.metadata.name: side["NodeInfo"](n) for n in nodes}
    for v in victims:
        infos[v.spec.node_name].add_pod(v)
    return infos, [pdb]


@pytest.mark.parametrize("min_member", [8, 4])
def test_build_domain_tables_matches_jax(min_member):
    _domain_tables_match(48, min_member, workload.STORM_SLICE)


def test_build_domain_tables_keyless_matches_jax():
    """A gang with no topology key: every candidate's domain is "", so
    the whole 352-node storm cluster is one row of more than 1,024 victim
    units, priced at U = 2,048."""
    tt = _domain_tables_match(352, 8, "")
    assert tt.domains == [""] and tt.arrays["dslots"].shape == (1, 2048)


def _domain_tables_match(n_nodes, min_member, topology_key):
    """build_domain_tables on the storm cluster in both packages: equal
    tables, and price_domains on them equal to JAX's; returns the port's
    tables."""
    out = []
    for side in (JAX, PORT):
        infos, pdbs = _storm_infos(side, n_nodes)
        _, members = workload.storm_gang(side["api"], 0)
        cands = [(n, ni, ni.node.metadata.labels[topology_key]
                  if topology_key else "")
                 for n, ni in sorted(infos.items())]
        out.append(side["pk"].build_domain_tables(
            members[:min_member], cands, infos, pdbs, min_member))
    jt, tt = out
    assert jt.domains == tt.domains and jt.res_names == tt.res_names
    assert [[(u.key, n, j) for u, n, j in row] for row in jt.units] == \
        [[(u.key, n, j) for u, n, j in row] for row in tt.units]
    for dom in jt.domains:
        assert [(n, c.tolist()) for n, c in jt.nodes[dom]] == \
            [(n, c.tolist()) for n, c in tt.nodes[dom]]
    assert set(jt.arrays) == set(tt.arrays)
    for k, v in jt.arrays.items():
        w = tt.arrays[k]
        assert np.asarray(v).dtype == np.asarray(w).dtype, k
        np.testing.assert_array_equal(np.atleast_1d(v).view(np.uint8),
                                      np.atleast_1d(w).view(np.uint8), k)
    j, t = _price_both(tt.arrays)
    for x, y in zip(j, t):
        np.testing.assert_array_equal(x, y)
    assert int(t[0]) >= 0 and t[1][int(t[0])].any()
    return tt


# ------------------------------------------------------------ end to end


def _node(api, name, cpu="4", mem="32Gi", labels=None):
    node = workload.make_node(api, 0)
    node.metadata.name = name
    node.metadata.labels = {api.wellknown.LABEL_HOSTNAME: name,
                            **(labels or {})}
    q = {"cpu": api.Quantity(cpu), "memory": api.Quantity(mem),
         "pods": api.Quantity(110)}
    node.status.capacity, node.status.allocatable = dict(q), dict(q)
    return node


def _pod(api, name, cpu="100m", group=None):
    pod = workload.make_pod(api, 0)
    pod.metadata.name = name
    pod.metadata.labels = {api.wellknown.LABEL_POD_GROUP: group} \
        if group else {}
    pod.spec.containers[0].resources.requests = {
        "cpu": api.Quantity(cpu), "memory": api.Quantity("200Mi")}
    return pod


def _scenario(name, side):
    """(nodes, groups, pods, batch size) of tests/test_gang.py's three
    end-to-end scenarios in `side`'s types."""
    api = side["api"]
    if name == "partial-gang-binds-zero":
        # two 1-CPU nodes: a 3-member gang of 600m pods can place at
        # most 2 members and must bind none; a singleton still lands
        nodes = [_node(api, f"n{i}", cpu="1", mem="2Gi") for i in (1, 2)]
        groups = [workload.pod_group(api, "g1", 3)]
        pods = [_pod(api, f"w{i}", "600m", "g1") for i in range(3)] + \
            [_pod(api, "solo")]
        return nodes, groups, pods, 16
    if name == "gang-in-one-domain":
        nodes = [_node(api, f"n{i}", labels={"tpu/slice": "ab"[i // 2]})
                 for i in range(4)] + [_node(api, "plain")]
        groups = [workload.pod_group(api, "g1", 3, "tpu/slice")]
        pods = [_pod(api, f"w{i}", group="g1") for i in range(3)]
        return nodes, groups, pods, 16
    # permit-timeout: batch size 1 splits the gang; the placeable member
    # reserves its node, the other can never place, the timeout rolls
    # the reservation back
    nodes = [_node(api, "n1", cpu="1", mem="2Gi")]
    groups = [workload.pod_group(api, "g1", 2, timeout=1)]
    pods = [_pod(api, "fits", "600m", "g1"), _pod(api, "never", "30", "g1")]
    return nodes, groups, pods, 1


def _run_loop(side, nodes, groups, pods, batch, max_rounds=64,
              victims=None):
    """Create the objects through side's Client, then drive the Scheduler
    on this thread until nothing is pending (or max_rounds)."""
    clock = side["FakeClock"]()
    client = side["Client"](validate=False)
    for n in nodes:
        client.nodes().create(n)
    for g in groups:
        client.pod_groups("default").create(g)
    sched = side["Scheduler"](client, batch_size=batch, clock=clock,
                              **side["kw"])
    pump = workload.InformerPump(sched.informers)
    try:
        for p in pods:
            client.pods().create(p)
        pump.pump()
        bound = workload.drain_until_idle(sched, pump, clock, max_rounds)
    finally:
        pump.close()
    stored = {p.metadata.name: p for p in client.pods().list()}
    events = sorted((e.reason, e.involved_object.name, e.message)
                    for e in client.events("default").list()
                    if e.reason == "Preempted")
    gm = sched.gang_metrics
    return {"bound": bound,
            "binds": {k: p.spec.node_name for k, p in stored.items()},
            "nominated": {k: p.status.nominated_node_name
                          for k, p in stored.items()},
            "assumed": sorted(sched.cache.pod_keys_snapshot()[1]),
            "gangs": (gm.gangs_admitted.value(), gm.gangs_rejected.value(),
                      gm.gangs_timed_out.value()),
            "preemption": (sched.metrics.preemption_attempts.value(),
                           sched.metrics.preemption_victims.value()),
            "events": events,
            "evicted": sorted(v.metadata.name for v in victims or ()
                              if v.metadata.name not in stored)}


SCENARIOS = ("partial-gang-binds-zero", "gang-in-one-domain",
             "permit-timeout")


@pytest.mark.parametrize("name", SCENARIOS)
def test_gang_scenarios_bind_like_jax(name, monkeypatch):
    monkeypatch.setenv("KTPU_COMMIT_THREAD", "0")
    runs = []
    for side in (JAX, PORT):
        nodes, groups, pods, batch = _scenario(name, side)
        runs.append(_run_loop(side, nodes, groups, pods, batch,
                              max_rounds=8))
    j, t = runs
    assert j == t
    binds = t["binds"]
    if name == "partial-gang-binds-zero":
        assert [k for k, v in binds.items() if v] == ["solo"]
        assert t["gangs"][1] >= 1 and not t["assumed"]
    elif name == "gang-in-one-domain":
        assert all(binds.values())
        assert len({binds[f"w{i}"] in ("n0", "n1") for i in range(3)}) == 1
        assert t["gangs"][0] >= 1
    else:
        # the reservation timed out and rolled back (the member may hold
        # a fresh one from the round after), and nothing ever bound
        assert not any(binds.values()) and t["gangs"][2] >= 1
        assert t["assumed"] in ([], ["default/fits"])


def _gang_storm(side, n_nodes, n_gangs, first_round_only=False,
                topology_key=workload.STORM_SLICE):
    """bench.py preempt_main's gang storm through side's Client and
    Scheduler: the storm cluster (workload.storm_objects), then gangs of
    8 arriving one after another, each drained on this thread until
    nothing is pending (workload.drain_until_idle). With
    `first_round_only`, the first gang's first drain only."""
    api = side["api"]
    nodes, victims, pdb = workload.storm_objects(api, n_nodes)
    clock = side["FakeClock"]()
    client = side["Client"](validate=False)
    for n in nodes:
        client.nodes().create(n)
    created = [client.pods().create(v) for v in victims]
    client.pod_disruption_budgets("default").create(pdb)
    sched = side["Scheduler"](client, batch_size=64, clock=clock,
                              **side["kw"])
    pump = workload.InformerPump(sched.informers)
    bound = 0
    try:
        for g in range(n_gangs):
            group, members = workload.storm_gang(
                api, g, topology_key=topology_key)
            client.pod_groups("default").create(group)
            for p in members:
                client.pods().create(p)
            pump.pump()
            bound += workload.drain_until_idle(
                sched, pump, clock, 1 if first_round_only else 64)
    finally:
        pump.close()
    stored = {p.metadata.name: p for p in client.pods().list()}
    events = sorted((e.involved_object.name, e.message)
                    for e in client.events("default").list()
                    if e.reason == "Preempted")
    return {"bound": bound,
            "binds": {k: p.spec.node_name for k, p in stored.items()},
            "evicted": sorted(v.metadata.name for v in created
                              if v.metadata.name not in stored),
            "nominated": {k: p.status.nominated_node_name
                          for k, p in stored.items()
                          if k.startswith("gang")},
            "events": events,
            "prio": {v.metadata.name: v.spec.priority for v in created},
            "slice": {n.metadata.name: n.metadata.labels[
                workload.STORM_SLICE] for n in nodes},
            "metrics": (sched.metrics.preemption_attempts.value(),
                        sched.metrics.preemption_victims.value())}


def test_gang_storm_plans_like_jax(monkeypatch):
    """A gang of 8 (2 CPU / 3Gi at priority 1000, minMember 8, one
    tpu/slice) on a full 32-node storm cluster: the first drain prices it
    over the 4 slices (price_domains_plain), nominates its members across
    the winner's freed nodes and evicts the chosen units. The evicted
    victims, nominations and Preempted events equal JAX's."""
    monkeypatch.setenv("KTPU_COMMIT_THREAD", "0")
    priced = []
    orig = tpk.price_domains_plain
    monkeypatch.setattr(tpk, "price_domains_plain", lambda *a: priced.append(
        a[2].shape) or orig(*a))
    j = _gang_storm(JAX, 32, 1, first_round_only=True)
    t = _gang_storm(PORT, 32, 1, first_round_only=True)
    for k in ("evicted", "nominated", "events"):
        assert t[k] == j[k], k
    assert priced and t["evicted"]
    assert all(t["prio"][v] < 1000 for v in t["evicted"])
    assert len(set(t["nominated"].values()) - {""}) >= 2
    assert {t["slice"][n] for n in t["nominated"].values()} != {""} and \
        len({t["slice"][n] for n in t["nominated"].values()}) == 1


def test_gang_storm_lands_every_gang(monkeypatch):
    """Two gangs arriving one after another on the storm cluster through
    the port's Scheduler: each lands whole in one slice, every evicted
    victim ranks below it, and preemption_attempts counts the plans. (The
    plan nominates two members to one node where a node frees two slots;
    the reference's overlay keeps the gang's own reservations then and
    the gang never lands: ROADMAP Queue C.)"""
    monkeypatch.setenv("KTPU_COMMIT_THREAD", "0")
    t = _gang_storm(PORT, 32, 2)
    assert t["bound"] == 16
    members = [k for k in t["binds"] if k.startswith("gang")]
    assert len(members) == 16 and all(t["binds"][k] for k in members)
    for g in range(2):
        slices = {t["slice"][t["binds"][f"gang{g}-{i}"]] for i in range(8)}
        assert len(slices) == 1
    assert t["evicted"] and all(t["prio"][v] < 1000 for v in t["evicted"])
    assert t["metrics"][0] >= 2


def test_keyless_gang_storm_plans_like_jax(monkeypatch):
    """A gang of 8 with no topology key on a full 352-node storm cluster:
    preempt_gang prices the whole cluster as one domain row, more than
    1,024 victim units wide (U = 2,048), in one price_domains call. The
    first drain's evicted victims, nominations and Preempted events equal
    JAX's; the port's drain then lands the gang whole."""
    monkeypatch.setenv("KTPU_COMMIT_THREAD", "0")
    priced = []
    orig = tpk.price_domains_plain
    monkeypatch.setattr(tpk, "price_domains_plain", lambda *a: priced.append(
        tuple(a[2].shape)) or orig(*a))
    j = _gang_storm(JAX, 352, 1, first_round_only=True, topology_key="")
    t = _gang_storm(PORT, 352, 1, first_round_only=True, topology_key="")
    for k in ("evicted", "nominated", "events"):
        assert t[k] == j[k], k
    assert priced and priced[0][0] == 1 and priced[0][1] > 1024
    assert t["evicted"] and all(t["prio"][v] < 1000 for v in t["evicted"])
    assert len(set(t["nominated"].values()) - {""}) >= 2
    t = _gang_storm(PORT, 352, 1, topology_key="")
    assert t["bound"] == 8 and all(t["binds"][f"gang0-{i}"]
                                   for i in range(8))
    assert all(t["prio"][v] < 1000 for v in t["evicted"])
