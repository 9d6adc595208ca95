"""The host's choice of K2, K7, K9, K12 and K15 designs, on the CPU.

K2 runs its "shared" design (csrc/class_scan_shared.cu), the [C, N]
table and the class constants in shared memory, where they fit beside
the step's scratch, and its "global" design (csrc/class_scan.cu)
otherwise; K7 (csrc/pod_scan_cluster.cu) and K9 (csrc/gang_scan.cu) run
their "cluster" designs, each of 16 CTAs holding its rows' state in
shared memory, where that fits, and their single-block "block" designs
otherwise; K15 runs its "shared" design (csrc/shard_scan_shared.cu), each
CTA of a cluster of up to 16 holding its slice of the table, where the
slice fits, and its "global" design (csrc/shard_scan.cu) otherwise. The
choice is pure Python over the batch's sizes (kernels/batch.py
class_scan_design, pod_scan_design, shard_scan_design, kernels/gang.py
gang_design, spec_scan_design), mirrored by the C launchers, which
refuse a batch their design does not take. These tests pin the choice at
the main paths' sizes and at the edges, the per-design launch counts, and
the ctypes parameter blocks against the C structs they stand for. One
test a kernel: each walks its cases and names the failing one. K12's two
designs check a cohort's fence first (only the members before the first
pod that reads carried terms are elected and checked): two tests hold
that rule against the whole cohort's checks and against the JAX kernel's
stats.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch.scheduler.kernels import batch as kb
from kubernetes_tpu_torch.scheduler.kernels import gang as gk

CSRC = Path(kb.__file__).resolve().parents[2] / "csrc"

#: (C, N, R, G, Z, spread, design) for K2
K2_CASES = [
    # uniform, scheduler and nominated batches: 4 classes, 8,192 rows
    (4, 8192, 8, 0, 0, False, "shared"),
    # the spread batch: one group, zones of the bench's cluster
    (4, 8192, 8, 1, 17, True, "shared"),
    # the preferred batch: 4 classes on 1,024 rows
    (4, 1024, 8, 0, 0, False, "shared"),
    # the anti-affinity batch: 512 classes (a 2 MB table)
    (512, 1024, 8, 0, 0, False, "global"),
    # the service batch: about 1,000 templates
    (1000, 8192, 8, 0, 0, False, "global"),
    # more rows than 16 a thread of 512
    (4, 16384, 8, 0, 0, False, "global"),
    (1, 8193, 8, 0, 0, False, "global"),
    # more classes than the refresh's warp takes
    (33, 1024, 8, 0, 0, False, "global"),
    (32, 1024, 8, 0, 0, False, "shared"),
    # a usage row wider than the shared step's scratch
    (4, 1024, 65, 0, 0, False, "global"),
    (4, 1024, 64, 0, 0, False, "shared"),
    # spread: the zone sums count, held counts do not decide the design
    (4, 8192, 8, 64, 17, True, "shared"),
]

#: (N, R, design) for K9
K9_CASES = [
    (8192, 8, "cluster"),      # the gang and gang-preemption batches
    (128, 8, "cluster"),       # the small gang drain's capacity
    (100, 3, "cluster"),       # fewer rows than the cluster's threads
    (5, 8, "cluster"),         # fewer rows than CTAs
    (32768, 8, "cluster"),     # 2,048 rows a CTA, 4 a thread of 512
    (32769, 8, "block"),       # one row more than the cluster's threads
    (8192, 64, "block"),       # 529 bytes a row: 270 KB a CTA
    (8192, 48, "block"),       # 200.5 KB a CTA
    (8192, 47, "cluster"),
]


def _c_fields(path, struct):
    """Field names of a C struct in declaration order."""
    src = path.read_text()
    body = re.search(r"struct %s \{(.*?)\n\};" % struct, src, re.S).group(1)
    names = []
    for line in body.splitlines():
        line = line.split("//")[0].strip().rstrip(";")
        if not line:
            continue
        decl = re.sub(r"^(const\s+)?(long\s+)*\w+\s*\**\s*", "", line)
        names += [n.strip().lstrip("*") for n in decl.split(",")]
    return names


def test_class_scan_design_choice():
    for C, N, R, G, Z, spread, want in K2_CASES:
        assert kb.class_scan_design(C, N, R, G, Z, spread) == want, \
            (C, N, R, G, Z, spread)
    # every C <= 32 fits at N = 1,024; at N = 8,192 the largest table
    # that fits takes the shared design and one class more the global
    N, R = 1024, 8
    assert all(kb.class_scan_smem_words(C, N, R, 0, 0, False, False) * 4
               <= kb.SCAN_SMEM_LIMIT for C in range(1, 33))
    N = 8192
    C_max = max(C for C in range(1, 33)
                if kb.class_scan_smem_words(C, N, R, 0, 0, False, False) * 4
                <= kb.SCAN_SMEM_LIMIT)
    assert kb.class_scan_design(C_max, N, R) == "shared"
    assert kb.class_scan_design(C_max + 1, N, R) == "global"
    # the held spread counts need not fit for the shared design
    assert kb.class_scan_smem_words(4, N, R, 64, 17, True, True) * 4 > \
        kb.SCAN_SMEM_LIMIT
    # a launch count for every instance in each design, reset with the
    # instance counts
    for name in kb.LAUNCHES:
        if name.startswith("class_scan"):
            for d in kb.CLASS_SCAN_DESIGNS:
                assert f"{name}:{d}" in kb.DESIGN_LAUNCHES, (name, d)
    kb.DESIGN_LAUNCHES["class_scan:shared"] = 3
    kb.reset_launches()
    assert not any(kb.DESIGN_LAUNCHES.values())
    # the ctypes block lists KtpuScanParams's fields in order
    assert _c_fields(CSRC / "class_step.cuh", "KtpuScanParams") == \
        [f for f, _ in kb._ScanParams._fields_]


def test_gang_design_choice():
    for N, R, want in K9_CASES:
        assert gk.gang_design(N, R) == want, (N, R)
    N = 8192
    rows = N // gk.GANG_CLUSTER
    R_max = max(R for R in range(2, 65)
                if gk.gang_smem_bytes(rows, R) <= gk.GANG_SMEM_LIMIT)
    assert gk.gang_design(N, R_max) == "cluster"
    assert gk.gang_design(N, R_max + 1) == "block"
    for name in gk.LAUNCHES:
        if name.startswith("gang_scan"):
            for d in gk.GANG_SCAN_DESIGNS:
                assert f"{name}:{d}" in gk.DESIGN_LAUNCHES, (name, d)
    gk.DESIGN_LAUNCHES["gang_scan_cap:cluster"] = 2
    gk.reset_launches()
    assert not any(gk.DESIGN_LAUNCHES.values())
    assert _c_fields(CSRC / "gang_scan.cu", "KtpuGangScanParams") == \
        [f for f, _ in gk._GangParams._fields_]


SPREAD = (True, False, False, False)
TOPO = (False, True, True, False)
SOFT = (False, False, False, True)
NONE = (False, False, False, False)

#: (N, R, G, Z, terms, nom, design) for K7
K7_CASES = [
    # the classic, classic-spread and classic-nominated batches
    (8192, 8, 0, 0, NONE, False, "cluster"),
    (8192, 8, 1, 17, SPREAD, False, "cluster"),
    (8192, 8, 0, 0, NONE, True, "cluster"),
    # classic-anti-affinity and classic-preferred: 64 rows a CTA
    (1024, 8, 0, 0, TOPO, False, "cluster"),
    (1024, 8, 0, 0, SOFT, False, "cluster"),
    # zones: the exchange's lanes hold 32
    (8192, 8, 1, 32, SPREAD, False, "cluster"),
    (8192, 8, 1, 33, SPREAD, False, "block"),
    (8192, 8, 1, 0, SPREAD, False, "block"),
    # zones do not count without spread groups
    (8192, 8, 0, 40, NONE, False, "cluster"),
    # rows: 16 x 512 threads x 4 rows, and one more
    (16 * 512 * 4, 8, 0, 0, NONE, False, "cluster"),
    (16 * 512 * 4 + 1, 8, 0, 0, NONE, False, "block"),
    (5, 8, 0, 0, NONE, False, "cluster"),
    # shared memory at 512 rows a CTA: 47 columns fit, 48 do not; with
    # the overlay's reservations 31 and 32
    (8192, 47, 0, 0, NONE, False, "cluster"),
    (8192, 48, 0, 0, NONE, False, "block"),
    (8192, 31, 0, 0, NONE, True, "cluster"),
    (8192, 32, 0, 0, NONE, True, "block"),
    # held spread counts need not fit
    (8192, 8, 64, 17, SPREAD, False, "cluster"),
    # usage rows the resource score cannot read, or wider than the
    # kernels' scratch
    (8192, 1, 0, 0, NONE, False, "block"),
    (1024, 65, 0, 0, NONE, False, "block"),
]

#: (C, N, R, D, G, Z, terms, design) for K15
K15_CASES = [
    # the sharded-uniform / -scheduler / -nominated batches at 8 shards,
    # and the SHARD_WIDTHS sweep
    (4, 8192, 8, 8, 0, 0, NONE, "shared"),
    (4, 8192, 8, 4, 0, 0, NONE, "shared"),
    (4, 8192, 8, 2, 0, 0, NONE, "shared"),
    # sharded-spread
    (4, 8192, 8, 8, 1, 17, SPREAD, "shared"),
    # sharded-anti-affinity: 512 classes, 64 rows a CTA (155 KB: the
    # design takes it, but its refresh of 16 passes costs more than it
    # saves); 32 classes take one pass
    (512, 1024, 8, 8, 0, 0, TOPO, "global"),
    (32, 1024, 8, 8, 0, 0, TOPO, "shared"),
    (33, 1024, 8, 8, 0, 0, TOPO, "global"),
    # sharded-preferred
    (4, 1024, 8, 8, 0, 0, SOFT, "shared"),
    # sharded-pad: 3 shards of 2,731 rows over 15 CTAs
    (4, 8193, 8, 3, 0, 0, NONE, "shared"),
    # zones
    (4, 8192, 8, 8, 1, 32, SPREAD, "shared"),
    (4, 8192, 8, 8, 1, 33, SPREAD, "global"),
    # rows: 2,048 a CTA (512 threads x 4), and one more
    (4, 32768, 8, 8, 0, 0, NONE, "shared"),
    (4, 32776, 8, 8, 0, 0, NONE, "global"),
    # the service batch's ~1,000 classes over 8,192 rows
    (1000, 8192, 8, 8, 0, 0, NONE, "global"),
    # a slice of exactly 200 KB (51,200 words: 31 classes, 1,210 rows a
    # CTA), and one of a word past it (SLICE_PAST)
    (31, 19360, 8, 8, 0, 0, NONE, "shared"),
    # shard counts the mesh does not take, or that do not divide N
    (4, 8192, 8, 9, 0, 0, NONE, "global"),
    (4, 8192, 8, 1, 0, 0, NONE, "global"),
    (4, 8192, 8, 3, 0, 0, NONE, "global"),
]


def test_pod_scan_design_choice():
    for N, R, G, Z, terms, nom, want in K7_CASES:
        assert kb.pod_scan_design(N, R, G, Z, terms, nom) == want, \
            (N, R, G, Z, terms, nom)
    # the same edge from the byte count: the widest usage row that fits
    # 512 rows a CTA takes the cluster design, one column more the block
    rows = 8192 // kb.POD_CLUSTER
    for nom in (False, True):
        R_max = max(R for R in range(2, 65)
                    if kb.pod_cluster_smem_bytes(rows, R, 0, nom)
                    <= kb.POD_SMEM_LIMIT)
        assert kb.pod_scan_design(8192, R_max, nom=nom) == "cluster"
        assert kb.pod_scan_design(8192, R_max + 1, nom=nom) == "block"
    # a launch count for every instance in each design, reset with the
    # instance counts
    for name in kb.LAUNCHES:
        if name.startswith("pod_scan"):
            for d in kb.POD_SCAN_DESIGNS:
                assert f"{name}:{d}" in kb.DESIGN_LAUNCHES, (name, d)
    kb.DESIGN_LAUNCHES["pod_scan_spread:cluster"] = 3
    kb.reset_launches()
    assert not any(kb.DESIGN_LAUNCHES.values())
    # the ctypes block lists KtpuPodScanParams's fields in order
    assert _c_fields(CSRC / "pod_scan.cuh", "KtpuPodScanParams") == \
        [f for f, _ in kb._PodScanParams._fields_]


#: (C, N, R, D): a slice one word past 200 KB (51,201 words: 20 classes
#: of 5 columns, 1,822 rows a CTA), which the shared design refuses
SLICE_PAST = (20, 29144, 5, 8)


def test_shard_scan_design_choice():
    for C, N, R, D, G, Z, terms, want in K15_CASES:
        assert kb.shard_scan_design(C, N, R, D, G, Z, terms) == want, \
            (C, N, R, D, G, Z, terms)
    # the design takes 512 classes; the host gives it 32 at most
    assert kb.shard_shared_fits(512, 1024, 8, 8, 0, 0, TOPO)
    assert not kb.shard_shared_fits(*SLICE_PAST)
    assert kb.shard_scan_design(*SLICE_PAST) == "global"
    # the cluster: 16 CTAs at 2, 4 and 8 shards, 15 at 3
    assert [kb.shard_ctas(D) * D for D in (2, 3, 4, 8)] == [16, 15, 16, 16]
    # the 200 KB edge of the two slices above, from the byte count
    assert kb.shard_smem_words(31, 1210, 8) * 4 == kb.SHARD_SMEM_LIMIT
    C, N, R, D = SLICE_PAST
    rows = -(-(N // D) // kb.shard_ctas(D))
    assert kb.shard_smem_words(C, rows, R) * 4 == kb.SHARD_SMEM_LIMIT + 4
    # held spread counts need not fit
    assert kb.shard_scan_design(31, 19360, 8, 8, 4, 17, SPREAD) == "shared"
    assert kb.shard_smem_words(31, 1210, 8, 4, True) * 4 > \
        kb.SHARD_SMEM_LIMIT
    for name in kb.LAUNCHES:
        if name.startswith("shard_scan"):
            for d in kb.SHARD_SCAN_DESIGNS:
                assert f"{name}:{d}" in kb.DESIGN_LAUNCHES, (name, d)
    kb.DESIGN_LAUNCHES["shard_scan_topo:shared"] = 2
    kb.reset_launches()
    assert not any(kb.DESIGN_LAUNCHES.values())
    # the ctypes blocks list KtpuShardParams's and KtpuScanParams's
    # fields in order
    assert _c_fields(CSRC / "shard_scan.cuh", "KtpuShardParams") == \
        [f for f, _ in kb._ShardParams._fields_]
    assert _c_fields(CSRC / "class_step.cuh", "KtpuScanParams") == \
        [f for f, _ in kb._ShardParams._fields_[0][1]._fields_]


#: (C, N, R, G, Z, terms, nom, width, design) for K12
K12_CASES = [
    # chip_smoke.py's five batches: uniform, spread, anti-affinity (512
    # classes), preferred (1,024 rows, 64 a CTA), nominated
    (4, 8192, 8, 0, 0, NONE, False, 16, "cluster"),
    (4, 8192, 8, 1, 17, SPREAD, False, 16, "cluster"),
    (512, 1024, 8, 0, 0, TOPO, False, 16, "block"),
    (4, 1024, 8, 0, 0, SOFT, False, 16, "cluster"),
    (4, 8192, 8, 0, 0, NONE, True, 16, "cluster"),
    # classes: the refresh's warp takes 32 in one pass
    (32, 1024, 8, 0, 0, NONE, False, 16, "cluster"),
    (33, 1024, 8, 0, 0, NONE, False, 16, "block"),
    # rows: 16 CTAs x 512 threads x 4 rows, and one more
    (4, 32768, 8, 0, 0, NONE, False, 16, "cluster"),
    (4, 32769, 8, 0, 0, NONE, False, 16, "block"),
    (4, 5, 8, 0, 0, NONE, False, 16, "cluster"),
    # zones: the exchange's lanes hold 32
    (4, 8192, 8, 1, 32, SPREAD, False, 16, "cluster"),
    (4, 8192, 8, 1, 33, SPREAD, False, 16, "block"),
    (4, 8192, 8, 0, 40, NONE, False, 16, "cluster"),
    # cohorts: a lane a member
    (4, 8192, 8, 0, 0, NONE, False, 32, "cluster"),
    (4, 8192, 8, 0, 0, NONE, False, 64, "block"),
    # usage rows the resource score cannot read or the kernels' scratch
    # cannot hold
    (4, 8192, 1, 0, 0, NONE, False, 16, "block"),
    (4, 1024, 65, 0, 0, NONE, False, 16, "block"),
    # 31 classes: 960 rows a CTA fit 160 KB, 1,000 do not
    (31, 15360, 8, 0, 0, NONE, False, 16, "cluster"),
    (31, 16000, 8, 0, 0, NONE, False, 16, "block"),
]


def test_spec_scan_design_choice():
    from kubernetes_tpu_torch.scheduler.kernels import speculative as sk
    for C, N, R, G, Z, terms, nom, width, want in K12_CASES:
        assert kb.spec_scan_design(C, N, R, G, Z, terms, nom, width) == \
            want, (C, N, R, G, Z, terms, nom, width)
    # the design takes 512 classes; the host gives it 32 at most
    assert kb.spec_cluster_fits(512, 1024, 8, 0, 0, TOPO)
    assert kb.shard_smem_words(31, 1000, 8) * 4 > kb.SPEC_SMEM_LIMIT
    assert kb.shard_smem_words(31, 960, 8) * 4 <= kb.SPEC_SMEM_LIMIT
    for name in sk.LAUNCHES:
        for d in kb.SPEC_SCAN_DESIGNS:
            assert f"{name}:{d}" in kb.DESIGN_LAUNCHES, (name, d)
    kb.DESIGN_LAUNCHES["spec_scan_soft:cluster"] = 2
    kb.reset_launches()
    assert not any(kb.DESIGN_LAUNCHES.values())
    assert _c_fields(CSRC / "spec_scan.cuh", "KtpuSpecParams") == \
        [f for f, _ in sk._SpecParams._fields_]


def _first_collider(collide):
    hits = np.nonzero(np.asarray(collide))[0]
    return int(hits[0]) if len(hits) else len(collide)


@pytest.mark.parametrize("W", [8, 16, 32])
@pytest.mark.parametrize("where", ["first", "middle", "last", "none"])
def test_spec_fence_first_finds_the_same_collider(W, where):
    """K12 checks only the members before the cohort's first fenced one,
    f: a member's type-1 and type-2 checks read only earlier members, so
    the first collider over [0, f), or f, is the one the whole cohort's
    checks (the port's _cohort_checks, the reference's :161-170) give. On
    random cohorts with row clashes and near maxima, a fence at member 0,
    in the middle or last, or none."""
    from kubernetes_tpu_torch.scheduler.kernels import speculative as sk
    rng = np.random.default_rng(W * 7 + len(where))
    C = 5
    f = {"first": 0, "middle": W // 2, "last": W - 1, "none": W}[where]
    for trial in range(200):
        ok = torch.from_numpy(rng.random(W) < 0.8)
        best = torch.from_numpy(rng.integers(0, 3 * W, W).astype(np.int32))
        vbest = torch.from_numpy(rng.choice(
            [1.0, 2.0, 3.0, -0.0, 0.0], W).astype(np.float32))
        cols = torch.from_numpy(rng.choice(
            [0.5, 1.0, 2.5, 3.0, -1e30, 0.0, -0.0], (W, C)).astype(
                np.float32))
        u = torch.from_numpy(rng.integers(0, C, W))
        seq = torch.from_numpy(rng.integers(0, 1 << 16, W).astype(np.int32))
        fence = torch.zeros(W, dtype=torch.bool)
        if f < W:
            fence[f] = True
            # members past the fence may be fenced too
            fence[f + 1:] = torch.from_numpy(rng.random(W - f - 1) < 0.3)
        whole = _first_collider(
            sk._cohort_checks(ok, best, vbest, cols, u, seq, fence)[2])
        if f == 0:
            fenced = 0
        else:
            head = sk._cohort_checks(ok[:f], best[:f], vbest[:f], cols[:f],
                                     u[:f], seq[:f], fence[:f])[2]
            fenced = min(_first_collider(head), f)
        assert fenced == whole, (trial, f)


@pytest.mark.parametrize("W", [8, 16, 32])
def test_spec_fence_stats_match_jax(W):
    """The JAX speculative kernel and the port's plain version (every
    member checked) on one batch whose fence marks sit at member 0, in
    the middle, last, or nowhere in successive cohorts: the same
    (accepted, first collider) a cohort, the fence-first rule's, and the
    same decisions."""
    from kubernetes_tpu.scheduler.kernels import speculative as jspec
    from kubernetes_tpu_torch.convert import tables_from_numpy
    from kubernetes_tpu_torch.scheduler.kernels import speculative as sk
    from test_torch_affinity import _base
    cfg, use, pb = _base(0)
    P = pb["seq"].shape[0]
    plain = np.ones(P, bool)
    fences = []
    for c in range(P // W):
        at = (0, W // 2, W - 1, W)[c % 4]
        fences.append(at)
        if at < W:
            plain[c * W + at] = False
    pb = dict(pb, spec_plain=plain)
    ref = jspec.schedule_batch_speculative(cfg, use, pb, None, width=W)
    tc, tu, tpb = tables_from_numpy(cfg, use, pb, "cpu")
    got = sk.schedule_batch_speculative_plain(tc, tu, tpb, None, W)
    st = got[3].numpy()
    np.testing.assert_array_equal(np.asarray(ref[3]), st)
    np.testing.assert_array_equal(np.asarray(ref[0]), got[0].numpy())
    active = pb["active"]
    for c, at in enumerate(fences):
        if at < W and active[c * W + at]:
            assert st[c, 1] <= at and st[c, 0] == 0, (c, at, st[c])


def test_filter_params_block_matches_c_struct():
    """K8's ctypes block lists KtpuFilterParams's fields in order (the
    spread scratch table after the outputs)."""
    assert _c_fields(CSRC / "filter_score.cu", "KtpuFilterParams") == \
        list(kb._FILTER_PTRS) + list(kb._FILTER_INTS)


def test_price_domains_design_choice():
    """K11's design by its table's width, counted by the one the C entry
    takes: a warp a row up to KTPU_DOMAIN_NARROW_U units, one block a
    row past it."""
    from kubernetes_tpu_torch.scheduler.kernels import preempt as pk
    src = (CSRC / "price_domains.cu").read_text()
    narrow = re.search(r"#define KTPU_DOMAIN_NARROW_U (\d+)", src)
    assert narrow and int(narrow.group(1)) == pk.DOMAIN_ROWS_MAX_U
    assert "if (U <= KTPU_DOMAIN_NARROW_U)" in src
    for U, design in ((1, "rows"), (32, "rows"), (1024, "rows"),
                      (1025, "wide"), (16384, "wide"), (1 << 24, "wide")):
        assert pk.price_domains_design(U) == design, U
    assert set(pk.DESIGN_LAUNCHES) == {"price_domains:rows",
                                       "price_domains:wide"}
