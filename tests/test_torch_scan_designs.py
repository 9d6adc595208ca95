"""The host's choice of K2 and K9 designs, on the CPU.

K2 runs its "shared" design (csrc/class_scan_shared.cu), the [C, N]
table and the class constants in shared memory, where they fit beside
the step's scratch, and its "global" design (csrc/class_scan.cu)
otherwise; K9 (csrc/gang_scan.cu) runs its "cluster" design, each of 16
CTAs holding its rows' state in shared memory, where that fits, and its
single-block "block" design otherwise. The choice is pure Python over
the batch's sizes (kernels/batch.py class_scan_design, kernels/gang.py
gang_design), mirrored by the C launchers, which refuse a batch their
design does not take. These tests pin the choice at the main paths'
sizes and at the edges, the per-design launch counts, and the ctypes
parameter blocks against the C structs they stand for. One test a
kernel: each walks its cases and names the failing one.
"""

import re
from pathlib import Path

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
