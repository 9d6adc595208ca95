"""The batch scans on the GPU: score table, serial class scan, classic
per-pod scan, the [P, N] fits and scores, dirty-row scatter.

Port of kubernetes_tpu/scheduler/kernels/batch.py. Every function here has
a plain PyTorch version in the same f32 operation order as the JAX
reference (so the two agree bit for bit), and every device program has a
hand-written CUDA kernel (csrc/):

    class_ms_init  -> K1  csrc/class_ms_init.cu   [C, N] masked scores,
                          with the nominated reservations folded into
                          feasibility (_nom_feas_usage)
    schedule_batch -> K2  csrc/class_scan.cu      the class route, one
                          (+ class_scan_shared.cu) launch per batch, in
                          the design class_scan_design picks; class_col,
                          spread_score and tie_penalized are its
                          __device__ functions,
                          pack_results its epilogue; the required
                          (anti-)affinity carry (term_hits / topo_bad /
                          topo_scatter) and the preferred credits
                          (soft_raw / soft_score / soft_write) live in
                          csrc/affinity.cuh; the nominated overlay (the
                          nominee's own row exempt, the winner column
                          refreshed with the reservations) is its NOM
                          instance
    schedule_batch -> K7  csrc/pod_scan.cu        the classic per-pod
                          (+ pod_scan_cluster.cu) route (a batch without
                          class tables, KTPU_CLASS_SCAN=0), one launch
                          per batch, in the design pod_scan_design picks:
                          every pod's fits and score over all N rows
                          (csrc/pod.cuh, _pod_feasible / _pod_score), with
                          the same carried terms and overlay as K2
    schedule_batch_sharded
                   -> K15 csrc/shard_scan.cu      the class route on a
                          (+ shard_scan_shared.cu) mesh of D node shards
                          (sharding.py), one launch per batch of one
                          thread-block cluster, in the design
                          shard_scan_design picks; shard s owning rows
                          [s*N/D, (s+1)*N/D); per pod the shards'
                          reductions and the (score, row) election cross
                          the cluster through distributed shared memory;
                          decisions equal to K2's where the capacities
                          coincide
    filter_score   -> K8  csrc/filter_score.cu    [P, N] fits and masked
                          scores against the frozen snapshot
    apply_dirty    -> K3  csrc/apply_dirty.cu     dirty-row scatter

Dispatch is by tensor device: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel (a build or launch failure raises; it
never gives way to the plain version). LAUNCHES counts kernel launches,
one per launch, so a run can show that its main path went through them.
K2, K7 and K15 are each one template instantiated per set of carried
terms (spread groups, topology counters, soft credits) and the nominated
overlay; each instance counts under its own name (scan_instance).

State layout (host mirror: tensorize.TensorMirror):
  node_cfg: alloc [N,R] f32, max_pods [N] f32, node_ok/mem_pressure/
    valid [N] bool.
  usage: used [N,R], nonzero_used [N,2], pod_count [N] f32, plus the
    "spread" [G,N] and "soft_cnt" [Ts,Ds] carry finals when the batch had
    spread groups or soft credit tables.
  nom (core._nominated_device, None when nothing is nominated): the
    phantom reservations of nominated pods, used [N,R] and count [N] f32;
    the pod batch's nom_row [P] names each pod's own nominated row or -1
    (read only with `nom`, on both routes).
schedule_batch returns post-batch usage in new tensors (the inputs are
left as they were), so consecutive batches chain on the device.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, Tuple

import numpy as np
import torch

MAX_PRIORITY = 10.0
NEG = -1e30
#: "was feasible" threshold: real masked scores are small; NEG marks
#: infeasible. Strictly between them.
NEG_THRESHOLD = -1e29
#: SelectorSpread zone blend weight (selector_spreading.go zoneWeighting)
ZONE_WEIGHTING = 2.0 / 3.0
COL_CPU = 0
COL_MEM = 1
#: the widest usage row the nominated overlay folds on the card
#: (csrc/score.cuh KTPU_MAX_R)
MAX_R = 64
#: the most node shards the sharded scan takes: K15's thread-block
#: cluster of up to 8 CTAs, the portable cluster size on Hopper
#: (csrc/shard_scan.cuh KTPU_MAX_SHARDS)
MAX_SHARDS = 8


def scan_instance(has_spread: bool, has_topo: bool, has_soft: bool,
                  has_nom: bool = False, kernel: str = "class_scan") -> str:
    """The name of the instance of `kernel` (K2 "class_scan", K7
    "pod_scan", K15 "shard_scan") that scans a batch with these carried
    terms and, with
    `has_nom`, the nominated overlay (the bare kernel name when it
    carries none)."""
    return kernel + "_spread" * has_spread + "_topo" * has_topo \
        + "_soft" * has_soft + "_nom" * has_nom


#: kernel launches by name; each wrapper adds one per launch
LAUNCHES: Dict[str, int] = {
    "class_ms_init": 0, "apply_dirty": 0, "filter_score": 0,
    "filter_score_spread": 0,
    **{scan_instance(sp, tp, sf, nm, kernel): 0
       for kernel in ("class_scan", "pod_scan", "shard_scan")
       for nm in (False, True)
       for sp in (False, True) for tp in (False, True)
       for sf in (False, True)}}

#: K2's designs: "shared" (csrc/class_scan_shared.cu), the [C, N] table,
#: the class constants and (where they fit) the spread counts in shared
#: memory, and "global" (csrc/class_scan.cu), every table in global memory
#: (any batch); the host picks one by the batch's sizes (class_scan_design)
CLASS_SCAN_DESIGNS = ("shared", "global")
#: the shared design's bounds: dynamic shared memory (bytes), rows (8 a
#: thread of 1,024, or 16 of 512 with spread or soft terms) and classes
#: (the refresh runs in one warp)
SCAN_SMEM_LIMIT = 200 * 1024
SCAN_SMEM_ROWS = 8192
SCAN_SMEM_CLASSES = 32
#: the shared design's zone partials: 32 warps x 32 zones (spread)
SCAN_SMEM_ZONE_WORDS = 32 * 32


def class_scan_smem_words(C: int, N: int, R: int, G: int, Z: int,
                          spread: bool, hold_spread: bool) -> int:
    """The shared design's dynamic shared memory in 4-byte words
    (csrc/class_scan_shared.cu ktpu_scan_smem_words): the [C, N] table,
    the class constants, with spread the zone sums and zinit and the
    warps' zone partials, and the [G, N] spread counts when they are held
    there."""
    w = C * N + C * (R + 4) + (C + 3) // 4
    if spread:
        w += 2 * Z + SCAN_SMEM_ZONE_WORDS
    if spread and hold_spread:
        w += G * N
    return w


def class_scan_design(C: int, N: int, R: int, G: int = 0, Z: int = 0,
                      has_spread: bool = False) -> str:
    """The K2 design for a batch of C classes over N rows of R columns
    (with spread: G groups, Z zones): "shared" where the table and the
    class constants fit in shared memory beside the zone sums, else
    "global"."""
    if not (1 <= C <= SCAN_SMEM_CLASSES and 1 <= N <= SCAN_SMEM_ROWS
            and R <= MAX_R):
        return "global"
    words = class_scan_smem_words(C, N, R, G, Z, has_spread, False)
    return "shared" if words * 4 <= SCAN_SMEM_LIMIT else "global"


_CLASS_KEYS = ("class_req", "class_nz", "class_blocked", "class_mask_idx",
               "class_score_idx")


#: K2 launches by "instance:design" (class_scan_design), beside LAUNCHES
#: (K7's and K15's are added below)
DESIGN_LAUNCHES: Dict[str, int] = {
    f"{scan_instance(sp, tp, sf, nm)}:{d}": 0 for d in CLASS_SCAN_DESIGNS
    for nm in (False, True) for sp in (False, True) for tp in (False, True)
    for sf in (False, True)}


#: K7's designs: "cluster" (csrc/pod_scan_cluster.cu), the rows over one
#: thread-block cluster of POD_CLUSTER CTAs, each holding its rows' state
#: in shared memory, and "block" (csrc/pod_scan.cu), one block of 512
#: threads over the rows in global memory (any batch); the host picks one
#: by the batch's sizes (pod_scan_design)
POD_SCAN_DESIGNS = ("cluster", "block")
#: the cluster design's bounds: CTAs, threads a CTA, rows a thread,
#: dynamic shared memory a CTA (bytes) and zones (spread); the
#: exchanges of K7's and K15's cluster designs (csrc/cluster_xchg.cuh)
#: take 32 zones
POD_CLUSTER = 16
POD_CTHREADS = 512
POD_RPT = 4
POD_SMEM_LIMIT = 200 * 1024
XCHG_ZONES = 32


def pod_cluster_smem_bytes(rows: int, R: int, G: int = 0,
                           nom: bool = False, hold_spread: bool = False
                           ) -> int:
    """A K7 cluster CTA's dynamic shared memory for `rows` rows of R
    columns (csrc/pod_scan_cluster.cu ktpu_pod_cluster_smem_bytes):
    alloc and used [R], nz [2], count and max pods (f32) a row, with the
    overlay its reservations [R] and count, with held spread counts [G],
    and a flag byte a row."""
    words = rows * (2 * R + 4)
    if nom:
        words += rows * (R + 1)
    if hold_spread:
        words += rows * G
    return words * 4 + ((rows + 15) & ~15)


def _cluster_rows_fit(rows: int) -> bool:
    """`rows` rows fit a cluster CTA's threads (up to 512, 4 rows each)."""
    threads = min(POD_CTHREADS, -(-rows // 32) * 32)
    return rows <= threads * POD_RPT


def pod_scan_design(N: int, R: int, G: int = 0, Z: int = 0,
                    terms=(False, False, False, False),
                    nom: bool = False) -> str:
    """The K7 design for a batch over N rows of R columns with the carried
    `terms` (spread, topo, dir2, soft as _scan_terms gives them; with
    spread: G groups, Z zones) and, with `nom`, the nominated overlay:
    "cluster" where each CTA's N / 16 rows fit its threads and their
    state its shared memory (the held spread counts need not fit) and
    the zones the exchange, else "block"."""
    rows = -(-N // POD_CLUSTER)
    spread = bool(terms[0])
    if N < 1 or not 2 <= R <= MAX_R or not _cluster_rows_fit(rows) or \
            (spread and not 1 <= Z <= XCHG_ZONES) or \
            pod_cluster_smem_bytes(rows, R, G, nom) > POD_SMEM_LIMIT:
        return "block"
    return "cluster"


#: K15's designs: "shared" (csrc/shard_scan_shared.cu), one cluster of
#: shard_ctas(D) CTAs a shard, each holding its slice of the [C, N]
#: table, the class constants and its rows' usage in shared memory, and
#: "global" (csrc/shard_scan.cu), one CTA a shard with every table in
#: global memory (any batch); the host picks one (shard_scan_design)
SHARD_SCAN_DESIGNS = ("shared", "global")
#: the shared design's CTAs at most (a non-portable cluster), its dynamic
#: shared memory a CTA (bytes) and the classes the host gives it: its
#: winner's warp refreshes 32 classes a pass, and past one pass the
#: refresh on the chain costs more than the design saves (512 classes:
#: 131.0 ms against the global design's 79.0 on the anti-affinity batch,
#: NVIDIA H100, PERF.md)
SHARD_CLUSTER = 16
SHARD_SMEM_LIMIT = 200 * 1024
SHARD_SMEM_CLASSES = 32


def shard_ctas(D: int) -> int:
    """CTAs a shard of the shared design: the most that 16 hold for D
    shards (16 CTAs in all at D = 2, 4, 8; 15 at D = 3)."""
    return SHARD_CLUSTER // D


def shard_smem_words(C: int, rows: int, R: int, G: int = 0,
                     hold_spread: bool = False) -> int:
    """A shared-design CTA's dynamic shared memory in 4-byte words for
    `rows` rows (csrc/shard_scan_shared.cu ktpu_shard_smem_words): its
    [C, rows] slice of the table, the class constants, its rows' used
    [R], nz [2] and count, and the held spread counts [G]."""
    w = C * rows + C * (R + 4) + (C + 3) // 4 + (R + 3) * rows
    if hold_spread:
        w += G * rows
    return w


def shard_shared_fits(C: int, N: int, R: int, D: int, G: int = 0,
                      Z: int = 0, terms=(False, False, False, False)
                      ) -> bool:
    """Whether K15's shared design takes the batch (its C launcher's
    conditions): a CTA's slice of N / D / shard_ctas(D) rows fits its
    threads and, with the class constants and its rows' usage, 200 KB of
    shared memory, and the zones fit the exchange."""
    spread = bool(terms[0])
    if not 2 <= D <= MAX_SHARDS or N < D or N % D or C < 1 or \
            not 2 <= R <= MAX_R or (spread and not 1 <= Z <= XCHG_ZONES):
        return False
    rows = -(-(N // D) // shard_ctas(D))
    return _cluster_rows_fit(rows) and \
        shard_smem_words(C, rows, R, G) * 4 <= SHARD_SMEM_LIMIT


def shard_scan_design(C: int, N: int, R: int, D: int, G: int = 0,
                      Z: int = 0, terms=(False, False, False, False)
                      ) -> str:
    """The K15 design for a batch of C classes over N rows of R columns on
    D shards (with spread: G groups, Z zones): "shared" where the design
    takes the batch (shard_shared_fits) and its refresh takes the classes
    in one pass (C <= 32), else "global"."""
    if C <= SHARD_SMEM_CLASSES and \
            shard_shared_fits(C, N, R, D, G, Z, terms):
        return "shared"
    return "global"


#: K12's designs: "cluster" (csrc/spec_scan_cluster.cu), one cluster of
#: SHARD_CLUSTER CTAs each holding N / 16 rows' slice of the table, the
#: class constants and its rows' usage in shared memory (K15's shared
#: design with one shard, whose step repairs a dirty cohort), and "block"
#: (csrc/spec_scan.cu), one block over the tables in global memory (any
#: batch); the host picks one (spec_scan_design)
SPEC_SCAN_DESIGNS = ("cluster", "block")
#: the cluster design's dynamic shared memory a CTA (bytes; its cohort's
#: exchange takes static shared memory beside it) and the cohort widths
#: it takes (a lane a member)
SPEC_SMEM_LIMIT = 160 * 1024
SPEC_CLUSTER_WIDTH = 32


def spec_cluster_fits(C: int, N: int, R: int, G: int = 0, Z: int = 0,
                      terms=(False, False, False, False),
                      width: int = 16) -> bool:
    """Whether K12's cluster design takes the batch (its C launcher's
    conditions): a CTA's N / 16 rows fit its threads and, with the class
    constants and their usage, SPEC_SMEM_LIMIT of shared memory, the
    zones fit the exchange and a cohort fits a warp."""
    spread = bool(terms[0])
    if N < 1 or C < 1 or not 2 <= R <= MAX_R or \
            not 1 <= width <= SPEC_CLUSTER_WIDTH or \
            (spread and not 1 <= Z <= XCHG_ZONES):
        return False
    rows = -(-N // SHARD_CLUSTER)
    return _cluster_rows_fit(rows) and \
        shard_smem_words(C, rows, R, G) * 4 <= SPEC_SMEM_LIMIT


def spec_scan_design(C: int, N: int, R: int, G: int = 0, Z: int = 0,
                     terms=(False, False, False, False), nom: bool = False,
                     width: int = 16) -> str:
    """The K12 design for a batch of C classes over N rows of R columns
    with the carried `terms` (spread, topo, dir2, soft as _scan_terms
    gives them; with spread: G groups, Z zones), the nominated overlay
    with `nom`, in cohorts of `width`: "cluster" where the design takes
    the batch (spec_cluster_fits) and its refresh takes the classes in
    one pass (C <= 32, K15's rule), else "block". The overlay changes no
    fit (its reservations stay in global memory). On the card the
    cluster design beat the block design on every batch of the main
    paths it takes, and lost on the 512 classes it is not given
    (PERF.md)."""
    if C <= SHARD_SMEM_CLASSES and \
            spec_cluster_fits(C, N, R, G, Z, terms, width):
        return "cluster"
    return "block"


#: K7, K12 and K15 launches by "instance:design" (pod_scan_design,
#: spec_scan_design, shard_scan_design), beside K2's
DESIGN_LAUNCHES.update({
    f"{scan_instance(sp, tp, sf, nm, kernel)}:{d}": 0
    for kernel, designs in (("pod_scan", POD_SCAN_DESIGNS),
                            ("spec_scan", SPEC_SCAN_DESIGNS),
                            ("shard_scan", SHARD_SCAN_DESIGNS))
    for d in designs for nm in (False, True) for sp in (False, True)
    for tp in (False, True) for sf in (False, True)})


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for k in DESIGN_LAUNCHES:
        DESIGN_LAUNCHES[k] = 0


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}: cpu or cuda")


def _ptr(t: torch.Tensor, dtype: torch.dtype, name: str) -> ctypes.c_void_p:
    """Device pointer of a contiguous CUDA tensor of the given dtype."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    return ctypes.c_void_p(t.data_ptr())


def _check_shapes(node_cfg: dict, usage: dict, cls: dict, unique_masks,
                  unique_scores, rw) -> None:
    """The shapes the kernels index by: a mismatch would read out of
    bounds on the card, so it raises here. (Index VALUES — class ids, mask
    and score rows — come from tensorize, which builds them in range.)"""
    N, R = node_cfg["alloc"].shape
    C = cls["class_req"].shape[0] if "class_req" in cls else 0
    want = {"max_pods": (N,), "node_ok": (N,), "mem_pressure": (N,),
            "valid": (N,), "used": (N, R), "nonzero_used": (N, 2),
            "pod_count": (N,), "class_req": (C, R), "class_nz": (C, 2),
            "class_blocked": (C,), "class_mask_idx": (C,),
            "class_score_idx": (C,), "resource_weights": (2,)}
    have = {**{k: v for k, v in node_cfg.items() if k != "alloc"},
            **usage, **cls, "resource_weights": rw}
    for k, shape in want.items():
        if k in have and tuple(have[k].shape) != shape:
            raise ValueError(f"{k}: shape {tuple(have[k].shape)}, the "
                             f"kernels need {shape}")
    for k, t in (("unique_masks", unique_masks),
                 ("unique_scores", unique_scores)):
        if t.dim() != 2 or t.shape[1] != N:
            raise ValueError(f"{k}: shape {tuple(t.shape)}, the kernels "
                             f"need [rows, {N}]")


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


#: (library, entry) -> its configured ctypes function
_FNS: Dict[Tuple[str, str], Any] = {}


def _fn(lib_name: str, fn_name: str, argtypes):
    """A C entry of a kernel library (built on first use); pointers and
    the stream pass as c_void_p, sizes as c_int. Each entry is configured
    once, on its first call: an entry's argtypes never change."""
    fn = _FNS.get((lib_name, fn_name))
    if fn is None:
        from .build import load
        fn = getattr(load(lib_name), fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[(lib_name, fn_name)] = fn
    return fn


_P, _I = ctypes.c_void_p, ctypes.c_int


# ------------------------------------------------------------ plain math


def class_resource_score(cap_cpu, cap_mem, req_cpu, req_mem, rw):
    """LeastRequested + BalancedAllocation over pre-broadcast class/node
    axes (batch.py _class_resource_score), same f32 op order."""
    safe_cpu = torch.clamp_min(cap_cpu, 1.0)
    safe_mem = torch.clamp_min(cap_mem, 1.0)
    lr_c = torch.where((cap_cpu > 0) & (req_cpu <= cap_cpu),
                       torch.floor((cap_cpu - req_cpu) * MAX_PRIORITY
                                   / safe_cpu), 0.0)
    lr_m = torch.where((cap_mem > 0) & (req_mem <= cap_mem),
                       torch.floor((cap_mem - req_mem) * MAX_PRIORITY
                                   / safe_mem), 0.0)
    lr = torch.floor((lr_c + lr_m) / 2.0)
    cpu_frac = torch.where(cap_cpu > 0, req_cpu / safe_cpu, 1.0)
    mem_frac = torch.where(cap_mem > 0, req_mem / safe_mem, 1.0)
    ba = torch.floor((1.0 - torch.abs(cpu_frac - mem_frac)) * MAX_PRIORITY
                     + 4e-6)
    ba = torch.where((cpu_frac >= 1.0) | (mem_frac >= 1.0), 0.0, ba)
    return rw[0] * lr + rw[1] * ba


def class_col(node_cfg: dict, cls: dict, unique_masks, unique_scores, rw,
              used_b, nz_b, cnt_b, b):
    """Every class's masked score at ONE node row `b` (batch.py
    _class_col) — [C] f32, NEG where infeasible. K2 runs the same
    arithmetic (csrc/score.cuh ktpu_class_score) for the winner's
    column."""
    alloc_b = node_cfg["alloc"][b]                                 # [R]
    fits = torch.all(cls["class_req"] + used_b[None, :]
                     <= alloc_b[None, :], dim=1)                   # [C]
    fits = fits & (cnt_b + 1.0 <= node_cfg["max_pods"][b])
    fits = fits & ~(cls["class_blocked"] & node_cfg["mem_pressure"][b])
    fits = fits & (node_cfg["node_ok"][b] & node_cfg["valid"][b])
    fits = fits & unique_masks[cls["class_mask_idx"].long(), b]
    score = class_resource_score(
        alloc_b[COL_CPU], alloc_b[COL_MEM],
        nz_b[0] + cls["class_nz"][:, 0],
        nz_b[1] + cls["class_nz"][:, 1], rw) \
        + unique_scores[cls["class_score_idx"].long(), b]
    return torch.where(fits, score, NEG)


def nom_feas_usage(usage: dict, nom: dict) -> dict:
    """Usage with the phantom nominated reservations folded into the
    feasibility columns only (batch.py _nom_feas_usage): used + nom used,
    pod_count + nom count; the scores stay on real usage."""
    return {"used": usage["used"] + nom["used"],
            "nonzero_used": usage["nonzero_used"],
            "pod_count": usage["pod_count"] + nom["count"]}


def class_ms_init_plain(node_cfg: dict, usage: dict, cls: dict,
                        unique_masks, unique_scores, rw, nom=None):
    """[C, N] masked-score table at batch start (batch.py
    _class_ms_init), the same arithmetic as class_col over all rows; with
    `nom`, over the usage with the reservations folded in."""
    if nom is not None:
        usage = nom_feas_usage(usage, nom)
    used = usage["used"]
    nz = usage["nonzero_used"]
    cnt = usage["pod_count"]
    alloc = node_cfg["alloc"]
    C = cls["class_req"].shape[0]
    N, R = alloc.shape
    fits = torch.ones((C, N), dtype=torch.bool, device=alloc.device)
    for r in range(R):  # no [C, N, R] intermediate
        fits &= cls["class_req"][:, r][:, None] + used[None, :, r] \
            <= alloc[None, :, r]
    fits &= (cnt + 1.0 <= node_cfg["max_pods"])[None, :]
    fits &= ~(cls["class_blocked"][:, None]
              & node_cfg["mem_pressure"][None, :])
    fits &= (node_cfg["node_ok"] & node_cfg["valid"])[None, :]
    fits &= unique_masks[cls["class_mask_idx"].long()]
    score = class_resource_score(
        alloc[:, COL_CPU][None, :], alloc[:, COL_MEM][None, :],
        nz[:, 0][None, :] + cls["class_nz"][:, 0][:, None],
        nz[:, 1][None, :] + cls["class_nz"][:, 1][:, None], rw) \
        + unique_scores[cls["class_score_idx"].long()]
    return torch.where(fits, score, NEG)


def _least_requested_plain(nz_used, nz_req, cap_cpu, cap_mem):
    """least_requested.go:53 over the node rows (batch.py
    _least_requested); nz_used [N, 2], nz_req [..., 2] (leading axes are
    pods, each [N] row of the result one pod's)."""
    req_cpu = nz_used[:, 0] + nz_req[..., 0:1]
    req_mem = nz_used[:, 1] + nz_req[..., 1:2]
    cpu = torch.where((cap_cpu > 0) & (req_cpu <= cap_cpu),
                      torch.floor((cap_cpu - req_cpu) * MAX_PRIORITY
                                  / torch.clamp_min(cap_cpu, 1.0)), 0.0)
    mem = torch.where((cap_mem > 0) & (req_mem <= cap_mem),
                      torch.floor((cap_mem - req_mem) * MAX_PRIORITY
                                  / torch.clamp_min(cap_mem, 1.0)), 0.0)
    return torch.floor((cpu + mem) / 2.0)


def _balanced_allocation_plain(nz_used, nz_req, cap_cpu, cap_mem):
    """balanced_resource_allocation.go:77 (batch.py _balanced_allocation),
    with the 4e-6 floor nudge; shapes as _least_requested_plain."""
    req_cpu = nz_used[:, 0] + nz_req[..., 0:1]
    req_mem = nz_used[:, 1] + nz_req[..., 1:2]
    cpu_frac = torch.where(cap_cpu > 0,
                           req_cpu / torch.clamp_min(cap_cpu, 1.0), 1.0)
    mem_frac = torch.where(cap_mem > 0,
                           req_mem / torch.clamp_min(cap_mem, 1.0), 1.0)
    score = torch.floor((1.0 - torch.abs(cpu_frac - mem_frac)) * MAX_PRIORITY
                        + 4e-6)
    return torch.where((cpu_frac >= 1.0) | (mem_frac >= 1.0), 0.0, score)


def _pod_feasible_plain(node_cfg: dict, used, pod_count, req, blocked,
                        mask):
    """Pods' [..., N] feasibility against usage `used` [N, R] /
    `pod_count` [N] (batch.py _pod_feasible): req [..., R], blocked [...]
    (the pod's mem_pressure_blocked), mask [..., N]. csrc/pod.cuh
    ktpu_pod_fits is the same test at one (pod, row)."""
    fits_res = torch.all(req.unsqueeze(-2) + used <= node_cfg["alloc"],
                         dim=-1)
    fits_count = pod_count + 1.0 <= node_cfg["max_pods"]
    blocked = blocked.unsqueeze(-1) & node_cfg["mem_pressure"]
    return (fits_res & fits_count & node_cfg["node_ok"] & node_cfg["valid"]
            & mask & ~blocked)


def _pod_score_plain(node_cfg: dict, nz_used, nz_req, static, rw):
    """Pods' [..., N] batch-varying score (batch.py _pod_score): rw[0]
    LeastRequested, then rw[1] BalancedAllocation, then the static row,
    each a rounding of its own. The same f32 arithmetic as
    class_resource_score + the static row (what class_col computes),
    which is why csrc/pod.cuh's ktpu_pod_base calls ktpu_resource_score."""
    cap_cpu = node_cfg["alloc"][:, COL_CPU]
    cap_mem = node_cfg["alloc"][:, COL_MEM]
    score = rw[0] * _least_requested_plain(nz_used, nz_req, cap_cpu,
                                           cap_mem)
    score = score + rw[1] * _balanced_allocation_plain(nz_used, nz_req,
                                                       cap_cpu, cap_mem)
    return score + static


def spread_score(cnt_g, fits, zone_of, zinit):
    """One pod's [N] SelectorSpread score from running group counts
    (batch.py _spread_score): node counts inverted to 0-10 over the
    feasible set, zone counts blended at 2/3; zone 0 means no zone label.
    Leading axes of `cnt_g` / `fits` are pods, each reduced on its own
    (filter_score's [P, N]). The zone sums are integer-valued f32, exact
    in any order."""
    Z = zinit.shape[0]
    cf = torch.where(fits, cnt_g, 0.0)
    maxc = cf.amax(-1, keepdim=True)
    in_range = (zone_of >= 0) & (zone_of < Z)
    zs = zinit.expand(cf.shape[:-1] + (Z,)).clone().scatter_add_(
        -1, torch.where(in_range, zone_of, 0).long().expand(cf.shape),
        torch.where(in_range, cf, 0.0))
    z_idx = torch.arange(Z, device=zs.device)
    maxz = torch.where(z_idx > 0, zs, 0.0).amax(-1, keepdim=True)
    have_zones = torch.where(fits & (zone_of > 0), 1.0, 0.0).amax(
        -1, keepdim=True) > 0
    return spread_blend(cnt_g, zone_of, zs, maxc, maxz, have_zones)


def spread_blend(cnt_g, zone_of, zs, maxc, maxz, have_zones):
    """The SelectorSpread score of each row from the feasible set's
    reductions (batch.py _spread_score after its reduce; the sharded
    scan's _spread_score_sharded after its pmax / psum): the max count
    `maxc`, the zone sums `zs` [..., Z], their named-zone max `maxz` and
    `have_zones`, broadcast against cnt_g's leading axes."""
    Z = zs.shape[-1]
    node_s = torch.where(maxc > 0,
                         MAX_PRIORITY * (maxc - cnt_g)
                         / torch.clamp_min(maxc, 1.0), MAX_PRIORITY)
    zone_at = torch.gather(zs, -1, zone_of.clamp(0, Z - 1).long().expand(
        cnt_g.shape))
    zone_s = torch.where((zone_of > 0) & (maxz > 0),
                         MAX_PRIORITY * (maxz - zone_at)
                         / torch.clamp_min(maxz, 1.0), MAX_PRIORITY)
    blended = torch.where(have_zones,
                          node_s * (1.0 - ZONE_WEIGHTING)
                          + ZONE_WEIGHTING * zone_s, node_s)
    return torch.floor(blended)


def tie_penalized(masked, rows, seq):
    """Sub-integer (row, seq) hash penalty (batch.py _tie_penalized). The
    reference multiplies in wrapping int32; int64 products keep the same
    low 16 bits."""
    h = (rows.long() * -1640531527 + torch.as_tensor(
        seq, device=rows.device).long() * 40503) & 0xFFFF
    return masked - h.to(torch.float32) * (0.5 / 65536.0)


def term_hits(anti_dom, table, tids):
    """[K, N] bool: the node's domain holds an in-batch hit for term
    tids[k] in `table` (batch.py _term_hits; -1 is padding and never
    hits, nor does a node outside the term's domains)."""
    t = tids.clamp_min(0).long()
    drow = anti_dom[t]                                        # [K, N]
    at = torch.gather(table[t], 1, drow.clamp_min(0).long())  # [K, N]
    return (tids[:, None] >= 0) & (drow >= 0) & (at > 0.0)


def topo_bad(anti_dom, carry, anti_tids, aff_tids, cmatch_tids):
    """[N] bool: rows this pod may not take because of earlier winners'
    required (anti-)affinity (batch.py _topo_bad): direction 1 (the pod
    carries an anti term a winner matches), direction 2 (the pod matches
    an anti term a winner carries; `cmatch_tids` is None without the
    carry table), and waived required affinity (once any winner matches
    the term, later carriers must co-locate into its domain)."""
    bad = term_hits(anti_dom, carry["topo_cnt"], anti_tids).any(dim=0)
    if cmatch_tids is not None:
        bad = bad | term_hits(anti_dom, carry["topo_carry"],
                              cmatch_tids).any(dim=0)
    need = (aff_tids >= 0) & \
        (carry["topo_tot"][aff_tids.clamp_min(0).long()] > 0.0)
    return bad | (need[:, None] & ~term_hits(
        anti_dom, carry["topo_cnt"], aff_tids)).any(dim=0)


def _scatter_counts(anti_dom, table, tids, best, ok, tot=None, d=None):
    """Add 1.0 at (tids[k], domain of `best`) for every real entry, 0.0
    at the clamped index otherwise, as .at[].add does. `d` gives the
    domains of `best` when the caller has them (the sharded scan's
    broadcast from the winner's shard)."""
    t = tids.clamp_min(0).long()
    if d is None:
        d = anti_dom[t, best]
    val = ((tids >= 0) & (d >= 0) & ok).to(torch.float32)
    table.index_put_((t, d.clamp_min(0).long()), val, accumulate=True)
    if tot is not None:
        tot.index_put_((t,), val, accumulate=True)


def topo_scatter(anti_dom, carry, match_tids, canti_tids, best, ok):
    """The winner's (term, domain) counter writes, in place (batch.py
    _topo_scatter): match counts and totals, and with the direction-2
    table (`canti_tids` not None) the carry counts."""
    _scatter_counts(anti_dom, carry["topo_cnt"], match_tids, best, ok,
                    tot=carry["topo_tot"])
    if canti_tids is not None:
        _scatter_counts(anti_dom, carry["topo_carry"], canti_tids, best,
                        ok)


def soft_raw(soft_dom, scnt, soft_base, read_tids, read_w, base_idx):
    """One pod's [N] raw inter-pod score (batch.py _soft_raw): its
    template's frozen base row plus the signed running credits of its
    read channels at each node's domain. The reference's where, then
    multiply: a negative weight on a zero count gives -0.0 there too."""
    t = read_tids.clamp_min(0).long()
    drow = soft_dom[t]                                        # [Ks, N]
    at = torch.gather(scnt[t], 1, drow.clamp_min(0).long())   # [Ks, N]
    valid = (read_tids[:, None] >= 0) & (drow >= 0)
    delta = (read_w[:, None] * torch.where(valid, at, 0.0)).sum(dim=0)
    return soft_base[base_idx.clamp_min(0).long()] + delta


def soft_score(raw, fits, weight):
    """Min-max normalisation over the feasible rows, floored with the
    4e-6 epsilon (batch.py _soft_score); exactly 0.0 with no feasible row
    or a flat row."""
    mn = torch.where(fits, raw, float("inf")).min()
    mx = torch.where(fits, raw, float("-inf")).max()
    return soft_norm(raw, mn, mx, weight)


def soft_norm(raw, mn, mx, weight):
    """_soft_score from the feasible set's min `mn` and max `mx` of raw
    (the sharded scan reduces them across shards first)."""
    span_ok = (mx > mn) & torch.isfinite(mn)
    norm = torch.floor(MAX_PRIORITY * (raw - mn)
                       / torch.clamp_min(mx - mn, 1e-30) + 4e-6)
    return torch.where(span_ok, weight * norm, 0.0)


def soft_write(soft_dom, soft_cnt, write_tids, write_w, best, ok, d=None):
    """The winner's credit writes at the chosen node's domains, in place
    (batch.py _soft_write); `d` as in _scatter_counts."""
    t = write_tids.clamp_min(0).long()
    if d is None:
        d = soft_dom[t, best]
    val = torch.where((write_tids >= 0) & (d >= 0) & ok, write_w, 0.0)
    soft_cnt.index_put_((t, d.clamp_min(0).long()), val, accumulate=True)


def pack_results(assign: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
    """[2, P] int32 — assign and the bits of the scores in one buffer, so
    a batch costs one device-to-host copy (batch.py pack_results). On the
    card K2 writes this buffer itself."""
    return torch.stack([assign.to(torch.int32),
                        scores.contiguous().view(torch.int32)])


def unpack_results(packed) -> Tuple[np.ndarray, np.ndarray]:
    arr = packed.cpu().numpy() if isinstance(packed, torch.Tensor) \
        else np.asarray(packed)
    return arr[0], arr[1].view(np.float32)


# ------------------------------------------------------------ K1


def _check_nom(nom: dict, N: int, R: int) -> None:
    """The nominated overlay's shapes, and R within the kernels' folded
    row (csrc/score.cuh KTPU_MAX_R)."""
    _need(nom["used"], (N, R), "nom used")
    _need(nom["count"], (N,), "nom count")
    if R > MAX_R:
        raise ValueError(f"the nominated overlay folds rows of at most "
                         f"{MAX_R} resources, got {R}")


def class_ms_init(node_cfg: dict, usage: dict, cls: dict, unique_masks,
                  unique_scores, rw, nom=None) -> torch.Tensor:
    """[C, N] masked-score table, with the nominated reservations folded
    into feasibility when `nom` is given: plain on the CPU, kernel K1 on
    CUDA."""
    alloc = node_cfg["alloc"]
    if not _on_cuda(alloc):
        return class_ms_init_plain(node_cfg, usage, cls, unique_masks,
                                   unique_scores, rw, nom)
    from .build import check
    _check_shapes(node_cfg, usage, cls, unique_masks, unique_scores, rw)
    N, R = alloc.shape
    if nom is not None:
        _check_nom(nom, N, R)
    C = cls["class_req"].shape[0]
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    ms = torch.empty((C, N), dtype=f32, device=alloc.device)
    args = (_ptr(alloc, f32, "alloc"),
            _ptr(node_cfg["max_pods"], f32, "max_pods"),
            _ptr(node_cfg["node_ok"], b8, "node_ok"),
            _ptr(node_cfg["mem_pressure"], b8, "mem_pressure"),
            _ptr(node_cfg["valid"], b8, "valid"),
            _ptr(usage["used"], f32, "used"),
            _ptr(usage["nonzero_used"], f32, "nonzero_used"),
            _ptr(usage["pod_count"], f32, "pod_count"),
            _ptr(cls["class_req"], f32, "class_req"),
            _ptr(cls["class_nz"], f32, "class_nz"),
            _ptr(cls["class_blocked"], b8, "class_blocked"),
            _ptr(cls["class_mask_idx"], i32, "class_mask_idx"),
            _ptr(cls["class_score_idx"], i32, "class_score_idx"),
            _ptr(unique_masks, b8, "unique_masks"),
            _ptr(unique_scores, f32, "unique_scores"),
            _ptr(rw, f32, "resource_weights"),
            _ptr(nom["used"], f32, "nom used") if nom is not None else None,
            _ptr(nom["count"], f32, "nom count") if nom is not None
            else None,
            _ptr(ms, f32, "ms"), N, R, C, _stream(alloc))
    rc = _fn("class_ms_init", "ktpu_class_ms_init",
             [_P] * 19 + [_I] * 3 + [_P])(*args)
    check(rc, "class_ms_init")
    LAUNCHES["class_ms_init"] += 1
    return ms


# ------------------------------------------------------------ K2


def _scan_terms(pod_batch: dict) -> Tuple[bool, bool, bool, bool]:
    """(has_spread, has_topo, has_dir2, has_soft): the carried terms a
    batch's tables install (batch.py _class_ctx, and the classic branch's
    own checks at :684-696)."""
    has_topo = pod_batch.get("anti_dom") is not None
    return (pod_batch.get("spread_base") is not None, has_topo,
            has_topo and "cmatch_tids" in pod_batch,
            pod_batch.get("soft_dom") is not None)


def _carry_setup(usage: dict, pod_batch: dict):
    """(carry, terms): fresh copies of the state a scan carries, for both
    routes (batch.py _class_ctx and the classic branch's carry0,
    :771-784), and the batch's _scan_terms. A chained launch seeds the
    spread and soft carries from its predecessor's finals
    (core.schedule_launch gates this); the topology counters start from
    the batch's own anti_cnt0. The carry's usage stays real usage: the
    scans add the nominated reservations where they read feasibility."""
    terms = _scan_terms(pod_batch)
    has_spread, has_topo, has_dir2, has_soft = terms
    carry = {"used": usage["used"].clone(),
             "nonzero_used": usage["nonzero_used"].clone(),
             "pod_count": usage["pod_count"].clone()}
    if has_spread:
        sp0 = usage.get("spread")
        carry["spread"] = (sp0 if sp0 is not None
                           else pod_batch["spread_base"]).clone()
    if has_topo:
        cnt0 = pod_batch["anti_cnt0"]
        carry["topo_cnt"] = cnt0.clone()
        carry["topo_tot"] = torch.zeros((cnt0.shape[0],),
                                        dtype=torch.float32,
                                        device=cnt0.device)
        if has_dir2:
            carry["topo_carry"] = torch.zeros_like(cnt0)
    if has_soft:
        sc0 = usage.get("soft_cnt")
        carry["soft_cnt"] = (sc0 if sc0 is not None
                             else pod_batch["soft_cnt0"]).clone()
    return carry, terms


def _scan_setup(node_cfg: dict, usage: dict, pod_batch: dict, nom=None):
    """(cls, rw, ms0, carry, terms) of the class route: the class tables,
    the initial table (K1 on the card; with `nom`, the reservations folded
    into its feasibility) and _carry_setup's carry and terms."""
    cls = {k: pod_batch[k] for k in _CLASS_KEYS}
    rw = pod_batch["resource_weights"]
    ms0 = class_ms_init(node_cfg, usage, cls, pod_batch["unique_masks"],
                        pod_batch["unique_scores"], rw, nom)
    carry, terms = _carry_setup(usage, pod_batch)
    return cls, rw, ms0, carry, terms


def _usage_out(carry: dict) -> dict:
    """The post-batch usage from the scan's carry (batch.py
    _class_usage_out): the spread and soft finals ride along for the
    next chained launch; the topology counters end with the batch."""
    return {k: v for k, v in carry.items()
            if k in ("used", "nonzero_used", "pod_count", "spread",
                     "soft_cnt")}


def _term_steps(pod_batch: dict, carry: dict, terms):
    """(refuse, add, write): one pod's steps of the carried terms, in the
    order both routes take them (batch.py _class_pod_step and the
    classic one_pod): refuse(p, fits) takes out the rows the topology
    counters forbid; add(p, fits, score) adds the soft term, then
    (spread_w * use_spread) * spread, each a rounding of its own;
    write(p, best, ok, ok_f) applies the winner's spread, topology and
    credit writes to the `carry` copies."""
    has_spread, has_topo, has_dir2, has_soft = terms
    pb = pod_batch

    def refuse(p, fits):
        if not has_topo:
            return fits
        return fits & ~topo_bad(
            pb["anti_dom"], carry, pb["anti_tids"][p], pb["aff_tids"][p],
            pb["cmatch_tids"][p] if has_dir2 else None)

    def add(p, fits, score):
        if has_soft:
            base_idx = pb["soft_base_idx"][p]
            raw = soft_raw(pb["soft_dom"], carry["soft_cnt"],
                           pb["soft_base"], pb["soft_read_tids"][p],
                           pb["soft_read_w"][p], base_idx)
            score = score + torch.where(
                base_idx >= 0, soft_score(raw, fits, pb["soft_weight"]),
                0.0)
        if has_spread:
            g = pb["spread_gidx"][p].long()
            use_spread = torch.where(g >= 0, 1.0, 0.0)
            score = score + pb["spread_weight"] * use_spread * spread_score(
                carry["spread"][g.clamp_min(0)], fits, pb["spread_zone"],
                pb["spread_zinit"])
        return score

    def write(p, best, ok, ok_f):
        if has_spread:
            spread = carry["spread"]
            spread[:, best] = spread[:, best] + pb["spread_match"][p] * ok_f
        if has_topo:
            topo_scatter(pb["anti_dom"], carry, pb["match_tids"][p],
                         pb["canti_tids"][p] if has_dir2 else None, best, ok)
        if has_soft:
            soft_write(pb["soft_dom"], carry["soft_cnt"],
                       pb["soft_write_tids"][p], pb["soft_write_w"][p],
                       best, ok)
    return refuse, add, write


def class_step_ctx(node_cfg, pod_batch, cls, rw, carry, terms, nom=None):
    """What class_pod_step_plain reads besides the [C, N] table: the node
    and class tables, the running `carry` (mutated by the steps) and the
    carried terms' steps (_term_steps)."""
    N = carry["used"].shape[0]
    return {"node_cfg": node_cfg, "pod_batch": pod_batch, "cls": cls,
            "rw": rw, "carry": carry, "nom": nom,
            "rows": torch.arange(N, dtype=torch.int32,
                                 device=carry["used"].device),
            "class_idx": pod_batch["class_idx"].long(), "terms": terms,
            "steps": _term_steps(pod_batch, carry, terms)}


def class_pod_step_plain(ctx, ms, p):
    """Pod p's step of the serial scan in plain PyTorch (batch.py
    _class_pod_step), the one copy that the serial scan and the
    speculative scan's repair run; mutates `ms` and ctx's carry. Returns
    (assign: the winner row or -1, the chosen masked score), 0-d. With
    the nominated overlay, the pod's own nominated row (nom_row) is
    recomputed with its own reservation taken out, (used + nom) - req and
    (count + nom count) - 1 in that association, and the winner's column
    is refreshed with the reservations added."""
    node_cfg, pb, cls, rw = (ctx["node_cfg"], ctx["pod_batch"], ctx["cls"],
                             ctx["rw"])
    carry, nom, rows = ctx["carry"], ctx["nom"], ctx["rows"]
    unique_masks = pb["unique_masks"]
    unique_scores = pb["unique_scores"]
    used, nz, cnt = carry["used"], carry["nonzero_used"], carry["pod_count"]
    N = used.shape[0]
    refuse, add, write = ctx["steps"]
    u = ctx["class_idx"][p]
    base = ms[u]
    if nom is not None:
        r = pb["nom_row"][p]
        rc = r.clamp(0, N - 1).long()
        corr = class_col(
            node_cfg, cls, unique_masks, unique_scores, rw,
            used[rc] + nom["used"][rc] - cls["class_req"][u], nz[rc],
            cnt[rc] + nom["count"][rc] - 1.0, rc)[u]
        base = torch.where((r >= 0) & (rows == r), corr, base)
    fits = refuse(p, base > NEG_THRESHOLD)
    score = add(p, fits, base)
    masked = torch.where(fits, score, NEG)
    best = torch.argmax(tie_penalized(masked, rows, pb["seq"][p]))
    chosen = masked[best]
    ok = (chosen > NEG_THRESHOLD) & pb["active"][p]
    ok_f = torch.where(ok, 1.0, 0.0)
    used[best] = used[best] + ok_f * cls["class_req"][u]
    nz[best] = nz[best] + ok_f * cls["class_nz"][u]
    cnt[best] = cnt[best] + ok_f
    if nom is not None:
        ms[:, best] = class_col(
            node_cfg, cls, unique_masks, unique_scores, rw,
            used[best] + nom["used"][best], nz[best],
            cnt[best] + nom["count"][best], best)
    else:
        ms[:, best] = class_col(node_cfg, cls, unique_masks,
                                unique_scores, rw, used[best], nz[best],
                                cnt[best], best)
    write(p, best, ok, ok_f)
    return torch.where(ok, best.to(torch.int32), -1), chosen


def _class_scan_plain(node_cfg, pod_batch, cls, rw, ms, carry, terms,
                      nom=None):
    """The serial scan in plain PyTorch (batch.py _class_pod_step over
    the pods in order: class_pod_step_plain); mutates `ms` and the
    `carry` copies."""
    ctx = class_step_ctx(node_cfg, pod_batch, cls, rw, carry, terms, nom)
    dev = carry["used"].device
    P = pod_batch["class_idx"].shape[0]
    assign = torch.empty((P,), dtype=torch.int32, device=dev)
    scores = torch.empty((P,), dtype=torch.float32, device=dev)
    for p in range(P):
        assign[p], scores[p] = class_pod_step_plain(ctx, ms, p)
    return pack_results(assign, scores)


def _pod_scan_plain(node_cfg, pod_batch, carry, terms, nom=None):
    """The classic per-pod scan in plain PyTorch (batch.py schedule_batch's
    classic branch: one_pod, :702-769, over the pods in order); mutates
    the `carry` copies (_carry_setup, the branch's carry0 :771-784). Each
    pod recomputes fits and score over every row against the running
    usage: no [C, N] table. With `nom`, feasibility reads
    (used + nom used) - req at the pod's own nominated row and - 0.0
    elsewhere, (count + nom count) - 1 / - 0, in that association
    (:705-709); scores read real usage. Without spread tables the
    reference still adds its zero-weight spread term, + 0.0."""
    unique_masks = pod_batch["unique_masks"]
    unique_scores = pod_batch["unique_scores"]
    rw = pod_batch["resource_weights"]
    req, nz_req = pod_batch["req"], pod_batch["nonzero_req"]
    blocked = pod_batch["mem_pressure_blocked"]
    mask_idx = pod_batch["mask_idx"].long()
    score_idx = pod_batch["score_idx"].long()
    seq, active = pod_batch["seq"], pod_batch["active"]
    used, nz, cnt = carry["used"], carry["nonzero_used"], carry["pod_count"]
    dev = used.device
    N = used.shape[0]
    rows = torch.arange(N, dtype=torch.int32, device=dev)
    P = seq.shape[0]
    has_spread = terms[0]
    refuse, add, write = _term_steps(pod_batch, carry, terms)
    assign = torch.empty((P,), dtype=torch.int32, device=dev)
    scores = torch.empty((P,), dtype=torch.float32, device=dev)
    for p in range(P):
        eff_used, eff_cnt = used, cnt
        if nom is not None:
            self_oh = rows == pod_batch["nom_row"][p]
            eff_used = used + nom["used"] - torch.where(
                self_oh[:, None], req[p][None, :], 0.0)
            eff_cnt = cnt + nom["count"] - self_oh.to(torch.float32)
        fits = refuse(p, _pod_feasible_plain(
            node_cfg, eff_used, eff_cnt, req[p], blocked[p],
            unique_masks[mask_idx[p]]))
        score = add(p, fits, _pod_score_plain(
            node_cfg, nz, nz_req[p], unique_scores[score_idx[p]], rw))
        if not has_spread:
            score = score + 0.0
        masked = torch.where(fits, score, NEG)
        best = torch.argmax(tie_penalized(masked, rows, seq[p]))
        ok = fits[best] & active[p]
        ok_f = torch.where(ok, 1.0, 0.0)
        used[best] = used[best] + ok_f * req[p]
        nz[best] = nz[best] + ok_f * nz_req[p]
        cnt[best] = cnt[best] + ok_f
        write(p, best, ok, ok_f)
        assign[p] = torch.where(ok, best.to(torch.int32), -1)
        scores[p] = masked[best]
    return pack_results(assign, scores)


#: the pointer fields of the carried terms and the nominated overlay, in
#: the order both scans' parameter blocks list them (KtpuScanParams in
#: csrc/class_scan.cu, KtpuPodScanParams in csrc/pod_scan.cu); a term's
#: pointers are null when the batch does not carry it
_TERM_PTRS = (
    "spread_gidx", "spread_match", "spread", "zone_of", "zinit",
    "spread_w",
    "anti_dom", "topo_cnt", "topo_tot", "topo_carry", "anti_tids",
    "aff_tids", "match_tids", "cmatch_tids", "canti_tids",
    "soft_dom", "soft_cnt", "soft_base", "soft_base_idx", "read_tids",
    "read_w", "write_tids", "write_w", "soft_w",
    "nom_used", "nom_count", "nom_row")
#: the pointer fields of K2's parameter block, in the order of
#: KtpuScanParams in csrc/class_scan.cu
_SCAN_PTRS = (
    "alloc", "max_pods", "node_ok", "mem_pressure", "valid", "class_req",
    "class_nz", "class_blocked", "class_mask_idx", "class_score_idx",
    "unique_masks", "unique_scores", "rw", "used", "nz_used", "pod_count",
    "ms", "class_idx", "seq", "active") + _TERM_PTRS + ("packed", "prof")
#: the int fields that follow them
_SCAN_INTS = ("N", "R", "C", "P", "G", "Z", "T", "D", "K", "Ts", "Ds", "Ks",
              "Sb", "has_spread", "has_topo", "has_dir2", "has_soft",
              "has_nom", "prof_every")
#: K7's parameter block (KtpuPodScanParams in csrc/pod_scan.cuh): the pod
#: rows in place of the class tables, the same terms, the same ints
#: without C
_POD_SCAN_PTRS = (
    "alloc", "max_pods", "node_ok", "mem_pressure", "valid",
    "unique_masks", "unique_scores", "rw", "used", "nz_used", "pod_count",
    "req", "nz_req", "blocked", "mask_idx", "score_idx", "seq",
    "active") + _TERM_PTRS + ("packed", "prof")
_POD_SCAN_INTS = tuple(k for k in _SCAN_INTS if k != "C")


class _ScanParams(ctypes.Structure):
    _fields_ = [(k, ctypes.c_void_p) for k in _SCAN_PTRS] + \
        [(k, ctypes.c_int) for k in _SCAN_INTS]


class _PodScanParams(ctypes.Structure):
    _fields_ = [(k, ctypes.c_void_p) for k in _POD_SCAN_PTRS] + \
        [(k, ctypes.c_int) for k in _POD_SCAN_INTS]


def _need(t: torch.Tensor, shape: tuple, name: str) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, need "
                         f"{tuple(shape)}")


def _term_params(pod_batch: dict, carry: dict, terms, nom, P: int, N: int,
                 R: int, name: str) -> Tuple[dict, dict]:
    """(dims, ptrs) of the carried terms and the nominated overlay, with
    their shapes checked: the fields that K2's and K7's parameter blocks
    share (ptrs maps a field to its (tensor, dtype))."""
    has_spread, has_topo, has_dir2, has_soft = terms
    f32, i32 = torch.float32, torch.int32
    dims = {"has_spread": int(has_spread), "has_topo": int(has_topo),
            "has_dir2": int(has_dir2), "has_soft": int(has_soft)}
    ptrs = {}
    if has_spread:
        G = carry["spread"].shape[0]
        Z = pod_batch["spread_zinit"].shape[0]
        if Z * 4 > 48 * 1024:
            raise ValueError(f"{name}: {Z} zones exceed the kernel's 48 KB "
                             "of zone sums in shared memory")
        _need(carry["spread"], (G, N), "spread")
        _need(pod_batch["spread_gidx"], (P,), "spread_gidx")
        _need(pod_batch["spread_match"], (P, G), "spread_match")
        _need(pod_batch["spread_zone"], (N,), "spread_zone")
        dims.update(G=G, Z=Z)
        ptrs.update(
            spread_gidx=(pod_batch["spread_gidx"], i32),
            spread_match=(pod_batch["spread_match"], f32),
            spread=(carry["spread"], f32),
            zone_of=(pod_batch["spread_zone"], i32),
            zinit=(pod_batch["spread_zinit"], f32),
            spread_w=(pod_batch["spread_weight"].reshape(1), f32))
    if has_topo:
        T, D = carry["topo_cnt"].shape
        K = pod_batch["anti_tids"].shape[1]
        _need(pod_batch["anti_dom"], (T, N), "anti_dom")
        _need(carry["topo_tot"], (T,), "topo_tot")
        lists = ["anti_tids", "aff_tids", "match_tids"]
        if has_dir2:
            _need(carry["topo_carry"], (T, D), "topo_carry")
            ptrs["topo_carry"] = (carry["topo_carry"], f32)
            lists += ["cmatch_tids", "canti_tids"]
        for k in lists:
            _need(pod_batch[k], (P, K), k)
            ptrs[k] = (pod_batch[k], i32)
        dims.update(T=T, D=D, K=K)
        ptrs.update(anti_dom=(pod_batch["anti_dom"], i32),
                    topo_cnt=(carry["topo_cnt"], f32),
                    topo_tot=(carry["topo_tot"], f32))
    if has_soft:
        Ts, Ds = carry["soft_cnt"].shape
        Sb = pod_batch["soft_base"].shape[0]
        Ks = pod_batch["soft_read_tids"].shape[1]
        _need(pod_batch["soft_dom"], (Ts, N), "soft_dom")
        _need(pod_batch["soft_base"], (Sb, N), "soft_base")
        _need(pod_batch["soft_base_idx"], (P,), "soft_base_idx")
        for k in ("soft_read_tids", "soft_read_w", "soft_write_tids",
                  "soft_write_w"):
            _need(pod_batch[k], (P, Ks), k)
        dims.update(Ts=Ts, Ds=Ds, Ks=Ks, Sb=Sb)
        ptrs.update(
            soft_dom=(pod_batch["soft_dom"], i32),
            soft_cnt=(carry["soft_cnt"], f32),
            soft_base=(pod_batch["soft_base"], f32),
            soft_base_idx=(pod_batch["soft_base_idx"], i32),
            read_tids=(pod_batch["soft_read_tids"], i32),
            read_w=(pod_batch["soft_read_w"], f32),
            write_tids=(pod_batch["soft_write_tids"], i32),
            write_w=(pod_batch["soft_write_w"], f32),
            soft_w=(pod_batch["soft_weight"].reshape(1), f32))
    if nom is not None:
        _need(nom["used"], (N, R), "nom used")
        _need(nom["count"], (N,), "nom count")
        _need(pod_batch["nom_row"], (P,), "nom_row")
        dims.update(has_nom=1)
        ptrs.update(nom_used=(nom["used"], f32),
                    nom_count=(nom["count"], f32),
                    nom_row=(pod_batch["nom_row"], i32))
    return dims, ptrs


def _fill(params_cls, ints, dims: dict, ptrs: dict):
    """A parameter block: null pointers and zero ints where `dims` /
    `ptrs` leave a field unset; every pointer checked CUDA, typed and
    contiguous first."""
    prm = params_cls()
    for k, (t, dtype) in ptrs.items():
        setattr(prm, k, _ptr(t, dtype, k).value)
    for k in ints:
        setattr(prm, k, dims.get(k, 0))
    return prm


def _call(lib: str, entry: str, prm, on: torch.Tensor, name: str) -> None:
    """Call the library's entry with the parameter block `prm` on the
    current stream of `on`'s device; raises, naming the instance `name`,
    when the launch failed."""
    from .build import check
    rc = _fn(lib, entry, [ctypes.POINTER(type(prm)), _P])(
        ctypes.byref(prm), _stream(on))
    check(rc, name)


def _launch(lib: str, entry: str, params_cls, ints, dims: dict,
            ptrs: dict, name: str) -> None:
    """_fill's parameter block passed to the library's entry (_call) on
    alloc's device."""
    _call(lib, entry, _fill(params_cls, ints, dims, ptrs),
          ptrs["alloc"][0], name)


def _node_ptrs(node_cfg: dict, usage: dict, unique_masks, unique_scores,
               rw) -> dict:
    """ptrs of the node tables, the running usage and the deduplicated
    mask and score rows: the fields K2's, K7's and K8's parameter blocks
    share."""
    f32, b8 = torch.float32, torch.bool
    return {"alloc": (node_cfg["alloc"], f32),
            "max_pods": (node_cfg["max_pods"], f32),
            "node_ok": (node_cfg["node_ok"], b8),
            "mem_pressure": (node_cfg["mem_pressure"], b8),
            "valid": (node_cfg["valid"], b8),
            "unique_masks": (unique_masks, b8),
            "unique_scores": (unique_scores, f32), "rw": (rw, f32),
            "used": (usage["used"], f32),
            "nz_used": (usage["nonzero_used"], f32),
            "pod_count": (usage["pod_count"], f32)}


def _class_scan_params(node_cfg, pod_batch, cls, rw, ms, carry, terms,
                       nom=None):
    """(K2's parameter block, the [2, P] packed output it names) for one
    batch, the shapes K2 indexes by checked; K12 (kernels/speculative.py)
    takes the same block. Index values (class ids, term ids, domains,
    nominated rows) come from tensorize and core, which build them inside
    the tables' shapes."""
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    alloc = node_cfg["alloc"]
    N, R = alloc.shape
    C = cls["class_req"].shape[0]
    P = pod_batch["class_idx"].shape[0]
    _check_shapes(node_cfg, carry, cls, pod_batch["unique_masks"],
                  pod_batch["unique_scores"], rw)
    _need(ms, (C, N), "ms")
    for k in ("class_idx", "seq", "active"):
        _need(pod_batch[k], (P,), k)
    if nom is not None:
        _check_nom(nom, N, R)
    packed = torch.empty((2, P), dtype=i32, device=alloc.device)
    dims, ptrs = _term_params(pod_batch, carry, terms, nom, P, N, R,
                              "class_scan")
    dims.update(N=N, R=R, C=C, P=P)
    ptrs.update(_node_ptrs(node_cfg, carry, pod_batch["unique_masks"],
                           pod_batch["unique_scores"], rw))
    ptrs.update({
        **{k: (cls[k], f32 if k in ("class_req", "class_nz") else
               b8 if k == "class_blocked" else i32) for k in _CLASS_KEYS},
        "ms": (ms, f32), "class_idx": (pod_batch["class_idx"], i32),
        "seq": (pod_batch["seq"], i32), "active": (pod_batch["active"], b8),
        "packed": (packed, i32)})
    return _fill(_ScanParams, _SCAN_INTS, dims, ptrs), packed


def _set_prof(prm, prof) -> None:
    """Point a scan's parameter block at a profiling instance's stamp
    buffer: `prof` is (an int64 [n, 8] CUDA tensor, stamp every k-th
    step), csrc/prof.cuh."""
    stamps, every = prof
    prm.prof = _ptr(stamps, torch.int64, "prof").value
    prm.prof_every = int(every)


def scan_design_of(node_cfg: dict, pod_batch: dict, cls: dict,
                   carry: dict, terms) -> str:
    """class_scan_design for a batch of the class route: its classes,
    rows, usage columns and, with spread groups, groups and zones."""
    N, R = node_cfg["alloc"].shape
    spread = terms[0]
    return class_scan_design(
        cls["class_req"].shape[0], N, R,
        carry["spread"].shape[0] if spread else 0,
        pod_batch["spread_zinit"].shape[0] if spread else 0, spread)


def _class_scan_cuda(node_cfg, pod_batch, cls, rw, ms, carry, terms,
                     nom=None, prof=None, design=None):
    """Kernel K2: the whole batch in one launch of the instance for its
    carried terms (and the nominated overlay with `nom`); returns the
    [2, P] packed results and mutates `ms` and the `carry` copies.
    The design is class_scan_design's for the batch's sizes; `design`
    names one of CLASS_SCAN_DESIGNS instead and `prof` launches the
    profiling instance of the uniform or spread batch with its stamp
    buffer (chip_smoke.py's kernel phase, which compares the designs)."""
    prm, packed = _class_scan_params(node_cfg, pod_batch, cls, rw, ms,
                                     carry, terms, nom)
    if prof is not None:
        _set_prof(prm, prof)
    has_spread, has_topo, _, has_soft = terms
    if design is None:
        design = scan_design_of(node_cfg, pod_batch, cls, carry, terms)
    name = scan_instance(has_spread, has_topo, has_soft, nom is not None)
    lib, entry = {"shared": ("class_scan_shared", "ktpu_class_scan_shared"),
                  "global": ("class_scan", "ktpu_class_scan")}[design]
    _call(lib, entry, prm, node_cfg["alloc"], f"{name}:{design}")
    LAUNCHES[name] += 1
    DESIGN_LAUNCHES[f"{name}:{design}"] += 1
    return packed


def _check_pod_rows(node_cfg: dict, usage: dict, pod_batch: dict) -> int:
    """The shapes K7 and K8 index by (node tables, usage, pod rows, the
    deduplicated mask and score rows); returns P."""
    N, R = node_cfg["alloc"].shape
    P = pod_batch["seq"].shape[0]
    _check_shapes(node_cfg, usage, {}, pod_batch["unique_masks"],
                  pod_batch["unique_scores"], pod_batch["resource_weights"])
    for k, shape in (("req", (P, R)), ("nonzero_req", (P, 2)),
                     ("mem_pressure_blocked", (P,)), ("mask_idx", (P,)),
                     ("score_idx", (P,))):
        _need(pod_batch[k], shape, k)
    return P


def _pod_rows(pod_batch: dict) -> dict:
    """ptrs of the per-pod rows (PodBatchTensors.device) that the classic
    scan and filter_score read, under the parameter blocks' names."""
    return {"req": (pod_batch["req"], torch.float32),
            "nz_req": (pod_batch["nonzero_req"], torch.float32),
            "blocked": (pod_batch["mem_pressure_blocked"], torch.bool),
            "mask_idx": (pod_batch["mask_idx"], torch.int32),
            "score_idx": (pod_batch["score_idx"], torch.int32)}


def pod_design_of(node_cfg: dict, pod_batch: dict, carry: dict, terms,
                  nom=None) -> str:
    """pod_scan_design for a batch of the classic route: its rows, usage
    columns, carried terms, overlay and, with spread groups, groups and
    zones."""
    N, R = node_cfg["alloc"].shape
    spread = terms[0]
    return pod_scan_design(
        N, R, carry["spread"].shape[0] if spread else 0,
        pod_batch["spread_zinit"].shape[0] if spread else 0, terms,
        nom is not None)


def _pod_scan_cuda(node_cfg, pod_batch, carry, terms, nom=None, prof=None,
                   design=None):
    """Kernel K7: the classic per-pod scan of the whole batch in one
    launch of the instance for its carried terms (and the nominated
    overlay with `nom`); returns the [2, P] packed results and mutates the
    `carry` copies. Index values (mask and score rows, term ids, domains,
    nominated rows) come from tensorize and core. The design is
    pod_scan_design's for the batch's sizes; `design` names one of
    POD_SCAN_DESIGNS instead and `prof` launches the profiling instance
    of the uniform or spread batch with its stamp buffer (chip_smoke.py's
    kernel phase and tools/scan_probe.py, which compare the designs)."""
    alloc = node_cfg["alloc"]
    N, R = alloc.shape
    P = _check_pod_rows(node_cfg, carry, pod_batch)
    _need(pod_batch["active"], (P,), "active")
    packed = torch.empty((2, P), dtype=torch.int32, device=alloc.device)
    dims, ptrs = _term_params(pod_batch, carry, terms, nom, P, N, R,
                              "pod_scan")
    dims.update(N=N, R=R, P=P)
    ptrs.update(_node_ptrs(node_cfg, carry, pod_batch["unique_masks"],
                           pod_batch["unique_scores"],
                           pod_batch["resource_weights"]))
    ptrs.update(_pod_rows(pod_batch))
    ptrs.update(seq=(pod_batch["seq"], torch.int32),
                active=(pod_batch["active"], torch.bool),
                packed=(packed, torch.int32))
    if prof is not None:
        ptrs["prof"] = (prof[0], torch.int64)
        dims["prof_every"] = int(prof[1])
    has_spread, has_topo, _, has_soft = terms
    if design is None:
        design = pod_design_of(node_cfg, pod_batch, carry, terms, nom)
    name = scan_instance(has_spread, has_topo, has_soft, nom is not None,
                         "pod_scan")
    lib, entry = {"cluster": ("pod_scan_cluster", "ktpu_pod_scan_cluster"),
                  "block": ("pod_scan", "ktpu_pod_scan")}[design]
    _launch(lib, entry, _PodScanParams, _POD_SCAN_INTS, dims, ptrs,
            f"{name}:{design}")
    LAUNCHES[name] += 1
    DESIGN_LAUNCHES[f"{name}:{design}"] += 1
    return packed


def schedule_batch_packed(node_cfg: dict, usage: dict, pod_batch: dict,
                          nom: dict = None) -> Tuple[torch.Tensor, dict]:
    """batch.py schedule_batch: the class route (_schedule_batch_classes;
    K1 + K2 on CUDA) for a batch with class tables, the classic per-pod
    route (K7 on CUDA) for one without; with the nominated-reservation
    overlay when `nom` is given. Returns ([2, P] int32 packed assign +
    score bits, post-batch usage). Plain on the CPU."""
    if nom is not None and "nom_row" not in pod_batch:
        # no pod holds a nomination of its own (batch.py reads -1)
        pod_batch = dict(pod_batch,
                         nom_row=torch.full_like(pod_batch["seq"], -1))
    cuda = _on_cuda(node_cfg["alloc"])
    if "class_req" in pod_batch:
        cls, rw, ms, carry, terms = _scan_setup(node_cfg, usage, pod_batch,
                                                nom)
        scan = _class_scan_cuda if cuda else _class_scan_plain
        packed = scan(node_cfg, pod_batch, cls, rw, ms, carry, terms, nom)
    else:
        carry, terms = _carry_setup(usage, pod_batch)
        scan = _pod_scan_cuda if cuda else _pod_scan_plain
        packed = scan(node_cfg, pod_batch, carry, terms, nom)
    return packed, _usage_out(carry)


def schedule_batch(node_cfg: dict, usage: dict, pod_batch: dict,
                   nom: dict = None):
    """(assign [P] int32 node row or -1, chosen score [P] f32, post-batch
    usage) — the reference's return shape; assign and score are views of
    the packed buffer."""
    packed, new_usage = schedule_batch_packed(node_cfg, usage, pod_batch,
                                              nom)
    return packed[0], packed[1].view(torch.float32), new_usage


# ------------------------------------------------------------ K15


#: the reference's pmin identity for the elected row (batch.py
#: _INT32_MAX)
_INT32_MAX = 2147483647


def shard_elect(lmax, lbest, Nl: int):
    """The cross-shard winner (batch.py _sharded_class_scan :970-985):
    lmax [D] each shard's tie-penalized maximum, lbest [D] its first
    local row at that maximum. pmax of the maxima, then pmin of the
    global rows (r * Nl + lbest[r]) among the shards at that max. The
    comparison is float ==, so a -0.0 and a +0.0 maximum tie and the
    lower row wins, as the pmax + pmin pair gives it. 0-d int64."""
    D = lmax.shape[0]
    rows = torch.arange(D, device=lmax.device) * Nl + lbest
    return torch.where(lmax == lmax.amax(), rows, _INT32_MAX).amin()


def _from_owner(vals, owner, fill):
    """The reference's owner broadcast: pmax over the shards (axis 0 of
    `vals`, [D, ...]) of `vals` on the owning shard and `fill` on every
    other (fill loses to every real value: -1 for a domain id, NEG for a
    masked score)."""
    ranks = torch.arange(vals.shape[0], device=vals.device)
    mine = (ranks == owner).reshape((-1,) + (1,) * (vals.dim() - 1))
    return torch.where(mine, vals, fill).amax(0)


def _owner_doms(dom, tids, owner, lb, D: int, Nl: int):
    """The winner's domain ids for the term rows `tids` [K], broadcast
    from its shard (batch.py _topo_scatter_sharded, the soft `wd`): each
    shard offers dom[t] at local row lb, the owner's is kept."""
    t = tids.clamp_min(0).long()
    local = dom[t].reshape(t.shape[0], D, Nl)[:, :, lb]      # [K, D]
    return _from_owner(local.transpose(0, 1), owner, -1)


def _shard_pod_step_plain(ctx, ms, p, D: int):
    """Pod p's step of the sharded class scan in plain PyTorch (batch.py
    _sharded_class_scan's one_pod), the shards modelled explicitly: the
    [N] rows are D local slices of Nl = N / D ([D, Nl] views). Per shard
    the row-local work (class row, the nominee's own row on its owner,
    topology refusal, soft raw, spread counts) and its partial
    reductions; across shards, folded in rank order, the soft min/max,
    the spread max count, zone sums and zone presence, then the election
    (shard_elect). The owner's masked score and domain ids are broadcast
    (_from_owner), and the owner's rows take the usage, column and spread
    writes; the replicated counters take the identical writes. Mutates
    `ms` and ctx's carry; returns (assign, chosen), 0-d."""
    node_cfg, pb, cls, rw = (ctx["node_cfg"], ctx["pod_batch"], ctx["cls"],
                             ctx["rw"])
    carry, nom, rows = ctx["carry"], ctx["nom"], ctx["rows"]
    unique_masks = pb["unique_masks"]
    unique_scores = pb["unique_scores"]
    used, nz, cnt = carry["used"], carry["nonzero_used"], carry["pod_count"]
    N = used.shape[0]
    Nl = N // D
    has_spread, has_topo, has_dir2, has_soft = ctx["terms"]
    refuse = ctx["steps"][0]
    u = ctx["class_idx"][p]
    base = ms[u]
    if nom is not None:
        # the self-exemption column at the GLOBAL nom_row, on its owner
        r = pb["nom_row"][p]
        rc = r.clamp(0, N - 1).long()
        corr = class_col(
            node_cfg, cls, unique_masks, unique_scores, rw,
            used[rc] + nom["used"][rc] - cls["class_req"][u], nz[rc],
            cnt[rc] + nom["count"][rc] - 1.0, rc)[u]
        base = torch.where((r >= 0) & (rows == r), corr, base)
    fits = refuse(p, base > NEG_THRESHOLD)
    score = base
    if has_soft:
        base_idx = pb["soft_base_idx"][p]
        raw = soft_raw(pb["soft_dom"], carry["soft_cnt"], pb["soft_base"],
                       pb["soft_read_tids"][p], pb["soft_read_w"][p],
                       base_idx)
        lmn = torch.where(fits, raw, float("inf")).reshape(D, Nl).amin(1)
        lmx = torch.where(fits, raw, float("-inf")).reshape(D, Nl).amax(1)
        mn, mx = lmn[0], lmx[0]
        for q in range(1, D):
            mn, mx = torch.minimum(mn, lmn[q]), torch.maximum(mx, lmx[q])
        score = score + torch.where(
            base_idx >= 0, soft_norm(raw, mn, mx, pb["soft_weight"]), 0.0)
    if has_spread:
        g = pb["spread_gidx"][p].long()
        use_spread = torch.where(g >= 0, 1.0, 0.0)
        cnt_g = carry["spread"][g.clamp_min(0)]
        zone_of, zinit = pb["spread_zone"], pb["spread_zinit"]
        Z = zinit.shape[0]
        cf = torch.where(fits, cnt_g, 0.0).reshape(D, Nl)
        in_range = ((zone_of >= 0) & (zone_of < Z)).reshape(D, Nl)
        part = torch.zeros((D, Z), dtype=cf.dtype, device=cf.device)
        part.scatter_add_(1, torch.where(
            in_range, zone_of.reshape(D, Nl), 0).long(),
            torch.where(in_range, cf, 0.0))
        lmaxc = cf.amax(1)
        lhz = torch.where(fits & (zone_of > 0), 1.0, 0.0).reshape(
            D, Nl).amax(1)
        maxc, hz, tot = lmaxc[0], lhz[0], part[0]
        for q in range(1, D):
            maxc = torch.maximum(maxc, lmaxc[q])
            hz = torch.maximum(hz, lhz[q])
            tot = tot + part[q]
        zs = zinit + tot
        z_idx = torch.arange(Z, device=zs.device)
        maxz = torch.where(z_idx > 0, zs, 0.0).amax()
        score = score + pb["spread_weight"] * use_spread * spread_blend(
            cnt_g, zone_of, zs, maxc, maxz, hz > 0)
    masked = torch.where(fits, score, NEG)
    pen = tie_penalized(masked, rows, pb["seq"][p]).reshape(D, Nl)
    lbest = pen.argmax(1)                                  # first max
    lmax = pen.gather(1, lbest[:, None])[:, 0]
    best = shard_elect(lmax, lbest, Nl)
    owner = best // Nl
    lb = best - owner * Nl
    chosen = _from_owner(masked.reshape(D, Nl)[:, lb], owner, NEG)
    ok = (chosen > NEG_THRESHOLD) & pb["active"][p]
    ok_f = torch.where(ok, 1.0, 0.0)
    used[best] = used[best] + ok_f * cls["class_req"][u]
    nz[best] = nz[best] + ok_f * cls["class_nz"][u]
    cnt[best] = cnt[best] + ok_f
    if nom is not None:
        ms[:, best] = class_col(
            node_cfg, cls, unique_masks, unique_scores, rw,
            used[best] + nom["used"][best], nz[best],
            cnt[best] + nom["count"][best], best)
    else:
        ms[:, best] = class_col(node_cfg, cls, unique_masks,
                                unique_scores, rw, used[best], nz[best],
                                cnt[best], best)
    if has_spread:
        spread = carry["spread"]
        spread[:, best] = spread[:, best] + pb["spread_match"][p] * ok_f
    if has_topo:
        dom = pb["anti_dom"]
        mt = pb["match_tids"][p]
        _scatter_counts(dom, carry["topo_cnt"], mt, best, ok,
                        tot=carry["topo_tot"],
                        d=_owner_doms(dom, mt, owner, lb, D, Nl))
        if has_dir2:
            at = pb["canti_tids"][p]
            _scatter_counts(dom, carry["topo_carry"], at, best, ok,
                            d=_owner_doms(dom, at, owner, lb, D, Nl))
    if has_soft:
        wt = pb["soft_write_tids"][p]
        soft_write(pb["soft_dom"], carry["soft_cnt"], wt,
                   pb["soft_write_w"][p], best, ok,
                   d=_owner_doms(pb["soft_dom"], wt, owner, lb, D, Nl))
    return torch.where(ok, best.to(torch.int32), -1), chosen


def _shard_scan_plain(D: int, node_cfg, pod_batch, cls, rw, ms, carry,
                      terms, nom=None):
    """The sharded scan in plain PyTorch (_shard_pod_step_plain over the
    pods in order); mutates `ms` and the `carry` copies."""
    ctx = class_step_ctx(node_cfg, pod_batch, cls, rw, carry, terms, nom)
    dev = carry["used"].device
    P = pod_batch["class_idx"].shape[0]
    assign = torch.empty((P,), dtype=torch.int32, device=dev)
    scores = torch.empty((P,), dtype=torch.float32, device=dev)
    for p in range(P):
        assign[p], scores[p] = _shard_pod_step_plain(ctx, ms, p, D)
    return pack_results(assign, scores)


class _ShardParams(ctypes.Structure):
    """K15's parameter block (KtpuShardParams in csrc/shard_scan.cuh):
    K2's, then the shard count."""
    _fields_ = [("scan", _ScanParams), ("D", ctypes.c_int)]


def shard_design_of(D: int, node_cfg: dict, pod_batch: dict, cls: dict,
                    carry: dict, terms) -> str:
    """shard_scan_design for a batch of the class route on D shards: its
    classes, rows, usage columns, terms and, with spread groups, groups
    and zones."""
    N, R = node_cfg["alloc"].shape
    spread = terms[0]
    return shard_scan_design(
        cls["class_req"].shape[0], N, R, D,
        carry["spread"].shape[0] if spread else 0,
        pod_batch["spread_zinit"].shape[0] if spread else 0, terms)


def spec_design_of(node_cfg: dict, pod_batch: dict, cls: dict,
                   carry: dict, terms, nom=None, width: int = 16) -> str:
    """spec_scan_design for a batch of the class route in cohorts of
    `width`: its classes, rows, usage columns, terms, overlay and, with
    spread groups, groups and zones."""
    N, R = node_cfg["alloc"].shape
    spread = terms[0]
    return spec_scan_design(
        cls["class_req"].shape[0], N, R,
        carry["spread"].shape[0] if spread else 0,
        pod_batch["spread_zinit"].shape[0] if spread else 0, terms,
        nom is not None, width)


def _shard_scan_cuda(D: int, node_cfg, pod_batch, cls, rw, ms, carry,
                     terms, nom=None, prof=None, design=None):
    """Kernel K15: the whole batch in one launch of the instance for its
    carried terms (and the nominated overlay with `nom`), one thread-block
    cluster; returns the [2, P] packed results and mutates `ms` and the
    `carry` copies. A build or launch failure raises. The design is
    shard_scan_design's for the batch's sizes; `design` names one of
    SHARD_SCAN_DESIGNS instead and `prof` launches the profiling
    instance of the uniform or spread batch with its stamp buffer
    (chip_smoke.py's kernel phase and tools/scan_probe.py)."""
    scan, packed = _class_scan_params(node_cfg, pod_batch, cls, rw, ms,
                                      carry, terms, nom)
    if prof is not None:
        _set_prof(scan, prof)
    has_spread, has_topo, _, has_soft = terms
    if design is None:
        design = shard_design_of(D, node_cfg, pod_batch, cls, carry, terms)
    if design == "global" and has_spread and scan.Z * 8 > 48 * 1024:
        raise ValueError(f"shard_scan: {scan.Z} zones exceed the kernel's "
                         "48 KB of partial and reduced zone sums in shared "
                         "memory")
    prm = _ShardParams(scan=scan, D=D)
    name = scan_instance(has_spread, has_topo, has_soft, nom is not None,
                         "shard_scan")
    lib, entry = {"shared": ("shard_scan_shared", "ktpu_shard_scan_shared"),
                  "global": ("shard_scan", "ktpu_shard_scan")}[design]
    _call(lib, entry, prm, node_cfg["alloc"], f"{name}:{design}")
    LAUNCHES[name] += 1
    DESIGN_LAUNCHES[f"{name}:{design}"] += 1
    return packed


def _shard_setup(D: int, node_cfg: dict, pod_batch: dict, nom) -> dict:
    """The pod batch, with nom_row filled in as schedule_batch_packed
    does, after checking the shard count D against the capacity and
    MAX_SHARDS and the batch for class tables."""
    N = node_cfg["alloc"].shape[0]
    if not 2 <= D <= MAX_SHARDS or N % D:
        raise ValueError(f"schedule_batch_sharded: {D} shards over {N} "
                         f"rows; the mesh takes 2 to {MAX_SHARDS} shards "
                         "that divide the capacity")
    if "class_req" not in pod_batch:
        raise ValueError("schedule_batch_sharded: a batch without class "
                         "tables (the sharded scan is the class route)")
    if nom is not None and "nom_row" not in pod_batch:
        pod_batch = dict(pod_batch,
                         nom_row=torch.full_like(pod_batch["seq"], -1))
    return pod_batch


def schedule_batch_sharded_packed(D: int, node_cfg: dict, usage: dict,
                                  pod_batch: dict, nom: dict = None
                                  ) -> Tuple[torch.Tensor, dict]:
    """batch.py schedule_batch_sharded: the class route on a mesh of D
    node shards (D dividing the capacity), with the nominated overlay when `nom` is given. K1 + K15
    on CUDA, plain on the CPU. Returns ([2, P] int32 packed assign +
    score bits, post-batch usage), as schedule_batch_packed."""
    pod_batch = _shard_setup(D, node_cfg, pod_batch, nom)
    cls, rw, ms, carry, terms = _scan_setup(node_cfg, usage, pod_batch, nom)
    scan = _shard_scan_cuda if _on_cuda(node_cfg["alloc"]) \
        else _shard_scan_plain
    packed = scan(D, node_cfg, pod_batch, cls, rw, ms, carry, terms, nom)
    return packed, _usage_out(carry)


def schedule_batch_sharded(D: int, node_cfg: dict, usage: dict,
                           pod_batch: dict, nom: dict = None):
    """(assign [P] int32, chosen score [P] f32, post-batch usage) — the
    reference's return shape; assign and score are views of the packed
    buffer."""
    packed, new_usage = schedule_batch_sharded_packed(D, node_cfg, usage,
                                                      pod_batch, nom)
    return packed[0], packed[1].view(torch.float32), new_usage


def schedule_batch_sharded_plain(D: int, node_cfg: dict, usage: dict,
                                 pod_batch: dict, nom: dict = None):
    """schedule_batch_sharded in plain PyTorch on any device (the table by
    class_ms_init_plain, the scan by _shard_scan_plain): the reference's
    sharded f32 order throughout. Same returns."""
    pod_batch = _shard_setup(D, node_cfg, pod_batch, nom)
    cls = {k: pod_batch[k] for k in _CLASS_KEYS}
    rw = pod_batch["resource_weights"]
    ms = class_ms_init_plain(node_cfg, usage, cls, pod_batch["unique_masks"],
                             pod_batch["unique_scores"], rw, nom)
    carry, terms = _carry_setup(usage, pod_batch)
    packed = _shard_scan_plain(D, node_cfg, pod_batch, cls, rw, ms, carry,
                               terms, nom)
    return packed[0], packed[1].view(torch.float32), _usage_out(carry)


# ------------------------------------------------------------ K8


#: pods per chunk of filter_score_plain: its [pods, N, R] fits
#: intermediate stays within 2^24 elements
_FILTER_CHUNK_ELEMS = 1 << 24


def filter_score_plain(node_cfg: dict, usage: dict, pod_batch: dict):
    """(fits [P, N] bool, where(fits, score, NEG) [P, N] f32) against the
    frozen snapshot (batch.py filter_score): _pod_feasible / _pod_score
    for every pod and row, no in-batch updates, no nominated overlay, no
    topology or soft terms; the spread term from the frozen spread_base
    row (a zero-weight + 0.0 without spread tables). Chunked over pods so
    that the card holds it at 16,384 pods x 8,192 rows."""
    alloc = node_cfg["alloc"]
    N, R = alloc.shape
    P = pod_batch["seq"].shape[0]
    um, us = pod_batch["unique_masks"], pod_batch["unique_scores"]
    rw = pod_batch["resource_weights"]
    has_spread = pod_batch.get("spread_base") is not None
    fits_out = torch.empty((P, N), dtype=torch.bool, device=alloc.device)
    score_out = torch.empty((P, N), dtype=torch.float32,
                            device=alloc.device)
    step = max(1, _FILTER_CHUNK_ELEMS // max(1, N * R))
    for a in range(0, P, step):
        b = min(P, a + step)
        fits = _pod_feasible_plain(
            node_cfg, usage["used"], usage["pod_count"],
            pod_batch["req"][a:b], pod_batch["mem_pressure_blocked"][a:b],
            um[pod_batch["mask_idx"][a:b].long()])
        score = _pod_score_plain(
            node_cfg, usage["nonzero_used"],
            pod_batch["nonzero_req"][a:b],
            us[pod_batch["score_idx"][a:b].long()], rw)
        if has_spread:
            g = pod_batch["spread_gidx"][a:b].long()
            use_spread = torch.where(g >= 0, 1.0, 0.0)[:, None]
            score = score + pod_batch["spread_weight"] * use_spread \
                * spread_score(pod_batch["spread_base"][g.clamp_min(0)],
                               fits, pod_batch["spread_zone"],
                               pod_batch["spread_zinit"])
        else:
            score = score + 0.0
        fits_out[a:b] = fits
        score_out[a:b] = torch.where(fits, score, NEG)
    return fits_out, score_out


#: K8's parameter block (KtpuFilterParams in csrc/filter_score.cu)
_FILTER_PTRS = (
    "alloc", "max_pods", "node_ok", "mem_pressure", "valid",
    "unique_masks", "unique_scores", "rw", "used", "nz_used", "pod_count",
    "req", "nz_req", "blocked", "mask_idx", "score_idx", "spread_gidx",
    "spread_base", "zone_of", "zinit", "spread_w", "fits", "score",
    "scratch")
_FILTER_INTS = ("N", "R", "P", "G", "Z", "has_spread")


class _FilterParams(ctypes.Structure):
    _fields_ = [(k, ctypes.c_void_p) for k in _FILTER_PTRS] + \
        [(k, ctypes.c_int) for k in _FILTER_INTS]


def filter_score(node_cfg: dict, usage: dict, pod_batch: dict
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The [P, N] fits mask and masked score matrix against the frozen
    snapshot (batch.py filter_score): plain on the CPU, kernel K8 on CUDA
    (its instance with spread groups counts as filter_score_spread: two
    passes, which hold each pod's spread partials in an int32 scratch of
    P * (3 + Z): the max counts' bits, have_zones, each pod's group
    representative, the zone sums). No scheduler route calls it;
    gang_feasible reads its mask."""
    alloc = node_cfg["alloc"]
    if not _on_cuda(alloc):
        return filter_score_plain(node_cfg, usage, pod_batch)
    f32, i32 = torch.float32, torch.int32
    N, R = alloc.shape
    P = _check_pod_rows(node_cfg, usage, pod_batch)
    if not 2 <= R <= MAX_R:
        raise ValueError(f"filter_score: {R} resource columns; K8 stages "
                         f"2 to {MAX_R}")
    fits = torch.empty((P, N), dtype=torch.bool, device=alloc.device)
    score = torch.empty((P, N), dtype=f32, device=alloc.device)
    dims = {"N": N, "R": R, "P": P}
    ptrs = {**_node_ptrs(node_cfg, usage, pod_batch["unique_masks"],
                         pod_batch["unique_scores"],
                         pod_batch["resource_weights"]),
            **_pod_rows(pod_batch), "fits": (fits, torch.bool),
            "score": (score, f32)}
    if pod_batch.get("spread_base") is not None:
        G = pod_batch["spread_base"].shape[0]
        Z = pod_batch["spread_zinit"].shape[0]
        if Z < 1:
            raise ValueError("filter_score: spread groups with no zone "
                             "column (zone 0 is the unlabelled zone)")
        _need(pod_batch["spread_base"], (G, N), "spread_base")
        _need(pod_batch["spread_gidx"], (P,), "spread_gidx")
        _need(pod_batch["spread_zone"], (N,), "spread_zone")
        dims.update(G=G, Z=Z, has_spread=1)
        # [P] max count bits, [P] have_zones, [P] representatives,
        # [P, Z] zone sums
        scratch = torch.empty((P * (3 + Z),), dtype=i32,
                              device=alloc.device)
        ptrs.update(spread_gidx=(pod_batch["spread_gidx"], i32),
                    spread_base=(pod_batch["spread_base"], f32),
                    zone_of=(pod_batch["spread_zone"], i32),
                    zinit=(pod_batch["spread_zinit"], f32),
                    spread_w=(pod_batch["spread_weight"].reshape(1), f32),
                    scratch=(scratch, i32))
    name = "filter_score" + "_spread" * bool(dims.get("has_spread"))
    _launch("filter_score", "ktpu_filter_score", _FilterParams,
            _FILTER_INTS, dims, ptrs, name)
    LAUNCHES[name] += 1
    return fits, score


# ------------------------------------------------------------ K3


def apply_dirty_plain(node_cfg: dict, usage: dict, idx: torch.Tensor,
                      cfg_rows: dict, usage_rows: dict) -> Tuple[dict, dict]:
    """Scatter dirty rows in place (batch.py apply_dirty). A slot whose
    row is outside [0, capacity) is a pad and is dropped, never
    clamped."""
    cap = next(iter(node_cfg.values())).shape[0]
    keep = (idx >= 0) & (idx < cap)
    rows = idx[keep].long()
    for tables, src in ((node_cfg, cfg_rows), (usage, usage_rows)):
        for k, t in tables.items():
            t[rows] = src[k][keep]
    return node_cfg, usage


class _DirtyTables(ctypes.Structure):
    """K3's table descriptor (KtpuDirtyHost in csrc/apply_dirty.cu)."""
    _fields_ = [("dst", ctypes.c_void_p * 16), ("src", ctypes.c_void_p * 16),
                ("cols", ctypes.c_int * 16), ("elem", ctypes.c_int * 16),
                ("n", ctypes.c_int)]


#: K3's descriptors, keyed by the layout of the tables and rows they
#: describe (_dirty_key): built once for a set of tables, checks and all
_DIRTY_DESC: Dict[tuple, _DirtyTables] = {}


def _dirty_key(tensors) -> tuple:
    return tuple((t.data_ptr(), t.shape, t.stride(), t.dtype, t.device)
                 for t in tensors)


def _dirty_desc(pairs, D: int) -> _DirtyTables:
    """The descriptor of (table, rows, name) pairs, every table checked
    CUDA, contiguous, of one capacity, and its rows [D, ...] of its
    dtype."""
    if len(pairs) > 16:
        raise ValueError(f"apply_dirty: {len(pairs)} tables, K3 takes 16")
    desc = _DirtyTables()
    cap = pairs[0][0].shape[0]
    for j, (t, rows, name) in enumerate(pairs):
        if t.shape[0] != cap or tuple(rows.shape) != (D,) + tuple(t.shape[1:]):
            raise ValueError(f"apply_dirty: {name} rows {tuple(rows.shape)}"
                             f" do not match table {tuple(t.shape)}")
        if rows.dtype != t.dtype or t.element_size() not in (1, 4):
            raise TypeError(f"apply_dirty: {name} is {t.dtype}/{rows.dtype}")
        desc.dst[j] = _ptr(t, t.dtype, name).value
        desc.src[j] = _ptr(rows, t.dtype, name + " rows").value
        desc.cols[j] = int(np.prod(t.shape[1:], dtype=np.int64))
        desc.elem[j] = t.element_size()
    desc.n = len(pairs)
    return desc


def apply_dirty(node_cfg: dict, usage: dict, idx: torch.Tensor,
                cfg_rows: dict, usage_rows: dict) -> Tuple[dict, dict]:
    """Dirty-row scatter into the device tables, in place (the reference
    donates its input buffers, so in place is the same contract): plain
    on the CPU, kernel K3 on CUDA. The descriptor of a set of tables and
    rows is built (and checked) on its first scatter and reused while
    their pointers and layouts stay."""
    if not _on_cuda(idx):
        return apply_dirty_plain(node_cfg, usage, idx, cfg_rows,
                                 usage_rows)
    from .build import check
    tables = [*node_cfg.values(), *usage.values()]
    rows = [*(cfg_rows[k] for k in node_cfg), *(usage_rows[k] for k in usage)]
    D = idx.shape[0]
    key = (D, *_dirty_key(tables), *_dirty_key(rows))
    desc = _DIRTY_DESC.get(key)
    if desc is None:
        names = [*node_cfg, *usage]
        desc = _dirty_desc(list(zip(tables, rows, names)), D)
        if len(_DIRTY_DESC) >= 64:
            _DIRTY_DESC.clear()
        _DIRTY_DESC[key] = desc
    rc = _fn("apply_dirty", "ktpu_apply_dirty", [_P, _P, _I, _I, _P])(
        ctypes.byref(desc), _ptr(idx, torch.int32, "idx"), D,
        tables[0].shape[0], _stream(idx))
    check(rc, "apply_dirty")
    LAUNCHES["apply_dirty"] += 1
    return node_cfg, usage
