"""Speculative cohort assignment over the class scan, on the GPU.

Port of kubernetes_tpu/scheduler/kernels/speculative.py. The class scan
(kernels/batch.py, K2) assigns one pod at a time against the running
usage. This route takes the pods in cohorts of K (KTPU_SPEC_COHORT, in
the serial scan's order) and, per cohort:

  1. elects every member's row in one shot against the frozen [C, N]
     masked-score table (tie-penalized first-max, as max + where + min);
  2. checks exactly whether the serial scan would have made the same
     picks: type 1, an earlier member won the same row; type 2, an
     earlier winner's column after its write (batch.class_col, with the
     nominated reservations), tie-penalized with the later member's seq,
     reaches that member's frozen maximum (>=); the fence, a pod that
     reads carried terms (`spec_plain` false, tensorize.set_speculative);
  3. a clean cohort applies the winners' usage rows, table columns and
     spread counts at their distinct rows, and the topology and credit
     writes in pod order; on the first collision the whole cohort replays
     the serial step (batch.class_pod_step_plain on the CPU, class_step.cuh
     on the card) from the pre-cohort carry.

Decisions are therefore K2's, bit for bit, on every batch. Per cohort the
route reports (accepted, first collider; K when clean): the
scheduler_speculative_* counters (core._account_speculative), and the
oracle (`speculative_reference`, `divergence_report`) replays the serial
scan on the same inputs.

    schedule_batch_speculative -> K12  the whole batch in one launch, an
                                       instance per set of carried terms
                                       and the overlay, as K2's
                                       (scan_instance(..., "spec_scan"))

K12 has two designs, picked by batch.spec_scan_design from the batch's
sizes: "cluster" (csrc/spec_scan_cluster.cu, 16 CTAs each holding N / 16
rows' state in shared memory, a dirty cohort repaired through K15's
shared step, csrc/shard_step.cuh) and "block" (csrc/spec_scan.cu, one
block over the tables in global memory, any batch). Both check the fence
first: with f the cohort's first active pod that reads carried terms, the
first collider is at most f, so only the members before f are elected
and checked (none when f = 0). That changes no decision and no stat.

Dispatch is by tensor device, as in kernels/batch.py: a CPU tensor takes
the plain version, a CUDA tensor launches K12 (a build or launch failure
raises). LAUNCHES counts K12's launches per instance (and
batch.DESIGN_LAUNCHES per "instance:design"). The reference's
KTPU_SPEC_GROUP (cohorts unrolled per scan step) changes no decision and
no stat: both versions walk the cohorts one by one.
"""

from __future__ import annotations

import ctypes
import os as _os
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import batch as kb

#: pods per speculative cohort (rounded down to a power of two and
#: clamped to the pod bucket by cohort_width)
_SPEC_COHORT = int(_os.environ.get("KTPU_SPEC_COHORT", "16"))
#: cohorts a scan step unrolls in the reference; read for parity of the
#: knobs, it changes no decision and no stat
_SPEC_GROUP = int(_os.environ.get("KTPU_SPEC_GROUP", "1"))
#: the least share of plain pods (tensorize.set_speculative) among a
#: batch's active pods for the route to engage; below it the batch takes
#: the serial scan (core.schedule_launch). 0 forces speculation on.
_SPEC_MIN_PLAIN = float(_os.environ.get("KTPU_SPEC_MIN_PLAIN", "0.25"))

#: K12 launches by instance; the wrapper adds one per launch
LAUNCHES: Dict[str, int] = {
    kb.scan_instance(sp, tp, sf, nm, "spec_scan"): 0
    for nm in (False, True) for sp in (False, True)
    for tp in (False, True) for sf in (False, True)}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def cohort_width(P: int) -> int:
    """The cohort width for a P-pod batch: the knob rounded down to a
    power of two and clamped to P (P is a power of two >= 8, so the
    cohorts tile the batch)."""
    want = max(1, _SPEC_COHORT)
    return min(1 << (want.bit_length() - 1), P)


def _width(P: int, width: int) -> int:
    K = min(max(1, int(width)), P)
    if P % K:
        raise ValueError(f"speculative scan: cohort width {K} does not "
                         f"divide the batch's {P} pods")
    return K


# ------------------------------------------------------------ plain


def _cohort_checks(ok, best, vbest, cols, u, seq, fence):
    """(type 1, type 2, collide), [K] bool each, of one cohort
    (speculative.py :161-170): type 1, an earlier winner on the member's
    row; type 2, an earlier winner's column value of the member's class
    after its write, tie-penalized with the member's seq, >= the member's
    frozen maximum; collide, either for a bound member, or the fence (an
    active pod that reads carried terms)."""
    K = ok.shape[0]
    afterval = cols[:, u]                                       # [K_j, K_i]
    pen_after = kb.tie_penalized(afterval, best[:, None], seq[None, :])
    idx = torch.arange(K, device=ok.device)
    earlier = idx[:, None] < idx[None, :]
    wj = ok[:, None]
    t1 = (earlier & wj & (best[:, None] == best[None, :])).any(dim=0)
    t2 = (earlier & wj & (pen_after >= vbest[None, :])).any(dim=0)
    return t1, t2, ((t1 | t2) & ok) | fence


def _spec_chunk_plain(ctx, ms, a: int, K: int) -> Tuple[list, int]:
    """One cohort, pods a .. a + K - 1 (speculative.py _spec_chunk):
    elect, check, apply or repair; mutates `ms` and ctx's carry. Returns
    ([(assign, chosen)] per pod, first collider or K)."""
    node_cfg, pb, cls, rw = (ctx["node_cfg"], ctx["pod_batch"], ctx["cls"],
                             ctx["rw"])
    carry, nom, rows = ctx["carry"], ctx["nom"], ctx["rows"]
    used, nz, cnt = carry["used"], carry["nonzero_used"], carry["pod_count"]
    N = used.shape[0]
    dev = used.device
    u = ctx["class_idx"][a:a + K]                               # [K]
    seq = pb["seq"][a:a + K]
    active = pb["active"][a:a + K]
    base = ms[u]                                                # [K, N]
    fits = base > kb.NEG_THRESHOLD
    masked = torch.where(fits, base, kb.NEG)
    pen = kb.tie_penalized(masked, rows[None, :], seq[:, None])
    # first-max argmax as max + where + min (the reference's idiom)
    vbest = pen.amax(dim=1)                                     # [K]
    best = torch.where(pen == vbest[:, None], rows[None, :],
                       torch.tensor(N, dtype=torch.int32, device=dev)
                       ).amin(dim=1)                            # [K]
    bl = best.long()
    chosen = torch.gather(masked, 1, bl[:, None])[:, 0]
    ok = (chosen > kb.NEG_THRESHOLD) & active
    okf = torch.where(ok, 1.0, 0.0)
    # each winner's row after its write, in the serial refresh's op order
    used_b = used[bl] + okf[:, None] * cls["class_req"][u]
    nz_b = nz[bl] + okf[:, None] * cls["class_nz"][u]
    cnt_b = cnt[bl] + okf
    if nom is not None:
        col_used = used_b + nom["used"][bl]
        col_cnt = cnt_b + nom["count"][bl]
    else:
        col_used, col_cnt = used_b, cnt_b
    cols = torch.stack([
        kb.class_col(node_cfg, cls, pb["unique_masks"], pb["unique_scores"],
                     rw, col_used[g], nz_b[g], col_cnt[g], bl[g])
        for g in range(K)])                                     # [K, C]
    collide = _cohort_checks(ok, best, vbest, cols, u, seq,
                             ~pb["spec_plain"][a:a + K] & active)[2]
    idx = torch.arange(K, device=dev)
    first = int(torch.where(collide, idx, K).min())
    if first < K:
        # repair: the whole cohort through the serial step, from the
        # carry as the cohort found it
        return [kb.class_pod_step_plain(ctx, ms, a + g)
                for g in range(K)], first
    w = bl[ok]                                  # distinct rows (type 1)
    used[w] = used_b[ok]
    nz[w] = nz_b[ok]
    cnt[w] = cnt_b[ok]
    ms[:, w] = cols[ok].T
    has_spread, has_topo, has_dir2, has_soft = ctx["terms"]
    if has_spread:
        # integer-valued counts at distinct columns: exact
        sp = carry["spread"]
        sp[:, w] = sp[:, w] + pb["spread_match"][a:a + K][ok].T \
            * okf[ok][None, :]
    # the topology and credit writes unrolled in pod order
    for g in range(K):
        if has_topo:
            kb.topo_scatter(pb["anti_dom"], carry, pb["match_tids"][a + g],
                            pb["canti_tids"][a + g] if has_dir2 else None,
                            bl[g], ok[g])
        if has_soft:
            kb.soft_write(pb["soft_dom"], carry["soft_cnt"],
                          pb["soft_write_tids"][a + g],
                          pb["soft_write_w"][a + g], bl[g], ok[g])
    return [(torch.where(ok[g], best[g], -1), chosen[g])
            for g in range(K)], K


def _spec_scan_plain(node_cfg, pod_batch, cls, rw, ms, carry, terms,
                     nom=None, width: int = 16):
    """The cohort scan in plain PyTorch (speculative.py
    schedule_batch_speculative's lax.scan of _spec_chunk); mutates `ms`
    and the `carry` copies. Returns ([2, P] packed, stats [P/K, 2])."""
    P = pod_batch["class_idx"].shape[0]
    K = _width(P, width)
    ctx = kb.class_step_ctx(node_cfg, pod_batch, cls, rw, carry, terms, nom)
    dev = carry["used"].device
    assign = torch.empty((P,), dtype=torch.int32, device=dev)
    scores = torch.empty((P,), dtype=torch.float32, device=dev)
    stats = torch.empty((P // K, 2), dtype=torch.int32, device=dev)
    for c in range(P // K):
        outs, first = _spec_chunk_plain(ctx, ms, c * K, K)
        for g, (asg, sc) in enumerate(outs):
            assign[c * K + g], scores[c * K + g] = asg, sc
        stats[c, 0] = int(first >= K)
        stats[c, 1] = first
    return kb.pack_results(assign, scores), stats


# ------------------------------------------------------------ K12


class _SpecParams(ctypes.Structure):
    """KtpuSpecParams in csrc/spec_scan.cuh: K2's block, then the cohort
    fields (the scratch is the block design's)."""
    _fields_ = [("scan", kb._ScanParams),
                ("spec_plain", ctypes.c_void_p), ("stats", ctypes.c_void_p),
                ("fscratch", ctypes.c_void_p), ("iscratch", ctypes.c_void_p),
                ("W", ctypes.c_int), ("fscratch_len", ctypes.c_int),
                ("iscratch_len", ctypes.c_int)]


def _spec_scan_cuda(node_cfg, pod_batch, cls, rw, ms, carry, terms,
                    nom=None, width: int = 16, prof=None, design=None):
    """Kernel K12: the whole batch in one launch of the instance for its
    carried terms (and the nominated overlay with `nom`); returns ([2, P]
    packed, stats [P/K, 2]) and mutates `ms` and the `carry` copies. The
    design is spec_scan_design's for the batch's sizes; `design` names one
    of SPEC_SCAN_DESIGNS instead and `prof` launches the profiling
    instance of the uniform or spread batch with its stamp buffer
    (chip_smoke.py's kernel phase and tools/scan_probe.py)."""
    P = pod_batch["class_idx"].shape[0]
    K = _width(P, width)
    scan, packed = kb._class_scan_params(node_cfg, pod_batch, cls, rw, ms,
                                         carry, terms, nom)
    kb._need(pod_batch["spec_plain"], (P,), "spec_plain")
    if prof is not None:
        kb._set_prof(scan, prof)
    if design is None:
        design = kb.spec_design_of(node_cfg, pod_batch, cls, carry, terms,
                                   nom, K)
    N, R = node_cfg["alloc"].shape
    C = cls["class_req"].shape[0]
    dev = node_cfg["alloc"].device
    stats = torch.empty((P // K, 2), dtype=torch.int32, device=dev)
    prm = _SpecParams(
        scan=scan,
        spec_plain=kb._ptr(pod_batch["spec_plain"], torch.bool,
                           "spec_plain").value,
        stats=kb._ptr(stats, torch.int32, "stats").value, W=K)
    if design == "block":
        # per member: frozen max, chosen, the post-write row (and with the
        # overlay), nonzero row, count (and with the overlay), the C
        # columns; winner row and bound flag
        fscratch = torch.empty((K * (2 * R + 5 + C),), dtype=torch.float32,
                               device=dev)
        iscratch = torch.empty((2 * K,), dtype=torch.int32, device=dev)
        prm.fscratch = kb._ptr(fscratch, torch.float32, "fscratch").value
        prm.iscratch = kb._ptr(iscratch, torch.int32, "iscratch").value
        prm.fscratch_len = fscratch.numel()
        prm.iscratch_len = iscratch.numel()
    has_spread, has_topo, _, has_soft = terms
    name = kb.scan_instance(has_spread, has_topo, has_soft, nom is not None,
                            "spec_scan")
    lib, entry = {"cluster": ("spec_scan_cluster", "ktpu_spec_scan_cluster"),
                  "block": ("spec_scan", "ktpu_spec_scan")}[design]
    kb._call(lib, entry, prm, node_cfg["alloc"], f"{name}:{design}")
    LAUNCHES[name] += 1
    kb.DESIGN_LAUNCHES[f"{name}:{design}"] += 1
    return packed, stats


# ------------------------------------------------------------ entries


def _with_nom_row(pod_batch: dict, nom) -> dict:
    if nom is not None and "nom_row" not in pod_batch:
        # no pod holds a nomination of its own (batch.py reads -1)
        return dict(pod_batch, nom_row=torch.full_like(pod_batch["seq"], -1))
    return pod_batch


def schedule_batch_speculative_packed(node_cfg: dict, usage: dict,
                                      pod_batch: dict, nom: dict = None,
                                      width: int = 16):
    """The speculative route of a class-table batch carrying `spec_plain`
    (core.BatchScheduler attaches it under KTPU_SPECULATIVE=1): ([2, P]
    int32 packed assign + score bits, post-batch usage, stats [P/K, 2]
    int32 of (accepted, first collider) per cohort). The usage chains as
    the serial scan's does (batch._usage_out: spread and soft finals ride
    along). K1 + K12 on CUDA, plain on the CPU."""
    pod_batch = _with_nom_row(pod_batch, nom)
    cls, rw, ms, carry, terms = kb._scan_setup(node_cfg, usage, pod_batch,
                                               nom)
    scan = _spec_scan_cuda if kb._on_cuda(node_cfg["alloc"]) \
        else _spec_scan_plain
    packed, stats = scan(node_cfg, pod_batch, cls, rw, ms, carry, terms,
                         nom, width)
    return packed, kb._usage_out(carry), stats


def schedule_batch_speculative(node_cfg: dict, usage: dict, pod_batch: dict,
                               nom: dict = None, width: int = 16):
    """(assign [P] int32, chosen score [P] f32, post-batch usage, stats
    [P/K, 2]) — the reference's return shape; assign and score are views
    of the packed buffer. K1 + K12 on CUDA, plain on the CPU."""
    packed, new_usage, stats = schedule_batch_speculative_packed(
        node_cfg, usage, pod_batch, nom, width)
    return packed[0], packed[1].view(torch.float32), new_usage, stats


def schedule_batch_speculative_plain(node_cfg: dict, usage: dict,
                                     pod_batch: dict, nom: dict = None,
                                     width: int = 16):
    """schedule_batch_speculative in plain PyTorch on any device (the
    table by class_ms_init_plain, the cohorts by _spec_scan_plain): the
    reference's f32 order throughout."""
    pod_batch = _with_nom_row(pod_batch, nom)
    cls = {k: pod_batch[k] for k in kb._CLASS_KEYS}
    rw = pod_batch["resource_weights"]
    ms = kb.class_ms_init_plain(node_cfg, usage, cls,
                                pod_batch["unique_masks"],
                                pod_batch["unique_scores"], rw, nom)
    carry, terms = kb._carry_setup(usage, pod_batch)
    packed, stats = _spec_scan_plain(node_cfg, pod_batch, cls, rw, ms, carry,
                                     terms, nom, width)
    return (packed[0], packed[1].view(torch.float32), kb._usage_out(carry),
            stats)


def speculative_reference(node_cfg: dict, usage: dict, pod_batch: dict,
                          nom: dict = None) -> Tuple[np.ndarray, np.ndarray]:
    """The divergence oracle: the same inputs through the port's serial
    class scan (K1 + K2 on the card), fetched to host numpy as (assign
    [P], scores [P])."""
    packed, _ = kb.schedule_batch_packed(node_cfg, usage, pod_batch, nom)
    return kb.unpack_results(packed)


def divergence_report(spec_assign, ref_assign, width: int) -> List[dict]:
    """One dict per pod whose speculative pick differs from the serial
    pick, with its cohort (pod index // width); empty when bit-identical,
    the expected steady state."""
    sa = np.asarray(spec_assign)
    ra = np.asarray(ref_assign)
    return [{"pod": int(i), "cohort": int(i // max(width, 1)),
             "speculative": int(sa[i]), "serial": int(ra[i])}
            for i in np.nonzero(sa != ra)[0]]
