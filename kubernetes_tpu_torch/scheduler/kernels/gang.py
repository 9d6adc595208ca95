"""All-or-nothing gang assignment on the GPU.

Port of kubernetes_tpu/scheduler/kernels/gang.py. A PodGroup's members
either ALL place, each against the running usage and all inside one ICI
topology domain, or NONE do. The batch's placement units (gangs, and
every singleton as a gang of one) are flattened into one member-entry
stream, in the layout core._gang_device_table builds:

    pod_idx       [T] int32  pod-axis index of the entry (-1 = padding)
    start         [T] bool   first entry of its unit (opens a trial)
    end           [T] bool   last entry of its unit (commit or drop)
    gang_id       [T] int32  unit id, for the post-scan all-or-nothing mask
    entry_dom_idx [T] int32  row into dom_tab (-1 = no topology constraint)
    pin_dom       [T] int32  pre-pinned domain id (-1 = free)
    dom_tab    [K, N] int32  node row -> topology-domain id (-1 = no label)
    need          [T] f32    the unit's member count    } optional: the
    greq       [T, R] f32    its elementwise-max request } capacity gate

Every unit is a contiguous run of entries from a start entry to an end
entry; the core builds no other stream.

The device program:

    gang_schedule_batch -> K9  csrc/gang_scan.cu    the member scan, one
                               launch per batch; its step is K7's
                               (csrc/pod.cuh), its trial window an undo
                               log; one template instance per set of
                               terms (the capacity gate, soft credits,
                               the nominated overlay)
    gang_feasible       -> K10 csrc/gang_feasible.cu  per gang: does every
                               member fit somewhere on the [P, N] mask

`gang_schedule_plain` is the plain PyTorch version in the reference's f32
operation order, entry by entry; `gang_feasible_plain` K10's. Dispatch is
by tensor device, as in kernels/batch.py: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel (a build or launch failure
raises). LAUNCHES counts launches, each K9 instance under its own name
(gang_instance).

With the nominated overlay, the reference takes only a member's own
reservation out of the usage it reads (the self-exemption), so a gang's
members read their gang-mates' reservations on top of their trial
placements, and a gang whose plan nominates two members to one node can
never land (ROADMAP Queue C). With `exempt_mates` (the core always sets
it), a member of a unit of more than one entry reads the overlay less the
reservations of its whole unit instead, summed per row in entry order;
that applies to the capacity gate too. A singleton's exemption is its own
either way, and every other unit keeps reading the gang's reservations.

The reference adds a zero-weight write (0.0 * req, a 0.0 credit) for an
entry that does not place; both versions here skip it. Usage and credit
counts start at +0.0 or above and only ever add requests, so x + 0.0 == x
bit for bit on every value they hold. The reference reads a pod's own
nominated row even without the overlay; here, as in kernels/batch.py,
nom_row is read only with `nom` (the core sets it only then).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from .batch import (NEG, _I, _P, _carry_setup, _check_nom, _check_pod_rows,
                    _fn, _launch, _need, _node_ptrs, _on_cuda,
                    _pod_feasible_plain, _pod_rows, _pod_score_plain, _ptr,
                    _stream, _usage_out, pack_results, soft_raw, soft_score,
                    soft_write, tie_penalized)

#: K9's designs (csrc/gang_scan.cu): "cluster", one thread-block cluster
#: of GANG_CLUSTER CTAs (16: Hopper's largest, non-portable cluster),
#: each holding its rows' state in shared memory, and "block", one block
#: of 1,024 threads over the rows in global memory (any batch); the host
#: picks one by the batch's sizes (gang_design)
GANG_SCAN_DESIGNS = ("cluster", "block")
#: the cluster design's bounds: CTAs, threads a CTA, rows a thread,
#: dynamic shared memory a CTA (bytes)
GANG_CLUSTER = 16
GANG_CTHREADS = 512
GANG_RPT = 4
GANG_SMEM_LIMIT = 200 * 1024


def gang_smem_bytes(rows: int, R: int) -> int:
    """A cluster CTA's shared memory for `rows` rows of R columns
    (csrc/gang_scan.cu ktpu_gang_smem_bytes): alloc and used [R], nz [2],
    count, max pods (f32) and a flag byte a row."""
    return rows * (2 * R + 4) * 4 + ((rows + 15) & ~15)


def gang_design(N: int, R: int) -> str:
    """The K9 design for N rows of R columns: "cluster" where each CTA's
    N / GANG_CLUSTER rows fit its threads and its shared memory, else
    "block"."""
    rows = -(-N // GANG_CLUSTER)
    threads = min(GANG_CTHREADS, -(-rows // 32) * 32)
    if N < 1 or rows > threads * GANG_RPT or \
            gang_smem_bytes(rows, R) > GANG_SMEM_LIMIT:
        return "block"
    return "cluster"


#: the [T] entry-stream keys every gang table carries, with dom_tab; the
#: capacity gate's need / greq are optional
ENTRY_KEYS = ("pod_idx", "start", "end", "gang_id", "entry_dom_idx",
              "pin_dom")
CAP_KEYS = ("need", "greq")


def gang_instance(has_cap: bool, has_soft: bool, has_nom: bool) -> str:
    """The name of the K9 instance that scans a batch with the capacity
    gate (`has_cap`: the table carries need / greq), soft credits and the
    nominated overlay."""
    return "gang_scan" + "_cap" * has_cap + "_soft" * has_soft \
        + "_nom" * has_nom


#: kernel launches by name; each wrapper adds one per launch
LAUNCHES: Dict[str, int] = {
    "gang_feasible": 0,
    **{gang_instance(c, s, n): 0 for c in (False, True)
       for s in (False, True) for n in (False, True)}}


#: K9 launches by "instance:design" (gang_design), beside LAUNCHES
DESIGN_LAUNCHES: Dict[str, int] = {
    f"{gang_instance(c, s, n)}:{d}": 0 for d in GANG_SCAN_DESIGNS
    for c in (False, True) for s in (False, True) for n in (False, True)}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for k in DESIGN_LAUNCHES:
        DESIGN_LAUNCHES[k] = 0


# ------------------------------------------------------------ K10


def gang_feasible_plain(fits: torch.Tensor, members: torch.Tensor
                        ) -> torch.Tensor:
    """[G] bool (gang.py gang_feasible): False when some member of the
    gang fits no row of the [P, N] mask; members [G, M] int32 pod rows,
    -1 padded."""
    ok_pod = fits.any(dim=1)
    valid = members >= 0
    ok_m = ok_pod[members.clamp_min(0).long()]
    return (ok_m | ~valid).all(dim=1)


def gang_feasible(fits: torch.Tensor, members: torch.Tensor
                  ) -> torch.Tensor:
    """Per-gang static feasibility over the [P, N] fits mask of
    filter_score: plain on the CPU, kernel K10 on CUDA. No scheduler
    route calls it (the scan subsumes it, as in the reference)."""
    if fits.dim() != 2 or members.dim() != 2:
        raise ValueError(f"gang_feasible: fits {tuple(fits.shape)} and "
                         f"members {tuple(members.shape)} must be 2-d")
    if not _on_cuda(fits):
        return gang_feasible_plain(fits, members)
    from .build import check
    P, N = fits.shape
    G, M = members.shape
    ok_pod = torch.empty((P,), dtype=torch.bool, device=fits.device)
    out = torch.empty((G,), dtype=torch.bool, device=fits.device)
    rc = _fn("gang_feasible", "ktpu_gang_feasible", [_P] * 4 + [_I] * 4
             + [_P])(_ptr(fits, torch.bool, "fits"),
                     _ptr(members, torch.int32, "members"),
                     _ptr(ok_pod, torch.bool, "ok_pod"),
                     _ptr(out, torch.bool, "out"), P, N, G, M, _stream(fits))
    check(rc, "gang_feasible")
    LAUNCHES["gang_feasible"] += 1
    return out


# ------------------------------------------------------------ K9


def _cap_elig(node_cfg: dict, used, cnt, nom, dom_row, need, greq,
              mates=None):
    """The capacity gate at a gang's start entry (gang.py :165-188): per
    row the member slots against COMMITTED usage (plus the nominated
    overlay, less the unit's own reservations `mates` when given), summed
    per domain; a row is eligible when its domain holds `need` members.
    Returns the [N] mask, or None when no row is (the gate then leaves
    the gang to the greedy pin)."""
    N = used.shape[0]
    nom_used = nom["used"] if nom is not None else torch.zeros_like(used)
    nom_cnt = nom["count"] if nom is not None else torch.zeros_like(cnt)
    eff_used, eff_cnt = used + nom_used, cnt + nom_cnt
    if mates is not None:
        eff_used, eff_cnt = eff_used - mates[0], eff_cnt - mates[1]
    free = node_cfg["alloc"] - eff_used
    per = torch.where(greq[None, :] > 0,
                      torch.floor(free / torch.clamp_min(greq, 1e-9)
                                  [None, :]),
                      float("inf"))
    slots = torch.minimum(per.amin(dim=1),
                          torch.floor(node_cfg["max_pods"] - eff_cnt))
    slots = torch.clamp_min(slots, 0.0)
    ok_node = node_cfg["node_ok"] & node_cfg["valid"] & (dom_row >= 0)
    slots = torch.where(ok_node, slots, 0.0)
    # domains outside [0, N) are dropped by the scatter, clamped by the
    # gather, as in the reference
    keep = (dom_row >= 0) & (dom_row < N)
    domcap = torch.zeros((N,), dtype=torch.float32, device=used.device)
    domcap.index_add_(0, dom_row[keep].long(), slots[keep])
    elig = (domcap[dom_row.clamp(0, N - 1).long()] >= need) & (dom_row >= 0)
    return elig if bool(elig.any()) else None


def _mates_reserved(h: dict, t: int, nom_row, req, N: int):
    """([N, R] requests, [N] counts) that the members of the unit opening
    at entry t hold reserved, summed per row in entry order."""
    used = torch.zeros((N, req.shape[1]), dtype=torch.float32,
                       device=req.device)
    cnt = torch.zeros((N,), dtype=torch.float32, device=req.device)
    e = t
    while True:
        i = h["pod_idx"][e]
        if i >= 0 and 0 <= nom_row[i] < N:
            used[nom_row[i]] = used[nom_row[i]] + req[i]
            cnt[nom_row[i]] = cnt[nom_row[i]] + 1.0
        if h["end"][e]:
            return used, cnt
        e += 1


def gang_schedule_plain(node_cfg: dict, pod_batch: dict, gang_tab: dict,
                        carry: dict, nom=None,
                        exempt_mates: bool = False) -> torch.Tensor:
    """The member scan in plain PyTorch (gang.py gang_schedule_batch, its
    one_entry :131-239 over the entries in order, then the all-or-nothing
    mask and the scatter to the pod axis :275-293); mutates the `carry`
    copies, which end as the committed usage. A unit of more than one
    entry places into a trial copy of the committed state, folded in at
    its end entry when every member placed and dropped otherwise; a
    singleton places straight into the committed state. With
    `exempt_mates`, a multi-entry unit reads the overlay less its own
    members' reservations (module docstring). Returns the [2, P] packed
    results."""
    um, us = pod_batch["unique_masks"], pod_batch["unique_scores"]
    rw = pod_batch["resource_weights"]
    req, nz_req = pod_batch["req"], pod_batch["nonzero_req"]
    blocked = pod_batch["mem_pressure_blocked"]
    mask_idx = pod_batch["mask_idx"].long()
    score_idx = pod_batch["score_idx"].long()
    seq, active = pod_batch["seq"], pod_batch["active"]
    has_soft = pod_batch.get("soft_dom") is not None
    dev = carry["used"].device
    N = carry["used"].shape[0]
    P = seq.shape[0]
    rows = torch.arange(N, dtype=torch.int32, device=dev)
    h = {k: gang_tab[k].cpu().tolist() for k in ENTRY_KEYS}
    T = len(h["pod_idx"])
    dom_tab = gang_tab["dom_tab"]
    has_cap = all(k in gang_tab for k in CAP_KEYS)
    need = gang_tab["need"].cpu().tolist() if has_cap else None
    nom_row = pod_batch["nom_row"].cpu().tolist() if nom is not None \
        else None
    committed = carry
    state = committed            # where the current entry places
    gang_dom, gang_ok, gang_elig, mates = -1, True, None, None
    assign_e = [-1] * T
    score_e: Dict[int, torch.Tensor] = {}
    ok_units = [False] * T
    for t in range(T):
        d = h["entry_dom_idx"][t]
        dom_row = dom_tab[max(d, 0)]
        if h["start"][t]:
            # a new unit: a trial copy for more than one entry
            state = committed if h["end"][t] else \
                {k: v.clone() for k, v in committed.items()}
            gang_dom, gang_ok, gang_elig = h["pin_dom"][t], True, None
            mates = _mates_reserved(h, t, nom_row, req, N) \
                if exempt_mates and nom is not None and not h["end"][t] \
                else None
            if has_cap and d >= 0 and h["pin_dom"][t] < 0 and need[t] > 0:
                gang_elig = _cap_elig(node_cfg, committed["used"],
                                      committed["pod_count"], nom, dom_row,
                                      gang_tab["need"][t],
                                      gang_tab["greq"][t], mates)
        i = h["pod_idx"][t]
        if i >= 0:
            mask = um[mask_idx[i]]
            if d >= 0:
                dmask = dom_row >= 0
                if gang_dom >= 0:
                    dmask = dmask & (dom_row == gang_dom)
                if gang_elig is not None:
                    dmask = dmask & gang_elig
                mask = mask & dmask
            eff_used, eff_cnt = state["used"], state["pod_count"]
            if mates is not None:
                eff_used = state["used"] + nom["used"] - mates[0]
                eff_cnt = state["pod_count"] + nom["count"] - mates[1]
            elif nom is not None:
                self_oh = rows == nom_row[i]
                eff_used = state["used"] + nom["used"] - torch.where(
                    self_oh[:, None], req[i][None, :], 0.0)
                eff_cnt = state["pod_count"] + nom["count"] \
                    - self_oh.to(torch.float32)
            fits = _pod_feasible_plain(node_cfg, eff_used, eff_cnt, req[i],
                                       blocked[i], mask)
            score = _pod_score_plain(node_cfg, state["nonzero_used"],
                                     nz_req[i], us[score_idx[i]], rw)
            if has_soft:
                # credits read from the trial: an open gang's earlier
                # members are visible, a dropped gang's never were
                base_idx = pod_batch["soft_base_idx"][i]
                raw = soft_raw(pod_batch["soft_dom"], state["soft_cnt"],
                               pod_batch["soft_base"],
                               pod_batch["soft_read_tids"][i],
                               pod_batch["soft_read_w"][i], base_idx)
                score = score + torch.where(
                    base_idx >= 0,
                    soft_score(raw, fits, pod_batch["soft_weight"]), 0.0)
            masked = torch.where(fits, score, NEG)
            best = int(torch.argmax(tie_penalized(masked, rows, seq[i])))
            ok = bool(fits[best]) and bool(active[i])
            if ok:
                state["used"][best] = state["used"][best] + req[i]
                state["nonzero_used"][best] = \
                    state["nonzero_used"][best] + nz_req[i]
                state["pod_count"][best] = state["pod_count"][best] + 1.0
                if has_soft:
                    soft_write(pod_batch["soft_dom"], state["soft_cnt"],
                               pod_batch["soft_write_tids"][i],
                               pod_batch["soft_write_w"][i], best,
                               torch.tensor(True, device=dev))
                if d >= 0 and gang_dom < 0:
                    gang_dom = int(dom_row[best])
                assign_e[t] = best
            gang_ok = gang_ok and ok
            score_e[t] = masked[best]
        if h["end"][t]:
            if state is not committed and gang_ok:
                for k in committed:
                    committed[k] = state[k]
            state = committed
            g = h["gang_id"][t]
            if 0 <= g < T:
                ok_units[g] = gang_ok
    assign = torch.full((P,), -1, dtype=torch.int32, device=dev)
    scores = torch.full((P,), NEG, dtype=torch.float32, device=dev)
    for t in range(T):
        i = h["pod_idx"][t]
        if 0 <= i < P:
            g = min(h["gang_id"][t], T - 1)
            assign[i] = assign_e[t] if ok_units[g] else -1
            scores[i] = score_e[t]
    return pack_results(assign, scores)


_GANG_PTRS = (
    "alloc", "max_pods", "node_ok", "mem_pressure", "valid",
    "unique_masks", "unique_scores", "rw", "used", "nz_used", "pod_count",
    "req", "nz_req", "blocked", "mask_idx", "score_idx", "seq", "active",
    "soft_dom", "soft_cnt", "soft_base", "soft_base_idx", "read_tids",
    "read_w", "write_tids", "write_w", "soft_w",
    "nom_used", "nom_count", "nom_row",
    "pod_idx", "start", "end", "gang_id", "entry_dom", "pin_dom", "dom_tab",
    "need", "greq",
    "log_row", "log_vals", "log_soft", "log_cell", "entry_assign",
    "entry_score", "ok_units", "domcap", "elig", "gex_used", "gex_cnt",
    "packed", "prof")
_GANG_INTS = ("N", "R", "P", "T", "K", "Ts", "Ds", "Ks", "Sb",
              "has_soft", "has_nom", "has_cap", "mates", "prof_every")


class _GangParams(ctypes.Structure):
    """K9's parameter block: KtpuGangScanParams in csrc/gang_scan.cu
    lists its fields in this order."""
    _fields_ = [(k, ctypes.c_void_p) for k in _GANG_PTRS] + \
        [(k, ctypes.c_int) for k in _GANG_INTS]


def _gang_scan_cuda(node_cfg, pod_batch, gang_tab, carry, nom=None,
                    exempt_mates=False, prof=None, design=None):
    """Kernel K9: the whole entry stream in one launch of the instance
    for the batch's terms, in gang_design's design for its sizes
    (`design` names one of GANG_SCAN_DESIGNS instead; `prof` launches the
    profiling instance of a capacity-gated batch with its stamp buffer:
    chip_smoke.py's kernel phase, which compares the designs); returns
    the [2, P] packed results and mutates the `carry` copies. Index values
    (pod rows, unit ids, domains, mask and score rows, nominated rows)
    come from tensorize and core."""
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    alloc = node_cfg["alloc"]
    dev = alloc.device
    N, R = alloc.shape
    P = _check_pod_rows(node_cfg, carry, pod_batch)
    _need(pod_batch["active"], (P,), "active")
    T = gang_tab["pod_idx"].shape[0]
    K = gang_tab["dom_tab"].shape[0]
    for k in ENTRY_KEYS:
        _need(gang_tab[k], (T,), k)
    _need(gang_tab["dom_tab"], (K, N), "dom_tab")
    has_cap = all(k in gang_tab for k in CAP_KEYS)
    has_soft = pod_batch.get("soft_dom") is not None
    dims = {"N": N, "R": R, "P": P, "T": T, "K": K,
            "has_soft": int(has_soft), "has_nom": int(nom is not None),
            "has_cap": int(has_cap),
            "mates": int(exempt_mates and nom is not None)}
    ptrs = _node_ptrs(node_cfg, carry, pod_batch["unique_masks"],
                      pod_batch["unique_scores"],
                      pod_batch["resource_weights"])
    ptrs.update(_pod_rows(pod_batch))
    packed = torch.empty((2, P), dtype=i32, device=dev)
    Ks = 0
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
        _check_nom(nom, N, R)
        _need(pod_batch["nom_row"], (P,), "nom_row")
        ptrs.update(nom_used=(nom["used"], f32),
                    nom_count=(nom["count"], f32),
                    nom_row=(pod_batch["nom_row"], i32))
    if has_cap:
        _need(gang_tab["need"], (T,), "need")
        _need(gang_tab["greq"], (T, R), "greq")
        ptrs.update(need=(gang_tab["need"], f32),
                    greq=(gang_tab["greq"], f32))
    if design is None:
        design = gang_design(N, R)
    # the trial's undo log (a row, with the cluster design one copy a
    # CTA, and its R + 3 old values, and the Ks old credit cells, per
    # placed member of an open gang), the per-entry results, the per-unit
    # verdicts, the capacity gate's two [N] buffers and the open unit's
    # own reservations (zero outside it)
    log_rows = T * (GANG_CLUSTER if design == "cluster" else 1)
    ptrs.update(
        seq=(pod_batch["seq"], i32), active=(pod_batch["active"], b8),
        pod_idx=(gang_tab["pod_idx"], i32), start=(gang_tab["start"], b8),
        end=(gang_tab["end"], b8), gang_id=(gang_tab["gang_id"], i32),
        entry_dom=(gang_tab["entry_dom_idx"], i32),
        pin_dom=(gang_tab["pin_dom"], i32),
        dom_tab=(gang_tab["dom_tab"], i32),
        log_row=(torch.empty((log_rows,), dtype=i32, device=dev), i32),
        log_vals=(torch.empty((T, R + 3), dtype=f32, device=dev), f32),
        log_soft=(torch.empty((T, max(Ks, 1)), dtype=f32, device=dev), f32),
        log_cell=(torch.empty((T, max(Ks, 1)), dtype=i32, device=dev),
                  i32),
        entry_assign=(torch.empty((T,), dtype=i32, device=dev), i32),
        entry_score=(torch.empty((T,), dtype=f32, device=dev), f32),
        ok_units=(torch.empty((T,), dtype=i32, device=dev), i32),
        domcap=(torch.empty((2 * N,), dtype=f32, device=dev), f32),
        elig=(torch.empty((N,), dtype=b8, device=dev), b8),
        packed=(packed, i32))
    if dims["mates"]:
        ptrs.update(gex_used=(torch.zeros((N, R), dtype=f32, device=dev),
                              f32),
                    gex_cnt=(torch.zeros((N,), dtype=f32, device=dev), f32))
    name = gang_instance(has_cap, has_soft, nom is not None)
    if prof is not None:
        ptrs["prof"] = (prof[0], torch.int64)
        dims["prof_every"] = int(prof[1])
    entry = {"cluster": "ktpu_gang_scan_cluster",
             "block": "ktpu_gang_scan"}[design]
    _launch("gang_scan", entry, _GangParams, _GANG_INTS, dims, ptrs,
            f"{name}:{design}")
    LAUNCHES[name] += 1
    DESIGN_LAUNCHES[f"{name}:{design}"] += 1
    return packed


def gang_schedule_packed(node_cfg: dict, usage: dict, pod_batch: dict,
                         gang_tab: dict, nom: Optional[dict] = None,
                         exempt_mates: bool = False
                         ) -> Tuple[torch.Tensor, dict]:
    """gang.py gang_schedule_batch: ([2, P] int32 packed assign + score
    bits, the committed post-batch usage) — K9 on CUDA, plain on the CPU.
    The batch takes the per-pod rows (no class tables) and may carry soft
    credit tables; `gang_tab` the entry stream, `exempt_mates` the
    overlay's own-gang exemption (module docstring)."""
    if nom is not None and "nom_row" not in pod_batch:
        pod_batch = dict(pod_batch,
                         nom_row=torch.full_like(pod_batch["seq"], -1))
    # a gang batch carries no spread or topology tables (the core
    # assigns none), so the carry is the usage and any soft credits
    carry, _ = _carry_setup(usage, pod_batch)
    if _on_cuda(node_cfg["alloc"]):
        packed = _gang_scan_cuda(node_cfg, pod_batch, gang_tab, carry, nom,
                                 exempt_mates)
    else:
        packed = gang_schedule_plain(node_cfg, pod_batch, gang_tab, carry,
                                     nom, exempt_mates)
    return packed, _usage_out(carry)


def gang_schedule_batch(node_cfg: dict, usage: dict, pod_batch: dict,
                        gang_tab: dict, nom: Optional[dict] = None,
                        exempt_mates: bool = False):
    """(assign [P] int32 node row or -1, chosen score [P] f32, committed
    usage) — the reference's return shape; assign and score are views of
    the packed buffer."""
    packed, new_usage = gang_schedule_packed(node_cfg, usage, pod_batch,
                                             gang_tab, nom, exempt_mates)
    return packed[0], packed[1].view(torch.float32), new_usage
