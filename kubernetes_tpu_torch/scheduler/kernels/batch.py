"""The class-indexed batch scan on the GPU: score table, serial scan,
dirty-row scatter.

Port of kubernetes_tpu/scheduler/kernels/batch.py's class route. Every
function here has a plain PyTorch version in the same f32 operation order
as the JAX reference (so the two agree bit for bit), and the three device
programs on the main path have hand-written CUDA kernels (csrc/):

    class_ms_init  -> K1  csrc/class_ms_init.cu   [C, N] masked scores
    schedule_batch -> K2  csrc/class_scan.cu      one launch per batch;
                          class_col, spread_score and tie_penalized are
                          its __device__ functions, pack_results its
                          epilogue
    apply_dirty    -> K3  csrc/apply_dirty.cu     dirty-row scatter

Dispatch is by tensor device: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel (a build or launch failure raises; it
never gives way to the plain version). LAUNCHES counts kernel launches,
one per launch, so a run can show that its main path went through them.

State layout (host mirror: tensorize.TensorMirror):
  node_cfg: alloc [N,R] f32, max_pods [N] f32, node_ok/mem_pressure/
    valid [N] bool.
  usage: used [N,R], nonzero_used [N,2], pod_count [N] f32, plus the
    "spread" [G,N] carry final when the batch had spread groups.
schedule_batch returns post-batch usage in new tensors (the inputs are
left as they were), so consecutive batches chain on the device.

Routes outside this slice raise NotImplementedError: the classic per-pod
branch, the in-scan (anti-)affinity and soft-credit tables, and the
nominated-reservation overlay (ROADMAP, port slice 3).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

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

#: kernel launches by name; each wrapper adds one per launch
LAUNCHES: Dict[str, int] = {"class_ms_init": 0, "class_scan": 0,
                            "apply_dirty": 0}

_CLASS_KEYS = ("class_req", "class_nz", "class_blocked", "class_mask_idx",
               "class_score_idx")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
    C = cls["class_req"].shape[0]
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


def _fn(lib_name: str, fn_name: str, argtypes):
    """A C entry of a kernel library (built on first use); pointers and
    the stream pass as c_void_p, sizes as c_int."""
    from .build import load
    fn = getattr(load(lib_name), fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
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


def class_ms_init_plain(node_cfg: dict, usage: dict, cls: dict,
                        unique_masks, unique_scores, rw):
    """[C, N] masked-score table at batch start (batch.py
    _class_ms_init), the same arithmetic as class_col over all rows."""
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


def spread_score(cnt_g, fits, zone_of, zinit):
    """One pod's [N] SelectorSpread score from running group counts
    (batch.py _spread_score): node counts inverted to 0-10 over the
    feasible set, zone counts blended at 2/3; zone 0 means no zone label.
    The zone sums are integer-valued f32, exact in any order."""
    Z = zinit.shape[0]
    cf = torch.where(fits, cnt_g, 0.0)
    maxc = cf.max()
    in_range = (zone_of >= 0) & (zone_of < Z)
    zs = zinit.clone().index_add_(
        0, torch.where(in_range, zone_of, 0).long(),
        torch.where(in_range, cf, 0.0))
    z_idx = torch.arange(Z, device=zs.device)
    maxz = torch.where(z_idx > 0, zs, 0.0).max()
    have_zones = torch.where(fits & (zone_of > 0), 1.0, 0.0).max() > 0
    node_s = torch.where(maxc > 0,
                         MAX_PRIORITY * (maxc - cnt_g)
                         / torch.clamp_min(maxc, 1.0), MAX_PRIORITY)
    zone_at = zs[zone_of.clamp(0, Z - 1).long()]
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


def class_ms_init(node_cfg: dict, usage: dict, cls: dict, unique_masks,
                  unique_scores, rw) -> torch.Tensor:
    """[C, N] masked-score table: plain on the CPU, kernel K1 on CUDA."""
    alloc = node_cfg["alloc"]
    if not _on_cuda(alloc):
        return class_ms_init_plain(node_cfg, usage, cls, unique_masks,
                                   unique_scores, rw)
    from .build import check
    _check_shapes(node_cfg, usage, cls, unique_masks, unique_scores, rw)
    N, R = alloc.shape
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
            _ptr(ms, f32, "ms"), N, R, C, _stream(alloc))
    rc = _fn("class_ms_init", "ktpu_class_ms_init",
             [_P] * 17 + [_I] * 3 + [_P])(*args)
    check(rc, "class_ms_init")
    LAUNCHES["class_ms_init"] += 1
    return ms


# ------------------------------------------------------------ K2


def _check_slice(pod_batch: dict, nom) -> None:
    if "class_req" not in pod_batch:
        raise NotImplementedError(
            "schedule_batch: the classic per-pod branch (KTPU_CLASS_SCAN=0 "
            "or a batch without class tables) is not ported yet "
            "(ROADMAP: port slice 3)")
    if "anti_dom" in pod_batch:
        raise NotImplementedError(
            "schedule_batch: in-scan required (anti-)affinity tables "
            "(_topo_bad/_topo_scatter) are not ported yet "
            "(ROADMAP: port slice 3)")
    if "soft_dom" in pod_batch:
        raise NotImplementedError(
            "schedule_batch: in-scan soft inter-pod credits "
            "(_soft_raw/_soft_score/_soft_write) are not ported yet "
            "(ROADMAP: port slice 3)")
    if nom is not None:
        raise NotImplementedError(
            "schedule_batch: the nominated-reservation overlay is not "
            "ported yet (ROADMAP: port slice 3)")


def _scan_setup(node_cfg: dict, usage: dict, pod_batch: dict):
    """(cls, rw, ms0, carry0, has_spread): the class tables, the initial
    table (K1 on the card) and fresh copies of the carried state."""
    cls = {k: pod_batch[k] for k in _CLASS_KEYS}
    rw = pod_batch["resource_weights"]
    ms0 = class_ms_init(node_cfg, usage, cls, pod_batch["unique_masks"],
                        pod_batch["unique_scores"], rw)
    has_spread = pod_batch.get("spread_base") is not None
    carry = {"used": usage["used"].clone(),
             "nonzero_used": usage["nonzero_used"].clone(),
             "pod_count": usage["pod_count"].clone()}
    if has_spread:
        # a chained launch seeds the spread carry from its predecessor's
        # finals (core.schedule_launch gates this)
        sp0 = usage.get("spread")
        carry["spread"] = (sp0 if sp0 is not None
                           else pod_batch["spread_base"]).clone()
    return cls, rw, ms0, carry, has_spread


def _class_scan_plain(node_cfg, pod_batch, cls, rw, ms, carry, has_spread):
    """The serial scan in plain PyTorch (batch.py _class_pod_step over
    the pods in order); mutates `ms` and the `carry` copies."""
    unique_masks = pod_batch["unique_masks"]
    unique_scores = pod_batch["unique_scores"]
    used, nz, cnt = carry["used"], carry["nonzero_used"], carry["pod_count"]
    dev = used.device
    N = used.shape[0]
    rows = torch.arange(N, dtype=torch.int32, device=dev)
    class_idx = pod_batch["class_idx"].long()
    seq = pod_batch["seq"]
    active = pod_batch["active"]
    P = class_idx.shape[0]
    if has_spread:
        spread = carry["spread"]
        gidx = pod_batch["spread_gidx"].long()
        smatch = pod_batch["spread_match"]
        zone_of = pod_batch["spread_zone"]
        zinit = pod_batch["spread_zinit"]
        sw = pod_batch["spread_weight"]
    assign = torch.empty((P,), dtype=torch.int32, device=dev)
    scores = torch.empty((P,), dtype=torch.float32, device=dev)
    for p in range(P):
        u = class_idx[p]
        base = ms[u]
        fits = base > NEG_THRESHOLD
        score = base
        if has_spread:
            g = gidx[p]
            use_spread = torch.where(g >= 0, 1.0, 0.0)
            score = score + sw * use_spread * spread_score(
                spread[g.clamp_min(0)], fits, zone_of, zinit)
        masked = torch.where(fits, score, NEG)
        best = torch.argmax(tie_penalized(masked, rows, seq[p]))
        chosen = masked[best]
        ok = (chosen > NEG_THRESHOLD) & active[p]
        ok_f = torch.where(ok, 1.0, 0.0)
        used[best] = used[best] + ok_f * cls["class_req"][u]
        nz[best] = nz[best] + ok_f * cls["class_nz"][u]
        cnt[best] = cnt[best] + ok_f
        ms[:, best] = class_col(node_cfg, cls, unique_masks, unique_scores,
                                rw, used[best], nz[best], cnt[best], best)
        if has_spread:
            spread[:, best] = spread[:, best] + smatch[p] * ok_f
        assign[p] = torch.where(ok, best.to(torch.int32), -1)
        scores[p] = chosen
    return pack_results(assign, scores)


def _class_scan_cuda(node_cfg, pod_batch, cls, rw, ms, carry, has_spread):
    """Kernel K2: the whole batch in one launch; returns the [2, P]
    packed results and mutates `ms` and the `carry` copies."""
    from .build import check
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    alloc = node_cfg["alloc"]
    N, R = alloc.shape
    C = cls["class_req"].shape[0]
    P = pod_batch["class_idx"].shape[0]
    dev = alloc.device
    _check_shapes(node_cfg, carry, cls, pod_batch["unique_masks"],
                  pod_batch["unique_scores"], rw)
    if tuple(ms.shape) != (C, N):
        raise ValueError(f"ms: shape {tuple(ms.shape)}, need {(C, N)}")
    for k in ("class_idx", "seq", "active"):
        if tuple(pod_batch[k].shape) != (P,):
            raise ValueError(f"{k}: shape {tuple(pod_batch[k].shape)}, "
                             f"need ({P},)")
    packed = torch.empty((2, P), dtype=i32, device=dev)
    null = ctypes.c_void_p(0)
    if has_spread:
        G = carry["spread"].shape[0]
        Z = pod_batch["spread_zinit"].shape[0]
        want = {"spread": (G, N), "spread_gidx": (P,),
                "spread_match": (P, G), "spread_zone": (N,)}
        for k, shape in want.items():
            t = carry[k] if k == "spread" else pod_batch[k]
            if tuple(t.shape) != shape:
                raise ValueError(f"{k}: shape {tuple(t.shape)}, need "
                                 f"{shape}")
        if Z * 4 > 48 * 1024:
            raise ValueError(f"class_scan: {Z} zones exceed the kernel's "
                             "48 KB of zone sums in shared memory")
        sp = (_ptr(pod_batch["spread_gidx"], i32, "spread_gidx"),
              _ptr(pod_batch["spread_match"], f32, "spread_match"),
              _ptr(carry["spread"], f32, "spread"),
              _ptr(pod_batch["spread_zone"], i32, "spread_zone"),
              _ptr(pod_batch["spread_zinit"], f32, "spread_zinit"),
              _ptr(pod_batch["spread_weight"].reshape(1), f32,
                   "spread_weight"))
    else:
        G = Z = 0
        sp = (null,) * 6
    args = (_ptr(alloc, f32, "alloc"),
            _ptr(node_cfg["max_pods"], f32, "max_pods"),
            _ptr(node_cfg["node_ok"], b8, "node_ok"),
            _ptr(node_cfg["mem_pressure"], b8, "mem_pressure"),
            _ptr(node_cfg["valid"], b8, "valid"),
            _ptr(cls["class_req"], f32, "class_req"),
            _ptr(cls["class_nz"], f32, "class_nz"),
            _ptr(cls["class_blocked"], b8, "class_blocked"),
            _ptr(cls["class_mask_idx"], i32, "class_mask_idx"),
            _ptr(cls["class_score_idx"], i32, "class_score_idx"),
            _ptr(pod_batch["unique_masks"], b8, "unique_masks"),
            _ptr(pod_batch["unique_scores"], f32, "unique_scores"),
            _ptr(rw, f32, "resource_weights"),
            _ptr(carry["used"], f32, "used"),
            _ptr(carry["nonzero_used"], f32, "nonzero_used"),
            _ptr(carry["pod_count"], f32, "pod_count"),
            _ptr(ms, f32, "ms"),
            _ptr(pod_batch["class_idx"], i32, "class_idx"),
            _ptr(pod_batch["seq"], i32, "seq"),
            _ptr(pod_batch["active"], b8, "active"),
            *sp,
            int(has_spread), N, R, C, P, G, Z,
            _ptr(packed, i32, "packed"), _stream(alloc))
    # 26 pointers; has_spread, N, R, C, P, G, Z; packed; stream
    rc = _fn("class_scan", "ktpu_class_scan",
             [_P] * 26 + [_I] * 7 + [_P] * 2)(*args)
    check(rc, "class_scan")
    LAUNCHES["class_scan"] += 1
    return packed


def schedule_batch_packed(node_cfg: dict, usage: dict, pod_batch: dict,
                          nom: dict = None) -> Tuple[torch.Tensor, dict]:
    """The class-route scan (batch.py schedule_batch ->
    _schedule_batch_classes). Returns ([2, P] int32 packed assign +
    score bits, post-batch usage). Plain on the CPU; K1 + K2 on CUDA."""
    _check_slice(pod_batch, nom)
    cls, rw, ms, carry, has_spread = _scan_setup(node_cfg, usage,
                                                 pod_batch)
    scan = _class_scan_cuda if _on_cuda(node_cfg["alloc"]) \
        else _class_scan_plain
    packed = scan(node_cfg, pod_batch, cls, rw, ms, carry, has_spread)
    return packed, carry


def schedule_batch(node_cfg: dict, usage: dict, pod_batch: dict,
                   nom: dict = None):
    """(assign [P] int32 node row or -1, chosen score [P] f32, post-batch
    usage) — the reference's return shape; assign and score are views of
    the packed buffer."""
    packed, new_usage = schedule_batch_packed(node_cfg, usage, pod_batch,
                                              nom)
    return packed[0], packed[1].view(torch.float32), new_usage


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


def apply_dirty(node_cfg: dict, usage: dict, idx: torch.Tensor,
                cfg_rows: dict, usage_rows: dict) -> Tuple[dict, dict]:
    """Dirty-row scatter into the device tables, in place (the reference
    donates its input buffers, so in place is the same contract): plain
    on the CPU, kernel K3 on CUDA."""
    if not _on_cuda(idx):
        return apply_dirty_plain(node_cfg, usage, idx, cfg_rows,
                                 usage_rows)
    from .build import check
    pairs = [(node_cfg[k], cfg_rows[k], k) for k in node_cfg] + \
            [(usage[k], usage_rows[k], k) for k in usage]
    n = len(pairs)
    dst = (ctypes.c_void_p * n)()
    src = (ctypes.c_void_p * n)()
    cols = (ctypes.c_int * n)()
    elem = (ctypes.c_int * n)()
    cap = pairs[0][0].shape[0]
    D = idx.shape[0]
    for j, (t, rows, name) in enumerate(pairs):
        if t.shape[0] != cap or tuple(rows.shape) != (D,) + tuple(t.shape[1:]):
            raise ValueError(f"apply_dirty: {name} rows {tuple(rows.shape)}"
                             f" do not match table {tuple(t.shape)}")
        if rows.dtype != t.dtype or t.element_size() not in (1, 4):
            raise TypeError(f"apply_dirty: {name} is {t.dtype}/{rows.dtype}")
        dst[j] = _ptr(t, t.dtype, name).value
        src[j] = _ptr(rows, t.dtype, name + " rows").value
        cols[j] = int(np.prod(t.shape[1:], dtype=np.int64))
        elem[j] = t.element_size()
    args = (_ptr(idx, torch.int32, "idx"), D, cap, n,
            ctypes.cast(dst, ctypes.c_void_p),
            ctypes.cast(src, ctypes.c_void_p),
            ctypes.cast(cols, ctypes.c_void_p),
            ctypes.cast(elem, ctypes.c_void_p), _stream(idx))
    rc = _fn("apply_dirty", "ktpu_apply_dirty",
             [_P] + [_I] * 3 + [_P] * 5)(*args)
    check(rc, "apply_dirty")
    LAUNCHES["apply_dirty"] += 1
    return node_cfg, usage
