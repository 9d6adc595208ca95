#!/usr/bin/env python3
"""Smoke test of kubernetes_tpu_torch on one NVIDIA GPU (H100, sm_90a).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from kubernetes_tpu_torch/csrc (nvcc,
one process per source, all started together), then:

  1. main paths, each with the kernel launch counts zeroed just before
     and read just after it; every kernel of the path must have launched:
     - `uniform` and `spread`: 50,000 pods onto 5,000 nodes through the
       port's BatchScheduler, in batches of 16,384 — `uniform` through
       the chained schedule_launch -> schedule_finish drain
       (scheduler/drain.py), `spread` (SelectorSpread groups over zone
       and hostname) one batch after another (K1, K2; K3 on spread);
     - `scheduler`: the scheduler loop as production runs it —
       Scheduler(client, batch_size=16384, device="cuda").drain_pipelined
       with the commit thread on, over a cluster built through the port's
       Client as bench.py's run_config builds it: 50,000 pods of nine
       tenants (priority 1000 for every fourth pod) onto 5,000 nodes.
       Every popped batch is ordered by DRF on the card (K4, K5, at least
       4 launches each), then scanned (K1, K2).
     Every pod must bind (in the store, for `scheduler`), and no node's
     usage recomputed from the binds may exceed its allocatable;
  2. kernel phase: each kernel on the inputs the main paths gave it, held
     bit for bit against its plain PyTorch version on the card, and
     timed with CUDA events beside the plain version and, where one
     PyTorch call computes the same function, that call;
  3. the `uniform` and `spread` drains with the plain versions on the
     card (the kernels patched out in this script only): the binds must
     be equal;
  4. small drains (128 nodes, 1,024 pods) on the card against the same
     drains on the CPU: for `uniform` and `spread` the binds and score
     bits must be equal; for the nine-tenant scheduler loop (with
     KTPU_COMMIT_THREAD=0, the only setting whose multi-tenant order does
     not depend on thread timing) the binds and the DRF shares' bits.

It prints a `kernels` JSON line, the card's name and power limit as
nvidia-smi reports them, and as its last line
{"ok": true, "device": {"platform": "gpu", ...}}. Any failed phase exits
non-zero. Without a CUDA device, or without the package beside it, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

N_NODES = 5000
N_PODS = 50_000
BATCH = 16_384
SMALL_NODES, SMALL_PODS, SMALL_BATCH = 128, 1024, 256
#: the scheduler path's tenants (bench.py tenancy_main's nine steady
#: tenants) and its priority mix (every fourth pod at 1000)
N_TENANTS = 9
#: kernels each main path must launch
PATH_KERNELS = {"uniform": ("class_ms_init", "class_scan"),
                "spread": ("class_ms_init", "class_scan", "apply_dirty"),
                "scheduler": ("class_ms_init", "class_scan", "drf_dominant",
                              "drf_order")}
#: published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s
#: outside the tensor cores; the bound of a kernel is the larger of its
#: bytes over the first and its f32 operations over the second
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


# ------------------------------------------------------------- fixtures


class Port:
    """The port's modules, imported once the checks above passed."""

    def __init__(self):
        import torch
        from kubernetes_tpu_torch import api, workload
        from kubernetes_tpu_torch.scheduler import drain as drain_mod
        from kubernetes_tpu_torch.scheduler.cache import Cache
        from kubernetes_tpu_torch.scheduler.core import BatchScheduler
        from kubernetes_tpu_torch.scheduler.kernels import batch as kb
        from kubernetes_tpu_torch.scheduler.nodeinfo import (NodeInfo,
                                                              pod_resource)
        from kubernetes_tpu_torch.scheduler.priorities import SpreadListers
        from kubernetes_tpu_torch.scheduler.scheduler import Scheduler
        from kubernetes_tpu_torch.scheduler.tensorize import \
            precompute_pod_features
        from kubernetes_tpu_torch.state import Client
        from kubernetes_tpu_torch.tenancy import TENANT_LABEL
        from kubernetes_tpu_torch.tenancy import kernels as tk
        self.Scheduler, self.Client, self.tk = Scheduler, Client, tk
        self.precompute = precompute_pod_features
        self.TENANT_LABEL = TENANT_LABEL
        self.torch, self.api, self.wl = torch, api, workload
        self.drain, self.kb = drain_mod.drain, kb
        self.Cache, self.BatchScheduler = Cache, BatchScheduler
        self.NodeInfo, self.pod_resource = NodeInfo, pod_resource
        self.SpreadListers = SpreadListers

    def scheduler(self, n_nodes, variant, device):
        return self.wl.build(self.api, self.Cache, self.BatchScheduler,
                             self.SpreadListers, n_nodes, variant,
                             device=device)

    def pods(self, n, variant):
        return [self.wl.make_pod(self.api, i, variant) for i in range(n)]

    def tenant_pod(self, i):
        """bench.py's uniform pod i of tenant t{i % 9}, priority 1000 for
        every fourth pod (the DRF parity mix of bench.py tenancy)."""
        pod = self.wl.make_pod(self.api, i)
        pod.metadata.labels[self.TENANT_LABEL] = f"t{i % N_TENANTS}"
        pod.spec.priority = 1000 if i % 4 == 3 else 0
        return pod

    def launches(self):
        return {**self.kb.LAUNCHES, **self.tk.LAUNCHES}

    def reset_launches(self):
        self.kb.reset_launches()
        self.tk.reset_launches()


class Recorder:
    """Wraps the kernel entry points to keep (a copy of) the inputs the
    main path hands them, and brackets each call with CUDA events so the
    device time of the scan calls (K1 + K2 and the carry copies) and of
    the scatters (K3) can be summed per drain; the wrapped call itself is
    unchanged."""

    def __init__(self, port):
        self.kb, self.tk = port.kb, port.tk
        #: the inputs of the largest drf_dominant / drf_order call (the
        #: last one at that size, when shares have built up)
        self.dominant_inputs = None
        self.order_inputs = None
        #: variant -> its first batch's (node_cfg, usage, pod batch)
        self.scan_inputs = {}
        self.variant = None
        self.dirty_inputs = None    # largest apply_dirty call's inputs
        #: (variant, start event, end event) around every device call
        self.events = []
        self._orig = {}

    def __enter__(self):
        kb = self.kb
        self._orig = {"schedule_batch_packed": kb.schedule_batch_packed,
                      "apply_dirty": kb.apply_dirty}
        orig_scan, orig_dirty = (self._orig["schedule_batch_packed"],
                                 self._orig["apply_dirty"])

        def clone(d):
            return {k: v.clone() for k, v in d.items()}

        def timed(fn, *args):
            import torch
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args)
            b.record()
            self.events.append((self.variant, a, b))
            return out

        def scan(node_cfg, usage, pod_batch, nom=None):
            if self.variant not in self.scan_inputs:
                self.scan_inputs[self.variant] = (
                    clone(node_cfg), clone(usage), clone(pod_batch))
            return timed(orig_scan, node_cfg, usage, pod_batch, nom)

        def dirty(node_cfg, usage, idx, cfg_rows, usage_rows):
            if self.dirty_inputs is None or \
                    idx.shape[0] > self.dirty_inputs[2].shape[0]:
                self.dirty_inputs = (clone(node_cfg), clone(usage),
                                     idx.clone(), clone(cfg_rows),
                                     clone(usage_rows))
            return timed(orig_dirty, node_cfg, usage, idx, cfg_rows,
                         usage_rows)
        kb.schedule_batch_packed = scan
        kb.apply_dirty = dirty
        tk = self.tk
        self._orig_tk = {"drf_dominant": tk.drf_dominant,
                         "drf_order": tk.drf_order}
        orig_dom, orig_ord = tk.drf_dominant, tk.drf_order

        def dominant(usage, cap):
            if self.dominant_inputs is None or \
                    usage.shape[0] >= self.dominant_inputs[0].shape[0]:
                self.dominant_inputs = (usage.clone(), cap.clone())
            return timed(orig_dom, usage, cap)

        def order(prio, shares, tidx, pos):
            if self.order_inputs is None or \
                    prio.shape[0] >= self.order_inputs[0].shape[0]:
                self.order_inputs = (prio.clone(), shares.clone(),
                                     tidx.clone(), pos.clone())
            return timed(orig_ord, prio, shares, tidx, pos)
        tk.drf_dominant = dominant
        tk.drf_order = order
        return self

    def __exit__(self, *exc):
        for k, v in self._orig.items():
            setattr(self.kb, k, v)
        for k, v in self._orig_tk.items():
            setattr(self.tk, k, v)


class PlainOnCard:
    """Patches the kernel launchers out of the drain for this script's
    comparison run, so the same tensors on the card take the plain
    PyTorch versions. The package itself has no such switch."""

    def __init__(self, port):
        self.kb = port.kb
        self._orig = {}

    def __enter__(self):
        kb = self.kb
        self._orig = {"class_ms_init": kb.class_ms_init,
                      "_class_scan_cuda": kb._class_scan_cuda,
                      "apply_dirty": kb.apply_dirty}
        kb.class_ms_init = kb.class_ms_init_plain
        kb._class_scan_cuda = kb._class_scan_plain
        kb.apply_dirty = kb.apply_dirty_plain
        return self

    def __exit__(self, *exc):
        for k, v in self._orig.items():
            setattr(self.kb, k, v)


def run_scheduler_drain(port, device, n_nodes, n_pods, batch):
    """The scheduler loop on `device`, built as bench.py's run_config
    builds it: nodes and pods created through the port's Client, nodes
    fed to the cache, pods (features precomputed, as the informer thread
    does) to the queue. Returns the drain's numbers; host phases and the
    launch-to-committed latency of each batch are taken by wrapping the
    drain's own methods here (the package has no such hooks)."""
    client = port.Client(validate=False)
    sched = port.Scheduler(client, batch_size=batch, device=device)
    t0 = time.perf_counter()
    for i in range(n_nodes):
        node = port.wl.make_node(port.api, i)
        client.nodes().create(node)
        sched.cache.add_node(node)
    pods = [client.pods().create(port.tenant_pod(i)) for i in range(n_pods)]
    for pod in pods:
        port.precompute(pod)
        sched.queue.add(pod)
    setup_s = time.perf_counter() - t0
    sched.algorithm.refresh()
    phases = {"drf_order": 0.0, "launch": 0.0, "finish": 0.0,
              "commit": 0.0}
    latency = []
    algo = sched.algorithm

    def timed(name, fn):
        def run(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                phases[name] += time.perf_counter() - t
        return run
    sched._drf_order = timed("drf_order", sched._drf_order)
    sched._commit_stage = timed("commit", sched._commit_stage)
    algo.schedule_finish = timed("finish", algo.schedule_finish)
    launch = timed("launch", algo.schedule_launch)

    def schedule_launch(*a, **kw):
        t = time.perf_counter()
        pending = launch(*a, **kw)
        if pending is not None:
            pending.t_launch = t
        return pending
    algo.schedule_launch = schedule_launch
    finish_pipelined = sched._finish_pipelined

    def finish(pending, cycle, commit_fut):
        fut = finish_pipelined(pending, cycle, commit_fut)
        if fut is None:
            latency.append(time.perf_counter() - pending.t_launch)
        else:
            fut.add_done_callback(lambda f, t=pending.t_launch:
                                  latency.append(time.perf_counter() - t))
        return fut
    sched._finish_pipelined = finish
    algo.reset_phase_stats()
    t0 = time.perf_counter()
    n = sched.drain_pipelined()
    wall = time.perf_counter() - t0
    sched.stop()
    stored = client.pods().list()
    return {"sched": sched, "client": client, "pods": stored, "bound": n,
            "binds": {p.metadata.key(): p.spec.node_name or None
                      for p in stored},
            "wall": wall, "setup_s": setup_s, "latency": latency,
            "phases": phases, "commit_thread": sched._commit_async,
            "phase_stats": dict(algo.phase_stats)}


def run_drain(port, variant, device, n_nodes, n_pods, batch, chain):
    sched, cache = port.scheduler(n_nodes, variant, device)
    pods = port.pods(n_pods, variant)
    t0 = time.perf_counter()
    res = port.drain(sched, pods, batch, chain=chain)
    wall = time.perf_counter() - t0
    return sched, pods, res, wall


def check_capacity(port, variant, n_nodes, pods, binds):
    """Every pod bound, and per node the recomputed requests (cpu,
    memory, pod count) within allocatable."""
    unbound = [k for k, v in binds.items() if v is None]
    if len(binds) != len(pods) or unbound:
        fail(f"{variant}: {len(pods) - len(binds) + len(unbound)} of "
             f"{len(pods)} pods did not bind")
    alloc = {}
    for i in range(n_nodes):
        node = port.wl.make_node(port.api, i, variant)
        alloc[node.metadata.name] = port.NodeInfo(node).allocatable
    used = {}
    for pod in pods:
        node = binds[pod.metadata.key()]
        r = port.pod_resource(pod)
        u = used.setdefault(node, [0, 0, 0])
        u[0] += r.milli_cpu
        u[1] += r.memory
        u[2] += 1
    for node, (cpu, mem, cnt) in used.items():
        a = alloc[node]
        if cpu > a.milli_cpu or mem > a.memory or \
                cnt > a.allowed_pod_number:
            fail(f"{variant}: node {node} over capacity: cpu {cpu}/"
                 f"{a.milli_cpu}, memory {mem}/{a.memory}, pods {cnt}/"
                 f"{a.allowed_pod_number}")


def pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]


# ------------------------------------------------------------- timing


def time_cuda(torch, fn, reps, warm=1):
    """Mean ms of fn() over reps launches, by CUDA events after warm-up."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def time_host(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def bound(bytes_, ops):
    t_b = bytes_ / HBM_BYTES_PER_S * 1e3
    t_o = ops / F32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def max_abs(torch, a, b):
    if a.dtype == torch.bool or a.dtype == torch.int32:
        return 0.0 if torch.equal(a, b) else float("inf")
    return float((a.double() - b.double()).abs().max().item()) \
        if a.numel() else 0.0


def bits_equal(torch, a, b):
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def check_scan(port, node_cfg, usage, pb, label):
    """K1 + K2 against their plain versions on one batch's inputs;
    returns (packed, post-batch usage, max abs error)."""
    torch, kb = port.torch, port.kb
    packed_k, use_k = kb.schedule_batch_packed(node_cfg, usage, pb)
    with PlainOnCard(port):
        packed_p, use_p = kb.schedule_batch_packed(node_cfg, usage, pb)
    torch.cuda.synchronize()
    if not torch.equal(packed_k, packed_p):
        fail(f"K2 class_scan disagrees with its plain version on the "
             f"{label} batch ({int((packed_k != packed_p).sum())} packed "
             "entries)")
    for k in use_p:
        if not bits_equal(torch, use_k[k], use_p[k]):
            fail(f"K2 class_scan post-batch usage {k} disagrees on the "
                 f"{label} batch")
    err = max(max_abs(torch, packed_k[0], packed_p[0]),
              max_abs(torch, packed_k[1].view(torch.float32),
                      packed_p[1].view(torch.float32)),
              *(max_abs(torch, use_k[k], use_p[k]) for k in use_p))
    return packed_k, use_k, err


def kernel_phase(port, rec, launches):
    torch, kb = port.torch, port.kb
    node_cfg, usage, pb = rec.scan_inputs["uniform"]
    cls = {k: pb[k] for k in kb._CLASS_KEYS}
    rw, um, us = pb["resource_weights"], pb["unique_masks"], \
        pb["unique_scores"]
    N, R = node_cfg["alloc"].shape
    C = cls["class_req"].shape[0]
    P = pb["class_idx"].shape[0]
    rows = []

    # ---- K1 class_ms_init
    ms_k = kb.class_ms_init(node_cfg, usage, cls, um, us, rw)
    ms_p = kb.class_ms_init_plain(node_cfg, usage, cls, um, us, rw)
    torch.cuda.synchronize()
    if not bits_equal(torch, ms_k, ms_p):
        fail("K1 class_ms_init disagrees with its plain version")
    k1_ms = time_cuda(torch, lambda: kb.class_ms_init(
        node_cfg, usage, cls, um, us, rw), reps=50, warm=3)
    k1_plain_ms, _ = time_host(torch, lambda: kb.class_ms_init_plain(
        node_cfg, usage, cls, um, us, rw))
    k1_bytes = nbytes(*node_cfg.values(), *usage.values(), *cls.values(),
                      rw, ms_k) + um.numel() + us.numel() * 4
    # per (class, node): R adds + R compares, 2 nz adds, ~24 score ops
    k1_ops = C * N * (2 * R + 28)
    k1_bound = bound(k1_bytes, k1_ops)
    rows.append({"name": "class_ms_init", "route": "cuda",
                 "source": "kubernetes_tpu_torch/csrc/class_ms_init.cu",
                 "replaces": "kubernetes_tpu/scheduler/kernels/batch.py:327",
                 "launches": launches["class_ms_init"],
                 "max_abs_err": max_abs(torch, ms_k, ms_p),
                 "ms": k1_ms, "plain_ms": k1_plain_ms,
                 "bound_ms": k1_bound[0], "bound_by": k1_bound[1],
                 "library_ms": None, "match": True,
                 "bytes": k1_bytes, "ops": k1_ops,
                 "shape": f"C={C} N={N} R={R}"})

    # ---- K2 class_scan (K1 + K2 inside schedule_batch_packed; K2 alone
    # is timed on a prepared table)
    has_spread = pb.get("spread_base") is not None
    packed_k, use_k, err = check_scan(port, node_cfg, usage, pb, "uniform")
    # the spread carries run only on the spread batch: hold them too
    s_cfg, s_usage, s_pb = rec.scan_inputs["spread"]
    _, _, s_err = check_scan(port, s_cfg, s_usage, s_pb, "spread")
    err = max(err, s_err)
    s_cls = {k: s_pb[k] for k in kb._CLASS_KEYS}

    def spread_scan():
        _, _, ms0, carry, hs = kb._scan_setup(s_cfg, s_usage, s_pb)
        return lambda: kb._class_scan_cuda(s_cfg, s_pb, s_cls,
                                           s_pb["resource_weights"], ms0,
                                           carry, hs)
    k2_spread_ms = [time_cuda(torch, spread_scan(), reps=1, warm=0)
                    for _ in range(2)][-1]

    def scan_only(plain=False):
        # a fresh table and carry for each run; only the scan is timed
        _, _, ms0, carry, hs = kb._scan_setup(node_cfg, usage, pb)
        fn = kb._class_scan_plain if plain else kb._class_scan_cuda
        return lambda: fn(node_cfg, pb, cls, rw, ms0, carry, hs)
    k2_runs = []
    for _ in range(3):
        run = scan_only()
        k2_runs.append(time_cuda(torch, run, reps=1, warm=0))
    k2_ms = sum(k2_runs[1:]) / 2   # the first run pays the library load
    k2_plain_ms, _ = time_host(torch, scan_only(plain=True))
    G = pb["spread_base"].shape[0] if has_spread else 0
    k2_bytes = (nbytes(*node_cfg.values(), *usage.values(), *cls.values(),
                       rw, ms_k, pb["class_idx"], pb["seq"], pb["active"],
                       packed_k, use_k["used"], use_k["nonzero_used"],
                       use_k["pod_count"], ms_k)
                + um.numel() + us.numel() * 4)
    if has_spread:
        k2_bytes += nbytes(pb["spread_gidx"], pb["spread_match"],
                           pb["spread_base"], pb["spread_zone"],
                           use_k["spread"])
    # per (pod, node): feasibility compare, select, tie penalty mul + sub,
    # argmax compare; spread adds ~14 (reductions, scores, blend); per
    # pod the winner column over C classes and the usage adds
    per_node = 5 + (14 if has_spread else 0)
    k2_ops = P * (N * per_node + C * (2 * R + 28) + R + 3 + G)
    k2_bound = bound(k2_bytes, k2_ops)
    rows.append({"name": "class_scan", "route": "cuda",
                 "source": "kubernetes_tpu_torch/csrc/class_scan.cu",
                 "replaces": "kubernetes_tpu/scheduler/kernels/batch.py:596",
                 "launches": launches["class_scan"], "max_abs_err": err,
                 "ms": k2_ms, "plain_ms": k2_plain_ms,
                 "bound_ms": k2_bound[0], "bound_by": k2_bound[1],
                 "library_ms": None, "match": True,
                 "bytes": k2_bytes, "ops": k2_ops,
                 "shape": f"P={P} C={C} N={N} R={R} G={G}",
                 "ms_spread_batch": k2_spread_ms})

    # ---- K3 apply_dirty
    if rec.dirty_inputs is None:
        fail("the main path never scattered dirty rows (K3)")
    cfg0, use0, idx, cfg_rows, use_rows = rec.dirty_inputs

    def fresh():
        return ({k: v.clone() for k, v in cfg0.items()},
                {k: v.clone() for k, v in use0.items()})
    ck, uk = kb.apply_dirty(*fresh(), idx, cfg_rows, use_rows)
    cp_, up_ = kb.apply_dirty_plain(*fresh(), idx, cfg_rows, use_rows)
    torch.cuda.synchronize()
    for k in ck:
        if not bits_equal(torch, ck[k], cp_[k]):
            fail(f"K3 apply_dirty disagrees on {k}")
    for k in uk:
        if not bits_equal(torch, uk[k], up_[k]):
            fail(f"K3 apply_dirty disagrees on {k}")
    tables = fresh()
    k3_ms = time_cuda(torch, lambda: kb.apply_dirty(
        tables[0], tables[1], idx, cfg_rows, use_rows), reps=50, warm=3)
    k3_plain_ms, _ = time_host(torch, lambda: kb.apply_dirty_plain(
        tables[0], tables[1], idx, cfg_rows, use_rows))
    cap = next(iter(cfg0.values())).shape[0]
    keep = (idx >= 0) & (idx < cap)
    live = idx[keep].long()
    lib_src = {k: v[keep] for k, v in {**cfg_rows, **use_rows}.items()}
    lib_dst = {**tables[0], **tables[1]}

    def library():
        for k, t in lib_dst.items():
            t.index_copy_(0, live, lib_src[k])
    k3_lib_ms = time_cuda(torch, library, reps=50, warm=3)
    D = idx.shape[0]
    n_live = int(keep.sum())
    row_bytes = sum(t.element_size() * (t.numel() // t.shape[0])
                    for t in lib_dst.values())
    k3_bytes = D * 4 + 2 * n_live * row_bytes
    k3_bound = bound(k3_bytes, 0)
    rows.append({"name": "apply_dirty", "route": "cuda",
                 "source": "kubernetes_tpu_torch/csrc/apply_dirty.cu",
                 "replaces": "kubernetes_tpu/scheduler/kernels/batch.py:1146",
                 "launches": launches["apply_dirty"], "max_abs_err": 0.0,
                 "ms": k3_ms, "plain_ms": k3_plain_ms,
                 "bound_ms": k3_bound[0], "bound_by": k3_bound[1],
                 "library_ms": k3_lib_ms, "match": True,
                 "library_call": f"index_copy_ x{len(lib_dst)} tables",
                 "bytes": k3_bytes, "ops": 0,
                 "shape": f"D={D} ({n_live} rows) N={cap}"})
    rows.extend(drf_rows(port, rec, launches))
    return rows


def drf_rows(port, rec, launches):
    """K4 and K5 on the inputs the scheduler path gave them."""
    torch, tk = port.torch, port.tk
    if rec.dominant_inputs is None or rec.order_inputs is None:
        fail("the scheduler path never reached the DRF kernels")
    rows = []

    # ---- K4 drf_dominant
    usage, cap = rec.dominant_inputs
    T, R = usage.shape
    sh_k = tk.drf_dominant(usage, cap)
    sh_p = tk.drf_dominant_plain(usage, cap)
    torch.cuda.synchronize()
    if not bits_equal(torch, sh_k, sh_p):
        fail("K4 drf_dominant disagrees with its plain version")
    k4_ms = time_cuda(torch, lambda: tk.drf_dominant(usage, cap), reps=200,
                      warm=5)
    k4_plain_ms, _ = time_host(torch, lambda: tk.drf_dominant_plain(
        usage, cap))
    k4_lib_ms = time_cuda(torch, lambda: (
        usage / torch.clamp_min(cap, 1.0)).amax(1), reps=200, warm=5)
    k4_bytes = T * R * 4 + R * 4 + T * 4
    k4_bound = bound(k4_bytes, 2 * T * R)
    rows.append({"name": "drf_dominant", "route": "cuda",
                 "source": "kubernetes_tpu_torch/csrc/drf_dominant.cu",
                 "replaces": "kubernetes_tpu/tenancy/drf.py:98",
                 "launches": launches["drf_dominant"],
                 "max_abs_err": max_abs(torch, sh_k, sh_p),
                 "ms": k4_ms, "plain_ms": k4_plain_ms,
                 "bound_ms": k4_bound[0], "bound_by": k4_bound[1],
                 "library_ms": k4_lib_ms, "match": True,
                 "library_call": "(usage / clamp_min(cap, 1)).amax(1), "
                                 "one expression of three calls",
                 "bytes": k4_bytes, "ops": 2 * T * R,
                 "shape": f"T={T} R={R}"})

    # ---- K5 drf_order
    prio, shares, tidx, pos = rec.order_inputs
    P = prio.shape[0]
    perm_k = tk.drf_order(prio, shares, tidx, pos)
    perm_p = tk.drf_order_plain(prio, shares, tidx, pos)
    torch.cuda.synchronize()
    if not torch.equal(perm_k, perm_p):
        n = int((perm_k != perm_p).sum())
        fail(f"K5 drf_order disagrees with its plain version ({n} of {P}"
             " entries)")
    k5_ms = time_cuda(torch, lambda: tk.drf_order(prio, shares, tidx, pos),
                      reps=20, warm=2)
    k5_plain_ms, _ = time_host(torch, lambda: tk.drf_order_plain(
        prio, shares, tidx, pos))
    if not torch.equal(pos, torch.arange(P, dtype=torch.int32,
                                         device=pos.device)):
        fail("the drain's pop positions are not 0..P-1")
    neg = tk.neg_wrap(prio)

    def two_pass():
        # pos is 0..P-1: lexsort is two stable sorts, minor key first
        perm = torch.sort(shares[tidx.long()], stable=True).indices
        return perm[torch.sort(neg[perm], stable=True).indices]
    if not torch.equal(two_pass().to(torch.int32), perm_k):
        fail("the two-pass torch.sort yardstick disagrees with K5")
    k5_lib_ms = time_cuda(torch, two_pass, reps=20, warm=2)
    k5_bytes = 4 * P * 4 + shares.numel() * 4
    # a comparison sort of P keys needs P log2 P comparisons of three-part
    # keys; the rank-counting kernel itself does P * P of them
    k5_ops = int(3 * P * math.log2(max(P, 2)))
    k5_bound = bound(k5_bytes, k5_ops)
    rows.append({"name": "drf_order", "route": "cuda",
                 "source": "kubernetes_tpu_torch/csrc/drf_order.cu",
                 "replaces": "kubernetes_tpu/tenancy/drf.py:115",
                 "launches": launches["drf_order"], "max_abs_err": 0.0,
                 "ms": k5_ms, "plain_ms": k5_plain_ms,
                 "bound_ms": k5_bound[0], "bound_by": k5_bound[1],
                 "library_ms": k5_lib_ms, "match": True,
                 "library_call": "two-pass stable torch.sort (share, then "
                                 "-prio), positions 0..P-1",
                 "bytes": k5_bytes, "ops": k5_ops,
                 "kernel_comparisons": P * P,
                 "shape": f"P={P} T={shares.numel()}"})
    return rows


def main() -> None:
    try:
        import torch
    except ImportError as e:
        fail(f"PyTorch is not installed ({e})")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs on the GPU only")
    sys.path.insert(0, HERE)
    try:
        import kubernetes_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the kubernetes_tpu_torch package is not here ({e}); run "
             "from a checkout of the repository")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    tag = f"[{card}]"
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- build
    from kubernetes_tpu_torch.scheduler.kernels import build
    t0 = time.perf_counter()
    built = build.build_all(verbose=True)
    print(f"build: {len(built)} kernels with nvcc (sm_90a) in "
          f"{time.perf_counter() - t0:.1f} s, in parallel")
    for k, v in built.items():
        info = [ln.strip() for ln in v["log"].splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"  {k}: {os.path.basename(v['path'])}: {' | '.join(info)}")
    port = Port()
    kb = port.kb
    dev = torch.device("cuda")

    # ---- main paths: counts zeroed just before each, read just after
    rec = Recorder(port)
    per_path = {}
    drains = {}
    with rec:
        for variant, chain in (("uniform", True), ("spread", False)):
            rec.variant = variant
            port.reset_launches()
            sched, pods, res, wall = run_drain(
                port, variant, dev, N_NODES, N_PODS, BATCH, chain)
            per_path[variant] = port.launches()
            drains[variant] = (sched, pods, res, wall)
        rec.variant = "scheduler"
        port.reset_launches()
        sp = run_scheduler_drain(port, dev, N_NODES, N_PODS, BATCH)
        per_path["scheduler"] = port.launches()
    for path, kernels in PATH_KERNELS.items():
        for k in kernels:
            if per_path[path][k] == 0:
                fail(f"kernel {k} was never launched on the {path} path")
    for k in ("drf_dominant", "drf_order"):
        if per_path["scheduler"][k] < 4:
            fail(f"{k} launched {per_path['scheduler'][k]} times on the "
                 "scheduler path; a drain of 50,000 pods in batches of "
                 "16,384 orders at least 4 pops on the card")
    launches = {k: sum(c[k] for c in per_path.values())
                for k in per_path["uniform"]}
    torch.cuda.synchronize()
    for variant, (sched, pods, res, wall) in drains.items():
        check_capacity(port, variant, N_NODES, pods, res.binds)
        bs = [s * 1e3 for s in res.batch_seconds]
        busy = sum(a.elapsed_time(b) for v, a, b in rec.events
                   if v == variant)
        print(f"main path: {variant} drain of {N_PODS} pods onto {N_NODES}"
              f" nodes, batches of {BATCH} ({res.batches} batches, "
              f"{res.chained} chained): all bound, capacity held; "
              f"{wall} s = {N_PODS / wall} pods/s; batch latency p50 "
              f"{pct(bs, 0.5)} ms p99 {pct(bs, 0.99)} ms; launches "
              f"{per_path[variant]}; host phases (s): launch "
              f"{res.launch_s} finish {res.finish_s} commit {res.commit_s}"
              f", inside them {sched.phase_stats}; device busy in the "
              f"kernel calls {busy} ms of {wall * 1e3} ms wall, idle share "
              f"{1 - busy / (wall * 1e3)} {tag}")
    for variant in drains:
        if variant not in rec.scan_inputs:
            fail(f"the {variant} drain never reached the class scan")
    # the scheduler loop: every pod bound in the store, capacity held
    if sp["bound"] != N_PODS:
        fail(f"scheduler: drain_pipelined bound {sp['bound']} of {N_PODS}")
    check_capacity(port, "scheduler", N_NODES, sp["pods"], sp["binds"])
    if not sp["commit_thread"]:
        fail("scheduler: the commit thread was off on the card")
    lat = [t * 1e3 for t in sp["latency"]]
    busy = sum(a.elapsed_time(b) for v, a, b in rec.events
               if v == "scheduler")
    wall = sp["wall"]
    print(f"main path: scheduler drain_pipelined of {N_PODS} pods of "
          f"{N_TENANTS} tenants onto {N_NODES} nodes, batches of {BATCH}, "
          f"commit thread on: all bound in the store, capacity held; "
          f"{wall} s = {N_PODS / wall} pods/s; batch latency (launch to "
          f"committed) p50 {pct(lat, 0.5)} ms p99 {pct(lat, 0.99)} ms over "
          f"{len(lat)} batches; launches {per_path['scheduler']}; host "
          f"phases (s): drf order {sp['phases']['drf_order']} launch "
          f"{sp['phases']['launch']} finish {sp['phases']['finish']} "
          f"commit (commit thread) {sp['phases']['commit']}, inside them "
          f"{sp['phase_stats']}; cluster set-up {sp['setup_s']} s; device "
          f"busy in the kernel calls {busy} ms of {wall * 1e3} ms wall, "
          f"idle share {1 - busy / (wall * 1e3)} {tag}")
    drf_rep = sp["sched"].drf.report()
    print("scheduler: DRF dominant shares after the drain "
          f"{ {t: v['dominant_share'] for t, v in drf_rep['tenants'].items()} }")

    # ---- kernel phase (on the main path's own inputs)
    rows = kernel_phase(port, rec, launches)
    for r in rows:
        r["launches_per_path"] = {v: per_path[v][r["name"]]
                                  for v in per_path}
        print(f"  {r['name']} at {r['shape']}: bit-identical to plain; "
              f"{r['ms']} ms per launch (plain {r['plain_ms']} ms, library "
              f"{r['library_ms']} ms, bound {r['bound_ms']} ms by "
              f"{r['bound_by']}); {r['launches']} launches on the main "
              f"path {tag}")

    # ---- the same drains with the plain versions on the card
    for variant, chain in (("uniform", True), ("spread", False)):
        port.reset_launches()
        with PlainOnCard(port):
            _, _, pres, pwall = run_drain(port, variant, dev, N_NODES,
                                          N_PODS, BATCH, chain)
        if any(port.launches().values()):
            fail(f"the plain {variant} drain launched kernels")
        kres = drains[variant][2]
        if pres.binds != kres.binds:
            n = sum(pres.binds[k] != kres.binds.get(k) for k in pres.binds)
            fail(f"{variant}: {n} binds differ between the kernels and "
                 "the plain versions on the card")
        print(f"plain versions on the card: {variant} drain binds equal "
              f"the kernels' ({pwall} s) {tag}")

    # ---- small drain: card against CPU
    for variant in ("uniform", "spread"):
        _, _, gres, _ = run_drain(port, variant, dev, SMALL_NODES,
                                  SMALL_PODS, SMALL_BATCH, True)
        _, _, cres, _ = run_drain(port, variant, "cpu", SMALL_NODES,
                                  SMALL_PODS, SMALL_BATCH, True)
        import numpy as np
        same_scores = all(
            np.float32(gres.scores[k]).view(np.int32)
            == np.float32(cres.scores[k]).view(np.int32)
            for k in cres.scores)
        if gres.binds != cres.binds or not same_scores:
            fail(f"small {variant} drain: the card disagrees with the CPU")
        print(f"small {variant} drain ({SMALL_PODS} pods, {SMALL_NODES} "
              "nodes): card equals CPU, binds and score bits")

    # ---- small scheduler loop, nine tenants: card against CPU. The
    # multi-tenant order depends on commit-thread timing (the commit
    # thread charges DRF usage while the drain thread orders the next
    # pop), so both run with the commit stage inline.
    saved = os.environ.get("KTPU_COMMIT_THREAD")
    os.environ["KTPU_COMMIT_THREAD"] = "0"
    try:
        small = [run_scheduler_drain(port, d, SMALL_NODES, SMALL_PODS,
                                     SMALL_BATCH) for d in (dev, "cpu")]
    finally:
        if saved is None:
            del os.environ["KTPU_COMMIT_THREAD"]
        else:
            os.environ["KTPU_COMMIT_THREAD"] = saved
    g, c = small
    if g["bound"] != SMALL_PODS or g["binds"] != c["binds"]:
        fail("small scheduler drain: the card's binds differ from the "
             "CPU's")
    import numpy as np
    g_sh, c_sh = (r["sched"].drf.dominant_shares() for r in small)
    if g_sh.view(np.int32).tolist() != c_sh.view(np.int32).tolist() or \
            g["sched"].drf.report() != c["sched"].drf.report():
        fail("small scheduler drain: the DRF shares differ between the "
             "card and the CPU")
    print(f"small scheduler drain ({SMALL_PODS} pods of {N_TENANTS} "
          f"tenants, {SMALL_NODES} nodes, batches of {SMALL_BATCH}, "
          "KTPU_COMMIT_THREAD=0): card equals CPU, binds and DRF share "
          "bits")

    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
