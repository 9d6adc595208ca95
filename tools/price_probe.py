#!/usr/bin/env python3
"""Times K11 price_domains and K8 filter_score on one GPU.

    python3 tools/price_probe.py [--root DIR] [--kernels k11,k8] [--reps N]

K11: the gang storm's two decisions as chip_smoke.py's gang-storm path
makes them (workload.storm_cache at 5,000 nodes, a BatchScheduler on the
card, one keyless preempt_gang call, whose one domain row holds every
victim unit of the cluster, then one on tpu/slice over 625 slices); each
recorded call is held against price_domains_plain, then timed by CUDA
events (the host's enqueue included), by the profiler's device time and
beside the one-expression yardstick (chip_smoke.domains_vectorized),
with the design its width takes.

K8: a seeded batch of 16,384 pods over 8,192 node rows and 8 resource
columns (the main path's shape), without and with spread groups (16
zones), and the first batch of chip_smoke.py's uniform and spread drains
(the inputs of its K8 rows); on each, the distinct pods a 64-pod tile
(the pods the kernel computes) and the distinct non-zero request pairs
(the resource scores a tile could share), fits and score bits held
against filter_score_plain, then timed by events and by device (each of
its launches' device time apart).

--root DIR imports the package of the tree at DIR (default: this
checkout), so a `git archive` of another commit, or a copy with one
change to a kernel, is measured by the same script. It prints the
card's name and power limit and one JSON object. It needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STORM_NODES = 5000
FILTER_P, FILTER_N, FILTER_R, FILTER_G, FILTER_Z = 16384, 8192, 8, 4, 17
#: csrc/filter_score.cu KTPU_FILTER_PODS
FILTER_TILE = 64


def _k11(cs, torch, args):
    from kubernetes_tpu_torch import api, workload
    from kubernetes_tpu_torch.scheduler.cache import Cache
    from kubernetes_tpu_torch.scheduler.core import BatchScheduler
    from kubernetes_tpu_torch.scheduler.kernels import preempt as pk
    cache, pdbs = workload.storm_cache(api, Cache, STORM_NODES)
    sched = BatchScheduler(cache, pdb_lister=lambda: pdbs,
                           device=torch.device("cuda"))
    calls = []
    orig = pk.price_domains

    def rec(*a):
        calls.append(a)
        return orig(*a)
    pk.price_domains = rec
    try:
        _, free = workload.storm_gang(api, 1, topology_key="")
        sched.preempt_gang(free, 8, "")
        _, members = workload.storm_gang(api, 0)
        sched.preempt_gang(members, 8, workload.STORM_SLICE)
    finally:
        pk.price_domains = orig
    if len(calls) != 2:
        sys.exit(f"price_probe: {len(calls)} price_domains calls, not 2")
    out = {}
    for tag, a in (("keyless", calls[0]), ("keyed", calls[1])):
        got = pk.price_domains(*a)
        want = pk.price_domains_plain(*a)
        torch.cuda.synchronize()
        if not cs.decisions_equal(torch, got, want):
            sys.exit(f"price_probe: K11 {tag} disagrees with its plain "
                     "version")
        D, U = a[2].shape
        out[f"k11_{tag}"] = {
            "shape": [D, U], "winner": int(got[0]),
            "ms": cs.time_cuda(torch, lambda: pk.price_domains(*a),
                               reps=args.reps, warm=5),
            "device_ms": cs.device_ms(torch, lambda: pk.price_domains(*a),
                                      reps=max(5, args.reps // 4)),
            "library_ms": cs.time_cuda(
                torch, lambda: cs.domains_vectorized(torch, a),
                reps=max(5, args.reps // 4), warm=3),
            "library_device_ms": cs.device_ms(
                torch, lambda: cs.domains_vectorized(torch, a),
                reps=max(5, args.reps // 8))}
        out[f"k11_{tag}"]["design"] = pk.price_domains_design(U)
    return out


def _filter_batch(torch, spread):
    import numpy as np
    from kubernetes_tpu_torch.convert import tables_from_numpy
    P, N, R, G, Z = FILTER_P, FILTER_N, FILTER_R, FILTER_G, FILTER_Z
    rng = np.random.default_rng(19)
    f32, MiB = np.float32, float(2 ** 20)
    alloc = np.zeros((N, R), f32)
    alloc[:, 0] = rng.choice([2000, 4000, 8000], N)
    alloc[:, 1] = rng.choice([8, 16, 32], N) * 1024 * MiB
    alloc[:, 2:] = rng.integers(0, 4, (N, R - 2))
    frac = rng.choice([0.0, 0.3, 0.7, 0.95], N)
    used = np.zeros((N, R), f32)
    used[:, 0] = np.floor(alloc[:, 0] * frac / 50) * 50
    used[:, 1] = np.floor(alloc[:, 1] * frac / MiB) * MiB
    node_cfg = {"alloc": alloc, "max_pods": np.full(N, 110, f32),
                "node_ok": rng.random(N) > 0.05,
                "mem_pressure": rng.random(N) < 0.1,
                "valid": np.ones(N, bool)}
    usage = {"used": used, "nonzero_used": used[:, :2].copy(),
             "pod_count": rng.integers(0, 110, N).astype(f32)}
    req = np.zeros((P, R), f32)
    req[:, 0] = rng.choice([100, 250, 500], P)
    req[:, 1] = rng.choice([128, 512, 1024], P) * MiB
    pb = {"req": req, "nonzero_req": req[:, :2].copy(),
          "mem_pressure_blocked": rng.random(P) < 0.3,
          "mask_idx": rng.integers(0, 3, P).astype(np.int32),
          "score_idx": rng.integers(0, 2, P).astype(np.int32),
          "unique_masks": rng.random((3, N)) < 0.9,
          "unique_scores": rng.integers(0, 7, (2, N)).astype(f32),
          "resource_weights": np.ones(2, f32),
          "seq": np.arange(P, dtype=np.int32)}
    if spread:
        pb.update(spread_gidx=rng.integers(-1, G, P).astype(np.int32),
                  spread_base=rng.integers(0, 5, (G, N)).astype(f32),
                  spread_zone=rng.integers(0, Z, N).astype(np.int32),
                  spread_zinit=np.zeros(Z, f32),
                  spread_weight=np.float32(1.0))
    return tables_from_numpy(node_cfg, usage, pb, torch.device("cuda"))


def _tile_groups(torch, cpb, spread):
    """Distinct pods (bit for bit the same request row, non-zero request
    pair, blocked flag, mask, score and spread rows: csrc/filter_score.cu
    ktpu_filter_same) and distinct non-zero request pairs a tile of
    csrc/filter_score.cu KTPU_FILTER_PODS pods: mean, min and max over
    the batch's tiles."""
    i32 = torch.int32
    nz = cpb["nonzero_req"].contiguous().view(i32)
    cols = [cpb["req"].contiguous().view(i32), nz,
            cpb["mem_pressure_blocked"].to(i32)[:, None],
            cpb["mask_idx"].to(i32)[:, None],
            cpb["score_idx"].to(i32)[:, None]]
    if spread:
        cols.append(cpb["spread_gidx"].to(i32)[:, None])
    key = torch.cat(cols, 1)
    pods, pairs = [], []
    for p0 in range(0, key.shape[0], FILTER_TILE):
        pods.append(torch.unique(key[p0:p0 + FILTER_TILE], dim=0).shape[0])
        pairs.append(torch.unique(nz[p0:p0 + FILTER_TILE], dim=0).shape[0])
    return {f"{name}_a_tile": {"mean": sum(v) / len(v), "min": min(v),
                               "max": max(v)}
            for name, v in (("distinct_pods", pods),
                            ("distinct_pairs", pairs))}


def _main_path_batches(cs, torch):
    """The first batch of chip_smoke.py's uniform and spread drains (its
    K8 rows' inputs), classic_batch as its filter_rows takes it."""
    port = cs.Port()
    rec = cs.Recorder(port)
    with rec:
        for variant in ("uniform", "spread"):
            rec.variant = variant
            cs.run_drain(port, variant, torch.device("cuda"), cs.N_NODES,
                         cs.BATCH, cs.BATCH, False)
    for path in ("uniform", "spread"):
        node_cfg, usage, pb, _ = rec.scan_inputs[path]
        yield path, (node_cfg, usage, cs.classic_batch(port.kb, pb))


def _k8(cs, torch, args):
    from kubernetes_tpu_torch.scheduler.kernels import batch as kb
    out = {}
    batches = [(("seeded", "filter_score" + "_spread" * spread),
                _filter_batch(torch, spread)) for spread in (False, True)]
    for path, tables in _main_path_batches(cs, torch):
        spread = "spread_base" in tables[2]
        batches.append(((path, "filter_score" + "_spread" * spread),
                        tables))
    for (path, name), (tc, tu, tpb) in batches:
        fits, score = kb.filter_score(tc, tu, tpb)
        ref_fits, ref_score = kb.filter_score_plain(tc, tu, tpb)
        torch.cuda.synchronize()
        if not (torch.equal(fits, ref_fits)
                and cs.bits_equal(torch, score, ref_score)):
            sys.exit(f"price_probe: K8 {name} disagrees with its plain "
                     f"version on the {path} batch")
        del ref_fits, ref_score
        row = out[f"k8_{path}_{name}"] = {
            "shape": [tpb["seq"].shape[0], *tc["alloc"].shape],
            "fits": int(fits.sum()),
            **_tile_groups(torch, tpb, "spread_base" in tpb),
            "ms": cs.time_cuda(torch, lambda: kb.filter_score(tc, tu, tpb),
                               reps=max(5, args.reps // 20), warm=2),
            "device_split": cs.device_split(
                torch, lambda: kb.filter_score(tc, tu, tpb),
                reps=max(5, args.reps // 40))}
        row["device_ms"] = sum(row["device_split"].values())
        del fits, score
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--kernels", default="k11,k8")
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("price_probe: no CUDA device")
    sys.path.insert(0, HERE)
    import chip_smoke as cs   # timing helpers; this checkout's
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import kubernetes_tpu_torch
    if not kubernetes_tpu_torch.__file__.startswith(root):
        sys.exit(f"price_probe: imported {kubernetes_tpu_torch.__file__},"
                 f" not the package under {root}")
    from kubernetes_tpu_torch.scheduler.kernels import build
    card = cs.card_line()
    print(card)
    build.build_all()
    out = {"root": root, "card": card, "reps": args.reps}
    kernels = args.kernels.split(",")
    if "k11" in kernels:
        out.update(_k11(cs, torch, args))
    if "k8" in kernels:
        out.update(_k8(cs, torch, args))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
