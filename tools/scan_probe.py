#!/usr/bin/env python3
"""Where the serial scans K2, K7, K9, K15 and K12 spend their time, on one
GPU.

    python3 tools/scan_probe.py [--kernels k2,k7,k9,k15,k12] [--gang-pods N]

It builds the port's kernels, drains the first batch of the `uniform` and
`spread` paths (16,384 pods onto 5,000 nodes, as chip_smoke.py drives
them) and, with K9, BASELINE.json config 5's gang drain (chip_smoke.py's
`gang` path, --gang-pods pods, 50,000 by default), keeps each path's
first (largest) batch, and on those batches runs every design of

- K2 `class_scan` / `class_scan_spread` (the class batches);
- K7 `pod_scan` / `pod_scan_spread` (the same batches with their class
  tables dropped: chip_smoke.classic_batch);
- K9 `gang_scan_cap` (the gang batch);
- K15 `shard_scan` / `shard_scan_spread` (the class batches on
  chip_smoke.MESH_SHARDS shards);
- K12 `spec_scan` / `spec_scan_spread` (the class batches with spec_plain
  as tensorize marks it, cohorts of 16: chip_smoke.spec_plain_of), its
  `cluster` and `block` designs by the private `design=` argument of
  kernels/speculative.py _spec_scan_cuda, every 8th cohort stamped;

each as

- the profiling instance (csrc/prof.cuh: clock stamps of one thread at
  the phase boundaries of every 64th pod or entry, K12's every 8th
  cohort), giving each phase's
  mean SM cycles and share of a step (chip_smoke.step_profile);
- the plain instance, three launches on fresh copies, by CUDA events
  (the mean of the last two: the first pays the library load).

The old design is held bit for bit against the new one. It
prints each library's registers and spills, the card's name and power
limit and one JSON object. It needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: library names of each kernel's designs, for the ptxas lines
LIBS = {"k2": ("class_scan", "class_scan_shared"),
        "k7": ("pod_scan", "pod_scan_cluster"),
        "k9": ("gang_scan",),
        "k15": ("shard_scan", "shard_scan_shared"),
        "k12": ("spec_scan", "spec_scan_cluster")}
#: K12's profiling stride: every 8th cohort of 16 pods
SPEC_EVERY = 8


def probe(port, cs, make_of, designs, steps, kernel, label, card, out,
          every=None):
    """Both designs of one scan on one batch (chip_smoke.design_times):
    make_of(design, prof=None) prepares fresh inputs and returns a call that
    launches it and returns (packed, carry); the old design is held bit
    for bit against the new, each is timed and profiled."""
    packed, carry = make_of(designs[0])()
    ms_by, profile = cs.design_times(
        port, make_of, designs[0], designs, packed,
        port.kb._usage_out(carry), f"{kernel} on the {label} batch", steps,
        kernel, True, every=every)
    for design in designs:
        out[f"{kernel}:{label}:{design}"] = {"ms": ms_by[design],
                                             "profile": profile[design]}
        print(f"{kernel} {label} batch, {design}: {ms_by[design]} ms; per "
              f"step {profile[design]} {card}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels", default="k2,k7,k9,k15,k12",
                    help="comma-separated subset of k2, k7, k9, k15, k12")
    ap.add_argument("--gang-pods", type=int, default=50_000)
    args = ap.parse_args()
    kernels = [k for k in args.kernels.split(",") if k]
    if not kernels or set(kernels) - set(LIBS):
        sys.exit(f"scan_probe: --kernels takes {', '.join(LIBS)}")
    import torch
    if not torch.cuda.is_available():
        sys.exit("scan_probe: no CUDA device")
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from kubernetes_tpu_torch.scheduler.kernels import build
    card = cs.card_line()
    print(card)
    built = build.build_all(verbose=True)
    for k in kernels:
        for lib in LIBS[k]:
            for fn, d in cs.ptxas_info(built[lib]["log"]).items():
                print(f"ptxas {lib}: {fn}: {d}")
    port = cs.Port()
    kb, gk, sk = port.kb, port.gk, port.sk
    dev = torch.device("cuda")
    rec = cs.Recorder(port)
    with rec:
        for variant in ("uniform", "spread"):
            rec.variant = variant
            cs.run_drain(port, variant, dev, cs.N_NODES, cs.BATCH,
                         cs.BATCH, False)
        if "k9" in kernels:
            rec.variant = "gang"
            cs.run_gang_drain(port, dev, cs.GANG_NODES, args.gang_pods,
                              cs.GANG_SLICE_GANGS * args.gang_pods
                              // cs.GANG_PODS,
                              cs.GANG_PLAIN_GANGS * args.gang_pods
                              // cs.GANG_PODS, cs.BATCH)
    out = {}
    for path in ("uniform", "spread"):
        node_cfg, usage, pb, nom = rec.scan_inputs[path]
        cls = {k: pb[k] for k in kb._CLASS_KEYS}
        rw = pb["resource_weights"]
        P = pb["class_idx"].shape[0]
        cpb = cs.classic_batch(kb, pb)
        D = cs.MESH_SHARDS

        def k2(design, prof=None):
            # fresh table and carry; only the launch is timed
            _, _, ms0, carry, terms = kb._scan_setup(node_cfg, usage, pb,
                                                     nom)
            return lambda: (kb._class_scan_cuda(
                node_cfg, pb, cls, rw, ms0, carry, terms, nom, prof=prof,
                design=design), carry)

        def k7(design, prof=None):
            carry, terms = kb._carry_setup(usage, cpb)
            return lambda: (kb._pod_scan_cuda(
                node_cfg, cpb, carry, terms, nom, prof=prof,
                design=design), carry)

        def k15(design, prof=None):
            _, _, ms0, carry, terms = kb._scan_setup(node_cfg, usage, pb,
                                                     nom)
            return lambda: (kb._shard_scan_cuda(
                D, node_cfg, pb, cls, rw, ms0, carry, terms, nom,
                prof=prof, design=design), carry)
        spb = dict(pb, spec_plain=cs.spec_plain_of(pb))
        W = sk.cohort_width(P)

        def k12(design, prof=None):
            _, _, ms0, carry, terms = kb._scan_setup(node_cfg, usage, spb,
                                                     nom)
            return lambda: (sk._spec_scan_cuda(
                node_cfg, spb, cls, rw, ms0, carry, terms, nom, W,
                prof=prof, design=design)[0], carry)
        if "k12" in kernels:
            probe(port, cs, k12, kb.SPEC_SCAN_DESIGNS, P // W, "spec_scan",
                  path, card, out, SPEC_EVERY)
        for k, make_of, designs, kernel in (
                ("k2", k2, kb.CLASS_SCAN_DESIGNS, "class_scan"),
                ("k7", k7, kb.POD_SCAN_DESIGNS, "pod_scan"),
                ("k15", k15, kb.SHARD_SCAN_DESIGNS, "shard_scan")):
            if k in kernels:
                probe(port, cs, make_of, designs, P, kernel, path, card,
                      out)
    if "k9" in kernels:
        node_cfg, usage, pb, gt, nom, mates = rec.gang_inputs[
            ("gang", "gang_scan_cap")]

        def k9(design, prof=None):
            carry, _ = kb._carry_setup(usage, pb)
            return lambda: (gk._gang_scan_cuda(
                node_cfg, pb, gt, carry, nom, mates, prof=prof,
                design=design), carry)
        T = gt["pod_idx"].shape[0]
        probe(port, cs, k9, gk.GANG_SCAN_DESIGNS, T, "gang_scan", "gang",
              card, out)
        out["gang_scan:gang:entries"] = int((gt["pod_idx"] >= 0).sum())
    print(card)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
