#!/usr/bin/env python3
"""Where the serial scans K2 and K9 spend their time, on one GPU.

    python3 tools/scan_probe.py [--gang-pods N]

It builds the port's kernels, drains the first batch of the `uniform` and
`spread` paths (16,384 pods onto 5,000 nodes, as chip_smoke.py drives
them) and BASELINE.json config 5's gang drain (chip_smoke.py's `gang`
path, --gang-pods pods, 50,000 by default), keeps each path's first
(largest) batch, and on those batches runs every design of K2
`class_scan` / `class_scan_spread` and K9 `gang_scan_cap`:

- the profiling instance (csrc/prof.cuh: clock stamps of thread 0 at
  the phase boundaries of every 64th pod or entry), giving each phase's
  mean SM cycles and share of a step (chip_smoke.step_profile);
- the plain instance, three launches on fresh copies, by CUDA events.

Every launch is held bit for bit against the first design's result. It
prints the card's name and power limit and one JSON object. It needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--gang-pods", type=int, default=50_000)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("scan_probe: no CUDA device")
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from kubernetes_tpu_torch.scheduler.kernels import build
    card = cs.card_line()
    print(card)
    built = build.build_all(verbose=True)
    for lib in ("class_scan", "gang_scan"):
        for fn, d in cs.ptxas_info(built[lib]["log"]).items():
            print(f"ptxas {lib}: {fn}: {d}")
    port = cs.Port()
    kb, gk = port.kb, port.gk
    dev = torch.device("cuda")
    rec = cs.Recorder(port)
    with rec:
        for variant in ("uniform", "spread"):
            rec.variant = variant
            cs.run_drain(port, variant, dev, cs.N_NODES, cs.BATCH,
                         cs.BATCH, False)
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
        ref = None
        for design in kb.CLASS_SCAN_DESIGNS:
            def make(prof=None, design=design):
                # fresh table and carry; only the launch is timed
                _, _, ms0, carry, terms = kb._scan_setup(node_cfg, usage,
                                                         pb, nom)
                return lambda: (kb._class_scan_cuda(
                    node_cfg, pb, cls, rw, ms0, carry, terms, nom,
                    prof=prof, design=design), carry)
            packed, carry = make()()
            if ref is None:
                ref = (packed, carry)
            elif not torch.equal(packed, ref[0]) or not all(
                    cs.bits_equal(torch, carry[k], ref[1][k]) for k in carry):
                sys.exit(f"scan_probe: K2 {design} differs on {path}")
            runs = [cs.time_cuda(torch, make(), reps=1, warm=0)
                    for _ in range(3)]
            prof = cs.step_profile(torch, make, P, f"class_scan:{design}")
            out[f"{path}:{design}"] = {"ms": runs, "profile": prof}
            print(f"K2 {path} batch, {design}: {runs} ms; per step "
                  f"{prof} {card}")
    node_cfg, usage, pb, gt, nom, mates = rec.gang_inputs[("gang",
                                                          "gang_scan_cap")]
    T = gt["pod_idx"].shape[0]
    ref = None
    for design in gk.GANG_SCAN_DESIGNS:
        def make(prof=None, design=design):
            carry, _ = kb._carry_setup(usage, pb)
            return lambda: (gk._gang_scan_cuda(
                node_cfg, pb, gt, carry, nom, mates, prof=prof,
                design=design), carry)
        packed, carry = make()()
        if ref is None:
            ref = (packed, carry)
        elif not torch.equal(packed, ref[0]) or not all(
                cs.bits_equal(torch, carry[k], ref[1][k]) for k in carry):
            sys.exit(f"scan_probe: K9 {design} differs on the gang batch")
        runs = [cs.time_cuda(torch, make(), reps=1, warm=0)
                for _ in range(3)]
        prof = cs.step_profile(torch, make, T, f"gang_scan:{design}")
        out[f"gang:{design}"] = {"ms": runs, "profile": prof,
                                 "entries": int((gt["pod_idx"] >= 0).sum())}
        print(f"K9 gang batch ({T} entries), {design}: {runs} ms; per step "
              f"{prof} {card}")
    print(card)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
