#!/usr/bin/env python3
"""Times the dirty-row scatter of the port's node mirror on one GPU.

    python3 tools/dirty_probe.py [--root DIR] [--reps N]

At the main path's largest scatter (a mirror of capacity 8,192 rows and
8 resource columns, 5,000 dirty rows in the D = 8,192 bucket, the eight
cfg and usage tables: 83 bytes a row) it measures, on the package of the
tree at --root (default: this checkout, so a `git archive` of another
commit can be measured by the same script):

- K3 `apply_dirty` on rows already on the card, by CUDA events (the
  host's enqueue included) and by the profiler's device time, and the
  same rows scattered with `index_copy_` once a table (8 calls);
- `scatter_ms`: `TensorMirror.device_cfg_usage` with those rows dirty,
  from the host arrays to the tables on the card (host clock to a
  synchronize);
- `library_scatter_ms`: the same rows uploaded one tensor a table and
  scattered with `index_copy_` x8 (host clock to a synchronize).

K3 is held against `apply_dirty_plain` on the card first. It prints the
card's name and power limit and one JSON object. It needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAPACITY, LIVE, SEED = 8192, 5000, 15


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("dirty_probe: no CUDA device")
    sys.path.insert(0, HERE)
    import chip_smoke as cs   # timing helpers; this checkout's
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import kubernetes_tpu_torch
    if not kubernetes_tpu_torch.__file__.startswith(root):
        sys.exit(f"dirty_probe: imported {kubernetes_tpu_torch.__file__},"
                 f" not the package under {root}")
    from kubernetes_tpu_torch.scheduler.kernels import batch as kb
    from kubernetes_tpu_torch.scheduler.kernels import build
    from kubernetes_tpu_torch.scheduler.tensorize import TensorMirror
    card = cs.card_line()
    print(card)
    build.build_all()
    dev = torch.device("cuda")

    mirror = TensorMirror(min_capacity=CAPACITY, device=dev)
    rng = np.random.default_rng(SEED)
    for k, a in mirror.t.arrays().items():
        a[...] = (rng.random(a.shape) < 0.5) if a.dtype == bool else \
            rng.integers(0, 1 << 20, a.shape).astype(a.dtype)
    host = {k: a.copy() for k, a in mirror.t.arrays().items()}
    cfg0, use0 = mirror.device_cfg_usage()   # the full upload
    rows = rng.choice(CAPACITY, LIVE, replace=False).astype(np.int32)
    D = 1 << (LIVE - 1).bit_length()
    idx = np.full(D, CAPACITY, np.int32)
    idx[:LIVE] = rows

    def padded(a):
        out = np.zeros((D,) + a.shape[1:], a.dtype)
        out[:LIVE] = a[rows]
        return torch.from_numpy(out).to(dev)
    cfg_rows = {k: padded(host[k]) for k in cfg0}
    use_rows = {k: padded(host[k]) for k in use0}
    t = cs.dirty_times(torch, kb, cfg0, use0, torch.from_numpy(idx).to(dev),
                       cfg_rows, use_rows, args.reps)
    out = {"k3_ms": t["ms"], "k3_device_ms": t["device_ms"],
           "index_copy_ms": t["library_ms"],
           "index_copy_device_ms": t["library_device_ms"]}
    out.update(cs.scatter_times(torch, TensorMirror, host, rows, dev,
                                reps=args.reps // 4))
    out.update(capacity=CAPACITY, rows=LIVE, D=D,
               row_bytes=sum(a.itemsize * (a.size // a.shape[0])
                             for a in host.values()),
               root=root, card=card, reps=args.reps)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
