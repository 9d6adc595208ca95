"""The DRF drain-ordering kernels on the GPU: dominant shares (K4) and
the batch permutation (K5).

Port of kubernetes_tpu/tenancy/drf.py's two device programs. Each has a
plain PyTorch version that gives the same bits as the JAX function, and a
hand-written CUDA kernel (csrc/):

    drf_dominant -> K4  csrc/drf_dominant.cu   [T, R] usage -> [T] shares
    drf_order    -> K5  csrc/drf_order.cu      lexsort permutation, by
                        sorted runs and merged ranks (no sort library)

Dispatch is by tensor device, as in scheduler/kernels/batch.py: a CPU
tensor takes the plain version, a CUDA tensor launches the kernel (a
build or launch failure raises). LAUNCHES counts kernel launches, one per
launch.
"""

from __future__ import annotations

import functools
from typing import Dict

import torch

from ..scheduler.kernels.batch import _I, _P, _fn, _on_cuda, _ptr, _stream

#: kernel launches by name; each wrapper adds one per launch. drf_order
#: counts its C calls: each enqueues the run sort and, past one run of
#: pods, the merge of the runs
LAUNCHES: Dict[str, int] = {"drf_dominant": 0, "drf_order": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ------------------------------------------------------------ K4


def drf_dominant_plain(usage: torch.Tensor, cap: torch.Tensor) -> torch.Tensor:
    """_dominant_kernel: f32 divide by the capacity floored at 1, then the
    max over resources."""
    return (usage / torch.clamp_min(cap, 1.0)).amax(1)


def drf_dominant(usage: torch.Tensor, cap: torch.Tensor) -> torch.Tensor:
    """[T, R] f32 tenant usage + [R] f32 capacity -> [T] f32 dominant
    shares: plain on the CPU, kernel K4 on CUDA."""
    if usage.dim() != 2 or tuple(cap.shape) != (usage.shape[1],):
        raise ValueError(f"drf_dominant: usage {tuple(usage.shape)} and "
                         f"capacity {tuple(cap.shape)} do not agree")
    if not _on_cuda(usage):
        return drf_dominant_plain(usage, cap)
    from ..scheduler.kernels.build import check
    T, R = usage.shape
    shares = torch.empty((T,), dtype=torch.float32, device=usage.device)
    # pointers first: a wrong tensor raises before any library loads
    args = (_ptr(usage, torch.float32, "usage"),
            _ptr(cap, torch.float32, "cap"),
            _ptr(shares, torch.float32, "shares"), T, R, _stream(usage))
    rc = _fn("drf_dominant", "ktpu_drf_dominant",
             [_P] * 3 + [_I] * 2 + [_P])(*args)
    check(rc, "drf_dominant")
    LAUNCHES["drf_dominant"] += 1
    return shares


# ------------------------------------------------------------ K5


def neg_wrap(prio: torch.Tensor) -> torch.Tensor:
    """-prio in int32 with two's-complement wraparound (INT32_MIN maps to
    itself), as jnp and numpy negate int32."""
    return (-prio.to(torch.int64)).to(torch.int32)


def drf_order_plain(prio: torch.Tensor, shares: torch.Tensor,
                    tidx: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """_order_kernel, jnp.lexsort((pos, shares[tidx], -prio)), as stable
    sorts from the last key to the first. Every NaN share becomes the one
    positive NaN first: lexsort puts all NaNs last as equals, while the
    card's stable sort (a radix sort on the bits) would put a NaN with
    the sign bit set first."""
    perm = torch.sort(pos, stable=True).indices
    share = shares[tidx.long()]
    share = torch.where(torch.isnan(share), float("nan"), share)
    perm = perm[torch.sort(share[perm], stable=True).indices]
    perm = perm[torch.sort(neg_wrap(prio)[perm], stable=True).indices]
    return perm.to(torch.int32)


@functools.lru_cache(maxsize=None)
def order_run() -> int:
    """K5's pods a sorted run, as csrc/drf_order.cu defines it (its
    library is built on first use)."""
    return int(_fn("drf_order", "ktpu_drf_order_run", [])())


def drf_order(prio: torch.Tensor, shares: torch.Tensor, tidx: torch.Tensor,
              pos: torch.Tensor) -> torch.Tensor:
    """[P] int32 priorities, [T] f32 dominant shares, [P] int32 tenant
    indices into them and [P] int32 pop positions -> the [P] int32
    permutation by priority desc, share asc, position asc (ties by index,
    as a stable lexsort): plain on the CPU, kernel K5 on CUDA. Tenant
    indices must lie in [0, T); DRFAccount checks them on the host before
    they are shipped."""
    P = prio.shape[0]
    for name, t in (("tidx", tidx), ("pos", pos)):
        if tuple(t.shape) != (P,):
            raise ValueError(f"drf_order: {name} has shape "
                             f"{tuple(t.shape)}, prio ({P},)")
    if shares.dim() != 1:
        raise ValueError(f"drf_order: shares has shape {tuple(shares.shape)}")
    if not _on_cuda(prio):
        return drf_order_plain(prio, shares, tidx, pos)
    from ..scheduler.kernels.build import check
    ins = (_ptr(prio, torch.int32, "prio"),
           _ptr(shares, torch.float32, "shares"),
           _ptr(tidx, torch.int32, "tidx"), _ptr(pos, torch.int32, "pos"))
    perm = torch.empty((P,), dtype=torch.int32, device=prio.device)
    # the keys in sorted runs (16 bytes a slot), alive until the launches
    # are enqueued
    run = order_run()
    slots = -(-P // run) * run if P > run else 0
    runs = (torch.empty((slots, 4), dtype=torch.int32, device=prio.device)
            if slots else None)
    rc = _fn("drf_order", "ktpu_drf_order", [_P] * 6 + [_I] * 3 + [_P])(
        *ins, _ptr(perm, torch.int32, "perm"),
        _ptr(runs, torch.int32, "runs") if slots else None, slots, P,
        shares.shape[0], _stream(prio))
    check(rc, "drf_order")
    LAUNCHES["drf_order"] += 1
    return perm
