"""Inter-pod (anti-)affinity template evaluation on the GPU.

Port of kubernetes_tpu/scheduler/kernels/affinity.py. For a whole batch
of constraint templates at once (the reference's topologyPairsMaps
lookups of predicates.go InterPodAffinityMatches),

    viol[u, n] = sel_dom[u]     · (1 - has_dom[:, n])   # aff terms need the
                                                        # topology key
               + sel_present[u] · (1 - present[:, n])   # non-waived affinity
                                                        # needs a match
               + sel_absent[u]  · present[:, n]         # anti-affinity
                                                        # forbids a match
    mask[u, n] = viol[u, n] == 0

with present taken as present ∧ has_dom: three [U, T] × [T, N] f32
products of 0/1 matrices. The topology index (scheduler/topology.py)
routes a batch here when U·T·N reaches DEVICE_EVAL_THRESHOLD; smaller
batches stay on host numpy.

The device programs:

    affinity_masks  -> K13 csrc/affinity_masks.cu   the terms packed into
                           32-bit words, mask = (OR of word ANDs) == 0
    affinity_scores -> K14 csrc/affinity_scores.cu  weights @ counts, the
                           preferred-term score accumulation (no caller in
                           the scheduler, as in the reference)

`affinity_masks_plain` / `affinity_scores_plain` are the plain PyTorch
versions in the JAX form. The numpy wrappers `affinity_masks` /
`affinity_scores` pad to the reference's power-of-two buckets (`_bucket`),
upload to `device` and return the unpadded numpy result; on the tensors,
dispatch is by device, as in kernels/batch.py: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel (a build or launch
failure raises). LAUNCHES counts the launches.

K13's contract: its bit form is exact for selectors in {0.0, -0.0, 1.0},
all that required_masks ever passes. A selector of any other value (0.5,
2.0, NaN) on the card raises ValueError, never a silent wrong mask and
never the plain version in its place; `affinity_masks_plain` keeps JAX's
f32 arithmetic for any selector values.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Tuple

import numpy as np
import torch

from .batch import _I, _P, _fn, _on_cuda, _ptr, _stream

#: kernel launches by name; each wrapper adds one per launch
LAUNCHES: Dict[str, int] = {"affinity_masks": 0, "affinity_scores": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _bucket(n: int, minimum: int = 8) -> int:
    return max(minimum, 1 << max(0, math.ceil(math.log2(max(1, n)))))


def _device(device) -> torch.device:
    """The device to upload to: CUDA unless the caller asks for another;
    raises when CUDA is asked for and absent (never the plain version in
    its place)."""
    from ..core import resolve_device   # core imports this package
    return resolve_device(device)


def _padded(arr: np.ndarray, shape, dtype: torch.dtype,
            device: torch.device) -> torch.Tensor:
    """`arr` in the leading corner of a zero tensor of `shape` on
    `device` (the reference pads on the host; the zeros are the same)."""
    out = torch.zeros(shape, dtype=dtype, device=device)
    src = torch.from_numpy(np.ascontiguousarray(arr))
    out[tuple(slice(0, s) for s in arr.shape)] = src.to(dtype)
    return out


# ------------------------------------------------------------ K13


def affinity_masks_plain(has_dom: torch.Tensor, present: torch.Tensor,
                         sel_dom: torch.Tensor, sel_present: torch.Tensor,
                         sel_absent: torch.Tensor) -> torch.Tensor:
    """[U, N] bool (affinity.py _affinity_masks_jit): has_dom, present
    bool [T, N]; the three selectors f32 [U, T]."""
    hd = has_dom.to(torch.float32)
    pr = (present & has_dom).to(torch.float32)
    viol = sel_dom @ (1.0 - hd) + sel_present @ (1.0 - pr) + sel_absent @ pr
    return viol == 0.0


@functools.lru_cache(maxsize=None)
def _scratch_words(U: int, T: int, N: int) -> Tuple[int, int, int]:
    """4-byte words of K13's scratch at (U, T, N): the selector words, the
    node words and the chunk flags (the C library's own tiling)."""
    from .build import check
    words = (ctypes.c_longlong * 3)()
    check(_fn("affinity_masks", "ktpu_affinity_masks_scratch",
              [_I] * 3 + [_P])(U, T, N, ctypes.cast(words, _P)),
          "affinity_masks_scratch")
    return tuple(int(w) for w in words)


def mask_scratch(U: int, T: int, N: int, device) -> Dict[str, torch.Tensor]:
    """K13's scratch on `device`: "sel_words" and "node_words" (the packed
    terms), "chunks" (a flag for each template tile and chunk of words
    with a selector bit set) and "err" (set by a selector outside
    {0, -0, 1}), all int32."""
    a, b, c = _scratch_words(U, T, N)
    return {name: torch.empty(n, dtype=torch.int32, device=device)
            for name, n in (("sel_words", a), ("node_words", b),
                            ("chunks", c), ("err", 1))}


def _affinity_masks_cuda(has_dom, present, sel_dom, sel_present,
                         sel_absent, scratch=None) -> torch.Tensor:
    """K13; `scratch` (mask_scratch's) is allocated here unless given, and
    holds the packed words and chunk flags of the call afterwards."""
    from .build import check
    T, N = has_dom.shape
    U = sel_dom.shape[0]
    out = torch.empty((U, N), dtype=torch.bool, device=has_dom.device)
    if scratch is None:
        scratch = mask_scratch(U, T, N, has_dom.device)
    elif any(scratch[k].numel() < n for k, n in
             zip(("sel_words", "node_words", "chunks", "err"),
                 (*_scratch_words(U, T, N), 1))):
        raise ValueError(f"affinity_masks: scratch too small for "
                         f"{(U, T, N)}")
    rc = _fn("affinity_masks", "ktpu_affinity_masks",
             [_P] * 6 + [_I] * 3 + [_P] * 5)(
        _ptr(has_dom, torch.bool, "has_dom"),
        _ptr(present, torch.bool, "present"),
        _ptr(sel_dom, torch.float32, "sel_dom"),
        _ptr(sel_present, torch.float32, "sel_present"),
        _ptr(sel_absent, torch.float32, "sel_absent"),
        _ptr(out, torch.bool, "out"), U, T, N,
        *(_ptr(scratch[k], torch.int32, k)
          for k in ("sel_words", "node_words", "chunks", "err")),
        _stream(has_dom))
    check(rc, "affinity_masks")
    LAUNCHES["affinity_masks"] += 1
    if int(scratch["err"].item()):
        raise ValueError("affinity_masks: a selector outside {0.0, -0.0, "
                         "1.0}; K13's bit form is exact only for 0/1 "
                         "selectors (the plain version takes any f32)")
    return out


def affinity_masks_tensors(has_dom: torch.Tensor, present: torch.Tensor,
                           sel_dom: torch.Tensor, sel_present: torch.Tensor,
                           sel_absent: torch.Tensor) -> torch.Tensor:
    """The [U, N] mask of tensors on one device: plain on the CPU,
    kernel K13 on CUDA."""
    T, N = has_dom.shape
    U = sel_dom.shape[0]
    if tuple(present.shape) != (T, N):
        raise ValueError(f"affinity_masks: present {tuple(present.shape)}, "
                         f"has_dom {(T, N)}")
    for name, s in (("sel_dom", sel_dom), ("sel_present", sel_present),
                    ("sel_absent", sel_absent)):
        if tuple(s.shape) != (U, T):
            raise ValueError(f"affinity_masks: {name} {tuple(s.shape)}, "
                             f"need {(U, T)}")
    if not _on_cuda(has_dom):
        return affinity_masks_plain(has_dom, present, sel_dom, sel_present,
                                    sel_absent)
    return _affinity_masks_cuda(has_dom, present, sel_dom, sel_present,
                                sel_absent)


def affinity_masks(has_dom: np.ndarray, present: np.ndarray,
                   sel_dom: np.ndarray, sel_present: np.ndarray,
                   sel_absent: np.ndarray, device=None) -> np.ndarray:
    """Bucket-padded wrapper; returns the unpadded [U, N] bool mask."""
    dev = _device(device)
    T, N = has_dom.shape
    U = sel_dom.shape[0]
    Tb, Ub = _bucket(T), _bucket(U)
    out = affinity_masks_tensors(
        _padded(has_dom, (Tb, N), torch.bool, dev),
        _padded(present, (Tb, N), torch.bool, dev),
        _padded(sel_dom, (Ub, Tb), torch.float32, dev),
        _padded(sel_present, (Ub, Tb), torch.float32, dev),
        _padded(sel_absent, (Ub, Tb), torch.float32, dev))
    return out[:U].cpu().numpy()


# ------------------------------------------------------------ K14


def affinity_scores_plain(weights: torch.Tensor,
                          counts: torch.Tensor) -> torch.Tensor:
    """[U, N] f32 (affinity.py _affinity_scores_jit): [U, T] preferred-term
    weights × [T, N] match/carry counts."""
    return weights @ counts


def _affinity_scores_cuda(weights, counts) -> torch.Tensor:
    from .build import check
    U, T = weights.shape
    N = counts.shape[1]
    out = torch.empty((U, N), dtype=torch.float32, device=weights.device)
    rc = _fn("affinity_scores", "ktpu_affinity_scores",
             [_P] * 3 + [_I] * 3 + [_P])(
        _ptr(weights, torch.float32, "weights"),
        _ptr(counts, torch.float32, "counts"),
        _ptr(out, torch.float32, "out"), U, T, N, _stream(weights))
    check(rc, "affinity_scores")
    LAUNCHES["affinity_scores"] += 1
    return out


def affinity_scores_tensors(weights: torch.Tensor,
                            counts: torch.Tensor) -> torch.Tensor:
    """The [U, N] scores of tensors on one device: plain on the CPU,
    kernel K14 on CUDA."""
    U, T = weights.shape
    if counts.dim() != 2 or counts.shape[0] != T:
        raise ValueError(f"affinity_scores: counts {tuple(counts.shape)}, "
                         f"need [{T}, N]")
    if not _on_cuda(weights):
        return affinity_scores_plain(weights, counts)
    return _affinity_scores_cuda(weights, counts)


def affinity_scores(weights: np.ndarray, counts: np.ndarray,
                    device=None) -> np.ndarray:
    """Bucket-padded [U, T] @ [T, N] preferred-affinity score
    accumulation; returns the unpadded [U, N] f32 scores."""
    dev = _device(device)
    U, T = weights.shape
    N = counts.shape[1]
    Tb, Ub = _bucket(T), _bucket(U)
    out = affinity_scores_tensors(
        _padded(weights, (Ub, Tb), torch.float32, dev),
        _padded(counts, (Tb, N), torch.float32, dev))
    return out[:U].cpu().numpy()
