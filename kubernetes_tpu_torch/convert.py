"""Carry scheduler state across from numpy into the port's tensors.

The JAX package holds its state as numpy arrays before upload: the mirror's
TensorMirror.t.cfg_arrays() / usage_arrays() and a PodBatchTensors batch's
fields (its device() dict under the same keys). tables_from_numpy turns
such dicts into torch tensors on one device with the same keys, shapes,
dtypes (float32 / int32 / bool) and padding, so the two packages can be
fed identical state. It is the port's stand-in for loading weights.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

_DTYPES = {np.dtype(np.float32): torch.float32,
           np.dtype(np.int32): torch.int32,
           np.dtype(np.bool_): torch.bool}


def to_tensor(arr, device) -> torch.Tensor:
    """One numpy array (or scalar) -> a tensor of the same dtype on
    `device`. Only float32, int32 and bool are state dtypes; anything
    else is refused rather than silently widened or narrowed."""
    a = np.asarray(arr)
    if a.dtype not in _DTYPES:
        raise TypeError(f"state arrays are float32, int32 or bool; "
                        f"got {a.dtype}")
    return torch.tensor(np.ascontiguousarray(a), dtype=_DTYPES[a.dtype],
                        device=device)


def _convert(d: Optional[dict], device) -> Optional[Dict[str, torch.Tensor]]:
    if d is None:
        return None
    return {k: to_tensor(v, device) for k, v in d.items()}


def tables_from_numpy(node_cfg: dict, usage: dict,
                      pod_batch: Optional[dict] = None, device="cpu"
                      ) -> Tuple[dict, dict, Optional[dict]]:
    """(node_cfg, usage, pod_batch) numpy dicts -> the same dicts of
    torch tensors on `device`."""
    device = torch.device(device)
    return (_convert(node_cfg, device), _convert(usage, device),
            _convert(pod_batch, device))
