"""Carry scheduler state across from numpy into the port's tensors.

The JAX package holds its state as numpy arrays before upload: the mirror's
TensorMirror.t.cfg_arrays() / usage_arrays() and a PodBatchTensors batch's
fields (its device() dict under the same keys, with the class tables for
the class route or without them for the classic per-pod route, the gang
scan and filter_score), the gang entry stream of core._gang_device_table,
the victim-pricing tables of kernels/preempt.py (VictimTables.arrays and
the whole-gang DomainTables.arrays) and the nominated reservations
({used, count}). tables_from_numpy, gang_table_from_numpy,
victim_tables_from_numpy, domain_tables_from_numpy and nom_from_numpy
turn such dicts into torch tensors on one device with the same keys,
shapes, dtypes (float32 / int32 / bool) and padding, so the two packages
can be fed identical state. It is the port's stand-in for loading
weights.
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
    # ascontiguousarray would turn a 0-d array into shape (1,)
    return torch.tensor(np.ascontiguousarray(a) if a.ndim else a,
                        dtype=_DTYPES[a.dtype], device=device)


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


def victim_tables_from_numpy(arrays: dict, device="cpu"
                             ) -> Dict[str, torch.Tensor]:
    """VictimTables.arrays (free0, cfree0, need, need_cnt, freed, fcnt,
    valid, pdb, top, psum, gcnt, startr, row_valid) -> the same dict of
    tensors on `device`; need_cnt becomes a 0-d float32 tensor."""
    return _convert(arrays, torch.device(device))


def gang_table_from_numpy(gang_tab: dict, device="cpu"
                          ) -> Dict[str, torch.Tensor]:
    """The gang entry stream (pod_idx, start, end, gang_id, entry_dom_idx,
    pin_dom, dom_tab, and the capacity gate's need / greq when present)
    -> the same dict of tensors on `device`."""
    return _convert(gang_tab, torch.device(device))


def domain_tables_from_numpy(arrays: dict, device="cpu"
                             ) -> Dict[str, torch.Tensor]:
    """DomainTables.arrays (base, need, dslots, valid, pdb, top, psum,
    gcnt, startr, row_valid) -> the same dict of tensors on `device`;
    need becomes a 0-d float32 tensor."""
    return _convert(arrays, torch.device(device))


def nom_from_numpy(nom: Optional[dict], device="cpu"
                   ) -> Optional[Dict[str, torch.Tensor]]:
    """The nominated reservations {used [N, R], count [N]} (None when
    nothing is nominated) -> tensors on `device`."""
    return _convert(nom, torch.device(device))
