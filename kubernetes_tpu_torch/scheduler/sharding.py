"""Mesh plumbing for the sharded drain path, on one card.

Port of kubernetes_tpu/scheduler/sharding.py. The reference shards the
node axis over a 1-D "nodes" mesh of devices; its sharded class scan
(kernels/batch.py schedule_batch_sharded) decides per shard and elects
across shards, and its decisions depend only on the shard count and the
padded capacity, never on what executes a shard. The port keeps that
contract on one H100: a shard is one CTA of a thread-block cluster (kernel
K15, csrc/shard_scan.cu), the cross-shard reductions are exchanges
through distributed shared memory, and every tensor lives on the one
card. A mesh over several cards is later work (ROADMAP).

ShardMesh stands in for jax.sharding.Mesh: one "nodes" axis of D shards
and the card (torch device) they run on. A tensor is placed by a plain
transfer to the mesh's device, because every shard lives on one card;
K15 splits the node axis itself. The reference's name-keyed partition
rules, kept here as the record of which tensors K15 splits:

    node-leading  (N, ...)   alloc used nz_used nonzero_used pod_count
                             max_pods node_ok mem_pressure valid count
                             spread_zone
    node-trailing (..., N)   unique_masks unique_scores spread_base spread
                             soft_base anti_dom soft_dom dom_tab
    replicated               every other name: the pod axis, the DRF
                             tenant tensors, scalars

Mesh resolution follows the reference: the Scheduler's `mesh` argument (a
ShardMesh, "auto", a shard count) or, when it is None, KTPU_MESH
(""/"0"/"none" or unset: no mesh). "auto" gives 8 shards, the reference's
"auto" under the 8 virtual devices of its tier-1 and a portable
thread-block cluster; more than 8 shards is refused (MAX_SHARDS, K15's
cluster limit in kernels/batch.py), as the reference refuses more shards
than devices.

Kernel selection: with a mesh, class-table batches take the sharded scan
(K15) unless KTPU_SHARD_MAP=0; then they take the unsharded class scan
(K2) over the padded mirror, the port's counterpart of the reference's GSPMD path, which
computes the unsharded function.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from .kernels.batch import MAX_SHARDS

#: mesh axis the node dimension shards over
NODE_AXIS = "nodes"


class ShardMesh:
    """A 1-D "nodes" mesh of `shards` shards on one card (`device`)."""

    axis_names: Tuple[str, ...] = (NODE_AXIS,)

    def __init__(self, shards: int, device):
        if not 2 <= int(shards) <= MAX_SHARDS:
            raise ValueError(f"a mesh takes 2 to {MAX_SHARDS} shards, got "
                             f"{shards}")
        self.shards = int(shards)
        self.device = torch.device(device)

    @property
    def shape(self) -> dict:
        return {NODE_AXIS: self.shards}

    def __repr__(self) -> str:
        return f"ShardMesh({self.shards}, {self.device})"


def n_shards(mesh) -> int:
    """Shard count on the node axis (1 when unsharded)."""
    return 1 if mesh is None else int(mesh.shape[NODE_AXIS])


def shard_divisible(n: int, shards: int) -> int:
    """Smallest multiple of `shards` >= n (the mirror's capacity pad)."""
    if shards <= 1:
        return n
    return n + (-n) % shards


def resolve_mesh(mesh=None, device=None) -> Optional[ShardMesh]:
    """Normalize the scheduler's `mesh` argument to a ShardMesh or None.

    A ShardMesh passes through (its device must be the scheduler's). An
    int n takes n shards: n <= 1 means EXPLICITLY no mesh, immune to the
    env (the parity baselines' escape hatch); n > MAX_SHARDS raises.
    "auto" takes MAX_SHARDS. None consults KTPU_MESH (the same forms;
    ""/"0"/"none"/unset means no mesh). The mesh runs on `device` (CUDA
    unless the caller asks for another; no CUDA device raises)."""
    from .core import resolve_device
    source = "mesh argument"
    if mesh is None:
        mesh = os.environ.get("KTPU_MESH", "")
        source = "KTPU_MESH"
        if mesh in ("", "0", "none"):
            return None
    if isinstance(mesh, ShardMesh):
        if device is not None and \
                resolve_device(device) != mesh.device:
            raise ValueError(f"{source} {mesh} is not on the scheduler's "
                             f"device {resolve_device(device)}")
        return mesh
    if isinstance(mesh, str) and mesh != "auto":
        mesh = int(mesh)
    if mesh == "auto":
        mesh = MAX_SHARDS
    if not isinstance(mesh, int):
        raise ValueError(f"{source} {mesh!r}: a ShardMesh, \"auto\" or a "
                         "shard count")
    if mesh <= 1:
        return None
    if mesh > MAX_SHARDS:
        raise ValueError(
            f"{source} wants {mesh} shards, at most {MAX_SHARDS} (one "
            "thread-block cluster) — refusing a silently degenerate mesh")
    return ShardMesh(mesh, resolve_device(device))


def shard_map_enabled() -> bool:
    """False pins mesh batches to the unsharded class scan over the
    padded mirror — the selection knob the sharded tests use as their
    control."""
    return os.environ.get("KTPU_SHARD_MAP", "1") != "0"


def use_shard_map(mesh, capacity: int) -> bool:
    """True when the class-indexed scan should take the sharded kernel: a
    node mesh is active and the kernel knob is on. The mirror pads its
    capacity to a multiple of the shard count, so a capacity that does not
    divide is a fault and raises."""
    shards = n_shards(mesh)
    if shards > 1 and capacity % shards:
        raise ValueError(f"capacity {capacity} is not a multiple of the "
                         f"mesh's {shards} shards")
    return shards > 1 and shard_map_enabled()
