"""Replica device groups (port of the replica half of ``repro.launch.mesh``).

``replica_devices`` / ``replica_submeshes`` carve the visible devices
(``torch.cuda`` devices, or ``torch.device("cpu")`` when the caller asks
for the CPU) into one group per engine replica.  The reference's
``make_production_mesh`` / ``make_host_mesh`` build TPU pod meshes and have
no counterpart here.
"""
from __future__ import annotations

import warnings

import torch

from repro_torch.kernels._util import resolve_device


def _devices(device) -> list[torch.device]:
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def replica_devices(n: int, *, device=None) -> list[torch.device]:
    """One device per data-parallel engine replica; with more replicas than
    devices the assignment wraps (replicas share a device).  ``device``:
    None (the cards) or ``"cpu"``."""
    if n < 1:
        raise ValueError(f"need at least one replica, got {n}")
    return [g[0] for g in replica_submeshes(n, 1, device=device)]


def replica_submeshes(n_replicas: int, shards_per_replica: int = 1, *,
                      device=None) -> list[list[torch.device]]:
    """Carve the device list into per-replica "model"-axis groups.

    Replica ``i`` owns the ``shards_per_replica`` contiguous devices
    starting at ``i * shards_per_replica``.  Rules (the reference's):

    * ``shards_per_replica == 1`` — with more replicas than devices the
      assignment wraps silently (replicas share a device);
    * ``shards_per_replica > 1`` and one device — every replica gets that
      device repeated (emulation: ``parallel.collective.ShardLoop`` runs
      the shards in turn on it), with a warning;
    * ``shards_per_replica > 1`` on several devices — a group that would
      wrap non-contiguously around the end of the device list is rejected.
    """
    if n_replicas < 1:
        raise ValueError(f"need at least one replica, got {n_replicas}")
    if shards_per_replica < 1:
        raise ValueError(f"need at least one shard per replica, got {shards_per_replica}")
    devs = _devices(device)
    d = len(devs)
    if shards_per_replica == 1:
        return [[devs[i % d]] for i in range(n_replicas)]
    if d == 1:
        warnings.warn(
            f"{shards_per_replica}-way tensor parallelism on a single device: "
            "shards will be emulated in turn, not distributed",
            stacklevel=2,
        )
        return [[devs[0]] * shards_per_replica for _ in range(n_replicas)]
    groups = []
    for i in range(n_replicas):
        start = (i * shards_per_replica) % d
        if start + shards_per_replica > d:
            raise ValueError(
                f"replica {i}'s {shards_per_replica}-device submesh would wrap "
                f"non-contiguously around the {d}-device mesh (start {start}); "
                f"the model axis must stay contiguous — use "
                f"n_replicas * shards_per_replica <= {d} (or a multiple)"
            )
        groups.append(list(devs[start: start + shards_per_replica]))
    return groups
