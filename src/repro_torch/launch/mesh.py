"""Logical meshes and replica device groups (port of ``repro.launch.mesh``).

:class:`Mesh` is the counterpart of the ``jax.sharding.Mesh`` the reference
hands to ``models.moe.set_moe_distribution``: named axes and their sizes
(``("data", "model")`` or ``("pod", "data", "model")``), no devices.  The
port's sharded MoE dispatch runs the shards in turn in process (or one a
rank under ``parallel.collective.ProcessGroupGate``), so the mesh only says
how the batch and the experts split.  :func:`make_host_mesh` is the
reference's 1 x 1 mesh; its ``make_production_mesh`` builds TPU pod meshes
(16 x 16, 2 x 16 x 16) and has no counterpart.  Any object with
``axis_names`` and a ``shape`` mapping (a ``jax.sharding.Mesh`` too) serves
where a mesh is asked for.

``replica_devices`` / ``replica_submeshes`` carve the visible devices
(``torch.cuda`` devices, or ``torch.device("cpu")`` when the caller asks
for the CPU) into one group per engine replica.
"""
from __future__ import annotations

import dataclasses
import warnings

import torch

from repro_torch.kernels._util import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named mesh axes and their sizes (row-major, as ``jax.make_mesh``)."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes) or len(set(self.axis_names)) != len(
                self.axis_names):
            raise ValueError(f"mesh axes {self.axis_names} and sizes {self.sizes} do not pair up")
        if any(int(n) < 1 for n in self.sizes):
            raise ValueError(f"mesh sizes must be positive, got {self.sizes}")

    @property
    def shape(self) -> dict[str, int]:
        """``{axis: size}`` in axis order (``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.sizes))


def make_mesh(shape: tuple[int, ...], axis_names: tuple[str, ...]) -> Mesh:
    """A mesh of ``shape`` over ``axis_names`` (``jax.make_mesh``'s order)."""
    return Mesh(tuple(axis_names), tuple(int(n) for n in shape))


def make_host_mesh() -> Mesh:
    """The trivial 1 x 1 ("data", "model") mesh (tests / examples)."""
    return make_mesh((1, 1), ("data", "model"))


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
