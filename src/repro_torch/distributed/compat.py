"""The device mesh of the distributed drivers (counterpart of
:func:`repro.distributed.compat.make_mesh`).

A :class:`Mesh` is a process group seen as a named 1-D or 2-D grid of
ranks: one process per rank, each holding one device.  The drivers
flatten every axis (rank order is row-major over ``axis_names``), as
``shard_map`` with ``P(axes)`` does.  A one-rank mesh needs no process
group: its collectives are the identity, as on the reference's
one-device mesh.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from repro_torch.core.engine import resolve_device


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A process group as a named grid of ranks.

    ``group`` is the ``torch.distributed`` process group (``None`` for a
    one-rank mesh without one), ``rank`` this process's rank in it,
    ``axis_shape`` / ``axis_names`` the grid (their product is the group's
    size) and ``device`` this rank's device."""

    group: object
    rank: int
    axis_shape: tuple
    axis_names: tuple
    device: torch.device

    @property
    def size(self) -> int:
        return math.prod(self.axis_shape)

    @property
    def backend(self):
        """The group's backend (``"gloo"``, ``"nccl"``) or ``None``."""
        return None if self.group is None else dist.get_backend(self.group)

    def __repr__(self):
        return (f"Mesh({dict(zip(self.axis_names, self.axis_shape))}, "
                f"rank={self.rank}, "
                f"backend={self.backend!r}, device={str(self.device)!r})")


def make_mesh(axis_shape, axis_names, *, group=None, device=None) -> Mesh:
    """A :class:`Mesh` of ``axis_shape`` named ``axis_names``.

    ``group`` defaults to the default process group when one is
    initialized and its size is the mesh's; a one-rank mesh without a
    group needs none (collectives are the identity).  ``device`` defaults
    to this rank's CUDA device, and without one raises."""
    axis_shape = tuple(int(n) for n in axis_shape)
    axis_names = tuple(axis_names)
    if len(axis_shape) != len(axis_names) or not 1 <= len(axis_shape) <= 2:
        raise ValueError(f"a mesh has one or two named axes; got shape "
                         f"{axis_shape} and names {axis_names}")
    size = math.prod(axis_shape)
    if size < 1:
        raise ValueError(f"mesh shape {axis_shape} has no ranks")
    if group is None and dist.is_initialized() \
            and dist.get_world_size() == size:
        group = dist.group.WORLD
    if group is None:
        if size != 1:
            raise ValueError(
                f"a mesh of {size} ranks needs a process group of that "
                "size: initialize torch.distributed or pass group=")
        rank = 0
        global_rank = dist.get_rank() if dist.is_initialized() else 0
    else:
        if dist.get_world_size(group) != size:
            raise ValueError(f"mesh shape {axis_shape} has {size} ranks, "
                             f"the group {dist.get_world_size(group)}")
        rank, global_rank = dist.get_rank(group), dist.get_rank()
    if device is None:
        # this rank's card (ranks spread over the visible cards); raises
        # without CUDA: the port never falls back to the CPU quietly
        resolve_device(None)
        dev = torch.device("cuda", global_rank % torch.cuda.device_count())
    else:
        dev = torch.device(device)
    return Mesh(group=group, rank=rank, axis_shape=axis_shape,
                axis_names=axis_names, device=dev)
