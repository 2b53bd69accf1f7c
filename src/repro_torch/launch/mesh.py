"""Production mesh construction (counterpart of
:mod:`repro.launch.mesh`).

The single-cluster production mesh is 16 x 16 = 256 H100 cards, 8 to a
node, as ``("data", "model")``; the two-cluster mesh adds a leading
``pod`` axis: 2 x 16 x 16 = 512 cards.  Rank ``r`` sits at row-major
position ``r`` of the mesh, so a ``model`` group of 16 spans two nodes
and each node holds 8 consecutive ranks.

The dry run builds these meshes over a process group of the ``"fake"``
backend (:func:`start_fake_group`): one process plays rank 0 of 256 or
512, every collective returns at once and no byte moves.  A fake group
is the process's default group, so it never sits beside a real one: the
dry run and every test that needs one run in a process of their own.
Importing this module starts no group.
"""

from __future__ import annotations

import torch.distributed as dist

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def start_fake_group(world_size: int) -> None:
    """Make a ``"fake"`` process group of ``world_size`` ranks, this
    process rank 0, the default group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already up; a fake group "
                           "needs a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def is_fake_group() -> bool:
    return dist.is_initialized() and dist.get_backend() == "fake"


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The 16 x 16 (or 2 x 16 x 16) ``DeviceMesh`` over the fake group of
    that size, which must be up (:func:`start_fake_group`)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = PRODUCTION_SHAPES[multi_pod]
    size = 1
    for n in shape:
        size *= n
    if not is_fake_group() or dist.get_world_size() != size:
        raise RuntimeError(
            f"the production mesh {shape} needs a fake process group of "
            f"{size} ranks (start_fake_group({size})) in a process of its "
            f"own")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(shape=None, axes=("data", "model"), *,
                   device_type: str = "cuda"):
    """A ``DeviceMesh`` over the ranks of the default process group (real
    or fake), ``(world_size, 1)`` by default, on the card unless the
    caller names another device type."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialized process "
                           "group")
    n = dist.get_world_size()
    if shape is None:
        shape = (n, 1)
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))
