"""Elastic scaling: mesh bring-up policy and checkpoint restore
(counterpart of :mod:`repro.launch.elastic`).

One module owns "how many ranks, in what shape" for both altitudes:

* **Serving** (:func:`serving_mesh`): ``EvalSession(backend=
  "graph_sharded")`` (axis ``"graph"``) and ``Evaluator`` on
  ``backend="distributed"`` (axis ``"eval"``) both bring their mesh up
  through it.
* **Training and recovery** (:func:`make_elastic_mesh` /
  :func:`elastic_restore`): checkpoints store logical (unsharded)
  arrays (:mod:`repro_torch.checkpoint.manager`); on restart the mesh is
  rebuilt from the live world size (:func:`choose_mesh_shape`), so
  fewer or more ranks just give another mesh shape, and the restored
  tree lands on the device ``sharding_fn`` names on the new mesh.
"""

from __future__ import annotations

import torch.distributed as dist

from repro_torch.distributed.compat import make_mesh


def choose_mesh_shape(n_devices: int, *, max_model: int = 16,
                      axes: int = 2):
    """Mesh shape for the available device count.

    ``axes=2`` (the default): ``(data, model)`` with the largest power of
    two ``<= max_model`` dividing ``n_devices`` as the model axis.
    ``axes=1``: ``(shards,)`` with the largest power of two ``<=
    n_devices`` (the serving layout: pow2 so the session's pow2 buckets
    divide evenly; leftover devices idle rather than forcing a ragged
    partition)."""
    n_devices = max(int(n_devices), 1)
    if axes == 1:
        shards = 1
        while shards * 2 <= n_devices:
            shards *= 2
        return (shards,)
    if axes != 2:
        raise ValueError(f"axes must be 1 or 2, got {axes}")
    model = 1
    while model * 2 <= max_model and n_devices % (model * 2) == 0:
        model *= 2
    return (n_devices // model, model)


def serving_mesh(axis: str = "eval", *, shards=None, device=None):
    """The serving-side default mesh: 1-D over the ranks of the default
    process group (one rank without one), capped by ``shards`` (the
    ``EvalConfig.shards`` knob) and trimmed to a power of two by
    :func:`choose_mesh_shape`.

    Every rank of the default group must call it (it creates the process
    groups).  When the mesh is smaller than the world, the ranks form
    consecutive meshes of that size, one per block of ranks, and a rank
    left over past the last whole block serves alone on a one-rank mesh.
    ``device`` is this rank's device (its CUDA device by default)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = world if shards is None else min(world, int(shards))
    (n,) = choose_mesh_shape(n, axes=1)
    group = None
    if 1 < n < world:
        rank = dist.get_rank()
        for start in range(0, world - n + 1, n):
            block = dist.new_group(list(range(start, start + n)))
            if start <= rank < start + n:
                group = block
        if group is None:
            n = 1
    return make_mesh((n,), (axis,), group=group, device=device)


def make_elastic_mesh(*, device=None):
    """The training mesh over the ranks of the default process group
    (one rank without one): ``(data, model)`` of
    :func:`choose_mesh_shape` of the world size.  ``device`` is this
    rank's device (its CUDA device by default)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh(choose_mesh_shape(world), ("data", "model"),
                     device=device)


def elastic_restore(directory: str, template, sharding_fn, *, device=None):
    """Restore the newest valid checkpoint of ``directory`` onto a freshly
    built mesh (:func:`make_elastic_mesh` on ``device``).

    ``sharding_fn(mesh, template)`` names the device this rank restores
    the tree onto (a rank of the port holds whole logical arrays, so the
    reference's per-leaf shardings come down to one device).  Returns
    ``(tree, step, mesh)``; ``(None, None, mesh)`` when there is no valid
    checkpoint."""
    # imported here so the serving path never pays for the checkpoint stack
    from repro_torch.checkpoint.manager import CheckpointManager

    mesh = make_elastic_mesh(device=device)
    tree, step = CheckpointManager(directory).restore(
        template, device=sharding_fn(mesh, template))
    return tree, step, mesh
