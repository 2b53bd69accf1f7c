"""Mesh-axis conventions, placement helpers and divisibility helpers of
the tensor-parallel layout (counterpart of
:mod:`repro.distributed.sharding`).

Logical axes:

* ``pod``   -- outermost data-parallel axis across clusters (the
  two-cluster mesh);
* ``data``  -- data parallel (batch / independent strips);
* ``model`` -- tensor parallel (heads / d_ff / experts / vocab / table
  rows).

A :class:`P` is the port's partition spec: one entry per tensor dim,
each ``None`` (replicated), a mesh axis name or a tuple of them (the dim
split over those axes, in mesh order).  :func:`placements` turns it into
the ``DTensor`` placements of a ``DeviceMesh``, the counterpart of a
``NamedSharding``; the helpers take either a ``DeviceMesh`` or a
:class:`repro_torch.distributed.compat.Mesh`.

Query heads are padded up to a multiple of the model axis, kv heads
repeated (the Megatron GQA convention) when there are fewer than the
model axis, and the vocabulary and expert counts padded to multiples.
:class:`repro_torch.models.transformer.TransformerConfig.with_mesh`
sizes a model with them.
"""

from __future__ import annotations


class P(tuple):
    """A partition spec: ``P("data", None)`` splits dim 0 over ``data``;
    ``P(("pod", "data"))`` over both; dims past the spec's length are
    replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` or a compat ``Mesh``."""
    shape = getattr(mesh, "axis_shape", None)
    if shape is None:
        shape = tuple(mesh.shape)
    return dict(zip(axis_names(mesh), shape))


def mesh_size(mesh) -> int:
    size = mesh.size
    return size() if callable(size) else size


def mesh_rank(mesh) -> int:
    """This rank's row-major position on the mesh."""
    coord = getattr(mesh, "get_coordinate", None)
    if coord is None:
        return mesh.rank
    pos = 0
    for c, n in zip(coord(), axis_sizes(mesh).values()):
        pos = pos * n + c
    return pos


def batch_axes(mesh):
    """The composite batch-sharding axis tuple for this mesh."""
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


def model_axis_size(mesh) -> int:
    return axis_sizes(mesh)["model"]


def data_axis_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    return sizes["data"] * sizes.get("pod", 1)


def shard_batch_spec(mesh, *trailing) -> P:
    """The spec with the batch dim sharded over (pod?, data)."""
    return P(batch_axes(mesh), *trailing)


def placements(mesh, spec: P) -> tuple:
    """The ``DTensor`` placements (one per mesh dim) of ``spec``: mesh
    axis ``a`` is ``Shard(d)`` where ``spec[d]`` names it, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    where = {}
    for d, entry in enumerate(spec):
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            if name is None:
                continue
            if name in where:
                raise ValueError(f"mesh axis {name!r} appears twice in "
                                 f"{spec}")
            where[name] = d
    names = axis_names(mesh)
    unknown = set(where) - set(names)
    if unknown:
        raise ValueError(f"{spec} names axes {sorted(unknown)} that the "
                         f"mesh {names} does not have")
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in names)


def local_shape(mesh, shape, spec: P) -> tuple:
    """The shape of rank 0's shard of a ``shape`` tensor laid out by
    ``spec``: each sharded dim split as ``torch.chunk`` splits it, over
    its axes in mesh order (rank 0 holds the largest piece)."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            if name is not None:
                out[d] = -(-out[d] // sizes[name])
    return tuple(out)


def tree_shardings(mesh, spec_tree):
    """Map nested dicts and lists of :class:`P` to placements."""
    if isinstance(spec_tree, P):
        return placements(mesh, spec_tree)
    if isinstance(spec_tree, dict):
        return {k: tree_shardings(mesh, v) for k, v in spec_tree.items()}
    if isinstance(spec_tree, (list, tuple)):
        return type(spec_tree)(tree_shardings(mesh, v) for v in spec_tree)
    raise TypeError(f"not a spec tree: {spec_tree!r}")


def round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def pad_heads(n_heads: int, model_size: int) -> int:
    """Pad a head count up to a multiple of the model axis (dummy heads are
    masked out of the output projection)."""
    return round_up(n_heads, model_size)


def repeat_kv_heads(n_kv: int, model_size: int) -> int:
    """Effective kv-head count after Megatron-style duplication so the kv
    dimension shards evenly: ``max(n_kv, model)`` rounded to a
    multiple."""
    if n_kv >= model_size:
        return round_up(n_kv, model_size)
    return model_size
