"""The collectives of the distributed drivers, on ``torch.distributed``
(counterpart of :mod:`repro.distributed.collectives`).

* :func:`psum` -- ``lax.psum`` as ``all_reduce`` (sum).  Counts are
  int64 here, int32 in the reference; the values are equal.
* :func:`pmax` -- ``lax.pmax`` as ``all_reduce`` (max).
* :func:`halo_exchange` -- ``lax.ppermute`` from the ring successor: each
  rank sends its slabs to rank - 1 and receives rank + 1's, as one batch
  of point-to-point operations.  Bumps ``CALL_COUNTS["halo_exchanges"]``
  once per call, which is how the tests certify one exchange per
  graph-sharded evaluation (zero for strip-only metric subsets).
* :func:`ring_shift` -- the ring of :func:`~repro_torch.distributed.
  pairwise.ring_occlusion_count`: send to rank + 1, receive from rank - 1.
* :func:`all_gather` -- ``shard_map``'s ``out_specs=P(axes)`` on the
  batch axis: every rank's rows, concatenated in rank order.

Gloo moves host tensors only, so on a gloo group the payloads (halo
slabs, partial sums, per-layout results: all small) are copied to the
host and back; on NCCL they stay on the device.  The pair sweeps run on
the rank's device either way.  On a one-rank mesh the permutations are
the identity (gloo cannot send to itself), and a mesh without a process
group has identity collectives throughout.

``merge_decode_attention`` is decode attention against a KV cache
sharded on its sequence axis over the mesh (the LM serving path):
local softmax statistics merged by all-reduces.
``sharded_embedding_lookup`` is the recsys path's range-partitioned
table lookup: each rank of one axis gathers the ids it owns, the ranks
of that axis sum.  :func:`psum_all` is the one all-reduce over every
axis that ends the dry run's row-sharded builders.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core import grid as gridlib


def _staged(mesh, t):
    """``t`` as the group's backend can move it: on the host for gloo,
    bool as uint8 (gloo reduces no bool)."""
    if mesh.backend == "gloo" and t.device.type != "cpu":
        t = t.cpu()
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    return t.contiguous()


def _back(t, like):
    return t.to(like.device, like.dtype)


def psum(mesh, t):
    """Sum of ``t`` over the mesh's ranks (every rank gets it)."""
    if mesh.group is None:
        return t
    x = _staged(mesh, t)
    if x is t:
        x = t.clone()      # all_reduce works in place: leave t alone
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.group)
    return _back(x, t)


def pmax(mesh, t):
    """Elementwise maximum of ``t`` over the mesh's ranks."""
    if mesh.group is None:
        return t
    x = _staged(mesh, t)
    if x is t:
        x = t.clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=mesh.group)
    return _back(x, t)


def _permute(mesh, tensors, send_to, recv_from):
    """Send each tensor to mesh rank ``send_to`` and receive a tensor of
    the same shape from ``recv_from``, all as one batch."""
    if mesh.size == 1:
        return tuple(t.clone() for t in tensors)
    g = mesh.group
    peer_send = dist.get_global_rank(g, send_to)
    peer_recv = dist.get_global_rank(g, recv_from)
    outs, bufs, ops = [], [], []
    for t in tensors:
        x = _staged(mesh, t)
        buf = torch.empty_like(x)
        ops.append(dist.P2POp(dist.isend, x, peer_send, g))
        ops.append(dist.P2POp(dist.irecv, buf, peer_recv, g))
        bufs.append(buf)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    for t, buf in zip(tensors, bufs):
        outs.append(_back(buf, t))
    return tuple(outs)


def halo_exchange(mesh, slabs):
    """Receive each slab of ``slabs`` (a tuple of tensors of one leading
    shape: the caller's boundary-cell bucket rows) from the ring successor
    ``rank + 1``.  The wrap-around slab (the last rank receives rank 0's)
    is the caller's to mask."""
    gridlib.CALL_COUNTS["halo_exchanges"] += 1
    n = mesh.size
    return _permute(mesh, slabs, (mesh.rank - 1) % n, (mesh.rank + 1) % n)


def ring_shift(mesh, tensors):
    """Pass each tensor one step along the ring: rank ``i`` receives what
    rank ``i - 1`` held."""
    n = mesh.size
    return _permute(mesh, tensors, (mesh.rank + 1) % n, (mesh.rank - 1) % n)


def all_gather(mesh, t):
    """Every rank's ``t`` (same shape on each) concatenated along dim 0 in
    rank order; every rank gets the whole."""
    if mesh.group is None:
        return t
    x = _staged(mesh, t)
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    return _back(torch.cat(parts), t)


def merge_decode_attention(mesh, q, k_cache, v_cache, pos, *,
                           seq_axis: str = "model"):
    """Decode attention against a KV cache sharded on its sequence axis
    over the mesh: ``q`` ``(B, H, dh)`` replicated, ``k_cache`` /
    ``v_cache`` ``(B, S, H, dh)``, ``pos`` the last position attended.
    Returns ``(B, H, dh)``, the same on every rank.

    Each rank takes its contiguous ``S / n`` slice of the cache (the
    reference's ``shard_map`` in-spec; a rank reads only its slice) and
    forms local ``(m, l, o)``; then ``m* = max(m)``, ``l* = sum(l
    e^(m - m*))``, ``o* = sum(o e^(m - m*)) / l*`` over the ranks (the
    max and the sums as all-reduces).  The mesh is one axis,
    ``seq_axis``."""
    if mesh.axis_names != (seq_axis,):
        raise ValueError(f"merge_decode_attention shards over one axis "
                         f"{seq_axis!r}; the mesh has {mesh.axis_names}")
    n = mesh.size
    S = k_cache.shape[1]
    if S % n:
        raise ValueError(f"a cache of {S} positions does not split over "
                         f"{n} ranks")
    per = S // n
    sl = slice(mesh.rank * per, (mesh.rank + 1) * per)
    k, v = k_cache[:, sl], v_cache[:, sl]
    scale = torch.full((), q.shape[-1] ** -0.5, dtype=torch.float32,
                       device=q.device)
    t = mesh.rank * per + torch.arange(per, device=q.device)
    s = torch.einsum("bhd,bthd->bht", q, k).float() * scale
    s = torch.where((t <= pos)[None, None, :], s, -1e30)
    m = s.amax(dim=-1)                                        # (B, H)
    p = torch.exp(s - m[..., None])
    l_ = p.sum(dim=-1)                                        # (B, H)
    o = torch.einsum("bht,bthd->bhd", p.to(v.dtype), v)
    m_star = pmax(mesh, m)
    corr = torch.exp(m - m_star)
    l_star = psum(mesh, l_ * corr)
    o_star = psum(mesh, o * corr[..., None].to(o.dtype))
    return o_star / torch.clamp_min(l_star, 1e-30)[..., None].to(o.dtype)


def psum_all(mesh, t):
    """Sum of ``t`` over every axis of a mesh, as one all-reduce: a
    :class:`~repro_torch.distributed.compat.Mesh` (:func:`psum`) or a
    ``DeviceMesh`` over the whole default group (a functional all-reduce,
    which a trace over fake ranks records).  One rank: ``t``."""
    if not hasattr(mesh, "mesh_dim_names"):
        return psum(mesh, t)
    if mesh.size() == 1:
        return t
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"psum_all sums over the whole default group; "
                         f"the mesh has {mesh.size()} of its "
                         f"{dist.get_world_size()} ranks")
    from torch.distributed import _functional_collectives as funcol
    return funcol.all_reduce(t, "sum", dist.group.WORLD)


# the sub-meshes of one axis: (id of the group, axis) -> Mesh
_SUBMESHES = {}


def axis_submesh(mesh, axis: str):
    """The one-axis :class:`~repro_torch.distributed.compat.Mesh` of the
    ranks that share this rank's position on every axis but ``axis``.
    Every rank of ``mesh`` must call it (it makes the sub-groups of all
    positions, in one order, the first time)."""
    from repro_torch.distributed.compat import Mesh

    if len(mesh.axis_names) == 1:
        return mesh
    key = (id(mesh.group), axis)
    if key not in _SUBMESHES:
        a = mesh.axis_names.index(axis)
        shape = mesh.axis_shape
        strides = [1] * len(shape)
        for d in range(len(shape) - 2, -1, -1):
            strides[d] = strides[d + 1] * shape[d + 1]
        others = [d for d in range(len(shape)) if d != a]
        mine = None
        for pos in range(mesh.size // shape[a]):
            base, rest = 0, pos
            for d in reversed(others):
                base += (rest % shape[d]) * strides[d]
                rest //= shape[d]
            ranks = [base + i * strides[a] for i in range(shape[a])]
            glob = ([dist.get_global_rank(mesh.group, r) for r in ranks]
                    if mesh.group is not None else ranks)
            group = (dist.new_group(glob) if mesh.group is not None
                     else None)
            if mesh.rank in ranks:
                mine = Mesh(group=group, rank=ranks.index(mesh.rank),
                            axis_shape=(shape[a],), axis_names=(axis,),
                            device=mesh.device)
        _SUBMESHES[key] = mine
    return _SUBMESHES[key]


def sharded_embedding_lookup(mesh, table, ids, *, axis: str = "model"):
    """Range-partitioned lookup: ``table`` ``(V, d)`` sharded on rows over
    the mesh's ``axis``, ``ids`` ``(...,)`` replicated.  Returns ``(...,
    d)``, the same on every rank.

    Rank ``r`` of ``axis`` takes rows ``[r V/n, (r+1) V/n)`` of ``table``
    (the reference's ``shard_map`` in-spec ``P(axis, None)``; a rank
    reads only its slice), gathers the ids in that range, zeroes the
    others, and the ranks of that axis sum (:func:`psum` over the axis's
    sub-group; the mesh's other axes replicate).  ``V`` must split evenly
    over the axis."""
    if axis not in mesh.axis_names:
        raise ValueError(f"the mesh {mesh.axis_names} has no axis "
                         f"{axis!r}")
    sub = axis_submesh(mesh, axis)
    n_shard, V = sub.size, table.shape[0]
    if V % n_shard:
        raise ValueError(f"a table of {V} rows does not split over "
                         f"{n_shard} ranks")
    per = V // n_shard
    lo = sub.rank * per
    local = ids.long() - lo
    in_range = (local >= 0) & (local < per)
    rows = table[lo:lo + per][torch.clamp(local, 0, per - 1)]
    rows = torch.where(in_range[..., None], rows, torch.zeros_like(rows))
    return psum(sub, rows)
