"""The collectives of the distributed drivers, on ``torch.distributed``
(counterpart of :mod:`repro.distributed.collectives`).

* :func:`psum` -- ``lax.psum`` as ``all_reduce`` (sum).  Counts are
  int64 here, int32 in the reference; the values are equal.
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

``merge_decode_attention`` and ``sharded_embedding_lookup`` belong to
the seed-template substrate and are not ported here.
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
