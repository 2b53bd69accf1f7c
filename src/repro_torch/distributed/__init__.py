"""Distributed evaluation on ``torch.distributed`` (counterpart of
:mod:`repro.distributed`): one process per rank, every rank running the
same program, which is PyTorch's counterpart of ``shard_map``.

* :mod:`~repro_torch.distributed.compat` -- :class:`Mesh` and
  :func:`make_mesh`;
* :mod:`~repro_torch.distributed.collectives` -- ``psum`` as
  ``all_reduce``, the halo exchange as a ring of point-to-point sends,
  gathering the batch axis as ``all_gather``;
* :mod:`~repro_torch.distributed.graph_sharded` -- ONE layout spatially
  partitioned over the ranks (``backend="graph_sharded"``);
* :mod:`~repro_torch.distributed.batched` -- the batch axis over the
  ranks;
* :mod:`~repro_torch.distributed.gridded` -- strip-sharded reversal
  sweeps and the ``backend="distributed"`` front door;
* :mod:`~repro_torch.distributed.pairwise` -- row-sharded and
  ring-streamed exact all-pairs counts.
"""
