"""Divisibility helpers of the tensor-parallel layout (counterpart of
:mod:`repro.distributed.sharding`).

Query heads are padded up to a multiple of the model axis, kv heads
repeated (the Megatron GQA convention) when there are fewer than the
model axis, and the vocabulary and expert counts padded to multiples.
:class:`repro_torch.models.transformer.TransformerConfig.with_mesh`
sizes a model with them.

The reference's ``NamedSharding`` / ``PartitionSpec`` helpers
(``batch_axes``, ``named``, ``shard_batch_spec`` and the axis-size
readers) have no counterpart here: the port shards by hand over
``torch.distributed`` ranks (:mod:`repro_torch.distributed.compat`), and
no placement annotation exists to build.
"""

from __future__ import annotations


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
