"""Deterministic synthetic data pipelines (counterpart of
:mod:`repro.data.pipeline`): LM tokens and recsys click logs with
checkpointable cursors and shard-aware loading.

Plain numpy, as in the reference, and the same draws: given the same
seed, step and shard every batch is bit-identical to the reference's.
Every stream is a pure function of (seed, step, shard), so

* resuming from a checkpointed cursor reproduces the exact batch order
  (a restarted run sees no data skew), and
* each host materializes only its shard (:func:`host_slice`).

Batches are numpy arrays; the caller moves them to its device.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class StreamState:
    seed: int
    step: int = 0

    def cursor(self):
        return {"seed": self.seed, "step": self.step}

    @classmethod
    def from_cursor(cls, cur):
        return cls(seed=int(cur["seed"]), step=int(cur["step"]))


def host_slice(global_batch: int, n_hosts: int, host_id: int):
    per = global_batch // n_hosts
    return slice(host_id * per, (host_id + 1) * per)


class TokenStream:
    """Synthetic LM token stream with a planted bigram structure (so the
    loss falls in the example training runs).  ``next_batch`` returns
    ``{"tokens", "labels"}`` int32 ``(batch, seq)``, the last label of
    each row -1 (masked)."""

    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0):
        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = global_batch
        self.state = StreamState(seed)
        rng = np.random.default_rng(seed)
        self._trans = rng.integers(0, vocab_size,
                                   size=(min(vocab_size, 4096),)).astype(
            np.int32)

    def next_batch(self, shard: slice | None = None):
        step = self.state.step
        self.state.step += 1
        rng = np.random.default_rng((self.state.seed, step))
        b = self.batch if shard is None else (shard.stop - shard.start)
        first = rng.integers(0, self.vocab, size=(b, 1)).astype(np.int32)
        noise = rng.integers(0, self.vocab, size=(b, self.seq)).astype(
            np.int32)
        keep = rng.random((b, self.seq)) < 0.75
        toks = np.empty((b, self.seq), np.int32)
        toks[:, 0] = first[:, 0]
        for t in range(1, self.seq):
            nxt = self._trans[toks[:, t - 1] % len(self._trans)]
            toks[:, t] = np.where(keep[:, t], nxt, noise[:, t])
        labels = np.concatenate(
            [toks[:, 1:], np.full((b, 1), -1, np.int32)], axis=1)
        return {"tokens": toks, "labels": labels}


class ClickLogStream:
    """Recsys click log: heavy-tailed categorical ids and planted logistic
    labels (so a click model trained on it has signal)."""

    def __init__(self, field_vocabs, global_batch: int, seed: int = 0):
        self.field_vocabs = np.asarray(field_vocabs, np.int64)
        self.offsets = np.concatenate(
            [[0], np.cumsum(self.field_vocabs)[:-1]])
        self.batch = global_batch
        self.state = StreamState(seed)
        rng = np.random.default_rng(seed + 1)
        self._w = rng.normal(scale=0.3, size=(len(field_vocabs),))

    def next_batch(self, shard: slice | None = None):
        step = self.state.step
        self.state.step += 1
        rng = np.random.default_rng((self.state.seed, step))
        b = self.batch if shard is None else (shard.stop - shard.start)
        u = rng.random((b, len(self.field_vocabs)))
        ids = np.minimum((u ** 3 * self.field_vocabs).astype(np.int64),
                         self.field_vocabs - 1)
        logit = (ids / np.maximum(self.field_vocabs, 1) * self._w).sum(-1)
        labels = (rng.random(b) < 1.0 / (1.0 + np.exp(-logit))).astype(
            np.float32)
        return {"ids": (ids + self.offsets).astype(np.int32),
                "labels": labels}
