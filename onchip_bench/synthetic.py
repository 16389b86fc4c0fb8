"""The token stream of every training cell: a frozen copy of the port's
``data/pipeline.SyntheticTokens`` (its ``batch_at``), so that a change to the
program cannot change the benchmark's inputs.

Each row is an affine bigram walk ``x_{t+1} = (x_t + c) mod A`` over an active
sub-vocabulary of ``A`` ids, with a share ``noise`` of positions replaced by
uniform ids; ``c`` follows from the seed, each row's start and noise from
``(seed, step)``.  Rows of one batch differ (each its own start and noise).
A batch is a pure function of (seed, step), made on the host as a loader makes it.
"""

from __future__ import annotations

import numpy as np

#: seeds are taken modulo this (numpy's and torch's generators take any
#: non-negative integer below it)
SEED_MOD = 2 ** 63


class Stream:
    def __init__(self, seed: int, batch: int, seq_len: int, vocab: int,
                 active_vocab: int = 4096, noise: float = 0.02):
        self.seed = int(seed) % SEED_MOD
        self.batch, self.seq_len = batch, seq_len
        self.active = min(vocab, active_vocab)
        self.noise = noise

    def batch_at(self, step: int) -> dict:
        """{"tokens", "labels"}: int32 arrays of (batch, seq_len)."""
        rng = np.random.default_rng((self.seed, step, 0))
        B, S, A = self.batch, self.seq_len, self.active
        c = (self.seed * 2654435761 % (A - 1)) + 1
        x0 = rng.integers(0, A, size=(B,), dtype=np.int64)
        t = np.arange(S + 1, dtype=np.int64)
        seq = (x0[:, None] + c * t[None, :]) % A
        noisy = rng.random((B, S + 1)) < self.noise
        seq = np.where(noisy, rng.integers(0, A, size=(B, S + 1)), seq)
        return {"tokens": seq[:, :-1].astype(np.int32), "labels": seq[:, 1:].astype(np.int32)}
