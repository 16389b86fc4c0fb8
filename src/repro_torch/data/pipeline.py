"""Deterministic synthetic data pipeline.

Requirements served here:
  * host-sharded — each host materialises only its slice of the global batch
    (``host_id``/``n_hosts``), as a real multi-host input pipeline would;
  * seekable — ``batch_at(step)`` is a pure function of (seed, step), so a
    restart from a step-k checkpoint reproduces the exact token stream
    (checked by tests);
  * modality-aware — archs with a frontend stub get deterministic
    ``frontend_embeds`` alongside the token stream.

The generator is a counter-based PRNG (Philox via numpy) keyed on
(seed, step, host) — no state to checkpoint.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..configs.base import ModelCfg, ShapeCfg


@dataclass(frozen=True)
class DataCfg:
    seq_len: int
    global_batch: int
    seed: int = 1234


class SyntheticTokens:
    """Synthetic LM stream with a learnable structure (affine-recurrent
    tokens + noise) so small models show decreasing loss, not just noise."""

    def __init__(self, data: DataCfg, model: ModelCfg, host_id: int = 0, n_hosts: int = 1):
        assert data.global_batch % n_hosts == 0, (data.global_batch, n_hosts)
        self.data = data
        self.model = model
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.local_batch = data.global_batch // n_hosts

    def _rng(self, step: int) -> np.random.Generator:
        # SeedSequence mixes (seed, step, host) into independent streams
        return np.random.default_rng((self.data.seed, step, self.host_id))

    def batch_at(self, step: int) -> dict:
        rng = self._rng(step)
        B, S, V = self.local_batch, self.data.seq_len, self.model.vocab
        # structured stream over an active sub-vocabulary: a fixed affine
        # bigram process x_{t+1} = (x_t + c) % A with 2% corruption — models
        # of any size show decreasing loss, and the stream stays non-trivial
        # (c depends on the seed; corruption is irreducible entropy).
        A = min(V, 4096)
        c = (self.data.seed * 2654435761 % (A - 1)) + 1
        x0 = rng.integers(0, A, size=(B,), dtype=np.int64)
        t = np.arange(S + 1, dtype=np.int64)
        seq = (x0[:, None] + c * t[None, :]) % A
        noise = rng.random((B, S + 1)) < 0.02
        seq = np.where(noise, rng.integers(0, A, size=(B, S + 1)), seq)
        out = {
            "tokens": seq[:, :-1].astype(np.int32),
            "labels": seq[:, 1:].astype(np.int32),
        }
        if self.model.frontend is not None:
            out["frontend_embeds"] = rng.standard_normal(
                (B, self.model.frontend_tokens, self.model.frontend_dim),
                dtype=np.float32) * 0.02
        return out


def make_batch(cfg: ModelCfg, shape: ShapeCfg, *, step: int = 0, seed: int = 0,
               host_id: int = 0, n_hosts: int = 1) -> dict:
    """One batch for an (arch x shape) cell."""
    ds = SyntheticTokens(DataCfg(shape.seq_len, shape.global_batch, seed),
                         cfg, host_id, n_hosts)
    b = ds.batch_at(step)
    if shape.kind == "prefill":
        b.pop("labels", None)
    return b
