"""Prefill and decode step functions.

  * ``make_prefill_step`` — forward logits at full sequence length.
  * ``make_serve_step``  — one decode step (new token) against the KV cache.

The training step belongs to a later slice (ROADMAP.md queue A, item 8).
Both factories take ``device=`` (``None``: the CUDA device; raises where
there is none) and return a function that moves its token inputs there.
"""

from __future__ import annotations

from typing import Optional

import torch

from .._device import resolve_device
from ..configs.base import ModelCfg
from ..models import transformer


def make_prefill_step(cfg: ModelCfg, *, device=None):
    dev = resolve_device(device)

    def prefill_step(params, batch):
        batch = dict(batch, tokens=torch.as_tensor(batch["tokens"], device=dev))
        logits, _ = transformer.lm_forward(params, batch, cfg)
        return logits

    return prefill_step


def make_serve_step(cfg: ModelCfg, temperature: float = 0.0, *, device=None):
    dev = resolve_device(device)

    def serve_step(params, cache, tokens1, index, rng: Optional[torch.Generator] = None):
        """Greedy (or, with ``temperature > 0`` and a generator on the
        device, sampled) single-token decode step.  Returns (next tokens
        (B,1) int32, cache)."""
        logits, cache = transformer.lm_decode_step(
            params, cache, torch.as_tensor(tokens1, device=dev),
            torch.as_tensor(index, dtype=torch.int32, device=dev), cfg)
        last = logits[:, -1, :].float()
        if temperature > 0.0 and rng is not None:
            probs = torch.softmax(last / temperature, dim=-1)
            next_tok = torch.multinomial(probs, 1, generator=rng)[:, 0]
        else:
            next_tok = last.argmax(-1)
        return next_tok.to(torch.int32)[:, None], cache

    return serve_step
