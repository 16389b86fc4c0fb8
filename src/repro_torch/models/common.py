"""Shared model components: norms, rope, activations, initializers.

Parameters are plain dicts of tensors with the reference's tree layout, so
that a reference tree carries over leaf by leaf (``compat``).  ``init_*``
functions draw from a ``torch.Generator`` and create their tensors on that
generator's device.  The reference's ``_named_scope`` marks kernel-eligible
regions; here those regions are calls into ``kernels.ops``.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.api import DTensor, reshape


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}[name]


def ninit(gen: torch.Generator, shape, scale: float = 0.02,
          dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
            * scale).to(dtype)


def dense(x: torch.Tensor, w: torch.Tensor, contract: int = 1) -> torch.Tensor:
    """``x`` times ``w`` over the last ``contract`` dims of ``x`` and the
    first ``contract`` dims of ``w`` — the reference's projection einsums
    ("bsd,dhe->bshe", "bshe,hed->bsd", "bsd,df->bsf") as one matmul — with
    ``jnp.einsum``'s type promotion: bfloat16 weights against float32
    activations give float32, exactly."""
    dt = torch.promote_types(x.dtype, w.dtype)
    x = x if x.dtype == dt else x.to(dt)
    w = w if w.dtype == dt else w.to(dt)
    lead, k = x.shape[:x.ndim - contract], math.prod(w.shape[:contract])
    if isinstance(x, DTensor) or isinstance(w, DTensor):
        y = reshape(x, (*lead, k)) @ reshape(w, (k, math.prod(w.shape[contract:])))
        return reshape(y, (*lead, *w.shape[contract:]))
    return (x.reshape(*lead, k) @ w.reshape(k, -1)).reshape(*lead, *w.shape[contract:])


# -- norms -------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
             plus_one: bool = False) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    w = weight.float()
    if plus_one:
        w = w + 1.0
    return (y * w).to(x.dtype)


def init_norm(d: int, device=None):
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def specs_norm():
    return {"scale": (None,)}


# -- rope ---------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def rope_freqs(d_head: int, theta: float, rope_dim: Optional[int] = None,
               device=None) -> torch.Tensor:
    """Inverse frequencies, computed in float64 and rounded to float32; kept
    per device, so a decode step copies nothing from the host."""
    rd = rope_dim or d_head
    inv = 1.0 / (theta ** (np.arange(0, rd, 2, dtype=np.float64) / rd))
    return torch.as_tensor(inv.astype(np.float32), device=device)  # (rd/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               rope_dim: Optional[int] = None) -> torch.Tensor:
    """x: (..., S, H, Dh) or (..., S, Dh); positions: (..., S).  Rotates
    interleaved pairs (x[..., 0::2], x[..., 1::2]), as the reference does."""
    dh = x.shape[-1]
    rd = rope_dim or dh
    inv = rope_freqs(dh, theta, rd, device=x.device)
    ang = positions[..., None].float() * inv                  # (..., S, rd/2)
    sin, cos = torch.sin(ang), torch.cos(ang)
    if x.ndim == ang.ndim + 1:  # head axis present
        sin, cos = sin[..., None, :], cos[..., None, :]
    xr = x[..., :rd].float()
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    ro = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).reshape(xr.shape)
    if rd < dh:
        ro = torch.cat([ro, x[..., rd:].float()], dim=-1)
    return ro.to(x.dtype)


# -- activations -----------------------------------------------------------------


def act_fn(name: str):
    # jax.nn.gelu is the tanh approximation unless told otherwise
    return {"silu": F.silu, "gelu": functools.partial(F.gelu, approximate="tanh"),
            "relu": F.relu, "gelu_tanh": functools.partial(F.gelu, approximate="tanh")}[name]


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap
