"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

Real-Gated Linear Recurrent Unit:
    r_t = sigmoid(W_a u_t)                 (recurrence gate)
    i_t = sigmoid(W_x u_t)                 (input gate)
    log a_t = -c * softplus(Lambda) * r_t
    h_t = a_t . h_{t-1} + sqrt(1 - a_t^2) . (i_t . u_t)

The full recurrent block is: dual linear branches -> short depthwise causal
conv -> RG-LRU -> gated output projection; decode keeps (h, conv window)
state.  The reference evaluates the diagonal recurrence with an associative
scan in the region it marks ``pallas_kernel.rglru_scan``; here that region is
``ops.rglru_scan``: kernel K6 on the card, the plain scan on the CPU.

The reference's numerics are kept where PyTorch's defaults differ:
``jax.nn.gelu`` is the tanh approximation, ``jax.nn.softplus`` is
``logaddexp(x, 0)``, and the conv sums its taps in the input's dtype in the
reference's order.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from .._device import resolve_device
from ..configs.base import ModelCfg
from ..kernels import ops
from .common import dense, dtype_of, ninit

gelu = functools.partial(F.gelu, approximate="tanh")


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (``F.softplus`` returns x
    itself above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _d_rnn(cfg: ModelCfg) -> int:
    return cfg.rglru.d_rnn or cfg.d_model


def init_rglru(gen: torch.Generator, cfg: ModelCfg):
    d = cfg.d_model
    dr = _d_rnn(cfg)
    w = cfg.rglru.conv_width
    dev = gen.device
    return {
        "w_x": ninit(gen, (d, dr)),          # recurrent branch in-proj
        "w_y": ninit(gen, (d, dr)),          # gate branch in-proj
        "conv_w": ninit(gen, (w, dr), scale=0.1),
        "conv_b": torch.zeros((dr,), dtype=torch.float32, device=dev),
        "w_a": ninit(gen, (dr, dr), scale=0.01, dtype=torch.float32),
        "w_i": ninit(gen, (dr, dr), scale=0.01, dtype=torch.float32),
        "lam": torch.full((dr,), 0.5, dtype=torch.float32, device=dev),   # Lambda
        "w_o": ninit(gen, (dr, d), scale=0.02 / max(1, cfg.n_layers) ** 0.5),
    }


def specs_rglru(cfg: ModelCfg):
    return {
        "w_x": ("embed_tp", "ff"), "w_y": ("embed_tp", "ff"),
        "conv_w": (None, "ff"), "conv_b": ("ff",),
        "w_a": ("ff", "ff2"), "w_i": ("ff", "ff2"),
        "lam": ("ff",),
        "w_o": ("ff", "embed_tp"),
    }


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor, state=None):
    """Depthwise causal conv; u (B,S,C), w (W,C).  ``state`` (B,W-1,C): the
    previous inputs, for decode.  The taps are summed in u's dtype, in the
    reference's order, then the bias is added.  Returns (out, new state)."""
    W = w.shape[0]
    if state is None:
        pad = torch.zeros((u.shape[0], W - 1, u.shape[2]), dtype=u.dtype, device=u.device)
    else:
        pad = state.to(u.dtype)
    ext = torch.cat([pad, u], dim=1)
    S = u.shape[1]
    out = ext[:, 0:S] * w[0].to(u.dtype)
    for i in range(1, W):
        out = out + ext[:, i:i + S] * w[i].to(u.dtype)
    return out + b.to(u.dtype), ext[:, ext.shape[1] - (W - 1):]


def _gates(p, u: torch.Tensor, cfg: ModelCfg):
    """(a, b) of the recurrence in float32."""
    uf = u.float()
    r = torch.sigmoid(uf @ p["w_a"])
    i = torch.sigmoid(uf @ p["w_i"])
    log_a = -cfg.rglru.c * softplus(p["lam"]) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (i * uf)
    return a, b


def rglru_forward(p, x: torch.Tensor, cfg: ModelCfg, h0=None) -> torch.Tensor:
    """x (B,S,D) -> (B,S,D); the scan is K6 (``ops.rglru_scan``) on the card."""
    u = dense(x, p["w_x"])
    y = gelu(dense(x, p["w_y"]))
    u, _ = _causal_conv(u, p["conv_w"], p["conv_b"])
    a, b = _gates(p, u, cfg)
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0.float()[:, None], b[:, 1:]], dim=1)
    h = ops.rglru_scan(a, b)
    return dense(h.to(x.dtype) * y, p["w_o"])


# -- decode -------------------------------------------------------------------


def init_rglru_cache(batch: int, cfg: ModelCfg, device=None):
    """Zeroed state on ``device`` (``None``: the CUDA device; raises where
    there is none)."""
    device = resolve_device(device)
    dr = _d_rnn(cfg)
    w = cfg.rglru.conv_width
    return {"h": torch.zeros((batch, dr), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, w - 1, dr), dtype=dtype_of(cfg.dtype), device=device)}


def specs_rglru_cache():
    return {"h": ("batch", "ff"), "conv": ("batch", None, "ff")}


def rglru_decode_step(p, x1: torch.Tensor, cache, cfg: ModelCfg):
    """x1 (B,1,D).  Plain tensor code: the reference runs no kernel here.
    Returns (out (B,1,D), cache); the cache's tensors are updated in place."""
    u = dense(x1, p["w_x"])
    y = gelu(dense(x1, p["w_y"]))
    u, conv_state = _causal_conv(u, p["conv_w"], p["conv_b"], state=cache["conv"])
    a, b = _gates(p, u, cfg)
    h = a[:, 0] * cache["h"] + b[:, 0]
    out = dense(h[:, None].to(x1.dtype) * y, p["w_o"])
    cache["h"].copy_(h)
    cache["conv"].copy_(conv_state)
    return out, cache
