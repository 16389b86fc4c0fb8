"""Mamba-2 SSD mixer (state-space duality, arXiv:2405.21060).

Chunked SSD algorithm: within each chunk the recurrence is evaluated as a
masked (decay-weighted) attention-like product; chunk boundary states are
carried by a sequential scan over chunks.

Layer structure (mamba2 block): in_proj -> [z | x | B | C | dt], short causal
conv on (x,B,C), SSD core with scalar-per-head decay A, gated RMSNorm, out
projection.  The SSD core is the region the reference marks
``pallas_kernel.ssd_scan``: kernel K5 (``ops.ssd_scan`` on the dt-weighted
inputs, plus the skip ``x * D``), whose wrapper takes its plain version on
CPU tensors.  ``ssd_core_chunked``, the reference's own chunked computation,
stays as the tests' oracle.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .._device import resolve_device
from ..configs.base import ModelCfg
from ..kernels import ops
from .common import dense, dtype_of, ninit
from .rglru import _causal_conv, softplus


def dims(cfg: ModelCfg):
    s = cfg.ssd
    d_inner = s.expand * cfg.d_model
    H = d_inner // s.headdim
    return d_inner, H, s.headdim, s.d_state


def init_ssd(gen: torch.Generator, cfg: ModelCfg):
    s = cfg.ssd
    d = cfg.d_model
    d_inner, H, P, N = dims(cfg)
    conv_ch = d_inner + 2 * N  # x, B, C share the conv (G=1 group)
    f32 = dict(dtype=torch.float32, device=gen.device)
    return {
        "w_in": ninit(gen, (d, 2 * d_inner + 2 * N + H)),  # z,x,B,C,dt
        "conv_w": ninit(gen, (s.conv_width, conv_ch), scale=0.1),
        "conv_b": torch.zeros((conv_ch,), **f32),
        "A_log": torch.zeros((H,), **f32),                  # A = -exp(A_log)
        "D": torch.ones((H,), **f32),
        "dt_bias": torch.zeros((H,), **f32),
        "norm_w": torch.ones((d_inner,), **f32),
        "w_out": ninit(gen, (d_inner, d), scale=0.02 / max(1, cfg.n_layers) ** 0.5),
    }


def specs_ssd(cfg: ModelCfg):
    return {
        "w_in": ("embed_tp", "ff"),
        "conv_w": (None, "ff"), "conv_b": ("ff",),
        "A_log": ("heads",), "D": ("heads",), "dt_bias": ("heads",),
        "norm_w": ("ff",),
        "w_out": ("ff", "embed_tp"),
    }


def _split(p, x, cfg: ModelCfg):
    d_inner, H, P, N = dims(cfg)
    proj = dense(x, p["w_in"])
    z = proj[..., :d_inner]
    rest = proj[..., d_inner:2 * d_inner + 2 * N]
    dt = proj[..., proj.shape[-1] - H:]
    return z, rest, dt


def _conv(p, rest, cfg: ModelCfg, state=None):
    out, new_state = _causal_conv(rest, p["conv_w"], p["conv_b"], state=state)
    return F.silu(out), new_state


def _gated_norm(y, z, w, eps=1e-6):
    yf = y.float() * F.silu(z.float())
    var = (yf * yf).mean(-1, keepdim=True)
    return (yf * torch.rsqrt(var + eps) * w).to(y.dtype)


def ssd_core_chunked(xh, dt, A, Bc, Cc, D, chunk: int, h0=None):
    """SSD core, the reference's chunked computation (the model's oracle of
    K5).  xh (B,S,H,P); dt (B,S,H) (post-softplus); A (H,) < 0; Bc, Cc
    (B,S,N); D (H,).  Returns (y (B,S,H,P) float32, final state (B,H,N,P))."""
    Bb, S, H, P = xh.shape
    N = Bc.shape[-1]
    nc = -(-S // chunk)
    pad = nc * chunk - S
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bc = F.pad(Bc, (0, 0, 0, pad))
        Cc = F.pad(Cc, (0, 0, 0, pad))
    Q = chunk
    xc = xh.reshape(Bb, nc, Q, H, P).float()
    dtc = dt.reshape(Bb, nc, Q, H).float()
    Bcc = Bc.reshape(Bb, nc, Q, N).float()
    Ccc = Cc.reshape(Bb, nc, Q, N).float()

    dA = dtc * A[None, None, None, :]                   # (B,nc,Q,H), negative
    cum = torch.cumsum(dA, dim=2)                       # within-chunk cumsum
    # intra-chunk: scores[t,s] = C_t.B_s * exp(cum_t - cum_s) for s <= t
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,Q,Q,H)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xh.device))
    decay = torch.where(tri[None, None, :, :, None], torch.exp(seg), 0.0)
    cb = torch.einsum("bcqn,bcsn->bcqs", Ccc, Bcc)
    xdt = xc * dtc[..., None]                            # dt-weighted input
    y_intra = torch.einsum("bcqs,bcqsh,bcshp->bcqhp", cb, decay, xdt)

    # chunk states: S_c = sum_s exp(cum_last - cum_s) B_s (x_s dt_s)^T
    last = cum[:, :, -1:, :]
    w_s = torch.exp(last - cum)                          # (B,nc,Q,H)
    states = torch.einsum("bcsn,bcsh,bcshp->bchnp", Bcc, w_s, xdt)

    # inter-chunk recurrence over nc chunks
    chunk_decay = torch.exp(last[:, :, 0, :])            # (B,nc,H)
    h = h0.float() if h0 is not None else torch.zeros((Bb, H, N, P), dtype=torch.float32,
                                                      device=xh.device)
    h_before = []
    for c in range(nc):
        h_before.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_before = torch.stack(h_before, 1)                  # (B,nc,H,N,P) state entering chunk
    y_inter = torch.einsum("bcqn,bcqh,bchnp->bcqhp", Ccc, torch.exp(cum), h_before)

    y = (y_intra + y_inter).reshape(Bb, nc * Q, H, P)[:, :S]
    y = y + xh.reshape(Bb, nc * Q, H, P)[:, :S] * D[None, None, :, None]
    return y, h


def ssd_forward(p, x, cfg: ModelCfg):
    d_inner, H, P, N = dims(cfg)
    z, rest, dt = _split(p, x, cfg)
    rest, _ = _conv(p, rest, cfg)
    xh = rest[..., :d_inner].reshape(*x.shape[:2], H, P)
    Bc = rest[..., d_inner:d_inner + N]
    Cc = rest[..., d_inner + N:]
    dt = softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    # K5 on the dt-weighted inputs, as tests/kernels/test_kernels.py holds
    # the Pallas kernel to ssd_core_chunked
    xf = xh.float()
    y = ops.ssd_scan(xf * dt[..., None], dt * A, Bc.float(), Cc.float(), chunk=cfg.ssd.chunk)
    y = y + xf * p["D"][None, None, :, None]
    y = y.reshape(*x.shape[:2], d_inner).to(x.dtype)
    y = _gated_norm(y, z, p["norm_w"])
    return dense(y, p["w_out"])


# -- decode --------------------------------------------------------------------


def init_ssd_cache(batch: int, cfg: ModelCfg, device=None):
    """Zeroed state on ``device`` (``None``: the CUDA device; raises where
    there is none)."""
    device = resolve_device(device)
    d_inner, H, P, N = dims(cfg)
    w = cfg.ssd.conv_width
    conv_ch = d_inner + 2 * N
    return {"h": torch.zeros((batch, H, N, P), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, w - 1, conv_ch), dtype=dtype_of(cfg.dtype), device=device)}


def specs_ssd_cache():
    return {"h": ("batch", "heads", None, None), "conv": ("batch", None, "ff")}


def ssd_decode_step(p, x1, cache, cfg: ModelCfg):
    """x1 (B,1,D).  Plain tensor code: the reference runs no kernel here.
    Returns (out (B,1,D), cache); the cache's tensors are updated in place."""
    d_inner, H, P, N = dims(cfg)
    z, rest, dt = _split(p, x1, cfg)
    rest, conv_state = _conv(p, rest, cfg, state=cache["conv"])
    xh = rest[..., :d_inner].reshape(x1.shape[0], H, P).float()
    Bc = rest[:, 0, d_inner:d_inner + N].float()
    Cc = rest[:, 0, d_inner + N:].float()
    dtv = softplus(dt[:, 0].float() + p["dt_bias"])                      # (B,H)
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dtv * A[None, :])                                  # (B,H)
    h = cache["h"] * decay[..., None, None] + torch.einsum("bn,bh,bhp->bhnp", Bc, dtv, xh)
    y = torch.einsum("bn,bhnp->bhp", Cc, h) + xh * p["D"][None, :, None]
    y = y.reshape(x1.shape[0], 1, d_inner).to(x1.dtype)
    y = _gated_norm(y, z, p["norm_w"])
    o = dense(y, p["w_out"])
    cache["h"].copy_(h)
    cache["conv"].copy_(conv_state)
    return o, cache
