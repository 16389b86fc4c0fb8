"""Plain float32 reference of ``mamba2-780m`` (Mamba-2, arXiv:2405.21060), as its
configuration file states it.

Per layer: RMSNorm; the in-projection to [z | x B C | dt]; a depthwise causal
convolution of width d_conv (with bias) over (x, B, C) and SiLU; dt =
softplus(dt + dt_bias), A = -exp(A_log); the SSD recurrence h_t = exp(dt_t A) h_{t-1}
+ dt_t B_t x_t^T, y_t = C_t h_t + D x_t, one group of B and C shared by all
heads, computed by the chunked algorithm of the paper (within a chunk the
decay-masked product C B^T, across chunks the states passed on); the gated
RMSNorm of y * SiLU(z); the out-projection; the residual.  Final RMSNorm and
the tied head, the mean cross-entropy.

Each layer is recomputed in its backward.  Parameters are named and stacked as
the port's tree holds them; ``param_specs`` lists them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from onchip_bench import plain

STD = 0.02             # matrices are drawn N(0, STD^2)
CONV_STD = 0.1         # the convolution's taps N(0, CONV_STD^2)


def _dims(conf: dict) -> dict:
    s = conf["ssm_cfg"]
    di = s["expand"] * conf["d_model"]
    m = conf["pad_vocab_size_multiple"]
    return dict(D=conf["d_model"], L=conf["n_layer"], di=di, P=s["headdim"], H=di // s["headdim"],
                N=s["d_state"], W=s["d_conv"], Q=s["chunk_size"],
                V=-(-conf["vocab_size"] // m) * m)


def param_specs(conf: dict) -> dict:
    """``{path: (shape, dtype, init)}`` of every parameter, by the port's paths."""
    d = _dims(conf)
    s = conf["ssm_cfg"]
    L, D, di, H, N = d["L"], d["D"], d["di"], d["H"], d["N"]
    # the layers' matrices are stored in bfloat16, the embedding in the
    # configuration's dtype (the port's storage)
    bf, f32 = "bfloat16", "float32"
    pre = "segments/0/0"
    return {
        "embed": ((d["V"], D), conf["dtype"], ("normal", STD)),
        "ln_f/scale": ((D,), f32, ("ones",)),
        f"{pre}/ln1/scale": ((L, D), f32, ("ones",)),
        f"{pre}/mixer/w_in": ((L, D, 2 * di + 2 * N + H), bf, ("normal", STD)),
        f"{pre}/mixer/conv_w": ((L, d["W"], di + 2 * N), bf, ("normal", CONV_STD)),
        f"{pre}/mixer/conv_b": ((L, di + 2 * N), f32, ("zeros",)),
        f"{pre}/mixer/A_log": ((L, H), f32, ("log_of_uniform", *s["A_init_range"])),
        f"{pre}/mixer/D": ((L, H), f32, ("ones",)),
        f"{pre}/mixer/dt_bias": ((L, H), f32,
                                 ("softplus_inverse_log_uniform", s["dt_min"], s["dt_max"])),
        f"{pre}/mixer/norm_w": ((L, di), f32, ("ones",)),
        f"{pre}/mixer/w_out": ((L, di, D), bf, ("normal", STD)),
    }


def ssd(x, a, Bm, Cm, Q: int, precision: str):
    """The SSD outputs without the skip: x (B,S,H,P) already times dt, a (B,S,H)
    = dt * A <= 0, Bm and Cm (B,S,N).  The sequence is padded with zeros to a
    whole number of chunks of Q and cut back."""
    Bb, S, H, P = x.shape
    pad = -S % Q
    if pad:
        x, a = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(a, (0, 0, 0, pad))
        Bm, Cm = F.pad(Bm, (0, 0, 0, pad)), F.pad(Cm, (0, 0, 0, pad))
    nc = x.shape[1] // Q
    x = x.reshape(Bb, nc, Q, H, P)
    cum = a.reshape(Bb, nc, Q, H).cumsum(2)
    Bc, Cc = Bm.reshape(Bb, nc, Q, -1), Cm.reshape(Bb, nc, Q, -1)
    # within a chunk: y_l = sum_{s <= l} (C_l . B_s) exp(cum_l - cum_s) x_s
    causal = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    seg = (cum[:, :, :, None, :] - cum[:, :, None, :, :]).masked_fill(
        ~causal[None, None, :, :, None], float("-inf"))                  # (B,nc,l,s,H)
    cb = plain.einsum("bcln,bcsn->bcls", Cc, Bc, precision)
    y = plain.einsum("bclsh,bcshp->bclhp", cb[..., None] * torch.exp(seg), x, precision)
    # each chunk's state: sum_s exp(cum_last - cum_s) B_s x_s^T
    w = torch.exp(cum[:, :, -1:, :] - cum)                                # (B,nc,Q,H)
    states = plain.einsum("bcsn,bcshp->bchnp", Bc, x * w[..., None], precision)
    decay = torch.exp(cum[:, :, -1, :])                                   # (B,nc,H)
    h = x.new_zeros(Bb, H, Bc.shape[-1], P)
    entering = []
    for c in range(nc):
        entering.append(h)
        h = h * decay[:, c, :, None, None] + states[:, c]
    entering = torch.stack(entering, 1)                                   # (B,nc,H,N,P)
    y = y + plain.einsum("bcln,bchnp->bclhp", Cc, entering, precision) * torch.exp(cum)[..., None]
    return y.reshape(Bb, nc * Q, H, P)[:, :S]


def _conv(u, w, b):
    """Depthwise causal convolution: u (B,S,C), w (W,C), b (C,)."""
    W, S = w.shape[0], u.shape[1]
    ext = F.pad(u, (0, 0, W - 1, 0))
    return sum(ext[:, i:i + S] * w[i] for i in range(W)) + b


def _layer(x, p, d: dict, eps: float, precision: str):
    Bb, S, _ = x.shape
    di, H, P, N = d["di"], d["H"], d["P"], d["N"]
    proj = plain.einsum("bsd,de->bse", plain.rms_norm(x, p["ln1"], eps), p["w_in"], precision)
    z, xbc, dt = proj[..., :di], proj[..., di:2 * di + 2 * N], proj[..., 2 * di + 2 * N:]
    xbc = F.silu(_conv(xbc, p["conv_w"], p["conv_b"]))
    xs = xbc[..., :di].reshape(Bb, S, H, P)
    Bm, Cm = xbc[..., di:di + N], xbc[..., di + N:]
    dt = F.softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y = ssd(xs * dt[..., None], dt * A, Bm, Cm, d["Q"], precision) + xs * p["D"][:, None]
    g = y.reshape(Bb, S, di) * F.silu(z)
    g = plain.rms_norm(g, p["norm_w"], eps)
    return x + plain.einsum("bse,ed->bsd", g, p["w_out"], precision)


def loss(params: dict, batch: dict, conf: dict, precision: str = "fp32") -> torch.Tensor:
    """The training loss of one batch: the mean cross-entropy."""
    d = _dims(conf)
    eps = conf["norm_epsilon"]
    tokens, labels, mask = plain.batch_tensors(batch, params["embed"].device)
    x = params["embed"][tokens]
    pre = "segments/0/0/"
    for i in range(d["L"]):
        p = {k[len(pre):].split("/")[-1]: v[i] for k, v in params.items() if k.startswith(pre)}
        p["ln1"] = p.pop("scale")
        x = checkpoint(_layer, x, p, d, eps, precision, use_reentrant=False)
    return plain.mean_xent(x.reshape(-1, d["D"]), params["ln_f/scale"], params["embed"].t(),
                           labels, mask, eps, precision)


def train(conf: dict, weights: dict, batches: list, opt: dict, seed: int,
          precision: str = "fp32") -> dict:
    """AdamW steps from ``weights`` (the benchmark's, by path; consumed), one a
    batch, in float32 or the control's precision; the readings of ``plain.train``
    (its gradient samples drawn from ``seed``)."""
    plain.no_tf32()
    params = {}
    for k in list(weights):
        params[k] = weights.pop(k).float()
    return plain.train(params, batches, opt, lambda p, b: loss(p, b, conf, precision), seed)
