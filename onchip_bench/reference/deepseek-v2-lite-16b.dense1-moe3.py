"""Plain float32 reference of ``deepseek-v2-lite-16b.dense1-moe3`` (DeepSeek-V2-Lite,
arXiv:2405.04434, cut to its dense layer and 3 MoE layers), as its configuration
file states it, departures included.

Per layer: RMSNorm; multi-head latent attention without a query latent: q = h Wq
split into (nope 128, rope 64), c_kv = RMSNorm(h W_dkv) of rank 512, a shared
rotary key k_pe = RoPE(h W_kpe), per-head keys [c_kv W_uk, k_pe] and values
c_kv W_uv, causal softmax at (nope + rope) ** -0.5, out W_o; RMSNorm; then the
dense SwiGLU (layer 0) or the MoE: a float32 router, softmax over 64 experts,
top-6 gates renormalised, each expert keeping its first ceil(1.25 T k / E)
arrivals in token order (the rest fall through), SwiGLU experts of 1408, 2
shared experts as one SwiGLU of 2816, and the balance loss alpha * E *
sum_e mean_prob_e * share_of_slots_e over the batch.  Final RMSNorm, an untied
head, the mean cross-entropy plus the balance losses.  RoPE rotates
interleaved pairs, its angles taken in float64.

Attention runs in blocks of query rows, each recomputed in the backward, and
each layer is recomputed in its backward, so the 16k cell fits beside the
float32 optimizer state.  Parameters are named and stacked as the port's tree
holds them (a segment's layers on the first dim); ``param_specs`` lists them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from onchip_bench import plain

ATTN_BLOCK = 1024      # query rows a block of attention takes
STD = 0.02             # every matrix is drawn N(0, STD^2)


def _dims(conf: dict) -> dict:
    n_dense = conf["first_k_dense_replace"]
    return dict(D=conf["hidden_size"], H=conf["num_attention_heads"],
                nope=conf["qk_nope_head_dim"], rope=conf["qk_rope_head_dim"],
                dv=conf["v_head_dim"], r=conf["kv_lora_rank"], F=conf["intermediate_size"],
                E=conf["n_routed_experts"], K=conf["num_experts_per_tok"],
                Fe=conf["moe_intermediate_size"], Fs=conf["n_shared_experts"]
                * conf["moe_intermediate_size"],
                V=conf["vocab_size"], n_dense=n_dense,
                n_moe=conf["num_hidden_layers"] - n_dense)


def param_specs(conf: dict) -> dict:
    """``{path: (shape, dtype, init)}`` of every parameter, by the port's paths."""
    d = _dims(conf)
    D, H, qd, r, E = d["D"], d["H"], d["nope"] + d["rope"], d["r"], d["E"]
    # the layers' matrices are stored in bfloat16, the embedding and head in
    # the configuration's dtype (the port's storage)
    bf, f32, normal, ones = "bfloat16", "float32", ("normal", STD), ("ones",)
    specs = {"embed": ((d["V"], D), conf["dtype"], normal),
             "lm_head": ((D, d["V"]), conf["dtype"], normal),
             "ln_f/scale": ((D,), f32, ones)}
    for seg, n, ffn in ((0, d["n_dense"], "mlp"), (1, d["n_moe"], "moe")):
        pre = f"segments/{seg}/0"
        specs.update({
            f"{pre}/ln1/scale": ((n, D), f32, ones), f"{pre}/ln2/scale": ((n, D), f32, ones),
            f"{pre}/mixer/wq": ((n, D, H, qd), bf, normal),
            f"{pre}/mixer/w_dkv": ((n, D, r), bf, normal),
            f"{pre}/mixer/w_kpe": ((n, D, d["rope"]), bf, normal),
            f"{pre}/mixer/w_uk": ((n, r, H, d["nope"]), bf, normal),
            f"{pre}/mixer/w_uv": ((n, r, H, d["dv"]), bf, normal),
            f"{pre}/mixer/wo": ((n, H, d["dv"], D), bf, normal),
            f"{pre}/mixer/kv_norm": ((n, r), f32, ones),
        })
        if ffn == "mlp":
            specs.update({f"{pre}/ffn/w_gate": ((n, D, d["F"]), bf, normal),
                          f"{pre}/ffn/w_up": ((n, D, d["F"]), bf, normal),
                          f"{pre}/ffn/w_down": ((n, d["F"], D), bf, normal)})
        else:
            specs.update({f"{pre}/ffn/router": ((n, D, E), f32, normal),
                          f"{pre}/ffn/w_gate": ((n, E, D, d["Fe"]), bf, normal),
                          f"{pre}/ffn/w_up": ((n, E, D, d["Fe"]), bf, normal),
                          f"{pre}/ffn/w_down": ((n, E, d["Fe"], D), bf, normal),
                          f"{pre}/ffn/shared/w_gate": ((n, D, d["Fs"]), bf, normal),
                          f"{pre}/ffn/shared/w_up": ((n, D, d["Fs"]), bf, normal),
                          f"{pre}/ffn/shared/w_down": ((n, d["Fs"], D), bf, normal)})
    return specs


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, [H,] d): interleaved pairs rotated by position * theta^(-2i/d)."""
    S, d = x.shape[1], x.shape[-1]
    inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float64, device=x.device) / d)
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * inv[None, :]
    cos, sin = torch.cos(ang).float(), torch.sin(ang).float()
    if x.ndim == 4:
        cos, sin = cos[:, None, :], sin[:, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).flatten(-2)


def _attend_block(q, k, v, q0: int, scale: float, precision: str):
    s = plain.einsum("bqhd,bkhd->bhqk", q, k, precision) * scale
    qi = q0 + torch.arange(q.shape[1], device=q.device)
    ki = torch.arange(k.shape[1], device=q.device)
    s = s.masked_fill(ki[None, :] > qi[:, None], float("-inf"))
    return plain.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v, precision)


def _attention(q, k, v, scale: float, precision: str):
    """Causal attention in blocks of query rows: a block sees keys up to its end."""
    S = q.shape[1]
    out = [checkpoint(_attend_block, q[:, q0:q0 + ATTN_BLOCK], k[:, :q0 + ATTN_BLOCK],
                      v[:, :q0 + ATTN_BLOCK], q0, scale, precision, use_reentrant=False)
           for q0 in range(0, S, ATTN_BLOCK)]
    return torch.cat(out, 1)


def _mla(p, h, d: dict, conf: dict, precision: str):
    B, S, _ = h.shape
    q = plain.einsum("bsd,dhe->bshe", h, p["wq"], precision)
    q_nope, q_pe = q[..., :d["nope"]], _rope(q[..., d["nope"]:], conf["rope_theta"])
    c_kv = plain.rms_norm(plain.einsum("bsd,dr->bsr", h, p["w_dkv"], precision), p["kv_norm"],
                          conf["rms_norm_eps"])
    k_pe = _rope(plain.einsum("bsd,de->bse", h, p["w_kpe"], precision), conf["rope_theta"])
    k_nope = plain.einsum("bsr,rhe->bshe", c_kv, p["w_uk"], precision)
    v = plain.einsum("bsr,rhe->bshe", c_kv, p["w_uv"], precision)
    q = torch.cat([q_nope, q_pe], -1)
    k = torch.cat([k_nope, k_pe[:, :, None, :].expand(B, S, d["H"], d["rope"])], -1)
    o = _attention(q, k, v, (d["nope"] + d["rope"]) ** -0.5, precision)
    return plain.einsum("bshe,hed->bsd", o, p["wo"], precision)


def _swiglu(x, w_gate, w_up, w_down, precision: str):
    h = F.silu(plain.einsum("td,df->tf", x, w_gate, precision)) * \
        plain.einsum("td,df->tf", x, w_up, precision)
    return plain.einsum("tf,fd->td", h, w_down, precision)


def capacity(tokens: int, d: dict, conf: dict) -> int:
    return max(1, math.ceil(tokens * d["K"] * conf["capacity_factor"] / d["E"]))


def _moe(p, x, d: dict, conf: dict, precision: str):
    """x (T, D).  Returns (y (T, D), balance loss)."""
    T, E, K = x.shape[0], d["E"], d["K"]
    probs = torch.softmax(plain.einsum("td,de->te", x, p["router"], precision), -1)
    top, idx = probs.topk(K, -1)
    gates = top / top.sum(-1, keepdim=True).clamp(min=1e-9)
    chosen = torch.zeros(T, E, device=x.device).scatter_(1, idx, 1.0)
    before = torch.cumsum(chosen, 0) - chosen          # earlier arrivals at each expert
    kept = (chosen > 0) & (before < capacity(T, d, conf))
    gate_of = torch.zeros(T, E, device=x.device).scatter(1, idx, gates)
    y = torch.zeros_like(x)
    for e in range(E):
        rows = kept[:, e].nonzero()[:, 0]
        if rows.numel():
            ye = _swiglu(x[rows], p["w_gate"][e], p["w_up"][e], p["w_down"][e], precision)
            y = y.index_add(0, rows, ye * gate_of[rows, e, None])
    sh = p["shared"]
    y = y + _swiglu(x, sh["w_gate"], sh["w_up"], sh["w_down"], precision)
    share = chosen.sum(0) / (T * K)
    return y, conf["aux_loss_alpha"] * E * (probs.mean(0) * share).sum()


def _layer(x, p, ffn: str, d: dict, conf: dict, precision: str):
    B, S, D = x.shape
    eps = conf["rms_norm_eps"]
    x = x + _mla(p["mixer"], plain.rms_norm(x, p["ln1"], eps), d, conf, precision)
    h = plain.rms_norm(x, p["ln2"], eps).reshape(B * S, D)
    if ffn == "mlp":
        f, aux = _swiglu(h, p["ffn"]["w_gate"], p["ffn"]["w_up"], p["ffn"]["w_down"],
                         precision), x.new_zeros(())
    else:
        f, aux = _moe(p["ffn"], h, d, conf, precision)
    return x + f.reshape(B, S, D), aux


def _layer_params(params: dict, seg: int, i: int) -> dict:
    """Layer ``i`` of segment ``seg`` as a nested dict of views."""
    pre = f"segments/{seg}/0/"
    out: dict = {}
    for path, t in params.items():
        if path.startswith(pre):
            keys = path[len(pre):].split("/")
            node = out
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = t[i]
    out["ln1"], out["ln2"] = out["ln1"]["scale"], out["ln2"]["scale"]
    return out


def loss(params: dict, batch: dict, conf: dict, precision: str = "fp32") -> torch.Tensor:
    """The training loss of one batch: mean cross-entropy plus balance losses."""
    d = _dims(conf)
    device = params["embed"].device
    tokens, labels, mask = plain.batch_tensors(batch, device)
    x = params["embed"][tokens]
    aux = x.new_zeros(())
    for seg, n, ffn in ((0, d["n_dense"], "mlp"), (1, d["n_moe"], "moe")):
        for i in range(n):
            x, a = checkpoint(_layer, x, _layer_params(params, seg, i), ffn, d, conf, precision,
                              use_reentrant=False)
            aux = aux + a
    xent = plain.mean_xent(x.reshape(-1, d["D"]), params["ln_f/scale"], params["lm_head"],
                           labels, mask, conf["rms_norm_eps"], precision)
    return xent + aux


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
