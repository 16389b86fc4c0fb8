"""The work of ``deepseek-v2-lite-16b.dense1-moe3`` counted from its shapes: the
model FLOPs of a training step (``mfu``'s numerator) and the operations and
bytes of one call of the port's attention kernels K3 (forward) and S2
(backward), from which their roofline bounds follow.

Model FLOPs: 6 x the matmul parameters a token touches (MLA's projections, the
dense MLP, the router, 6 of the 64 routed experts and the shared ones, the
output head; the embedding gather is no product), plus attention's causal score
and value products x 3 (forward and backward), with no remat recompute.  A
causal pass over S positions takes S (S + 1) / 2 query-key pairs.

Kernel work: K3 takes 2 (Dqk + Dv) operations a pair (Q K^T, P V); S2 takes
2 (3 Dqk + 2 Dv) a pair (S = Q K^T again, dP = dO V^T, dV = P^T dO, dQ = dS K,
dK = dS^T Q).  Bytes: each input read once and each output written once, two
bytes an element: K3 reads q, k, v and writes o and each row's lse; S2 reads q,
k, v, o, dO and lse and writes dq, dk, dv.
"""

from __future__ import annotations


def _dims(conf: dict) -> dict:
    n_dense = conf["first_k_dense_replace"]
    return dict(D=conf["hidden_size"], H=conf["num_attention_heads"],
                nope=conf["qk_nope_head_dim"], rope=conf["qk_rope_head_dim"],
                dv=conf["v_head_dim"], r=conf["kv_lora_rank"], F=conf["intermediate_size"],
                E=conf["n_routed_experts"], K=conf["num_experts_per_tok"],
                Fe=conf["moe_intermediate_size"],
                Fs=conf["n_shared_experts"] * conf["moe_intermediate_size"],
                V=conf["vocab_size"], n_dense=n_dense,
                n_moe=conf["num_hidden_layers"] - n_dense, L=conf["num_hidden_layers"])


def matmul_params_per_token(conf: dict) -> int:
    d = _dims(conf)
    D, H, r = d["D"], d["H"], d["r"]
    mla = (D * H * (d["nope"] + d["rope"]) + D * r + D * d["rope"] + r * H * d["nope"]
           + r * H * d["dv"] + H * d["dv"] * D)
    dense = 3 * D * d["F"]
    moe = D * d["E"] + d["K"] * 3 * D * d["Fe"] + 3 * D * d["Fs"]
    return d["L"] * mla + d["n_dense"] * dense + d["n_moe"] * moe + D * d["V"]


def _pairs(seq: int) -> int:
    return seq * (seq + 1) // 2


def attention_flops_forward(conf: dict, batch: int, seq: int) -> int:
    """Score and value products of every layer's causal attention, forward."""
    d = _dims(conf)
    return d["L"] * 2 * batch * d["H"] * _pairs(seq) * (d["nope"] + d["rope"] + d["dv"])


def model_flops(conf: dict, traffic: dict) -> int:
    """Model FLOPs of one training step."""
    B, S = traffic["batch"], traffic["seq_len"]
    return 6 * matmul_params_per_token(conf) * B * S + 3 * attention_flops_forward(conf, B, S)


def kernel_work(conf: dict, traffic: dict) -> dict:
    """``{family: (operations, bytes)}`` of one call of each kernel family."""
    d = _dims(conf)
    B, S, H, dqk, dv = traffic["batch"], traffic["seq_len"], d["H"], d["nope"] + d["rope"], d["dv"]
    pairs = B * H * _pairs(S)
    rows = B * S * H
    return {
        "k3": (2 * pairs * (dqk + dv), 2 * (rows * (2 * dqk + 2 * dv) + rows)),
        "s2": (2 * pairs * (3 * dqk + 2 * dv), 2 * (rows * (4 * dqk + 4 * dv) + rows)),
    }
