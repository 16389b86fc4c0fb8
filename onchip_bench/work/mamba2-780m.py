"""The work of ``mamba2-780m`` counted from its shapes: the model FLOPs of a
training step (``mfu``'s numerator) and the operations and bytes of one call of
the port's SSD kernels K5 (forward) and S3 (backward), from which their roofline
bounds follow.

Model FLOPs: 6 x the matmul parameters a token touches (each layer's in- and
out-projections, the tied head; the embedding gather is no product and the
depthwise convolution no matmul), plus the SSD's chunked products x 3 (forward
and backward), with no remat recompute.

The SSD's chunked products, a chunk of Q positions, one group of B and C shared
by the heads: C B^T over the chunk's causal pairs Q (Q + 1) / 2 (2 N operations
a pair, once for all heads); for each head the decay-masked scores times x (2 P a
pair), the chunk's state B^T x (2 Q N P) and the outputs C h of the state
entering the chunk (2 Q N P).  K5 does these; S3 twice as many (each product's
gradient with respect to both operands).  Bytes: each input read once and each
output written once, two bytes an element: K5 reads x dt (B,S,H,P), dt A
(B,S,H), B and C (B,S,N) and writes y (B,S,H,P); S3 reads those inputs and dy
and writes their gradients.
"""

from __future__ import annotations


def _dims(conf: dict) -> dict:
    s = conf["ssm_cfg"]
    di = s["expand"] * conf["d_model"]
    m = conf["pad_vocab_size_multiple"]
    return dict(D=conf["d_model"], L=conf["n_layer"], di=di, P=s["headdim"],
                H=di // s["headdim"], N=s["d_state"], Q=s["chunk_size"],
                V=-(-conf["vocab_size"] // m) * m)


def matmul_params_per_token(conf: dict) -> int:
    d = _dims(conf)
    D, di, N, H = d["D"], d["di"], d["N"], d["H"]
    return d["L"] * (D * (2 * di + 2 * N + H) + di * D) + d["V"] * D


def ssd_flops_forward(conf: dict, batch: int, seq: int) -> int:
    """One layer's chunked SSD products, forward."""
    d = _dims(conf)
    Q, N, P, H = d["Q"], d["N"], d["P"], d["H"]
    chunks = batch * -(-seq // Q)
    pairs = Q * (Q + 1) // 2
    return chunks * (2 * pairs * N + H * (2 * pairs * P + 4 * Q * N * P))


def model_flops(conf: dict, traffic: dict) -> int:
    """Model FLOPs of one training step."""
    B, S = traffic["batch"], traffic["seq_len"]
    return (6 * matmul_params_per_token(conf) * B * S
            + 3 * _dims(conf)["L"] * ssd_flops_forward(conf, B, S))


def kernel_work(conf: dict, traffic: dict) -> dict:
    """``{family: (operations, bytes)}`` of one call of each kernel family."""
    d = _dims(conf)
    B, S = traffic["batch"], traffic["seq_len"]
    x, a, bc = B * S * d["H"] * d["P"], B * S * d["H"], 2 * B * S * d["N"]
    flops = ssd_flops_forward(conf, B, S)
    return {"k5": (flops, 2 * (x + a + bc + x)),
            "s3": (2 * flops, 2 * (2 * (x + a + bc) + x))}
