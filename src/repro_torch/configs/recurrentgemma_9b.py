"""recurrentgemma-9b [hybrid] — 38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000; RG-LRU + local attention 2:1 [arXiv:2402.19427].

Griffin pattern: (rglru, rglru, local_attn) x 12 + (rglru, rglru) = 38
blocks; sliding window 2048 => sub-quadratic => the long_500k cell RUNS for
this arch.  Gemma-isms: rmsnorm(+1), sqrt(d_model) embedding scale, gelu,
tied embeddings, final logit softcap 30."""

from .base import AttentionCfg, ModelCfg, RGLRUCfg, Segment

CONFIG = ModelCfg(
    name="recurrentgemma-9b",
    family="hybrid",
    d_model=4096,
    vocab=256000,
    d_ff=12288,
    segments=(
        Segment(pattern=("rglru", "rglru", "local_attn"), repeats=12, ffn="mlp"),
        Segment(pattern=("rglru", "rglru"), repeats=1, ffn="mlp"),
    ),
    attn=AttentionCfg(n_heads=16, n_kv_heads=1, d_head=256, window=2048,
                      rope_theta=10_000.0),
    rglru=RGLRUCfg(d_rnn=4096, conv_width=4, c=8.0),
    act="gelu_tanh",
    norm="rmsnorm_p1",
    tie_embeddings=True,
    scale_embeddings=True,
    logit_softcap=30.0,
)


def smoke() -> ModelCfg:
    return ModelCfg(
        name="rg-smoke",
        family="hybrid",
        d_model=128,
        vocab=512,
        d_ff=256,
        segments=(
            Segment(pattern=("rglru", "rglru", "local_attn"), repeats=2, ffn="mlp"),
        ),
        attn=AttentionCfg(n_heads=4, n_kv_heads=1, d_head=32, window=16),
        rglru=RGLRUCfg(d_rnn=128, conv_width=4, c=8.0),
        act="gelu_tanh",
        norm="rmsnorm_p1",
        tie_embeddings=True,
        scale_embeddings=True,
        logit_softcap=30.0,
        remat="none",
        dtype="float32",
    )
