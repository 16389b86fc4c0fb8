"""tinyllama-1.1b [dense] — 22L d_model=2048 32H (GQA kv=4) d_ff=5632
vocab=32000, llama2-arch small [arXiv:2401.02385; hf]."""

from .base import AttentionCfg, ModelCfg, Segment

CONFIG = ModelCfg(
    name="tinyllama-1.1b",
    family="dense",
    d_model=2048,
    vocab=32000,
    d_ff=5632,
    segments=(Segment(pattern=("attn",), repeats=22, ffn="mlp"),),
    attn=AttentionCfg(n_heads=32, n_kv_heads=4, d_head=64, rope_theta=10_000.0),
    act="silu",
)


def smoke() -> ModelCfg:
    return ModelCfg(
        name="tinyllama-smoke",
        family="dense",
        d_model=128,
        vocab=512,
        d_ff=352,
        segments=(Segment(pattern=("attn",), repeats=2, ffn="mlp"),),
        attn=AttentionCfg(n_heads=8, n_kv_heads=2, d_head=16),
        remat="none",
        dtype="float32",
    )
