"""qwen2-7b [dense] — 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064, GQA + QKV bias [arXiv:2407.10671; hf]."""

from .base import AttentionCfg, ModelCfg, Segment

CONFIG = ModelCfg(
    name="qwen2-7b",
    family="dense",
    d_model=3584,
    vocab=152064,
    d_ff=18944,
    segments=(Segment(pattern=("attn",), repeats=28, ffn="mlp"),),
    attn=AttentionCfg(n_heads=28, n_kv_heads=4, d_head=128, qkv_bias=True,
                      rope_theta=1_000_000.0),
    act="silu",
)


def smoke() -> ModelCfg:
    return ModelCfg(
        name="qwen2-smoke",
        family="dense",
        d_model=112,
        vocab=512,
        d_ff=320,
        segments=(Segment(pattern=("attn",), repeats=2, ffn="mlp"),),
        attn=AttentionCfg(n_heads=7, n_kv_heads=1, d_head=16, qkv_bias=True),
        remat="none",
        dtype="float32",
    )
