"""qwen2.5-14b [dense] — 48L d_model=5120 40H (GQA kv=8) d_ff=13824
vocab=152064, GQA + QKV bias [hf:Qwen/Qwen2.5-14B; hf]."""

from .base import AttentionCfg, ModelCfg, Segment

CONFIG = ModelCfg(
    name="qwen2.5-14b",
    family="dense",
    d_model=5120,
    vocab=152064,
    d_ff=13824,
    segments=(Segment(pattern=("attn",), repeats=48, ffn="mlp"),),
    attn=AttentionCfg(n_heads=40, n_kv_heads=8, d_head=128, qkv_bias=True,
                      rope_theta=1_000_000.0),
    act="silu",
)


def smoke() -> ModelCfg:
    return ModelCfg(
        name="qwen2.5-smoke",
        family="dense",
        d_model=160,
        vocab=512,
        d_ff=384,
        segments=(Segment(pattern=("attn",), repeats=3, ffn="mlp"),),
        attn=AttentionCfg(n_heads=5, n_kv_heads=1, d_head=32, qkv_bias=True),
        remat="none",
        dtype="float32",
    )
