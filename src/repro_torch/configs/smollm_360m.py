"""smollm-360m [dense] — 32L d_model=960 15H (GQA kv=5) d_ff=2560
vocab=49152, llama-arch small [hf:HuggingFaceTB/SmolLM-360M; hf]."""

from .base import AttentionCfg, ModelCfg, Segment

CONFIG = ModelCfg(
    name="smollm-360m",
    family="dense",
    d_model=960,
    vocab=49152,
    d_ff=2560,
    segments=(Segment(pattern=("attn",), repeats=32, ffn="mlp"),),
    attn=AttentionCfg(n_heads=15, n_kv_heads=5, d_head=64, rope_theta=10_000.0),
    act="silu",
    tie_embeddings=True,
)


def smoke() -> ModelCfg:
    return ModelCfg(
        name="smollm-smoke",
        family="dense",
        d_model=96,
        vocab=512,
        d_ff=256,
        segments=(Segment(pattern=("attn",), repeats=2, ffn="mlp"),),
        attn=AttentionCfg(n_heads=3, n_kv_heads=1, d_head=32),
        tie_embeddings=True,
        remat="none",
        dtype="float32",
    )
