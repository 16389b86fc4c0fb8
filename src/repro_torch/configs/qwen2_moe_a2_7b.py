"""qwen2-moe-a2.7b [moe] — 24L d_model=2048 16H (kv=16) d_ff=1408(expert)
vocab=151936; 4 shared + 60 routed top-4 [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]."""

from .base import AttentionCfg, ModelCfg, MoECfg, Segment

CONFIG = ModelCfg(
    name="qwen2-moe-a2.7b",
    family="moe",
    d_model=2048,
    vocab=151936,
    d_ff=0,                          # every FFN is MoE
    segments=(Segment(pattern=("attn",), repeats=24, ffn="moe"),),
    attn=AttentionCfg(n_heads=16, n_kv_heads=16, d_head=128, qkv_bias=True,
                      rope_theta=1_000_000.0),
    moe=MoECfg(n_routed=60, n_shared=4, top_k=4, d_ff_expert=1408,
               d_ff_shared=5632, capacity_factor=1.25),
    act="silu",
)


def smoke() -> ModelCfg:
    return ModelCfg(
        name="qwen2moe-smoke",
        family="moe",
        d_model=128,
        vocab=512,
        d_ff=0,
        segments=(Segment(pattern=("attn",), repeats=2, ffn="moe"),),
        attn=AttentionCfg(n_heads=4, n_kv_heads=4, d_head=32, qkv_bias=True),
        moe=MoECfg(n_routed=6, n_shared=2, top_k=2, d_ff_expert=64,
                   d_ff_shared=128),
        remat="none",
        dtype="float32",
    )
