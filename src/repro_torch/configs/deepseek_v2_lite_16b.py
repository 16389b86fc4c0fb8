"""deepseek-v2-lite-16b [moe] — 27L d_model=2048 16H d_ff=1408(expert)
vocab=102400; MLA kv_lora=512; MoE top-6 [arXiv:2405.04434; hf].

Assignment-header discrepancy ("64e top-6" vs "160 routed"): resolved to the
hf DeepSeek-V2-Lite card — 64 routed + 2 shared experts, top-6 routing,
expert d_ff 1408; layer 0 is a dense MLP (d_ff 10944), layers 1..26 are MoE
(see DESIGN.md §Arch-applicability)."""

from .base import AttentionCfg, ModelCfg, MoECfg, Segment

CONFIG = ModelCfg(
    name="deepseek-v2-lite-16b",
    family="moe",
    d_model=2048,
    vocab=102400,
    d_ff=10944,                      # dense first-layer FFN (hf card)
    segments=(
        Segment(pattern=("mla",), repeats=1, ffn="mlp"),
        Segment(pattern=("mla",), repeats=26, ffn="moe"),
    ),
    attn=AttentionCfg(
        n_heads=16, n_kv_heads=16, d_head=128,
        kv_lora_rank=512, q_lora_rank=None,
        rope_head_dim=64, nope_head_dim=128, v_head_dim=128,
        rope_theta=10_000.0,
    ),
    moe=MoECfg(n_routed=64, n_shared=2, top_k=6, d_ff_expert=1408,
               d_ff_shared=2816, capacity_factor=1.25),
    act="silu",
)


def smoke() -> ModelCfg:
    return ModelCfg(
        name="deepseek-smoke",
        family="moe",
        d_model=128,
        vocab=512,
        d_ff=256,
        segments=(
            Segment(pattern=("mla",), repeats=1, ffn="mlp"),
            Segment(pattern=("mla",), repeats=2, ffn="moe"),
        ),
        attn=AttentionCfg(n_heads=4, n_kv_heads=4, d_head=32,
                          kv_lora_rank=64, rope_head_dim=16,
                          nope_head_dim=32, v_head_dim=32),
        moe=MoECfg(n_routed=8, n_shared=2, top_k=2, d_ff_expert=64,
                   d_ff_shared=128),
        remat="none",
        dtype="float32",
    )
