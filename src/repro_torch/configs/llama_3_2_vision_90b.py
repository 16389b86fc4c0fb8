"""llama-3.2-vision-90b [vlm] — 100L d_model=8192 64H (GQA kv=8)
d_ff=28672 vocab=128256; cross-attn image layers
[hf:meta-llama/Llama-3.2-90B-Vision].

80 self-attention + 20 gated cross-attention layers, interleaved 4:1.  The
vision frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed patch embeddings (B, 1600, 1280) which a learned projection maps
to d_model.  Full quadratic attention => long_500k cell SKIPPED."""

from .base import AttentionCfg, ModelCfg, Segment

CONFIG = ModelCfg(
    name="llama-3.2-vision-90b",
    family="vlm",
    d_model=8192,
    vocab=128256,
    d_ff=28672,
    segments=(
        Segment(pattern=("attn", "attn", "attn", "attn", "cross_attn"),
                repeats=20, ffn="mlp"),
    ),
    attn=AttentionCfg(n_heads=64, n_kv_heads=8, d_head=128,
                      rope_theta=500_000.0),
    act="silu",
    frontend="vision_patches",
    frontend_tokens=1600,
    frontend_dim=1280,
)


def smoke() -> ModelCfg:
    return ModelCfg(
        name="llamavis-smoke",
        family="vlm",
        d_model=128,
        vocab=512,
        d_ff=256,
        segments=(
            Segment(pattern=("attn", "attn", "cross_attn"), repeats=2, ffn="mlp"),
        ),
        attn=AttentionCfg(n_heads=4, n_kv_heads=2, d_head=32),
        frontend="vision_patches",
        frontend_tokens=16,
        frontend_dim=48,
        remat="none",
        dtype="float32",
    )
