"""seamless-m4t-medium [audio] — 12L d_model=1024 16H (kv=16) d_ff=4096
vocab=256206; encoder-decoder, multimodal [arXiv:2308.11596; hf].

Encoder: 12 bidirectional layers over precomputed audio-frame embeddings
(the speech frontend is a STUB per the assignment: ``input_specs()``
supplies (B, 1024, 1024) frame features).  Decoder: 12 layers of
(self-attn, cross-attn) with one FFN per layer after the cross block.
Decode shapes RUN (there is a decoder); full attention => long_500k
SKIPPED."""

from .base import AttentionCfg, ModelCfg, Segment

CONFIG = ModelCfg(
    name="seamless-m4t-medium",
    family="audio",
    d_model=1024,
    vocab=256206,
    d_ff=4096,
    segments=(
        Segment(pattern=("attn", "cross_attn"), repeats=12, ffn=("none", "mlp")),
    ),
    encoder_segments=(Segment(pattern=("enc_attn",), repeats=12, ffn="mlp"),),
    attn=AttentionCfg(n_heads=16, n_kv_heads=16, d_head=64, rope_theta=10_000.0),
    act="relu",
    frontend="audio_frames",
    frontend_tokens=1024,
    frontend_dim=1024,
    cross_attn_from_encoder=True,
)


def smoke() -> ModelCfg:
    return ModelCfg(
        name="seamless-smoke",
        family="audio",
        d_model=64,
        vocab=512,
        d_ff=128,
        segments=(
            Segment(pattern=("attn", "cross_attn"), repeats=2, ffn=("none", "mlp")),
        ),
        encoder_segments=(Segment(pattern=("enc_attn",), repeats=2, ffn="mlp"),),
        attn=AttentionCfg(n_heads=4, n_kv_heads=4, d_head=16),
        act="relu",
        frontend="audio_frames",
        frontend_tokens=16,
        frontend_dim=64,
        cross_attn_from_encoder=True,
        remat="none",
        dtype="float32",
    )
