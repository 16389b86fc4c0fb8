"""mamba2-780m [ssm] — 48L d_model=1536 (attention-free) vocab=50280,
ssm_state=128, SSD state-space duality [arXiv:2405.21060].

Pure Mamba-2: every block is an SSD mixer, no FFN (d_ff=0); attention-free
=> the long_500k cell RUNS.  Vocab 50280 is padded to 50432 (multiple of
256) for TP-friendly sharding."""

from .base import AttentionCfg, ModelCfg, Segment, SSDCfg

CONFIG = ModelCfg(
    name="mamba2-780m",
    family="ssm",
    d_model=1536,
    vocab=50280,
    d_ff=0,
    segments=(Segment(pattern=("ssd",), repeats=48, ffn="none"),),
    attn=AttentionCfg(n_heads=24, n_kv_heads=24, d_head=64),   # unused (attn-free)
    ssd=SSDCfg(d_state=128, headdim=64, expand=2, chunk=256, conv_width=4),
    act="silu",
    tie_embeddings=True,
)


def smoke() -> ModelCfg:
    return ModelCfg(
        name="mamba2-smoke",
        family="ssm",
        d_model=96,
        vocab=512,
        d_ff=0,
        segments=(Segment(pattern=("ssd",), repeats=2, ffn="none"),),
        ssd=SSDCfg(d_state=16, headdim=24, expand=2, chunk=8, conv_width=4),
        tie_embeddings=True,
        remat="none",
        dtype="float32",
    )
