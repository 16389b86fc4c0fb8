"""Model / run configuration dataclasses.

A model is a sequence of *segments*; each segment is a repeated *group* of
layer blocks (e.g. RecurrentGemma's (rec, rec, local_attn) x 12).  Repeated
groups are `lax.scan`ned over stacked parameters so compile time is O(#block
kinds), not O(#layers) — essential for the 512-device dry-run compiles.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Union


@dataclass(frozen=True)
class AttentionCfg:
    kind: str = "gqa"                 # gqa | mla | local | cross
    n_heads: int = 8
    n_kv_heads: int = 8
    d_head: int = 64
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    rope_dim: Optional[int] = None    # None = full head dim
    window: Optional[int] = None      # sliding window (local attention)
    # MLA (DeepSeek-V2) parameters
    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = None
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128
    logit_softcap: Optional[float] = None


@dataclass(frozen=True)
class MoECfg:
    n_routed: int = 8
    n_shared: int = 0
    top_k: int = 2
    d_ff_expert: int = 1024
    d_ff_shared: Optional[int] = None  # default: n_shared * d_ff_expert
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001


@dataclass(frozen=True)
class RGLRUCfg:
    d_rnn: Optional[int] = None       # default d_model
    conv_width: int = 4
    n_heads: int = 0                  # block-diagonal gates (0 = dense proj)
    c: float = 8.0                    # RG-LRU temperature


@dataclass(frozen=True)
class SSDCfg:
    d_state: int = 128
    headdim: int = 64
    expand: int = 2
    chunk: int = 256
    conv_width: int = 4


@dataclass(frozen=True)
class Segment:
    """``pattern`` is a tuple of block kinds, repeated ``repeats`` times.
    Kinds: attn | local_attn | enc_attn | mla | cross_attn | rglru | ssd
    (each block includes its norms/residual and is followed by its ffn).
    ``ffn`` is one kind for every position, or a tuple per position —
    e.g. an enc-dec decoder layer is pattern ("attn","cross_attn") with
    ffn ("none","mlp")."""

    pattern: tuple[str, ...]
    repeats: int
    ffn: Union[str, tuple[str, ...]] = "mlp"   # mlp | moe | none

    def ffn_at(self, pos: int) -> str:
        return self.ffn if isinstance(self.ffn, str) else self.ffn[pos]


@dataclass(frozen=True)
class ModelCfg:
    name: str
    family: str                       # dense | moe | hybrid | ssm | vlm | audio
    d_model: int
    vocab: int
    segments: tuple[Segment, ...]
    attn: AttentionCfg = AttentionCfg()
    d_ff: int = 0
    act: str = "silu"
    norm: str = "rmsnorm"             # rmsnorm | rmsnorm_p1 (gemma +1)
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    moe: Optional[MoECfg] = None
    rglru: Optional[RGLRUCfg] = None
    ssd: Optional[SSDCfg] = None
    # encoder (enc-dec models); the encoder reuses attn cfg, bidirectional
    encoder_segments: tuple[Segment, ...] = ()
    cross_attn_from_encoder: bool = False
    # modality frontend stub: inputs arrive as precomputed embeddings
    frontend: Optional[str] = None    # None | "vision_patches" | "audio_frames"
    frontend_tokens: int = 0          # stub sequence length
    frontend_dim: int = 0
    # numerics / memory
    dtype: str = "bfloat16"
    remat: str = "block"              # none | block (remat each scanned block)
    logit_softcap: Optional[float] = None
    scale_embeddings: bool = False    # gemma-style sqrt(d_model) embed scale
    max_seq_len: int = 1 << 20

    pad_vocab_multiple: int = 256     # embedding-table padding (TP-friendly)

    @property
    def padded_vocab(self) -> int:
        m = self.pad_vocab_multiple
        return -(-self.vocab // m) * m

    @property
    def n_layers(self) -> int:
        n = sum(len(s.pattern) * s.repeats for s in self.segments)
        return n

    def scaled(self, **kw) -> "ModelCfg":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeCfg:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                         # train | prefill | decode
    # microbatching (gradient accumulation) for train shapes
    num_microbatches: int = 1


SHAPES: dict[str, ShapeCfg] = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524288, 1, "decode"),
}
