"""The benchmark's cells at the sizes of the port's ``smoke()`` configurations,
for runs on the CPU: every width cut, every kind of layer kept."""

from __future__ import annotations

import dataclasses

from onchip_bench import spec

DS_CELL, MB_CELL = "train.deepseek-v2-lite-16b.2x2048", "train.mamba2-780m.8x2048"

# configs/deepseek_v2_lite_16b.smoke() and configs/mamba2_780m.smoke() of the port
DS_SMOKE = dict(hidden_size=128, num_attention_heads=4, num_key_value_heads=4,
                qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32, kv_lora_rank=64,
                intermediate_size=256, n_routed_experts=8, n_shared_experts=2,
                num_experts_per_tok=2, moe_intermediate_size=64, vocab_size=512,
                num_hidden_layers=3)
# (the Mamba-2 vocabulary 500 where the port's smoke() has 512, so that the
# tied table holds 12 padded rows, as the cell's 50,288 hold 11)
MB_SMOKE = dict(d_model=96, n_layer=2, vocab_size=500)
MB_SMOKE_SSM = dict(d_state=16, headdim=24, chunk_size=8)


def cell(name: str, dtype: str = "bfloat16", batch: int = 2, seq_len: int = 32,
         **conf) -> spec.Cell:
    """The named cell of ``BENCHMARK.json`` at smoke sizes, in ``dtype``."""
    c = spec.resolve(spec.load_benchmark(), name)
    if c.config.startswith("deepseek"):
        new = dict(c.conf, **DS_SMOKE)
    else:
        new = dict(c.conf, **MB_SMOKE, ssm_cfg=dict(c.conf["ssm_cfg"], **MB_SMOKE_SSM))
    new.update(dtype=dtype, **conf)
    return dataclasses.replace(c, conf=new, traffic=dict(c.traffic, batch=batch, seq_len=seq_len))
