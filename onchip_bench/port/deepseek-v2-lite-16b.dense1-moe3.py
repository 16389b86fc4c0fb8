"""The port's model configuration (``repro_torch.configs.base.ModelCfg``) for the
configuration file ``configs/deepseek-v2-lite-16b.dense1-moe3.json``.  Refuses a
file that states what the port cannot run."""

from __future__ import annotations

from repro_torch.configs.base import AttentionCfg, ModelCfg, MoECfg, Segment


def model_cfg(conf: dict) -> ModelCfg:
    if conf["rope_scaling"]["type"] != "none":
        raise ValueError(f"{conf['name']}: the port applies no rope scaling, the file states "
                         f"{conf['rope_scaling']['type']!r}")
    wanted = {"norm_topk_prob": True, "seq_aux": False, "q_lora_rank": None,
              "scoring_func": "softmax", "topk_method": "greedy", "routed_scaling_factor": 1,
              "attention_bias": False, "moe_layer_freq": 1, "hidden_act": "silu",
              "tie_word_embeddings": False}
    for key, value in wanted.items():
        if conf[key] != value:
            raise ValueError(f"{conf['name']}: the port runs {key} = {value!r} only, "
                             f"the file states {conf[key]!r}")
    if conf["num_key_value_heads"] != conf["num_attention_heads"]:
        raise ValueError(f"{conf['name']}: MLA's key-value heads must equal its heads")
    n_dense = conf["first_k_dense_replace"]
    return ModelCfg(
        name=conf["name"], family="moe", d_model=conf["hidden_size"], vocab=conf["vocab_size"],
        d_ff=conf["intermediate_size"],
        segments=(Segment(("mla",), n_dense, "mlp"),
                  Segment(("mla",), conf["num_hidden_layers"] - n_dense, "moe")),
        attn=AttentionCfg(n_heads=conf["num_attention_heads"],
                          n_kv_heads=conf["num_key_value_heads"],
                          d_head=conf["qk_nope_head_dim"], kv_lora_rank=conf["kv_lora_rank"],
                          q_lora_rank=None, rope_head_dim=conf["qk_rope_head_dim"],
                          nope_head_dim=conf["qk_nope_head_dim"], v_head_dim=conf["v_head_dim"],
                          rope_theta=float(conf["rope_theta"])),
        moe=MoECfg(n_routed=conf["n_routed_experts"], n_shared=conf["n_shared_experts"],
                   top_k=conf["num_experts_per_tok"], d_ff_expert=conf["moe_intermediate_size"],
                   d_ff_shared=conf["n_shared_experts"] * conf["moe_intermediate_size"],
                   capacity_factor=conf["capacity_factor"],
                   router_aux_coef=conf["aux_loss_alpha"]),
        act=conf["hidden_act"], norm_eps=conf["rms_norm_eps"], tie_embeddings=False,
        dtype=conf["dtype"], remat=conf["remat"])
