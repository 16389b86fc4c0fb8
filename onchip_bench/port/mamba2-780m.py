"""The port's model configuration (``repro_torch.configs.base.ModelCfg``) for the
configuration file ``configs/mamba2-780m.json``.  Refuses a file that states what
the port cannot run."""

from __future__ import annotations

from repro_torch.configs.base import ModelCfg, Segment, SSDCfg

# the port's gated norm takes this epsilon whatever the configuration says
GATED_NORM_EPS = 1e-6


def model_cfg(conf: dict) -> ModelCfg:
    s = conf["ssm_cfg"]
    wanted = {"d_intermediate": 0, "rms_norm": True, "residual_in_fp32": False,
              "tie_embeddings": True, "norm_epsilon": GATED_NORM_EPS}
    wanted_ssm = {"layer": "Mamba2", "ngroups": 1, "norm_before_gate": False, "bias": False,
                  "conv_bias": True}
    for where, want in ((conf, wanted), (s, wanted_ssm)):
        for key, value in want.items():
            if where[key] != value:
                raise ValueError(f"{conf['name']}: the port runs {key} = {value!r} only, "
                                 f"the file states {where[key]!r}")
    return ModelCfg(
        name=conf["name"], family="ssm", d_model=conf["d_model"], vocab=conf["vocab_size"],
        d_ff=0, segments=(Segment(("ssd",), conf["n_layer"], "none"),),
        ssd=SSDCfg(d_state=s["d_state"], headdim=s["headdim"], expand=s["expand"],
                   chunk=s["chunk_size"], conv_width=s["d_conv"]),
        tie_embeddings=True, norm_eps=conf["norm_epsilon"],
        pad_vocab_multiple=conf["pad_vocab_size_multiple"], dtype=conf["dtype"],
        remat=conf["remat"])
