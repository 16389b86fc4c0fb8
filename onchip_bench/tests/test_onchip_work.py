"""The frozen work counts: hand counts at small shapes, the model FLOPs against
the port's dry-run count (``launch.trace_analysis.model_flops``) less the terms
it should not hold, and the kernel-name patterns against ``chip_smoke.py``'s."""

import ast
from pathlib import Path

import pytest

from onchip_bench import spec, trace
from onchip_bench.tests import tiny
from repro_torch import _tree
from repro_torch.configs.base import ShapeCfg
from repro_torch.kernels import flash_attention
from repro_torch.launch import specs as port_specs
from repro_torch.launch import trace_analysis

ROOT = Path(__file__).resolve().parents[2]
DS, MB = "deepseek-v2-lite-16b.dense1-moe3", "mamba2-780m"

# a deepseek config of hand-countable sizes: D 4, 2 heads of nope 3 + rope 2,
# v 2, rank 5, dense F 6, 4 experts of 3, top 2, 1 shared, vocab 7; 1 dense + 1 MoE
DS_HAND = dict(hidden_size=4, num_attention_heads=2, num_key_value_heads=2, qk_nope_head_dim=3,
               qk_rope_head_dim=2, v_head_dim=2, kv_lora_rank=5, intermediate_size=6,
               n_routed_experts=4, num_experts_per_tok=2, moe_intermediate_size=3,
               n_shared_experts=1, vocab_size=7, num_hidden_layers=2, first_k_dense_replace=1)
# Mamba-2: D 4, expand 2 (8 inner), headdim 4 (2 heads), N 3, chunk 2, 2 layers, vocab 5 -> 8
MB_HAND = dict(d_model=4, n_layer=2, vocab_size=5, pad_vocab_size_multiple=8)
MB_HAND_SSM = dict(expand=2, headdim=4, d_state=3, chunk_size=2)


def conf(name, **over):
    c = spec.data("configs", name)
    if name == MB:
        return dict(c, **over, ssm_cfg=dict(c["ssm_cfg"], **MB_HAND_SSM))
    return dict(c, **over)


def test_deepseek_hand_counts():
    work = spec.module("work", DS)
    c = conf(DS, **DS_HAND)
    # MLA: wq 4*2*5 + w_dkv 4*5 + w_kpe 4*2 + w_uk 5*2*3 + w_uv 5*2*2 + wo 2*2*4 = 134
    # dense 3*4*6 = 72; MoE: router 4*4 + 2 experts * 3*4*3 + shared 3*4*3 = 124; head 4*7
    assert work.matmul_params_per_token(c) == 2 * 134 + 72 + 124 + 28
    # B 2, S 3: 6 causal pairs a head; forward 2 layers * 2 * 2 * 2 heads * 6 * (5 + 2)
    assert work.attention_flops_forward(c, 2, 3) == 2 * 2 * 2 * 2 * 6 * 7
    t = {"batch": 2, "seq_len": 3}
    assert work.model_flops(c, t) == 6 * (2 * 134 + 72 + 124 + 28) * 6 + 3 * 672
    k3, s2 = work.kernel_work(c, t)["k3"], work.kernel_work(c, t)["s2"]
    pairs, rows = 2 * 2 * 6, 2 * 3 * 2
    assert k3 == (2 * pairs * 7, 2 * rows * (5 + 5 + 2 + 2 + 1))
    assert s2 == (2 * pairs * (15 + 4), 2 * rows * (5 + 5 + 2 + 2 + 2 + 1 + 5 + 5 + 2))


def test_mamba2_hand_counts():
    work = spec.module("work", MB)
    c = conf(MB, **MB_HAND)
    # w_in 4 * (2*8 + 2*3 + 2) = 96, w_out 8*4 = 32, a layer; the tied head 8*4
    assert work.matmul_params_per_token(c) == 2 * 128 + 32
    # B 1, S 4: 2 chunks of 2 (3 causal pairs): CB 2*3*3 + 2 heads (2*3*4 + 4*2*3*4)
    per_chunk = 2 * 3 * 3 + 2 * (2 * 3 * 4 + 4 * 2 * 3 * 4)
    assert work.ssd_flops_forward(c, 1, 4) == 2 * per_chunk
    t = {"batch": 1, "seq_len": 4}
    assert work.model_flops(c, t) == 6 * 288 * 4 + 3 * 2 * 2 * per_chunk
    x, a, bc = 1 * 4 * 2 * 4, 1 * 4 * 2, 2 * 1 * 4 * 3
    assert work.kernel_work(c, t) == {"k5": (2 * per_chunk, 2 * (2 * x + a + bc)),
                                      "s3": (4 * per_chunk, 2 * (3 * x + 2 * a + 2 * bc))}


NOT_MATMUL = ("scale", "kv_norm", "conv_w", "conv_b", "A_log", "D", "dt_bias", "norm_w")


@pytest.mark.parametrize("name", [tiny.DS_CELL, tiny.MB_CELL])
def test_model_flops_against_the_dry_run_count(name):
    """``model_flops`` of the dry-run counts every parameter a token touches,
    the embedding gather among them; less the gather (a separate table where
    the head is untied) and the leaves that are no matmul, it is 6 x our
    matmul parameters a token, exactly."""
    c = tiny.cell(name)
    cfg = spec.module("port", c.config).model_cfg(c.conf)
    work = spec.module("work", c.config)
    B, S = c.traffic["batch"], c.traffic["seq_len"]
    paths = _tree.with_paths(port_specs.params_shapes(cfg))
    skip = sum(t.numel() for k, t in paths.items() if k.split("/")[-1] in NOT_MATMUL)
    if not cfg.tie_embeddings:
        skip += paths["embed"].numel()
    theirs = trace_analysis.model_flops(cfg, ShapeCfg("t", S, B, "train"))
    assert theirs - 6 * B * S * skip == 6 * B * S * work.matmul_params_per_token(c.conf)


def test_family_patterns_match_chip_smoke():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
              and n.name == "step_shares")
    fams = next(n.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "families")
    theirs = {ast.literal_eval(k): v for k, v in zip(fams.keys, fams.values)}
    assert set(trace.FAMILY_NAMES) <= set(theirs)
    for fam, node in ((f, theirs[f]) for f in trace.FAMILY_NAMES):
        if fam == "s2":            # sorted({n for ns in fa.BWD_KERNELS.values() for n in ns})
            want = {n for ns in flash_attention.BWD_KERNELS.values() for n in ns}
            assert set(trace.FAMILY_NAMES["s2"]) == want
        else:
            assert list(trace.FAMILY_NAMES[fam]) == ast.literal_eval(node)


def test_family_patterns_read_kernel_names():
    names = {"void flash_bf16_wgmma<192, 128, false>(Params)": "k3",
             "void flash_bwd_dkdv_wgmma<192, 128, false>(P)": "s2",
             "flash_bwd_delta(float const*)": "s2",
             "void ssd_chunk_state<(bool)1>(float*)": "s3",
             "void ssd_chunk_state<false>(float*)": "k5",
             "ssd_bwd_ddA": "s3", "ssd_chunk_cb": "k5",
             "void at::native::vectorized_elementwise_kernel<4>": None}
    for name, fam in names.items():
        found = [f for f, p in trace.FAMILIES.items() if p.search(name)]
        assert found == ([fam] if fam else []), (name, found)
