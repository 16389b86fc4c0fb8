"""The port's dry-run (``launch.{specs,trace_analysis,dryrun}``) against the
reference's: twins of ``tests/launch/test_dryrun_mini.py`` (the three mini
cells on a ``("pod", "data", "model") = (2, 2, 2)`` fake mesh with the smoke
configs), of ``tests/test_properties.py::test_hlo_analyzer_dot_flops_and_
trip_counts`` (drawn products and all-reduces in a loop), the opt cells,
``model_flops``/``active_params`` for every arch and shape, the kernel
regions' FLOP formulas against the reference's counted dots of each
region's plain function jitted alone, and one CLI run.

Every case that makes a fake process group runs in one subprocess for the
file (``tests/torch_dryrun_worker.py``), so no later test in this worker
finds a world.  ``tests/test_torch_dryrun_ref.py`` holds the one-rank counts
to the reference's HLO analysis.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.registry import get_config as ref_config
from repro.configs.registry import get_smoke_config as ref_smoke
from repro.kernels import ref as ref_kernels
from repro.launch import hlo_analysis
from repro.models import attention as ref_attention
from repro.models import mla as ref_mla
from repro.models import ssd as ref_ssd
from repro.models import transformer as ref_transformer
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import get_config, get_smoke_config, list_archs
from repro_torch.kernels import regions
from repro_torch.launch import specs, trace_analysis
from repro_torch.models import mla

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "torch_dryrun_worker.py"


def _env() -> dict:
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"))


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "mini.json"
    r = subprocess.run([sys.executable, str(WORKER), str(out), "mini"], capture_output=True,
                       text=True, env=_env(), cwd=ROOT, timeout=600)
    assert r.returncode == 0, f"stdout:\n{r.stdout[-3000:]}\nstderr:\n{r.stderr[-3000:]}"
    return json.loads(out.read_text())


# -- the counting mode (the HLO analyzer's twin) --------------------------------------


def test_counting_mode_dot_flops_and_trip_counts(mini):
    """Hypothesis draws m, n, k in 1..64 and 1..40 trips of a product and an
    all-reduce over a fake group; the mode counts 2mnk·trip FLOPs and 4mn·trip
    all-reduce bytes (``torch_dryrun_worker.check_counts``)."""
    assert mini["hypothesis"] == "ok"


def test_dryrun_refuses_a_real_world(mini):
    assert "exists" in mini["refusal"], mini["refusal"]


# -- the mini cells (test_dryrun_mini's twins) -----------------------------------------


def _check_cell(c: dict) -> None:
    assert c["flops"] > 0, "dot FLOPs must be attributed"
    assert c["mem_bytes"] > 0
    assert c["unknown_trip_whiles"] == 0
    assert c["bottleneck"] in ("compute", "memory", "collective")


def test_mini_dryrun_train_dense(mini):
    c = mini["tinyllama-1.1b|train"]
    _check_cell(c)
    assert c["coll_bytes"] > 0   # FSDP/TP training must communicate


def test_mini_dryrun_train_moe(mini):
    _check_cell(mini["qwen2-moe-a2.7b|train"])


def test_mini_dryrun_decode(mini):
    _check_cell(mini["tinyllama-1.1b|decode"])


@pytest.mark.parametrize("cell", ["qwen2-moe-a2.7b|train|moe_ep",
                                  "tinyllama-1.1b|decode|flash_decode",
                                  "tinyllama-1.1b|train|int8"])
def test_mini_dryrun_opt_cells(mini, cell):
    c = mini[cell]
    _check_cell(c)
    assert c["coll_bytes"] > 0
    if cell.endswith("int8"):
        # the compressed step all-gathers int8 over pod; the plain one reduces
        assert c["coll_by_kind"] != mini["tinyllama-1.1b|train"]["coll_by_kind"]
        assert "all-gather" in c["coll_by_kind"]


# -- model_flops / active_params ---------------------------------------------------------


@pytest.mark.parametrize("arch", list_archs())
def test_active_params_and_model_flops_equal_reference(arch):
    cfg, rcfg = get_config(arch), ref_config(arch)
    shapes = specs.params_shapes(cfg)
    n = trace_analysis.active_params(cfg, shapes)
    assert n == hlo_analysis.active_params(rcfg)
    for name, shape in SHAPES.items():
        want = hlo_analysis.model_flops(rcfg, REF_SHAPES[name])
        n_tok = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
        assert {"train": 6.0, "prefill": 2.0, "decode": 2.0}[shape.kind] * n * n_tok == want
    assert trace_analysis.model_flops(cfg, SHAPES["decode_32k"]) == \
        hlo_analysis.model_flops(rcfg, REF_SHAPES["decode_32k"])


# -- the kernel regions' FLOPs against the reference's plain regions ------------------


def _ref_flops(fn, *args) -> float:
    return hlo_analysis.analyze(jax.jit(fn).lower(*args).compile().as_text()).flops


def _vjp(fn):
    """The region's forward and its VJP against a cotangent given as the
    last argument (a constant one would let XLA fold dots into sums)."""
    def run(*args):
        out, pull = jax.vjp(fn, *args[:-1])
        return out, pull(args[-1])
    return run


def _zeros(*shape):
    return jnp.zeros(shape, jnp.float32)


ATTN_SHAPES = [(1, 300, 1300, 4, 2, 16), (2, 16, 48, 4, 2, 8)]   # Sk 1300: padded to 2048


@pytest.mark.parametrize("B,Sq,Sk,H,KvH,D", ATTN_SHAPES)
def test_attention_region_flops_equal_reference(B, Sq, Sk, H, KvH, D):
    """K3's formula (and S2's, twice it) against the reference's online
    softmax over 1024-key chunks and its dense form, forward and with
    XLA's autodiff; ``attn_forward``'s switch picks the dense form for the
    short shape and the chunked one where Sq·Sk > 2048² and Sk > 1024."""
    q, k = _zeros(B, Sq, H, D), _zeros(B, Sk, KvH, D)
    for fn, form in ((ref_attention.flash_attention, "chunked"),
                     (ref_attention.dense_attention, "dense")):
        fwd = regions.attention_flops(B, Sq, H, Sk, D, D, regions.FORMS[form])
        assert _ref_flops(fn, q, k, k) == fwd
        assert _ref_flops(_vjp(fn), q, k, k, q) == 3 * fwd
    big = regions.attention_flops(1, 2100, 2, 2100, 16, 16, regions.FORMS["attention"])
    assert big == regions.attention_flops(1, 2100, 2, 2100, 16, 16, regions.FORMS["chunked"])
    assert regions.attention_flops(B, Sq, H, Sk, D, D, regions.FORMS["attention"]) == \
        regions.attention_flops(B, Sq, H, Sk, D, D, regions.FORMS["dense"])


@pytest.mark.parametrize("B,H,L,D", [(2, 4, 100, 16), (1, 8, 1500, 32)])
def test_decode_region_flops_equal_reference(B, H, L, D):
    q, k = _zeros(B, H, D), _zeros(B, L, H, D)
    want = _ref_flops(lambda q, k, v: ref_kernels.decode_attention_ref(q, k, v, L // 2), q, k, k)
    got = float(trace_analysis.flop_registry[torch.ops.repro_torch.decode_region](
        torch.empty(B, H, D, device="meta"), torch.empty(B, L, H, D, device="meta"),
        torch.empty(B, L, H, D, device="meta"), torch.empty(B, device="meta"), D ** -0.5,
        None, out_val=None))
    assert got == want


@pytest.mark.parametrize("B,S,H,P,N,chunk", [(1, 40, 2, 4, 8, 16), (2, 16, 3, 4, 8, 16),
                                             (1, 64, 2, 8, 4, 8)])
def test_ssd_region_flops_equal_reference(B, S, H, P, N, chunk):
    """K5's and S3's formulas against ``ssd_core_chunked`` jitted alone:
    several chunks, and one (whose zero entering state XLA folds away)."""
    A, D = _zeros(H), _zeros(H)
    fn = lambda xh, dt, Bc, Cc: ref_ssd.ssd_core_chunked(xh, dt, A, Bc, Cc, D, chunk)[0]
    args = (_zeros(B, S, H, P), _zeros(B, S, H), _zeros(B, S, N), _zeros(B, S, N))
    fwd = regions.ssd_flops(B, S, H, P, N, chunk, backward=False)
    assert _ref_flops(fn, *args) == fwd
    assert _ref_flops(_vjp(fn), *args, args[0]) == fwd + regions.ssd_flops(
        B, S, H, P, N, chunk, backward=True)


def test_rglru_region_has_no_dots():
    a = _zeros(2, 16, 8)
    comb = lambda x, y: (x[0] * y[0], y[0] * x[1] + y[1])
    assert _ref_flops(lambda a, b: jax.lax.associative_scan(comb, (a, b), axis=1)[1], a, a) == 0
    assert regions._rglru_flops() == 0


@pytest.mark.parametrize("S", [1300, 2048])
def test_mla_chunked_region_flops_equal_reference(S):
    """MLA's absorbed chunked form, whole (projections and the region): the
    reference's ``mla_forward_chunked`` jitted against the port's traced on
    meta tensors, where K3 counts as the reference's latent-rank dots."""
    cfg, rcfg = get_smoke_config("deepseek-v2-lite-16b"), ref_smoke("deepseek-v2-lite-16b")
    rp = jax.eval_shape(lambda: ref_transformer.init_lm(jax.random.key(0), rcfg))
    rmix = rp["segments"][0][0]["mixer"]
    rmix = jax.tree.map(lambda s: jnp.zeros(s.shape[1:], s.dtype), rmix)
    x = jnp.zeros((1, S, rcfg.d_model), jnp.float32)
    want = _ref_flops(lambda p, x: ref_mla.mla_forward_chunked(p, x, rcfg), rmix, x)
    mix = jax.tree.map(lambda s: torch.empty(s.shape, dtype=torch.float32, device="meta"), rmix)
    mode = trace_analysis.CountingMode()
    with mode:
        mla.mla_forward_chunked(mix, torch.empty((1, S, cfg.d_model), device="meta"), cfg)
    assert mode.stats.flops == want


# -- the CLI -------------------------------------------------------------------------------


def test_dryrun_cli_writes_an_ok_record(tmp_path):
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                        "tinyllama-1.1b", "--shape", "decode_32k", "--out", str(tmp_path)],
                       capture_output=True, text=True, env=_env(), cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    rec = json.loads((tmp_path / "tinyllama-1.1b__decode_32k__single.json").read_text())
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert rec["cost"]["flops_per_chip"] > 0 and rec["memory"]["peak_bytes"] > 0
    assert rec["roofline"]["bottleneck"] in ("compute", "memory", "collective")
    assert rec["model_flops"] > 0 and 0 < rec["useful_flops_frac"] <= 1
