"""The float32 references against the port on the CPU, at the sizes of the port's
``smoke()`` configurations, on the weights the benchmark draws.

The port is run with float32 activations (its layers' matrices stay bfloat16,
and the reference takes the same values), so the two differ by the order of
float32 sums and by the port's rounding of each bfloat16 leaf's gradient to
bfloat16: the loss is held to 1e-5, a float32 leaf's gradient to 1e-4 of its
norm, a bfloat16 leaf's to 4e-3 (bfloat16's half step is 2^-9, about 2e-3).
The MoE's capacity drops are held to ``mlp.moe_forward_local``'s exactly: the
same tokens dropped, the outputs within float32 rounding.
"""

import numpy as np
import pytest
import torch

from onchip_bench import harness, spec, weights
from onchip_bench.tests import tiny
from repro_torch import _tree
from repro_torch.models import mlp
from repro_torch.train.steps import make_grad_fn

SEED = 2 ** 31 + 12345


def grads_both(name: str, **conf):
    c = tiny.cell(name, "float32", **conf)
    cfg = spec.module("port", c.config).model_cfg(c.conf)
    ref = spec.module("reference", c.config)
    run = harness.Training(c, SEED, torch.device("cpu"))
    batch = harness.stream_of(c, SEED).batch_at(0)
    loss, _, g = make_grad_fn(cfg)(run.state["params"],
                                   {k: torch.as_tensor(v) for k, v in batch.items()})
    made = weights.make(ref.param_specs(c.conf), SEED, "cpu")
    params = {k: v.float().requires_grad_() for k, v in made.items()}
    ref_loss = ref.loss(params, batch, c.conf)
    ref_g = dict(zip(params, torch.autograd.grad(ref_loss, list(params.values()))))
    return float(loss), float(ref_loss.detach()), _tree.with_paths(g), ref_g


@pytest.mark.parametrize("name", [tiny.DS_CELL, tiny.MB_CELL])
def test_reference_matches_port(name):
    loss, ref_loss, g, ref_g = grads_both(name)
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
    assert sorted(g) == sorted(ref_g)
    for k, want in ref_g.items():
        tol = 4e-3 if g[k].dtype == torch.bfloat16 else 1e-4
        err = float((g[k].float() - want).norm() / want.norm())
        assert err <= tol, (k, err)


def test_reference_sees_a_wrong_layer():
    """The comparison above fails when the reference's MLA drops its rotary part."""
    ref = spec.module("reference", tiny.cell(tiny.DS_CELL).config)
    real = ref._rope
    ref._rope = lambda x, theta: x
    try:
        loss, ref_loss, g, ref_g = grads_both(tiny.DS_CELL)
    finally:
        ref._rope = real
    worst = max(float((g[k].float() - w).norm() / w.norm()) for k, w in ref_g.items())
    assert worst > 1e-2


@pytest.mark.parametrize("cf", [0.5, 8.0])
def test_capacity_drops_match_the_port(cf):
    c = tiny.cell(tiny.DS_CELL, "float32", capacity_factor=cf)
    cfg = spec.module("port", c.config).model_cfg(c.conf)
    ref = spec.module("reference", c.config)
    made = weights.make(ref.param_specs(c.conf), SEED, "cpu")
    pre = "segments/1/0/ffn/"
    p = {}
    for k, v in made.items():
        if k.startswith(pre):
            node, parts = p, k[len(pre):].split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = v[0]
    x = torch.randn(2, 48, c.conf["hidden_size"], generator=torch.Generator().manual_seed(3))
    y, aux = mlp.moe_forward_local(p, x, cfg)
    d = ref._dims(c.conf)
    pf = {k: (v.float() if not isinstance(v, dict) else {kk: vv.float() for kk, vv in v.items()})
          for k, v in p.items()}
    ry, raux = ref._moe(pf, x.reshape(-1, x.shape[-1]), d, c.conf, "fp32")
    torch.testing.assert_close(y.reshape(-1, x.shape[-1]), ry, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(aux, raux, rtol=1e-5, atol=1e-8)
    # the drops happen where the capacity is short, and not where it is long
    T = x.shape[0] * x.shape[1]
    chosen = np.zeros(d["E"])
    top = torch.softmax(x.reshape(T, -1) @ pf["router"], -1).topk(d["K"], -1)[1]
    np.add.at(chosen, top.reshape(-1).numpy(), 1)
    dropped = (chosen > ref.capacity(T, d, c.conf)).any()
    assert dropped == (cf < 1.0)
