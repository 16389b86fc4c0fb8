"""Two ``make_train_step`` steps from one carried-over state against the
reference's, for all ten archs' smoke configs with one and two microbatches:
the loss and metrics of each step, then every parameter and AdamW leaf (the
conventions and tolerances are ``test_torch_train.py``'s)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.optim import adamw as ref_adamw
from repro.train import steps as ref_steps

from repro_torch import _tree, compat
from repro_torch.configs import registry
from repro_torch.optim import adamw
from repro_torch.train import steps

from test_torch_train import (ARCHS, OPT, TOL, assert_params_close, batch_of, flat,
                              float32_state)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_two_train_steps_match_reference(arch, microbatches):
    """The reference's ``tests/models/test_arch_smoke.py::test_train_step``
    as a parity test: two steps from one carried-over state; the loss and
    metrics of each, then every parameter and AdamW leaf."""
    ref_cfg = ref_registry.get_smoke_config(arch)
    state = float32_state(arch)
    pstate = compat.state_from_reference(jax.device_get(state), "cpu")
    ref_step = jax.jit(ref_steps.make_train_step(ref_cfg, ref_adamw.OptCfg(**OPT),
                                                 num_microbatches=microbatches))
    port_step = steps.make_train_step(registry.get_smoke_config(arch), adamw.OptCfg(**OPT),
                                      num_microbatches=microbatches, device="cpu")
    p0 = pstate["params"]
    for i in range(2):
        b = batch_of(arch, i)
        state, metrics = ref_step(state, {k: jnp.asarray(v) for k, v in b.items()})
        pstate, p_metrics = port_step(pstate, b)
        assert set(p_metrics) == set(metrics)
        for k, v in metrics.items():
            np.testing.assert_allclose(float(p_metrics[k]), float(v), **TOL, err_msg=k)
    want, got = flat(state), flat(pstate)
    assert set(want) == set(got)
    for key in want:
        if not key.startswith("params/"):
            np.testing.assert_allclose(got[key], want[key], **TOL, err_msg=key)
    assert_params_close({k: v for k, v in want.items() if k.startswith("params/")}, got,
                        OPT["lr"], 2)
    assert int(pstate["opt"]["step"]) == 2
    assert not torch.equal(_tree.leaves(p0)[0], _tree.leaves(pstate["params"])[0])
