"""The gradients of the port's loss (``make_grad_fn``) against
``jax.value_and_grad`` of the reference's ``make_loss_fn``, for all ten
archs' smoke configs from a float32 copy of the reference's state, at 1e-5
(the conventions are ``test_torch_train.py``'s)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.train import steps as ref_steps

from repro_torch import compat
from repro_torch.configs import registry
from repro_torch.train import steps

from test_torch_train import ARCHS, TOL, batch_of, flat, float32_state


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_reference(arch):
    """``make_grad_fn`` against ``jax.value_and_grad`` of the reference's
    ``make_loss_fn``: the loss, the metrics and every gradient leaf."""
    ref_cfg = ref_registry.get_smoke_config(arch)
    state = float32_state(arch)
    b = batch_of(arch, 0)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(ref_steps.make_loss_fn(ref_cfg),
                                                        has_aux=True))(
        state["params"], {k: jnp.asarray(v) for k, v in b.items()})
    params = compat.params_from_reference(jax.device_get(state["params"]), "cpu")
    p_loss, p_metrics, p_grads = steps.make_grad_fn(registry.get_smoke_config(arch))(
        params, {k: torch.as_tensor(v) for k, v in b.items()})
    np.testing.assert_allclose(float(p_loss), float(loss), **TOL)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(p_metrics[k]), float(v), **TOL)
    want, got = flat(grads), flat(p_grads)
    assert set(want) == set(got)
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, **TOL, err_msg=key)
