"""The training slice of the port against the reference on the CPU: AdamW
(``schedule``, ``clip_by_global_norm``, ``adamw_update``), a step on the
bfloat16 weights, ``remat="block"``, the step factory's options; and the
helpers of its sibling files, which hold the gradients and two train steps
of all ten archs to the reference (``test_torch_train_grads.py``,
``test_torch_train_steps.py``) and run the entry points
(``test_torch_train_entry.py``).  Four files, so that the test runner's
workers share them.

Inputs are made with numpy (the data pipeline) or carried over from the
reference (``compat.state_from_reference``).  The parity tests start from
the reference's ``init_train_state`` with every bfloat16 leaf cast to float32
on both sides: a bfloat16 gradient is a float32 sum rounded to 8 bits, and two
sums taken in different orders round apart in about one element in a
thousand (``test_bf16_weights_round_apart_by_one_unit_at_most`` shows it), so
the bfloat16 weights are held to that separately.  Tolerance: 1e-5 (rtol and
atol) on the loss, every metric, every gradient and every AdamW moment; on
the parameters the same, but for AdamW's own amplification of float32 noise
(``assert_params_close``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.configs.base import ShapeCfg
from repro.data.pipeline import make_batch
from repro.optim import adamw as ref_adamw
from repro.train import steps as ref_steps

from repro_torch import _tree, compat
from repro_torch.configs import registry
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import transformer
from repro_torch.optim import adamw
from repro_torch.parallel import compression
from repro_torch.train import steps

ARCHS = ref_registry.list_archs()
SHAPE = ShapeCfg("smoke", seq_len=16, global_batch=2, kind="train")
TOL = dict(rtol=1e-5, atol=1e-5)
OPT = dict(lr=1e-3, warmup_steps=2, decay_steps=10)    # tests/models/test_arch_smoke.py's


def float32_state(arch):
    """The reference's train state of the arch's smoke config, every
    bfloat16 leaf cast to float32 (jax arrays)."""
    state = ref_steps.init_train_state(jax.random.key(0), ref_registry.get_smoke_config(arch))
    return jax.tree.map(lambda x: x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x,
                        state)


def flat(tree) -> dict:
    """``{path: float64 numpy}`` of a jax or torch tree, by checkpoint key."""
    if not isinstance(_tree.leaves(tree)[0], torch.Tensor):
        tree = compat.state_from_reference(jax.device_get(tree), "cpu") \
            if isinstance(tree, dict) and "opt" in tree else \
            compat.params_from_reference(jax.device_get(tree), "cpu")
    return {k: v.detach().double().numpy() for k, v in _tree.with_paths(tree).items()}


def assert_params_close(want: dict, got: dict, lr: float, n_steps: int):
    """Every element within 1e-5 (rtol and atol), but where AdamW amplifies
    float32 noise.  AdamW divides each gradient by its own running RMS, so an
    element whose gradient is a sum that cancels to float32 noise (a few 1e-8)
    takes a step whose size and sign that noise decides, on each side apart,
    though both compute the same function.  Such an element may differ by up
    to 5 % of one step a step (0.05 lr n_steps), and at most one element in
    10^5 of the whole state may (seen: 3 of 2.7 million)."""
    loose = 0.05 * lr * n_steps
    n_over = n_all = 0
    for key, w in want.items():
        diff = np.abs(got[key] - w)
        assert diff.max(initial=0.0) <= TOL["atol"] + loose, (key, diff.max())
        n_over += int((diff > TOL["atol"] + TOL["rtol"] * np.abs(w)).sum())
        n_all += w.size
    assert n_over <= max(1, n_all // 100_000), (n_over, n_all)


# -- AdamW --------------------------------------------------------------------------


def random_tree(seed=0):
    """A parameter-like tree: a matrix, a stacked norm scale, a vector, a
    bfloat16 matrix (as float32 numpy holding bfloat16 values)."""
    rng = np.random.default_rng(seed)
    bf = np.asarray(jnp.asarray(rng.standard_normal((4, 6)), jnp.bfloat16).astype(jnp.float32))
    return {"w": rng.standard_normal((5, 7)).astype(np.float32),
            "stack": {"scale": rng.standard_normal((3, 8)).astype(np.float32)},
            "bias": rng.standard_normal((9,)).astype(np.float32),
            "wb": bf}


def to_ref(tree, bf16_keys=("wb",)):
    return {k: (to_ref(v) if isinstance(v, dict) else
                jnp.asarray(v, jnp.bfloat16 if k in bf16_keys else jnp.float32))
            for k, v in tree.items()}


def to_port(tree, bf16_keys=("wb",)):
    return {k: (to_port(v) if isinstance(v, dict) else
                torch.as_tensor(v).to(torch.bfloat16 if k in bf16_keys else torch.float32))
            for k, v in tree.items()}


@pytest.mark.parametrize("step", [0, 1, 5, 99, 100, 101, 5000, 10_000, 20_000])
def test_schedule_matches_reference(step):
    cfg = dict(lr=3e-4, warmup_steps=100, decay_steps=10_000)
    want = float(ref_adamw.schedule(ref_adamw.OptCfg(**cfg), jnp.asarray(step, jnp.int32)))
    got = adamw.schedule(adamw.OptCfg(**cfg), torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = random_tree(1)
    want, want_norm = ref_adamw.clip_by_global_norm(to_ref(g), max_norm)
    got, got_norm = adamw.clip_by_global_norm(to_port(g), max_norm)
    np.testing.assert_allclose(float(got_norm), float(want_norm), rtol=1e-6)
    for key, w in flat(want).items():
        np.testing.assert_allclose(flat(got)[key], w, rtol=1e-6, atol=1e-7)


def test_adamw_update_matches_reference_and_decays_stacked_leaves():
    """Three updates from one state; the stacked (3, 8) scale is decayed as
    in the reference (``p.ndim >= 2``), the vector is not."""
    cfg = dict(lr=1e-2, warmup_steps=1, decay_steps=4, weight_decay=0.5, clip_norm=1.0)
    rp, pp = to_ref(random_tree(2)), to_port(random_tree(2))
    rs, ps = ref_adamw.init_opt_state(rp), adamw.init_opt_state(pp)
    for i in range(3):
        grads = random_tree(10 + i)
        rp, rs, rm = ref_adamw.adamw_update(to_ref(grads), rs, rp, ref_adamw.OptCfg(**cfg))
        pp, ps, pm = adamw.adamw_update(to_port(grads), ps, pp, adamw.OptCfg(**cfg))
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(pm[k]), float(rm[k]), rtol=1e-6)
    assert int(ps["step"]) == int(rs["step"]) == 3 and ps["step"].dtype == torch.int32
    for key, w in flat(rp).items():
        np.testing.assert_allclose(flat(pp)[key], w, **TOL)
    assert pp["wb"].dtype == torch.bfloat16 and ps["m"]["wb"].dtype == torch.float32
    for name in ("m", "v"):
        for key, w in flat(rs[name]).items():
            np.testing.assert_allclose(flat(ps[name])[key], w, rtol=1e-5, atol=1e-9)
    # with no gradient, a decayed leaf still moves and an undecayed one does not
    zero = {k: (torch.zeros_like(v) if not isinstance(v, dict) else
                {kk: torch.zeros_like(vv) for kk, vv in v.items()}) for k, v in pp.items()}
    moved, _, _ = adamw.adamw_update(zero, adamw.init_opt_state(pp), pp, adamw.OptCfg(**cfg))
    assert not torch.equal(moved["stack"]["scale"], pp["stack"]["scale"])
    assert torch.equal(moved["bias"], pp["bias"])


@pytest.mark.parametrize("arch", ["mamba2-780m", "qwen2.5-14b"])
def test_fixed_by_gradients_keeps_only_steps_that_float_noise_cannot_move(arch):
    """``adamw.fixed_by_gradients`` on two sets of gradients that agree far
    inside its 1e-5 band: the arch's smoke gradients taken in float32 and in
    float64 (rounded to float32), from one float32 state.  At every element
    it keeps, AdamW's first steps on the two sets are within 1e-4 of the
    leaf's largest magnitude; it leaves out every non-zero element whose
    gradient's sign the band leaves free, and at most 1 % of all."""
    cfg = registry.get_smoke_config(arch)
    state = _tree.map(lambda t: t.float() if t.dtype == torch.bfloat16 else t,
                      steps.init_train_state(0, cfg, device="cpu"))
    batch = {k: torch.as_tensor(v) for k, v in
             make_batch(cfg, ShapeCfg("t", seq_len=64, global_batch=4, kind="train")).items()}
    grad_fn = steps.make_grad_fn(cfg)
    _, _, g32 = grad_fn(state["params"], batch)
    _, _, g64 = grad_fn(_tree.map(lambda t: t.double() if t.is_floating_point() else t,
                                  state["params"]), batch)
    opt = adamw.OptCfg(lr=3e-4, warmup_steps=2, decay_steps=8)
    fixed = adamw.fixed_by_gradients(g32, state["opt"], state["params"], opt)
    a, b = (adamw.adamw_update(g, state["opt"], state["params"], opt)[0]
            for g in (g32, _tree.map(lambda t: t.float(), g64)))
    n_out = n_all = 0
    for g, keep, pa, pb in zip(*map(_tree.leaves, (g32, fixed, a, b))):
        err = float(((pa - pb).abs() * keep).max())
        assert err <= 1e-4 * float(pa.abs().max()), (err, float(pa.abs().max()))
        free = (g.abs() <= 1e-5 * g.abs().max()) & (g != 0)
        assert not (free & keep).any()
        n_out, n_all = n_out + int((~keep).sum()), n_all + keep.numel()
    assert n_out <= 0.01 * n_all, (n_out, n_all)


# -- the gradients and the train step ----------------------------------------------


def batch_of(arch, step):
    return make_batch(ref_registry.get_smoke_config(arch), SHAPE, step=step)


def test_bf16_weights_round_apart_by_one_unit_at_most():
    """The smoke config as it is (bfloat16 projection weights): after a step
    from one state, each bfloat16 parameter equals the reference's or is one
    rounding apart (the float32 gradients agree to 1e-5; rounded to 8 bits
    they part in about one element in a thousand), and every float32 leaf is
    within 1e-5."""
    arch = "tinyllama-1.1b"
    ref_cfg = ref_registry.get_smoke_config(arch)
    state = ref_steps.init_train_state(jax.random.key(0), ref_cfg)
    pstate = compat.state_from_reference(jax.device_get(state), "cpu")
    b = batch_of(arch, 0)
    state, _ = jax.jit(ref_steps.make_train_step(ref_cfg, ref_adamw.OptCfg(**OPT)))(
        state, {k: jnp.asarray(v) for k, v in b.items()})
    pstate, _ = steps.make_train_step(registry.get_smoke_config(arch), adamw.OptCfg(**OPT),
                                      device="cpu")(pstate, b)
    ref_leaves = _tree.with_paths(jax.device_get(state))
    n_apart = n_bf16 = 0
    for key, t in _tree.with_paths(pstate).items():
        want = np.asarray(ref_leaves[key]).astype(np.float64)
        got = t.double().numpy()
        if t.dtype == torch.bfloat16:
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
            assert (np.abs(got - want) <= ulp + 1e-12).all(), key
            n_apart += int((got != want).sum())
            n_bf16 += got.size
        else:
            np.testing.assert_allclose(got, want, **TOL, err_msg=key)
    assert n_bf16 > 0 and n_apart <= n_bf16 // 100, (n_apart, n_bf16)


def test_remat_block_gives_the_gradients_of_no_remat():
    cfg = registry.get_smoke_config("qwen2-7b")
    params = steps.init_train_state(0, cfg, device="cpu")["params"]
    b = {k: torch.as_tensor(v) for k, v in batch_of("qwen2-7b", 0).items()}
    plain = steps.make_grad_fn(cfg)(params, b)
    remat = steps.make_grad_fn(cfg.scaled(remat="block"))(params, b)
    assert torch.equal(plain[0], remat[0])
    for g, r in zip(_tree.leaves(plain[2]), _tree.leaves(remat[2])):
        torch.testing.assert_close(r, g, rtol=1e-6, atol=1e-7)
    # and the forward is the forward
    with torch.no_grad():
        a, _ = transformer.lm_forward(params, b, cfg)
        r, _ = transformer.lm_forward(params, b, cfg.scaled(remat="block"))
    assert torch.equal(a, r)


def test_remat_block_runs_each_block_forward_twice():
    """Under remat each repeat's forward runs again in the backward: the
    attention's Function is entered twice a layer."""
    from repro_torch.kernels import flash_attention as fa
    cfg = registry.get_smoke_config("tinyllama-1.1b").scaled(remat="block")
    params = steps.init_train_state(0, cfg, device="cpu")["params"]
    b = {k: torch.as_tensor(v) for k, v in batch_of("tinyllama-1.1b", 0).items()}
    calls = []
    real = fa.FlashAttention.forward

    def counted(ctx, *args):
        calls.append(1)
        return real(ctx, *args)

    fa.FlashAttention.forward = staticmethod(counted)
    try:
        steps.make_grad_fn(cfg)(params, b)
    finally:
        fa.FlashAttention.forward = staticmethod(real)
    assert len(calls) == 2 * cfg.n_layers


def test_train_step_options_for_the_mesh_are_refused_or_identities():
    """int8 compression runs the plain step where there is no ``pod`` axis,
    as the reference does (``repro/train/steps.py:130``), and equals the
    reference's step from one float32 state; across a ``pod`` axis (a
    one-rank ``("pod", "data", "model")`` mesh here; eight ranks in
    ``tests/test_torch_distributed.py``) it is AdamW on the gradients
    through the int8 round trip.  ``constrain_grads`` is the identity on
    plain tensors."""
    arch = "tinyllama-1.1b"
    cfg = registry.get_smoke_config(arch)
    state = float32_state(arch)
    pstate = compat.state_from_reference(jax.device_get(state), "cpu")
    b = batch_of(arch, 0)
    want, w_metrics = jax.jit(ref_steps.make_train_step(
        ref_registry.get_smoke_config(arch), ref_adamw.OptCfg(**OPT),
        grad_compression="int8"))(state, {k: jnp.asarray(v) for k, v in b.items()})
    a, ma = steps.make_train_step(cfg, adamw.OptCfg(**OPT), device="cpu")(pstate, b)
    runs = [steps.make_train_step(cfg, adamw.OptCfg(**OPT), grad_compression="int8",
                                  mesh=mesh, device="cpu")(pstate, b)
            for mesh in (None, type("NoPod", (), {"axis_names": ("data",)})())]
    runs.append(steps.make_train_step(cfg, adamw.OptCfg(**OPT), constrain_grads=True,
                                      device="cpu")(pstate, b))
    for c, mc in runs:
        assert all(torch.equal(x, y) for x, y in zip(_tree.leaves(a), _tree.leaves(c)))
        assert all(torch.equal(ma[k], mc[k]) for k in ma)
    for k, v in w_metrics.items():
        np.testing.assert_allclose(float(ma[k]), float(v), **TOL, err_msg=k)
    got = flat(a)
    for key, w in flat(want).items():
        if not key.startswith("params/"):
            np.testing.assert_allclose(got[key], w, **TOL, err_msg=key)
    assert_params_close({k: v for k, v in flat(want).items() if k.startswith("params/")}, got,
                        OPT["lr"], 1)
    made = not torch.distributed.is_initialized()
    try:
        mesh = make_mesh((1, 1, 1), ("pod", "data", "model"), device_type="cpu")
        c, mc = steps.make_train_step(cfg, adamw.OptCfg(**OPT), grad_compression="int8",
                                      mesh=mesh, device="cpu")(pstate, b)
    finally:
        if made:
            torch.distributed.destroy_process_group()
    tb = {k: torch.as_tensor(v) for k, v in b.items()}
    loss, _, grads = steps.make_grad_fn(cfg)(pstate["params"], tb)
    round_trip = _tree.map(lambda g: compression.dequantize(*compression.quantize_int8(g)), grads)
    want_c, _, _ = adamw.adamw_update(round_trip, pstate["opt"], pstate["params"],
                                      adamw.OptCfg(**OPT))
    assert all(torch.equal(x, y) for x, y in zip(_tree.leaves(want_c),
                                                 _tree.leaves(c["params"])))
    assert torch.equal(mc["loss"], loss)


@pytest.mark.parametrize("n_seq, microbatches", [(5, 2), (6, 4)])
def test_microbatches_that_do_not_divide_the_batch_are_refused(n_seq, microbatches):
    """5 sequences in 2 microbatches, or 6 in 4: the reference's reshape
    refuses the batch, and so does the port, before any pass."""
    arch = "tinyllama-1.1b"
    b = make_batch(ref_registry.get_smoke_config(arch),
                   ShapeCfg("smoke", seq_len=16, global_batch=n_seq, kind="train"))
    state = float32_state(arch)
    with pytest.raises(TypeError, match="reshape"):
        ref_steps.make_train_step(ref_registry.get_smoke_config(arch),
                                  num_microbatches=microbatches)(
            state, {k: jnp.asarray(v) for k, v in b.items()})
    pstate = compat.state_from_reference(jax.device_get(state), "cpu")
    with pytest.raises(ValueError, match=f"{microbatches} microbatches do not divide"):
        steps.make_train_step(registry.get_smoke_config(arch), num_microbatches=microbatches,
                              device="cpu")(pstate, b)


def test_microbatches_of_a_divisible_batch_match_the_reference():
    """4 sequences in 2 microbatches of 2: the loss, the metrics and the
    gradients equal the reference's (``make_grad_fn`` against
    ``jax.value_and_grad`` over the reference's microbatched step)."""
    arch = "tinyllama-1.1b"
    b = make_batch(ref_registry.get_smoke_config(arch),
                   ShapeCfg("smoke", seq_len=16, global_batch=4, kind="train"))
    state = float32_state(arch)
    pstate = compat.state_from_reference(jax.device_get(state), "cpu")
    want, w_metrics = jax.jit(ref_steps.make_train_step(
        ref_registry.get_smoke_config(arch), ref_adamw.OptCfg(**OPT), num_microbatches=2))(
        state, {k: jnp.asarray(v) for k, v in b.items()})
    got, g_metrics = steps.make_train_step(registry.get_smoke_config(arch),
                                           adamw.OptCfg(**OPT), num_microbatches=2,
                                           device="cpu")(pstate, b)
    for k, v in w_metrics.items():
        np.testing.assert_allclose(float(g_metrics[k]), float(v), **TOL, err_msg=k)
    g = flat(got)
    for key, w in flat(want).items():
        if not key.startswith("params/"):
            np.testing.assert_allclose(g[key], w, **TOL, err_msg=key)
    assert_params_close({k: v for k, v in flat(want).items() if k.startswith("params/")}, g,
                        OPT["lr"], 1)


def test_train_entry_points_raise_where_there_is_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default device resolves")
    cfg = registry.get_smoke_config("tinyllama-1.1b")
    for call in (lambda: steps.init_train_state(0, cfg),
                 lambda: steps.make_train_step(cfg)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
