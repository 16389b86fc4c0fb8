"""The port's checkpoints and fault-tolerance runtime on the CPU: the twins of
``tests/train/test_checkpoint_ft.py`` (all but the elastic re-mesh, whose
twin restores onto 8 ranks in ``tests/test_torch_distributed.py``), and
checkpoints crossing between
the two packages bit for bit in both directions, a bfloat16 leaf included.
"""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as ref_store
from repro.configs import registry as ref_registry
from repro.train import steps as ref_steps

from repro_torch import _tree, compat
from repro_torch.checkpoint.store import AsyncCheckpointer, latest_step, restore, save
from repro_torch.configs.base import ShapeCfg
from repro_torch.configs.registry import get_smoke_config
from repro_torch.data.pipeline import make_batch
from repro_torch.ft.runtime import (InjectedFailure, StepMonitor, inject_failures,
                                    run_with_restarts)
from repro_torch.optim.adamw import OptCfg
from repro_torch.train.steps import init_train_state, make_train_step

SHAPE = ShapeCfg("t", seq_len=16, global_batch=4, kind="train")


def _cfg():
    return get_smoke_config("smollm-360m")


def _batch(cfg, step):
    return make_batch(cfg, SHAPE, step=step)


def _init(cfg):
    return init_train_state(0, cfg, device="cpu")


def _equal(a, b) -> bool:
    la, lb = _tree.leaves(a), _tree.leaves(b)
    return len(la) == len(lb) and all(x.dtype == y.dtype and torch.equal(x, y)
                                      for x, y in zip(la, lb))


def test_save_restore_roundtrip(tmp_path):
    cfg = _cfg()
    state = _init(cfg)
    assert any(t.dtype == torch.bfloat16 for t in _tree.leaves(state))
    save(tmp_path, 7, state)
    assert latest_step(tmp_path) == 7
    restored, step = restore(tmp_path, init_train_state(1, cfg, device="cpu"))
    assert step == 7
    assert _equal(state, restored)


def test_atomicity_keeps_previous_on_partial_write(tmp_path):
    cfg = _cfg()
    state = _init(cfg)
    save(tmp_path, 1, state)
    # simulate a torn write: stale tmp dir + LATEST pointing at missing dir
    (tmp_path / ".tmp-00000002").mkdir()
    (tmp_path / "LATEST").write_text("step_00000002")
    assert latest_step(tmp_path) == 1  # falls back to newest complete
    restored, step = restore(tmp_path, state)
    assert step == 1


def test_async_checkpointer(tmp_path):
    cfg = _cfg()
    state = _init(cfg)
    ck = AsyncCheckpointer(tmp_path, keep=2)
    for s in (0, 1, 2, 3):
        ck.save(s, state)
    ck.wait()
    assert latest_step(tmp_path) == 3
    kept = sorted(p.name for p in tmp_path.glob("step_*"))
    assert len(kept) == 2  # gc keeps the newest 2


def test_async_checkpointer_snapshots_before_the_state_changes(tmp_path):
    """The port may update tensors in place: the writer's copy is taken when
    ``save`` is called."""
    state = {"w": torch.zeros(4, 4)}
    ck = AsyncCheckpointer(tmp_path)
    ck.save(0, state)
    state["w"].add_(1.0)
    ck.wait()
    restored, _ = restore(tmp_path, state)
    assert float(restored["w"].abs().max()) == 0.0


def test_exact_resume_matches_uninterrupted_run(tmp_path):
    """Train 6 steps straight vs 3 steps + checkpoint + restore + 3 steps:
    identical final parameters (seekable data + full state in ckpt)."""
    cfg = _cfg()
    step_fn = make_train_step(cfg, OptCfg(lr=1e-3, warmup_steps=2, decay_steps=10),
                              device="cpu")

    s_a = _init(cfg)
    for i in range(6):
        s_a, _ = step_fn(s_a, _batch(cfg, i))

    s_b = _init(cfg)
    for i in range(3):
        s_b, _ = step_fn(s_b, _batch(cfg, i))
    save(tmp_path, 2, s_b)
    s_c, _ = restore(tmp_path, init_train_state(1, cfg, device="cpu"))
    for i in range(3, 6):
        s_c, _ = step_fn(s_c, _batch(cfg, i))

    for a, c in zip(_tree.leaves(s_a["params"]), _tree.leaves(s_c["params"])):
        np.testing.assert_allclose(a.float().numpy(), c.float().numpy(), rtol=1e-6, atol=1e-6)


def test_run_with_restarts_survives_injected_failures(tmp_path):
    cfg = _cfg()
    base_step = make_train_step(cfg, OptCfg(lr=1e-3, warmup_steps=2, decay_steps=10),
                                device="cpu")
    step_fn = inject_failures(base_step, fail_at={5, 12})
    report = run_with_restarts(
        init_state=lambda: _init(cfg),
        step_fn=step_fn,
        batch_at=lambda i: _batch(cfg, i),
        num_steps=15,
        ckpt_dir=str(tmp_path),
        ckpt_every=4,
        max_restarts=3,
    )
    assert report.steps_completed == 15
    assert report.restarts == 2
    # optimizer step count equals the step the run finished at
    final, step = restore(tmp_path, _init(cfg))
    assert step == 14
    assert int(final["opt"]["step"]) == 15


def test_restart_budget_exhausted_raises(tmp_path):
    cfg = _cfg()
    base_step = make_train_step(cfg, OptCfg(), device="cpu")
    step_fn = inject_failures(base_step, fail_at={1, 2, 3, 4, 5})
    with pytest.raises(InjectedFailure):
        run_with_restarts(
            init_state=lambda: _init(cfg),
            step_fn=step_fn,
            batch_at=lambda i: _batch(cfg, i),
            num_steps=10,
            ckpt_dir=str(tmp_path),
            ckpt_every=2,
            max_restarts=2,
        )


def test_straggler_detection():
    mon = StepMonitor(threshold=2.0)
    for i in range(8):
        mon.start()
        time.sleep(0.01)
        mon.stop(i)
    mon.start()
    time.sleep(0.08)
    mon.stop(99)
    assert any(s == 99 for s, _ in mon.stragglers)


def test_restore_puts_leaves_on_the_device_asked_for(tmp_path):
    state = {"a": torch.arange(6, dtype=torch.int32), "b": [torch.ones(2, dtype=torch.bfloat16)]}
    save(tmp_path, 0, state)
    like = {"a": torch.zeros(6, dtype=torch.float32), "b": [torch.zeros(2, dtype=torch.bfloat16)]}
    restored, _ = restore(tmp_path, like, device="cpu")
    assert restored["a"].dtype == torch.float32 and restored["a"].tolist() == list(range(6))
    with pytest.raises(ValueError, match="mismatch"):
        restore(tmp_path, {"a": like["a"]})


# -- the two packages' checkpoints ------------------------------------------------------


def _reference_state():
    """The reference's train state of a smoke config with bfloat16 weights,
    one step in (non-zero moments, step 1), as jax arrays."""
    cfg = ref_registry.get_smoke_config("qwen2-7b")
    from repro.data.pipeline import make_batch as ref_make_batch
    from repro.optim.adamw import OptCfg as RefOptCfg
    state = ref_steps.init_train_state(jax.random.key(0), cfg)
    b = {k: jnp.asarray(v) for k, v in ref_make_batch(cfg, SHAPE, step=0).items()}
    state, _ = jax.jit(ref_steps.make_train_step(cfg, RefOptCfg(lr=1e-3)))(state, b)
    return state


def _bits(x) -> np.ndarray:
    """A leaf's raw bits, whichever package holds it."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def test_reference_checkpoint_restores_into_the_port_bit_for_bit(tmp_path):
    state = _reference_state()
    ref_store.save(tmp_path, 1, state, metadata={"num_steps": 3})
    like = compat.state_from_reference(jax.device_get(state), "cpu")
    like = _tree.map(torch.zeros_like, like)
    restored, step = restore(tmp_path, like)
    assert step == 1
    want = _tree.with_paths(jax.device_get(state))
    got = _tree.with_paths(restored)
    assert set(want) == set(got)
    assert any(np.asarray(v).dtype.name == "bfloat16" for v in want.values())
    for key, w in want.items():
        assert got[key].dtype == like_dtype(w), key
        np.testing.assert_array_equal(_bits(got[key]), _bits(w), err_msg=key)


def like_dtype(x) -> torch.dtype:
    name = np.asarray(x).dtype.name
    return {"bfloat16": torch.bfloat16, "float32": torch.float32, "int32": torch.int32}[name]


def test_port_checkpoint_restores_into_the_reference_bit_for_bit(tmp_path):
    state = _reference_state()
    port_state = compat.state_from_reference(jax.device_get(state), "cpu")
    save(tmp_path, 4, port_state, metadata={"num_steps": 9})
    manifest = json.loads((tmp_path / "step_00000004" / "manifest.json").read_text())
    assert manifest["metadata"] == {"num_steps": 9} and manifest["step"] == 4
    assert "bfloat16" in manifest["dtypes"].values()
    assert ref_store.latest_step(tmp_path) == 4
    like = jax.tree.map(jnp.zeros_like, state)
    restored, step = ref_store.restore(tmp_path, like)
    assert step == 4
    for key, w in _tree.with_paths(port_state).items():
        got = _tree.with_paths(jax.device_get(restored))[key]
        assert np.asarray(got).dtype.name == str(w.dtype).removeprefix("torch."), key
        np.testing.assert_array_equal(_bits(got), _bits(w), err_msg=key)


def test_both_packages_write_the_same_keys_shapes_and_dtypes(tmp_path):
    state = _reference_state()
    ref_store.save(tmp_path / "ref", 0, state)
    save(tmp_path / "port", 0, compat.state_from_reference(jax.device_get(state), "cpu"))
    ref_m, port_m = (json.loads((tmp_path / side / "step_00000000" / "manifest.json")
                                .read_text()) for side in ("ref", "port"))
    for field in ("keys", "shapes", "dtypes"):
        assert ref_m[field] == port_m[field], field
    with np.load(tmp_path / "ref" / "step_00000000" / "arrays.npz") as a, \
            np.load(tmp_path / "port" / "step_00000000" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
