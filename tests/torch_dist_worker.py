"""One rank of the 8-rank gloo world of ``tests/test_torch_distributed.py``.

    python tests/torch_dist_worker.py <rank> <world> <directory>

Joins the world over a ``FileStore`` in ``directory``, builds the mesh
``("pod", "data", "model") = (2, 2, 2)`` and runs every case on the inputs
the parent wrote there (``inputs.npz``, a checkpoint under ``ckpt/``),
writing this rank's results to ``rank<rank>.npz``.  Imports neither ``jax``
nor the reference package: torch and the port only.
"""

from __future__ import annotations

import dataclasses
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import _tree
from repro_torch.checkpoint.store import restore
from repro_torch.configs.base import MoECfg
from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import attention, mlp, transformer
from repro_torch.optim.adamw import OptCfg, adamw_update, opt_state_specs
from repro_torch.parallel import compression
from repro_torch.parallel.api import (coordinate, local_slice, named_sharding, use_rules)
from repro_torch.parallel.rules import rules_for
from repro_torch.train.steps import (_argmax_sharded, _target_logit_sharded, init_train_state,
                                     make_grad_fn, make_train_step)

try:
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
except ImportError:  # pragma: no cover - torch before 2.4
    from torch.distributed._tensor import Replicate, Shard, distribute_tensor

SHAPE, AXES = (2, 2, 2), ("pod", "data", "model")
# the reference test's MoE configs: E=8 splits over model=2, E=3 does not
MOE_CASES = {"experts": ("deepseek-v2-lite-16b", 8), "ff": ("qwen2-moe-a2.7b", 3)}
DECODE_CAP = 1.0
OPT = dict(lr=1e-3, warmup_steps=2, decay_steps=10)


def moe_cfg(arch: str, n_routed: int):
    return get_smoke_config(arch).scaled(moe=MoECfg(
        n_routed=n_routed, n_shared=2, top_k=2, d_ff_expert=64, d_ff_shared=128,
        capacity_factor=8.0))


def params_of(inputs, prefix: str) -> dict:
    """The float32 tree saved under ``prefix/...`` (dicts of leaves)."""
    out: dict = {}
    for key in inputs.files:
        if key.startswith(prefix + "/"):
            node = out
            *path, leaf = key[len(prefix) + 1:].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = torch.from_numpy(inputs[key].copy())
    return out


def view_offsets(view: torch.Tensor, base: torch.Tensor) -> list[int]:
    """Each dim's offset of a narrowed view into a contiguous ``base``."""
    rem, offs = view.storage_offset() - base.storage_offset(), []
    for st in base.stride():
        offs.append(rem // st)
        rem %= st
    return offs


def dp_rows(x: torch.Tensor, coord: dict) -> torch.Tensor:
    """This rank's rows of the batch over ("pod", "data"), major to minor."""
    n = x.shape[0] // 4
    i = coord["pod"] * 2 + coord["data"]
    return x[i * n:(i + 1) * n]


def case_moe(mesh, inputs, name, arch, n_routed) -> dict:
    cfg = moe_cfg(arch, n_routed)
    coord = coordinate(mesh)
    rules = rules_for(cfg, mesh, "train", batch=8, moe_ep=True)
    p = params_of(inputs, f"moe_{name}/p")
    x = torch.from_numpy(inputs[f"moe_{name}/x"])
    xl = dp_rows(x, coord)
    world = dist.get_world_size()
    n_model = SHAPE[2]

    def loss_of(y, aux):
        # the sum over the ranks is the reference's (y^2).mean() + aux: each
        # token's row is on n_model ranks, aux on all of them
        return (y.float() ** 2).sum() / (x.numel() * n_model) + aux / world

    out = {}
    with use_rules(rules, mesh):
        # the dispatcher, given whole parameters
        leaves = [t.clone().requires_grad_() for t in _tree.leaves(p)]
        whole = _tree.unflatten(p, leaves)
        y, aux = mlp.moe_forward(whole, xl, cfg)
        grads = torch.autograd.grad(loss_of(y, aux), leaves)
        out["y"], out["aux"] = y.detach().numpy(), aux.detach().numpy()
        for key, g in _tree.with_paths(_tree.unflatten(p, list(grads))).items():
            out[f"grad_whole/{key}"] = g.numpy()
        # the EP body itself, given this rank's shards
        views = mlp.moe_ep_params(p, cfg, mesh)
        shards = [v.clone().requires_grad_() for v in _tree.leaves(views)]
        y2, aux2 = mlp.moe_forward_ep(_tree.unflatten(p, shards), xl, cfg, mesh,
                                      ("pod", "data"))
        grads2 = torch.autograd.grad(loss_of(y2, aux2), shards)
        out["y_ep"] = y2.detach().numpy()
        for (key, v), b, g in zip(_tree.with_paths(views).items(), _tree.leaves(p), grads2):
            out[f"grad_shard/{key}"] = g.numpy()
            out[f"offset/{key}"] = np.asarray(view_offsets(v, b), np.int64)
    return out


def case_compress(mesh, inputs) -> dict:
    w = torch.from_numpy(inputs["compress/w"])
    x = torch.from_numpy(inputs["compress/x"])

    def grad_fn(w, xb):
        w = w.detach().requires_grad_()
        with torch.enable_grad():
            loss = ((xb @ w) ** 2).mean()
            (g,) = torch.autograd.grad(loss, [w])
        return loss.detach(), {"l": loss.detach()}, g

    loss, metrics, g = compression.pod_grads_compressed(grad_fn, w, x, mesh)
    # this pod's gradient (the mean over data) and its int8 payload
    _, _, g_local = grad_fn(w, dp_rows(x, coordinate(mesh)))
    g_pod = g_local.clone()
    dist.all_reduce(g_pod, group=mesh.get_group("data"))
    g_pod = g_pod / 2
    q, scale = compression.quantize_int8(g_pod)
    return {"loss": loss.numpy(), "metric_l": metrics["l"].numpy(), "g": g.numpy(),
            "g_pod": g_pod.numpy(), "q": q.numpy(), "scale": scale.numpy()}


def case_decode(mesh, inputs, capped: bool) -> dict:
    tag = "decode_capped" if capped else "decode"
    cfg = get_smoke_config("tinyllama-1.1b")
    if capped:
        cfg = cfg.scaled(attn=dataclasses.replace(cfg.attn, logit_softcap=DECODE_CAP))
    p = params_of(inputs, f"{tag}/p")
    k, v = (torch.from_numpy(inputs[f"{tag}/{n}"]) for n in ("k", "v"))
    x1 = torch.from_numpy(inputs[f"{tag}/x1"])
    idx = torch.from_numpy(inputs[f"{tag}/idx"])
    B, L = k.shape[:2]
    rules = rules_for(cfg, mesh, "decode", batch=B, flash_decode=True)
    assert rules.rules.get("_flash_decode")
    i = coordinate(mesh)["model"]
    Ll = L // SHAPE[2]
    out = {}
    with use_rules(rules, mesh):
        # a cache made under the rules holds this rank's slots of the length
        made = attention.init_attn_cache(B, L, cfg, device="cpu")
        out["made_shape"] = np.asarray(made["k"].shape)
        try:
            attention.init_attn_cache(B, L + 1, cfg, device="cpu")
            out["odd_length_raises"] = np.asarray(False)
        except ValueError:
            out["odd_length_raises"] = np.asarray(True)
        cache = {"k": k[:, i * Ll:(i + 1) * Ll].clone(), "v": v[:, i * Ll:(i + 1) * Ll].clone()}
        o, cache = attention.attn_decode_step(p, x1, cache, idx, cfg)
    out["out"] = o.numpy()
    out["k"], out["v"] = cache["k"].numpy(), cache["v"].numpy()
    return out


def case_train(mesh, inputs, directory: Path) -> dict:
    cfg = get_smoke_config("tinyllama-1.1b")
    like = _tree.map(lambda t: t.float() if t.is_floating_point() else t,
                     init_train_state(1, cfg, device="cpu"))
    state, _ = restore(directory / "ckpt", like)
    batch = {k: torch.from_numpy(inputs[f"train/{k}"]) for k in ("tokens", "labels")}
    loss, metrics, grads = compression.pod_grads_compressed(make_grad_fn(cfg), state["params"],
                                                            batch, mesh)
    step = make_train_step(cfg, OptCfg(**OPT), grad_compression="int8", mesh=mesh, device="cpu")
    new_state, step_metrics = step(state, batch)
    # the step is AdamW on exactly these gradients
    want, _, _ = adamw_update(grads, state["opt"], state["params"], OptCfg(**OPT))
    same = all(torch.equal(a, b) for a, b in zip(_tree.leaves(want),
                                                 _tree.leaves(new_state["params"])))
    out = {"loss": loss.numpy(), "step_loss": step_metrics["loss"].numpy(),
           "step_is_adamw_of_the_grads": np.asarray(same)}
    for key, g in _tree.with_paths(grads).items():
        out[f"grad/{key}"] = g.numpy()
    return out


def case_restore(mesh, directory: Path) -> dict:
    """Each rank's slices of the saved train state under the train rules
    (the optimizer state's by ``opt_state_specs``), by
    ``restore(shardings=...)``, and DTensor's own slices of them."""
    cfg = get_smoke_config("tinyllama-1.1b")
    like = _tree.map(lambda t: t.float() if t.is_floating_point() else t,
                     init_train_state(1, cfg, device="cpu"))
    rules = rules_for(cfg, mesh, "train", batch=8)
    specs = transformer.specs_lm(cfg)
    specs = {"params": specs, "opt": opt_state_specs(specs)}
    shardings = _spec_map(lambda s: named_sharding(mesh, s, rules), specs)
    full = _tree.with_paths(restore(directory / "ckpt", like)[0])
    got, _ = restore(directory / "ckpt", like, shardings=shardings, mesh=mesh)
    out, agree = {}, True
    flat_sh = dict(zip(full, _spec_leaves(shardings)))
    flat_spec = dict(zip(full, _spec_leaves(specs)))
    for key, leaf in _tree.with_paths(got).items():
        if key.startswith("params/"):
            out[f"leaf/{key[len('params/'):]}"] = leaf.numpy()
        dt = distribute_tensor(full[key], mesh, flat_sh[key]).to_local()
        mine = local_slice(full[key], rules.resolve(flat_spec[key]), mesh)
        agree &= torch.equal(dt, leaf) and torch.equal(mine, leaf)
    out["dtensor_agrees"] = np.asarray(agree)
    return out


def case_local_indexing(mesh) -> dict:
    """The dry-run's local regions on DTensors that hold values: the argmax
    and the target logit over vocab shards (small integer logits, so rows
    tie across shards), the vocab-parallel embedding lookup and the in-place
    cache write, each under two layouts, against plain torch on the whole
    tensors.  One error a check; every one must be 0."""
    R, S = Replicate(), Shard
    g = torch.Generator().manual_seed(7)
    lf = torch.randint(0, 5, (4, 3, 12), generator=g).float()
    labels = torch.randint(0, 12, (4, 3), generator=g)
    table = torch.randn(12, 8, generator=g)
    tokens = torch.randint(0, 12, (4, 3), generator=g)
    cache = torch.randn(4, 8, 2, 3, generator=g)
    slot = torch.tensor([0, 3, 5, 7])
    new = torch.randn(4, 2, 3, generator=g)
    errors = []
    for pl in ((S(0), R, S(2)), (R, S(2), S(2))):
        d = distribute_tensor(lf, mesh, pl)
        lab = distribute_tensor(labels, mesh, tuple(R if isinstance(p, Shard) and p.dim == 2
                                                    else p for p in pl))
        top = _argmax_sharded(d, d.amax(-1)).full_tensor()
        errors.append(float((top != lf.argmax(-1)).sum()))
        tgt = _target_logit_sharded(d, lab).full_tensor()
        errors.append(float((tgt - lf.gather(-1, labels[..., None])[..., 0]).abs().max()))
    for pl in ((R, S(0), S(1)), (S(0), S(0), R)):
        x = transformer._embed_sharded(distribute_tensor(table, mesh, pl),
                                       distribute_tensor(tokens, mesh, (S(0), R, R)))
        errors.append(float((x.full_tensor() - table[tokens]).abs().max()))
    for pl in ((S(0), R, S(1)), (R, R, S(1))):
        c = distribute_tensor(cache, mesh, pl)
        attention.write_slot(c, distribute_tensor(slot, mesh, (R, R, R)),
                             distribute_tensor(new, mesh, (R, R, R)))
        want = cache.clone()
        want[torch.arange(4), slot] = new
        errors.append(float((c.full_tensor() - want).abs().max()))
    return {"errors": np.asarray(errors)}


def _spec_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _spec_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_spec_map(fn, v) for v in tree]
    return fn(tree)


def _spec_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _spec_leaves(tree[k])]
    if isinstance(tree, list):
        return [leaf for t in tree for leaf in _spec_leaves(t)]
    return [tree]


def main(rank: int, world: int, directory: Path) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(str(directory / "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=timedelta(seconds=120))
    mesh = make_mesh(SHAPE, AXES, device_type="cpu")
    inputs = np.load(directory / "inputs.npz")
    out = {"coord": np.asarray([coordinate(mesh)[a] for a in AXES])}
    parts = [(f"moe_{name}", case_moe(mesh, inputs, name, *MOE_CASES[name])) for name in MOE_CASES]
    parts += [("compress", case_compress(mesh, inputs)),
              ("decode", case_decode(mesh, inputs, capped=False)),
              ("decode_capped", case_decode(mesh, inputs, capped=True)),
              ("train", case_train(mesh, inputs, directory)),
              ("restore", case_restore(mesh, directory)),
              ("local_indexing", case_local_indexing(mesh))]
    for prefix, part in parts:
        out.update({f"{prefix}/{k}": v for k, v in part.items()})
    out["imports_clean"] = np.asarray(not any(m == "jax" or m == "repro" or m.startswith(
        ("jax.", "repro.")) for m in sys.modules))
    np.savez(directory / f"rank{rank}.npz", **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
