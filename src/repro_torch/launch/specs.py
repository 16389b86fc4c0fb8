"""Abstract inputs and their DTensor placements for every (arch x shape)
cell: the counterpart of the reference's ``launch/specs.py``.

The reference's ``jax.eval_shape`` is ``FakeTensorMode`` here: the port's
own initialisers (``train.steps.init_train_state``, ``transformer.init_lm``,
``transformer.init_lm_cache``) run under it and allocate nothing, so a
90B-parameter tree costs a second.  ``abstractify`` turns such a tree into
``DTensor``s over empty meta shards with their global shapes and strides:
the dry-run's step inputs, which hold no data.
"""

from __future__ import annotations

from typing import Any

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from .. import _tree
from ..configs.base import ModelCfg, ShapeCfg
from ..models import transformer
from ..optim.adamw import opt_state_specs
from ..parallel.api import ShardingRules, from_local, placements, spec_leaves, use_rules
from ..train.steps import init_train_state


def _is_spec_leaf(x) -> bool:
    return isinstance(x, tuple) and all(e is None or isinstance(e, str) for e in x)


def _structure(tree, is_leaf):
    """The tree's shape without its leaves: dict keys and list lengths."""
    if is_leaf(tree):
        return "*"
    if isinstance(tree, dict):
        return {k: _structure(tree[k], is_leaf) for k in sorted(tree)}
    return [_structure(t, is_leaf) for t in tree]


def tree_placements(spec_tree, shape_tree, rules: ShardingRules, mesh):
    """The tree of DTensor placements of a logical-axis spec tree on
    ``mesh``, after checking that the spec tree and the shape tree have the
    same structure and every spec one entry per dim."""
    sdef = _structure(spec_tree, _is_spec_leaf)
    vdef = _structure(shape_tree, lambda x: isinstance(x, torch.Tensor))
    assert sdef == vdef, f"spec/shape tree mismatch:\n{sdef}\nvs\n{vdef}"
    flat_specs, flat_shapes = spec_leaves(spec_tree), _tree.leaves(shape_tree)
    out = []
    for sp, shp in zip(flat_specs, flat_shapes):
        assert len(sp) == len(shp.shape), (sp, shp.shape)
        out.append(placements(rules.resolve(sp), mesh))
    return _tree.unflatten(shape_tree, out)


def abstract_tensor(shape, dtype, pl=None, mesh=None):
    """A tensor of ``shape`` that holds no data: an empty meta tensor, or
    with placements a DTensor over an empty meta shard of this rank's local
    shape, with the global shape and stride given."""
    shape = tuple(int(n) for n in shape)
    if pl is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    local, _ = compute_local_shape_and_global_offset(shape, mesh, pl)
    return from_local(torch.empty(local, dtype=dtype, device="meta"), mesh, pl, shape)


def abstractify(tree, pl_tree=None, mesh=None):
    """Meta tensors (no placements) or DTensors over empty meta shards for
    a tree of fake or meta tensors."""
    if pl_tree is None:
        return _tree.map(lambda x: abstract_tensor(x.shape, x.dtype), tree)
    flat = [abstract_tensor(x.shape, x.dtype, p, mesh)
            for x, p in zip(_tree.leaves(tree), spec_leaves(pl_tree))]
    return _tree.unflatten(tree, flat)


# ---------------------------------------------------------------------------
# per-cell shapes
# ---------------------------------------------------------------------------


def state_shapes(cfg: ModelCfg):
    with FakeTensorMode():
        return init_train_state(0, cfg, device="cpu")


def params_shapes(cfg: ModelCfg):
    with FakeTensorMode():
        return transformer.init_lm(0, cfg, device="cpu")


def cache_shapes(cfg: ModelCfg, batch: int, seq_len: int):
    """The whole caches' shapes: outside any rules, so a sequence-sharded
    cache is not cut to one rank's slots here."""
    with FakeTensorMode(), use_rules(None, None):
        return transformer.init_lm_cache(cfg, batch, seq_len, device="cpu")


def batch_specs(cfg: ModelCfg, shape: ShapeCfg) -> dict[str, Any]:
    """Logical specs and meta tensors for the data batch of a cell."""
    B, S = shape.global_batch, shape.seq_len
    shapes: dict[str, Any] = {}
    specs: dict[str, Any] = {}
    if shape.kind in ("train", "prefill"):
        shapes["tokens"] = abstract_tensor((B, S), torch.int32)
        specs["tokens"] = ("batch", "seq")
        if shape.kind == "train":
            shapes["labels"] = abstract_tensor((B, S), torch.int32)
            specs["labels"] = ("batch", "seq")
    if cfg.frontend is not None and shape.kind in ("train", "prefill"):
        shapes["frontend_embeds"] = abstract_tensor((B, cfg.frontend_tokens, cfg.frontend_dim),
                                                    torch.float32)
        specs["frontend_embeds"] = ("batch", None, None)
    return {"shapes": shapes, "specs": specs}


def cell_abstract_inputs(cfg: ModelCfg, shape: ShapeCfg, rules: ShardingRules, mesh,
                         num_microbatches: int = 1, *, local: bool = False):
    """``(args, in_placements, out_placements_hint)`` for the step function
    of a cell, as the reference's returns its shardings; ``args`` is a tuple
    matching the step's signature.  ``num_microbatches`` is the reference's
    parameter, unused there as here: the batch stays whole and the step
    slices it.  With ``local`` the arguments are whole meta tensors with no
    placements, as the int8 cross-pod step holds them (every rank the same
    state and the whole batch)."""

    def place(spec_tree, shape_tree):
        if local:
            return abstractify(shape_tree), None
        pl = tree_placements(spec_tree, shape_tree, rules, mesh)
        return abstractify(shape_tree, pl, mesh), pl

    if shape.kind == "train":
        st = state_shapes(cfg)
        pspecs = transformer.specs_lm(cfg)
        st_a, st_pl = place({"params": pspecs, "opt": opt_state_specs(pspecs)}, st)
        bs = batch_specs(cfg, shape)
        b_a, b_pl = place(bs["specs"], bs["shapes"])
        return (st_a, b_a), (st_pl, b_pl), (st_pl, None)
    if shape.kind == "prefill":
        ps = params_shapes(cfg)
        p_a, p_pl = place(transformer.specs_lm(cfg), ps)
        bs = batch_specs(cfg, shape)
        b_a, b_pl = place(bs["specs"], bs["shapes"])
        # logits: huge (B,S,V) — kept sharded over batch and vocab
        logits_pl = None if local else placements(rules.resolve(("batch", "seq", "vocab")), mesh)
        return (p_a, b_a), (p_pl, b_pl), logits_pl
    if shape.kind == "decode":
        B = shape.global_batch
        ps = params_shapes(cfg)
        p_a, p_pl = place(transformer.specs_lm(cfg), ps)
        cs = cache_shapes(cfg, B, shape.seq_len)
        c_a, c_pl = place(transformer.specs_lm_cache(cfg), cs)
        tok_pl = None if local else placements(rules.resolve(("batch", None)), mesh)
        idx_pl = None if local else placements((), mesh)
        tok = abstract_tensor((B, 1), torch.int32, tok_pl, mesh)
        idx = abstract_tensor((), torch.int32, idx_pl, mesh)
        return (p_a, c_a, tok, idx), (p_pl, c_pl, tok_pl, idx_pl), (tok_pl, c_pl)
    raise ValueError(shape.kind)

