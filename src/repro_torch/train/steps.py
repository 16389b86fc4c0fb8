"""Train, prefill and decode step functions.

  * ``make_train_step``  — fwd+bwd, microbatch gradient accumulation,
    global-norm clip, AdamW; optional int8-compressed cross-pod gradient
    all-reduce (``parallel.compression``).
  * ``make_prefill_step`` — forward logits at full sequence length.
  * ``make_serve_step``  — one decode step (new token) against the KV cache.

The factories take ``device=`` (``None``: the CUDA device; raises where
there is none) and return a function that moves its batch there.  Gradients
come from ``torch.autograd.grad``; on the card the attention's go through the
flash-attention kernel's backward (S2).
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import _tree
from .._device import resolve_device
from ..configs.base import ModelCfg
from ..models import transformer
from ..optim.adamw import OptCfg, adamw_update, init_opt_state
from ..parallel.api import DTensor, current_rules, mesh_axis_names, placements, spec_leaves
from ..parallel.compression import pod_grads_compressed


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


def make_loss_fn(cfg: ModelCfg):
    """``loss_fn(params, batch) -> (loss, metrics)``: the mean cross-entropy
    over the unmasked positions plus the forward's aux loss.  The target
    logit is a ``gather`` where the reference multiplies by a one-hot and
    sums; that sum adds one value to zeros, so the two are equal exactly.
    The row maximum is detached, as the reference stops its gradient."""

    def loss_fn(params, batch):
        logits, aux = transformer.lm_forward(params, batch, cfg)
        labels = batch["labels"].long()
        mask = batch.get("loss_mask")
        if mask is None:
            mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
        lf = logits.float()
        m = lf.amax(-1).detach()
        lse = m + torch.log(torch.exp(lf - m[..., None]).sum(-1))
        tgt = lf.gather(-1, labels[..., None])[..., 0]
        denom = torch.clamp(mask.sum(), min=1.0)
        xent = ((lse - tgt) * mask).sum() / denom
        return xent + aux, {"xent": xent, "aux": aux,
                            "accuracy": ((logits.argmax(-1) == labels) * mask).sum() / denom}

    return loss_fn


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------


def init_train_state(seed: int, cfg: ModelCfg, *, device=None):
    """Parameters from ``transformer.init_lm(seed, cfg)`` on ``device``
    (``None``: the CUDA device) and a fresh AdamW state."""
    params = transformer.init_lm(seed, cfg, device=device)
    return {"params": params, "opt": init_opt_state(params)}


def constrain_like_params(grads, cfg: ModelCfg):
    """Pin the gradient tree to the parameter sharding: each ``DTensor``
    leaf is redistributed to its parameter's placements.  A plain tensor is
    one rank's local data, as the parameters are, and stays as it is;
    outside a rules context, or where the trees differ, nothing changes."""
    rules = current_rules()
    if rules is None:
        return grads
    flat_s = spec_leaves(transformer.specs_lm(cfg))
    flat_g = _tree.leaves(grads)
    if len(flat_s) != len(flat_g):
        return grads
    out = [g.redistribute(g.device_mesh, placements(rules.resolve(s), g.device_mesh))
           if isinstance(g, DTensor) else g for g, s in zip(flat_g, flat_s)]
    return _tree.unflatten(grads, out)


def make_grad_fn(cfg: ModelCfg, num_microbatches: int = 1):
    """``grad_fn(params, batch) -> (loss, metrics, grads)``, the gradient
    half of the train step: one pass, or ``num_microbatches`` passes over
    equal slices of the batch whose gradients are summed into float32 zeros
    (the reference's ``lax.scan``) and averaged, as are the loss and the
    metrics.  ``batch`` holds tensors already on the parameters' device; a
    batch that ``num_microbatches`` does not divide raises ``ValueError``, as
    the reference's reshape refuses it."""
    loss_fn = make_loss_fn(cfg)

    def value_and_grad(params, batch):
        leaves = [p.detach().requires_grad_() for p in _tree.leaves(params)]
        with torch.enable_grad():
            loss, metrics = loss_fn(_tree.unflatten(params, leaves), batch)
            grads = torch.autograd.grad(loss, leaves)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                _tree.unflatten(params, list(grads)))

    def grad_fn(params, batch):
        if num_microbatches <= 1:
            return value_and_grad(params, batch)
        for k, v in batch.items():
            if v.shape[0] % num_microbatches:
                raise ValueError(f"make_grad_fn: {k} holds {v.shape[0]} sequences, which "
                                 f"{num_microbatches} microbatches do not divide")
        mbs = [{k: v.unflatten(0, (num_microbatches, -1))[i] for k, v in batch.items()}
               for i in range(num_microbatches)]
        loss_sum = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
        grad_acc = _tree.map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
        per_mb = []
        for mb in mbs:
            loss, metrics, grads = value_and_grad(params, mb)
            grad_acc = _tree.map(lambda a, g: a + g.to(a.dtype), grad_acc, grads)
            loss_sum = loss_sum + loss
            per_mb.append(metrics)
        inv = 1.0 / num_microbatches
        metrics = {k: torch.stack([m[k] for m in per_mb]).mean() for k in per_mb[0]}
        return loss_sum * inv, metrics, _tree.map(lambda g: g * inv, grad_acc)

    return grad_fn


def make_train_step(
    cfg: ModelCfg,
    opt_cfg: OptCfg = OptCfg(),
    num_microbatches: int = 1,
    grad_compression: Optional[str] = None,   # None | "int8" (cross-pod)
    mesh=None,
    constrain_grads: bool = False,            # pin grads to param sharding
    *,
    device=None,
):
    """``train_step(state, batch) -> (new_state, metrics)``; the state is
    ``{"params", "opt"}`` and is not updated in place.  ``batch`` holds
    numpy arrays or tensors; they are moved to ``device``.  As in the
    reference, ``grad_compression="int8"`` compresses only across a mesh's
    ``pod`` axis; without one the step is the plain one.  With one, every
    rank is given the whole batch and the same state, takes its
    ``("pod", "data")`` slice of the batch and ends with the same new state
    (``parallel.compression.pod_grads_compressed``).  ``constrain_grads``
    pins the gradients to the parameters' sharding (``constrain_like_params``)."""
    dev = resolve_device(device)
    grad_fn = make_grad_fn(cfg, num_microbatches)
    compressed = (grad_compression == "int8" and mesh is not None
                  and "pod" in mesh_axis_names(mesh))

    def train_step(state, batch):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        params = state["params"]
        if compressed:
            loss, metrics, grads = pod_grads_compressed(grad_fn, params, batch, mesh)
        else:
            loss, metrics, grads = grad_fn(params, batch)
        if constrain_grads:
            grads = constrain_like_params(grads, cfg)
        new_params, new_opt, opt_metrics = adamw_update(grads, state["opt"], params, opt_cfg)
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


# ---------------------------------------------------------------------------
# inference steps
# ---------------------------------------------------------------------------


def make_prefill_step(cfg: ModelCfg, *, device=None):
    dev = resolve_device(device)

    def prefill_step(params, batch):
        batch = dict(batch, tokens=torch.as_tensor(batch["tokens"], device=dev))
        logits, _ = transformer.lm_forward(params, batch, cfg)
        return logits

    return prefill_step


def make_serve_step(cfg: ModelCfg, temperature: float = 0.0, *, device=None):
    dev = resolve_device(device)

    def serve_step(params, cache, tokens1, index, rng: Optional[torch.Generator] = None):
        """Greedy (or, with ``temperature > 0`` and a generator on the
        device, sampled) single-token decode step.  Returns (next tokens
        (B,1) int32, cache)."""
        logits, cache = transformer.lm_decode_step(
            params, cache, torch.as_tensor(tokens1, device=dev),
            torch.as_tensor(index, dtype=torch.int32, device=dev), cfg)
        last = logits[:, -1, :].float()
        if temperature > 0.0 and rng is not None:
            probs = torch.softmax(last / temperature, dim=-1)
            next_tok = torch.multinomial(probs, 1, generator=rng)[:, 0]
        else:
            next_tok = last.argmax(-1)
        return next_tok.to(torch.int32)[:, None], cache

    return serve_step
