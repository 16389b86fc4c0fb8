"""Plain PyTorch pieces that the float32 references share: products in float32
(TF32 off) or, for the control, in fp8; RMSNorm; the cross-entropy taken in
blocks of rows; AdamW as the traffic mix states it; and the readings that the
check compares.  Imports torch alone: nothing of the program.
"""

from __future__ import annotations

import math
import zlib

import torch
from torch.utils.checkpoint import checkpoint

#: the precisions a reference runs in: its own, and the control's (the
#: nearest below bfloat16, the configurations' training precision)
PRECISIONS = ("fp32", "fp8")
_FP8_FWD, _FP8_GRAD = torch.float8_e4m3fn, torch.float8_e5m2


def no_tf32() -> None:
    """float32 products in float32: on the card a float32 matmul may run in
    TF32 unless these are off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    """x through ``dtype`` and back, scaled per tensor to its largest magnitude."""
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = torch.finfo(dtype).max / amax
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _Fp8Operand(torch.autograd.Function):
    """An operand rounded to e4m3 for the product; its gradient passes as it is."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, _FP8_FWD)

    @staticmethod
    def backward(ctx, g):
        return g


class _Fp8Grad(torch.autograd.Function):
    """The identity, whose backward rounds the incoming gradient to e5m2, so
    that a product's backward multiplies fp8 operands too."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _round(g, _FP8_GRAD)


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor, precision: str = "fp32") -> torch.Tensor:
    """A product of two operands, in float32 or (the control) with both
    operands, and in the backward the incoming gradient, rounded to fp8."""
    if precision == "fp32":
        return torch.einsum(eq, a, b)
    if precision != "fp8":
        raise ValueError(f"precision {precision!r}: one of {PRECISIONS}")
    return _Fp8Grad.apply(torch.einsum(eq, _Fp8Operand.apply(a), _Fp8Operand.apply(b)))


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _xent_block(x, w_norm, head, labels, mask, eps, precision):
    h = rms_norm(x, w_norm, eps)
    logits = einsum("td,dv->tv", h, head, precision)
    lse = torch.logsumexp(logits, -1)
    tgt = logits.gather(-1, labels[:, None])[:, 0]
    return ((lse - tgt) * mask).sum()


def mean_xent(x, w_norm, head, labels, mask, eps, precision, rows: int = 2048):
    """The mean cross-entropy of the final norm and head over the rows of x
    (T, D) whose mask is 1; each block of ``rows`` rows recomputed in the
    backward, so that the logits of one block live at a time."""
    total = x.new_zeros(())
    for r0 in range(0, x.shape[0], rows):
        sl = slice(r0, r0 + rows)
        total = total + checkpoint(_xent_block, x[sl], w_norm, head, labels[sl], mask[sl], eps,
                                   precision, use_reentrant=False)
    return total / mask.sum().clamp(min=1.0)


def batch_tensors(batch: dict, device) -> tuple:
    """(tokens (B,S) long, labels (T,) long, mask (T,) float32) of a host batch;
    the mask is the batch's ``loss_mask`` where it has one."""
    tokens = torch.as_tensor(batch["tokens"], device=device).long()
    labels = torch.as_tensor(batch["labels"], device=device).long().reshape(-1)
    mask = batch.get("loss_mask")
    mask = (torch.ones(labels.shape, dtype=torch.float32, device=device) if mask is None
            else torch.as_tensor(mask, device=device).float().reshape(-1))
    return tokens, labels, mask


#: elements of each leaf whose first gradient both sides keep
SAMPLE = 65536


def sample_indices(path: str, numel: int, seed: int) -> torch.Tensor:
    """The flat indices of the elements of leaf ``path`` whose first gradient
    is compared, drawn from the seed and the leaf's name (every element of a
    leaf of at most ``SAMPLE``)."""
    if numel <= SAMPLE:
        return torch.arange(numel)
    gen = torch.Generator().manual_seed((int(seed) * 1000003 + zlib.crc32(path.encode()))
                                        % 2 ** 63)
    return torch.randint(0, numel, (SAMPLE,), generator=gen)


def lr_at(opt: dict, step: int) -> float:
    """Linear warm-up to ``lr`` over ``warmup_steps``, then a cosine to
    ``min_lr_frac * lr`` over ``decay_steps``."""
    if step < opt["warmup_steps"]:
        return opt["lr"] * min(1.0, (step + 1) / max(1, opt["warmup_steps"]))
    t = min(1.0, max(0.0, (step - opt["warmup_steps"])
                     / max(1, opt["decay_steps"] - opt["warmup_steps"])))
    return opt["lr"] * (opt["min_lr_frac"] + (1 - opt["min_lr_frac"]) * 0.5
                        * (1 + math.cos(math.pi * t)))


def train(params: dict, batches: list, opt: dict, loss_fn, sample_seed: int) -> dict:
    """``len(batches)`` AdamW steps from ``params`` (float32 leaves, by path),
    each on its batch: the gradient of ``loss_fn(params, batch)``, clipped to
    a global norm of ``clip_norm``; weight decay on every leaf of two dims or
    more as stored (a segment's layers stacked on the first dim).  Returns the
    readings the check compares: each step's loss, each leaf's gradient norm
    at the first step (after the clip, as AdamW takes it) and its values at
    the leaf's ``sample_indices``, and each leaf's norm of change over all
    the steps."""
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    start = {k: v.detach().clone() for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, grad_norms, samples = [], {}, {}
    for step, batch in enumerate(batches):
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        loss = loss_fn(leaves, batch)
        names = sorted(leaves)
        grads = dict(zip(names, torch.autograd.grad(loss, [leaves[k] for k in names])))
        losses.append(float(loss.detach()))
        norm = torch.sqrt(sum(g.pow(2).sum() for g in grads.values()))
        clip = torch.clamp(opt["clip_norm"] / norm.clamp(min=1e-9), max=1.0)
        if step == 0:
            grad_norms = {k: float(g.norm() * clip) for k, g in grads.items()}
            samples = {k: (g.flatten()[sample_indices(k, g.numel(), sample_seed).to(g.device)]
                           * clip).cpu() for k, g in grads.items()}
        lr = lr_at(opt, step)
        with torch.no_grad():
            for k in names:
                g = grads[k] * clip
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                delta = (m[k] / (1 - b1 ** (step + 1))) / (
                    torch.sqrt(v2[k] / (1 - b2 ** (step + 1))) + eps)
                if params[k].ndim >= 2:
                    delta = delta + wd * params[k]
                params[k] = params[k] - lr * delta
        del grads, leaves, loss
    change = {k: float((params[k] - start[k]).norm()) for k in params}
    return {"loss": losses, "grad_norms": grad_norms, "grad_samples": samples,
            "change_norms": change}
