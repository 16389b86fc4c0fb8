"""Int8-compressed cross-pod gradient all-reduce.

Cross-pod links are the scarcest bandwidth in a multi-pod job; the
within-pod reduction happens at full precision while the pod-to-pod exchange
ships int8 + one fp32 scale per tensor — a 4x (vs fp32) / 2x (vs bf16)
wire-byte reduction.

Implementation: each rank computes the gradients of its ``("pod", "data")``
slice of the batch; a mean over ``data`` in float32 gives its pod's
gradients (the reference's within-pod GSPMD reduction), and the pod-to-pod
all-reduce is an all-gather of the int8 payload + per-pod scales over the
``pod`` group followed by a local dequant-sum (sum_i scale_i * q_i), which is
how compressed collectives are actually realised (you cannot sum int8
payloads with different scales on the wire).  ``torch.round`` rounds half
to even, as ``jnp.round`` does, so ``q`` is the reference's bit for bit.
These are plain torch ops, as the reference's are plain jnp: no kernel.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .. import _tree
from .api import Mesh, gather_stacked, local_slice, mesh_axis_names, mesh_shape


def quantize_int8(x: torch.Tensor):
    """Per-tensor symmetric int8 quantization; returns (q, scale)."""
    xf = x.float()
    amax = xf.abs().max()
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum(x: torch.Tensor, axis_name: str, mesh: Mesh) -> torch.Tensor:
    """All-reduce ``x`` over ``axis_name`` shipping int8 on the wire;
    float32 result."""
    group, n = mesh.get_group(axis_name), mesh_shape(mesh)[axis_name]
    q, scale = quantize_int8(x)
    qs = gather_stacked(q, group, n)                              # int8 on the wire
    ss = gather_stacked(scale.reshape(1), group, n).reshape(n)    # (npods,) fp32 scales
    return torch.einsum("p,p...->...", ss, qs.float())


def _mean_over(x: torch.Tensor, axes: tuple[str, ...], mesh: Mesh) -> torch.Tensor:
    n = 1
    for a in axes:
        dist.all_reduce(x, group=mesh.get_group(a))
        n *= mesh_shape(mesh)[a]
    return x / n


def pod_grads_compressed(grad_fn, params, batch, mesh: Mesh):
    """Run ``grad_fn(params, batch) -> (loss, metrics, grads)`` on this
    rank's ``("pod", "data")`` slice of ``batch``, mean the gradients over
    ``data`` in float32, and combine the pods' with the compressed cross-pod
    all-reduce.  Loss and metrics are means over both axes.  Returns (loss,
    metrics, float32 grads), the same on every rank."""
    names = mesh_axis_names(mesh)
    npods = mesh_shape(mesh)["pod"]
    dp = tuple(a for a in ("pod", "data") if a in names)
    # this rank's rows of every batch leaf, over the dp axes major to minor
    local = _tree.map(lambda v: local_slice(v, (dp,), mesh), batch)
    loss, metrics, grads = grad_fn(params, local)
    if "data" in names:
        grads = _tree.map(lambda g: _mean_over(g.float().clone(), ("data",), mesh), grads)
    grads = _tree.map(lambda g: compressed_psum(g, "pod", mesh) / npods, grads)
    keys = sorted(metrics)
    stats = torch.stack([loss.float()] + [metrics[k].float() for k in keys])
    stats = _mean_over(stats, dp, mesh)
    return stats[0], {k: stats[1 + i] for i, k in enumerate(keys)}, grads
