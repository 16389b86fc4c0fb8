"""Plain PyTorch versions of the hand-written kernels (the ``ref.py``
contract): each is the semantic ground truth its kernel is held against,
and what a kernel's wrapper runs for tensors that lie on the CPU."""

from __future__ import annotations

import torch


def matmul_ref(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """float32 product (full float32, never TF32) cast back to ``x.dtype``."""
    return (x.float() @ y.float()).to(x.dtype)
