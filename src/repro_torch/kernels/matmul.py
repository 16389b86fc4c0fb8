"""Tiled matmul — the Hopper binding of the paper's systolic GEMM (§7.3).

The HIR GEMM describes a 16x16 systolic array via nested unroll_for with
distributed-memref banking.  On the card the binding component becomes
thread-block tiling: one block per (bm x bn) output tile, (bm x bk) and
(bk x bn) tiles staged through shared memory over a loop on K inside the
block, accumulating in float32 registers (``csrc/matmul.cu``).  Products are
full float32 on the CUDA cores: integer-valued inputs give integer-exact
results, which the GEMM binding relies on.

Tiling contract (checked by ``core.verifier``-style ``check_schedule``):
tiles divide the (padded) dims; each thread owns a ``micro x micro`` patch of
the tile, and the resulting block fits the card's thread and register
limits; the staged float32 tiles fit the 227 KB of shared memory a block
can use; rows of the operands are 16-byte aligned (the kernel stages with
scalar loads today; the contract leaves room for 16-byte ones).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import matmul_ref

SMEM_BYTES = 232_448            # shared memory one block can use on Hopper (227 KB)
MAX_THREADS = 1024              # threads per block
MAX_THREADS_MICRO8 = 256        # an 8x8 micro-tile holds 64 accumulators a thread:
                                # more than 256 such threads overrun the register file
MIN_THREADS = 64                # below this a block cannot hide latency; shrink the patch

#: kernel launches made by ``matmul`` (a run resets it to 0, drives its path,
#: and reads it to show the path used the kernel)
launches = 0

_SYMBOL = {torch.float32: "launch_matmul_f32", torch.bfloat16: "launch_matmul_bf16"}
_launchers: dict = {}


def micro_tile(bm: int, bn: int) -> int:
    """Edge of the square patch of outputs one thread accumulates: the
    largest of 8, 4, 2, 1 that divides both tile dims and still leaves a
    block of at least ``MIN_THREADS`` threads."""
    for t in (8, 4, 2):
        if bm % t == 0 and bn % t == 0 and (bm // t) * (bn // t) >= MIN_THREADS:
            return t
    return 1


def check_schedule(M: int, N: int, K: int, bm: int, bn: int, bk: int,
                   elem_bytes: int = 2) -> list[str]:
    """HIR-style static schedule verification for the kernel binding:
    returns a list of diagnostics (empty = clean)."""
    errs = []
    for name, b, d in (("bm", bm, M), ("bn", bn, N), ("bk", bk, K)):
        if b <= 0 or d % b:
            errs.append(f"{name}={b} does not tile dim {d}")
    if errs:
        return errs
    t = micro_tile(bm, bn)
    threads = (bm // t) * (bn // t)
    limit = MAX_THREADS_MICRO8 if t == 8 else MAX_THREADS
    if threads > limit:
        errs.append(f"output tile ({bm},{bn}) needs {threads} threads of {t}x{t} "
                    f"outputs each, over the limit of {limit} per block")
    staged = (bk * (bm + 1) + bk * bn) * 4      # tiles are staged as float32
    if staged > SMEM_BYTES:
        errs.append(f"staged tiles {staged} bytes exceed shared memory {SMEM_BYTES}")
    for name, row in (("x", K), ("y", N), ("out", N)):
        if (row * elem_bytes) % 16:
            errs.append(f"rows of {name} ({row} x {elem_bytes} bytes) not 16-byte aligned")
    return errs


def _launcher(dtype: torch.dtype):
    if dtype not in _launchers:
        lib = _build.load_library(*_build.csrc_source("matmul.cu"))
        _launchers[dtype] = _build.bind(
            lib, _SYMBOL[dtype],
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    return _launchers[dtype]


def matmul(x: torch.Tensor, y: torch.Tensor, *, bm: int = 128, bn: int = 128,
           bk: int = 16) -> torch.Tensor:
    """(M,K) @ (K,N); dims must tile by (bm,bn,bk) — ``ops.matmul`` pads.

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version.  float32 and bfloat16; the result has the inputs' dtype."""
    M, K = x.shape
    K2, N = y.shape
    if K != K2:
        raise ValueError(f"inner dims differ: {tuple(x.shape)} @ {tuple(y.shape)}")
    if x.dtype != y.dtype or x.dtype not in _SYMBOL:
        raise TypeError(f"matmul takes float32 or bfloat16 pairs, got {x.dtype}, {y.dtype}")
    if x.device != y.device:
        raise ValueError(f"operands on different devices: {x.device}, {y.device}")
    if x.device.type != "cuda":
        return matmul_ref(x, y)         # the plain version has no tiles
    bm, bn, bk = min(bm, M), min(bn, N), min(bk, K)
    errs = check_schedule(M, N, K, bm, bn, bk, x.element_size())
    if errs:
        raise ValueError("; ".join(errs))
    global launches
    x, y = x.contiguous(), y.contiguous()
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _launcher(x.dtype)(x.data_ptr(), y.data_ptr(), out.data_ptr(),
                                M, N, K, bm, bn, bk, micro_tile(bm, bn), stream)
    _build.check_launch(rc, _SYMBOL[x.dtype])
    launches += 1
    return out
