"""Tiled matmul — the Hopper binding of the paper's systolic GEMM (§7.3).

The HIR GEMM describes a 16x16 systolic array via nested unroll_for with
distributed-memref banking.  On the card the binding component becomes
thread-block tiling: one block per (bm x bn) output tile, a loop on K inside
the block over a ring of shared-memory stages, accumulating in float32
registers (``csrc/matmul.cu``).  One kernel per dtype:

* bfloat16 runs ``mm_bf16_wgmma`` on the tensor cores: ``wgmma`` products
  fed by TMA loads, one producer warp and one or two consumer warpgroups;
* float32 runs ``mm_f32`` on the CUDA cores: full float32 products, never
  TF32, so integer-valued inputs give integer-exact results, which the GEMM
  binding relies on.

A bfloat16 pair never reaches the CUDA-core kernel.  Tiling contract, per
dtype (``check_schedule``): tiles divide the (padded) dims and rows are
16-byte aligned; bfloat16 adds ``wgmma``'s rules (bm 64 or 128, bn and bk
multiples of 16 up to 256) and a ring of at least 3 stages within shared
memory; float32 adds the block's thread and register limits, 16-byte copies
(bn and bk multiples of 4) and its ring of 3 slabs within shared memory.
There is no backward kernel (no training path runs it): on the card, under
grad with an input that requires it, the call raises ``NotImplementedError``
before any launch.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .ref import matmul_ref

SMEM_BYTES = 232_448            # shared memory one block can use on Hopper (227 KB)
MAX_THREADS = 1024              # threads per block
MAX_THREADS_MICRO8 = 256        # an 8x8 micro-tile holds 64 accumulators a thread:
                                # more than 256 such threads overrun the register file
MIN_THREADS = 64                # below this a block cannot hide latency; shrink the patch
F32_RING = 3                    # slabs of K in flight in the float32 kernel
BF16_MIN_STAGES, BF16_MAX_STAGES = 3, 8
WGMMA_WIDTHS = (256, 128, 64, 32, 16)

#: kernel launches made by ``matmul`` (a run resets it to 0, drives its path,
#: and reads it to show the path used the kernel)
launches = 0

_SYMBOL = {torch.float32: "launch_matmul_f32", torch.bfloat16: "launch_matmul_bf16_wgmma"}
_KERNEL = {torch.float32: "mm_f32", torch.bfloat16: "mm_bf16_wgmma"}
_launchers: dict = {}


def micro_tile(bm: int, bn: int) -> int:
    """Edge of the square patch of outputs one float32 thread accumulates:
    the largest of 8, 4, 2, 1 that divides both tile dims and still leaves a
    block of at least ``MIN_THREADS`` threads."""
    for t in (8, 4, 2):
        if bm % t == 0 and bn % t == 0 and (bm // t) * (bn // t) >= MIN_THREADS:
            return t
    return 1


def f32_slab(bk: int) -> int:
    """Depth of one slab of K in the float32 kernel's ring: 32, or the part
    of ``bk`` that 32 shares with it."""
    return math.gcd(bk, 32)


def wgmma_width(bn: int) -> int:
    """N of one ``wgmma`` instruction: the widest of 256..16 that divides bn."""
    return next((w for w in WGMMA_WIDTHS if bn % w == 0), 0)


def stage_bytes(bm: int, bn: int, bk: int) -> int:
    """One bfloat16 stage (bm x bk of x, bk x bn of y), rounded up to 1 KB."""
    return -(-(bm * bk + bk * bn) * 2 // 1024) * 1024


def ring_stages(bm: int, bn: int, bk: int) -> int:
    """Stages of the bfloat16 ring: as many as fit, at most 8 (below 3 the
    schedule is refused)."""
    room = SMEM_BYTES - 1024 - 2 * BF16_MAX_STAGES * 8       # alignment slack, barriers
    return min(BF16_MAX_STAGES, room // stage_bytes(bm, bn, bk))


def check_schedule(M: int, N: int, K: int, bm: int, bn: int, bk: int,
                   elem_bytes: int = 2) -> list[str]:
    """HIR-style static schedule verification for the kernel binding:
    returns a list of diagnostics (empty = clean).  ``elem_bytes`` 2 is the
    bfloat16 kernel, 4 the float32 one."""
    errs = []
    for name, b, d in (("bm", bm, M), ("bn", bn, N), ("bk", bk, K)):
        if b <= 0 or d % b:
            errs.append(f"{name}={b} does not tile dim {d}")
    if errs:
        return errs
    if elem_bytes == 2:
        if bm not in (64, 128):
            errs.append(f"bm={bm}: a wgmma tile takes 64 or 128 rows "
                        "(one or two consumer warpgroups of 64)")
        if bn % 16 or bn > 256:
            errs.append(f"bn={bn}: a wgmma tile takes a multiple of 16 columns up to 256")
        if bk % 16 or bk > 256:
            errs.append(f"bk={bk}: a wgmma stage takes a multiple of 16 up to 256 "
                        "(k16 steps; a TMA box edge)")
        if not errs and ring_stages(bm, bn, bk) < BF16_MIN_STAGES:
            errs.append(f"a ring of {BF16_MIN_STAGES} stages of {stage_bytes(bm, bn, bk)} "
                        f"bytes exceeds shared memory {SMEM_BYTES}")
    else:
        t = micro_tile(bm, bn)
        threads = (bm // t) * (bn // t)
        limit = MAX_THREADS_MICRO8 if t == 8 else MAX_THREADS
        if threads > limit:
            errs.append(f"output tile ({bm},{bn}) needs {threads} threads of {t}x{t} "
                        f"outputs each, over the limit of {limit} per block")
        if bn % 4 or bk % 4:
            errs.append(f"bn={bn}, bk={bk}: 16-byte copies need multiples of 4")
        else:
            ks = f32_slab(bk)
            ring = F32_RING * (bm * (ks + 4) + ks * bn) * 4
            if ring > SMEM_BYTES:
                errs.append(f"a ring of {F32_RING} slabs of {ks} ({ring} bytes) exceeds "
                            f"shared memory {SMEM_BYTES}")
    for name, row in (("x", K), ("y", N), ("out", N)):
        if (row * elem_bytes) % 16:
            errs.append(f"rows of {name} ({row} x {elem_bytes} bytes) not 16-byte aligned")
    return errs


def schedule(bm: int, bn: int, bk: int, dtype: torch.dtype) -> dict:
    """What a (checked) call runs: the kernel, its launcher, the tile and the
    kernel's own parameters of it."""
    out = {"kernel": _KERNEL[dtype], "launcher": _SYMBOL[dtype], "bm": bm, "bn": bn, "bk": bk}
    if dtype == torch.bfloat16:
        out.update(stages=ring_stages(bm, bn, bk), wgmma_n=wgmma_width(bn),
                   consumer_warpgroups=bm // 64)
    else:
        out.update(micro=micro_tile(bm, bn), slab=f32_slab(bk))
    return out


def _launcher(dtype: torch.dtype):
    if dtype not in _launchers:
        lib = _build.load_library(*_build.csrc_source("matmul.cu"))
        _launchers[dtype] = _build.bind(
            lib, _SYMBOL[dtype],
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    return _launchers[dtype]


def matmul(x: torch.Tensor, y: torch.Tensor, *, bm: int = 128, bn: int = 128,
           bk: int = 16) -> torch.Tensor:
    """(M,K) @ (K,N); dims must tile by (bm,bn,bk) — ``ops.matmul`` pads.

    CUDA tensors launch the dtype's kernel (or raise); CPU tensors take the
    plain version.  float32 and bfloat16; the result has the inputs' dtype."""
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
    _build.refuse_grad("matmul", x, y)
    bm, bn, bk = min(bm, M), min(bn, N), min(bk, K)
    errs = check_schedule(M, N, K, bm, bn, bk, x.element_size())
    if errs:
        raise ValueError("; ".join(errs))
    global launches
    s = schedule(bm, bn, bk, x.dtype)
    extra = (s["stages"], s["wgmma_n"]) if x.dtype == torch.bfloat16 else (s["micro"], s["slab"])
    x, y = x.contiguous(), y.contiguous()
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    rc = _build.on_device(x.device, _launcher(x.dtype), x.data_ptr(), y.data_ptr(),
                          out.data_ptr(), M, N, K, bm, bn, bk, *extra)
    _build.check_launch(rc, _SYMBOL[x.dtype])
    launches += 1
    return out
