"""Shared primitive tables for the HIR <-> PyTorch/CUDA lowering boundary.

Two components speak both HIR and PyTorch:

  * ``lower/to_torch.py`` — HIR -> plain PyTorch (algorithm extraction),
  * ``lower/to_cuda.py``  — HIR -> generated CUDA C++ kernel (hardware
    adaptation) and its plain PyTorch version.

They share one HIR-arith-op -> torch implementation table and one dtype
policy, so adding an HIR arith op is a one-table change (plus its C
spelling in ``to_cuda``).

Dtype policy
------------
``torch_dtype`` is the faithful mapping used by the functional
(``to_torch``) lowering: every HIR type maps to a torch dtype that
represents it losslessly (``f64 -> float64``, ``f16 -> float16``).

``cuda_dtype`` is the mapping used by the CUDA lowering.  Hopper computes
``f64`` and ``f16`` natively, so nothing is coerced and nothing warns:
``f64 -> float64``, ``f32 -> float32``, ``f16 -> float16``, integers ->
``int32`` (HIR ints are <= 32 bits in this flow).  ``allow_downcast`` is
accepted for signature parity with the TPU policy and has no effect.
"""

from __future__ import annotations

from typing import Any

import torch

from .. import ir


class PrecisionWarning(UserWarning):
    """A lowering changed numeric precision/format.  The CUDA dtype policy
    never needs to; the class exists so callers can filter on it."""


def torch_dtype(t: ir.Type) -> torch.dtype:
    """Faithful HIR type -> torch dtype (functional lowering)."""
    if isinstance(t, ir.IntType):
        return torch.int32 if t.width <= 32 else torch.int64
    if isinstance(t, ir.FloatType):
        return {16: torch.float16, 32: torch.float32, 64: torch.float64}[t.width]
    raise TypeError(t)


def cuda_dtype(t: ir.Type, allow_downcast: bool = False) -> torch.dtype:
    """Hopper HIR type -> torch dtype.

    Every float width the IR has is native on the card, so the mapping is
    lossless: it never raises on ``f64``, never warns, and ignores
    ``allow_downcast`` (kept so call sites read like the TPU policy's)."""
    del allow_downcast
    if isinstance(t, ir.IntType):
        return torch.int32
    if isinstance(t, ir.FloatType):
        return {16: torch.float16, 32: torch.float32, 64: torch.float64}[t.width]
    raise TypeError(t)


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


def _is_int(x) -> bool:
    if _is_tensor(x):
        return not (x.dtype.is_floating_point or x.dtype.is_complex)
    return isinstance(x, (int, bool))


def _shift(a, b, left: bool):
    """Shift with the semantics of the reference: the count is taken as
    unsigned, a count >= the width gives 0 (left) or the sign fill (right)."""
    if not _is_tensor(a) and not _is_tensor(b):
        if not 0 <= b < 32:
            return 0 if left or a >= 0 else -1
        return a << b if left else a >> b
    if not _is_tensor(b):
        if 0 <= b < 32:
            return a << b if left else a >> b
        return torch.zeros_like(a) if left else a >> 31
    if not _is_tensor(a):
        a = torch.full_like(b, a)
    ok = (b >= 0) & (b < 32)
    sb = torch.where(ok, b, torch.zeros_like(b))
    over = torch.zeros_like(a) if left else a >> 31
    return torch.where(ok, a << sb if left else a >> sb, over)


def _select(c, a, b):
    if not _is_tensor(c):
        return a if c != 0 else b
    if not _is_tensor(a) and not _is_tensor(b):
        is_f = isinstance(a, float) or isinstance(b, float)
        a = torch.full(c.shape, a, device=c.device,
                       dtype=torch.float32 if is_f else torch.int32)
    return torch.where(c != 0, a, b)


def torch_arith_table() -> dict[str, Any]:
    """HIR arith op name -> torch implementation.

    Works on tensors and on python scalars alike (the lowerings feed it
    python ints for constant operands, which fold in Python before they meet
    a tensor).  Division is *floor* division on integers — matching the RTL
    semantics (signed floor div) on the domains where both are defined.
    ``int32`` tensors wrap on overflow; compares yield ``int32`` 0/1."""

    def _as_i32(x):
        return x.to(torch.int32) if _is_tensor(x) else int(x)

    return {
        "add": lambda a, b: a + b,
        "sub": lambda a, b: a - b,
        "mult": lambda a, b: a * b,
        "div": lambda a, b: a // b if _is_int(a) and _is_int(b) else a / b,
        "and": lambda a, b: a & b,
        "or": lambda a, b: a | b,
        "xor": lambda a, b: a ^ b,
        "not": lambda a: ~a,
        "shl": lambda a, b: _shift(a, b, left=True),
        "shr": lambda a, b: _shift(a, b, left=False),
        "cmp_lt": lambda a, b: _as_i32(a < b),
        "cmp_le": lambda a, b: _as_i32(a <= b),
        "cmp_eq": lambda a, b: _as_i32(a == b),
        "cmp_ne": lambda a, b: _as_i32(a != b),
        "cmp_gt": lambda a, b: _as_i32(a > b),
        "cmp_ge": lambda a, b: _as_i32(a >= b),
        "select": _select,
        "trunc": lambda a: a,
        "zext": lambda a: a,
        "sext": lambda a: a,
    }


#: ops with memory/timing effects — everything else is pure SSA dataflow
EFFECTFUL_OPS = ("mem_read", "mem_write", "call", "for", "unroll_for")


def schedule_key(op: ir.Operation) -> tuple:
    """Schedule-order sort key: start offset, reads before writes on cycle
    ties (the hardware read phase samples pre-write state)."""
    off = op.start.offset if op.start is not None else 0
    rw = 0 if op.opname == "mem_read" else 1
    return (off, rw)


# -- memref access over tensors ------------------------------------------------
#
# Both lowerings keep each memref as one tensor, of the memref's shape or
# with one leading ``lanes`` dimension (independent stimulus vectors run side
# by side — the written-out counterpart of a ``vmap`` over the callable).
# An index is a python int or, when it depends on data or on a lane, a
# tensor of shape ``(lanes,)``.


def _mem_key(arr: torch.Tensor, idx: tuple, batched: bool) -> tuple:
    if not batched:
        return tuple(i.long() if _is_tensor(i) else int(i) for i in idx)
    if not any(_is_tensor(i) for i in idx):
        return (slice(None),) + tuple(int(i) for i in idx)
    lanes = torch.arange(arr.shape[0], device=arr.device)
    return (lanes,) + tuple(i.long() if _is_tensor(i) else int(i) for i in idx)


def mem_load(arr: torch.Tensor, idx: tuple, batched: bool):
    """``arr[idx]`` for every lane, as a copy: a read samples the memory
    when it runs, and later in-place writes must not show through."""
    return arr[_mem_key(arr, idx, batched)].clone()


def mem_store(arr: torch.Tensor, idx: tuple, val, pred, batched: bool) -> None:
    """``arr[idx] = val`` for every lane, in place; with ``pred`` the old
    value stays where ``pred == 0`` (read-modify-``where``)."""
    key = _mem_key(arr, idx, batched)
    if pred is None and not _is_tensor(val):
        arr[key] = val
        return
    x = val.to(arr.dtype) if _is_tensor(val) else torch.as_tensor(
        val, dtype=arr.dtype, device=arr.device)
    if pred is not None:
        p = pred if _is_tensor(pred) else torch.as_tensor(pred, device=arr.device)
        x = torch.where(p != 0, x, arr[key])
    arr[key] = x
