"""Functional (algorithm-component) lowering of HIR to plain PyTorch.

The paper decomposes a hardware design into *algorithm*, *schedule* and
*binding* (§4).  This lowering extracts the algorithm component: an HIR
function becomes a PyTorch function over its memref arguments —
``hir.for`` -> a Python loop, ``hir.unroll_for`` -> the same loop,
memrefs -> tensors, ``hir.delay`` -> identity.

It is the cross-check that a *schedule* never changes *functionality*: for
every gallery kernel, ``simulate(...)`` (cycle-accurate) and
``lower_to_torch(...)`` (schedule-free) must agree — a strong property test
of the whole IR stack.

Memory-effect ordering: effectful ops execute in schedule order within each
region (reads before writes on ties), iterations in index order.  This agrees
with the cycle-accurate semantics whenever cross-iteration memory dependences
flow forward in time — true for all verified race-free designs in the gallery;
the simulator remains the authority on cycle semantics.

Memrefs are private copies of the caller's arrays, updated in place (eager
PyTorch has no trace to keep pure, and a copy per write would dominate the
run); the caller's arrays are never touched.  Each memref argument may carry
one leading ``lanes`` dimension: all lanes then run side by side.

This walker (thunks over chained environments, no phase split) is kept apart
from the one in ``to_cuda.py`` on purpose: the generated kernels and their
plain version are held against it as an independent witness, so it shares
with them only the stimulus handling (``as_lane_tensors``) and the arith and
memory helpers of ``common.py``.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Union

import torch

from ..._device import resolve_device
from .. import ir
from ..ir import ForOp, FuncOp, MemrefType, Module, Operation, Region, Value
from .common import EFFECTFUL_OPS as _EFFECTFUL
from .common import mem_load, mem_store
from .common import schedule_key as _schedule_key
from .common import torch_arith_table as _torch_arith
from .common import torch_dtype as _torch_dtype


class _Thunk:
    __slots__ = ("fn", "_val", "_done")

    def __init__(self, fn: Callable[[], Any]):
        self.fn = fn
        self._done = False
        self._val = None

    def force(self) -> Any:
        if not self._done:
            self._val = self.fn()
            self._done = True
        return self._val


class _Env:
    def __init__(self, parent: Optional["_Env"] = None):
        self.vals: dict[Value, Any] = {}
        self.parent = parent

    def get(self, v: Value) -> Any:
        e: Optional[_Env] = self
        while e is not None:
            if v in e.vals:
                return e.vals[v]
            e = e.parent
        raise KeyError(f"%{v.name}")

    def set(self, v: Value, x: Any) -> None:
        self.vals[v] = x


def as_memref_tensor(x, mt: MemrefType, dtype: torch.dtype, device: torch.device,
                     copy: bool = True) -> tuple[torch.Tensor, bool]:
    """Stimulus ``x`` as a contiguous tensor of ``dtype`` on ``device`` — a
    private copy unless ``copy=False`` (for callers that only read it); also
    says whether it carries a leading ``lanes`` dimension."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
    t = t.to(device=device, dtype=dtype, copy=copy).contiguous()
    shape = tuple(mt.shape)
    if tuple(t.shape) == shape:
        return t, False
    if tuple(t.shape[1:]) == shape:
        return t, True
    raise ValueError(f"stimulus of shape {tuple(t.shape)} fits neither "
                     f"{shape} nor (lanes, *{shape})")


def as_lane_tensors(arrays, types, dtypes, device: torch.device,
                    copy: bool = True) -> tuple[list[torch.Tensor], Optional[int]]:
    """One tensor per memref of ``types`` from the stimulus ``arrays`` (see
    ``as_memref_tensor``), and the number of lanes: None when no array has a
    lanes dimension; otherwise the arrays without one are repeated for every
    lane."""
    pairs = [as_memref_tensor(x, mt, dt, device, copy)
             for x, mt, dt in zip(arrays, types, dtypes)]
    lanes = {t.shape[0] for t, b in pairs if b}
    if len(lanes) > 1:
        raise ValueError(f"stimulus arrays disagree on lanes: {sorted(lanes)}")
    n = lanes.pop() if lanes else None
    return [t if b or n is None else t.expand(n, *t.shape).contiguous()
            for t, b in pairs], n


class _Lowerer:
    def __init__(self, module: Module, device: torch.device):
        self.module = module
        self.device = device
        self.arith = _torch_arith()
        self.lanes: Optional[int] = None      # None: no lanes dimension

    # -- public ---------------------------------------------------------
    def lower(self, func: FuncOp) -> Callable:
        def fn(*args):
            if len(args) != len(func.args):
                raise ValueError(f"@{func.name} takes {len(func.args)} arguments, "
                                 f"got {len(args)}")
            env = _Env()
            store: dict[str, torch.Tensor] = {}
            storage_of: dict[Value, str] = {}
            mems = [(a, x) for a, x in zip(func.args, args)
                    if isinstance(a.type, MemrefType)]
            for a, x in zip(func.args, args):
                if not isinstance(a.type, MemrefType):
                    env.set(a, x)
            tensors, self.lanes = as_lane_tensors(
                [x for _, x in mems], [a.type for a, _ in mems],
                [_torch_dtype(a.type.elem) for a, _ in mems], self.device)
            for (a, _), t in zip(mems, tensors):
                store[f"arg_{a.name}"] = t
                storage_of[a] = f"arg_{a.name}"
            self._run_region(func.body, env, store, storage_of)
            return {
                a.name: store[f"arg_{a.name}"]
                for a in func.args
                if isinstance(a.type, MemrefType) and a.type.port in (ir.PORT_W, ir.PORT_RW)
            }

        return fn

    # -- helpers ------------------------------------------------------------
    def _val(self, env: _Env, v: Value) -> Any:
        x = env.get(v)
        return x.force() if isinstance(x, _Thunk) else x

    def _register_pure(self, ops, env: _Env, store: dict,
                       storage_of: dict[Value, str]) -> None:
        for op in ops:
            o = op.opname
            if o == "constant":
                env.set(op.result, op.attrs["value"])
            elif o == "alloc":
                # allocs create zeroed storage immediately
                key = f"alloc_{op.results[0].id}"
                for r in op.results:
                    storage_of[r] = key
                base: MemrefType = op.attrs["base"]
                shape = tuple(base.shape)
                if self.lanes is not None:
                    shape = (self.lanes,) + shape
                store[key] = torch.zeros(shape, dtype=_torch_dtype(base.elem),
                                         device=self.device)
            elif o in ir.ARITH_OPS:
                env.set(op.result, _Thunk(lambda op=op, env=env: self.arith[op.opname](
                    *[self._val(env, v) for v in op.operands])))
            elif o == "delay":
                env.set(op.result, _Thunk(lambda op=op, env=env: self._val(env, op.operands[0])))

    def _run_region(self, region: Region, env: _Env, store: dict,
                    storage_of: dict[Value, str]) -> None:
        self._register_pure(region.ops, env, store, storage_of)
        for op in sorted([o for o in region.ops if o.opname in _EFFECTFUL], key=_schedule_key):
            self._run_effect(op, env, store, storage_of)

    def _run_effect(self, op: Operation, env: _Env, store: dict,
                    storage_of: dict[Value, str]) -> None:
        o = op.opname
        batched = self.lanes is not None
        if o == "mem_read":
            key = storage_of[op.operands[0]]
            idx = tuple(self._val(env, v) for v in op.operands[1:])
            env.set(op.result, mem_load(store[key], idx, batched))
            return

        if o == "mem_write":
            value_v, mem_v, idx_vs, pred_v = ir.mem_write_parts(op)
            idx = tuple(self._val(env, v) for v in idx_vs)
            val = self._val(env, value_v)
            pred = self._val(env, pred_v) if pred_v is not None else None
            mem_store(store[storage_of[mem_v]], idx, val, pred, batched)
            return

        if o == "call":
            callee = self.module.funcs.get(op.attrs["callee"])
            if callee is None or callee.attrs.get("external"):
                raise NotImplementedError(
                    f"functional lowering of external @{op.attrs['callee']} needs a PyTorch model"
                )
            sub = _Env()
            sub_storage: dict[Value, str] = {}
            for formal, actual in zip(callee.args, op.operands):
                if isinstance(formal.type, MemrefType):
                    sub_storage[formal] = storage_of[actual]
                else:
                    sub.set(formal, self._val(env, actual))
            self._run_region(callee.body, sub, store, sub_storage)
            for bop in callee.body.ops:
                if bop.opname == "return" and bop.operands:
                    for r, v in zip(op.results, bop.operands):
                        env.set(r, self._val(sub, v))
            return

        if isinstance(op, ForOp):
            self._run_loop(op, env, store, storage_of)
            return

        raise NotImplementedError(f"to_torch: op hir.{o}")  # pragma: no cover

    def _run_loop(self, op: ForOp, env: _Env, store: dict,
                  storage_of: dict[Value, str]) -> None:
        lbv = self._val(env, op.lb)
        ubv = self._val(env, op.ub)
        stepv = self._val(env, op.step)
        if not all(isinstance(x, int) for x in (lbv, ubv, stepv)):
            raise NotImplementedError("to_torch: loops need constant bounds")
        for ivv in range(lbv, ubv, stepv):
            it = _Env(env)
            it.set(op.iv, ivv)
            self._run_region(op.region(0), it, store, storage_of)


def lower_to_torch(module: Module, func_name: str,
                   pipeline: Optional[str] = None, *,
                   device: Optional[Union[str, torch.device]] = None) -> Callable:
    """Lower ``@func_name`` to a PyTorch function: arrays in (one per memref
    arg, scalars for primitives), dict of final writable-memref tensors out.

    ``pipeline`` optionally names a ``PassManager`` spec (e.g.
    ``"canonicalize,cse,dce"``) run on ``module`` (in place) before lowering.
    ``device=None`` means the CUDA device (raises when there is none)."""
    dev = resolve_device(device)
    if pipeline:
        from ..passmgr import PassManager

        PassManager.from_spec(pipeline).run(module)
    return _Lowerer(module, dev).lower(module.get(func_name))
