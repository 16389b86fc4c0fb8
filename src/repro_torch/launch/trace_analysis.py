"""Per-chip FLOP, byte and collective accounting of a traced step, and the
three roofline terms — the counterpart of the reference's
``launch/hlo_analysis.py``.

The reference lowers a jitted step on fake XLA devices and parses the
partitioned HLO, because XLA's own cost analysis counts a ``while`` body
once.  The port has no HLO to parse: ``launch.dryrun`` runs its own step
functions eagerly on ``DTensor``s whose local shards are meta tensors, over
a fake process group as large as the mesh, and :class:`CountingMode` — a
``TorchDispatchMode`` below ``DTensor`` — sees what one rank runs: the local
ops on its shards and the ``_c10d_functional.*`` collectives that DTensor
issues to redistribute them, and the ``c10d.*`` collectives of the port's
explicit paths (``parallel.api``'s ``all_gather``/``psum``/``pmean``,
``parallel.compression``).  Nothing is allocated and nothing is launched.
An eager trace unrolls every loop, so there is no trip count to find and
``unknown_trip_whiles`` is 0 by construction.

  * FLOPs — ``torch.utils.flop_counter``'s formulas for the matmul-like
    ops (``mm``, ``bmm``, ``addmm``, ``baddbmm``, convolutions), as the
    reference counts only dots; the kernel regions (``kernels.regions``)
    carry the dot FLOPs of the reference's plain regions;
  * collectives — the operand bytes of each all-gather, all-reduce,
    reduce-scatter and all-to-all, by kind under the reference's names;
  * memory — the operand plus result bytes of every op that moves data.
    Views, ``detach``, allocations, metadata ops and the collectives'
    wrapper ops are free, as the reference's ``_FREE_OPS``.

A kernel region is one op, so its bytes are its boundary I/O, what the
hand-written kernel reads and writes (``marked_boundary`` sums them): the
reference's ``pallas_kernel.*`` scopes and ``roofline_kernel_substituted``
are the regions themselves, and the port records one memory figure.  The
reference's bf16-dot correction (``mem_bytes_tpu_adjusted``) has no
counterpart: meta tensors carry their true dtypes.

Where ``DTensor`` has no sharding strategy, the port gives one:
``register_sharding`` for the kernel regions (``kernels.regions``: over the
batch, the heads or replicated), and ``local_map`` with the placements the
rules give for the MoE's routed dispatch (``models.mlp``: top-k, sort,
capacity, ``index_add_``), the sequence-sharded flash-decode
(``models.attention``) and the expert-parallel MoE, which run on local
tensors as they run over gloo and NCCL.  Four more run on each rank's
shards where DTensor's own form would be wrong or whole-sized: the decode
caches' in-place writes (``attention.write_slot``), the loss's target logit
over vocab shards (``train.steps``), reshapes that split a dim its shards
do not divide (``parallel.api.reshape``), and the layers of a stacked
parameter, unbound once (``transformer._layers``).

All figures are per chip.  ``CountingMode`` also follows the bytes of the
local tensors alive during the trace (``peak_bytes``: the largest live
local bytes, backward included, beside the step's arguments).
"""

from __future__ import annotations

import functools
import weakref
from dataclasses import dataclass, field
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

try:
    from torch._subclasses.fake_tensor import FakeTensor
except ImportError:  # pragma: no cover
    FakeTensor = ()

try:
    from torch.distributed.tensor import DTensor
except ImportError:  # pragma: no cover
    DTensor = ()

# op name -> (kind, index of the operand whose bytes travel)
_COLLECTIVE_OPS = {
    "_c10d_functional.all_gather_into_tensor": ("all-gather", 0),
    "_c10d_functional.all_gather_into_tensor_out": ("all-gather", 0),
    "_c10d_functional.all_gather_into_tensor_coalesced": ("all-gather", 0),
    "_c10d_functional.all_reduce": ("all-reduce", 0),
    "_c10d_functional.all_reduce_": ("all-reduce", 0),
    "_c10d_functional.all_reduce_coalesced": ("all-reduce", 0),
    "_c10d_functional.all_reduce_coalesced_": ("all-reduce", 0),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", 0),
    "_c10d_functional.reduce_scatter_tensor_coalesced": ("reduce-scatter", 0),
    "_c10d_functional.all_to_all_single": ("all-to-all", 0),
    "_c10d_functional.broadcast": ("collective-broadcast", 0),
    "_c10d_functional.broadcast_": ("collective-broadcast", 0),
    "_dtensor.shard_dim_alltoall": ("all-to-all", 0),
    "c10d.allreduce_": ("all-reduce", 0),
    "c10d.allreduce_coalesced_": ("all-reduce", 0),
    "c10d.allgather_": ("all-gather", 1),
    "c10d._allgather_base_": ("all-gather", 1),
    "c10d.allgather_into_tensor_coalesced_": ("all-gather", 1),
    "c10d.reduce_scatter_": ("reduce-scatter", 1),
    "c10d._reduce_scatter_base_": ("reduce-scatter", 1),
    "c10d.reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "c10d.alltoall_": ("all-to-all", 1),
    "c10d.alltoall_base_": ("all-to-all", 1),
    "c10d.broadcast_": ("collective-broadcast", 0),
}

# ops that move no bytes of their own: views and metadata, allocations, the
# collectives' wrappers and waits, host scalars
_FREE = {
    "aten.detach", "aten.alias", "aten.lift_fresh", "aten.empty", "aten.empty_strided",
    "aten.empty_like", "aten.new_empty", "aten.new_empty_strided", "aten.item",
    "aten._local_scalar_dense", "aten.promote_types", "aten.sym_size", "aten.sym_stride",
    "aten.sym_numel", "aten.sym_storage_offset", "aten.is_same_size", "aten.contiguous",
    "aten.set_", "aten.resize_", "aten.lift_fresh_copy",
    "_c10d_functional.wait_tensor", "_c10d_functional_autograd.wait_tensor",
    "_c10d_functional._wrap_tensor_autograd", "c10d.barrier", "c10d.monitored_barrier_",
}


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclass
class Stats:
    """Per-chip counts of one traced step (the reference's fields where the
    port has the quantity)."""
    flops: float = 0.0
    mem_bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_by_kind: dict = field(default_factory=dict)
    coll_count: int = 0
    unknown_trip_whiles: int = 0          # an eager trace unrolls every loop
    marked_boundary: float = 0.0          # the kernel regions' boundary I/O
    argument_bytes: float = 0.0
    peak_bytes: float = 0.0


class CountingMode(TorchDispatchMode):
    """Counts what one rank runs, below ``DTensor``: a dispatch that meets a
    DTensor returns ``NotImplemented``, so DTensor's own dispatch runs first
    and this mode sees its local ops and collectives.  The fake tensors of
    DTensor's sharding propagation are run and not counted.  ``arguments``
    are the step's inputs: their local bytes are ``argument_bytes``, alive
    throughout; the peak adds the largest live bytes of what the trace made."""

    def __init__(self, arguments=()):
        super().__init__()
        self.stats = Stats()
        self._pinned: set = set()
        for t in _tensors(arguments):
            t = t._local_tensor if isinstance(t, DTensor) else t
            key = t.untyped_storage()._cdata
            if key not in self._pinned:
                self._pinned.add(key)
                self.stats.argument_bytes += t.untyped_storage().nbytes()
        self._refs: dict = {}         # storage -> [live tensors, bytes]
        self._live = 0

    def _release(self, key) -> None:
        entry = self._refs[key]
        entry[0] -= 1
        if entry[0] == 0:
            self._live -= entry[1]
            del self._refs[key]

    def _track(self, out) -> None:
        for t in _tensors(out):
            if isinstance(t, (DTensor, FakeTensor)) or t.layout != torch.strided:
                continue
            key = t.untyped_storage()._cdata
            if key in self._pinned:
                continue
            entry = self._refs.get(key)
            if entry is None:
                # the tensor's own bytes: a fake collective may return a
                # chunk of a buffer its real kernel never allocates
                entry = self._refs[key] = [0, nbytes(t)]
                self._live += entry[1]
                self.stats.peak_bytes = max(self.stats.peak_bytes, self._live)
            entry[0] += 1
            weakref.finalize(t, self._release, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if DTensor and any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if FakeTensor and any(issubclass(t, FakeTensor) for t in types):
            return out                                  # DTensor's sharding propagation
        st = self.stats
        name = func._schema.name.replace("::", ".")
        coll = _COLLECTIVE_OPS.get(name)
        if coll is not None:
            kind, i = coll
            b = float(sum(nbytes(t) for t in _tensors(args[i])))
            st.coll_bytes += b
            st.coll_count += 1
            st.coll_by_kind[kind] = st.coll_by_kind.get(kind, 0.0) + b
            st.mem_bytes += b + sum(nbytes(t) for t in _tensors(out))
            self._track(out)
            return out
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            st.flops += float(formula(*args, **kwargs, out_val=out))
        if not (func.is_view or name in _FREE):
            b = float(sum(nbytes(t) for t in _tensors(args) + _tensors(kwargs))
                      + sum(nbytes(t) for t in _tensors(out)))
            st.mem_bytes += b
            if name.startswith("repro_torch."):
                st.marked_boundary += b
        self._track(out)
        return out


# ---------------------------------------------------------------------------
# roofline terms (the H100 SXM's data-sheet peaks)
# ---------------------------------------------------------------------------

# The data sheet's figures for one H100 SXM (80 GB HBM3), not measurements:
# dense bf16 tensor-core FLOP/s, HBM3 bytes/s, and NVLink 4's bytes/s each
# way (900 GB/s both ways).  Across nodes a rank's link is its NIC, not
# NVLink, so the collective term of a mesh larger than a node is a floor.
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 450e9


def roofline_terms(flops_per_chip: float, bytes_per_chip: float,
                   coll_bytes_per_chip: float) -> dict:
    t_c = flops_per_chip / PEAK_FLOPS
    t_m = bytes_per_chip / HBM_BW
    t_x = coll_bytes_per_chip / LINK_BW
    dom = max(("compute", t_c), ("memory", t_m), ("collective", t_x), key=lambda kv: kv[1])
    hard_bound = max(t_c, t_m, t_x)
    return {
        "compute_s": t_c,
        "memory_s": t_m,
        "collective_s": t_x,
        "bottleneck": dom[0],
        "bound_step_time_s": hard_bound,
        "roofline_fraction": (t_c / hard_bound) if hard_bound else None,
    }


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N_active*D for train, 2*N_active*D forward-only
    (D = tokens processed; decode processes one token per sequence)."""
    n_active = active_params(cfg)
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch


def active_params(cfg, shapes: Optional[dict] = None) -> float:
    """Parameters touched per token (MoE: top_k of n_routed experts), over
    the port's fake parameter tree (``launch.specs.params_shapes``).
    Routed-expert tensors are identified by the expert dim E in the first two
    axes of a >=3-d stacked leaf ((layers, E, d, ff) / (E, d, ff))."""
    from .. import _tree

    if shapes is None:
        return _active_params(cfg)
    E = cfg.moe.n_routed if cfg.moe is not None else None
    total = 0.0
    for leaf in _tree.leaves(shapes):
        n = 1
        for d in leaf.shape:
            n *= d
        if E is not None and len(leaf.shape) >= 3 and E in leaf.shape[:2]:
            n = n * cfg.moe.top_k / E
        total += n
    return float(total)


@functools.lru_cache(maxsize=None)
def _active_params(cfg) -> float:
    from .specs import params_shapes

    return active_params(cfg, params_shapes(cfg))
