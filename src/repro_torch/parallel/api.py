"""Logical-axis sharding API (the thin layer every model touches), over
``torch.distributed``.

Models annotate activations with *logical* axes (``batch``, ``seq``,
``embed``, ``heads``, ``ff`` ...).  A :class:`ShardingRules` context resolves
logical axes to mesh axes; outside any context annotations are no-ops so the
same model code runs in single-device tests and on a mesh.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named dims
(``launch.mesh``); the rules read only its axis names and sizes, so they
also take a :class:`MeshShape`, a mesh's shape without any process behind
it (the 256- and 512-chip production shapes).

A rank holds plain local tensors: its slice of each sharded tensor, at its
coordinate on each mesh axis (``local_slice``).  A tensor dim sharded over
several mesh axes (``("pod", "data")``) is split major to minor in the
order of the spec, as JAX splits it.  The explicit paths — the
sequence-sharded decode, the expert-parallel MoE and the int8 cross-pod
all-reduce — exchange what they need through ``all_gather``, ``psum`` and
``pmean`` below (``jax.lax``'s names), whose backwards are their transposes
(a tiled all-gather's is a reduce-scatter), so gradients flow across ranks.
GSPMD's automatic partitioning has no eager counterpart: outside those
paths, ranks compute redundantly, and ``shard`` returns a plain tensor as it
is (it redistributes a ``DTensor`` to the resolved placements).

The reference's ``shard_map_compat`` has no counterpart: what a
``shard_map`` body does runs on each rank as it stands, over its shards.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Optional, Sequence, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

try:
    from torch.distributed.tensor import DTensor, Replicate, Shard
except ImportError:  # pragma: no cover - torch before 2.4
    from torch.distributed._tensor import DTensor, Replicate, Shard

_state = threading.local()

# the flat-buffer collectives under their newer names where torch has them
_all_gather_flat = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter_flat = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor

MeshAxes = Union[None, str, tuple[str, ...]]


def _entry(axes: MeshAxes) -> MeshAxes:
    """An entry as JAX keeps it: a 1-tuple is its axis, an empty one None."""
    if isinstance(axes, (tuple, list)):
        axes = tuple(axes)
        return None if not axes else (axes[0] if len(axes) == 1 else axes)
    return axes


class PartitionSpec(tuple):
    """One entry per tensor dim: None, a mesh axis, or a tuple of them (a
    1-tuple becomes its axis and an empty one None, as in JAX)."""

    def __new__(cls, *axes: MeshAxes):
        return super().__new__(cls, (_entry(a) for a in axes))

    def __repr__(self) -> str:
        return f"PartitionSpec({', '.join(map(repr, self))})"


P = PartitionSpec


class MeshShape:
    """A mesh's axis names and sizes, with no process group behind it: what
    ``rules_for`` reads of a mesh (``axis_names``, and ``shape`` as a dict
    like a JAX mesh's)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError(f"MeshShape: {len(shape)} sizes for axes {tuple(axis_names)}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(n) for n in shape)))

    @property
    def size(self) -> int:
        out = 1
        for n in self.shape.values():
            out *= n
        return out

    def __repr__(self) -> str:
        return f"MeshShape({self.shape})"


Mesh = Union[DeviceMesh, MeshShape]


def mesh_axis_names(mesh: Mesh) -> tuple[str, ...]:
    if isinstance(mesh, DeviceMesh):
        if not mesh.mesh_dim_names:
            raise ValueError("a DeviceMesh without mesh_dim_names has no named axes")
        return tuple(mesh.mesh_dim_names)
    return tuple(mesh.axis_names)


def mesh_shape(mesh: Mesh) -> dict[str, int]:
    """``{axis name: size}`` in mesh order."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh_axis_names(mesh), mesh.shape))
    return dict(mesh.shape)


class ShardingRules:
    """Mapping logical axis -> mesh axis (or tuple, or None)."""

    def __init__(self, **rules: MeshAxes):
        self.rules: dict[str, MeshAxes] = dict(rules)

    def resolve(self, logical: Sequence[Optional[str]]) -> P:
        out = []
        for ax in logical:
            out.append(None if ax is None else self.rules.get(ax))
        return P(*out)

    def replace(self, **kw: MeshAxes) -> "ShardingRules":
        r = dict(self.rules)
        r.update(kw)
        return ShardingRules(**r)


def current_rules() -> Optional[ShardingRules]:
    return getattr(_state, "rules", None)


def current_mesh() -> Optional[Mesh]:
    return getattr(_state, "mesh", None)


@contextmanager
def use_rules(rules: ShardingRules, mesh: Optional[Mesh] = None):
    old_r = getattr(_state, "rules", None)
    old_m = getattr(_state, "mesh", None)
    _state.rules = rules
    _state.mesh = mesh
    try:
        yield
    finally:
        _state.rules = old_r
        _state.mesh = old_m


def logical_spec(logical: Sequence[Optional[str]]) -> P:
    r = current_rules()
    if r is None:
        return P()
    return r.resolve(logical)


def _axes(entry: MeshAxes) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: Sequence[MeshAxes], mesh: Mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim that tensor dim ``d`` names, ``Replicate()`` elsewhere.  DTensor
    splits a tensor dim sharded on several mesh dims in mesh order, so the
    axes of one entry must come in mesh order (then it is the spec's major
    to minor order, as in JAX); a spec that names an axis the mesh lacks,
    or one axis twice, raises ``ValueError``."""
    names = mesh_axis_names(mesh)
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        prev = -1
        for a in _axes(entry):
            if a not in names:
                raise ValueError(f"spec {tuple(spec)} names axis {a!r}, not in {names}")
            j = names.index(a)
            if not isinstance(out[j], Replicate):
                raise ValueError(f"spec {tuple(spec)} names axis {a!r} twice")
            if j < prev:
                raise ValueError(f"spec {tuple(spec)}: the axes {entry} of dim {dim} are not in "
                                 f"mesh order {names}, which DTensor cannot place")
            out[j], prev = Shard(dim), j
    return tuple(out)


def shard(x, *logical: Optional[str]):
    """Annotate ``x`` with logical axes: a ``DTensor`` is redistributed to
    the resolved placements; a plain tensor (one rank's local data) is
    returned as it is, as is anything outside a rules context."""
    r = current_rules()
    if r is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, placements(r.resolve(logical), x.device_mesh))


def named_sharding(mesh: Mesh, logical: Sequence[Optional[str]], rules: ShardingRules) -> tuple:
    """The DTensor placements of the logical axes' spec on ``mesh``."""
    return placements(rules.resolve(logical), mesh)


def spec_leaves(tree) -> list:
    """The tuples (logical specs, or placements) at the leaves of a tree of
    dicts and lists, in the order ``_tree.leaves`` walks a parameter tree."""
    if isinstance(tree, tuple):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in spec_leaves(tree[k])]
    return [leaf for t in tree for leaf in spec_leaves(t)]


# -- a rank's slices ---------------------------------------------------------------


def coordinate(mesh: Mesh) -> dict[str, int]:
    """This rank's ``{axis: index}`` on a DeviceMesh (a rank outside the
    mesh raises ``ValueError``)."""
    coord = mesh.get_coordinate() if isinstance(mesh, DeviceMesh) else None
    if coord is None:
        raise ValueError(f"this process holds no coordinate on {mesh}")
    return dict(zip(mesh_axis_names(mesh), coord))


def _chunk(size: int, dim: int, entry: MeshAxes, sizes: dict, coord: dict) -> tuple[int, int]:
    """(offset, width) of the rank's chunk of a dim of ``size``, the axes of
    ``entry`` major to minor."""
    axes = _axes(entry)
    n, i = 1, 0
    for a in axes:
        n, i = n * sizes[a], i * sizes[a] + coord[a]
    if size % n:
        raise ValueError(f"dim {dim} of size {size} does not split over {axes} ({n} ways)")
    return i * (size // n), size // n


def local_slice(x: torch.Tensor, spec: Sequence[MeshAxes], mesh: Mesh,
                coord: Optional[dict] = None) -> torch.Tensor:
    """This rank's slice of the global tensor ``x`` under ``spec`` (a view):
    each dim narrowed to the chunk at the rank's coordinate (``coord``, or the
    DeviceMesh's own), the axes of a dim major to minor.  A dim its axes do
    not divide raises ``ValueError``."""
    sizes, coord = mesh_shape(mesh), coord if coord is not None else coordinate(mesh)
    for dim, entry in enumerate(spec):
        if _axes(entry):
            off, width = _chunk(x.shape[dim], dim, entry, sizes, coord)
            x = x.narrow(dim, off, width)
    return x


# -- collectives with their transposes as backward ----------------------------------


def axis_index(axis_name: str, mesh: Optional[Mesh] = None) -> int:
    """This rank's index on ``axis_name`` (``jax.lax.axis_index``)."""
    return coordinate(mesh if mesh is not None else current_mesh())[axis_name]


def _group(axis_name: str, mesh: Optional[Mesh]):
    mesh = mesh if mesh is not None else current_mesh()
    if not isinstance(mesh, DeviceMesh):
        raise ValueError(f"a collective over {axis_name!r} needs a DeviceMesh, not {mesh!r}")
    return mesh.get_group(axis_name), mesh_shape(mesh)[axis_name]


def gather_stacked(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """``(n, *x.shape)``: every rank's ``x`` in group rank order, gathered
    into one flat buffer (the form gloo takes as well as NCCL) in x's dtype."""
    out = x.new_empty((n * x.numel(),))
    _all_gather_flat(out, x.contiguous().view(-1), group=group)
    return out.view(n, *x.shape)


def _reduce_scatter_stacked(g: torch.Tensor, group, n: int) -> torch.Tensor:
    """Rank i's row of the sum over ranks of ``g`` (n, *shape)."""
    out = g.new_empty((g[0].numel(),))
    _reduce_scatter_flat(out, g.contiguous().view(-1), group=group)
    return out.view(g.shape[1:])


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis: int, tiled: bool, group, n: int):
        ctx.axis, ctx.tiled, ctx.group, ctx.n = axis, tiled, group, n
        parts = gather_stacked(x, group, n)
        if tiled:
            return torch.cat(parts.unbind(0), dim=axis)
        return parts.movedim(0, axis).contiguous()

    @staticmethod
    def backward(ctx, g):
        if ctx.tiled:
            stacked = torch.stack(g.chunk(ctx.n, dim=ctx.axis))
        else:
            stacked = g.movedim(ctx.axis, 0)
        return _reduce_scatter_stacked(stacked, ctx.group, ctx.n), None, None, None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, scale: float):
        ctx.group, ctx.scale = group, scale
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y * scale if scale != 1.0 else y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return (g * ctx.scale if ctx.scale != 1.0 else g), None, None


def all_gather(x: torch.Tensor, axis_name: str, *, axis: int = 0, tiled: bool = False,
               mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Every rank's ``x`` along ``axis_name`` (``jax.lax.all_gather``): a new
    dim at ``axis``, or with ``tiled`` concatenated along ``axis``.  Its
    backward is the reduce-scatter."""
    group, n = _group(axis_name, mesh)
    return _AllGather.apply(x, axis, tiled, group, n)


def psum(x: torch.Tensor, axis_name: str, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Sum over ``axis_name`` (backward: the sum of the gradients)."""
    group, _ = _group(axis_name, mesh)
    return _AllReduce.apply(x, group, 1.0)


def pmean(x: torch.Tensor, axis_name: str, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Mean over ``axis_name`` (backward: the mean of the gradients)."""
    group, n = _group(axis_name, mesh)
    return _AllReduce.apply(x, group, 1.0 / n)
