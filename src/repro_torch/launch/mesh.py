"""Mesh construction over ``torch.distributed``.

A mesh is a ``DeviceMesh`` of the world's ranks, one process a rank (one
card a rank on the GPU), with named dims.  The world must exist before a
mesh of more than one rank is made: each process calls
``torch.distributed.init_process_group`` with its rank and the world size
(gloo on the CPU, NCCL on the card).  A one-rank mesh makes its own world
where none exists: a group of one rank over an in-process ``HashStore``, no
sockets — gloo for the CPU, and NCCL beside it for CUDA tensors where the
process has a card.  Functions, not module constants: importing this module
touches no process group.

The production meshes (256 and 512 ranks) need that many processes; the
sharding rules read only a mesh's shape, which ``production_shape`` gives
without any (``parallel.api.MeshShape``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .._device import resolve_device
from ..parallel.api import MeshShape

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def _device_type(device_type: Optional[str]) -> str:
    """``device_type``, or with None the card's (``cuda``): where there is
    no card that raises, in ``_device.resolve_device``'s words.  The CPU is
    used only when asked for by name."""
    if device_type is not None:
        return device_type
    return resolve_device(None).type


def _one_rank_world(device_type: str) -> None:
    """A world of one rank over a ``HashStore``, where none exists."""
    if dist.is_initialized():
        return
    backend = "gloo"
    if device_type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("a CUDA mesh needs NCCL, which this torch lacks")
        backend = "cpu:gloo,cuda:nccl"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device_type: Optional[str] = None) -> DeviceMesh:
    """A mesh of ``shape`` over ranks 0.. in row-major order, its dims named
    ``axes``, on ``device_type`` (default: ``cuda``, which raises where
    there is no card; ``cpu`` only by name).  Needs a world of exactly that
    many ranks; a one-rank mesh makes its own world where none exists."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"make_mesh: {len(shape)} sizes for axes {axes}")
    n = 1
    for s in shape:
        n *= s
    dt = _device_type(device_type)
    if n == 1:
        _one_rank_world(dt)
    if not dist.is_initialized() or dist.get_world_size() != n:
        have = dist.get_world_size() if dist.is_initialized() else 0
        raise RuntimeError(f"make_mesh{shape}: needs a world of {n} ranks, have {have} "
                           "(init_process_group in each of them first)")
    return DeviceMesh(dt, torch.arange(n).reshape(shape), mesh_dim_names=axes)


def production_shape(*, multi_pod: bool = False) -> MeshShape:
    """The production mesh's shape: 16x16 = 256 chips per pod; 2 pods = 512."""
    return MeshShape(*PRODUCTION[multi_pod])


def make_production_mesh(*, multi_pod: bool = False, device_type: Optional[str] = None
                         ) -> DeviceMesh:
    """16x16 = 256 ranks per pod; 2 pods = 512 ranks multi-pod (a world of
    that many processes must exist)."""
    shape, axes = PRODUCTION[multi_pod]
    return make_mesh(shape, axes, device_type=device_type)


def host_device_mesh(device_type: Optional[str] = None) -> DeviceMesh:
    """The one-rank ``('data', 'model')`` mesh the launchers use."""
    return make_mesh((1, 1), ("data", "model"), device_type=device_type)
