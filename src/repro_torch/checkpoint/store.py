"""Checkpointing: atomic save/restore with an asynchronous writer — the
reference's ``checkpoint/store.py`` for trees of torch tensors, in its
on-disk layout, so that a checkpoint crosses between the two packages in
either direction.

Layout of a checkpoint directory::

    <dir>/step_000123/
        manifest.json     # step, tree structure, shapes/dtypes, metadata
        arrays.npz        # flattened leaves, key = "/"-joined tree path
    <dir>/LATEST          # name of the newest complete step dir

Keys are the reference's: dict keys and list indices joined by "/", as
``jax.tree_util`` paths print them.  npz has no bfloat16: such a leaf is
stored as its raw bits (uint16) and the manifest records "bfloat16".  Writes
are atomic (write to ``.tmp-<step>`` then rename) so a failure mid-write
never corrupts the latest checkpoint — the restart driver (``repro_torch.ft``)
always restores a complete state.  ``AsyncCheckpointer`` copies the state to
host memory synchronously and writes on a background thread, overlapping I/O
with the next training steps.

Arrays are stored *unsharded*; ``restore`` with ``shardings`` re-shards onto
whatever mesh the restored run uses: each rank reads its own slice of every
leaf (elastic scaling — a checkpoint of one mesh restores onto any other).
"""

from __future__ import annotations

import json
import shutil
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .. import _tree
from ..parallel.api import (Replicate, Shard, coordinate, current_mesh, mesh_axis_names,
                            mesh_shape, spec_leaves)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A leaf as npz stores it: its raw bits (uint16) for bfloat16."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _host(tree):
    """The tree's leaves copied to host memory (a snapshot of a live state)."""
    return _tree.map(lambda t: t.detach().to("cpu", copy=True), tree)


def save(directory: str | Path, step: int, state, *, metadata: Optional[dict] = None) -> Path:
    """Atomic synchronous save; returns the final step directory."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:08d}"
    tmp = directory / f".tmp-{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    flat = _tree.with_paths(state)
    stored = {k: _to_numpy(v) for k, v in flat.items()}
    np.savez(tmp / "arrays.npz", **stored)
    manifest = {
        "step": step,
        "time": time.time(),
        "treedef": _treedef(state),
        "keys": sorted(stored.keys()),
        "shapes": {k: list(v.shape) for k, v in flat.items()},
        "dtypes": {k: str(v.dtype).removeprefix("torch.") for k, v in flat.items()},
        "metadata": metadata or {},
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=2))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    (directory / "LATEST").write_text(final.name)
    return final


def _treedef(tree) -> str:
    """The tree's structure, leaves as ``*`` (the reference writes jax's
    ``PyTreeDef`` here; neither side reads it back)."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"'{k}': {_treedef(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        return "[" + ", ".join(_treedef(t) for t in tree) + "]"
    return "*"


def latest_step(directory: str | Path) -> Optional[int]:
    directory = Path(directory)
    marker = directory / "LATEST"
    if not marker.exists():
        return None
    name = marker.read_text().strip()
    if not (directory / name / "manifest.json").exists():
        # fall back to scanning complete step dirs
        steps = sorted(int(p.name.split("_")[1]) for p in directory.glob("step_*")
                       if (p / "manifest.json").exists())
        return steps[-1] if steps else None
    return int(name.split("_")[1])


def _local(x: torch.Tensor, placements, sizes: list, coord: list) -> torch.Tensor:
    """This rank's slice of ``x`` under DTensor placements, one a mesh dim:
    ``Shard(d)`` splits dim d among that mesh dim's ranks, the mesh dims
    that split one tensor dim taken in mesh order (major to minor)."""
    for j, pl in enumerate(placements):
        if isinstance(pl, Shard):
            d, n = pl.dim, sizes[j]
            if x.shape[d] % n:
                raise ValueError(f"restore: dim {d} of size {x.shape[d]} does not split over "
                                 f"{n} ranks")
            w = x.shape[d] // n
            x = x.narrow(d, coord[j] * w, w)
        elif not isinstance(pl, Replicate):
            raise ValueError(f"restore: placement {pl!r} is neither Shard nor Replicate")
    return x


def restore(directory: str | Path, like, *, step: Optional[int] = None, device=None,
            shardings=None, mesh=None):
    """Restore into the structure of ``like`` (a state tree): each leaf in
    the dtype of ``like``'s leaf, on ``device`` or else on the device of
    ``like``'s leaf.  ``shardings``: optional matching tree of DTensor
    placements (``parallel.api.named_sharding``) on ``mesh`` (default: the
    current one); each leaf is then this rank's slice of the saved array
    (elastic re-mesh).  Returns (state, step)."""
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    path = directory / f"step_{step:08d}"
    manifest = json.loads((path / "manifest.json").read_text())
    with np.load(path / "arrays.npz") as npz:
        arrays = {}
        for k in npz.files:
            v = npz[k]
            if manifest["dtypes"].get(k) == "bfloat16":
                arrays[k] = torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
            else:
                arrays[k] = torch.from_numpy(v)

    flat_like = _tree.with_paths(like)
    missing = set(flat_like) - set(arrays)
    extra = set(arrays) - set(flat_like)
    if missing or extra:
        raise ValueError(f"checkpoint/state mismatch: missing={sorted(missing)[:5]} "
                         f"extra={sorted(extra)[:5]}")
    if shardings is not None:
        mesh = mesh if mesh is not None else current_mesh()
        sizes = list(mesh_shape(mesh).values())
        coord = [coordinate(mesh)[a] for a in mesh_axis_names(mesh)]
        flat_sh = spec_leaves(shardings)
        if len(flat_sh) != len(flat_like):
            raise ValueError(f"restore: {len(flat_sh)} shardings for {len(flat_like)} leaves")
        arrays = {k: _local(arrays[k], pl, sizes, coord) for k, pl in zip(flat_like, flat_sh)}
    out = [arrays[k].to(device=device if device is not None else leaf.device, dtype=leaf.dtype)
           for k, leaf in flat_like.items()]
    return _tree.unflatten(like, out), step


class AsyncCheckpointer:
    """Snapshot synchronously, write on a background thread."""

    def __init__(self, directory: str | Path, keep: int = 3):
        self.directory = Path(directory)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, state, metadata: Optional[dict] = None) -> None:
        self.wait()
        host_state = _host(state)          # snapshot before mutation

        def work():
            try:
                save(self.directory, step, host_state, metadata=metadata)
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(p for p in self.directory.glob("step_*")
                       if (p / "manifest.json").exists())
        for p in steps[:-self.keep]:
            shutil.rmtree(p, ignore_errors=True)
