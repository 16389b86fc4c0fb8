"""The one place that builds and loads CUDA kernels.

Every kernel of the port is CUDA C++ with a plain ``extern "C"`` launcher,
compiled by ``nvcc`` for ``sm_90a`` into a shared library and bound with
``ctypes``.  No PyTorch headers are involved, so a library builds in
seconds — which is what lets ``lower_to_cuda`` generate and build one
kernel per design.

A library is built at first use, under ``build/repro_torch/`` at the root of
the checkout, under a name that holds a hash of its source text and of the
compiler flags; a later call finds the file and loads it.  A failing build raises with the compiler's output; nothing
here falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Sequence

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"

#: seconds spent in nvcc per library name, this process (0.0 = found built)
build_seconds: dict[str, float] = {}

_loaded: dict[str, ctypes.CDLL] = {}

#: builds started and not yet finished, by library name
_pending: dict[str, "PendingBuild"] = {}


class BuildError(RuntimeError):
    """nvcc is missing or refused the source."""


def build_dir() -> Path:
    # src/repro_torch/kernels/_build.py -> the checkout's root
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise BuildError("nvcc not found (looked at $PATH and "
                     "/usr/local/cuda/bin): CUDA kernels cannot be built here")


def source_hash(source: str) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(b"\0")
    h.update(source.encode())
    return h.hexdigest()[:16]


@dataclass
class PendingBuild:
    """A library on its way: ``proc`` is None when it was found built."""

    name: str
    lib_path: Path
    tmp_path: Optional[Path]
    proc: Optional[subprocess.Popen]
    started: float


def start_build(stem: str, source: str) -> PendingBuild:
    """Write ``source`` to ``<build dir>/<stem>_<hash>.cu`` and start nvcc on
    it without waiting, so several libraries can build side by side.  A
    source whose build is already on its way gets that same build back."""
    name = f"{stem}_{source_hash(source)}"
    if name in _pending:
        return _pending[name]
    out = build_dir()
    lib = out / f"lib{name}.so"
    if name in _loaded or lib.exists():
        return PendingBuild(name, lib, None, None, time.perf_counter())
    nvcc = find_nvcc()
    out.mkdir(parents=True, exist_ok=True)
    cu = out / f"{name}.cu"
    cu.write_text(source)
    tmp = out / f"lib{name}.{os.getpid()}.tmp.so"
    proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(cu)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    _pending[name] = PendingBuild(name, lib, tmp, proc, time.perf_counter())
    return _pending[name]


def finish_build(pending: PendingBuild) -> ctypes.CDLL:
    """Wait for the compiler, move the library into place and load it."""
    if pending.name in _loaded:
        return _loaded[pending.name]
    if pending.proc is not None:
        output, _ = pending.proc.communicate()
        _pending.pop(pending.name, None)
        if pending.proc.returncode != 0:
            raise BuildError(f"nvcc failed on {pending.name}.cu "
                             f"(exit {pending.proc.returncode}):\n{output}")
        os.replace(pending.tmp_path, pending.lib_path)
        build_seconds[pending.name] = time.perf_counter() - pending.started
    else:
        build_seconds.setdefault(pending.name, 0.0)
    lib = ctypes.CDLL(str(pending.lib_path))
    _loaded[pending.name] = lib
    return lib


def load_library(stem: str, source: str) -> ctypes.CDLL:
    """Build (if needed) and load one library from its source text."""
    return finish_build(start_build(stem, source))


# a local header of csrc/, as in: #include "hopper.cuh"
_LOCAL_INCLUDE = re.compile(r'^[ \t]*#include[ \t]+"([\w.]+\.cuh)"[^\n]*$', re.M)
_PRAGMA_ONCE = re.compile(r'^[ \t]*#pragma[ \t]+once[^\n]*\n?', re.M)


def csrc_source(filename: str, directory: Path = CSRC_DIR) -> tuple[str, str]:
    """``(stem, source text)`` of a hand-written source in ``csrc/``, as
    ``start_build`` and ``load_library`` take them.  Each local
    ``#include "<name>.cuh"`` is replaced by that header's text (once per
    source), so the text builds on its own in the build directory and its
    hash covers the headers it uses."""
    seen: set[str] = set()

    def splice(text: str) -> str:
        def header(m: re.Match) -> str:
            name = m.group(1)
            if name in seen:
                return ""
            seen.add(name)
            return splice(_PRAGMA_ONCE.sub("", (directory / name).read_text()))
        return _LOCAL_INCLUDE.sub(header, text)

    return Path(filename).stem, splice((directory / filename).read_text())


def bind(lib: ctypes.CDLL, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The launcher ``symbol`` with its argument types set: ``c_void_p`` for
    pointers and the stream, ``c_int`` for ints.  Without them ctypes would
    pass each as a 32-bit int and cut the pointers.  Launchers return
    ``cudaGetLastError()`` as an int."""
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def on_device(device, launcher, *args) -> int:
    """``launcher(*args, stream)`` with the current stream of ``device`` (a
    CUDA ``torch.device`` with its index); the device is entered only when it
    is not already the current one."""
    import torch

    if device.index == torch.cuda.current_device():
        return launcher(*args, torch.cuda.current_stream(device).cuda_stream)
    with torch.cuda.device(device):
        return launcher(*args, torch.cuda.current_stream(device).cuda_stream)


def refuse_grad(what: str, *tensors) -> None:
    """Raise before any launch where autograd would need the kernel's
    gradient (grad enabled, an input that requires it) and the kernel has no
    backward: on the card its result would carry no ``grad_fn``, and the
    gradient would be lost without a word.  K2 (the HIR binding's matmul)
    and K4 (decode attention) take it: no training path runs either; every
    kernel a train step runs (K3, K5, K6) has its backward."""
    import torch

    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{what}: no backward kernel on the card, so its inputs' gradients would be "
            "dropped (no training path runs it)")


def check_launch(rc: int, what: str) -> None:
    """Raise on a launch that the runtime refused (too many threads, too
    much shared memory, ...): such a kernel never runs, and a later
    synchronize does not report it."""
    if rc != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError {rc}")
