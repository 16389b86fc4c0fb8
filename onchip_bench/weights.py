"""The weights of a cell, drawn from ``--seed`` on the device by the benchmark.

A configuration's reference lists its parameters (``param_specs``: path, shape,
dtype and how each is drawn); ``make`` draws them with one ``torch.Generator``
on the device, in a few large calls: one ``randn`` over all normal leaves of a
dtype, one ``rand`` over all uniform ones, in the dtype they are trained in.
The same seed on the same device gives the same weights, so the reference
draws them again after the window instead of keeping a copy.
"""

from __future__ import annotations

import math
from collections import defaultdict

import torch

from .synthetic import SEED_MOD

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def make(specs: dict, seed: int, device) -> dict:
    """``{path: tensor}`` for ``specs`` = ``{path: (shape, dtype, init)}``.
    ``init`` is ``("normal", std)``, ``("ones",)``, ``("zeros",)``,
    ``("log_of_uniform", lo, hi)`` (the log of a uniform draw in [lo, hi],
    Mamba's A_log) or
    ``("softplus_inverse_log_uniform", lo, hi)`` (x with softplus(x) drawn
    log-uniform in [lo, hi], Mamba's dt bias)."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % SEED_MOD)
    out = {}
    normal = defaultdict(list)
    uniform = []
    for path in sorted(specs):
        shape, dtype, init = specs[path]
        kind = init[0]
        if kind == "normal":
            normal[dtype].append(path)
        elif kind in ("log_of_uniform", "softplus_inverse_log_uniform"):
            uniform.append(path)
        elif kind == "ones":
            out[path] = torch.ones(shape, dtype=DTYPES[dtype], device=device)
        elif kind == "zeros":
            out[path] = torch.zeros(shape, dtype=DTYPES[dtype], device=device)
        else:
            raise ValueError(f"{path}: unknown init {init!r}")
    for dtype in sorted(normal):
        paths = normal[dtype]
        sizes = [math.prod(specs[p][0]) for p in paths]
        flat = torch.randn(sum(sizes), generator=gen, dtype=DTYPES[dtype], device=device)
        for p, part in zip(paths, flat.split(sizes)):
            out[p] = part.view(specs[p][0]).mul_(specs[p][2][1])
    if uniform:
        sizes = [math.prod(specs[p][0]) for p in uniform]
        flat = torch.rand(sum(sizes), generator=gen, dtype=torch.float32, device=device)
        for p, u in zip(uniform, flat.split(sizes)):
            kind, lo, hi = specs[p][2]
            if kind == "log_of_uniform":
                v = torch.log(lo + u * (hi - lo))
            else:                                   # softplus(v) = x
                x = torch.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
                v = x + torch.log(-torch.expm1(-x))
            out[p] = v.view(specs[p][0]).to(DTYPES[specs[p][1]])
    return out
