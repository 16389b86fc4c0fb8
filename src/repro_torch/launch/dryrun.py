"""Multi-pod dry-run: trace every (architecture x input-shape) cell on the
production meshes and record each chip's FLOPs, bytes, collective bytes,
memory and H100 roofline bound — the counterpart of the reference's
``launch/dryrun.py``.

The reference lowers each jitted step with ``in_shardings`` on fake XLA CPU
devices.  Here the port's own step functions (``train.steps``:
``make_train_step``, ``make_prefill_step``, ``make_serve_step``) run on
``DTensor`` inputs whose local shards are empty meta tensors, placed by the
sharding rules (``parallel.rules.rules_for`` through
``parallel.api.placements``), over a fake process group as large as the
mesh (``torch.testing._internal.distributed.fake_pg``: 256 ranks single
pod, 512 multi-pod); ``launch.trace_analysis.CountingMode`` counts what one
rank runs.  Nothing is allocated on any device and nothing is launched: like
the reference's, this dry-run runs on fake devices by design, on any host,
and a card is neither needed nor used.  The mesh is a CUDA mesh, as on the
card, so DTensor issues the collectives it would issue there.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Artifacts: artifacts/dryrun_torch/<arch>__<shape>__<mesh>[__tag].json
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import time
import traceback
from pathlib import Path
from typing import Optional, Sequence

import torch.distributed as dist

from ..configs.base import SHAPES, ModelCfg, ShapeCfg
from ..configs.registry import cell_supported, get_config, list_archs
from ..optim.adamw import OptCfg
from ..parallel.api import ShardingRules, mesh_shape, use_rules
from ..parallel.rules import rules_for
from ..train.steps import make_prefill_step, make_serve_step, make_train_step
from . import trace_analysis
from .mesh import PRODUCTION, make_mesh
from .specs import cell_abstract_inputs

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"

# per-device activation budget used to pick gradient-accumulation depth
ACT_BUDGET_BYTES = 4e9

# beyond-baseline optimizations; "opt" enables all
OPT_KEYS = ("moe_ep", "seq_shard_fallback", "no_embed_fsdp", "constrain_grads",
            "flash_decode")


def microbatches_for(cfg: ModelCfg, shape: ShapeCfg, mesh) -> int:
    """Boundary activations of the layer stack dominate train memory:
    L x (B/mb/dp) x S x d x 2B per device.  Choose the smallest microbatch
    count (a divisor of B/dp) that fits the budget."""
    if shape.kind != "train":
        return 1
    sizes = mesh_shape(mesh)
    dp = sizes.get("data", 1) * sizes.get("pod", 1)
    if shape.global_batch % dp:
        dp = 1
    per_mb = cfg.n_layers * shape.seq_len * cfg.d_model * 2 * (shape.global_batch / dp)
    mb = 1
    max_mb = max(1, shape.global_batch // dp)
    while per_mb / mb > ACT_BUDGET_BYTES and mb < max_mb:
        mb *= 2
    return min(mb, max_mb)


def build_step(cfg: ModelCfg, shape: ShapeCfg, mesh, num_microbatches: int, opts: dict,
               device="meta"):
    """The port's step for the cell, on ``device`` (the meta tensors')."""
    if shape.kind == "train":
        return make_train_step(cfg, OptCfg(), num_microbatches=num_microbatches, mesh=mesh,
                               constrain_grads=opts.get("constrain_grads", False),
                               grad_compression=opts.get("grad_compression"), device=device)
    if shape.kind == "prefill":
        return make_prefill_step(cfg, device=device)
    return make_serve_step(cfg, device=device)


@contextlib.contextmanager
def fake_world(n: int):
    """A fake process group of ``n`` ranks (this process is rank 0) for the
    length of the block, destroyed after it.  Refuses to start while a
    process group exists that it did not make: a real world must not be
    traced over, and a fake one of another size is someone else's."""
    if dist.is_initialized():
        raise RuntimeError(f"dry-run: a process group of {dist.get_world_size()} ranks "
                           f"({dist.get_backend()}) exists; the dry-run makes its own fake "
                           "one and needs a process without one")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _quiet_redistribute_warnings() -> None:
    # DTensor warns on every multi-axis redistribution of the 3-D mesh
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)


def trace_step(cfg: ModelCfg, shape: ShapeCfg, mesh, rules, num_microbatches: int = 1,
               opts: Optional[dict] = None) -> tuple[trace_analysis.Stats, float]:
    """Trace one step of the cell on ``mesh`` (a DeviceMesh over a fake
    world) under ``rules``; returns (per-chip stats, seconds)."""
    from torch.distributed.tensor.experimental import implicit_replication

    opts = opts or {}
    _quiet_redistribute_warnings()
    t0 = time.time()
    # one rank holds everything: its step runs on plain meta tensors, as the
    # int8 cross-pod step holds its state on every rank
    local = mesh.size() == 1 or (shape.kind == "train" and opts.get("grad_compression") == "int8"
                                 and "pod" in mesh_shape(mesh))
    with use_rules(rules, mesh):
        args, _, _ = cell_abstract_inputs(cfg, shape, rules, mesh, num_microbatches,
                                          local=local)
        step = build_step(cfg, shape, mesh, num_microbatches, opts)
        mode = trace_analysis.CountingMode(args)
        with implicit_replication(), mode:
            out = step(*args)
        del out
    return mode.stats, time.time() - t0


def analyze(cfg: ModelCfg, shape: ShapeCfg, mesh_dims: Sequence[int], axes: Sequence[str],
            opts: Optional[dict] = None, *, num_microbatches: Optional[int] = None,
            rules=None):
    """Make a fake world of the mesh's size, trace the cell, destroy the
    world.  Returns (stats, seconds, rules, num_microbatches)."""
    opts = opts or {}
    n = 1
    for d in mesh_dims:
        n *= d
    with fake_world(n):
        mesh = make_mesh(mesh_dims, axes, device_type="cuda")
        num_mb = num_microbatches or microbatches_for(cfg, shape, mesh)
        if rules is None:
            mode = "train" if shape.kind == "train" else shape.kind
            rules = rules_for(cfg, mesh, mode, batch=shape.global_batch // num_mb,
                              moe_ep=opts.get("moe_ep", False),
                              seq_shard_fallback=opts.get("seq_shard_fallback", False),
                              embed_fsdp=not opts.get("no_embed_fsdp", False),
                              flash_decode=opts.get("flash_decode", False))
        st, secs = trace_step(cfg, shape, mesh, without_unit_axes(rules, mesh), num_mb, opts)
    return st, secs, rules, num_mb


def without_unit_axes(rules, mesh):
    """The rules with every mesh axis of one rank dropped: such an axis
    splits nothing, and DTensor cannot view every tensor it marks as split."""
    sizes = mesh_shape(mesh)

    def keep(v):
        if not isinstance(v, (str, tuple)):
            return v                            # None, or a path flag
        axes = tuple(a for a in ((v,) if isinstance(v, str) else v) if sizes.get(a, 1) > 1)
        return None if not axes else axes[0] if len(axes) == 1 else axes

    return ShardingRules(**{k: keep(v) for k, v in rules.rules.items()})


def record(st: trace_analysis.Stats, cfg: ModelCfg, shape: ShapeCfg, n_chips: int) -> dict:
    """The record's figures from one rank's stats."""
    terms = trace_analysis.roofline_terms(st.flops, st.mem_bytes, st.coll_bytes)
    mf = trace_analysis.model_flops(cfg, shape)
    return dict(
        memory={"argument_bytes": st.argument_bytes,
                "peak_bytes": st.argument_bytes + st.peak_bytes},
        cost={"flops_per_chip": st.flops, "bytes_per_chip": st.mem_bytes,
              "total_flops": st.flops * n_chips, "kernel_boundary_bytes": st.marked_boundary},
        collectives={"operand_bytes": st.coll_bytes, "count": st.coll_count,
                     "bytes_by_kind": st.coll_by_kind,
                     "unknown_trip_whiles": st.unknown_trip_whiles},
        roofline=terms,
        model_flops=mf,
        useful_flops_frac=(mf / (st.flops * n_chips)) if st.flops else None,
    )


def run_cell(arch: str, shape_name: str, multi_pod: bool, verbose: bool = True,
             opts: Optional[dict] = None) -> dict:
    opts = opts or {}
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh_name = "multi" if multi_pod else "single"
    ok, reason = cell_supported(cfg, shape)
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "kind": shape.kind}
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec
    dims, axes = PRODUCTION[multi_pod]
    enabled = {k: v for k, v in opts.items() if v}
    if enabled:
        rec["opts"] = enabled
    try:
        st, secs, rules, num_mb = analyze(cfg, shape, dims, axes, opts)
        n_chips = 1
        for d in dims:
            n_chips *= d
        rec.update(status="ok", chips=n_chips, num_microbatches=num_mb,
                   rules={k: v for k, v in rules.rules.items() if v is not None},
                   trace_s=round(secs, 2), **record(st, cfg, shape, n_chips))
        if verbose:
            frac = rec["useful_flops_frac"]
            print(f"[{arch} x {shape_name} x {mesh_name}] OK trace={secs:.1f}s "
                  f"flops/chip={st.flops:.3e} bytes/chip={st.mem_bytes:.3e} "
                  f"coll={st.coll_bytes:.3e}B bottleneck={rec['roofline']['bottleneck']} "
                  + (f"useful={frac:.2f}" if frac is not None else ""), flush=True)
    except Exception as e:  # record the failure; the dry-run table shows it
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
        if verbose:
            print(f"[{arch} x {shape_name} x {mesh_name}] FAIL {type(e).__name__}: {e}",
                  flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None, help="architecture id (see --list)")
    ap.add_argument("--shape", default=None, choices=[*SHAPES, None])
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true", help="all (arch x shape) cells")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--out", default=str(ARTIFACTS))
    ap.add_argument("--opt", action="store_true",
                    help="enable every beyond-baseline optimization")
    for k in OPT_KEYS:
        ap.add_argument(f"--{k.replace('_', '-')}", action="store_true")
    ap.add_argument("--grad-compression", choices=["int8"], default=None)
    ap.add_argument("--tag", default=None,
                    help="artifact filename suffix (default: 'opt' when any opt on)")
    args = ap.parse_args(argv)

    if args.list:
        for a in list_archs():
            print(a)
        return 0

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = [False, True] if args.mesh == "both" else [args.mesh == "multi"]

    opts = {k: (args.opt or getattr(args, k)) for k in OPT_KEYS}
    if args.grad_compression:
        opts["grad_compression"] = args.grad_compression
    any_opt = any(opts.values())
    tag = args.tag or ("opt" if any_opt else None)

    n_fail = 0
    t0 = time.time()
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                rec = run_cell(arch, shape, mp, opts=opts)
                suffix = f"__{tag}" if tag else ""
                name = f"{arch}__{shape}__{'multi' if mp else 'single'}{suffix}.json"
                (outdir / name).write_text(json.dumps(rec, indent=2, default=str))
                n_fail += rec["status"] == "error"
    print(f"done in {time.time() - t0:.1f}s; {n_fail} failures")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
