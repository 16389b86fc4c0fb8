"""The port's side of ``tests/test_torch_dryrun*.py``: every case that makes
a fake process group, run in this one process so that no test process is
left with a world.  Imports neither jax nor the reference package.

    python tests/torch_dryrun_worker.py <out.json> mini|ref|prod

``mini`` traces the ``("pod", "data", "model") = (2, 2, 2)`` cells (the
``test_mini_dryrun_*`` twins and the opt cells) and runs the hypothesis
check of the counting mode; ``ref`` traces the one-rank cells held to the
reference's HLO counts, and three cells on the mini mesh held to its
per-chip counts; ``prod`` traces full-width cells on the single-pod mesh
(256 ranks) and on one rank.
"""

import json
import sys

import torch
import torch.distributed as dist
from hypothesis import given, settings, strategies as st

from repro_torch.configs.base import SHAPES, ShapeCfg
from repro_torch.configs.registry import get_config, get_smoke_config, list_archs
from repro_torch.launch import dryrun, trace_analysis
from repro_torch.launch.mesh import PRODUCTION

MINI = ((2, 2, 2), ("pod", "data", "model"))
ONE = ((1, 1), ("data", "model"))
PROD_CELLS = (("tinyllama-1.1b", "train_4k"), ("tinyllama-1.1b", "decode_32k"),
              ("mamba2-780m", "train_4k"), ("qwen2-moe-a2.7b", "decode_32k"),
              ("recurrentgemma-9b", "decode_32k"), ("qwen2-moe-a2.7b", "train_4k"),
              ("qwen2-7b", "decode_32k"))
REF_CELLS = ([(a, "train") for a in list_archs()]
             + [(a, k) for a in ("tinyllama-1.1b", "qwen2-moe-a2.7b", "mamba2-780m",
                                 "seamless-m4t-medium") for k in ("prefill", "decode")])


def cell(arch: str, kind: str, mesh, opts=None) -> dict:
    cfg = get_smoke_config(arch)
    shape = ShapeCfg("mini", 16, 8, kind)
    st_, secs, _, _ = dryrun.analyze(cfg, shape, *mesh, opts, num_microbatches=1)
    terms = trace_analysis.roofline_terms(st_.flops, st_.mem_bytes, st_.coll_bytes)
    return {"flops": st_.flops, "mem_bytes": st_.mem_bytes, "coll_bytes": st_.coll_bytes,
            "coll_by_kind": st_.coll_by_kind, "unknown_trip_whiles": st_.unknown_trip_whiles,
            "peak_bytes": st_.peak_bytes, "bottleneck": terms["bottleneck"],
            "seconds": secs}


def counted_loop(m: int, n: int, k: int, trip: int) -> trace_analysis.Stats:
    """``trip`` products of (m, k) by (k, n) in float32, each all-reduced over
    a fake group of two ranks, counted by the mode."""
    import torch.distributed._functional_collectives as funcol

    with dryrun.fake_world(2):
        a = torch.empty((m, k), device="meta")
        b = torch.empty((k, n), device="meta")
        mode = trace_analysis.CountingMode((a, b))
        with mode:
            for _ in range(trip):
                d = funcol.all_reduce(a @ b, "sum", dist.group.WORLD)
                funcol.wait_tensor(d)
    return mode.stats


@given(st.integers(min_value=1, max_value=64), st.integers(min_value=1, max_value=64),
       st.integers(min_value=1, max_value=64), st.integers(min_value=1, max_value=40))
@settings(max_examples=25, deadline=None, database=None)
def check_counts(m, n, k, trip):
    s = counted_loop(m, n, k, trip)
    assert s.flops == 2.0 * m * n * k * trip, (s.flops, m, n, k, trip)
    assert s.coll_bytes == 4.0 * m * n * trip, (s.coll_bytes, m, n, trip)
    assert s.coll_by_kind == {"all-reduce": 4.0 * m * n * trip}, s.coll_by_kind
    assert s.unknown_trip_whiles == 0


def refuses_a_real_world() -> str:
    """``analyze`` in a process that holds a (gloo, one-rank) world."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        cell("tinyllama-1.1b", "decode", ONE)
    except RuntimeError as e:
        return str(e)
    finally:
        dist.destroy_process_group()
    return ""


def main(out: str, which: str) -> None:
    res: dict = {}
    if which == "mini":
        check_counts()
        res["hypothesis"] = "ok"
        res["refusal"] = refuses_a_real_world()
        for arch, kind in (("tinyllama-1.1b", "train"), ("qwen2-moe-a2.7b", "train"),
                           ("tinyllama-1.1b", "decode")):
            res[f"{arch}|{kind}"] = cell(arch, kind, MINI)
        res["qwen2-moe-a2.7b|train|moe_ep"] = cell("qwen2-moe-a2.7b", "train", MINI,
                                                   {"moe_ep": True})
        res["tinyllama-1.1b|decode|flash_decode"] = cell("tinyllama-1.1b", "decode", MINI,
                                                         {"flash_decode": True})
        res["tinyllama-1.1b|train|int8"] = cell("tinyllama-1.1b", "train", MINI,
                                                {"grad_compression": "int8"})
    elif which == "prod":
        for arch, shape in PROD_CELLS:
            cfg = get_config(arch)
            st_, _, _, mb = dryrun.analyze(cfg, SHAPES[shape], *PRODUCTION[False])
            one, *_ = dryrun.analyze(cfg, SHAPES[shape], *ONE, num_microbatches=mb)
            res[f"{arch}|{shape}"] = {"per_chip": st_.flops, "one_rank": one.flops,
                                      "microbatches": mb}
    else:
        for arch, kind in REF_CELLS:
            res[f"{arch}|{kind}"] = cell(arch, kind, ONE)
        for arch, kind in (("tinyllama-1.1b", "train"), ("qwen2-moe-a2.7b", "train"),
                           ("tinyllama-1.1b", "decode")):
            res[f"{arch}|{kind}|mini"] = cell(arch, kind, MINI)
    assert not dist.is_initialized()
    with open(out, "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
