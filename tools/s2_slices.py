"""S2 at head dim 256 with each number of head slices, timed in turns on the
card: how ``flash_attention_bwd.head_slices`` (the least divisor of the
group that gives the card 132 dK/dV blocks) was chosen.

For each shape (RecurrentGemma's train 2 x 2048 16/1 window 2048 and the
2 x 512 16/1 check) the wrapper runs with ``head_slices`` forced to each
divisor of the group.  Every variant's dq, dk and dv must lie within 2e-2 of
the shipped choice's largest |value| (the slices' sums are added in another
grouping).  Times: one replay of a CUDA graph of 20 calls, over 20, in the
order shipped, variants, variants reversed, shipped; SDPA's backward (CUDA
events over 20 autograd calls, host included) beside them.  Prints one JSON
line per (shape, slices) and the card's name and power limit.

Run on the machine with the card:
    PYTHONPATH=src python tools/s2_slices.py
"""

from __future__ import annotations

import json
import subprocess

import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fab

# B, S, H, KvH, window
SHAPES = [(2, 2048, 16, 1, 2048), (2, 512, 16, 1, None)]
D = 256


def graph_ms(fn, calls: int = 20) -> float:
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        fn()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(calls):
                fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph.replay()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / calls
    del graph
    torch.cuda.empty_cache()
    return ms


def event_ms(fn, iters: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def main() -> None:
    dev = torch.device("cuda", 0)
    shipped = fab.head_slices
    g = torch.Generator().manual_seed(0)
    for B, S, H, KvH, window in SHAPES:
        mk = lambda *shape, s=1.0: (torch.randn(shape, generator=g) * s).to(dev, torch.bfloat16)
        q = mk(B, S, H, D, s=4.0).transpose(1, 2)
        k, v = mk(B, S, KvH, D).transpose(1, 2), mk(B, S, KvH, D).transpose(1, 2)
        do = mk(B, S, H, D).transpose(1, 2)
        o, lse = fa._forward(q, k, v, True, window, D ** -0.5, None, with_lse=True)
        call = lambda: fab.flash_attention_bwd(q, k, v, o, lse, do, window=window)
        group = H // KvH
        choice = shipped(B, KvH, group, S, D)
        want = call()
        variants = [s for s in range(1, group + 1) if group % s == 0]
        order = [choice] + variants + variants[::-1] + [choice]
        times: dict[int, list[float]] = {s: [] for s in variants}
        errs = {}
        for s in order:
            fab.head_slices = lambda *a, s=s: s
            got = call()
            errs[s] = max(float((a.float() - b.float()).abs().max()) / float(b.float().abs().max())
                          for a, b in zip(got, want))
            if errs[s] > 2e-2:
                raise SystemExit(f"{s} slices: {errs[s]} of the largest |value| off the shipped")
            times[s].append(graph_ms(call))
        fab.head_slices = shipped
        ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True, enable_gqa=True)
        sdpa = event_ms(lambda: torch.autograd.grad(out, (ql, kl, vl), do, retain_graph=True))
        for s in variants:
            print(json.dumps({"shape": f"{B}x{S} H{H}/{KvH} D{D}", "slices": s,
                              "shipped": s == choice,
                              "blocks": 2 * B * KvH * -(-S // fab.SPLIT_KEYS) * s,
                              "device_ms": times[s], "rel_err_vs_shipped": errs[s],
                              "sdpa_bwd_ms": sdpa}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
