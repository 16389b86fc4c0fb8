"""Batched serving driver: continuous batching over fixed decode slots.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --smoke --device cpu --requests 12 --slots 4 --max-new 16

A request = (prompt tokens, max_new_tokens).  The engine keeps ``--slots``
decode lanes; finished lanes are refilled from the queue (prefill writes the
prompt's KV into that lane, decode steps advance all lanes together — the
standard continuous-batching serving loop; recurrent archs refill in
waves).  On the card every decode step runs the decode-attention kernel (K4)
once per attention layer, with each lane's own cache length.  Without
``--device`` the engine runs on the CUDA device and raises where there is
none.  ``main`` serves on one rank: the one-rank ``("data", "model")`` mesh
of ``launch.mesh.host_device_mesh``, under the decode sharding rules
(``parallel.rules.rules_for``)."""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device
from ..configs.registry import get_config, get_smoke_config, list_archs
from ..launch.mesh import host_device_mesh
from ..models import transformer
from ..parallel.api import use_rules
from ..parallel.rules import rules_for
from ..train.steps import make_serve_step


@dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int
    out: list[int] = field(default_factory=list)


class Engine:
    """Slot-based continuous batching on top of ``lm_decode_step``.

    Decode steps advance all lanes with *per-lane* cache positions, so a
    freshly refilled lane starts at position 0 while its neighbours keep
    decoding (the per-lane length of the attention hides any stale cache
    beyond each lane's index).  Recurrent-state archs (rglru/ssd) carry
    hidden state no length can hide, so they refill in waves
    (``self.wave = True``): a new wave starts only when every lane is done,
    on a fresh cache.

    ``params`` defaults to the port's ``init_lm`` from seed 0 on ``device``;
    a test hands in parameters carried over from the reference instead.
    ``decode_calls`` counts every ``lm_decode_step``, prefill's included."""

    def __init__(self, cfg, slots: int, max_len: int, *, params=None, device=None):
        self.cfg = cfg
        self.slots = slots
        self.max_len = max_len
        self.device = resolve_device(device)
        kinds = {k for s in cfg.segments for k in s.pattern}
        self.wave = bool(kinds & {"rglru", "ssd"})
        self.params = params if params is not None else transformer.init_lm(
            0, cfg, device=self.device)
        self.cache = self._fresh_cache()
        self.pos = np.zeros(slots, np.int32)           # next position per lane
        self.active: list[Optional[Request]] = [None] * slots
        self.serve = make_serve_step(cfg, device=self.device)
        self.decode_calls = 0

    def _fresh_cache(self):
        cfg = self.cfg
        cache = transformer.init_lm_cache(cfg, self.slots, self.max_len, device=self.device)
        if cfg.frontend is not None:
            # stub modality inputs for the demo engine, as the reference's; a
            # real deployment feeds per-request embeddings here
            fe = torch.zeros((self.slots, cfg.frontend_tokens, cfg.frontend_dim),
                             dtype=torch.float32, device=self.device)
            cache = transformer.lm_prepare_decode_cache(self.params, cache,
                                                        {"frontend_embeds": fe}, cfg)
        return cache

    def _positions(self) -> torch.Tensor:
        return torch.as_tensor(self.pos, dtype=torch.int32).to(self.device)

    def prefill(self, assignments: dict[int, Request]):
        """Feed prompts into the assigned lanes in lockstep (one decode step
        per prompt position; equal prompt lengths assumed)."""
        if not assignments:
            return
        if self.wave:
            # recurrent state cannot be masked per-lane: reset everything
            self.cache = self._fresh_cache()
            self.pos[:] = 0
        plen = max(len(r.prompt) for r in assignments.values())
        for s, req in assignments.items():
            self.active[s] = req
            self.pos[s] = 0
        for t in range(plen):
            toks = np.zeros((self.slots, 1), np.int32)
            for s, req in assignments.items():
                toks[s, 0] = req.prompt[min(t, len(req.prompt) - 1)]
            _, self.cache = transformer.lm_decode_step(
                self.params, self.cache, torch.as_tensor(toks).to(self.device),
                self._positions(), self.cfg)
            self.decode_calls += 1
            for s in assignments:
                self.pos[s] += 1

    def step(self):
        """One decode step across all active lanes (per-lane positions)."""
        toks = np.zeros((self.slots, 1), np.int32)
        for s, req in enumerate(self.active):
            if req is not None:
                toks[s, 0] = (req.out[-1] if req.out else req.prompt[-1])
        next_toks, self.cache = self.serve(self.params, self.cache, torch.as_tensor(toks),
                                           self._positions())
        self.decode_calls += 1
        nt = next_toks.cpu().numpy()
        done = []
        for s, req in enumerate(self.active):
            if req is None:
                continue
            req.out.append(int(nt[s, 0]))
            self.pos[s] += 1
            if len(req.out) >= req.max_new or self.pos[s] >= self.max_len - 1:
                done.append(s)
        return done


def serve_requests(eng, queue: list) -> tuple[list, int]:
    """The continuous-batching loop: fill the lanes, step, refill finished
    lanes from ``queue`` (in waves for recurrent archs) until every request
    is done.  Returns (completed requests, decode steps)."""
    queue = list(queue)
    completed = []
    eng.prefill({s: queue.pop(0) for s in range(min(eng.slots, len(queue)))})
    steps = 0
    while any(r is not None for r in eng.active):
        done = eng.step()
        steps += 1
        refills = {}
        for s in done:
            completed.append(eng.active[s])
            eng.active[s] = None
        if eng.wave:
            # recurrent archs: refill only when the wave drains
            if not any(r is not None for r in eng.active) and queue:
                refills = {s: queue.pop(0) for s in range(min(eng.slots, len(queue)))}
        else:
            for s in done:
                if queue:
                    refills[s] = queue.pop(0)
        eng.prefill(refills)
    return completed, steps


def make_requests(n: int, prompt_len: int, max_new: int, vocab: int, seed: int = 0):
    """``n`` requests of ``prompt_len`` seeded tokens in [1, min(vocab, 1024))."""
    rng = np.random.default_rng(seed)
    return [Request(i, list(rng.integers(1, min(vocab, 1024), prompt_len)), max_new)
            for i in range(n)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dev = resolve_device(args.device)
    mesh = host_device_mesh(dev.type)
    rules = rules_for(cfg, mesh, "decode", batch=args.slots)
    queue = make_requests(args.requests, args.prompt_len, args.max_new, cfg.vocab)

    t0 = time.time()
    with use_rules(rules, mesh):
        eng = Engine(cfg, args.slots, args.max_len, device=dev)
        completed, steps = serve_requests(eng, queue)
    dt = time.time() - t0
    toks = sum(len(r.out) for r in completed)
    print(f"served {len(completed)} requests, {toks} tokens, "
          f"{steps} decode steps in {dt:.1f}s ({toks / dt:.1f} tok/s)")
    for r in completed[:3]:
        print(f"  req {r.rid}: prompt {r.prompt[:4]}... -> {r.out[:8]}...")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
