"""The gradient of flash attention — kernel S2, K3's backward.

No TPU kernel stands behind it: the reference trains through XLA's autodiff
of its plain jnp attention.  On the card the forward is K3, which writes each
query row's log-sum-exp beside its output; ``flash_attention_bwd`` takes
those and dO and launches ``csrc/flash_attention_bwd.cu``: Delta =
rowsum(dO o O), then dK and dV per key tile (a GQA group's query heads summed
in the block, no atomics), then dQ per query tile.  ``flash_attention.bwd_route``
picks the kernels: bfloat16 on the tensor cores (``flash_bwd_dkdv_wgmma``,
``flash_bwd_dq_wgmma``) at every head dim of the forward and MLA's
(192, 128), float32 on the CUDA cores (``flash_bwd_dkdv``, ``flash_bwd_dq``).
At head dim 256 a dK/dV block accumulates one of dK and dV, for a slice of
its group's query heads (``head_slices``: enough blocks to fill the card);
the slices' float32 sums go to a scratch that the wrapper allocates and
``flash_bwd_dkdv_sum`` adds them in a fixed order, so that two calls give the
same bits.  The masks are the forward's (``causal``, ``window``,
``kv_len``) and so are the layouts: any strides whose head dim is contiguous,
a head dim up to 256 that is a multiple of 8 zero-padded to the kernel's
(``flash_attention.kernel_operands``); float32 pads a pair with D != Dv to
one head dim, as its forward does, and cuts dv back to Dv.  Under the
forward's logit cap c (``softcap``) both routes recompute P from the capped
scores c t, t = tanh(s / c), and multiply dS by the cap's derivative
1 - t^2; the cap is a compile-time template parameter, as in K3, and a
capped call at MLA's (192, 128) raises ``ValueError``.

CUDA tensors launch the kernels or raise; CPU tensors take the plain version
(``ref.flash_attention_bwd_ref``).
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional

import torch

from . import _build
from . import flash_attention as _fa
from .ref import flash_attention_bwd_ref

#: calls of ``flash_attention_bwd`` that launched the kernels (three or four
#: launches a call; a run resets it to 0, drives its path, and reads it)
launches = 0
#: the same calls by shape: (B, H, KvH, Sq, Sk, D, Dv, causal, softcap)
by_shape: collections.Counter = collections.Counter()

_SYMBOL = {"cuda_cores": "launch_flash_attention_bwd_f32",
           "wgmma": "launch_flash_attention_bwd_bf16_wgmma"}
_launchers: dict = {}

#: the card's SMs (an H100 SXM's), which the dK/dV blocks at head dim 256 fill
SMS = 132
#: keys a dK/dV block holds at head dim 256 (``BwdTile::KK``)
SPLIT_KEYS = 128


def head_slices(B: int, KvH: int, group: int, Sk: int, Dk: int) -> int:
    """The slices a group's query heads are split into across S2's dK/dV
    blocks: 1 below head dim 256, where a block sums its whole group; at 256
    the least divisor of the group that gives at least ``SMS`` blocks (two an
    output, dK and dV, per slice, key tile, KV head and batch row), else the
    group, a head a slice."""
    if Dk != 256:
        return 1
    blocks = 2 * B * KvH * -(-Sk // SPLIT_KEYS)
    return next(s for s in range(1, group + 1) if group % s == 0 and
                (blocks * s >= SMS or s == group))


def _launcher(route: str):
    """The launcher of a route; both take 10 pointers, (B, H, KvH, Sq, Sk,
    D, Dv), the strides, the scale, the masks and the cap (0: none), the
    tensor cores' then the scratch of the head slices and their number, and
    the stream."""
    if route not in _launchers:
        lib = _build.load_library(*_build.csrc_source("flash_attention_bwd.cu"))
        slices = [ctypes.c_void_p, ctypes.c_int] if route == "wgmma" else []
        _launchers[route] = _build.bind(
            lib, _SYMBOL[route],
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p, ctypes.c_float]
            + [ctypes.c_int] * 3 + [ctypes.c_float] + slices + [ctypes.c_void_p])
    return _launchers[route]


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor, *, causal: bool = True,
                        window: Optional[int] = None, scale: Optional[float] = None,
                        kv_len: Optional[int] = None, softcap: Optional[float] = None):
    """q (B,H,Sq,D); k (B,KvH,Sk,D); v (B,KvH,Sk,Dv); o, do (B,H,Sq,Dv); lse
    (B,H,Sq) float32, the forward's (under the same cap).  Returns (dq, dk,
    dv) in the inputs' dtype — on the card (B,H,S,·) views of contiguous
    (B,S,H,·) tensors, the model's layout."""
    B, H, Sq, D = q.shape
    KvH, Sk, Dv = k.shape[1], k.shape[2], v.shape[-1]
    if o.shape != (B, H, Sq, Dv) or do.shape != o.shape or lse.shape != (B, H, Sq):
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)}, do {tuple(do.shape)}, "
                         f"lse {tuple(lse.shape)} do not match q {tuple(q.shape)}, "
                         f"v {tuple(v.shape)}")
    sc = scale if scale is not None else D ** -0.5
    cap = _fa.check_softcap(softcap, "flash_attention_bwd")
    if q.device.type != "cuda":
        return flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal, window=window,
                                       scale=sc, kv_len=kv_len, softcap=cap)
    if not all(t.dtype == q.dtype for t in (k, v, o, do)):
        raise TypeError(f"flash_attention_bwd takes one dtype, got "
                        f"{[t.dtype for t in (q, k, v, o, do)]}")
    if lse.dtype != torch.float32:
        raise TypeError(f"flash_attention_bwd: lse must be float32, got {lse.dtype}")
    if not all(t.device == q.device for t in (k, v, o, do, lse)):
        raise ValueError("flash_attention_bwd: operands on different devices")
    route, Dk, Dvk = _fa.bwd_route(D, Dv, q.dtype, cap is not None)
    q, k = _fa.kernel_operands(Dk, q, k)
    v, o, do = _fa.kernel_operands(Dvk, v, o, do)
    lse = lse.contiguous()
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    dq = torch.empty((B, Sq, H, Dk), dtype=q.dtype, device=q.device).transpose(1, 2)
    dk = torch.empty((B, Sk, KvH, Dk), dtype=q.dtype, device=q.device).transpose(1, 2)
    dv = torch.empty((B, Sk, KvH, Dvk), dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 24)(*(s for t in (q, k, v, o, do, dq, dk, dv)
                                         for s in t.stride()[:3]))
    tail = []
    if route == "wgmma":
        slices = head_slices(B, KvH, H // KvH, Sk, Dk)
        part = (torch.empty((2, slices, B, KvH, Sk, Dk), dtype=torch.float32, device=q.device)
                if slices > 1 else None)
        tail = [part.data_ptr() if part is not None else None, slices]
    global launches
    rc = _build.on_device(q.device, _launcher(route), q.data_ptr(), k.data_ptr(),
                          v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                          delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H,
                          KvH, Sq, Sk, Dk, Dvk, strides, sc, int(causal), window or 0,
                          kv_len or Sk, cap or 0.0, *tail)
    _build.check_launch(rc, "/".join(_fa.BWD_KERNELS[route]))
    launches += 1
    by_shape[(B, H, KvH, Sq, Sk, D, Dv, bool(causal), cap)] += 1
    return dq[..., :D], dk[..., :D], dv[..., :Dv]
