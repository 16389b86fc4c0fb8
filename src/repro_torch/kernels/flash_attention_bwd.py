"""The gradient of flash attention — kernel S2, K3's backward.

No TPU kernel stands behind it: the reference trains through XLA's autodiff
of its plain jnp attention.  On the card the forward is K3, which writes each
query row's log-sum-exp beside its output; ``flash_attention_bwd`` takes
those and dO and launches ``csrc/flash_attention_bwd.cu``: Delta =
rowsum(dO o O), then dK and dV per key tile (a GQA group's query heads summed
in the block, no atomics), then dQ per query tile.  ``flash_attention.bwd_route``
picks the kernels: bfloat16 on the tensor cores (``flash_bwd_dkdv_wgmma``,
``flash_bwd_dq_wgmma``) at the forward's head dims below 256 and MLA's
(192, 128), the CUDA cores (``flash_bwd_dkdv``, ``flash_bwd_dq``) in float32
and at head dim 256.  The masks are the forward's (``causal``, ``window``,
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

#: calls of ``flash_attention_bwd`` that launched the kernels (three launches
#: a call; a run resets it to 0, drives its path, and reads it)
launches = 0
#: the same calls by shape: (B, H, KvH, Sq, Sk, D, Dv, causal, softcap)
by_shape: collections.Counter = collections.Counter()

_SYMBOL = {(torch.float32, "cuda_cores"): "launch_flash_attention_bwd_f32",
           (torch.bfloat16, "cuda_cores"): "launch_flash_attention_bwd_bf16",
           (torch.bfloat16, "wgmma"): "launch_flash_attention_bwd_bf16_wgmma"}
_launchers: dict = {}


def _launcher(dtype: torch.dtype, route: str):
    """The launcher of a route; all take 10 pointers, (B, H, KvH, Sq, Sk, D,
    Dv), the strides, the scale, the masks, the cap (0: none) and the
    stream."""
    key = (dtype, route)
    if key not in _launchers:
        lib = _build.load_library(*_build.csrc_source("flash_attention_bwd.cu"))
        _launchers[key] = _build.bind(
            lib, _SYMBOL[key],
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p, ctypes.c_float]
            + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p])
    return _launchers[key]


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
    global launches
    rc = _build.on_device(q.device, _launcher(q.dtype, route), q.data_ptr(), k.data_ptr(),
                          v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                          delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H,
                          KvH, Sq, Sk, Dk, Dvk, strides, sc, int(causal), window or 0,
                          kv_len or Sk, cap or 0.0)
    _build.check_launch(rc, "/".join(_fa.BWD_KERNELS[route]))
    launches += 1
    by_shape[(B, H, KvH, Sq, Sk, D, Dv, bool(causal), cap)] += 1
    return dq[..., :D], dk[..., :D], dv[..., :Dv]
