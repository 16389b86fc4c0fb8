"""Flash-decode: single-token attention against a long KV cache — kernel K4.

The Pallas kernel runs a grid (B, H, L/bk) with the cache length sequential
and the online-softmax state in VMEM scratch, and takes one scalar
``length`` for the whole batch.  On the card (``csrc/decode_attention.cu``)
one launch does the whole call: the cache is split into chunks (``split``),
one block per (chunk, group, lane) reads its K/V rows once for all the query
heads of its group and forms a partial (acc, m, l), and the last block of
each (lane, group) merges the partials by log-sum-exp.  A group is the
G = H/KvH query heads of a KV head, or where G is above ``MAX_GROUP`` a tile
of that many of them (``groups``): any G runs, larger ones reading each K/V
row once a tile.
``length`` is a scalar or one int per lane — the serving engine refills
lanes independently, so each lane has its own — and chunks past a lane's
length are not read.  bfloat16 runs ``decode_bf16_mma`` (the query heads of
a KV head as the rows of ``mma.sync`` tiles), float32 ``decode_f32`` (the
CUDA cores, held to 2e-5).

``softcap`` (a cap c > 0, or None) caps each scaled score s to
``tanh(s / c) * c`` before the length mask, as the reference's decode does;
the partials' (m, l) are over the capped scores.  Both kernels are templates
on a compile-time cap, so the uncapped instantiations are the code they
were; bfloat16 takes ``tanh.approx.f32``, float32 ``tanhf``.

``normalize=False`` (``partial_decode_attention``) is the same kernel
returning the unnormalised accumulator and (m, l), so that sequence shards
merge with ``merge_partials``, which stays plain tensor math as in the
reference.

Head dims other than those of ``flash_attention.HEAD_DIMS`` (a multiple of
8 up to 256) run zero-padded, and rows the kernel cannot read 16 bytes at a
time are copied first, as in ``flash_attention``.

The float32 partials and the per-(lane, group) counters live in one
workspace per device, made once and grown when a call needs more; the
kernel leaves every counter at 0.  The workspace serves one stream at a
time (all the port uses): two calls in flight on two streams would share it.
A CUDA graph captures the workspace's pointers, so growth never frees them:
the tensors a growth supersedes are kept alive (``_retired``; each growth at
least doubles, so they hold less than the workspace itself), and a graph
captured before it still writes into valid memory.  Inside a capture the
workspace does not grow: a call that needs more raises ``RuntimeError``
naming the size — run that call once eagerly before capturing.

CUDA tensors launch the kernel or raise; CPU tensors take the plain version
(``ref.decode_attention_ref``).  There is no backward kernel (decode
steps do not train): on the card, under grad with an input that requires
it, the call raises ``NotImplementedError`` before any launch; the CPU's
plain version is differentiable.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import struct
from typing import Optional, Union

import torch

from . import _build
from .flash_attention import check_softcap, kernel_head_dim, kernel_operands
from .ref import decode_attention_ref

CHUNK = 64          # chunks are whole multiples of this many cache positions
MAX_GROUP = 16      # query heads a group: the rows of one mma tile
SMS = 132           # SMs of an H100 SXM; a call asks its own device

#: kernel launches made by ``decode_attention`` and ``partial_decode_attention``
launches = 0
#: the same launches by the call's shape: (B, H, KvH, L, D, a length per
#: lane, softcap), the cap None where there is none
by_shape: collections.Counter = collections.Counter()

#: the kernel each dtype runs
KERNEL = {torch.float32: "decode_f32", torch.bfloat16: "decode_bf16_mma"}

_SYMBOL = {torch.float32: "launch_decode_attention_f32",
           torch.bfloat16: "launch_decode_attention_bf16"}
_launchers: dict = {}


# the kernel's DecodeArgs, field by field: pointers, strides, ints, the scale
# and the cap (0: none), in the struct's order
_POINTERS = ("q", "k", "v", "lengths", "out", "m_out", "l_out", "partials", "counters")
_STRIDES = ("q_sb", "q_sh", "k_sb", "k_sl", "k_sh", "v_sb", "v_sl", "v_sh")
_INTS = ("length", "B", "H", "KvH", "L", "D", "chunk", "n_chunks", "normalize")
ARGS_FIELDS = ([(n, "P") for n in _POINTERS] + [(n, "q") for n in _STRIDES]
               + [(n, "i") for n in _INTS] + [("scale", "f"), ("softcap", "f")])
# "0P" pads the end to a pointer's alignment, as sizeof(DecodeArgs) is
_ARGS = struct.Struct("@" + "".join(code for _, code in ARGS_FIELDS) + "0P")


def _launcher(dtype: torch.dtype):
    if dtype not in _launchers:
        lib = _build.load_library(*_build.csrc_source("decode_attention.cu"))
        _launchers[dtype] = _build.bind(lib, _SYMBOL[dtype], [ctypes.c_char_p, ctypes.c_void_p])
    return _launchers[dtype]


@functools.lru_cache(maxsize=256)
def split(L: int, pairs: int, D: int, sms: int = SMS) -> tuple[int, int]:
    """``(chunk, n_chunks)`` for a cache of L positions read by ``pairs``
    (lane, group) pairs (``B * groups(H, KvH)``): the largest multiple of
    ``CHUNK`` that still gives every SM a block, within the 64 KB of bfloat16
    K and V a block stages (16384 / D positions), and no longer than the
    cache needs."""
    cap = max(CHUNK, 16384 // D // CHUNK * CHUNK)
    chunk = max(CHUNK, L * pairs // sms // CHUNK * CHUNK)
    chunk = min(chunk, cap, -(-L // CHUNK) * CHUNK)
    return chunk, -(-L // chunk)


def groups(H: int, KvH: int) -> int:
    """Groups of query heads a call forms: ceil(G / MAX_GROUP) a KV head."""
    return KvH * -(-(H // KvH) // MAX_GROUP)


_workspaces: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
#: workspace tensors a growth superseded, kept alive for the graphs that hold them
_retired: list[torch.Tensor] = []
_sms: dict[int, int] = {}


def _workspace(device: torch.device, n_partials: int, n_counters: int):
    """(float32 partials, int32 counters) of ``device``, at least this large.
    Counters are zeroed once, when made; the kernel leaves them at 0.  A
    growth at least doubles, keeps the superseded tensor alive, and is
    refused inside a CUDA-graph capture."""
    partials, counters = _workspaces.get(device.index, (None, None))
    small = [t is None or t.numel() < n for t, n in ((partials, n_partials),
                                                      (counters, n_counters))]
    if any(small) and device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"decode_attention: the workspace must grow to {n_partials} float32 "
                           f"partials and {n_counters} counters inside a CUDA-graph capture; "
                           "run this call once outside the capture first")

    def grown(t, n, least, make, dtype):
        if t is not None:
            _retired.append(t)
            least = max(least, 2 * t.numel())
        return make(max(n, least), dtype=dtype, device=device)

    if small[0]:
        partials = grown(partials, n_partials, 1 << 16, torch.empty, torch.float32)
    if small[1]:
        counters = grown(counters, n_counters, 256, torch.zeros, torch.int32)
    _workspaces[device.index] = (partials, counters)
    return partials, counters


def _lengths(length, B: int, device: torch.device) -> tuple[Optional[torch.Tensor], int]:
    """``(per-lane int32 tensor on the device, None)`` or ``(None, scalar)``."""
    if isinstance(length, torch.Tensor):
        if length.ndim == 0 and length.device.type == "cpu":
            return None, int(length)
        if (length.dtype == torch.int32 and length.device == device and length.shape == (B,)
                and length.stride() == (1,)):
            return length, 0                 # the engine's own: nothing to convert
        per_lane = torch.broadcast_to(length.to(device=device, dtype=torch.int32), (B,))
        return per_lane.contiguous(), 0
    return None, int(length)


def _call(q, k, v, length, scale, normalize, softcap):
    B, H, D = q.shape
    _, L, KvH, _ = k.shape
    if H % KvH != 0:
        raise ValueError(f"decode_attention: H={H} must be a multiple of KvH={KvH}")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"decode_attention: k {tuple(k.shape)} and v {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if isinstance(length, torch.Tensor) and length.numel() not in (1, B):
        raise ValueError(f"decode_attention: length has {length.numel()} values for {B} lanes")
    sc = scale if scale is not None else D ** -0.5
    cap = check_softcap(softcap, "decode_attention")
    if q.device.type != "cuda":
        return decode_attention_ref(q, k, v, length, scale=sc, normalize=normalize,
                                    softcap=cap)
    _build.refuse_grad("decode_attention", q, k, v)
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _SYMBOL:
        raise TypeError(f"decode_attention takes float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    Dk = kernel_head_dim(D, "decode_attention")
    if not (q.device == k.device == v.device):
        raise ValueError(f"operands on different devices: {q.device}, {k.device}, {v.device}")
    q, k, v = kernel_operands(Dk, q, k, v)
    dev = q.device
    per_lane, scalar = _lengths(length, B, dev)
    if dev.index not in _sms:
        _sms[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
    n_groups = B * groups(H, KvH)
    chunk, n_chunks = split(L, n_groups, Dk, _sms[dev.index])
    partials, counters = _workspace(
        dev, n_groups * n_chunks * (min(H // KvH, MAX_GROUP) * Dk + 32), n_groups)
    out = torch.empty((B, H, Dk), dtype=q.dtype, device=dev)
    m = l = None
    if not normalize:
        m, l = torch.empty((2, B, H), dtype=torch.float32, device=dev)
    args = _ARGS.pack(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      per_lane.data_ptr() if per_lane is not None else 0, out.data_ptr(),
                      m.data_ptr() if m is not None else 0, l.data_ptr() if l is not None else 0,
                      partials.data_ptr(), counters.data_ptr(), *q.stride()[:2], *k.stride()[:3],
                      *v.stride()[:3], scalar, B, H, KvH, L, Dk, chunk, n_chunks, int(normalize),
                      sc, cap or 0.0)
    global launches
    rc = _build.on_device(dev, _launcher(q.dtype), args)
    _build.check_launch(rc, KERNEL[q.dtype])
    launches += 1
    by_shape[(B, H, KvH, L, D, per_lane is not None, cap)] += 1
    out = out[..., :D]
    return out if normalize else (out, m, l)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length: Union[int, torch.Tensor], *, scale: Optional[float] = None,
                     softcap: Optional[float] = None) -> torch.Tensor:
    """q: (B,H,D); k,v: (B,L,KvH,D); positions >= length are masked, with
    ``length`` a scalar or one per lane (B,); ``softcap`` caps the scaled
    scores."""
    return _call(q, k, v, length, scale, True, softcap)


def partial_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             length: Union[int, torch.Tensor], *,
                             scale: Optional[float] = None, softcap: Optional[float] = None):
    """Unnormalised partial result + (m, l) for cross-shard merging."""
    return _call(q, k, v, length, scale, False, softcap)


def merge_partials(outs: torch.Tensor, ms: torch.Tensor, ls: torch.Tensor) -> torch.Tensor:
    """Merge per-shard partial attention (stacked on axis 0):
    outs (S,B,H,D) unnormalised, ms/ls (S,B,H).  Standard flash-decode
    log-sum-exp combination."""
    m = ms.amax(0)
    corr = torch.exp(ms - m[None])                       # (S,B,H)
    l = (ls * corr).sum(0)
    o = (outs.float() * corr[..., None]).sum(0)
    return (o / torch.clamp(l[..., None], min=1e-30)).to(outs.dtype)
