"""The kernel regions on meta and fake tensors: what the dry-run
(``launch.dryrun``) traces in place of K3–K6 and their backwards (S2–S4).

A wrapper in ``kernels.ops`` that is given a meta or fake tensor (or a
``DTensor`` whose local shards are such) calls the region op here, a
``torch.library.custom_op`` whose fake implementation makes the outputs'
shapes and dtypes and computes nothing.  On CUDA and CPU tensors nothing
comes here: the wrappers launch their kernel or run its plain version as
they always have.  Each region op carries

  * its FLOPs (``torch.utils.flop_counter.register_flop_formula``): the dot
    FLOPs that the reference's plain region counts in its own dry-run, where
    XLA lowers the region as einsums — ``models/attention.py``'s online
    softmax over keys padded to 1024-key chunks (``flash_attention``), or its
    dense form for short sequences, as MLA's short path (``attention_flops``), the decode's
    two einsums over the whole cache, MLA's absorbed chunked form (its dots
    contract over the latent rank: ``dims``), ``models/ssd.py``'s
    ``ssd_core_chunked`` and the RG-LRU's associative scan (no dots).  A
    backward counts what XLA's autodiff of those dots counts;
  * its bytes, which the counting mode takes as the op's operands and
    results: the boundary I/O of the hand-written kernel;
  * its DTensor sharding (``register_sharding``): over the batch, over the
    heads (the channels for the RG-LRU), or replicated.  Attention may also
    split its query heads where the KV heads are too few to split (4 KV
    heads over 16 ranks; one in a multi-query decode): a rank reads whole K
    and V and uses the heads its queries read, and its dK and dV are partial
    sums over the head shards, as the SSD backward's dB and dC are over
    heads.

Nothing here imports ``triton`` or builds a kernel.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

try:
    from torch._subclasses.fake_tensor import is_fake
except ImportError:  # pragma: no cover
    def is_fake(t) -> bool:
        return False

try:
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding
except ImportError:  # pragma: no cover - torch without DTensor
    DTensor = register_sharding = None

Tensor = torch.Tensor


def traced(t) -> bool:
    """True for a meta or fake tensor, or a DTensor whose shards are: the
    tensors of a dry-run, which hold no data.  A plain tensor (the card's
    and the CPU's) costs one type test and one device test."""
    if type(t) is torch.Tensor:
        return t.device.type == "meta"
    if DTensor is not None and isinstance(t, DTensor):
        t = t._local_tensor
    return isinstance(t, torch.Tensor) and (t.device.type == "meta" or is_fake(t))


def _refuse(name: str):
    raise RuntimeError(f"{name} is a dry-run region: it runs only on meta or fake tensors")


# -- K3 / S2: attention ---------------------------------------------------------------


@torch.library.custom_op("repro_torch::mha_region", mutates_args=())
def mha_region(q: Tensor, k: Tensor, v: Tensor, causal: bool, window: Optional[int],
               scale: float, softcap: Optional[float], form: int,
               dqk: int, dv: int) -> tuple[Tensor, Tensor]:
    _refuse("mha_region")


@mha_region.register_fake
def _(q, k, v, causal, window, scale, softcap, form, dqk, dv):
    B, Sq, H, _ = q.shape
    return (q.new_empty((B, Sq, H, v.shape[-1])),
            q.new_empty((B, H, Sq), dtype=torch.float32))


@torch.library.custom_op("repro_torch::mha_region_bwd", mutates_args=())
def mha_region_bwd(q: Tensor, k: Tensor, v: Tensor, out: Tensor, lse: Tensor, dout: Tensor,
                   causal: bool, window: Optional[int], scale: float,
                   softcap: Optional[float], form: int, dqk: int,
                   dv: int) -> tuple[Tensor, Tensor, Tensor]:
    _refuse("mha_region_bwd")


@mha_region_bwd.register_fake
def _(q, k, v, out, lse, dout, causal, window, scale, softcap, form, dqk, dv):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


#: how the reference computes an attention region (``attention_flops``)
FORMS = {"dense": 0, "attention": 1, "chunked": 2}
KV_CHUNK = 1024


def attention_flops(B: int, Sq: int, H: int, Sk: int, dqk: int, dv: int, form: int) -> int:
    """QKᵀ and PV of the reference's region, over all Sk keys (its dense
    form) or over the keys padded to whole 1024-key chunks (its online
    softmax).  ``attn_forward`` takes the dense form where Sq·Sk <= 2048² or
    Sk <= 1024 (``form`` 1), MLA's short path is dense (0), and its
    absorbed chunked form always chunks (2)."""
    chunked = form == FORMS["chunked"] or (
        form == FORMS["attention"] and Sk * Sq > 2048 * 2048 and Sk > KV_CHUNK)
    keys = -(-Sk // KV_CHUNK) * KV_CHUNK if chunked else Sk
    return 2 * B * Sq * H * keys * (dqk + dv)


@register_flop_formula(torch.ops.repro_torch.mha_region)
def _mha_flops(q, k, v, causal, window, scale, softcap, form, dqk, dv, *args,
               out_shape=None, **kw) -> int:
    return attention_flops(q[0], q[1], q[2], k[1], dqk, dv, form)


@register_flop_formula(torch.ops.repro_torch.mha_region_bwd)
def _mha_bwd_flops(q, k, v, out, lse, dout, causal, window, scale, softcap, form, dqk,
                   dv, *args, out_shape=None, **kw) -> int:
    # dS·K and dSᵀ·Q against QKᵀ, dP = dO·Vᵀ and Pᵀ·dO against PV
    return 2 * attention_flops(q[0], q[1], q[2], k[1], dqk, dv, form)


class _Mha(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, *opts):
        out, lse = torch.ops.repro_torch.mha_region(q, k, v, *opts)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = opts
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = torch.ops.repro_torch.mha_region_bwd(q, k, v, out, lse, dout, *ctx.opts)
        return (dq, dk, dv) + (None,) * len(ctx.opts)


def mha(q, k, v, *, causal: bool, window: Optional[int], scale: float,
        softcap: Optional[float], form: str = "attention",
        dims: Optional[tuple[int, int]] = None):
    """K3 (model layout: q (B,Sq,H,D), k (B,Sk,KvH,D), v (B,Sk,KvH,Dv)) as a
    region, with S2 as its backward where autograd records.  ``form`` (a key
    of ``FORMS``) and ``dims`` say how the reference's region counts (see
    ``attention_flops``) and change no shape: ``ops.mha`` leaves them at
    ``attention``, whose dense or chunked form follows from the shapes, and
    MLA's layer names its own."""
    dqk, dv = dims if dims is not None else (q.shape[-1], v.shape[-1])
    opts = (bool(causal), window, float(scale), softcap, FORMS[form], int(dqk), int(dv))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Mha.apply(q, k, v, *opts)
    return torch.ops.repro_torch.mha_region(q, k, v, *opts)[0]


# -- K4: decode ------------------------------------------------------------------------


@torch.library.custom_op("repro_torch::decode_region", mutates_args=())
def decode_region(q: Tensor, k: Tensor, v: Tensor, length: Tensor, scale: float,
                  softcap: Optional[float]) -> tuple[Tensor, Tensor, Tensor]:
    _refuse("decode_region")


@decode_region.register_fake
def _(q, k, v, length, scale, softcap):
    B, H, _ = q.shape
    return (q.new_empty((B, H, v.shape[-1])), q.new_empty((B, H), dtype=torch.float32),
            q.new_empty((B, H), dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.decode_region)
def _decode_flops(q, k, v, length, scale, softcap, *args, out_shape=None, **kw) -> int:
    # the reference's two einsums over every slot of the cache
    return 2 * q[0] * q[1] * k[1] * (q[2] + v[3])


def decode(q, k, v, length, *, scale: float, softcap: Optional[float], normalize: bool):
    """K4 (q (B,H,D), k and v (B,L,KvH,D)) as a region: the normalised
    output, or with ``normalize=False`` the partial (acc, m, l)."""
    if not isinstance(length, torch.Tensor):
        length = torch.full((q.shape[0],), int(length), dtype=torch.int32, device=q.device)
    elif length.ndim == 0:
        length = length.expand(q.shape[0])
    out, m, l = torch.ops.repro_torch.decode_region(q, k, v, length, float(scale), softcap)
    return out if normalize else (out, m, l)


# -- K5 / S3: the SSD scan -------------------------------------------------------------


@torch.library.custom_op("repro_torch::ssd_region", mutates_args=())
def ssd_region(xdt: Tensor, dA: Tensor, Bc: Tensor, Cc: Tensor, chunk: int) -> Tensor:
    _refuse("ssd_region")


@ssd_region.register_fake
def _(xdt, dA, Bc, Cc, chunk):
    return torch.empty_like(xdt)


@torch.library.custom_op("repro_torch::ssd_region_bwd", mutates_args=())
def ssd_region_bwd(xdt: Tensor, dA: Tensor, Bc: Tensor, Cc: Tensor, y: Tensor, dy: Tensor,
                   chunk: int) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    _refuse("ssd_region_bwd")


@ssd_region_bwd.register_fake
def _(xdt, dA, Bc, Cc, y, dy, chunk):
    return (torch.empty_like(xdt), torch.empty_like(dA), torch.empty_like(Bc),
            torch.empty_like(Cc))


def ssd_flops(B: int, S: int, H: int, P: int, N: int, chunk: int, *, backward: bool) -> int:
    """The dots of ``ssd_core_chunked`` over S padded to whole chunks (nc of
    Q = chunk positions) as XLA counts them: C·Bᵀ (Q²N), the intra-chunk
    product (Q²HP), the chunk states and the inter-chunk output (QNHP each).
    With one chunk the state entering it is zero and XLA folds one QNHP dot
    away.  The backward: the two products of C·Bᵀ (Q²N), the intra-chunk
    product's two (Q²HP) and its reduction over the heads (Q²H), four QNHP
    products (three with one chunk), and two QHP reductions of the decay's
    gradient."""
    nc, Q = -(-S // chunk), chunk
    k = 2 if nc > 1 else 1
    if not backward:
        return 2 * B * nc * Q * (Q * N + Q * H * P + k * N * H * P)
    return 2 * B * nc * (Q * Q * H + 2 * Q * Q * H * P + 2 * Q * Q * N
                         + (k + 2) * Q * N * H * P + 2 * Q * H * P)


@register_flop_formula(torch.ops.repro_torch.ssd_region)
def _ssd_flops(xdt, dA, Bc, Cc, chunk, *args, out_shape=None, **kw) -> int:
    B, S, H, P = xdt
    return ssd_flops(B, S, H, P, Bc[-1], chunk, backward=False)


@register_flop_formula(torch.ops.repro_torch.ssd_region_bwd)
def _ssd_bwd_flops(xdt, dA, Bc, Cc, y, dy, chunk, *args, out_shape=None, **kw) -> int:
    B, S, H, P = xdt
    return ssd_flops(B, S, H, P, Bc[-1], chunk, backward=True)


class _Ssd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xdt, dA, Bc, Cc, chunk):
        y = torch.ops.repro_torch.ssd_region(xdt, dA, Bc, Cc, chunk)
        ctx.save_for_backward(xdt, dA, Bc, Cc, y)
        ctx.chunk = chunk
        return y

    @staticmethod
    def backward(ctx, dy):
        xdt, dA, Bc, Cc, y = ctx.saved_tensors
        return (*torch.ops.repro_torch.ssd_region_bwd(xdt, dA, Bc, Cc, y, dy, ctx.chunk), None)


def ssd_scan(xdt, dA, Bc, Cc, *, chunk: int):
    """K5 (model layout: xdt (B,S,H,P), dA (B,S,H), Bc and Cc (B,S,N)) as a
    region, with S3 as its backward; ``chunk`` is the config's, which the
    reference pads S to."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xdt, dA, Bc, Cc)):
        return _Ssd.apply(xdt, dA, Bc, Cc, int(chunk))
    return torch.ops.repro_torch.ssd_region(xdt, dA, Bc, Cc, int(chunk))


# -- K6 / S4: the RG-LRU scan ----------------------------------------------------------


@torch.library.custom_op("repro_torch::rglru_region", mutates_args=())
def rglru_region(a: Tensor, b: Tensor) -> Tensor:
    _refuse("rglru_region")


@rglru_region.register_fake
def _(a, b):
    return torch.empty_like(a)


@torch.library.custom_op("repro_torch::rglru_region_bwd", mutates_args=())
def rglru_region_bwd(a: Tensor, h: Tensor, dh: Tensor) -> tuple[Tensor, Tensor]:
    _refuse("rglru_region_bwd")


@rglru_region_bwd.register_fake
def _(a, h, dh):
    return torch.empty_like(a), torch.empty_like(a)


@register_flop_formula([torch.ops.repro_torch.rglru_region, torch.ops.repro_torch.rglru_region_bwd])
def _rglru_flops(*args, out_shape=None, **kw) -> int:
    return 0           # the associative scan is elementwise: no dots


class _Rglru(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        h = torch.ops.repro_torch.rglru_region(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        return torch.ops.repro_torch.rglru_region_bwd(a, h, dh)


def rglru_scan(a, b):
    """K6 (a, b (B,S,D)) as a region, with S4 as its backward."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _Rglru.apply(a, b)
    return torch.ops.repro_torch.rglru_region(a, b)


# -- DTensor shardings -----------------------------------------------------------------


def _register_shardings() -> None:
    R, P = Replicate(), Partial()
    S = Shard

    @register_sharding(torch.ops.repro_torch.mha_region.default)
    def _(q, k, v, *opts):
        rest = [None] * len(opts)
        return [([R, R], [R, R, R] + rest),
                ([S(0), S(0)], [S(0), S(0), S(0)] + rest),
                ([S(2), S(1)], [S(2), S(2), S(2)] + rest),
                ([S(2), S(1)], [S(2), R, R] + rest)]

    @register_sharding(torch.ops.repro_torch.mha_region_bwd.default)
    def _(q, k, v, out, lse, dout, *opts):
        rest = [None] * len(opts)
        return [([R, R, R], [R] * 6 + rest),
                ([S(0)] * 3, [S(0)] * 6 + rest),
                ([S(2)] * 3, [S(2), S(2), S(2), S(2), S(1), S(2)] + rest),
                ([S(2), P, P], [S(2), R, R, S(2), S(1), S(2)] + rest)]

    @register_sharding(torch.ops.repro_torch.decode_region.default)
    def _(q, k, v, length, *opts):
        rest = [None] * len(opts)
        return [([R, R, R], [R, R, R, R] + rest),
                ([S(0)] * 3, [S(0)] * 4 + rest),
                ([S(1)] * 3, [S(1), S(2), S(2), R] + rest),
                ([S(1)] * 3, [S(1), R, R, R] + rest)]

    @register_sharding(torch.ops.repro_torch.ssd_region.default)
    def _(xdt, dA, Bc, Cc, chunk):
        return [([R], [R, R, R, R, None]),
                ([S(0)], [S(0)] * 4 + [None]),
                ([S(2)], [S(2), S(2), R, R, None])]

    @register_sharding(torch.ops.repro_torch.ssd_region_bwd.default)
    def _(xdt, dA, Bc, Cc, y, dy, chunk):
        return [([R] * 4, [R] * 6 + [None]),
                ([S(0)] * 4, [S(0)] * 6 + [None]),
                ([S(2), S(2), P, P], [S(2), S(2), R, R, S(2), S(2), None])]

    @register_sharding(torch.ops.repro_torch.rglru_region.default)
    def _(a, b):
        return [([R], [R, R]), ([S(0)], [S(0), S(0)]), ([S(2)], [S(2), S(2)])]

    @register_sharding(torch.ops.repro_torch.rglru_region_bwd.default)
    def _(a, h, dh):
        return [([R, R], [R] * 3), ([S(0)] * 2, [S(0)] * 3), ([S(2)] * 2, [S(2)] * 3)]


if register_sharding is not None:
    _register_shardings()
