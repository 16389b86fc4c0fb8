"""Plain PyTorch versions of the hand-written kernels (the ``ref.py``
contract): each is the semantic ground truth its kernel is held against,
and what a kernel's wrapper runs for tensors that lie on the CPU.

The attention versions take the kernels' own arguments (GQA by reading KV
head ``h // (H // KvH)``, never by replicating it; the masks; a per-lane
``length``) and repeat the Pallas bodies' arithmetic: float32 scores
``(q * scale) . k``, masked scores ``-1e30`` rather than ``-inf``, and the
normaliser floored at ``1e-30``.  With ``KvH == H`` they take the reference
oracles' arguments and compute their function."""

from __future__ import annotations

from typing import Optional, Union

import torch

NEG_INF = -1e30
_SEGMENT = 64           # positions ssd_scan_bwd_ref replays at a time


def matmul_ref(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """float32 product (full float32, never TF32) cast back to ``x.dtype``."""
    return (x.float() @ y.float()).to(x.dtype)


def _groups(H: int, KvH: int, who: str) -> int:
    if KvH <= 0 or H % KvH:
        raise ValueError(f"{who}: H={H} must be a multiple of KvH={KvH}")
    return H // KvH


def _capped(s: torch.Tensor, softcap: Optional[float]) -> torch.Tensor:
    """The scores ``tanh(s / c) * c`` under a cap c, else s."""
    return s if softcap is None else torch.tanh(s / softcap) * softcap


def _visible(Sq: int, Sk: int, causal: bool, window: Optional[int], kv_len: Optional[int],
             device) -> torch.Tensor:
    """(Sq, Sk) bool: the (query, key) pairs the masks of K3 leave."""
    q_pos = torch.arange(Sq, device=device)[:, None]
    k_pos = torch.arange(Sk, device=device)[None, :]
    valid = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        valid &= k_pos <= q_pos
    if window is not None:
        valid &= k_pos > q_pos - window
    if kv_len is not None:
        valid &= k_pos < kv_len
    return valid


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        scale: Optional[float] = None,
                        kv_len: Optional[int] = None, return_lse: bool = False,
                        softcap: Optional[float] = None):
    """q (B,H,Sq,D); k (B,KvH,Sk,D); v (B,KvH,Sk,Dv) (kernel layout).  Keys
    at positions ``>= kv_len`` are masked, as are keys after the query
    (``causal``) and ``window`` or more positions before it.  ``scale``
    defaults to D ** -0.5; ``softcap`` caps the scaled scores.  Returns
    (B,H,Sq,Dv) in q's dtype and, with ``return_lse``, each row's log-sum-exp
    of its (capped) scaled scores, m + log l (B,H,Sq) float32, which the
    backward takes.  The arithmetic is float32 (float64 for float64 inputs)."""
    B, H, Sq, D = q.shape
    KvH, Sk = k.shape[1], k.shape[2]
    G = _groups(H, KvH, "flash_attention")
    sc = scale if scale is not None else D ** -0.5
    acc = torch.promote_types(q.dtype, torch.float32)
    qf = (q.to(acc) * sc).reshape(B, KvH, G, Sq, D)
    s = _capped(torch.einsum("bhgqd,bhkd->bhgqk", qf, k.to(acc)), softcap)
    s = torch.where(_visible(Sq, Sk, causal, window, kv_len, q.device), s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.to(acc)) / torch.clamp(l, min=1e-30)
    o = o.reshape(B, H, Sq, v.shape[-1]).to(q.dtype)
    if return_lse:
        return o, (m + torch.log(l)).reshape(B, H, Sq)
    return o


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                            causal: bool = True, window: Optional[int] = None,
                            scale: Optional[float] = None, kv_len: Optional[int] = None,
                            softcap: Optional[float] = None):
    """The gradient of ``flash_attention_ref`` written out, in float32: the
    ground truth of the backward kernel (S2) and the backward the CPU takes.
    q, o, do (B,H,Sq,·); k, v (B,KvH,Sk,·); lse (B,H,Sq) from the forward.
    With s = scale q.k and P = exp(s - lse), 0 where the forward's masks
    (``causal``, ``window``, ``kv_len``) cut the pair:
    dV = P^T dO, dP = dO V^T, Delta = rowsum(dO o O), dS = P o (dP - Delta),
    dQ = scale dS K, dK = scale dS^T Q; a KV head's dK and dV sum over its
    group's G query heads.  Under a cap c, P = exp(c t - lse) with
    t = tanh(s / c), and dS takes the cap's derivative, P o (dP - Delta) o
    (1 - t^2).  Returns (dq, dk, dv) in the dtypes of q, k, v
    (float64 arithmetic for float64 inputs)."""
    B, H, Sq, D = q.shape
    KvH, Sk, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = _groups(H, KvH, "flash_attention_bwd")
    sc = scale if scale is not None else D ** -0.5
    acc = torch.promote_types(q.dtype, torch.float32)
    qf = q.to(acc).reshape(B, KvH, G, Sq, D)
    dof = do.to(acc).reshape(B, KvH, G, Sq, Dv)
    kf, vf = k.to(acc), v.to(acc)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf * sc, kf)
    if softcap is not None:
        t = torch.tanh(s / softcap)
        s = t * softcap
    p = torch.where(_visible(Sq, Sk, causal, window, kv_len, q.device),
                    torch.exp(s - lse.to(acc).reshape(B, KvH, G, Sq, 1)), 0.0)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, dof)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dof, vf)
    delta = (dof * o.to(acc).reshape(B, KvH, G, Sq, Dv)).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    if softcap is not None:
        ds = ds * (1 - t * t)
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, kf) * sc
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qf) * sc
    return dq.reshape(B, H, Sq, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         length: Union[int, torch.Tensor], *,
                         scale: Optional[float] = None, normalize: bool = True,
                         softcap: Optional[float] = None):
    """q (B,H,D) one token; k,v (B,L,KvH,D) cache; ``length`` a scalar or one
    per lane (B,): positions ``< length`` attend; ``softcap`` caps the scaled
    scores.  Returns the output (B,H,D)
    in q's dtype or, with ``normalize=False``, the unnormalised accumulator in
    q's dtype and the float32 statistics ``(acc, m, l)``, m and l (B,H)."""
    B, H, D = q.shape
    L, KvH = k.shape[1], k.shape[2]
    G = _groups(H, KvH, "decode_attention")
    sc = scale if scale is not None else D ** -0.5
    qf = (q.float() * sc).reshape(B, KvH, G, D)
    s = _capped(torch.einsum("bhgd,blhd->bhgl", qf, k.float()), softcap)
    n = torch.as_tensor(length, device=q.device).reshape(-1, 1)        # (1 or B, 1)
    valid = torch.arange(L, device=q.device)[None, :] < n               # (1 or B, L)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    acc = torch.einsum("bhgl,blhd->bhgd", p, v.float())
    if normalize:
        return (acc / torch.clamp(l[..., None], min=1e-30)).reshape(B, H, D).to(q.dtype)
    return acc.reshape(B, H, D).to(q.dtype), m.reshape(B, H), l.reshape(B, H)


def ssd_scan_ref(xdt: torch.Tensor, dA: torch.Tensor, Bc: torch.Tensor, Cc: torch.Tensor,
                 h0: Optional[torch.Tensor] = None):
    """The SSD recurrence one position at a time (no chunks), the ground truth
    of K5.  xdt (B,S,H,P) dt-weighted inputs; dA (B,S,H) decay logs; Bc, Cc
    (B,S,N).  ``h_t = exp(dA_t) h_{t-1} + B_t (xdt_t)^T``, ``y_t = C_t . h_t``,
    with h (B,H,N,P) float32 (float64 for float64 inputs) from ``h0`` or
    zero.  Returns (y (B,S,H,P) in xdt's dtype, the final h)."""
    B, S, H, P = xdt.shape
    N = Bc.shape[-1]
    acc = torch.promote_types(xdt.dtype, torch.float32)
    h = (torch.zeros((B, H, N, P), dtype=acc, device=xdt.device) if h0 is None
         else h0.to(acc))
    ys = []
    for t in range(S):
        a = torch.exp(dA[:, t].to(acc))                                    # (B,H)
        upd = torch.einsum("bn,bhp->bhnp", Bc[:, t].to(acc), xdt[:, t].to(acc))
        h = h * a[:, :, None, None] + upd
        ys.append(torch.einsum("bn,bhnp->bhp", Cc[:, t].to(acc), h))
    return torch.stack(ys, 1).to(xdt.dtype), h


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor, h0: Optional[torch.Tensor] = None):
    """The diagonal linear recurrence ``h_t = a_t * h_{t-1} + b_t`` one step
    at a time, the ground truth of K6.  a, b (B,S,D); the carry is float32
    (float64 for float64 inputs) from ``h0`` or zero.  Returns (h (B,S,D) in
    a's dtype, the final h)."""
    acc = torch.promote_types(a.dtype, torch.float32)
    h = torch.zeros_like(a[:, 0], dtype=acc) if h0 is None else h0.to(acc)
    af, bf = a.to(acc), b.to(acc)
    hs = []
    for t in range(a.shape[1]):
        h = af[:, t] * h + bf[:, t]
        hs.append(h)
    return torch.stack(hs, 1).to(a.dtype), h


def ssd_scan_bwd_ref(xdt: torch.Tensor, dA: torch.Tensor, Bc: torch.Tensor, Cc: torch.Tensor,
                     dy: torch.Tensor):
    """The gradient of ``ssd_scan_ref`` from h = 0 written out, one position
    at a time: the ground truth of the SSD scan's backward kernel (S3) and
    the backward the CPU takes.  Shapes as ``ssd_scan_ref``'s, dy (B,S,H,P).
    Walking t down from S-1, with dh (B,H,N,P) the gradient of h_t:
    ``dh_t = C_t dy_t^T + exp(dA_{t+1}) dh_{t+1}``, ``dx_t = B_t^T dh_t``,
    ``dB_t = sum_h dh_t x_t^T``, ``dC_t = sum_h h_t dy_t``,
    ``ddA_t = exp(dA_t) <dh_t, h_{t-1}>``.  The forward's states are
    replayed: it keeps h every ``_SEGMENT`` positions and forms one
    segment's again as the walk reaches it, so that it holds some 100 states
    at Mamba-2's 2048 positions rather than all of them.  Returns (dx, ddA, dB, dC) in the dtypes of
    xdt, dA, Bc, Cc; float32 arithmetic (float64 for float64 inputs)."""
    B, S, H, P = xdt.shape
    N = Bc.shape[-1]
    acc = torch.promote_types(xdt.dtype, torch.float32)
    x, a, Bf, Cf, g = (t.to(acc) for t in (xdt, dA, Bc, Cc, dy))
    a = torch.exp(a)                                                       # (B,S,H)

    def step(h, t):
        return h * a[:, t, :, None, None] + torch.einsum("bn,bhp->bhnp", Bf[:, t], x[:, t])

    h = torch.zeros((B, H, N, P), dtype=acc, device=xdt.device)
    marks = []                                  # h_{s0 - 1} at each segment's start s0
    for t in range(S):
        if t % _SEGMENT == 0:
            marks.append(h)
        h = step(h, t)
    dx, dB, dC = torch.empty_like(x), torch.empty_like(Bf), torch.empty_like(Cf)
    ddA = torch.empty_like(a)
    dh = torch.zeros_like(h)
    for s0 in reversed(range(0, S, _SEGMENT)):
        hs = [marks[s0 // _SEGMENT]]             # hs[i] = h_{s0 + i - 1}
        for t in range(s0, min(s0 + _SEGMENT, S)):
            hs.append(step(hs[-1], t))
        for t in reversed(range(s0, min(s0 + _SEGMENT, S))):
            dh = torch.einsum("bn,bhp->bhnp", Cf[:, t], g[:, t]) + (
                dh * a[:, t + 1, :, None, None] if t + 1 < S else 0.0)
            dx[:, t] = torch.einsum("bn,bhnp->bhp", Bf[:, t], dh)
            dB[:, t] = torch.einsum("bhnp,bhp->bn", dh, x[:, t])
            dC[:, t] = torch.einsum("bhnp,bhp->bn", hs[t - s0 + 1], g[:, t])
            ddA[:, t] = a[:, t] * (dh * hs[t - s0]).sum((-2, -1))
    return dx.to(xdt.dtype), ddA.to(dA.dtype), dB.to(Bc.dtype), dC.to(Cc.dtype)


def rglru_scan_bwd_ref(a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor):
    """The gradient of ``rglru_scan_ref`` from h = 0, one step at a time in
    float32 (float64 for float64 inputs): the ground truth of the RG-LRU
    scan's backward kernel (S4) and the backward the CPU takes.  a, h (the
    forward's output) and dh (B,S,D).  Walking t down from S-1:
    ``g_t = dh_t + a_{t+1} g_{t+1}``, ``db_t = g_t``, ``da_t = g_t h_{t-1}``
    with h_{-1} = 0.  Returns (da, db) in a's dtype."""
    acc = torch.promote_types(a.dtype, torch.float32)
    af, hf, dhf = a.to(acc), h.to(acc), dh.to(acc)
    g = torch.zeros_like(af[:, 0])
    gs = []
    for t in reversed(range(a.shape[1])):
        g = dhf[:, t] + (af[:, t + 1] * g if t + 1 < a.shape[1] else 0.0)
        gs.append(g)
    db = torch.stack(gs[::-1], 1)
    da = db * torch.cat([torch.zeros_like(hf[:, :1]), hf[:, :-1]], 1)
    return da.to(a.dtype), db.to(a.dtype)
