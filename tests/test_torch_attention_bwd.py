"""The gradient of the port's flash attention on the CPU: the plain backward
(``ref.flash_attention_bwd_ref``, the oracle of the backward kernel S2) and
the backward of ``flash_attention.FlashAttention`` (what ``ops.mha`` runs under
grad) against ``jax.vjp`` of the reference's model attention
(``repro.models.attention.flash_attention``, the chunked online softmax that
the reference trains through, and ``dense_attention``), and against autograd
through the port's plain forward.

Inputs are made with numpy from a seed and handed to both sides in float32.
Tolerance 1e-5 (rtol and atol): the same float32 arithmetic, summed in
another order (the backward rebuilds P from the forward's log-sum-exp where
autodiff keeps it).  ``gradcheck`` runs the Function in float64.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import dense_attention as ref_dense
from repro.models.attention import flash_attention as ref_flash

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fab
from repro_torch.kernels import ops, ref

TOL = dict(rtol=1e-5, atol=1e-5)

# B, Sq, Sk, H, KvH, D, causal, window
CASES = [
    (2, 16, 16, 4, 4, 16, True, None),      # group 1
    (2, 16, 16, 4, 2, 16, True, None),      # group 2
    (1, 24, 24, 8, 2, 32, True, None),      # group 4
    (2, 19, 19, 4, 1, 16, True, None),      # ragged Sq, MQA
    (2, 16, 16, 4, 2, 16, False, None),     # non-causal
    (1, 12, 20, 4, 2, 16, False, None),     # non-causal, Sq != Sk
    (2, 21, 21, 4, 2, 16, True, 5),         # a window
    (1, 40, 40, 2, 1, 8, True, 7),          # a window, several chunks
]


def operands(B, Sq, Sk, H, KvH, D, seed=0):
    """Model-layout q (B,Sq,H,D), k, v (B,Sk,KvH,D) and dO, float32 numpy."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, D), (B, Sk, KvH, D), (B, Sk, KvH, D), (B, Sq, H, D))]


def reference_vjp(fn, q, k, v, do, **kw):
    """(out, (dq, dk, dv)) of the reference function in model layout."""
    out, vjp = jax.vjp(lambda q, k, v: fn(q, k, v, **kw), jnp.asarray(q), jnp.asarray(k),
                       jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def kernel_layout(*arrays):
    return [torch.as_tensor(a).transpose(1, 2) for a in arrays]


@pytest.mark.parametrize("B,Sq,Sk,H,KvH,D,causal,window", CASES)
@pytest.mark.parametrize("oracle", ["flash", "dense"])
def test_plain_backward_matches_reference_vjp(B, Sq, Sk, H, KvH, D, causal, window, oracle):
    q, k, v, do = operands(B, Sq, Sk, H, KvH, D)
    kw = dict(causal=causal, window=window)
    fn = ref_flash if oracle == "flash" else ref_dense
    if oracle == "flash":
        kw["kv_chunk"] = 8                       # several chunks of the online softmax
    want_o, want = reference_vjp(fn, q, k, v, do, **kw)
    tq, tk, tv, tdo = kernel_layout(q, k, v, do)
    o, lse = ref.flash_attention_ref(tq, tk, tv, causal=causal, window=window, return_lse=True)
    np.testing.assert_allclose(o.transpose(1, 2).numpy(), want_o, **TOL)
    got = ref.flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo, causal=causal, window=window)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.transpose(1, 2).numpy(), w, **TOL)


@pytest.mark.parametrize("B,Sq,Sk,H,KvH,D,causal,window", CASES)
def test_function_backward_matches_reference_vjp(B, Sq, Sk, H, KvH, D, causal, window):
    """``ops.mha`` under grad on the CPU: the Function's backward equals the
    reference's VJP, and autograd through the plain forward."""
    q, k, v, do = operands(B, Sq, Sk, H, KvH, D, seed=1)
    _, want = reference_vjp(ref_flash, q, k, v, do, causal=causal, window=window, kv_chunk=8)
    tq, tk, tv = (torch.as_tensor(a).requires_grad_() for a in (q, k, v))
    out = ops.mha(tq, tk, tv, causal=causal, window=window)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (tq, tk, tv), torch.as_tensor(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL)
    plain = ref.flash_attention_ref(tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2),
                                    causal=causal, window=window).transpose(1, 2)
    autograd = torch.autograd.grad(plain, (tq, tk, tv), torch.as_tensor(do))
    for g, w in zip(got, autograd):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_kv_len_backward_matches_autograd_of_the_plain_forward(causal):
    """The reference's model attention has no ``kv_len``; the kernel's does:
    its masked keys get no gradient, as autograd through the plain forward
    says."""
    q, k, v, do = kernel_layout(*operands(2, 10, 14, 4, 2, 16, seed=2))
    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    kw = dict(causal=causal, kv_len=9)
    got = torch.autograd.grad(fa.flash_attention(q, k, v, **kw), (q, k, v), do)
    want = torch.autograd.grad(ref.flash_attention_ref(q, k, v, **kw), (q, k, v), do)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)
    assert float(got[1][:, :, 9:].abs().max()) == 0.0 == float(got[2][:, :, 9:].abs().max())


@pytest.mark.parametrize("B,Sq,Sk,H,KvH,D,causal,window,kv_len", [
    (1, 5, 5, 2, 1, 8, True, None, None),
    (1, 4, 6, 4, 2, 8, False, None, 5),
    (2, 7, 7, 2, 2, 8, True, 3, None),
    (1, 6, 6, 4, 1, 8, True, None, 4),
])
def test_function_gradcheck_in_float64(B, Sq, Sk, H, KvH, D, causal, window, kv_len):
    rng = np.random.default_rng(3)
    q, k, v = (torch.tensor(rng.standard_normal(s), dtype=torch.float64, requires_grad=True)
               for s in ((B, H, Sq, D), (B, KvH, Sk, D), (B, KvH, Sk, D)))
    fn = lambda q, k, v: fa.flash_attention(q, k, v, causal=causal, window=window,
                                            kv_len=kv_len)
    assert torch.autograd.gradcheck(fn, (q, k, v))


def test_backward_wrapper_takes_the_plain_version_on_the_cpu_and_counts_nothing():
    q, k, v, do = kernel_layout(*operands(1, 8, 8, 2, 1, 16, seed=4))
    o, lse = ref.flash_attention_ref(q, k, v, return_lse=True)
    before = fab.launches
    got = fab.flash_attention_bwd(q, k, v, o, lse, do)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do)
    assert fab.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="do not match"):
        fab.flash_attention_bwd(q, k, v, o, lse[:, :, :4], do)


def test_lse_is_the_log_sum_exp_of_the_scaled_scores():
    q, k, v, _ = kernel_layout(*operands(1, 6, 9, 4, 2, 16, seed=5))
    _, lse = ref.flash_attention_ref(q, k, v, causal=False, return_lse=True, scale=0.3)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k.repeat_interleave(2, dim=1)) * 0.3
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(), **TOL)


def test_no_grad_call_keeps_the_plain_forward():
    """Serving (no input requires grad) takes the plain forward, not the
    Function: the result has no ``grad_fn`` and equals the Function's."""
    q, k, v, _ = kernel_layout(*operands(1, 8, 8, 2, 1, 16, seed=6))
    plain = fa.flash_attention(q, k, v)
    assert plain.grad_fn is None
    qg = q.clone().requires_grad_()
    with_grad = fa.flash_attention(qg, k, v)
    assert isinstance(with_grad.grad_fn, torch.autograd.function.BackwardCFunction)
    assert torch.equal(plain, with_grad.detach())


# -- the backward's route and a value head dim of its own ---------------------------------


@pytest.mark.parametrize("D, Dv, dtype, want", [
    (64, 64, torch.bfloat16, ("wgmma", 64, 64)),          # tinyllama's training shape
    (16, 16, torch.bfloat16, ("wgmma", 16, 16)),
    (32, 32, torch.bfloat16, ("wgmma", 32, 32)),
    (128, 128, torch.bfloat16, ("wgmma", 128, 128)),
    (80, 80, torch.bfloat16, ("wgmma", 128, 128)),         # padded to the next head dim
    (192, 128, torch.bfloat16, ("wgmma", 192, 128)),       # MLA: its own instantiation
    (256, 256, torch.bfloat16, ("cuda_cores", 256, 256)),  # dK, dV would not fit a warpgroup
    (200, 200, torch.bfloat16, ("cuda_cores", 256, 256)),
    (64, 64, torch.float32, ("cuda_cores", 64, 64)),       # float32 keeps its CUDA-core kernel
    (192, 128, torch.float32, ("cuda_cores", 256, 256)),   # padded to one head dim
    (48, 32, torch.float32, ("cuda_cores", 64, 64)),
])
def test_bwd_route_of_each_call(D, Dv, dtype, want):
    route = fa.bwd_route(D, Dv, dtype)
    assert route == want and route[0] in fa.BWD_KERNELS


@pytest.mark.parametrize("D, Dv, dtype, error, match", [
    (48, 32, torch.bfloat16, ValueError, r"\(D 48, Dv 32\)"),   # a pair that is not built
    (128, 192, torch.bfloat16, ValueError, r"\(D 128, Dv 192\)"),
    (260, 260, torch.bfloat16, ValueError, "multiple of 8 up to 256"),
    (60, 60, torch.float32, ValueError, "multiple of 8 up to 256"),
    (64, 64, torch.float16, TypeError, "float32 or bfloat16"),
])
def test_bwd_route_refuses_what_no_kernel_takes(D, Dv, dtype, error, match):
    with pytest.raises(error, match=match):
        fa.bwd_route(D, Dv, dtype)


def test_bwd_routes_are_what_the_source_builds():
    """The tensor-core launcher's dispatch instantiates exactly
    ``BWD_WGMMA_HEAD_DIMS`` and ``BF16_PAIRS`` (a pair without the logit cap
    only), and each route's kernels are defined in the source."""
    src = (Path(fa.__file__).parent.parent / "csrc" / "flash_attention_bwd.cu").read_text()
    inst = re.findall(r"launch_wgmma_d<(\d+), (\d+), (CAP|false)>\(q", src)
    built = {(int(d), int(dv)) for d, dv, _ in inst}
    assert {pair for pair in built if pair[0] != pair[1]} == set(fa.BF16_PAIRS)
    assert {d for d, dv in built if d == dv} == set(fa.BWD_WGMMA_HEAD_DIMS)
    assert all(cap == "false" for d, dv, cap in inst if d != dv)
    for names in fa.BWD_KERNELS.values():
        for name in names:
            assert re.search(rf"^{name}\(", src, re.M), name


@pytest.mark.parametrize("B,Sq,Sk,H,KvH,causal,window,kv_len", [
    (2, 16, 16, 4, 4, True, None, None),
    (1, 24, 24, 8, 2, True, None, None),     # group 4
    (1, 12, 20, 4, 2, False, None, None),    # non-causal, Sq != Sk
    (2, 21, 21, 4, 2, True, 5, None),        # a window
    (1, 10, 14, 4, 2, False, None, 9),       # kv_len
])
def test_function_backward_with_a_value_dim_of_its_own(B, Sq, Sk, H, KvH, causal, window,
                                                       kv_len):
    """D 48 against Dv 32 under grad (what MLA's smoke config runs): the
    Function's gradients equal autograd through the plain forward, each of
    its own head dim."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.tensor(rng.standard_normal(s), dtype=torch.float32, requires_grad=True)
               for s in ((B, H, Sq, 48), (B, KvH, Sk, 48), (B, KvH, Sk, 32)))
    do = torch.tensor(rng.standard_normal((B, H, Sq, 32)), dtype=torch.float32)
    kw = dict(causal=causal, window=window, kv_len=kv_len, scale=0.17)
    out = fa.flash_attention(q, k, v, **kw)
    assert isinstance(out.grad_fn, torch.autograd.function.BackwardCFunction)
    got = torch.autograd.grad(out, (q, k, v), do)
    want = torch.autograd.grad(ref.flash_attention_ref(q, k, v, **kw), (q, k, v), do)
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.shape == t.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)
