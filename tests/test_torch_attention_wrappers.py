"""What the K3/K4 wrappers do before a launch, checked on the CPU: the head
dims the kernels are not built for run zero-padded (exactly, under the true
scale), rows the kernels cannot read 16 bytes at a time are copied, K4 forms
groups of at most 16 query heads, and its workspace grows without freeing
what a captured CUDA graph may still hold, and not at all inside a capture.

The plain versions stand in for the kernels here: padding a head dim with
zeros and cutting the output back gives their result on the unpadded
operands.  The kernels themselves take these shapes on the card in
``tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

from test_torch_gpu import attention_operands


@pytest.mark.parametrize("D", range(8, 257, 8))
def test_every_multiple_of_8_runs_at_the_next_kernel_head_dim(D):
    Dk = fa.kernel_head_dim(D, "k")
    assert Dk in fa.HEAD_DIMS and Dk >= D
    assert all(d < D for d in fa.HEAD_DIMS if d < Dk)


@pytest.mark.parametrize("D", [0, 4, 50, 100, 264, 512])
def test_other_head_dims_are_refused(D):
    with pytest.raises(ValueError, match="head dim"):
        fa.kernel_head_dim(D, "k")


def _padded(D, *tensors):
    return fa.kernel_operands(fa.kernel_head_dim(D, "k"), *tensors)


@pytest.mark.parametrize("D", [24, 48, 80, 200])
def test_zero_padding_the_head_dim_is_exact_for_flash_attention(D):
    q, k, v = map(torch.as_tensor, attention_operands((2, 8, 40, D), (2, 2, 40, D), "float32"))
    want = ref.flash_attention_ref(q, k, v, causal=True, window=16)
    qp, kp, vp = _padded(D, q, k, v)
    assert qp.shape[-1] == fa.kernel_head_dim(D, "k")
    got = ref.flash_attention_ref(qp, kp, vp, causal=True, window=16, scale=D ** -0.5)
    np.testing.assert_allclose(got[..., :D].numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    assert not got[..., D:].any()


@pytest.mark.parametrize("D", [24, 48, 80, 200])
def test_zero_padding_the_head_dim_is_exact_for_decode_attention(D):
    q, k, v = map(torch.as_tensor, attention_operands((3, 8, D), (3, 50, 2, D), "float32", 2))
    n = torch.tensor([1, 20, 50], dtype=torch.int32)
    qp, kp, vp = _padded(D, q, k, v)
    for normalize in (True, False):
        want = ref.decode_attention_ref(q, k, v, n, normalize=normalize)
        got = ref.decode_attention_ref(qp, kp, vp, n, scale=D ** -0.5, normalize=normalize)
        if normalize:
            want, got = (want,), (got[..., :D],)
        else:
            got = (got[0][..., :D],) + got[1:]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6, atol=1e-6)


def test_rows_the_kernels_cannot_read_are_copied():
    base = torch.arange(1 + 2 * 4 * 64, dtype=torch.float32)
    aligned = base[:-1].view(2, 4, 64)
    assert fa.rows_readable(aligned)
    assert fa.kernel_operands(64, aligned)[0] is aligned            # read in place
    for name, t in [("off 16 bytes", base[1:].view(2, 4, 64)),
                    ("row stride of 66", torch.zeros(2, 4, 66)[..., :64]),
                    ("last dim strided", torch.zeros(2, 64, 4).transpose(1, 2))]:
        assert not fa.rows_readable(t), name
        (copy,) = fa.kernel_operands(64, t)
        assert copy.is_contiguous() and copy.data_ptr() % 16 == 0 and fa.rows_readable(copy)
        assert torch.equal(copy, t), name
    (padded,) = fa.kernel_operands(64, base[1:1 + 2 * 4 * 48].view(2, 4, 48))
    assert padded.shape == (2, 4, 64) and fa.rows_readable(padded)
    assert torch.equal(padded, F.pad(base[1:1 + 2 * 4 * 48].view(2, 4, 48), (0, 16)))


@pytest.mark.parametrize("H,KvH,want", [(8, 8, 8), (32, 4, 4), (16, 1, 1), (32, 1, 2),
                                        (128, 2, 8), (20, 1, 2), (48, 3, 3)])
def test_decode_groups_hold_at_most_16_query_heads(H, KvH, want):
    assert dec.groups(H, KvH) == want
    assert dec.groups(H, KvH) * dec.MAX_GROUP >= H


@pytest.fixture
def no_workspace(monkeypatch):
    monkeypatch.setattr(dec, "_workspaces", {})
    monkeypatch.setattr(dec, "_retired", [])


def test_workspace_growth_keeps_what_it_supersedes(no_workspace):
    cpu = torch.device("cpu")
    partials, counters = dec._workspace(cpu, 100, 3)
    assert partials.numel() == 1 << 16 and counters.numel() == 256 and not counters.any()
    assert dec._workspace(cpu, 1 << 16, 256) == (partials, counters)      # large enough
    grown, more = dec._workspace(cpu, (1 << 16) + 1, 300)
    assert grown.numel() == 1 << 17 and more.numel() == 512               # at least doubled
    assert dec._retired[0] is partials and dec._retired[1] is counters
    assert dec._workspaces[None] == (grown, more)


def test_workspace_does_not_grow_inside_a_capture(no_workspace, monkeypatch):
    """Inside a capture a call that needs more raises and allocates nothing;
    one that fits takes the workspace as it is."""
    card = torch.device("cuda", 0)
    held = (torch.empty(1 << 16), torch.zeros(256, dtype=torch.int32))
    dec._workspaces[0] = held
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    assert dec._workspace(card, 1000, 10) == held
    with pytest.raises(RuntimeError, match=r"grow to 100000 float32 partials .* capture"):
        dec._workspace(card, 100_000, 10)
    assert dec._workspaces[0] == held and dec._retired == []
