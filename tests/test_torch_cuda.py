"""Tests of the port that need a CUDA card. They skip elsewhere; on a
machine with a card (where JAX need not be installed) run them with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

This file imports only torch and the port, so it collects without JAX.
"""
from __future__ import annotations

import pytest
import torch

from arbius_tpu_torch.ops import flash

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from arbius_tpu_torch.utils import setup_device

    return setup_device("cuda")


# (atol, rtol) against the plain version in float32 on the same inputs:
# in bf16, one rounding of the float32 result (<= 2**-8 of the value)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, (2e-5, 2e-5)),
                                       (torch.bfloat16, (1e-4, 2.0 ** -8))])
@pytest.mark.parametrize("b,h,sq,skv,d", [
    (1, 2, 200, 200, 40), (2, 8, 256, 77, 80), (1, 8, 64, 64, 160),
    (1, 1, 300, 300, 512), (2, 3, 100, 333, 33),
])
def test_kernel_matches_plain(cuda, dtype, tol, b, h, sq, skv, d):
    gen = torch.Generator(device=cuda).manual_seed(sq + d)
    q, k, v = (torch.randn(b, h, s, d, generator=gen, device=cuda)
               .to(dtype) for s in (sq, skv, skv))
    before = flash.flash_attention.launches
    out = flash.flash_attention(q, k, v)
    again = flash.flash_attention(q, k, v)
    assert flash.flash_attention.launches == before + 2
    plain = flash.flash_attention_reference(q.float(), k.float(), v.float())
    torch.testing.assert_close(out.float(), plain, atol=tol[0], rtol=tol[1])
    assert torch.equal(out, again)


def test_kernel_takes_strided_heads(cuda):
    """The models hand over [B, S, H, D] views transposed to [B, H, S, D]."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(2, 96, 4 * 40, generator=gen, device=cuda)
    q = x.view(2, 96, 4, 40).transpose(1, 2)
    out = flash.flash_attention(q, q, q)
    ref = flash.flash_attention_reference(q.contiguous(), q.contiguous(),
                                          q.contiguous())
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)
    assert torch.equal(flash.attention(q, q, q), out)


def test_conv_is_batch_position_invariant(cuda):
    """The conv shape where cuDNN's batched algorithm gave a sample other
    bits at another batch position (3x3, 1280 -> 1280, 16x16, batch 8)."""
    from arbius_tpu_torch.models.common import conv3x3

    conv = conv3x3(1280, 1280, torch.bfloat16, cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(8, 1280, 16, 16, generator=gen, device=cuda).bfloat16()
    perm = torch.tensor([2, 3, 0, 1, 6, 7, 4, 5], device=cuda)
    with torch.no_grad():
        assert torch.equal(conv(x[perm]), conv(x)[perm])
