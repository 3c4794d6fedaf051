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


def _inputs(device, b, h, sq, skv, d, dtype, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(b, h, s, d, generator=gen, device=device).to(dtype)
            for s in (sq, skv, skv)]


def _assert_within_bound(out, q, k, v, route):
    """Per element within ops/flash.py's error_bound for `route`, against
    the plain version in float32 on the same inputs."""
    ref = flash.flash_attention_reference(q.float(), k.float(), v.float())
    err = (out.float() - ref).abs()
    bound = flash.error_bound(q, k, v, route)
    assert bool((err <= bound).all()), (
        f"max error {err.max().item()}, worst error/bound "
        f"{(err / bound).max().item()}")


_CUDA_CORE_SHAPES = [(1, 2, 200, 200, 40), (2, 8, 256, 77, 80),
                     (1, 8, 64, 64, 160), (1, 1, 300, 300, 512),
                     (2, 3, 100, 333, 33)]
_TENSOR_CORE_SHAPES = [(1, 2, 200, 200, 40), (2, 8, 256, 77, 80),
                       (1, 8, 64, 64, 160), (1, 2, 200, 333, 40),
                       (2, 3, 200, 77, 80), (1, 4, 200, 333, 160)]
# the VAE's shape at 512x512, and ragged query and key lengths
_WIDE_SHAPES = [(4, 1, 4096, 4096, 512), (1, 1, 200, 77, 512),
                (2, 1, 1000, 1000, 512)]
# those, and the VAE's at 640x640 and 1024x768 (768x1024's is the same)
_WGMMA_WIDE_SHAPES = [*_WIDE_SHAPES, (4, 1, 6400, 6400, 512),
                      (4, 1, 12288, 12288, 512)]
# the UNet's two large self-attentions at 512x512, lengths that differ,
# D = 160 at 512x512 and 768x768, D = 80 at 640x640, ragged lengths; the
# video UNet's D = 64 self-attentions at damo's 1024 and 256 tokens and
# zeroscopev2xl's 144; fewer work tiles (b*h x query tiles) than SMs
_WGMMA_SHAPES = [(8, 8, 4096, 4096, 40), (8, 8, 1024, 1024, 80),
                 (1, 2, 128, 384, 40), (2, 3, 384, 128, 80),
                 (8, 8, 256, 256, 160), (8, 8, 576, 576, 160),
                 (8, 8, 1600, 1600, 80), (1, 2, 200, 333, 40),
                 (2, 3, 100, 129, 160), (1, 1, 64, 1000, 80),
                 (128, 5, 1024, 1024, 64), (128, 10, 256, 256, 64),
                 (192, 20, 144, 144, 64), (1, 3, 300, 700, 64)]
# the 77-key cross-attentions at 512x512 and 768x768, short
# self-attentions, and ragged query lengths and key widths (N = 16, 32,
# 64, 80, 128)
_SHORT_SHAPES = [(8, 8, 4096, 77, 40), (8, 8, 1024, 77, 80),
                 (8, 8, 256, 77, 160), (8, 8, 64, 64, 160),
                 (8, 8, 9216, 77, 40), (1, 2, 200, 16, 40),
                 (2, 3, 100, 30, 80), (2, 3, 100, 100, 160),
                 (1, 1, 4, 4, 160), (1, 2, 333, 128, 80)]


@pytest.mark.parametrize("route,dtype,b,h,sq,skv,d", [
    *(("cuda_core", dt, *s) for dt in (torch.float32, torch.bfloat16)
      for s in _CUDA_CORE_SHAPES),
    *(("tensor_core", torch.bfloat16, *s) for s in _TENSOR_CORE_SHAPES),
    *(("tensor_core_wide", torch.bfloat16, *s) for s in _WIDE_SHAPES),
    *(("tensor_core_wgmma_wide", torch.bfloat16, *s)
      for s in _WGMMA_WIDE_SHAPES),
    *(("tensor_core_wgmma", torch.bfloat16, *s) for s in _WGMMA_SHAPES),
    *(("tensor_core_wgmma_short", torch.bfloat16, *s)
      for s in _SHORT_SHAPES),
])
def test_kernel_matches_plain(cuda, route, dtype, b, h, sq, skv, d):
    q, k, v = _inputs(cuda, b, h, sq, skv, d, dtype, seed=sq + d)
    before = dict(flash.flash_attention.launches_by_route)
    out = flash.flash_attention(q, k, v, kernel=route)
    again = flash.flash_attention(q, k, v, kernel=route)
    assert flash.flash_attention.launches_by_route[route] == (
        before[route] + 2)
    _assert_within_bound(out, q, k, v, route)
    assert torch.equal(out, again)


def test_tensor_core_route_is_batch_position_invariant(cuda):
    """Permuting the batch permutes the output bit for bit (the mma.sync
    route forced; the rule sends these inputs to the wgmma route)."""
    q, k, v = _inputs(cuda, 8, 2, 200, 333, 40, torch.bfloat16, seed=5)
    perm = torch.tensor([2, 3, 0, 1, 6, 7, 4, 5], device=cuda)
    assert "tensor_core" in flash.routes_of(q, k, v)
    assert torch.equal(
        flash.flash_attention(q[perm], k[perm], v[perm], kernel="tensor_core"),
        flash.flash_attention(q, k, v, kernel="tensor_core")[perm])


@pytest.mark.parametrize("b,h,sq,skv,d", _WIDE_SHAPES)
def test_wide_tensor_core_route_is_batch_position_invariant(cuda, b, h, sq,
                                                            skv, d):
    """Permuting the batch (doubled, so that B = 1 has a neighbour)
    permutes the output bit for bit (the mma.sync wide route forced; the
    rule sends these inputs to the wgmma wide route)."""
    q, k, v = _inputs(cuda, 2 * b, h, sq, skv, d, torch.bfloat16, seed=7)
    perm = torch.arange(2 * b, device=cuda).roll(1)
    assert flash.routes_of(q, k, v)[1] == "tensor_core_wide"
    wide = "tensor_core_wide"
    assert torch.equal(
        flash.flash_attention(q[perm], k[perm], v[perm], kernel=wide),
        flash.flash_attention(q, k, v, kernel=wide)[perm])


@pytest.mark.parametrize("b,h,sq,skv,d", _WGMMA_WIDE_SHAPES)
def test_wgmma_wide_route_is_batch_position_invariant(cuda, b, h, sq, skv,
                                                      d):
    """Permuting the batch (doubled, so that B = 1 has a neighbour)
    permutes the output bit for bit: a block's query tile, its cluster's
    neighbours and which block issued a load leave its arithmetic
    alone."""
    q, k, v = _inputs(cuda, 2 * b, h, sq, skv, d, torch.bfloat16, seed=13)
    perm = torch.arange(2 * b, device=cuda).roll(1)
    assert flash.route_of(q, k, v) == "tensor_core_wgmma_wide"
    assert torch.equal(flash.flash_attention(q[perm], k[perm], v[perm]),
                       flash.flash_attention(q, k, v)[perm])


@pytest.mark.parametrize("s", [4096, 1000])
def test_wgmma_wide_route_takes_the_vaes_strided_views(cuda, s):
    """As the VAE hands them over: [B, S, C] projections viewed as
    [B, 1, S, D]; the output equals the contiguous inputs' bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(s)
    x = torch.randn(2, s, 3 * 512, generator=gen, device=cuda).bfloat16()
    q, k, v = (x[:, :, 512 * i:512 * (i + 1)].unsqueeze(1) for i in range(3))
    assert flash.route_of(q, k, v) == "tensor_core_wgmma_wide"
    out = flash.flash_attention(q, k, v)
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    _assert_within_bound(out, qc, kc, vc, "tensor_core_wgmma_wide")
    assert torch.equal(flash.flash_attention(qc, kc, vc), out)


@pytest.mark.parametrize("b,h,sq,skv,d", _WGMMA_SHAPES)
def test_wgmma_route_is_batch_position_invariant(cuda, b, h, sq, skv, d):
    """Permuting the batch (doubled, so that every entry has a
    neighbour) permutes the output bit for bit (the route forced where
    the rule sends a shape of at most 128 keys to the short one)."""
    q, k, v = _inputs(cuda, 2 * b, h, sq, skv, d, torch.bfloat16, seed=9)
    perm = torch.arange(2 * b, device=cuda).roll(1)
    assert flash.route_of(q, k, v) == ("tensor_core_wgmma_short"
                                       if skv <= 128 else "tensor_core_wgmma")
    wgmma = "tensor_core_wgmma"
    assert torch.equal(
        flash.flash_attention(q[perm], k[perm], v[perm], kernel=wgmma),
        flash.flash_attention(q, k, v, kernel=wgmma)[perm])


@pytest.mark.parametrize("d", [40, 64, 80, 160])
def test_wgmma_route_takes_the_models_strided_views(cuda, d):
    """Self-attention as the UNet hands it over: [B, S, H*D] viewed as
    [B, H, S, D]; the TMA maps read those strides."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    x = torch.randn(2, 256, 8 * d, generator=gen, device=cuda).bfloat16()
    q = x.view(2, 256, 8, d).transpose(1, 2)
    assert flash.route_of(q, q, q) == "tensor_core_wgmma"
    out = flash.flash_attention(q, q, q)
    qc = q.contiguous()
    _assert_within_bound(out, qc, qc, qc, "tensor_core_wgmma")
    assert torch.equal(flash.flash_attention(qc, qc, qc), out)


@pytest.mark.parametrize("route,cases", [
    ("tensor_core_wgmma", ((128, 128, 96), (64, 77, 48), (64, 64, 512))),
    ("tensor_core_wgmma_short", ((64, 129, 40), (64, 77, 96), (64, 77, 48)))])
def test_wgmma_route_refuses_what_the_rule_sends_elsewhere(cuda, route,
                                                           cases):
    before = flash.flash_attention.launches_by_route[route]
    for sq, skv, d in cases:
        q = torch.zeros(1, 1, sq, d, device=cuda, dtype=torch.bfloat16)
        kv = torch.zeros(1, 1, skv, d, device=cuda, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="cannot take"):
            flash.flash_attention(q, kv, kv, kernel=route)
    q = torch.zeros(1, 1, 64, 80, device=cuda)   # float32
    with pytest.raises(ValueError, match="cannot take"):
        flash.flash_attention(q, q, q, kernel=route)
    assert flash.flash_attention.launches_by_route[route] == before


@pytest.mark.parametrize("b,h,sq,skv,d", _SHORT_SHAPES[:4])
def test_short_wgmma_route_is_batch_position_invariant(cuda, b, h, sq, skv,
                                                       d):
    """Permuting the batch (doubled, so that every entry has a
    neighbour) permutes the output bit for bit."""
    q, k, v = _inputs(cuda, 2 * b, h, sq, skv, d, torch.bfloat16, seed=11)
    perm = torch.arange(2 * b, device=cuda).roll(1)
    assert flash.route_of(q, k, v) == "tensor_core_wgmma_short"
    assert torch.equal(flash.flash_attention(q[perm], k[perm], v[perm]),
                       flash.flash_attention(q, k, v)[perm])


@pytest.mark.parametrize("route,s,skv,d", [
    ("tensor_core_wgmma_short", 256, 77, 40),
    ("tensor_core_wgmma_short", 100, 100, 160),
    ("tensor_core_wgmma", 400, 400, 160),
    ("tensor_core_wgmma", 200, 200, 80)])
def test_wgmma_routes_take_the_models_strided_views_at_any_length(
        cuda, route, s, skv, d):
    """As the UNet hands them over: [B, S, H*D] viewed as [B, H, S, D],
    the keys from a context of `skv` tokens; the TMA maps read those
    strides, and the output equals the contiguous inputs' bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(d + s)
    q = (torch.randn(2, s, 8 * d, generator=gen, device=cuda).bfloat16()
         .view(2, s, 8, d).transpose(1, 2))
    kv = (torch.randn(2, skv, 8 * d, generator=gen, device=cuda).bfloat16()
          .view(2, skv, 8, d).transpose(1, 2))
    assert flash.route_of(q, kv, kv) == route
    out = flash.flash_attention(q, kv, kv)
    qc, kc = q.contiguous(), kv.contiguous()
    _assert_within_bound(out, qc, kc, kc, route)
    assert torch.equal(flash.flash_attention(qc, kc, kc), out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_takes_strided_heads(cuda, dtype):
    """The models hand over [B, S, H, D] views transposed to [B, H, S, D];
    in bf16 they take the tensor-core route."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(2, 96, 4 * 40, generator=gen, device=cuda).to(dtype)
    q = x.view(2, 96, 4, 40).transpose(1, 2)
    route = flash.route_of(q, q, q)
    assert route == ("tensor_core_wgmma_short" if dtype == torch.bfloat16
                     else "cuda_core")
    out = flash.flash_attention(q, q, q)
    qc = q.contiguous()
    _assert_within_bound(out, qc, qc, qc, route)
    assert torch.equal(flash.attention(q, q, q), out)


def test_tensor_core_route_refuses_what_the_rule_sends_elsewhere(cuda):
    q = torch.zeros(1, 1, 64, 40, device=cuda)
    with pytest.raises(ValueError, match="cannot take"):
        flash.flash_attention(q, q, q, kernel="tensor_core")


def test_wide_tensor_core_route_refuses_float32(cuda):
    q = torch.zeros(1, 1, 64, 512, device=cuda)
    before = flash.flash_attention.launches_by_route["tensor_core_wide"]
    with pytest.raises(ValueError, match="cannot take"):
        flash.flash_attention(q, q, q, kernel="tensor_core_wide")
    assert flash.flash_attention.launches_by_route["tensor_core_wide"] == (
        before)


def test_wgmma_wide_route_refuses_what_the_rule_sends_elsewhere(cuda):
    """float32, another head dim and a misaligned pointer: a forced call
    raises and launches nothing."""
    route = "tensor_core_wgmma_wide"
    before = flash.flash_attention.launches_by_route[route]
    f32 = torch.zeros(1, 1, 64, 512, device=cuda)
    d160 = torch.zeros(1, 1, 64, 160, device=cuda, dtype=torch.bfloat16)
    off = torch.zeros(64 * 512 + 1, device=cuda,
                      dtype=torch.bfloat16)[1:].view(1, 1, 64, 512)
    for q, kv in ((f32, f32), (d160, d160), (off, off)):
        with pytest.raises(ValueError, match="cannot take"):
            flash.flash_attention(q, kv, kv, kernel=route)
    assert flash.flash_attention.launches_by_route[route] == before


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


@pytest.mark.parametrize("precision", ["int8", "fp8"])
def test_textgen_quantized_graph_equals_eager(cuda, precision):
    """textgen in int8 and fp8 on the card: the captured graph begins by
    dequantizing the resident qv and qs into its own memory, and gives
    the plain loop's tokens bit for bit, every sampler, on a replay
    after another bucket's graph ran in between; between chunks the
    eligible parameters hold no full-width storage."""
    from arbius_tpu_torch.models.textgen import TextGenPipeline

    pipe = TextGenPipeline(device=cuda, precision=precision)
    pipe.load_params(pipe.init_params(seed=0))
    prompts, seeds = ["once upon a time", "ab", "x", "arbius"], [1, 2, 3, 4]
    for sampler in ("greedy", "top_k"):
        kw = dict(prompt_bucket=32, decode_bucket=16, sampler=sampler)
        eager = pipe.generate(prompts, seeds, eager=True, **kw)
        graph = pipe.generate(prompts, seeds, **kw)
        pipe.generate(prompts, seeds, prompt_bucket=64, decode_bucket=32,
                      sampler=sampler)
        again = pipe.generate(prompts, seeds, **kw)
        assert (graph == eager).all() and (again == eager).all()
        assert pipe.quantized.emptied()
