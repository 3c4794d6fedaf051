"""The rule between the four attention kernels (`route`) and the error
bound their outputs are held to (`error_bound`), on the CPU.

The tensor-core kernels (csrc/flash_attn_wgmma.cu for D = 40 and 80 at
lengths that are multiples of 128, csrc/flash_attn_tc.cu, and
csrc/flash_attn_tc_wide.cu for D = 512) round the probabilities P to
bf16 before P V; `_tensor_core_arithmetic` repeats their arithmetic in
plain torch (64-key tiles, 128 for the wgmma kernel, online softmax in
the log2 domain, P rounded to bf16, l summed from the unrounded P; for
the wide kernel each tile's keys in two halves that share the row max and
sum l apart) so that the bound can be held against it here. The kernels themselves are checked on
the card (tests/test_torch_cuda.py, chip_smoke.py,
tools/flash_mutants.py)."""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import chip_smoke
from arbius_tpu_torch.models import common
from arbius_tpu_torch.models.sd15 import vae
from arbius_tpu_torch.ops import flash

UNET_SHAPES = [s[:5] for s in chip_smoke.MAIN_PATH_SHAPES if s[4] <= 160]


def _contiguous(b, h, s, d):
    return (h * s * d, s * d, d)


def _route_contiguous(dtype, b, h, sq, skv, d, pointer=256):
    strides = _contiguous(b, h, sq, d) + 2 * _contiguous(b, h, skv, d)
    return flash.route(dtype, d, strides, [pointer] * 3, sq, skv)


def test_unet_shapes_take_the_tensor_cores_and_the_vae_does_not():
    """The UNet's two large self-attentions (D = 40 at S = 4096, D = 80 at
    S = 1024) take the tensor_core_wgmma route, its other shapes
    tensor_core; the VAE's D = 512 takes tensor_core_wide."""
    assert len(UNET_SHAPES) == 8
    wgmma = [(8, 8, 4096, 4096, 40), (8, 8, 1024, 1024, 80)]
    for shape in UNET_SHAPES:
        want = "tensor_core_wgmma" if shape in wgmma else "tensor_core"
        assert _route_contiguous(torch.bfloat16, *shape) == want, shape
    vae_shapes = [s[:5] for s in chip_smoke.MAIN_PATH_SHAPES if s[4] > 160]
    assert vae_shapes == [(4, 1, 4096, 4096, 512)]
    assert _route_contiguous(torch.bfloat16, *vae_shapes[0]) == (
        "tensor_core_wide")


def test_chip_smoke_expects_each_main_path_launch_on_its_route():
    assert chip_smoke.expected_launches(torch, flash) == {
        "tensor_core_wgmma": 200, "tensor_core": 440,
        "tensor_core_wide": 1, "cuda_core": 0}


def test_main_path_shapes_are_the_512_bucket():
    assert chip_smoke.MAIN_PATH_SHAPES == (
        (8, 8, 4096, 4096, 40, 100), (8, 8, 4096, 77, 40, 100),
        (8, 8, 1024, 1024, 80, 100), (8, 8, 1024, 77, 80, 100),
        (8, 8, 256, 256, 160, 100), (8, 8, 256, 77, 160, 100),
        (8, 8, 64, 64, 160, 20), (8, 8, 64, 77, 160, 20),
        (4, 1, 4096, 4096, 512, 1))
    assert chip_smoke.LAUNCHES_PER_CHUNK == 641


# (width, height) -> the self-attention (S, D) pairs that take the wgmma
# route, of the UNet's four levels (S = W*H/64 / 4^level)
_WGMMA_SELF = {
    (512, 512): {(4096, 40), (1024, 80)},
    (768, 768): {(9216, 40), (2304, 80)},
    (1024, 768): {(12288, 40), (3072, 80)},
    (768, 1024): {(12288, 40), (3072, 80)},
    # level 1 at 640x640 is S = 1600, not a multiple of 128
    (640, 640): {(6400, 40)},
    (128, 128): {(256, 40)},
}


@pytest.mark.parametrize("size", sorted(_WGMMA_SELF))
def test_rule_at_every_bucket(size):
    """At each bucket only self-attentions at D = 40 and 80 whose length
    is a multiple of 128 take tensor_core_wgmma; the cross-attentions (77
    keys) and D = 160 stay on tensor_core; the VAE takes
    tensor_core_wide."""
    shapes = chip_smoke.attention_shapes(*size)
    want = {"tensor_core_wgmma": 0, "tensor_core": 0,
            "tensor_core_wide": 1, "cuda_core": 0}
    for b, h, sq, skv, d, count in shapes:
        got = _route_contiguous(torch.bfloat16, b, h, sq, skv, d)
        if d == 512:
            assert got == "tensor_core_wide"
            continue
        wgmma = sq == skv and (sq, d) in _WGMMA_SELF[size]
        assert got == ("tensor_core_wgmma" if wgmma else "tensor_core"), (
            size, sq, skv, d)
        want[got] += count
    assert chip_smoke.expected_launches(torch, flash, shapes) == want


def test_768_bucket_shapes():
    assert chip_smoke.BUCKET_768_SHAPES == chip_smoke.attention_shapes(
        768, 768)
    assert chip_smoke.expected_launches(
        torch, flash, chip_smoke.BUCKET_768_SHAPES) == {
        "tensor_core_wgmma": 200, "tensor_core": 440,
        "tensor_core_wide": 1, "cuda_core": 0}


@pytest.mark.parametrize("case", [
    "ok", "d48", "d160", "sq_ragged", "skv_77", "float32", "s_stride",
    "pointer"])
def test_rule_for_the_wgmma_route(case):
    """bf16, D in {40, 80}, both lengths multiples of 128 and the
    tensor-core stride and alignment conditions; whatever fails one of
    them goes where it went before (the mma.sync route or the CUDA
    cores), and the mma.sync route can still be forced onto a wgmma
    call."""
    dtype, d, sq, skv, pointer = torch.bfloat16, 40, 256, 384, 256
    if case.startswith("d"):
        d = int(case[1:])
    elif case == "sq_ragged":
        sq = 200
    elif case == "skv_77":
        skv = 77
    elif case == "float32":
        dtype = torch.float32
    elif case == "pointer":
        pointer = 256 + 2
    strides = list(_contiguous(2, 8, sq, d)) + 2 * list(
        _contiguous(2, 8, skv, d))
    if case == "s_stride":
        strides[2] = 44
    got = flash.routes(dtype, d, strides, [256, pointer, 256], sq, skv)
    want = {"ok": ["tensor_core_wgmma", "tensor_core", "cuda_core"],
            "d48": ["tensor_core", "cuda_core"],
            "d160": ["tensor_core", "cuda_core"],
            "sq_ragged": ["tensor_core", "cuda_core"],
            "skv_77": ["tensor_core", "cuda_core"],
            "float32": ["cuda_core"], "s_stride": ["cuda_core"],
            "pointer": ["cuda_core"]}[case]
    assert got == want
    assert flash.route(dtype, d, strides, [256, pointer, 256], sq,
                       skv) == want[0]


@pytest.mark.parametrize("d", [40, 80, 160])
def test_models_strided_views_take_the_tensor_cores(monkeypatch, d):
    """The UNet's Attention hands [B, S, H, D] views transposed to
    [B, H, S, D]: self- and cross-attention both pass the rule."""
    seen = []

    def spy(q, k, v):
        seen.append((flash.route_of(q, k, v), q.is_contiguous()))
        return flash.flash_attention_reference(q, k, v)

    monkeypatch.setattr(common, "fused_attention", spy)
    torch.manual_seed(0)
    attn_self = common.Attention(8 * d, 8, d, torch.bfloat16)
    attn_cross = common.Attention(8 * d, 8, d, torch.bfloat16,
                                  context_dim=96)
    x = torch.randn(2, 16, 8 * d).bfloat16()
    with torch.no_grad():
        attn_self(x)
        attn_cross(x, torch.randn(2, 77, 96).bfloat16())
    assert seen == [("tensor_core", False)] * 2


def test_vae_strided_views_take_the_wide_tensor_cores(monkeypatch):
    """The VAE's mid-block attention (one head, D = channels = 512) hands
    its [B, S, C] projections over as [B, 1, S, D] views."""
    seen = []

    def spy(q, k, v):
        seen.append(flash.route_of(q, k, v))
        return flash.flash_attention_reference(q, k, v)

    monkeypatch.setattr(common, "fused_attention", spy)
    torch.manual_seed(0)
    mid = vae._MidAttention(512, torch.bfloat16)
    with torch.no_grad():
        out = mid(torch.randn(2, 512, 4, 4).bfloat16())
    assert out.shape == (2, 512, 4, 4)
    assert seen == ["tensor_core_wide"]


@pytest.mark.parametrize("case", [
    "float32", "d384", "d33", "d168", "d4", "s_stride", "h_stride",
    "pointer"])
def test_rule_sends_the_rest_to_the_cuda_cores(case):
    dtype, d, pointer = torch.bfloat16, 40, 256
    strides = list(_contiguous(2, 8, 64, 40)) * 3
    if case == "float32":
        dtype = torch.float32
    elif case.startswith("d"):
        d = int(case[1:])
        strides = list(_contiguous(2, 8, 64, d)) * 3
    elif case == "s_stride":
        strides[2] = 44              # rows 44 elements apart
    elif case == "h_stride":
        strides[4] = 64 * 40 + 4
    else:
        pointer = 256 + 2            # one bf16 element off 16 bytes
    assert flash.route(dtype, d, strides, [256, 256, pointer], 64,
                       64) == "cuda_core"


@pytest.mark.parametrize("case", [
    "bfloat16", "float32", "d384", "s_stride", "h_stride", "pointer"])
def test_rule_at_d512_takes_the_wide_tensor_cores_only_for_aligned_bf16(
        case):
    dtype, d, pointer = torch.bfloat16, 512, 256
    strides = list(_contiguous(4, 1, 64, 512)) * 3
    if case == "float32":
        dtype = torch.float32
    elif case == "d384":
        d = 384
        strides = list(_contiguous(4, 1, 64, d)) * 3
    elif case == "s_stride":
        strides[5] = 516             # k's rows 516 elements apart
    elif case == "h_stride":
        strides[1] = 64 * 512 + 4
    elif case == "pointer":
        pointer = 256 + 2            # one bf16 element off 16 bytes
    want = "tensor_core_wide" if case == "bfloat16" else "cuda_core"
    assert flash.route(dtype, d, strides, [256, pointer, 256], 64,
                       64) == want


def test_route_of_reads_real_tensors():
    x = torch.zeros(2 * 8 * 64 * 40 + 1, dtype=torch.bfloat16)
    q = x[:-1].view(2, 8, 64, 40)
    assert flash.route_of(q, q, q) == "tensor_core"
    y = torch.zeros(1 * 128 * 8 * 80 + 8, dtype=torch.bfloat16)
    w = y[:-8].view(1, 128, 8, 80).transpose(1, 2)   # the models' view
    assert flash.route_of(w, w, w) == "tensor_core_wgmma"
    assert flash.routes_of(w, w, w) == [
        "tensor_core_wgmma", "tensor_core", "cuda_core"]
    short = w[:, :, :77]
    assert flash.route_of(w, short, short) == "tensor_core"
    assert flash.route_of(w, w, y[1:-7].view(1, 128, 8, 80)
                          .transpose(1, 2)) == "cuda_core"
    off = x[1:].view(2, 8, 64, 40)   # data pointer 2 bytes off
    assert flash.route_of(q, off, q) == "cuda_core"
    assert flash.route_of(q.float(), q.float(), q.float()) == "cuda_core"
    y = torch.zeros(1 * 64 * 512 + 1, dtype=torch.bfloat16)
    w = y[:-1].view(1, 1, 64, 512)
    assert flash.route_of(w, w, w) == "tensor_core_wide"
    assert flash.route_of(w, w, y[1:].view(1, 1, 64, 512)) == "cuda_core"


def _qkv(b, h, sq, skv, d, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, h, s, d))
                             .astype(np.float32)).bfloat16()
            for s in (sq, skv, skv)]


def _tensor_core_arithmetic(q, k, v, scale_factor=1.0, tile=64,
                            halves=1):
    """The tensor-core kernels' arithmetic in plain torch: bf16 inputs,
    float32 scores, online softmax over 64-key tiles with
    exp2(s * scale * log2(e) - m * scale * log2(e)), P rounded to bf16
    for P V, l summed from the unrounded P, output rounded to bf16. With
    `halves=2` (the wide kernel) each tile's keys are split in two halves
    that share the row max; each half sums its own l, and the halves'
    sums are added once, at the end."""
    sl2 = scale_factor / math.sqrt(q.shape[-1]) * math.log2(math.e)
    qf, kf, vf = q.float(), k.float(), v.float()
    part = tile // halves
    m = torch.full(q.shape[:3], -math.inf)
    l = torch.zeros((halves, *q.shape[:3]))
    o = torch.zeros(q.shape)
    for kv0 in range(0, k.shape[2], tile):
        s = qf @ kf[:, :, kv0:kv0 + tile].transpose(-1, -2)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2((m - m_new) * sl2)
        p = torch.exp2(s * sl2 - (m_new * sl2)[..., None])
        l = l * alpha + torch.stack([p[..., i * part:(i + 1) * part].sum(-1)
                                     for i in range(halves)])
        o = o * alpha[..., None] + p.bfloat16().float() @ vf[:, :, kv0:kv0
                                                               + tile]
        m = m_new
    return (o / l.sum(0)[..., None]).bfloat16()


def _within(out, q, k, v, route):
    ref = flash.flash_attention_reference(q.float(), k.float(), v.float())
    err = (out.float() - ref).abs()
    return bool((err <= flash.error_bound(q, k, v, route)).all())


@pytest.mark.parametrize("d", [40, 80, 160])
@pytest.mark.parametrize("skv", [48, 77])
def test_tensor_core_arithmetic_lies_within_its_bound(d, skv):
    q, k, v = _qkv(2, 2, 96, skv, d, seed=d + skv)
    out = _tensor_core_arithmetic(q, k, v)
    assert _within(out, q, k, v, "tensor_core")
    # the CUDA-core kernel's bound (one rounding of the float32 result)
    # is too tight for this arithmetic: P's rounding needs its own term
    assert not _within(out, q, k, v, "cuda_core")


@pytest.mark.parametrize("d", [40, 80, 160])
@pytest.mark.parametrize("skv", [48, 77])
def test_scale_one_percent_high_breaks_the_bound(d, skv):
    q, k, v = _qkv(2, 2, 96, skv, d, seed=d + skv)
    out = _tensor_core_arithmetic(q, k, v, scale_factor=1.01)
    assert not _within(out, q, k, v, "tensor_core")


@pytest.mark.parametrize("d", [40, 80])
@pytest.mark.parametrize("skv", [128, 384])
def test_wgmma_arithmetic_lies_within_its_bound(d, skv):
    """The wgmma kernel's arithmetic is the mma.sync kernel's over
    128-key tiles; it is held to the same bound, which the CUDA-core
    route's tighter one is not."""
    q, k, v = _qkv(2, 2, 128, skv, d, seed=d + skv)
    out = _tensor_core_arithmetic(q, k, v, tile=128)
    assert _within(out, q, k, v, "tensor_core_wgmma")
    assert not _within(out, q, k, v, "cuda_core")
    torch.testing.assert_close(
        flash.error_bound(q, k, v, "tensor_core_wgmma"),
        flash.error_bound(q, k, v, "tensor_core"), rtol=0, atol=0)


@pytest.mark.parametrize("d", [40, 80])
@pytest.mark.parametrize("skv", [128, 384])
def test_wgmma_scale_one_percent_high_breaks_the_bound(d, skv):
    q, k, v = _qkv(2, 2, 128, skv, d, seed=d + skv)
    out = _tensor_core_arithmetic(q, k, v, scale_factor=1.01, tile=128)
    assert not _within(out, q, k, v, "tensor_core_wgmma")


@pytest.mark.parametrize("d", [40, 80])
def test_wgmma_dropping_the_last_key_breaks_the_bound(d):
    """The other fault tools/flash_mutants.py builds into the source."""
    q, k, v = _qkv(2, 2, 128, 256, d, seed=d)
    out = _tensor_core_arithmetic(q, k[:, :, :-1], v[:, :, :-1], tile=128)
    assert not _within(out, q, k, v, "tensor_core_wgmma")


@pytest.mark.parametrize("sq", [48, 200])
@pytest.mark.parametrize("skv", [48, 77, 100])
def test_wide_tensor_core_arithmetic_lies_within_its_bound(sq, skv):
    q, k, v = _qkv(1, 1, sq, skv, 512, seed=sq + skv)
    out = _tensor_core_arithmetic(q, k, v, halves=2)
    assert _within(out, q, k, v, "tensor_core_wide")
    assert not _within(out, q, k, v, "cuda_core")


@pytest.mark.parametrize("sq", [48, 200])
@pytest.mark.parametrize("skv", [48, 77, 100])
def test_wide_scale_one_percent_high_breaks_the_bound(sq, skv):
    q, k, v = _qkv(1, 1, sq, skv, 512, seed=sq + skv)
    out = _tensor_core_arithmetic(q, k, v, scale_factor=1.01, halves=2)
    assert not _within(out, q, k, v, "tensor_core_wide")


def test_wide_route_is_held_to_the_tensor_core_bound():
    q, k, v = _qkv(2, 1, 64, 77, 512, seed=2)
    assert torch.equal(flash.error_bound(q, k, v, "tensor_core_wide"),
                       flash.error_bound(q, k, v, "tensor_core"))


def test_cuda_core_bound_is_one_bf16_rounding():
    q, k, v = _qkv(1, 2, 64, 77, 40, seed=1)
    ref = flash.flash_attention_reference(q.float(), k.float(), v.float())
    torch.testing.assert_close(flash.error_bound(q, k, v, "cuda_core"),
                               1e-4 + 2.0 ** -8 * ref.abs())
    tc = flash.error_bound(q, k, v, "tensor_core")
    assert bool((tc > flash.error_bound(q, k, v, "cuda_core")).all())
    f32 = flash.error_bound(q.float(), k.float(), v.float(), "cuda_core")
    torch.testing.assert_close(f32, 2e-5 + 2e-5 * ref.abs())
    with pytest.raises(ValueError, match="unknown route"):
        flash.error_bound(q, k, v, "wgmma")


def test_reset_launches_zeroes_every_count():
    flash.flash_attention.launches_by_route["tensor_core"] = 3
    flash.flash_attention.launches = 3
    flash.reset_launches()
    assert flash.flash_attention.launches == 0
    assert flash.flash_attention.launches_by_route == {
        "tensor_core_wgmma": 0, "tensor_core": 0, "tensor_core_wide": 0,
        "cuda_core": 0}
