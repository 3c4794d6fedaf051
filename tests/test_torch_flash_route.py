"""The rule between the six attention kernels (`route`) and the error
bound their outputs are held to (`error_bound`), on the CPU.

The tensor-core kernels (csrc/flash_attn_wgmma.cu for D = 40, 80 and 160
at any lengths, csrc/flash_attn_wgmma_short.cu for those head dims at up
to 128 keys, csrc/flash_attn_wgmma_wide.cu and csrc/flash_attn_tc_wide.cu
for D = 512, and csrc/flash_attn_tc.cu) round the probabilities P to
bf16 before P V;
`_tensor_core_arithmetic` repeats their arithmetic in plain torch
(64-key tiles; 128 for the wgmma kernel at D = 40 and 80, 64 at
D = 160; one tile of 16, 32, 64, 80 or 128 keys for the short one;
keys padded with zeros to whole
tiles and masked; online softmax in the log2 domain, P rounded to bf16,
l summed from the unrounded P; for the mma.sync wide kernel each tile's
keys in two halves that share the row max and sum l apart; for the wgmma
wide one 64-key tiles, O's columns in two halves that each compute all
of S, m and l) so that the bound can be held against it here. The kernels themselves are checked on
the card (tests/test_torch_cuda.py, chip_smoke.py,
tools/flash_mutants.py)."""
from __future__ import annotations

import importlib.util
import json
import math
import pathlib
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from arbius_tpu_torch.models import common
from arbius_tpu_torch.models.kandinsky2 import movq
from arbius_tpu_torch.models.sd15 import vae
from arbius_tpu_torch.ops import flash
from arbius_tpu_torch.templates import load_template_bytes

UNET_SHAPES = [s[:5] for s in chip_smoke.MAIN_PATH_SHAPES if s[4] <= 160]


def _contiguous(b, h, s, d):
    return (h * s * d, s * d, d)


def _route_contiguous(dtype, b, h, sq, skv, d, pointer=256):
    strides = _contiguous(b, h, sq, d) + 2 * _contiguous(b, h, skv, d)
    return flash.route(dtype, d, strides, [pointer] * 3, sq, skv)


def test_unet_shapes_take_the_tensor_cores_and_the_vae_does_not():
    """The UNet's self-attentions over more than 128 keys (D = 40 at
    S = 4096, D = 80 at S = 1024, D = 160 at S = 256) take the
    tensor_core_wgmma route, its shapes with at most 128 keys (the
    cross-attentions, 64^2 at D = 160) tensor_core_wgmma_short; the
    VAE's D = 512 takes tensor_core_wgmma_wide."""
    assert len(UNET_SHAPES) == 8
    for shape in UNET_SHAPES:
        want = ("tensor_core_wgmma_short" if shape[3] <= 128
                else "tensor_core_wgmma")
        assert _route_contiguous(torch.bfloat16, *shape) == want, shape
    vae_shapes = [s[:5] for s in chip_smoke.MAIN_PATH_SHAPES if s[4] > 160]
    assert vae_shapes == [(4, 1, 4096, 4096, 512)]
    assert _route_contiguous(torch.bfloat16, *vae_shapes[0]) == (
        "tensor_core_wgmma_wide")


def test_chip_smoke_expects_each_main_path_launch_on_its_route():
    assert chip_smoke.expected_launches(torch, flash) == {
        "tensor_core_wgmma": 300, "tensor_core_wgmma_short": 340,
        "tensor_core_wgmma_wide": 1, "tensor_core": 0,
        "tensor_core_wide": 0, "cuda_core": 0}


def test_main_path_shapes_are_the_512_bucket():
    assert chip_smoke.MAIN_PATH_SHAPES == (
        (8, 8, 4096, 4096, 40, 100), (8, 8, 4096, 77, 40, 100),
        (8, 8, 1024, 1024, 80, 100), (8, 8, 1024, 77, 80, 100),
        (8, 8, 256, 256, 160, 100), (8, 8, 256, 77, 160, 100),
        (8, 8, 64, 64, 160, 20), (8, 8, 64, 77, 160, 20),
        (4, 1, 4096, 4096, 512, 1))
    assert chip_smoke.LAUNCHES_PER_CHUNK == 641


# the square buckets and the two largest, whose lengths at the UNet's
# four levels (S = W*H/64 / 4^level) are multiples of 128 or not (1600
# at 640x640, 3136 at 896x896)
_BUCKET_SIZES = sorted([(128, 128), (256, 256), (512, 512), (640, 640),
                        (768, 768), (896, 896), (1024, 768), (768, 1024)])


@pytest.mark.parametrize("size", _BUCKET_SIZES)
def test_rule_at_every_bucket(size):
    """At each bucket the calls with at most 128 keys (the
    cross-attentions, 77 keys, among them) take tensor_core_wgmma_short
    and the other UNet calls, at any length, tensor_core_wgmma, so none
    takes tensor_core; the VAE takes tensor_core_wgmma_wide."""
    shapes = chip_smoke.attention_shapes(*size)
    want = dict.fromkeys(flash.SOURCES, 0)
    want["tensor_core_wgmma_wide"] = 1
    for b, h, sq, skv, d, count in shapes:
        got = _route_contiguous(torch.bfloat16, b, h, sq, skv, d)
        if d == 512:
            assert got == "tensor_core_wgmma_wide"
            continue
        assert got == ("tensor_core_wgmma_short" if skv <= 128
                       else "tensor_core_wgmma"), (size, sq, skv, d)
        want[got] += count
    assert chip_smoke.expected_launches(torch, flash, shapes) == want
    assert want["tensor_core"] == want["cuda_core"] == 0
    assert want["tensor_core_wide"] == 0


_SIDES = next(row["choices"] for row in json.loads(
    load_template_bytes("anythingv3"))["input"] if row["variable"] == "width")


@pytest.mark.parametrize("height", _SIDES)
@pytest.mark.parametrize("width", _SIDES)
def test_no_template_bucket_takes_mma_sync_or_the_cuda_cores(width, height):
    """Every (width, height) the anythingv3 template allows: each of a
    chunk's attention calls takes a wgmma route."""
    launches = chip_smoke.expected_launches(
        torch, flash, chip_smoke.attention_shapes(width, height))
    assert launches["tensor_core"] == launches["cuda_core"] == 0
    assert launches["tensor_core_wide"] == 0
    assert launches["tensor_core_wgmma_wide"] == 1
    assert sum(launches.values()) == chip_smoke.LAUNCHES_PER_CHUNK


def test_768_bucket_shapes():
    assert chip_smoke.BUCKET_768_SHAPES == chip_smoke.attention_shapes(
        768, 768)
    assert chip_smoke.expected_launches(
        torch, flash, chip_smoke.BUCKET_768_SHAPES) == {
        "tensor_core_wgmma": 320, "tensor_core_wgmma_short": 320,
        "tensor_core_wgmma_wide": 1, "tensor_core": 0,
        "tensor_core_wide": 0, "cuda_core": 0}


def test_640_bucket_ragged_shapes():
    """The 640x640 shapes phase 2 checks beside the 512x512 and 768x768
    buckets: its calls that neither of those has a route for at that
    length (1600^2 at D = 80, 400^2 and 100^2 at D = 160) and their
    cross-attentions."""
    assert chip_smoke.BUCKET_640_RAGGED_SHAPES == tuple(
        s for s in chip_smoke.attention_shapes(640, 640) if 40 < s[4] < 512)
    assert [s[2:5] for s in chip_smoke.BUCKET_640_RAGGED_SHAPES] == [
        (1600, 1600, 80), (1600, 77, 80), (400, 400, 160), (400, 77, 160),
        (100, 100, 160), (100, 77, 160)]
    assert [_route_contiguous(torch.bfloat16, *s[:5])
            for s in chip_smoke.BUCKET_640_RAGGED_SHAPES] == [
        "tensor_core_wgmma", "tensor_core_wgmma_short",
        "tensor_core_wgmma", "tensor_core_wgmma_short",
        "tensor_core_wgmma_short", "tensor_core_wgmma_short"]


@pytest.mark.parametrize("case", [
    "ok", "d48", "d160", "sq_ragged", "skv_77", "float32", "s_stride",
    "pointer"])
def test_rule_for_the_wgmma_route(case):
    """bf16, D in {40, 80, 160} and the tensor-core stride and alignment
    conditions, at any lengths; up to 128 keys the short wgmma route
    comes first. Another head dim goes to mma.sync, and what fails the
    last two to the CUDA cores; the mma.sync route can still be forced
    onto a wgmma call, and the wgmma route onto a short one."""
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
    wgmma = "tensor_core_wgmma"
    want = {"ok": [wgmma, "tensor_core", "cuda_core"],
            "d48": ["tensor_core", "cuda_core"],
            "d160": [wgmma, "tensor_core", "cuda_core"],
            "sq_ragged": [wgmma, "tensor_core", "cuda_core"],
            "skv_77": ["tensor_core_wgmma_short", wgmma, "tensor_core",
                       "cuda_core"],
            "float32": ["cuda_core"], "s_stride": ["cuda_core"],
            "pointer": ["cuda_core"]}[case]
    assert got == want
    assert flash.route(dtype, d, strides, [256, pointer, 256], sq,
                       skv) == want[0]


@pytest.mark.parametrize("tokens", [16, 200])
@pytest.mark.parametrize("d", [40, 80, 160])
def test_models_strided_views_take_the_tensor_cores(monkeypatch, d, tokens):
    """The UNet's Attention hands [B, S, H, D] views transposed to
    [B, H, S, D]: self- and cross-attention both pass the rule, the
    cross-attention (77 keys) and a short self-attention to the short
    wgmma route, a longer one (200 tokens) to the wgmma route."""
    seen = []

    def spy(q, k, v):
        seen.append((flash.route_of(q, k, v), q.is_contiguous()))
        return flash.flash_attention_reference(q, k, v)

    monkeypatch.setattr(common, "fused_attention", spy)
    torch.manual_seed(0)
    attn_self = common.Attention(8 * d, 8, d, torch.bfloat16)
    attn_cross = common.Attention(8 * d, 8, d, torch.bfloat16,
                                  context_dim=96)
    x = torch.randn(2, tokens, 8 * d).bfloat16()
    with torch.no_grad():
        attn_self(x)
        attn_cross(x, torch.randn(2, 77, 96).bfloat16())
    self_route = ("tensor_core_wgmma_short" if tokens <= 128
                  else "tensor_core_wgmma")
    assert seen == [(self_route, False),
                    ("tensor_core_wgmma_short", False)]


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
    assert seen == ["tensor_core_wgmma_wide"]


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
    want = "tensor_core_wgmma_wide" if case == "bfloat16" else "cuda_core"
    assert flash.route(dtype, d, strides, [256, pointer, 256], 64,
                       64) == want


def test_route_of_reads_real_tensors():
    x = torch.zeros(2 * 8 * 64 * 40 + 1, dtype=torch.bfloat16)
    q = x[:-1].view(2, 8, 64, 40)
    assert flash.route_of(q, q, q) == "tensor_core_wgmma_short"
    y = torch.zeros(1 * 128 * 8 * 80 + 8, dtype=torch.bfloat16)
    w = y[:-8].view(1, 128, 8, 80).transpose(1, 2)   # the models' view
    assert flash.route_of(w, w, w) == "tensor_core_wgmma_short"
    assert flash.routes_of(w, w, w) == [
        "tensor_core_wgmma_short", "tensor_core_wgmma", "tensor_core",
        "cuda_core"]
    short = w[:, :, :77]
    assert flash.route_of(w, short, short) == "tensor_core_wgmma_short"
    assert flash.route_of(w[:, :, :100], w, w) == "tensor_core_wgmma_short"
    z = torch.zeros(1 * 200 * 8 * 160, dtype=torch.bfloat16)
    r = z.view(1, 200, 8, 160).transpose(1, 2)
    assert flash.route_of(r, r, r) == "tensor_core_wgmma"
    assert flash.route_of(r[:, :, :64], r[:, :, :129], r[:, :, :129]) == (
        "tensor_core_wgmma")
    assert flash.route_of(w, w, y[1:-7].view(1, 128, 8, 80)
                          .transpose(1, 2)) == "cuda_core"
    off = x[1:].view(2, 8, 64, 40)   # data pointer 2 bytes off
    assert flash.route_of(q, off, q) == "cuda_core"
    assert flash.route_of(q.float(), q.float(), q.float()) == "cuda_core"
    y = torch.zeros(1 * 64 * 512 + 1, dtype=torch.bfloat16)
    w = y[:-1].view(1, 1, 64, 512)
    assert flash.route_of(w, w, w) == "tensor_core_wgmma_wide"
    assert flash.routes_of(w, w, w) == [
        "tensor_core_wgmma_wide", "tensor_core_wide", "cuda_core"]
    assert flash.route_of(w, w, y[1:].view(1, 1, 64, 512)) == "cuda_core"


def _qkv(b, h, sq, skv, d, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, h, s, d))
                             .astype(np.float32)).bfloat16()
            for s in (sq, skv, skv)]


def _tensor_core_arithmetic(q, k, v, scale_factor=1.0, tile=64,
                            halves=1, mask_pad=True):
    """The tensor-core kernels' arithmetic in plain torch: bf16 inputs,
    float32 scores, online softmax over key tiles of `tile` keys (the
    keys padded with zeros to whole tiles, as TMA's out-of-bounds fill
    reads them, and the pad masked to -inf; `mask_pad=False` leaves the
    zeros' scores of 0 in, the fault the mask keeps out) with
    exp2(s * scale * log2(e) - m * scale * log2(e)), P rounded to bf16
    for P V, l summed from the unrounded P, output rounded to bf16. With
    a tile of at least S_kv (the short wgmma kernel) there is one tile,
    so no rescale. With `halves=2` (the wide kernel) each tile's keys
    are split in two halves that share the row max; each half sums its
    own l, and the halves' sums are added once, at the end."""
    sl2 = scale_factor / math.sqrt(q.shape[-1]) * math.log2(math.e)
    skv = k.shape[2]
    pad = -skv % tile
    qf = q.float()
    kf, vf = (torch.nn.functional.pad(t.float(), (0, 0, 0, pad))
              for t in (k, v))
    part = tile // halves
    m = torch.full(q.shape[:3], -math.inf)
    l = torch.zeros((halves, *q.shape[:3]))
    o = torch.zeros((*q.shape[:3], v.shape[-1]))
    for kv0 in range(0, kf.shape[2], tile):
        s = qf @ kf[:, :, kv0:kv0 + tile].transpose(-1, -2)
        if mask_pad:
            s[..., max(0, skv - kv0):] = -math.inf
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


def _short_tile(skv):
    """The short wgmma kernel's one key tile: S_kv rounded up to a width
    it has a product for."""
    return next(n for n in (16, 32, 64, 80, 128) if skv <= n)


@pytest.mark.parametrize("d", [40, 80, 160])
@pytest.mark.parametrize("skv", [4, 16, 64, 77, 100, 128])
def test_short_wgmma_arithmetic_lies_within_its_bound(d, skv):
    """The short wgmma kernel's arithmetic: one key tile of N = S_kv
    rounded up to 16, 32, 64, 80 or 128 (77 keys: 80), the tail masked;
    held to the tensor-core bound."""
    q, k, v = _qkv(2, 2, 96, skv, d, seed=d + skv)
    out = _tensor_core_arithmetic(q, k, v, tile=_short_tile(skv))
    assert _within(out, q, k, v, "tensor_core_wgmma_short")
    torch.testing.assert_close(
        flash.error_bound(q, k, v, "tensor_core_wgmma_short"),
        flash.error_bound(q, k, v, "tensor_core"), rtol=0, atol=0)


@pytest.mark.parametrize("fault", ["scale_1pct_high", "drops_last_key",
                                   "unmasked_pad"])
@pytest.mark.parametrize("d", [40, 80, 160])
@pytest.mark.parametrize("skv", [77, 100])
def test_short_wgmma_faults_break_the_bound(d, skv, fault):
    """tools/flash_mutants.py's two faults, and the mask of the zero
    keys TMA pads the tile with left out."""
    q, k, v = _qkv(2, 2, 96, skv, d, seed=d + skv)
    tile = _short_tile(skv)
    if fault == "scale_1pct_high":
        out = _tensor_core_arithmetic(q, k, v, scale_factor=1.01, tile=tile)
    elif fault == "drops_last_key":
        out = _tensor_core_arithmetic(q, k[:, :, :-1], v[:, :, :-1],
                                      tile=tile)
    else:
        out = _tensor_core_arithmetic(q, k, v, tile=tile, mask_pad=False)
    assert not _within(out, q, k, v, "tensor_core_wgmma_short")


# (D, S_kv) -> the wgmma kernels' key tile: 64 keys at D = 160 and 512
# (the wide kernel), 128 at D = 40 and 80; S_kv not a multiple of it, so
# the last tile is ragged. The fault cases leave out one key alone, whose
# softmax is 1 at any scale.
_RAGGED = [(40, 200), (80, 333), (160, 100), (160, 200), (160, 333)]
_RAGGED_WIDE = [(512, 48), (512, 77), (512, 100), (512, 130)]


def _wgmma_tile_and_route(d):
    if d == 512:
        return 64, "tensor_core_wgmma_wide"
    return 64 if d == 160 else 128, "tensor_core_wgmma"


@pytest.mark.parametrize("d,skv", _RAGGED + [(512, 1)] + _RAGGED_WIDE)
@pytest.mark.parametrize("sq", [100, 144])
def test_ragged_wgmma_arithmetic_lies_within_its_bound(d, skv, sq):
    """The wgmma kernels' arithmetic at ragged lengths: key tiles of 128
    (64 at D = 160 and 512), the last one masked past S_kv, the last
    query tile past Sq; held to the tensor-core bound."""
    q, k, v = _qkv(2, 2, sq, skv, d, seed=d + skv + sq)
    tile, route = _wgmma_tile_and_route(d)
    out = _tensor_core_arithmetic(q, k, v, tile=tile)
    assert _within(out, q, k, v, route)
    torch.testing.assert_close(
        flash.error_bound(q, k, v, route),
        flash.error_bound(q, k, v, "tensor_core"), rtol=0, atol=0)


@pytest.mark.parametrize("fault", ["scale_1pct_high", "drops_last_key",
                                   "unmasked_pad"])
@pytest.mark.parametrize("d,skv", _RAGGED + _RAGGED_WIDE)
def test_ragged_wgmma_faults_break_the_bound(d, skv, fault):
    """tools/flash_mutants.py's two faults, and the mask of the zero
    keys TMA pads the last tile with left out."""
    q, k, v = _qkv(2, 2, 100, skv, d, seed=d + skv)
    tile, route = _wgmma_tile_and_route(d)
    if fault == "scale_1pct_high":
        out = _tensor_core_arithmetic(q, k, v, scale_factor=1.01, tile=tile)
    elif fault == "drops_last_key":
        out = _tensor_core_arithmetic(q, k[:, :, :-1], v[:, :, :-1],
                                      tile=tile)
    else:
        out = _tensor_core_arithmetic(q, k, v, tile=tile, mask_pad=False)
    assert not _within(out, q, k, v, route)


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


def _wgmma_wide_arithmetic(q, k, v, **kw):
    """The wgmma wide kernel's order: 64-key tiles; O's 512 columns in two
    halves of 256, one per consumer warpgroup, each computing all of S,
    its own m and l over every key of a tile, and P V for its columns."""
    half = v.shape[-1] // 2
    return torch.cat([_tensor_core_arithmetic(q, k, v[..., :half], **kw),
                      _tensor_core_arithmetic(q, k, v[..., half:], **kw)],
                     dim=-1)


def test_wgmma_wide_halves_compute_what_one_pass_does():
    """Each column half repeats all of S, m and l: its output equals the
    columns of one pass over all 512 (the split costs products, not
    bits), so the ragged wgmma tests hold the one pass at D = 512 to the
    bound and to the faults."""
    q, k, v = _qkv(2, 1, 100, 130, 512, seed=3)
    torch.testing.assert_close(_wgmma_wide_arithmetic(q, k, v),
                               _tensor_core_arithmetic(q, k, v),
                               rtol=0, atol=0)


@pytest.mark.parametrize("height", _SIDES)
@pytest.mark.parametrize("width", _SIDES)
def test_rule_sends_every_vae_bucket_to_the_wgmma_wide_route(width,
                                                             height):
    """The VAE's call at each (width, height) the template allows, in
    its [B, 1, S, 512] views: the wgmma wide route first, the mma.sync
    wide one forcible beside it, the CUDA cores last."""
    [(b, h, sq, skv, d, count)] = [
        s for s in chip_smoke.attention_shapes(width, height) if s[4] == 512]
    assert (b, h, d, count) == (4, 1, 512, 1)
    assert sq == skv == (width // 8) * (height // 8)
    strides = list(_contiguous(b, h, sq, d)) * 3
    assert flash.routes(torch.bfloat16, d, strides, [256] * 3, sq, skv) == [
        "tensor_core_wgmma_wide", "tensor_core_wide", "cuda_core"]
    for dtype, ptr, stride in ((torch.float32, 256, d),
                               (torch.bfloat16, 258, d),
                               (torch.bfloat16, 256, d + 4)):
        odd = list(strides)
        odd[2] = stride
        assert flash.route(dtype, d, odd, [256, ptr, 256], sq,
                           skv) == "cuda_core"


_K2_SIDES = next(row["choices"] for row in json.loads(
    load_template_bytes("kandinsky2"))["input"] if row["variable"] == "width")


@pytest.mark.parametrize("height", _K2_SIDES)
@pytest.mark.parametrize("width", _K2_SIDES)
def test_movq_call_at_every_kandinsky2_bucket_takes_the_wgmma_wide_route(
        width, height):
    """kandinsky2's one flash call per chunk, MoVQ's mid attention, at
    each (width, height) its template allows (S = 9216 to 16384), in its
    [B, 1, S, 512] views: the wgmma wide route first, once per chunk, and
    no launch on any other route."""
    [(b, h, sq, skv, d, count)] = chip_smoke.movq_attention_shapes(width,
                                                                   height)
    assert (b, h, d, count) == (4, 1, 512, 1)
    assert sq == skv == (width // 8) * (height // 8)
    strides = [st for s in (sq, skv, skv) for st in (s * h * d, d, h * d)]
    assert flash.routes(torch.bfloat16, d, strides, [256] * 3, sq, skv) == [
        "tensor_core_wgmma_wide", "tensor_core_wide", "cuda_core"]
    launches = chip_smoke.expected_launches(
        torch, flash, chip_smoke.movq_attention_shapes(width, height))
    assert launches == {**dict.fromkeys(flash.SOURCES, 0),
                        "tensor_core_wgmma_wide": 1}


def test_movq_strided_views_take_the_wide_tensor_cores(monkeypatch):
    """The full-width MoVQ decoder (D = 512) hands its mid attention over
    as [B, 1, S, D] views that take the wgmma wide route, once per
    decode; none of its other layers calls the kernels."""
    seen = []

    def spy(q, k, v):
        seen.append(flash.route_of(q, k, v))
        return flash.flash_attention_reference(q, k, v)

    monkeypatch.setattr(common, "fused_attention", spy)
    torch.manual_seed(0)
    dec = movq.MOVQDecoder(movq.MOVQConfig())
    with torch.no_grad():
        out = dec(torch.randn(2, 2, 3, 4))
    assert out.shape == (2, 16, 24, 3)
    assert seen == ["tensor_core_wgmma_wide"]


def test_kandinsky2_generate_calls_the_kernels_once_per_chunk(monkeypatch):
    """A whole kandinsky2 solve (the tiny config) reaches ops/flash once,
    for MoVQ: the text tower's and the prior's attentions take masks and
    the decoder's added-KV attention is a matmul, as in the reference."""
    from arbius_tpu_torch.models.kandinsky2 import (
        Kandinsky2Config,
        Kandinsky2Pipeline,
    )
    from arbius_tpu_torch.node.factory import tiny_byte_tokenizer

    calls = []

    def spy(q, k, v):
        calls.append(tuple(q.shape))
        return flash.flash_attention_reference(q, k, v)

    monkeypatch.setattr(common, "fused_attention", spy)
    cfg = Kandinsky2Config.tiny()
    pipe = Kandinsky2Pipeline(cfg, tokenizer=tiny_byte_tokenizer(cfg.text),
                              device="cpu")
    pipe.load_params(pipe.init_params(0))
    pipe.generate(["a", "b"], None, [1, 2], width=64, height=64,
                  num_inference_steps=2)
    assert calls == [(2, 1, 64, 8)]


def test_device_trace_summary_counts_kernels_busy_and_idle_time():
    """chip_smoke's reading of a torch.profiler trace: kernels counted,
    busy time the union of device intervals (kernels and copies), the
    span first start to last end, and kernel names by summed time."""
    ev = [("kernel", "gemm", 0, 10), ("kernel", "norm", 5, 10),
          ("gpu_memcpy", "copy", 30, 5), ("kernel", "gemm", 40, 5),
          ("cuda_runtime", "cudaLaunchKernel", 0, 50)]
    got = chip_smoke.device_trace_summary({"traceEvents": [
        {"ph": "X", "cat": c, "name": n, "ts": t, "dur": d}
        for c, n, t, d in ev]})
    assert got == {"kernels": 3, "busy_ms": 0.025, "span_ms": 0.045,
                   "idle_share": 1 - 25 / 45,
                   "top": [["gemm", 0.015, 2], ["norm", 0.01, 1]]}


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


@pytest.mark.parametrize("route", sorted(flash.SOURCES))
def test_card_tools_edits_match_their_sources_once(route):
    """tools/flash_mutants.py's faults and tools/flash_ablate.py's
    ablations are text edits of a kernel's source; each must still find
    its text exactly once there, or the tool would refuse to build."""
    from arbius_tpu_torch.ops import _build

    tools = pathlib.Path(__file__).resolve().parent.parent / "tools"
    for name in ("flash_mutants", "flash_ablate"):   # ablate imports mutants
        if name not in sys.modules:
            spec = importlib.util.spec_from_file_location(
                name, tools / f"{name}.py")
            sys.modules[name] = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(sys.modules[name])
    flash_mutants, flash_ablate = (sys.modules[n] for n in
                                   ("flash_mutants", "flash_ablate"))

    text = (_build.CSRC / flash.SOURCES[route]).read_text()
    edits = [e for e in flash_mutants.MUTANTS[route].values() if e]
    for pairs in flash_ablate.ABLATIONS.get(route, {}).values():
        edits += pairs
    assert edits
    for old, _ in edits:
        assert text.count(old) == 1, old


def test_reset_launches_zeroes_every_count():
    flash.flash_attention.launches_by_route["tensor_core"] = 3
    flash.flash_attention.launches = 3
    flash.reset_launches()
    assert flash.flash_attention.launches == 0
    assert flash.flash_attention.launches_by_route == {
        "tensor_core_wgmma": 0, "tensor_core_wgmma_short": 0,
        "tensor_core_wgmma_wide": 0, "tensor_core": 0,
        "tensor_core_wide": 0, "cuda_core": 0}


def _timed_line(route, shape, main, ms, host, calls=100):
    return {"route": route, "shape": list(shape), "main_path": main,
            "ms": ms, "host_us": host, "host_mean_us": 2 * host,
            "plain_ms": 1.0, "library_ms": 0.5, "launches_per_batch": calls,
            "max_abs_err": 1e-3, "err_over_bound": 0.5, "operations": 0.1,
            "bytes": 0.2, "exponentials": 0.05}


def test_per_route_sums_each_route_and_the_routes_forced_onto_its_calls():
    """chip_smoke's per-batch summary: a route's own calls summed, and
    each other route timed at all of its shapes summed over the same
    calls (median and mean host time in ms); a route the bucket does not
    launch is summed over every shape it was timed at."""
    a, b = (8, 8, 4096, 77, 40), (8, 8, 1024, 1024, 80)
    lines = [_timed_line("tensor_core_wgmma_short", a, True, 0.03, 30.0),
             _timed_line("tensor_core_wgmma", a, False, 0.05, 40.0),
             _timed_line("tensor_core", a, False, 0.07, 50.0),
             _timed_line("tensor_core_wgmma", b, True, 0.09, 20.0),
             _timed_line("tensor_core", b, False, 0.14, 10.0),
             {"route": "tensor_core_wgmma", "shape": list(b),
              "main_path": True, "max_abs_err": 2e-3,
              "err_over_bound": 0.25}]   # float32: checked, not timed
    out = chip_smoke.per_route(lines)
    short, wgmma, tc = (out[r] for r in ("tensor_core_wgmma_short",
                                         "tensor_core_wgmma", "tensor_core"))
    assert short["launches_per_batch"] == wgmma["launches_per_batch"] == 100
    assert tc["launches_per_batch"] == 0
    assert short["ms"] == pytest.approx(3.0)
    assert (short["host_ms"], short["host_mean_ms"]) == pytest.approx(
        (3.0, 6.0))
    assert short["forced"] == {
        "tensor_core_wgmma": pytest.approx(
            {"ms": 5.0, "host_ms": 4.0, "host_mean_ms": 8.0}),
        "tensor_core": pytest.approx(
            {"ms": 7.0, "host_ms": 5.0, "host_mean_ms": 10.0})}
    assert wgmma["forced"] == {"tensor_core": pytest.approx(
        {"ms": 14.0, "host_ms": 1.0, "host_mean_ms": 2.0})}
    assert wgmma["cases"] == 3 and wgmma["max_abs_err"] == 2e-3
    assert tc["ms"] == pytest.approx(21.0) and tc["forced"] == {}
    assert set(out) == {"tensor_core_wgmma_short", "tensor_core_wgmma",
                        "tensor_core"}


def test_kernel_entries_list_every_route_with_the_contracts_keys():
    """chip_smoke's `kernels` line from phase 2's summaries: one entry per
    route with the keys the line must carry, launches from each run,
    per-bucket times where a route was timed there."""
    buckets = {}
    for bucket, shapes in chip_smoke.kernel_buckets():
        lines = []
        for b, h, sq, skv, d, calls in shapes:
            routes = flash.routes(torch.bfloat16, d, [8] * 9, [256] * 3, sq,
                                  skv)
            lines += [_timed_line(r, (b, h, sq, skv, d), r == routes[0],
                                  0.1, 20.0, calls) for r in routes]
        buckets[bucket] = chip_smoke.per_route(lines)
    counts = chip_smoke.expected_launches(torch, flash)
    entries = chip_smoke.kernel_entries(flash, buckets, {
        "launches": counts, "launches_node": counts,
        "launches_node_run": counts})
    assert [e["source"].rsplit("/", 1)[1] for e in entries] == list(
        flash.SOURCES.values())
    for e in entries:
        assert {"name", "route", "source", "replaces", "launches",
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms"} <= set(e)
        assert e["route"] == "cuda"
        assert e["replaces"] == "arbius_tpu/ops/flash.py:34"
    wide = next(e for e in entries
                if e["name"] == "flash_attention_wgmma_wide")
    assert wide["launches"] == 1 and wide["launches_per_batch"] == 1
    for s in (256, 6400, 12288):
        got = wide[f"bucket_VAE S={s}"]
        assert got["launches_per_batch"] == 1
        assert set(got["forced"]) == {"tensor_core_wide", "cuda_core"}
    old = next(e for e in entries if e["name"] == "flash_attention_tc_wide")
    assert old["launches"] == 0
