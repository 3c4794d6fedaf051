"""Robust Video Matting, the published `rvm_mobilenetv3` network, in
PyTorch.

Twin of arbius_tpu/models/rvm/model.py: a MobileNetV3-Large encoder
(torchvision's layout, last stage dilated so f4 sits at 1/16), the
LR-ASPP head, the recurrent decoder (ConvGRUs over half the channels at
four scales), the `project_mat`/`project_seg` heads and the
DeepGuidedFilter refiner of the downsample-then-refine path.

Differences of layout, not of math:
  - Maps are NCHW (cuDNN's layout); the reference is NHWC. The bridge
    turns its conv kernels [kH, kW, I/groups, O] into [O, I/groups, kH,
    kW], a depthwise [kH, kW, 1, C] into [C, 1, kH, kW].
  - `BNInf`'s parameters are `weight` (the reference's `scale`), `bias`,
    `mean` and `var`.
  - The convs are plain `nn.Conv2d`: every call is one frame (batch 1),
    so a frame's bits cannot depend on a neighbour.

Precisions are the reference's: convs in the compute dtype (bf16 by
default), BatchNorm's scale and shift, squeeze-excite, hard-swish, the
ConvGRU gates and state, the average pools, the heads and the refiner in
float32. Resizes are bilinear with half-pixel centres in float32; a
shrink antialiases (jax.image.resize's triangle kernel widened by the
scale), a growth does not (the kernel is then plain bilinear).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

# torchvision mobilenet_v3_large inverted-residual plan, dilated last
# stage: (in_ch, kernel, expanded_ch, out_ch, use_se, activation, stride,
# dilation)
MOBILENETV3_LARGE_ROWS: tuple[tuple, ...] = (
    (16, 3, 16, 16, False, "relu", 1, 1),
    (16, 3, 64, 24, False, "relu", 2, 1),
    (24, 3, 72, 24, False, "relu", 1, 1),
    (24, 5, 72, 40, True, "relu", 2, 1),
    (40, 5, 120, 40, True, "relu", 1, 1),
    (40, 5, 120, 40, True, "relu", 1, 1),
    (40, 3, 240, 80, False, "hardswish", 2, 1),
    (80, 3, 200, 80, False, "hardswish", 1, 1),
    (80, 3, 184, 80, False, "hardswish", 1, 1),
    (80, 3, 184, 80, False, "hardswish", 1, 1),
    (80, 3, 480, 112, True, "hardswish", 1, 1),
    (112, 3, 672, 112, True, "hardswish", 1, 1),
    (112, 5, 672, 160, True, "hardswish", 2, 2),
    (160, 5, 960, 160, True, "hardswish", 1, 2),
    (160, 5, 960, 160, True, "hardswish", 1, 2),
)

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def _make_divisible(v: float, divisor: int = 8) -> int:
    """torchvision's channel-rounding rule (SE squeeze widths)."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


@dataclass(frozen=True)
class RVMConfig:
    """Published rvm_mobilenetv3 by default; tiny() shrinks every stage
    and keeps the module structure."""
    ir_rows: tuple[tuple, ...] = MOBILENETV3_LARGE_ROWS
    stem_ch: int = 16
    last_ch: int = 960
    taps: tuple[int, int, int] = (1, 3, 6)
    aspp_ch: int = 128
    dec_ch: tuple[int, int, int] = (80, 40, 32)
    out_ch: int = 16
    dtype: str = "bfloat16"

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @classmethod
    def tiny(cls) -> "RVMConfig":
        return cls(
            ir_rows=(
                (8, 3, 8, 8, False, "relu", 1, 1),
                (8, 3, 16, 12, False, "relu", 2, 1),
                (12, 5, 36, 12, True, "relu", 2, 1),
                (12, 3, 24, 16, False, "hardswish", 2, 1),
            ),
            stem_ch=8, last_ch=24, taps=(1, 2, 3),
            aspp_ch=16, dec_ch=(16, 8, 8), out_ch=8)


def resize(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """jax.image.resize(method="bilinear") over an NCHW map's H, W in
    float32: antialiased where it shrinks, plain where it grows."""
    shrink = size[0] < x.shape[2] or size[1] < x.shape[3]
    return F.interpolate(x.float(), size=size, mode="bilinear",
                         align_corners=False, antialias=shrink)


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.hard_sigmoid: relu6(x + 3) / 6."""
    return F.relu6(x + 3.0) / 6.0


def hard_swish(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.hard_swish in float32, x * hard_sigmoid(x), rounded back to
    x's dtype (torch's hardswish multiplies before it divides)."""
    xf = x.float()
    return (xf * hard_sigmoid(xf)).to(x.dtype)


def _act(name: str | None, x: torch.Tensor) -> torch.Tensor:
    if name is None:
        return x
    if name == "relu":
        return F.relu(x)
    if name == "hardswish":
        return hard_swish(x)
    raise ValueError(f"unknown activation {name!r}")


class BNInf(nn.Module):
    """Inference-form BatchNorm2d: the running stats are parameters, the
    normalisation a float32 scale and shift, (x - mean) * (weight *
    rsqrt(var + eps)) + bias, rounded back to x's dtype. eps is the
    source module's: 1e-3 in the torchvision backbone, 1e-5 in RVM's own
    blocks."""

    def __init__(self, channels: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.mean = nn.Parameter(torch.zeros(channels, device=device))
        self.var = nn.Parameter(torch.ones(channels, device=device))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = (None, slice(None), None, None)
        mul = self.weight * torch.rsqrt(self.var + self.eps)
        return ((x.float() - self.mean[c]) * mul[c]
                + self.bias[c]).to(x.dtype)


def _conv(cin, cout, kernel, dtype, device, *, stride=1, dilation=1,
          groups=1, bias=True, pad=None) -> nn.Conv2d:
    pad = (kernel - 1) // 2 * dilation if pad is None else pad
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=pad,
                     dilation=dilation, groups=groups, bias=bias,
                     dtype=dtype, device=device)


class ConvBNAct(nn.Module):
    """torchvision Conv2dNormActivation: conv (no bias) + BN + act."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 dilation: int = 1, groups: int = 1,
                 activation: str | None = "relu", bn_eps: float = 1e-3,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.conv = _conv(cin, cout, kernel, dtype, device, stride=stride,
                          dilation=dilation, groups=groups, bias=False)
        self.bn = BNInf(cout, bn_eps, device)
        self.activation, self.dtype = activation, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _act(self.activation, self.bn(self.conv(x.to(self.dtype))))


class SqueezeExcite(nn.Module):
    """torchvision SqueezeExcitation in float32: pool, fc1, ReLU, fc2,
    hard sigmoid."""

    def __init__(self, channels: int, squeeze: int, device=None):
        super().__init__()
        self.fc1 = _conv(channels, squeeze, 1, torch.float32, device)
        self.fc2 = _conv(squeeze, channels, 1, torch.float32, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.float().mean(dim=(2, 3), keepdim=True)
        s = self.fc2(F.relu(self.fc1(s)))
        return (x.float() * hard_sigmoid(s)).to(x.dtype)


class InvertedResidual(nn.Module):
    """One MobileNetV3 block; submodules as torchvision has them for the
    row: `expand` (where exp != in), `depthwise`, `se`, `project`."""

    def __init__(self, row: tuple, dtype=torch.bfloat16, device=None):
        super().__init__()
        in_ch, kernel, exp, out, use_se, act, stride, dilation = row
        self.row = row
        # torchvision: dilation forces stride 1 (shape preserved)
        eff_stride = 1 if dilation > 1 else stride
        kw = dict(dtype=dtype, device=device)
        self.expand = (ConvBNAct(in_ch, exp, 1, activation=act, **kw)
                       if exp != in_ch else None)
        self.depthwise = ConvBNAct(exp, exp, kernel, stride=eff_stride,
                                   dilation=dilation, groups=exp,
                                   activation=act, **kw)
        self.se = (SqueezeExcite(exp, _make_divisible(exp // 4), device)
                   if use_se else None)
        self.project = ConvBNAct(exp, out, 1, activation=None, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        in_ch, _, _, out, _, _, stride, _ = self.row
        h = x if self.expand is None else self.expand(x)
        h = self.depthwise(h)
        if self.se is not None:
            h = self.se(h)
        h = self.project(h)
        if stride == 1 and in_ch == out:
            h = h + x
        return h


class MobileNetV3Encoder(nn.Module):
    """Normalise, stem, the inverted-residual blocks, the last 1x1;
    returns the four pyramid taps."""

    def __init__(self, cfg: RVMConfig, device=None):
        super().__init__()
        dt = cfg.tdtype
        self.cfg = cfg
        self.stem = ConvBNAct(3, cfg.stem_ch, 3, stride=2,
                              activation="hardswish", dtype=dt,
                              device=device)
        for i, row in enumerate(cfg.ir_rows):
            setattr(self, f"block_{i + 1}",
                    InvertedResidual(row, dt, device))
        self.lastconv = ConvBNAct(cfg.ir_rows[-1][3], cfg.last_ch, 1,
                                  activation="hardswish", dtype=dt,
                                  device=device)
        c = (1, 3, 1, 1)
        self.register_buffer("mean", torch.tensor(
            _IMAGENET_MEAN, device=device).view(c), persistent=False)
        self.register_buffer("std", torch.tensor(
            _IMAGENET_STD, device=device).view(c), persistent=False)

    def forward(self, x: torch.Tensor):
        cfg = self.cfg
        x = self.stem((x.float() - self.mean) / self.std)
        feats = {}
        for i in range(len(cfg.ir_rows)):
            x = getattr(self, f"block_{i + 1}")(x)
            feats[i + 1] = x
        x = self.lastconv(x)
        t1, t2, t3 = cfg.taps
        return feats[t1], feats[t2], feats[t3], x


class LRASPP(nn.Module):
    """1x1 + BN + ReLU, gated by global pool -> 1x1 -> sigmoid (float32)."""

    def __init__(self, cin: int, channels: int, dtype, device=None):
        super().__init__()
        self.aspp1_conv = _conv(cin, channels, 1, dtype, device, bias=False)
        self.aspp1_bn = BNInf(channels, device=device)
        self.aspp2_conv = _conv(cin, channels, 1, torch.float32, device,
                                bias=False)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = F.relu(self.aspp1_bn(self.aspp1_conv(x.to(self.dtype))))
        g = self.aspp2_conv(x.float().mean(dim=(2, 3), keepdim=True))
        return (a.float() * torch.sigmoid(g)).to(a.dtype)


class ConvGRU(nn.Module):
    """ih conv -> sigmoid -> (r, z); hh conv over [x, r h] -> tanh
    candidate; h' = (1 - z) h + z c. Convs in the compute dtype, gates
    and state in float32."""

    def __init__(self, channels: int, dtype, device=None):
        super().__init__()
        self.ih = _conv(2 * channels, 2 * channels, 3, dtype, device)
        self.hh = _conv(2 * channels, channels, 3, dtype, device)
        self.dtype = dtype

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        rz = self.ih(torch.cat([x.to(dt), h.to(dt)], dim=1))
        r, z = torch.sigmoid(rz.float()).chunk(2, dim=1)
        hf = h.float()
        c = self.hh(torch.cat([x.to(dt), (r * hf).to(dt)], dim=1))
        return (1.0 - z) * hf + z * torch.tanh(c.float())


class BottleneckBlock(nn.Module):
    """decode4: a ConvGRU over the second half of the channels."""

    def __init__(self, channels: int, dtype, device=None):
        super().__init__()
        self.gru = ConvGRU(channels // 2, dtype, device)

    def forward(self, x: torch.Tensor, r: torch.Tensor):
        a, b = x.chunk(2, dim=1)
        b = self.gru(b, r)
        return torch.cat([a, b.to(x.dtype)], dim=1), b


class UpsamplingBlock(nn.Module):
    """decode3/2/1: bilinear x2, crop to the skip, concat [x | skip |
    downsampled src], conv + BN + ReLU, a ConvGRU over the second half."""

    def __init__(self, cin: int, skip: int, channels: int, dtype,
                 device=None):
        super().__init__()
        self.conv = _conv(cin + skip + 3, channels, 3, dtype, device,
                          bias=False)
        self.bn = BNInf(channels, device=device)
        self.gru = ConvGRU(channels // 2, dtype, device)
        self.dtype = dtype

    def forward(self, x, f, s, r):
        dt = self.dtype
        h, w = x.shape[2:]
        x = resize(x, (2 * h, 2 * w)).to(dt)[:, :, :s.shape[2], :s.shape[3]]
        x = torch.cat([x, f.to(dt), s.to(dt)], dim=1)
        x = F.relu(self.bn(self.conv(x)))
        a, b = x.chunk(2, dim=1)
        b = self.gru(b, r)
        return torch.cat([a, b.to(x.dtype)], dim=1), b


class OutputBlock(nn.Module):
    """decode0: bilinear x2 to the source's size, concat src, two conv +
    BN + ReLU."""

    def __init__(self, cin: int, channels: int, dtype, device=None):
        super().__init__()
        self.conv_a = _conv(cin + 3, channels, 3, dtype, device, bias=False)
        self.bn_a = BNInf(channels, device=device)
        self.conv_b = _conv(channels, channels, 3, dtype, device, bias=False)
        self.bn_b = BNInf(channels, device=device)
        self.dtype = dtype

    def forward(self, x, s):
        dt = self.dtype
        h, w = x.shape[2:]
        x = resize(x, (2 * h, 2 * w)).to(dt)[:, :, :s.shape[2], :s.shape[3]]
        x = torch.cat([x, s.to(dt)], dim=1)
        x = F.relu(self.bn_a(self.conv_a(x)))
        return F.relu(self.bn_b(self.conv_b(x)))


def avgpool2(x: torch.Tensor) -> torch.Tensor:
    """AvgPool2d(2, 2) in float32 (the pipeline keeps every level even)."""
    b, c, h, w = x.shape
    return x.float().reshape(b, c, h // 2, 2, w // 2, 2).mean(dim=(3, 5))


class RecurrentDecoder(nn.Module):
    """The source pyramid by average pools, four recurrent stages coarse
    to fine; returns (hid at the source's size, new states r1..r4)."""

    def __init__(self, cfg: RVMConfig, device=None):
        super().__init__()
        dt = cfg.tdtype
        f1, f2, f3 = (cfg.ir_rows[t - 1][3] for t in cfg.taps)
        d3, d2, d1 = cfg.dec_ch
        self.decode4 = BottleneckBlock(cfg.aspp_ch, dt, device)
        self.decode3 = UpsamplingBlock(cfg.aspp_ch, f3, d3, dt, device)
        self.decode2 = UpsamplingBlock(d3, f2, d2, dt, device)
        self.decode1 = UpsamplingBlock(d2, f1, d1, dt, device)
        self.decode0 = OutputBlock(d1, cfg.out_ch, dt, device)

    def forward(self, s0, f1, f2, f3, f4, rec):
        r1, r2, r3, r4 = rec
        s0 = s0.float()
        s1 = avgpool2(s0)
        s2 = avgpool2(s1)
        s3 = avgpool2(s2)
        x4, r4 = self.decode4(f4, r4)
        x3, r3 = self.decode3(x4, f3, s3, r3)
        x2, r2 = self.decode2(x3, f2, s2, r2)
        x1, r1 = self.decode1(x2, f1, s1, r1)
        return self.decode0(x1, s0), (r1, r2, r3, r4)


class Projection(nn.Module):
    """1x1 conv head in float32 (project_mat / project_seg)."""

    def __init__(self, cin: int, channels: int, device=None):
        super().__init__()
        self.conv = _conv(cin, channels, 1, torch.float32, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x.float())


class DeepGuidedFilterRefiner(nn.Module):
    """Box-filter statistics of the base prediction against the base
    source (a learned grouped 3x3), a 1x1 head giving the affine A, and
    A x + b grown to the fine source's size; all float32."""

    def __init__(self, hid_channels: int = 16, device=None):
        super().__init__()
        f32 = torch.float32
        self.box_filter = _conv(4, 4, 3, f32, device, groups=4, bias=False)
        self.conv_a = _conv(4 * 2 + hid_channels, hid_channels, 1, f32,
                            device, bias=False)
        self.bn_a = BNInf(hid_channels, device=device)
        self.conv_b = _conv(hid_channels, hid_channels, 1, f32, device,
                            bias=False)
        self.bn_b = BNInf(hid_channels, device=device)
        self.conv_c = _conv(hid_channels, 4, 1, f32, device)

    def forward(self, fine_src, base_src, base_fgr, base_pha, base_hid):
        def with_mean(x):
            x = x.float()
            return torch.cat([x, x.mean(dim=1, keepdim=True)], dim=1)

        fine_x, base_x = with_mean(fine_src), with_mean(base_src)
        base_y = torch.cat([base_fgr, base_pha], dim=1).float()
        box = self.box_filter
        mean_x, mean_y = box(base_x), box(base_y)
        cov_xy = box(base_x * base_y) - mean_x * mean_y
        var_x = box(base_x * base_x) - mean_x * mean_x
        h = torch.cat([cov_xy, var_x, base_hid.float()], dim=1)
        h = F.relu(self.bn_a(self.conv_a(h)))
        h = F.relu(self.bn_b(self.conv_b(h)))
        a = self.conv_c(h)
        b = mean_y - a * mean_x
        size = fine_src.shape[2:]
        out = resize(a, size) * fine_x + resize(b, size)
        return out[:, :3], out[:, 3:]


class MattingStep(nn.Module):
    """One frame through the whole MattingNetwork.

    forward(src [B, 3, H, W] in [0, 1], rec, base_hw) -> (fgr [B, 3, H,
    W], pha [B, 1, H, W], new rec). `base_hw` is the downsampled working
    size; None runs the direct path (no refiner). `project_seg` holds the
    published segmentation head's weights and is not computed, as XLA
    drops it in the reference."""

    def __init__(self, config: RVMConfig, device=None):
        super().__init__()
        cfg = self.config = config
        self.backbone = MobileNetV3Encoder(cfg, device)
        self.aspp = LRASPP(cfg.last_ch, cfg.aspp_ch, cfg.tdtype, device)
        self.decoder = RecurrentDecoder(cfg, device)
        self.project_mat = Projection(cfg.out_ch, 4, device)
        self.project_seg = Projection(cfg.out_ch, 1, device)
        self.refiner = DeepGuidedFilterRefiner(cfg.out_ch, device)

    def forward(self, src: torch.Tensor, rec, base_hw=None):
        src_sm = src if base_hw is None else resize(src, base_hw)
        f1, f2, f3, f4 = self.backbone(src_sm)
        f4 = self.aspp(f4)
        hid, new_rec = self.decoder(src_sm, f1, f2, f3, f4, rec)
        out = self.project_mat(hid)
        fgr_res, pha = out[:, :3], out[:, 3:]
        if base_hw is not None:
            fgr_res, pha = self.refiner(src, src_sm, fgr_res, pha, hid)
        fgr = torch.clamp(fgr_res + src.float(), 0.0, 1.0)
        return fgr, torch.clamp(pha, 0.0, 1.0), new_rec

    def init_rec(self, batch: int, height: int, width: int,
                 device=None) -> tuple[torch.Tensor, ...]:
        """Zero GRU states for a working size of H x W: r1 at 1/2, r2 at
        1/4, r3 at 1/8, r4 at 1/16, each half its stage's channels."""
        cfg = self.config
        chans = (cfg.dec_ch[2] // 2, cfg.dec_ch[1] // 2, cfg.dec_ch[0] // 2,
                 cfg.aspp_ch // 2)
        return tuple(
            torch.zeros(batch, c, height >> s, width >> s,
                        dtype=torch.float32, device=device)
            for s, c in zip((1, 2, 3, 4), chans))
