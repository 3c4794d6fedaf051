"""UNet3D: the text-to-video denoiser (the zeroscopev2xl and damo
templates' model class, ModelScope's UNet3DConditionModel), in PyTorch.

Twin of arbius_tpu/models/video/unet3d.py, single-device:

  conv_in -> transformer_in (temporal, `tin_heads` heads) -> three
  cross-attention down levels + a plain one -> mid block -> mirrored up
  levels -> norm_out/conv_out. Every level's layer runs resnet ->
  TemporalConvLayer (four GroupNorm + SiLU + frame-axis conv stages, the
  last zero at init) -> SpatialTransformer (per frame) ->
  TemporalTransformer (per pixel over the frames: two self-attentions and
  a GEGLU feed-forward).

The public call takes the reference's channels-last [B, T, H, W, C]
latents and returns them so. Inside, a frame is an NCHW map and the
spatial modules (models/common.py) run over [B*T, C, H, W], frame-major
within each sample, as the reference's `_spatial` runs them over
[B*T, H, W, C]. The temporal modules see the 5D tensor:
TemporalConvLayer's GroupNorms and TemporalTransformer's `norm` normalise
each group over T*H*W (as the reference's 5D GroupNorm does), and the
temporal attention runs over [B*H*W, T, C], one sequence per site.

The temporal attention is plain torch with a float32 softmax (the
reference calls `sp_attention_reference`, an XLA einsum, not Pallas);
the spatial attentions go to ops/flash.py. Each 2D convolution runs one
sample's T frames (of one guidance half) per cuDNN call
(`samples_per_conv`), and each frame-axis convolution one sample per
call, so a task's bits do not depend on the tasks beside it.

The reference's frame-axis sequence parallelism (`sp_axis`: the UNet3D's
frames over the sp lanes, halo-exchanged temporal convolutions and ring
or Ulysses temporal attention) is not wired into the model yet; the
collectives and both attentions exist (parallel/collectives.py,
ops/ring.py, ops/ulysses.py). A config that asks for it is refused
(ROADMAP queue 1 item 11).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from arbius_tpu_torch.models.common import (
    GEGLU,
    Downsample,
    GroupNorm32,
    LayerNorm32,
    ResnetBlock,
    SpatialTransformer,
    TimestepEmbedding,
    Upsample,
    conv3x3,
    samples_per_conv,
    sinusoidal_embedding,
)
from arbius_tpu_torch.ops.flash import flash_attention_reference

@dataclass(frozen=True)
class UNet3DConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_channels: tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    attention_levels: tuple[bool, ...] = (True, True, True, False)
    head_dim: int = 64            # spatial and temporal heads: ch // head_dim
    tin_heads: int = 8            # transformer_in's head count
    context_dim: int = 1024
    transformer_depth: int = 1
    sp_axis: str | None = None    # frame sharding: not ported, refused
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.sp_axis is not None:
            raise ValueError(
                "frame-axis sequence parallelism (sp_axis) is not ported "
                "yet (ROADMAP queue 1 item 11)")

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @classmethod
    def tiny(cls) -> "UNet3DConfig":
        return cls(block_channels=(8, 8, 8, 8), layers_per_block=1,
                   head_dim=4, tin_heads=2, context_dim=16)


class TemporalConvLayer(nn.Module):
    """Four GroupNorm + SiLU + (3, 1, 1) frame-axis conv stages, the last
    conv zero at init, residual; x [B, C, T, H, W]. The conv pads one
    zero frame at each end, as the reference's 'SAME' padding does."""

    def __init__(self, channels: int, dtype, device=None):
        super().__init__()
        for name in ("conv1", "conv2", "conv3", "conv4"):
            setattr(self, f"{name}_norm", GroupNorm32(channels,
                                                      device=device))
            setattr(self, name, FrameConv(channels, dtype, device))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for name in ("conv1", "conv2", "conv3", "conv4"):
            h = F.silu(getattr(self, f"{name}_norm")(h)).to(self.dtype)
            h = getattr(self, name)(h)
        return x + h


class FrameConv(nn.Conv3d):
    """The frame-axis conv: kernel (3, 1, 1), one frame of zero padding,
    run one sample per call (as models/common.py's Conv2d is, and for the
    same reason)."""

    def __init__(self, channels: int, dtype, device=None):
        super().__init__(channels, channels, (3, 1, 1), padding=(1, 0, 0),
                         dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([super(FrameConv, self).forward(x[i:i + 1])
                          for i in range(x.shape[0])])


class TemporalSelfAttention(nn.Module):
    """Self-attention over the frame axis, tokens [N, T, C]: unbiased
    q/k/v projections to heads * head_dim, plain attention with a float32
    softmax, a biased output projection back to C."""

    def __init__(self, dim: int, num_heads: int, head_dim: int, dtype,
                 device=None):
        super().__init__()
        inner = num_heads * head_dim
        kw = dict(dtype=dtype, device=device)
        self.to_q = nn.Linear(dim, inner, bias=False, **kw)
        self.to_k = nn.Linear(dim, inner, bias=False, **kw)
        self.to_v = nn.Linear(dim, inner, bias=False, **kw)
        self.to_out = nn.Linear(inner, dim, **kw)
        self.num_heads, self.head_dim = num_heads, head_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, t, _ = x.shape

        def heads(a):
            return a.view(n, t, self.num_heads, self.head_dim).transpose(1, 2)

        out = flash_attention_reference(heads(self.to_q(x)),
                                        heads(self.to_k(x)),
                                        heads(self.to_v(x)))
        return self.to_out(out.transpose(1, 2).reshape(n, t, -1))


class TemporalTransformerBlock(nn.Module):
    """LN -> self-attention, LN -> a second self-attention, LN -> GEGLU
    feed-forward, all residual; tokens [N, T, dim]."""

    def __init__(self, dim: int, num_heads: int, head_dim: int, dtype,
                 device=None):
        super().__init__()
        for i in (1, 2, 3):
            setattr(self, f"norm{i}", LayerNorm32(dim, device=device))
        self.attn1 = TemporalSelfAttention(dim, num_heads, head_dim, dtype,
                                           device)
        self.attn2 = TemporalSelfAttention(dim, num_heads, head_dim, dtype,
                                           device)
        self.ff = GEGLU(dim, dim * 4, dtype, device=device)
        self.ff_out = nn.Linear(dim * 4, dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x).to(x.dtype))
        x = x + self.attn2(self.norm2(x).to(x.dtype))
        return x + self.ff_out(self.ff(self.norm3(x).to(x.dtype)))


class TemporalTransformer(nn.Module):
    """GroupNorm (eps 1e-6), linear proj_in to heads * head_dim, the
    blocks over each site's frames, linear proj_out (zero at init) back
    to the channels, residual; x [B, C, T, H, W]."""

    def __init__(self, channels: int, num_heads: int, head_dim: int, dtype,
                 depth: int = 1, device=None):
        super().__init__()
        inner = num_heads * head_dim
        kw = dict(dtype=dtype, device=device)
        self.norm = GroupNorm32(channels, 1e-6, device=device)
        self.proj_in = nn.Linear(channels, inner, **kw)
        self.depth = depth
        for i in range(depth):
            setattr(self, f"block_{i}",
                    TemporalTransformerBlock(inner, num_heads, head_dim,
                                             dtype, device))
        self.proj_out = nn.Linear(inner, channels, **kw)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, t, hh, ww = x.shape
        h = self.norm(x).to(self.dtype)
        # one sequence of T frames per (sample, site): [B*H*W, T, C]
        h = h.permute(0, 3, 4, 2, 1).reshape(b * hh * ww, t, c)
        h = self.proj_in(h)
        for i in range(self.depth):
            h = getattr(self, f"block_{i}")(h)
        h = self.proj_out(h).view(b, hh, ww, t, c).permute(0, 4, 3, 1, 2)
        return x + h


def _frames(x: torch.Tensor, b: int) -> torch.Tensor:
    """[B*T, C, H, W] (frame-major per sample) -> [B, C, T, H, W]."""
    return x.view(b, -1, *x.shape[1:]).transpose(1, 2)


def _maps(x: torch.Tensor) -> torch.Tensor:
    """[B, C, T, H, W] -> [B*T, C, H, W]."""
    return x.transpose(1, 2).reshape(-1, x.shape[1], *x.shape[3:])


class UNet3DCondition(nn.Module):
    """epsilon-prediction video UNet; forward(latents[B,T,H,W,C],
    t[B], context[B,L,D]) -> eps [B,T,H,W,C] float32."""

    def __init__(self, config: UNet3DConfig, device=None):
        super().__init__()
        cfg = self.config = config
        dt = cfg.tdtype
        bc = cfg.block_channels
        temb_dim = bc[0] * 4
        hd = cfg.head_dim
        self.TimestepEmbedding_0 = TimestepEmbedding(bc[0], temb_dim, dt,
                                                     device)
        self.conv_in = conv3x3(cfg.in_channels, bc[0], dt, device)
        self.transformer_in = TemporalTransformer(
            bc[0], cfg.tin_heads, hd, dt, cfg.transformer_depth, device)

        def add(name, module):
            self.add_module(name, module)

        def spatial(ch):
            return SpatialTransformer(ch, ch // hd, hd, cfg.context_dim, dt,
                                      cfg.transformer_depth, device)

        def temporal(ch):
            return TemporalTransformer(ch, ch // hd, hd, dt,
                                       cfg.transformer_depth, device)

        cur, skips = bc[0], [bc[0]]
        for level, ch in enumerate(bc):
            for j in range(cfg.layers_per_block):
                add(f"down_{level}_res_{j}",
                    ResnetBlock(cur, ch, dt, temb_dim, device=device))
                add(f"down_{level}_tconv_{j}",
                    TemporalConvLayer(ch, dt, device))
                if cfg.attention_levels[level]:
                    add(f"down_{level}_attn_{j}", spatial(ch))
                    add(f"down_{level}_tattn_{j}", temporal(ch))
                cur = ch
                skips.append(ch)
            if level < len(bc) - 1:
                add(f"down_{level}_ds", Downsample(ch, dt, device))
                skips.append(ch)
        mid = bc[-1]
        self.mid_res_0 = ResnetBlock(cur, mid, dt, temb_dim, device=device)
        self.mid_tconv_0 = TemporalConvLayer(mid, dt, device)
        self.mid_attn = spatial(mid)
        self.mid_tattn = temporal(mid)
        self.mid_res_1 = ResnetBlock(mid, mid, dt, temb_dim, device=device)
        self.mid_tconv_1 = TemporalConvLayer(mid, dt, device)
        cur = mid
        for level in reversed(range(len(bc))):
            ch = bc[level]
            for j in range(cfg.layers_per_block + 1):
                add(f"up_{level}_res_{j}",
                    ResnetBlock(cur + skips.pop(), ch, dt, temb_dim,
                                device=device))
                add(f"up_{level}_tconv_{j}",
                    TemporalConvLayer(ch, dt, device))
                if cfg.attention_levels[level]:
                    add(f"up_{level}_attn_{j}", spatial(ch))
                    add(f"up_{level}_tattn_{j}", temporal(ch))
                cur = ch
            if level > 0:
                add(f"up_{level}_us", Upsample(ch, dt, device))
        self.norm_out = GroupNorm32(cur, device=device)
        self.conv_out = conv3x3(cur, cfg.out_channels, torch.float32, device)

    def zero_init_keys(self) -> list[str]:
        """The state-dict keys the reference initialises to zero: each
        TemporalConvLayer's last conv and each TemporalTransformer's
        proj_out (so that at init the temporal branches add nothing)."""
        keys = []
        for name, mod in self.named_modules():
            if isinstance(mod, TemporalConvLayer):
                keys.append(f"{name}.conv4.weight")
            elif isinstance(mod, TemporalTransformer):
                keys.append(f"{name}.proj_out.weight")
        return keys

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                context: torch.Tensor) -> torch.Tensor:
        # a sample's frames per cuDNN call (models/common.py Conv2d)
        with samples_per_conv(x.shape[1]):
            return self._forward(x, t, context)

    def _forward(self, x, t, context):
        cfg = self.config
        dt = cfg.tdtype
        bc = cfg.block_channels
        b, frames = x.shape[:2]
        # frames of one sample follow each other: [B*T, C, H, W]
        x = x.to(dt).permute(0, 1, 4, 2, 3).reshape(b * frames, x.shape[4],
                                                     *x.shape[2:4])
        # every frame of a sample shares its text context and timestep
        ctx = context.to(dt).repeat_interleave(frames, dim=0)
        temb = self.TimestepEmbedding_0(sinusoidal_embedding(t, bc[0]))
        temb = temb.repeat_interleave(frames, dim=0)

        def temporal(name, h):
            return _maps(getattr(self, name)(_frames(h, b)))

        def layer(prefix, h, attend):
            h = getattr(self, f"{prefix.replace('@', 'res')}")(h, temb)
            h = temporal(prefix.replace("@", "tconv"), h)
            if attend:
                h = getattr(self, prefix.replace("@", "attn"))(h, ctx)
                h = temporal(prefix.replace("@", "tattn"), h)
            return h

        h = temporal("transformer_in", self.conv_in(x))
        skips = [h]
        for level in range(len(bc)):
            for j in range(cfg.layers_per_block):
                h = layer(f"down_{level}_@_{j}", h,
                          cfg.attention_levels[level])
                skips.append(h)
            if level < len(bc) - 1:
                h = getattr(self, f"down_{level}_ds")(h)
                skips.append(h)

        h = temporal("mid_tconv_0", self.mid_res_0(h, temb))
        h = temporal("mid_tattn", self.mid_attn(h, ctx))
        h = temporal("mid_tconv_1", self.mid_res_1(h, temb))

        for level in reversed(range(len(bc))):
            for j in range(cfg.layers_per_block + 1):
                h = layer(f"up_{level}_@_{j}",
                          torch.cat([h, skips.pop()], dim=1),
                          cfg.attention_levels[level])
            if level > 0:
                h = getattr(self, f"up_{level}_us")(h)

        h = self.conv_out(F.silu(self.norm_out(h)).float())
        return h.view(b, frames, *h.shape[1:]).permute(0, 1, 3, 4, 2)
