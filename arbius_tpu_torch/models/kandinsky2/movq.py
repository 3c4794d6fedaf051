"""MOVQ decoder: Kandinsky-2's latent -> pixel stage.

Twin of arbius_tpu/models/kandinsky2/movq.py: a VQGAN-style decoder whose
group norms are spatially modulated (`SpatialNorm`: scale and shift are
1x1 convs of the raw latent, resized nearest to each level), in the
published diffusers VQModel decoder's topology: post_quant conv ->
conv_in -> mid (res, spatially-normed single-head attention, res) -> an
up tower of `layers_per_block + 1` resnets per level -> spatial norm_out
-> conv_out. It decodes continuous latents (no codebook lookup).

The mid attention has one head of D = channels (512 at full width) and
no mask, so it goes through models/common.py's `Attention` to
ops/flash.py: on the card the wgmma wide kernel, once per decode. The
public call takes NHWC latents and returns NHWC pixels; inside,
activations run NCHW. `conv_out` runs in float32.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from arbius_tpu_torch.models.common import (
    Attention,
    GroupNorm32,
    Upsample,
    conv1x1,
    conv3x3,
)


@dataclass(frozen=True)
class MOVQConfig:
    latent_channels: int = 4
    block_channels: tuple[int, ...] = (128, 256, 256, 512)  # low->high res
    layers_per_block: int = 2     # the decoder runs this + 1 resnets
    dtype: str = "bfloat16"

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @classmethod
    def tiny(cls) -> "MOVQConfig":
        return cls(block_channels=(8, 8, 8, 8), layers_per_block=1)


class SpatialNorm(nn.Module):
    """GroupNorm (eps 1e-6) whose scale and shift are 1x1 convs of the
    latent z resized nearest to the map's size (an integer factor:
    output pixel i samples z at i // factor, as jax.image.resize's
    nearest does)."""

    def __init__(self, channels: int, latent_channels: int, dtype,
                 device=None):
        super().__init__()
        self.norm = GroupNorm32(channels, 1e-6, device=device)
        self.conv_y = conv1x1(latent_channels, channels, dtype, device)
        self.conv_b = conv1x1(latent_channels, channels, dtype, device)

    def forward(self, h: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        z_up = F.interpolate(z, size=h.shape[2:], mode="nearest")
        normed = self.norm(h)
        return (normed * self.conv_y(z_up).to(normed.dtype)
                + self.conv_b(z_up).to(normed.dtype))


class MOVQResBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, latent_channels: int, dtype,
                 device=None):
        super().__init__()
        self.norm1 = SpatialNorm(in_ch, latent_channels, dtype, device)
        self.Conv_0 = conv3x3(in_ch, out_ch, dtype, device)
        self.norm2 = SpatialNorm(out_ch, latent_channels, dtype, device)
        self.Conv_1 = conv3x3(out_ch, out_ch, dtype, device)
        self.skip = (conv1x1(in_ch, out_ch, dtype, device)
                     if in_ch != out_ch else None)

    def forward(self, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        h = self.Conv_0(F.silu(self.norm1(x, z)))
        h = self.Conv_1(F.silu(self.norm2(h, z)))
        if self.skip is not None:
            x = self.skip(x)
        return x + h


class MOVQDecoder(nn.Module):
    """forward(z[B,h,w,4] NHWC) -> pixels [B,8h,8w,3] float32 NHWC in
    roughly [-1, 1]."""

    def __init__(self, config: MOVQConfig, device=None):
        super().__init__()
        cfg = self.config = config
        dt, bc, lc = cfg.tdtype, cfg.block_channels, cfg.latent_channels
        self.post_quant = conv1x1(lc, lc, dt, device)
        self.conv_in = conv3x3(lc, bc[-1], dt, device)
        self.mid_res_0 = MOVQResBlock(bc[-1], bc[-1], lc, dt, device)
        self.mid_attn_norm = SpatialNorm(bc[-1], lc, dt, device)
        self.mid_attn = Attention(bc[-1], 1, bc[-1], dt, qkv_bias=True,
                                  device=device)
        self.mid_res_1 = MOVQResBlock(bc[-1], bc[-1], lc, dt, device)
        cur = bc[-1]
        for level in reversed(range(len(bc))):
            for j in range(cfg.layers_per_block + 1):
                self.add_module(f"up_{level}_res_{j}",
                                MOVQResBlock(cur, bc[level], lc, dt, device))
                cur = bc[level]
            if level > 0:
                self.add_module(f"up_{level}_us", Upsample(cur, dt, device))
        self.norm_out = SpatialNorm(cur, lc, dt, device)
        self.conv_out = conv3x3(cur, 3, torch.float32, device)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        # the spatial norms condition on the raw latent; the post-quant
        # conv feeds the conv tower only
        z = z.to(cfg.tdtype).permute(0, 3, 1, 2)
        h = self.mid_res_0(self.conv_in(self.post_quant(z)), z)
        b, c, hh, ww = h.shape
        t = self.mid_attn_norm(h, z).flatten(2).transpose(1, 2)  # [B,HW,C]
        h = h + self.mid_attn(t).transpose(1, 2).reshape(b, c, hh, ww)
        h = self.mid_res_1(h, z)
        for level in reversed(range(len(cfg.block_channels))):
            for j in range(cfg.layers_per_block + 1):
                h = getattr(self, f"up_{level}_res_{j}")(h, z)
            if level > 0:
                h = getattr(self, f"up_{level}_us")(h)
        h = F.silu(self.norm_out(h, z))
        return self.conv_out(h.float()).permute(0, 2, 3, 1)
