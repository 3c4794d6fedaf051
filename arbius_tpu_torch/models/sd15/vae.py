"""AutoencoderKL (the SD VAE) — latent <-> pixel codec.

Twin of arbius_tpu/models/sd15/vae.py. txt2img needs only the decoder;
the encoder is its twin for completeness (no caller in either package
uses it). Latent scaling factor 0.18215 (SD-1.5 convention). The public
calls take and return NHWC; inside, activations run NCHW.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from arbius_tpu_torch.models.common import (
    Attention,
    Downsample,
    GroupNorm32,
    ResnetBlock,
    Upsample,
    conv1x1,
    conv3x3,
)

SD_LATENT_SCALE = 0.18215


@dataclass(frozen=True)
class VAEConfig:
    latent_channels: int = 4
    block_channels: tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    dtype: str = "bfloat16"

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @classmethod
    def tiny(cls) -> "VAEConfig":
        return cls(block_channels=(8, 8, 8, 8), layers_per_block=1)


class _MidAttention(nn.Module):
    """Single-head full self-attention over the bottleneck spatial map
    (head dim = channels; q/k/v biases, as the published VAEs carry)."""

    def __init__(self, channels: int, dtype, device=None):
        super().__init__()
        self.GroupNorm32_0 = GroupNorm32(channels, 1e-6, device=device)
        self.Attention_0 = Attention(channels, 1, channels, dtype,
                                     qkv_bias=True, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        t = self.GroupNorm32_0(x).flatten(2).transpose(1, 2)   # [B, HW, C]
        t = self.Attention_0(t)
        return x + t.transpose(1, 2).reshape(b, c, h, w)


class VAEDecoder(nn.Module):
    """forward(z[B,h,w,4] NHWC) -> pixels [B,8h,8w,3] float32 NHWC in
    roughly [-1, 1]."""

    def __init__(self, config: VAEConfig, device=None):
        super().__init__()
        cfg = self.config = config
        dt = cfg.tdtype
        bc = cfg.block_channels
        self.post_quant = conv1x1(cfg.latent_channels, cfg.latent_channels,
                                  dt, device)
        self.conv_in = conv3x3(cfg.latent_channels, bc[-1], dt, device)
        self.mid_res_0 = ResnetBlock(bc[-1], bc[-1], dt, norm_eps=1e-6,
                                     device=device)
        self.mid_attn = _MidAttention(bc[-1], dt, device)
        self.mid_res_1 = ResnetBlock(bc[-1], bc[-1], dt, norm_eps=1e-6,
                                     device=device)
        cur = bc[-1]
        for level in reversed(range(len(bc))):
            ch = bc[level]
            for j in range(cfg.layers_per_block + 1):
                self.add_module(f"up_{level}_res_{j}",
                                ResnetBlock(cur, ch, dt, norm_eps=1e-6,
                                            device=device))
                cur = ch
            if level > 0:
                self.add_module(f"up_{level}_us", Upsample(ch, dt, device))
        self.norm_out = GroupNorm32(cur, 1e-6, device=device)
        # final conv in fp32: pixel values feed the deterministic PNG path
        self.conv_out = conv3x3(cur, 3, torch.float32, device)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        h = self.post_quant(z.to(cfg.tdtype).permute(0, 3, 1, 2))
        h = self.conv_in(h)
        h = self.mid_res_1(self.mid_attn(self.mid_res_0(h)))
        for level in reversed(range(len(cfg.block_channels))):
            for j in range(cfg.layers_per_block + 1):
                h = getattr(self, f"up_{level}_res_{j}")(h)
            if level > 0:
                h = getattr(self, f"up_{level}_us")(h)
        h = F.silu(self.norm_out(h))
        return self.conv_out(h.float()).permute(0, 2, 3, 1)


class VAEEncoder(nn.Module):
    """forward(x[B,H,W,3] NHWC) -> moments [B,H/8,W/8,2*latent] float32
    NHWC (mean, then logvar)."""

    def __init__(self, config: VAEConfig, device=None):
        super().__init__()
        cfg = self.config = config
        dt = cfg.tdtype
        bc = cfg.block_channels
        self.conv_in = conv3x3(3, bc[0], dt, device)
        cur = bc[0]
        for level, ch in enumerate(bc):
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_{level}_res_{j}",
                                ResnetBlock(cur, ch, dt, norm_eps=1e-6,
                                            device=device))
                cur = ch
            if level < len(bc) - 1:
                self.add_module(f"down_{level}_ds", Downsample(ch, dt, device))
        self.mid_res_0 = ResnetBlock(cur, bc[-1], dt, norm_eps=1e-6,
                                     device=device)
        self.mid_attn = _MidAttention(bc[-1], dt, device)
        self.mid_res_1 = ResnetBlock(bc[-1], bc[-1], dt, norm_eps=1e-6,
                                     device=device)
        self.norm_out = GroupNorm32(bc[-1], 1e-6, device=device)
        # mean + logvar, in fp32
        self.conv_out = conv3x3(bc[-1], cfg.latent_channels * 2,
                                torch.float32, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        h = self.conv_in(x.to(cfg.tdtype).permute(0, 3, 1, 2))
        for level in range(len(cfg.block_channels)):
            for j in range(cfg.layers_per_block):
                h = getattr(self, f"down_{level}_res_{j}")(h)
            if level < len(cfg.block_channels) - 1:
                h = getattr(self, f"down_{level}_ds")(h)
        h = self.mid_res_1(self.mid_attn(self.mid_res_0(h)))
        h = F.silu(self.norm_out(h))
        return self.conv_out(h.float()).permute(0, 2, 3, 1)


def decode_to_images(pixels: torch.Tensor) -> torch.Tensor:
    """[-1,1] float decoder output -> uint8 RGB: clip, x255, round half
    to even (torch.round), as the reference does."""
    x = torch.clamp(pixels * 0.5 + 0.5, 0.0, 1.0)
    return torch.round(x * 255.0).to(torch.uint8)
