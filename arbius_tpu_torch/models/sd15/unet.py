"""Conditional UNet2D — the SD-1.5 denoiser (anythingv3's model class).

Twin of arbius_tpu/models/sd15/unet.py: the published SD-1.5 topology,
a 4-level encoder/decoder (320/640/1280/1280 channels, 2 resnets per
level), spatial transformers with text cross-attention at the three
highest resolutions, and a 1280-channel mid block.

The public call takes NHWC latents and returns NHWC, as the reference
does; inside, activations run NCHW (cuDNN's native conv layout).
`conv_out` runs in float32 on float32 weights.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from arbius_tpu_torch.models.common import (
    Downsample,
    GroupNorm32,
    ResnetBlock,
    SpatialTransformer,
    TimestepEmbedding,
    Upsample,
    conv3x3,
    sinusoidal_embedding,
)


@dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_channels: tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    attention_levels: tuple[bool, ...] = (True, True, True, False)
    num_heads: int = 8
    head_dim: int | None = None   # set → heads vary per level (ch // head_dim)
    context_dim: int = 768
    transformer_depth: int = 1
    dtype: str = "bfloat16"

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def heads_for(self, ch: int) -> tuple[int, int]:
        """(num_heads, head_dim) at a channel width. SD-1.5 fixes the head
        COUNT; other published UNets (e.g. Kandinsky's decoder) fix the
        head DIM, so the count grows with width."""
        if self.head_dim is not None:
            return ch // self.head_dim, self.head_dim
        return self.num_heads, ch // self.num_heads

    @classmethod
    def tiny(cls) -> "UNetConfig":
        """Small config for tests: same topology, toy widths."""
        return cls(block_channels=(8, 8, 8, 8), layers_per_block=1,
                   num_heads=2, context_dim=16)


class UNet2DCondition(nn.Module):
    """epsilon-prediction UNet; forward(latents[B,H,W,4] NHWC, t[B],
    context[B,S,D]) -> eps [B,H,W,4] float32 NHWC."""

    def __init__(self, config: UNetConfig, device=None):
        super().__init__()
        cfg = self.config = config
        dt = cfg.tdtype
        bc = cfg.block_channels
        temb_dim = bc[0] * 4
        self.TimestepEmbedding_0 = TimestepEmbedding(bc[0], temb_dim, dt,
                                                     device)
        self.conv_in = conv3x3(cfg.in_channels, bc[0], dt, device)

        def transformer(ch):
            heads, hd = cfg.heads_for(ch)
            return SpatialTransformer(ch, heads, hd, cfg.context_dim, dt,
                                      cfg.transformer_depth, device)

        cur, skips = bc[0], [bc[0]]
        for level, ch in enumerate(bc):
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_{level}_res_{j}",
                                ResnetBlock(cur, ch, dt, temb_dim,
                                            device=device))
                cur = ch
                if cfg.attention_levels[level]:
                    self.add_module(f"down_{level}_attn_{j}", transformer(ch))
                skips.append(ch)
            if level < len(bc) - 1:
                self.add_module(f"down_{level}_ds", Downsample(ch, dt, device))
                skips.append(ch)
        self.mid_res_0 = ResnetBlock(cur, bc[-1], dt, temb_dim, device=device)
        self.mid_attn = transformer(bc[-1])
        self.mid_res_1 = ResnetBlock(bc[-1], bc[-1], dt, temb_dim,
                                     device=device)
        cur = bc[-1]
        for level in reversed(range(len(bc))):
            ch = bc[level]
            for j in range(cfg.layers_per_block + 1):
                self.add_module(f"up_{level}_res_{j}",
                                ResnetBlock(cur + skips.pop(), ch, dt,
                                            temb_dim, device=device))
                cur = ch
                if cfg.attention_levels[level]:
                    self.add_module(f"up_{level}_attn_{j}", transformer(ch))
            if level > 0:
                self.add_module(f"up_{level}_us", Upsample(ch, dt, device))
        self.norm_out = GroupNorm32(cur, device=device)
        self.conv_out = conv3x3(cur, cfg.out_channels, torch.float32, device)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                context: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        dt = cfg.tdtype
        bc = cfg.block_channels
        x = x.to(dt).permute(0, 3, 1, 2)
        context = context.to(dt)
        temb = self.TimestepEmbedding_0(sinusoidal_embedding(t, bc[0]))

        h = self.conv_in(x)
        skips = [h]
        for level in range(len(bc)):
            for j in range(cfg.layers_per_block):
                h = getattr(self, f"down_{level}_res_{j}")(h, temb)
                if cfg.attention_levels[level]:
                    h = getattr(self, f"down_{level}_attn_{j}")(h, context)
                skips.append(h)
            if level < len(bc) - 1:
                h = getattr(self, f"down_{level}_ds")(h)
                skips.append(h)

        h = self.mid_res_0(h, temb)
        h = self.mid_attn(h, context)
        h = self.mid_res_1(h, temb)

        for level in reversed(range(len(bc))):
            for j in range(cfg.layers_per_block + 1):
                h = torch.cat([h, skips.pop()], dim=1)
                h = getattr(self, f"up_{level}_res_{j}")(h, temb)
                if cfg.attention_levels[level]:
                    h = getattr(self, f"up_{level}_attn_{j}")(h, context)
            if level > 0:
                h = getattr(self, f"up_{level}_us")(h)

        h = F.silu(self.norm_out(h))
        return self.conv_out(h.float()).permute(0, 2, 3, 1)
