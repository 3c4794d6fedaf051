"""Kandinsky-2 decoder UNet: a denoiser conditioned on the CLIP image
embedding.

Twin of arbius_tpu/models/kandinsky2/decoder.py. The embedding the prior
produced is projected both into a short context token sequence (linear,
reshape to tokens, float32 LayerNorm: the published ImageProjection) and
into the timestep embedding (the published add_embedding MLP). The UNet
interior is the unCLIP family's:

  - attention is single-layer added-KV attention: queries from the
    group-normed spatial tokens, keys and values from [projected context
    || spatial tokens], all projections biased, the residual inside;
  - attention at every level but the highest resolution;
  - resnet-based down/upsampling (models/common.py `ResnetBlock` with
    `resample`), FiLM time conditioning (`scale_shift`), a fixed head
    dim of 64, and 8 output channels (epsilon + learned variance; the
    samplers read the epsilon half).

The public calls take NHWC latents and return NHWC, as the reference's;
inside, activations run NCHW. `conv_out` runs in float32.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from arbius_tpu_torch.models.common import (
    GroupNorm32,
    ResnetBlock,
    TimestepEmbedding,
    conv3x3,
    sinusoidal_embedding,
)
from arbius_tpu_torch.models.sd15.unet import UNetConfig


@dataclass(frozen=True)
class DecoderConfig:
    unet: UNetConfig = UNetConfig(block_channels=(384, 768, 1152, 1536),
                                  layers_per_block=3,
                                  attention_levels=(False, True, True, True),
                                  out_channels=8, head_dim=64,
                                  context_dim=768, time_scale_shift=True)
    clip_dim: int = 1280
    context_tokens: int = 10      # image embed -> this many pseudo-tokens

    @classmethod
    def tiny(cls) -> "DecoderConfig":
        unet = dataclasses.replace(
            UNetConfig.tiny(), attention_levels=(False, True, True, True),
            time_scale_shift=True)
        return cls(unet=unet, clip_dim=16, context_tokens=2)


class AttnAddedKV(nn.Module):
    """unCLIP-family attention over an NCHW map: group-normed spatial
    queries over [context || spatial] keys and values (context first),
    biased projections, residual inside. Scores from a matmul in the
    compute dtype, softmax in float32, probabilities back in the compute
    dtype, as the reference's einsums (no flash kernel)."""

    def __init__(self, channels: int, num_heads: int, head_dim: int,
                 context_dim: int, dtype, device=None):
        super().__init__()
        inner = num_heads * head_dim
        kw = dict(dtype=dtype, device=device)
        self.group_norm = GroupNorm32(channels, device=device)
        self.to_q = nn.Linear(channels, inner, **kw)
        self.to_k = nn.Linear(channels, inner, **kw)
        self.to_v = nn.Linear(channels, inner, **kw)
        self.add_k_proj = nn.Linear(context_dim, inner, **kw)
        self.add_v_proj = nn.Linear(context_dim, inner, **kw)
        self.to_out = nn.Linear(inner, channels, **kw)
        self.num_heads, self.head_dim = num_heads, head_dim

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, c, hh, ww = x.shape
        hs = self.group_norm(x).flatten(2).transpose(1, 2)     # [B, HW, C]
        ctx = context.to(hs.dtype)

        def split(t):   # [B, S, inner] -> [B, H, S, D]
            return t.unflatten(-1, (self.num_heads, self.head_dim)
                               ).transpose(1, 2)

        q = split(self.to_q(hs))
        k = split(torch.cat([self.add_k_proj(ctx), self.to_k(hs)], dim=1))
        v = split(torch.cat([self.add_v_proj(ctx), self.to_v(hs)], dim=1))
        scale = 1.0 / math.sqrt(self.head_dim)
        logits = torch.matmul(q, k.transpose(-1, -2)).float() * scale
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).flatten(2)
        out = self.to_out(out)                                 # [B, HW, C]
        return x + out.transpose(1, 2).reshape(b, c, hh, ww)


class KandinskyUNet(nn.Module):
    """forward(x NCHW, t[B], context[B,S,D], extra_temb[B,4ch0]) ->
    eps[+variance] NCHW float32."""

    def __init__(self, config: UNetConfig, device=None):
        super().__init__()
        cfg = self.config = config
        dt, bc = cfg.tdtype, cfg.block_channels
        temb_dim = bc[0] * 4
        self.TimestepEmbedding_0 = TimestepEmbedding(bc[0], temb_dim, dt,
                                                     device)
        self.conv_in = conv3x3(cfg.in_channels, bc[0], dt, device)

        def res(cin, cout, resample="none"):
            return ResnetBlock(cin, cout, dt, temb_dim, device=device,
                               scale_shift=cfg.time_scale_shift,
                               resample=resample)

        def attn(ch):
            heads, hd = cfg.heads_for(ch)
            return AttnAddedKV(ch, heads, hd, cfg.context_dim, dt, device)

        cur, skips = bc[0], [bc[0]]
        for level, ch in enumerate(bc):
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_{level}_res_{j}", res(cur, ch))
                cur = ch
                if cfg.attention_levels[level]:
                    self.add_module(f"down_{level}_attn_{j}", attn(ch))
                skips.append(ch)
            if level < len(bc) - 1:
                self.add_module(f"down_{level}_ds", res(ch, ch, "down"))
                skips.append(ch)
        self.mid_res_0 = res(cur, bc[-1])
        self.mid_attn = attn(bc[-1])
        self.mid_res_1 = res(bc[-1], bc[-1])
        cur = bc[-1]
        for level in reversed(range(len(bc))):
            ch = bc[level]
            for j in range(cfg.layers_per_block + 1):
                self.add_module(f"up_{level}_res_{j}",
                                res(cur + skips.pop(), ch))
                cur = ch
                if cfg.attention_levels[level]:
                    self.add_module(f"up_{level}_attn_{j}", attn(ch))
            if level > 0:
                self.add_module(f"up_{level}_us", res(ch, ch, "up"))
        self.norm_out = GroupNorm32(cur, device=device)
        self.conv_out = conv3x3(cur, cfg.out_channels, torch.float32, device)

    def forward(self, x, t, context, extra_temb=None) -> torch.Tensor:
        cfg = self.config
        bc = cfg.block_channels
        x = x.to(cfg.tdtype)
        context = context.to(cfg.tdtype)
        temb = self.TimestepEmbedding_0(sinusoidal_embedding(t, bc[0]))
        if extra_temb is not None:
            temb = temb + extra_temb.to(temb.dtype)

        h = self.conv_in(x)
        skips = [h]
        for level in range(len(bc)):
            for j in range(cfg.layers_per_block):
                h = getattr(self, f"down_{level}_res_{j}")(h, temb)
                if cfg.attention_levels[level]:
                    h = getattr(self, f"down_{level}_attn_{j}")(h, context)
                skips.append(h)
            if level < len(bc) - 1:
                h = getattr(self, f"down_{level}_ds")(h, temb)
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
                h = getattr(self, f"up_{level}_us")(h, temb)

        h = F.silu(self.norm_out(h))
        return self.conv_out(h.float())


class DecoderUNet(nn.Module):
    """forward(latents[B,h,w,4] NHWC, t[B], image_embed[B,clip_dim]) ->
    eps[+variance] [B,h,w,out_channels] float32 NHWC."""

    def __init__(self, config: DecoderConfig, device=None):
        super().__init__()
        cfg = self.config = config
        u = cfg.unet
        dt, tdim = u.tdtype, u.block_channels[0] * 4
        kw = dict(dtype=dt, device=device)
        self.embed_to_context = nn.Linear(
            cfg.clip_dim, cfg.context_tokens * u.context_dim, **kw)
        self.context_norm = nn.LayerNorm(u.context_dim, eps=1e-5,
                                         device=device)
        self.add_linear_1 = nn.Linear(cfg.clip_dim, tdim, **kw)
        self.add_linear_2 = nn.Linear(tdim, tdim, **kw)
        self.unet = KandinskyUNet(u, device)

    def forward(self, x, t, image_embed) -> torch.Tensor:
        cfg = self.config
        u = cfg.unet
        emb = image_embed.to(u.tdtype)
        ctx = self.embed_to_context(emb).view(
            emb.shape[0], cfg.context_tokens, u.context_dim)
        ctx = self.context_norm(ctx.float()).to(u.tdtype)
        add = self.add_linear_2(F.silu(self.add_linear_1(emb)))
        out = self.unet(x.to(u.tdtype).permute(0, 3, 1, 2), t, ctx,
                        extra_temb=add)
        return out.permute(0, 2, 3, 1)
