"""Shared neural building blocks of the SD-1.5 and Kandinsky-2 families,
in PyTorch.

Twin of arbius_tpu/models/common.py. Differences of layout, not of math:

  - Activations run NCHW inside the port (PyTorch's and cuDNN's native
    conv layout); the models' public calls keep the reference's NHWC and
    transpose at their edges.
  - Submodules carry the reference's flax names (``Conv_0``,
    ``GroupNorm32_0``, ``to_q`` ...), so a state_dict key is the flax
    parameter path with '/' -> '.' and kernel/scale -> weight; the bridge
    (models/sd15/bridge.py) relies on that.
  - Linear and conv weights are stored in the compute dtype. flax keeps
    float32 parameters and rounds them to the compute dtype at every use;
    rounding once at load gives the same bits.
  - Norm statistics are float32 whatever the activation dtype, as in the
    reference.
"""
from __future__ import annotations

import contextlib
import contextvars
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from arbius_tpu_torch.ops.flash import attention as fused_attention


def sinusoidal_embedding(t: torch.Tensor, dim: int,
                         max_period: float = 10000.0,
                         flip: bool = True) -> torch.Tensor:
    """Transformer-style timestep embedding; [B] -> [B, dim] float32."""
    half = dim // 2
    neg_log = torch.tensor(-np.log(max_period), dtype=torch.float32,
                           device=t.device)
    freqs = torch.exp(neg_log * torch.arange(half, dtype=torch.float32,
                                             device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip else [sin, cos], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


class GroupNorm32(nn.Module):
    """GroupNorm computed in float32 regardless of activation dtype;
    groups = gcd(channels, 32). NCHW.

    The arithmetic is flax's, not torch's fused kernel's: var =
    max(0, E[x^2] - E[x]^2) and y = (x - mean) * (rsqrt(var + eps) *
    scale) + bias. The two differ where a group is (nearly) constant,
    e.g. one element per group at a 1x1 map: flax's x - mean is exactly
    0 there, while torch's folded form leaves rounding noise times
    rsqrt(eps) that a following LayerNorm blows up. `GroupNorm_0` only
    holds the parameters."""

    def __init__(self, channels: int, eps: float = 1e-5,
                 num_groups: int = 32, device=None):
        super().__init__()
        self.GroupNorm_0 = nn.GroupNorm(math.gcd(channels, num_groups),
                                        channels, eps=eps, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gn = self.GroupNorm_0
        b, c = x.shape[:2]
        xf = x.float().reshape(b, gn.num_groups, -1)
        mean = xf.mean(-1, keepdim=True)
        var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + gn.eps).repeat_interleave(
            c // gn.num_groups, dim=1) * gn.weight[None, :, None]
        y = (x.float().reshape(b, c, -1) - mean.repeat_interleave(
            c // gn.num_groups, dim=1)) * mul + gn.bias[None, :, None]
        return y.reshape(x.shape).to(x.dtype)


class LayerNorm32(nn.Module):
    """LayerNorm over the last axis, computed in float32 whatever the
    input dtype, returning float32.

    The arithmetic is flax's (`_compute_stats` with its default
    use_fast_variance, then `_normalize`), not torch's two-pass form:
    mean = E[x], var = max(0, E[x^2] - mean^2), y = (x - mean) *
    (rsqrt(var + eps) * weight) + bias. The two differ where a row's
    mean is large against its spread. The parameters keep nn.LayerNorm's
    names, `weight` and `bias`."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        return (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias


_SAMPLES_PER_CONV = contextvars.ContextVar("samples_per_conv", default=1)


@contextlib.contextmanager
def samples_per_conv(n: int):
    """Within the block, each Conv2d call takes `n` consecutive maps of
    its batch (the video UNet3D: one task's frames of one guidance half)
    instead of one."""
    token = _SAMPLES_PER_CONV.set(n)
    try:
        yield
    finally:
        _SAMPLES_PER_CONV.reset(token)


class Conv2d(nn.Conv2d):
    """nn.Conv2d run one sample per call, so that a task's bits do not
    depend on its neighbours in the batch.

    cuDNN picks its algorithm from the problem's shape, and for some
    shapes it picks one whose result for a sample depends on the sample's
    position in the batch (on an H100, the 3x3 convs to 1280 channels
    over 16x16 and 32x32 maps at batch 8). With one sample per call every
    sample is the same problem, whatever shares its batch. The solver's
    canonical batch still fixes every other kernel's shape.

    Under `samples_per_conv(n)` a call takes n consecutive maps. The video
    UNet3D runs a task's T frames of one guidance half per call: each
    call is then the same problem, and a frame's position in it is its
    frame index, whatever tasks share the batch (on the H100 it takes a
    damo chunk's convolutions from 64x to 8 calls each, 47 s to 21 s a
    chunk)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = _SAMPLES_PER_CONV.get()
        return torch.cat([super(Conv2d, self).forward(x[i:i + n])
                          for i in range(0, x.shape[0], n)])


def conv3x3(cin: int, cout: int, dtype, device, stride: int = 1) -> Conv2d:
    return Conv2d(cin, cout, 3, stride=stride, padding=1, dtype=dtype,
                  device=device)


def conv1x1(cin: int, cout: int, dtype, device) -> Conv2d:
    return Conv2d(cin, cout, 1, dtype=dtype, device=device)


class TimestepEmbedding(nn.Module):
    """MLP lift of the sinusoidal embedding: dim -> out_dim."""

    def __init__(self, in_dim: int, out_dim: int, dtype, device=None):
        super().__init__()
        self.Dense_0 = nn.Linear(in_dim, out_dim, dtype=dtype, device=device)
        self.Dense_1 = nn.Linear(out_dim, out_dim, dtype=dtype, device=device)
        self.dtype = dtype

    def forward(self, emb: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(F.silu(self.Dense_0(emb.to(self.dtype))))


class ResnetBlock(nn.Module):
    """GN-SiLU-conv x2 with timestep conditioning and learned skip (NCHW).

    `scale_shift=True` is the FiLM form (Kandinsky's decoder): `Dense_0`
    predicts 2 x out_ch values, split into (scale, shift) and applied as
    h * (1 + scale) + shift after the second GroupNorm, in place of the
    additive injection before it. `resample` "down" (a 2x2 average pool)
    or "up" (nearest 2x) acts on both the branch and the skip between
    the first norm and conv. The average pool sums in float32 and rounds
    once to the input dtype; flax's `avg_pool` sums in the input dtype,
    which differs only for bf16 activations."""

    def __init__(self, in_ch: int, out_ch: int, dtype, temb_dim: int | None
                 = None, norm_eps: float = 1e-5, device=None,
                 scale_shift: bool = False, resample: str = "none"):
        super().__init__()
        self.GroupNorm32_0 = GroupNorm32(in_ch, norm_eps, device=device)
        self.Conv_0 = conv3x3(in_ch, out_ch, dtype, device)
        if temb_dim is not None:
            self.Dense_0 = nn.Linear(temb_dim, out_ch * (2 if scale_shift
                                                         else 1),
                                     dtype=dtype, device=device)
        self.GroupNorm32_1 = GroupNorm32(out_ch, norm_eps, device=device)
        self.Conv_1 = conv3x3(out_ch, out_ch, dtype, device)
        self.skip_proj = (conv1x1(in_ch, out_ch, dtype, device)
                          if in_ch != out_ch else None)
        self.scale_shift, self.resample = scale_shift, resample

    def _resample(self, x: torch.Tensor) -> torch.Tensor:
        if self.resample == "down":
            return F.avg_pool2d(x.float(), 2).to(x.dtype)
        if self.resample == "up":
            return F.interpolate(x, scale_factor=2, mode="nearest")
        return x

    def forward(self, x: torch.Tensor, temb: torch.Tensor | None = None):
        h = self._resample(F.silu(self.GroupNorm32_0(x)))
        x = self._resample(x)
        h = self.Conv_0(h)
        t = None
        if temb is not None:
            t = self.Dense_0(F.silu(temb))[:, :, None, None]
            if not self.scale_shift:
                h = h + t
        h = self.GroupNorm32_1(h)
        if t is not None and self.scale_shift:
            scale, shift = t.chunk(2, dim=1)
            h = h * (1 + scale) + shift
        h = self.Conv_1(F.silu(h))
        if self.skip_proj is not None:
            x = self.skip_proj(x)
        return x + h


class Attention(nn.Module):
    """Multi-head attention over tokens [B, S, C]; self- or cross-
    depending on `context`. The mask-free case goes to
    ops.flash.attention (the Hopper kernel on CUDA); the masked case is
    plain torch with a float32 softmax, as in the reference."""

    def __init__(self, query_dim: int, num_heads: int, head_dim: int, dtype,
                 context_dim: int | None = None, qkv_bias: bool = False,
                 device=None):
        super().__init__()
        inner = num_heads * head_dim
        ctx = query_dim if context_dim is None else context_dim
        kw = dict(dtype=dtype, device=device)
        self.to_q = nn.Linear(query_dim, inner, bias=qkv_bias, **kw)
        self.to_k = nn.Linear(ctx, inner, bias=qkv_bias, **kw)
        self.to_v = nn.Linear(ctx, inner, bias=qkv_bias, **kw)
        self.to_out = nn.Linear(inner, inner, **kw)
        self.num_heads, self.head_dim = num_heads, head_dim

    def forward(self, x: torch.Tensor, context: torch.Tensor | None = None,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        ctx = x if context is None else context

        def split(t):  # [B, S, inner] -> [B, H, S, D] (a strided view)
            b, s, _ = t.shape
            return t.view(b, s, self.num_heads, self.head_dim).transpose(1, 2)

        q, k, v = split(self.to_q(x)), split(self.to_k(ctx)), split(self.to_v(ctx))
        if mask is None:
            out = fused_attention(q, k, v)
        else:
            scale = 1.0 / math.sqrt(self.head_dim)
            logits = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
            probs = torch.softmax(logits + mask, dim=-1).to(q.dtype)
            out = torch.einsum("bhqk,bhkd->bhqd", probs, v)
        b, h, s, d = out.shape
        return self.to_out(out.transpose(1, 2).reshape(b, s, h * d))


class GEGLU(nn.Module):
    """Value and gate as two projections; the gate uses the exact erf
    gelu, as diffusers' GEGLU does."""

    def __init__(self, dim: int, dim_out: int, dtype, device=None):
        super().__init__()
        self.ff_val = nn.Linear(dim, dim_out, dtype=dtype, device=device)
        self.ff_gate = nn.Linear(dim, dim_out, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ff_val(x) * F.gelu(self.ff_gate(x))


class TransformerBlock(nn.Module):
    """LN->self-attn, LN->cross-attn, LN->GEGLU-FF, all residual; [B, S, C]."""

    def __init__(self, dim: int, num_heads: int, head_dim: int,
                 context_dim: int, dtype, device=None):
        super().__init__()
        for i in range(3):
            setattr(self, f"LayerNorm_{i}", LayerNorm32(dim, device=device))
        self.attn1 = Attention(dim, num_heads, head_dim, dtype, device=device)
        self.attn2 = Attention(dim, num_heads, head_dim, dtype,
                               context_dim=context_dim, device=device)
        self.ff = GEGLU(dim, dim * 4, dtype, device=device)
        self.ff_out = nn.Linear(dim * 4, dim, dtype=dtype, device=device)

    def _ln(self, i: int, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, f"LayerNorm_{i}")(x).to(x.dtype)

    def forward(self, x: torch.Tensor, context: torch.Tensor | None = None):
        x = x + self.attn1(self._ln(0, x))
        x = x + self.attn2(self._ln(1, x), context=context)
        return x + self.ff_out(self.ff(self._ln(2, x)))


class SpatialTransformer(nn.Module):
    """Transformer over the H*W tokens of an NCHW map, with 1x1 in/out
    projections. The pre-proj_in GroupNorm uses eps 1e-6, as diffusers'
    Transformer2DModel does."""

    def __init__(self, channels: int, num_heads: int, head_dim: int,
                 context_dim: int, dtype, depth: int = 1, device=None):
        super().__init__()
        self.GroupNorm32_0 = GroupNorm32(channels, 1e-6, device=device)
        self.proj_in = conv1x1(channels, channels, dtype, device)
        self.depth = depth
        for i in range(depth):
            setattr(self, f"block_{i}",
                    TransformerBlock(channels, num_heads, head_dim,
                                     context_dim, dtype, device=device))
        self.proj_out = conv1x1(channels, channels, dtype, device)

    def forward(self, x: torch.Tensor, context: torch.Tensor | None = None):
        b, c, h, w = x.shape
        residual = x
        x = self.proj_in(self.GroupNorm32_0(x))
        x = x.flatten(2).transpose(1, 2)                      # [B, HW, C]
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x, context)
        x = x.transpose(1, 2).reshape(b, c, h, w)
        return self.proj_out(x) + residual


class Downsample(nn.Module):
    def __init__(self, channels: int, dtype, device=None):
        super().__init__()
        self.Conv_0 = conv3x3(channels, channels, dtype, device, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Conv_0(x)


class Upsample(nn.Module):
    """Nearest x2 (each pixel repeated 2x2), then a 3x3 conv."""

    def __init__(self, channels: int, dtype, device=None):
        super().__init__()
        self.Conv_0 = conv3x3(channels, channels, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Conv_0(F.interpolate(x, scale_factor=2, mode="nearest"))
