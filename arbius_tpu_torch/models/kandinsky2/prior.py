"""Kandinsky-2 diffusion prior: text embedding -> CLIP-image embedding.

Twin of arbius_tpu/models/kandinsky2/prior.py. The graph is the
published diffusers `PriorTransformer`'s:

  token sequence = [ projected text states (text_len),
                     projected pooled text embed (1),
                     time embedding (1),
                     projected noisy image embed (1),
                     learned prd query token (1) ]  + positional embedding
  -> pre-LN transformer blocks (biased attention, exact-gelu FF)
  -> final LayerNorm -> clip-embedding readout at the prd position.

The prior works in a normalised clip space; `prior_sample` de-normalises
its result with the checkpoint's [mean; std] rows. Its attention takes
the additive text mask, so it is the plain float32-softmax path of
models/common.py's `Attention`, as in the reference (no flash kernel).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from arbius_tpu_torch import random as jrandom
from arbius_tpu_torch.models.common import Attention, sinusoidal_embedding

NEG_INF = -1e9
PRIOR_NOISE_FOLD = 0x9A10   # fold_in constant of the prior's initial noise


@dataclass(frozen=True)
class PriorConfig:
    clip_dim: int = 1280          # image-embedding dimensionality (bigG)
    width: int = 2048             # heads * head_dim
    layers: int = 20
    heads: int = 32
    text_len: int = 77
    dtype: str = "bfloat16"

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @classmethod
    def tiny(cls) -> "PriorConfig":
        return cls(clip_dim=16, width=32, layers=2, heads=2, text_len=8)


def _ln(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """A float32 LayerNorm, back in x's dtype."""
    return norm(x.float()).to(x.dtype)


class PriorBlock(nn.Module):
    """Pre-LN self-attention (biased projections) + exact-gelu MLP."""

    def __init__(self, width: int, heads: int, dtype, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.norm1 = nn.LayerNorm(width, eps=1e-5, device=device)
        self.attn1 = Attention(width, heads, width // heads, dtype,
                               qkv_bias=True, device=device)
        self.norm3 = nn.LayerNorm(width, eps=1e-5, device=device)
        self.ff_in = nn.Linear(width, width * 4, **kw)
        self.ff_out = nn.Linear(width * 4, width, **kw)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None):
        x = x + self.attn1(_ln(self.norm1, x), mask=mask)
        return x + self.ff_out(F.gelu(self.ff_in(_ln(self.norm3, x))))


class PriorTransformer(nn.Module):
    """forward(noisy_embed[B,D], t[B], text_tokens[B,L,C],
    text_pooled[B,C], text_mask[B,L] or None) -> x0 prediction [B, D]
    float32."""

    def __init__(self, config: PriorConfig, text_dim: int, device=None):
        super().__init__()
        cfg = self.config = config
        w, dt = cfg.width, cfg.tdtype
        kw = dict(dtype=dt, device=device)
        self.time_linear_1 = nn.Linear(w, w, **kw)
        self.time_linear_2 = nn.Linear(w, w, **kw)
        self.text_proj = nn.Linear(text_dim, w, **kw)
        self.pooled_proj = nn.Linear(cfg.clip_dim, w, **kw)
        self.embed_proj = nn.Linear(cfg.clip_dim, w, **kw)
        self.prd_embed = nn.Parameter(torch.zeros(1, 1, w, device=device))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, cfg.text_len + 4, w, device=device))
        for i in range(cfg.layers):
            setattr(self, f"block_{i}", PriorBlock(w, cfg.heads, dt, device))
        self.norm_out = nn.LayerNorm(w, eps=1e-5, device=device)
        self.out_proj = nn.Linear(w, cfg.clip_dim, device=device)

    def forward(self, noisy_embed, t, text_tokens, text_pooled,
                text_mask=None) -> torch.Tensor:
        cfg = self.config
        dt = cfg.tdtype
        b = noisy_embed.shape[0]
        # flip_sin_to_cos: the [cos, sin] layout of the published prior
        temb = self.time_linear_1(sinusoidal_embedding(t, cfg.width).to(dt))
        temb = self.time_linear_2(F.silu(temb))
        seq = torch.cat([
            self.text_proj(text_tokens.to(dt)),
            self.pooled_proj(text_pooled.to(dt))[:, None],
            temb[:, None],
            self.embed_proj(noisy_embed.to(dt))[:, None],
            self.prd_embed.to(dt).expand(b, 1, cfg.width),
        ], dim=1)
        seq = seq + self.pos_embed.to(dt)
        mask = None
        if text_mask is not None:
            # the four appended slots are always valid keys
            full = torch.cat([text_mask.float(),
                              text_mask.new_ones(b, 4, dtype=torch.float32)],
                             dim=1)
            mask = (1.0 - full)[:, None, None, :] * NEG_INF   # [B,1,1,S]
        for i in range(cfg.layers):
            seq = getattr(self, f"block_{i}")(seq, mask)
        return self.out_proj(self.norm_out(seq[:, -1].float()))


def prior_stats_init(clip_dim: int, device=None) -> torch.Tensor:
    """[clip_mean; clip_std] of the seeded init: mean 0, std 1 (a real
    checkpoint carries its own)."""
    return torch.stack([torch.zeros(clip_dim, device=device),
                        torch.ones(clip_dim, device=device)])


def prior_abar(steps: int) -> tuple[np.ndarray, np.ndarray]:
    """(timesteps, cosine alpha-bar) of the prior's DDIM loop: float64
    numpy math cast to float32, as the reference computes them."""
    ts = np.linspace(999, 0, steps, dtype=np.float64)
    abar = np.cos((ts / 1000 + 0.008) / 1.008 * np.pi / 2) ** 2
    return ts.astype(np.float32), abar.astype(np.float32)


@torch.no_grad()
def prior_sample(model: PriorTransformer, text_tokens, text_pooled, keys,
                 guidance, *, steps: int = 25, text_mask=None,
                 clip_stats=None) -> torch.Tensor:
    """Deterministic DDIM (eta 0) x0-prediction sampling of the embedding.

    `keys` [B, 2] are the tasks' threefry keys; the initial noise is
    normal(fold_in(key, 0x9A10)). Classifier-free guidance runs as one
    doubled batch, the unconditional half first, with a zeroed text
    context and an all-valid mask. `clip_stats` [2, D] (mean row 0, std
    row 1) de-normalises the result when given."""
    b, d = text_pooled.shape[0], model.config.clip_dim
    ts, abar = prior_abar(steps)
    x = jrandom.normal(jrandom.fold_in(keys, PRIOR_NOISE_FOLD), (d,))
    g = guidance.float()[:, None]
    tok2 = torch.cat([torch.zeros_like(text_tokens), text_tokens])
    pool2 = torch.cat([torch.zeros_like(text_pooled), text_pooled])
    mask2 = None
    if text_mask is not None:
        mask2 = torch.cat([torch.ones_like(text_mask), text_mask])
    one = np.float32(1.0)
    for i in range(steps):
        t = torch.full((2 * b,), float(ts[i]), device=x.device)
        x0_u, x0_c = model(torch.cat([x, x]), t, tok2, pool2,
                           mask2).chunk(2)
        x0 = x0_u + g * (x0_c - x0_u)
        a_t = abar[i]
        a_prev = abar[i + 1] if i + 1 < steps else one
        eps = (x - float(np.sqrt(a_t)) * x0) / float(np.sqrt(one - a_t))
        x = float(np.sqrt(a_prev)) * x0 + float(np.sqrt(one - a_prev)) * eps
    if clip_stats is not None:
        x = x * clip_stats[1][None, :].float() + clip_stats[0][None, :].float()
    return x
