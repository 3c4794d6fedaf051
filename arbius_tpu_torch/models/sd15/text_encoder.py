"""CLIP-style causal text transformer (SD-1.5's conditioning encoder).

Twin of arbius_tpu/models/sd15/text_encoder.py. ViT-L/14 text tower
topology: vocab 49408, 77 positions, width 768, 12 layers, 12 heads,
quick-gelu MLP, causal mask, final LayerNorm. `act="gelu"` gives the
exact erf gelu MLP of the OpenCLIP towers (Kandinsky-2's bigG text
tower).

The reference's `nn.SelfAttention` has biased query/key/value/out
projections (flax DenseGeneral kernels ``[W, heads, head_dim]`` and
``[heads, head_dim, W]``); here they are plain Linears over the flattened
heads. Its causal softmax is plain torch, as it is XLA (not Pallas) in the
reference, and it follows flax's order: scale q, mask with the dtype's
most negative value, softmax in the compute dtype.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from arbius_tpu_torch.models.common import LayerNorm32


@dataclass(frozen=True)
class TextEncoderConfig:
    vocab_size: int = 49408
    max_length: int = 77
    width: int = 768
    layers: int = 12
    heads: int = 12
    act: str = "quick_gelu"  # ViT-L towers; open_clip bigG towers use "gelu"
    dtype: str = "bfloat16"

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @classmethod
    def tiny(cls) -> "TextEncoderConfig":
        return cls(vocab_size=512, max_length=16, width=16, layers=1, heads=2)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class _SelfAttention(nn.Module):
    def __init__(self, width: int, heads: int, dtype, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.query = nn.Linear(width, width, **kw)
        self.key = nn.Linear(width, width, **kw)
        self.value = nn.Linear(width, width, **kw)
        self.out = nn.Linear(width, width, **kw)
        self.heads = heads

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, s, w = x.shape
        hd = w // self.heads
        q, k, v = (t.view(b, s, self.heads, hd)
                   for t in (self.query(x), self.key(x), self.value(x)))
        q = q / torch.tensor(np.sqrt(hd), dtype=torch.float32).to(q.dtype)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        logits = torch.where(mask, logits,
                             torch.finfo(logits.dtype).min)
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return self.out(out.reshape(b, s, w))


class _EncoderLayer(nn.Module):
    def __init__(self, cfg: TextEncoderConfig, device=None):
        super().__init__()
        dt = cfg.tdtype
        self.LayerNorm_0 = LayerNorm32(cfg.width, device=device)
        self.attn = _SelfAttention(cfg.width, cfg.heads, dt, device)
        self.LayerNorm_1 = LayerNorm32(cfg.width, device=device)
        self.Dense_0 = nn.Linear(cfg.width, cfg.width * 4, dtype=dt,
                                 device=device)
        self.Dense_1 = nn.Linear(cfg.width * 4, cfg.width, dtype=dt,
                                 device=device)
        self.act = quick_gelu if cfg.act == "quick_gelu" else F.gelu

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        h = self.LayerNorm_0(x).to(x.dtype)
        x = x + self.attn(h, mask)
        h = self.LayerNorm_1(x).to(x.dtype)
        return x + self.Dense_1(self.act(self.Dense_0(h)))


class TextEncoder(nn.Module):
    """forward(token_ids[B, L]) -> last hidden state [B, L, width] float32."""

    def __init__(self, config: TextEncoderConfig, device=None):
        super().__init__()
        cfg = self.config = config
        self.token_embed = nn.Embedding(cfg.vocab_size, cfg.width,
                                        dtype=cfg.tdtype, device=device)
        self.pos_embed = nn.Parameter(
            torch.zeros(cfg.max_length, cfg.width, device=device))
        for i in range(cfg.layers):
            setattr(self, f"layer_{i}", _EncoderLayer(cfg, device))
        self.final_norm = LayerNorm32(cfg.width, device=device)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        length = ids.shape[1]
        x = self.token_embed(ids) + self.pos_embed[None, :length].to(cfg.tdtype)
        causal = torch.ones(length, length, dtype=torch.bool,
                            device=ids.device).tril()[None, None]
        for i in range(cfg.layers):
            x = getattr(self, f"layer_{i}")(x, causal)
        return self.final_norm(x)
