"""Decoder-only text transformer with an explicit KV-cache API, in PyTorch.

Twin of arbius_tpu/models/textgen/model.py: token + learned position
embeddings, pre-LayerNorm attention/MLP blocks, a final float32 LayerNorm
and a float32 logits head, with the reference's split API:

  * `prefill(ids, total)`: one dense causal pass over the padded prompt
    bucket; the last position's logits plus per-layer K/V caches of
    length `total` (prompt bucket + decode bucket), prompt rows filled
    and the rest zero;
  * `decode(tok, kv, pos)`: one step; embeds the token at `pos`, writes
    its K/V row into the caches IN PLACE (the reference's
    `dynamic_update_slice` returns new caches; `pos` is a Python int
    here, so a captured CUDA graph holds every step's write), attends
    over positions <= pos and returns the next position's logits.

Precisions are the reference's one for one: the Dense layers compute in
the compute dtype (their weights are stored in it, which rounds once what
flax rounds at every use), the LayerNorms are `LayerNorm32` (flax's
arithmetic, float32 out), gelu is the exact erf form, attention logits
and softmax are float32 (softmax as jax.nn.softmax writes it: exp(x -
max) / sum) with the probabilities cast to the compute dtype before P·V,
masked logits are -1e30, the token embedding plus `pos_embed` is summed
in the compute dtype, and `lm_head` is float32. Caches are [B, S, H, D]
as in the reference, so the bridge transposes nothing there.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from arbius_tpu_torch.models.common import LayerNorm32

# additive mask value: large-negative float32, finite so a fully masked
# row still normalises (the reference's convention)
_NEG = -1e30


@dataclass(frozen=True)
class TextGenConfig:
    # the byte tokenizer's ids (0..255 bytes, bos 257, eos 258) with room
    vocab_size: int = 512
    # must cover max(prompt_buckets) + max(decode_buckets)
    max_positions: int = 128
    width: int = 64
    layers: int = 2
    heads: int = 2
    dtype: str = "bfloat16"

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def head_dim(self) -> int:
        return self.width // self.heads

    def __post_init__(self):
        if self.width % self.heads:
            raise ValueError(
                f"width ({self.width}) must be divisible by heads "
                f"({self.heads})")

    @classmethod
    def tiny(cls) -> "TextGenConfig":
        return cls(vocab_size=512, max_positions=96, width=16,
                   layers=1, heads=2)


def softmax32(logits: torch.Tensor) -> torch.Tensor:
    """jax.nn.softmax over the last axis: exp(x - max) / sum(exp(x - max))."""
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


class DecoderBlock(nn.Module):
    """Pre-LN attention + MLP block; `prefill` and `decode` share its
    parameters (the reference's `_DecoderBlock`)."""

    def __init__(self, cfg: TextGenConfig, device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=cfg.tdtype, device=device)
        w = cfg.width
        self.ln1 = LayerNorm32(w, device=device)
        self.wq = nn.Linear(w, w, **kw)
        self.wk = nn.Linear(w, w, **kw)
        self.wv = nn.Linear(w, w, **kw)
        self.wo = nn.Linear(w, w, **kw)
        self.ln2 = LayerNorm32(w, device=device)
        self.mlp_up = nn.Linear(w, 4 * w, **kw)
        self.mlp_down = nn.Linear(4 * w, w, **kw)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(*x.shape[:-1], self.cfg.heads, self.cfg.head_dim)

    def _mlp(self, x: torch.Tensor) -> torch.Tensor:
        h = self.ln2(x).to(self.cfg.tdtype)
        return x + self.mlp_down(F.gelu(self.mlp_up(h)))

    def prefill(self, x: torch.Tensor):
        """x [B, P, W] -> (x' [B, P, W], k [B, P, H, D], v [B, P, H, D])."""
        cfg = self.cfg
        h = self.ln1(x).to(cfg.tdtype)
        q = self._split(self.wq(h))
        k = self._split(self.wk(h))
        v = self._split(self.wv(h))
        # bphd,bmhd->bhpm in float32
        logits = torch.matmul(q.float().permute(0, 2, 1, 3),
                              k.float().permute(0, 2, 3, 1)) \
            * cfg.head_dim ** -0.5
        p = x.shape[1]
        causal = torch.ones(p, p, dtype=torch.bool, device=x.device).tril()
        logits = logits.masked_fill(~causal, _NEG)
        att = softmax32(logits).to(cfg.tdtype)
        o = torch.matmul(att, v.permute(0, 2, 1, 3))      # [B, H, P, D]
        o = o.permute(0, 2, 1, 3).reshape(*x.shape[:2], cfg.width)
        x = x + self.wo(o)
        return self._mlp(x), k, v

    def decode(self, x: torch.Tensor, k_cache: torch.Tensor,
               v_cache: torch.Tensor, pos: int) -> torch.Tensor:
        """One step: x [B, W] is the token at `pos`; its K/V row goes
        into the caches [B, S, H, D] in place, and attention reads
        positions <= pos."""
        cfg = self.cfg
        h = self.ln1(x).to(cfg.tdtype)
        q = self._split(self.wq(h))                       # [B, H, D]
        k_cache[:, pos] = self._split(self.wk(h)).to(k_cache.dtype)
        v_cache[:, pos] = self._split(self.wv(h)).to(v_cache.dtype)
        # bhd,bshd->bhs in float32
        logits = torch.matmul(q.float()[:, :, None, :],
                              k_cache.float().permute(0, 2, 3, 1))[:, :, 0]
        logits = logits * cfg.head_dim ** -0.5
        logits[..., pos + 1:] = _NEG
        att = softmax32(logits).to(cfg.tdtype)
        # bhs,bshd->bhd
        o = torch.matmul(att[:, :, None, :],
                         v_cache.to(cfg.tdtype).permute(0, 2, 1, 3))[:, :, 0]
        x = x + self.wo(o.reshape(o.shape[0], cfg.width))
        return self._mlp(x)


class TextGenModel(nn.Module):
    """Decoder-only LM under the reference tree's names (`token_embed`,
    `pos_embed`, `layer_{i}`, `final_norm`, `lm_head`)."""

    def __init__(self, config: TextGenConfig, device=None):
        super().__init__()
        cfg = self.config = config
        self.token_embed = nn.Embedding(cfg.vocab_size, cfg.width,
                                        dtype=cfg.tdtype, device=device)
        self.pos_embed = nn.Parameter(torch.zeros(
            cfg.max_positions, cfg.width, device=device))
        for i in range(cfg.layers):
            setattr(self, f"layer_{i}", DecoderBlock(cfg, device))
        self.final_norm = LayerNorm32(cfg.width, device=device)
        # float32 head: sampling compares logits at full precision
        self.lm_head = nn.Linear(cfg.width, cfg.vocab_size,
                                 dtype=torch.float32, device=device)

    def blocks(self) -> list[DecoderBlock]:
        return [getattr(self, f"layer_{i}") for i in range(self.config.layers)]

    def prefill(self, ids: torch.Tensor, total: int):
        """ids [B, P] -> (logits [B, V] float32 at the last prompt
        position, ((k, v), ...) caches [B, total, H, D] with rows 0..P-1
        filled, the rest zero)."""
        cfg = self.config
        p = ids.shape[1]
        x = self.token_embed(ids) + self.pos_embed[None, :p].to(cfg.tdtype)
        kv = []
        for blk in self.blocks():
            x, k, v = blk.prefill(x)
            kc = k.new_zeros(k.shape[0], total, *k.shape[2:])
            vc = v.new_zeros(v.shape[0], total, *v.shape[2:])
            kc[:, :p] = k
            vc[:, :p] = v
            kv.append((kc, vc))
        x = self.final_norm(x[:, -1])
        return self.lm_head(x.float()), tuple(kv)

    def decode(self, tok: torch.Tensor, kv, pos: int) -> torch.Tensor:
        """tok [B] at position `pos` -> logits [B, V] float32 for the next
        position; the caches `kv` take this position's rows in place."""
        cfg = self.config
        x = self.token_embed(tok) + self.pos_embed[pos].to(cfg.tdtype)
        for blk, (k, v) in zip(self.blocks(), kv):
            x = blk.decode(x, k, v, pos)
        x = self.final_norm(x)
        return self.lm_head(x.float())
