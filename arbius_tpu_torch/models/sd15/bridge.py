"""Weights for the port's modules: from a JAX parameter tree, or a seeded
init of the same distributions. Shared by every family.

`params_from_jax` takes the reference's `init_params` tree as nested dicts
of numpy arrays (the caller converts; this module never imports JAX) and
returns a `state_dict` for the family's module bundle (`SD15Models`,
`Kandinsky2Models`, `Text2VideoModels`, `TextGenModel`, RVM's
`MattingStep`). The port's modules carry the flax names, so a key is the
flax path joined with '.', and only the leaves change:

  - Dense kernel [in, out]          -> Linear weight [out, in]
  - Conv kernel [kH, kW, I/g, O]    -> Conv2d weight [O, I/g, kH, kW]
    (a depthwise [kH, kW, 1, C] -> [C, 1, kH, kW])
  - frame-axis Conv kernel [3, I, O] (`FRAME_CONVS`) -> Conv3d weight
    [O, I, 3, 1, 1]
  - DenseGeneral q/k/v [W, H, D]    -> Linear weight [H*D, W]; bias [H, D] -> [H*D]
  - DenseGeneral out [H, D, W]      -> Linear weight [W, H*D]
  - GroupNorm/LayerNorm/RVM's BNInf `scale`, Embed `embedding` -> `weight`
  - any other parameter (`pos_embed`, BNInf's `mean` and `var`, the prior's rank-3 `pos_embed` and
    `prd_embed`, the top-level `prior_stats`) keeps its name and shape.

`quant_layout` names the leaves the reference quantizes in int8 and fp8
mode (`_eligible`: floating with ndim >= 2 in the flax tree) and, for
each, where `_convert` put its output axis (`quant.core.QuantAxis`):
dim 0 of a Linear or conv weight, and the last dim of every leaf it keeps
in flax's layout (Embed's `weight [V, W]`, `pos_embed`, the prior's
embeddings, `prior_stats`). The reference scales a DenseGeneral q/k/v
kernel `[W, H, D]` and its bias `[H, D]` per D, so their Linear weight
`[H*D, W]` and flattened bias `[H*D]` are viewed as `[H, D, W]` and
`[H, D]` with the axis on D. `load_weights` loads a state into the
modules in a precision mode.

`init_params` draws flax's default distributions for the same keys from
an explicit `torch.Generator` (lecun-normal kernels, zero biases and other
parameters, unit norm scales, embeddings normal(1/sqrt(width)), and
`EMBED_STD`'s positional and query embeddings normal(std)): random
weights at full width that keep a 20-step image finite.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from arbius_tpu_torch.models.sd15.text_encoder import SelfAttention
from arbius_tpu_torch.quant.core import (
    QuantAxis,
    QuantizedWeights,
    quantize_state,
)
from arbius_tpu_torch.quant.modes import DEFAULT_MODE


def _convert(path: tuple[str, ...], leaf: np.ndarray) -> tuple[str, np.ndarray]:
    name = path[-1]
    if name == "kernel":
        if leaf.ndim == 2:
            leaf = leaf.T
        elif leaf.ndim == 4:
            leaf = leaf.transpose(3, 2, 0, 1)
        elif leaf.ndim == 3 and path[-2] in FRAME_CONVS:
            leaf = leaf.transpose(2, 1, 0)[..., None, None]
        elif leaf.ndim == 3 and path[-2] == "out":
            leaf = leaf.reshape(-1, leaf.shape[-1]).T
        elif leaf.ndim == 3:
            leaf = leaf.reshape(leaf.shape[0], -1).T
        else:
            raise ValueError(f"unexpected kernel rank at {'/'.join(path)}")
        name = "weight"
    elif name == "bias" and leaf.ndim == 2:
        leaf = leaf.reshape(-1)
    elif name in ("scale", "embedding"):
        name = "weight"
    return ".".join(path[:-1] + (name,)), np.ascontiguousarray(leaf)


# the video UNet's frame-axis convs (TemporalConvLayer's four stages)
FRAME_CONVS = ("conv1", "conv2", "conv3", "conv4")


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """JAX parameter tree (nested dicts of numpy arrays) -> the port's
    state_dict (float32 CPU tensors)."""
    out: dict[str, torch.Tensor] = {}

    def walk(node, path):
        for key in sorted(node):
            val = node[key]
            if isinstance(val, dict):
                walk(val, path + (key,))
            else:
                name, arr = _convert(path + (key,), np.asarray(val))
                out[name] = torch.from_numpy(arr.astype(np.float32))

    walk(tree, ())
    return out


def quant_layout(models: nn.Module) -> dict[str, QuantAxis]:
    """The port keys whose flax leaves the reference quantizes, each
    with its output axis in the port's layout (`_convert` read
    backwards; tests/test_torch_quant.py holds the two together)."""
    out, heads = {}, {}
    for name, mod in models.named_modules():
        prefix = f"{name}." if name else ""
        for pname, p in mod.named_parameters(recurse=False):
            key = prefix + pname
            if isinstance(mod, (nn.Linear, nn.Conv2d, nn.Conv3d)):
                if pname == "weight":     # Dense/Conv kernel: O first
                    out[key] = QuantAxis(tuple(p.shape), 0)
            elif p.dim() >= 2:            # kept in flax's layout
                out[key] = QuantAxis(tuple(p.shape), p.dim() - 1)
        if isinstance(mod, SelfAttention):
            heads[prefix] = mod.heads
    # DenseGeneral q/k/v: kernel [W, H, D] and bias [H, D], scaled per D;
    # the port's [H*D, W] and [H*D] viewed as [H, D, ...]
    for prefix, h in heads.items():
        for child in ("query", "key", "value"):
            hd, width = out[f"{prefix}{child}.weight"].view
            out[f"{prefix}{child}.weight"] = QuantAxis((h, hd // h, width), 1)
            out[f"{prefix}{child}.bias"] = QuantAxis((h, hd // h), 1)
    return out


def load_weights(models: nn.Module, state: dict[str, torch.Tensor],
                 precision: str) -> QuantizedWeights | None:
    """Copy `state` into `models` (every key required). In bf16 linear
    and conv weights round to their compute dtype here, once, and None
    comes back; in int8 or fp8 the leaves of `quant_layout` are
    quantized here and stay resident in the returned QuantizedWeights."""
    if precision == DEFAULT_MODE:
        models.load_state_dict(state, strict=True)
        return None
    layout = quant_layout(models)
    return QuantizedWeights(models, quantize_state(state, precision, layout),
                            layout)


# flax's normal(std) initialisers, by state-dict key suffix (the first
# that matches): the prior's embeddings, then the text towers'
EMBED_STD = (("prior.pos_embed", 0.02), ("prior.prd_embed", 0.02),
             ("pos_embed", 0.01))


def _fan_in(shape: torch.Size) -> int:
    # Linear [out, in]; Conv2d [O, I, kH, kW]; Conv3d [O, I, 3, 1, 1]
    return math.prod(shape[1:])


@torch.no_grad()
def init_params(models: torch.nn.Module, seed: int,
                device: str | torch.device) -> dict[str, torch.Tensor]:
    """A state_dict for `models` drawn from flax's default initialisers,
    in float32 on `device`, from ``torch.Generator(device).manual_seed``.
    Draws follow the state_dict's key order, so a seed gives the same
    weights every time."""
    gen = torch.Generator(device=device).manual_seed(seed)
    # flax's lecun_normal: a normal truncated at +-2 std, rescaled so the
    # truncated distribution has variance 1/fan_in
    trunc_std = 0.87962566103423978
    out = {}
    for name, ref in models.state_dict().items():
        t = torch.empty(ref.shape, dtype=torch.float32, device=device)
        leaf = name.rsplit(".", 1)[-1]
        embed_std = next((s for suffix, s in EMBED_STD
                          if name.endswith(suffix)), None)
        if embed_std is not None:
            t.normal_(0.0, embed_std, generator=gen)
        elif name.endswith("token_embed.weight"):
            t.normal_(0.0, 1.0 / math.sqrt(ref.shape[1]), generator=gen)
        elif leaf == "weight" and ref.dim() >= 2:
            std = 1.0 / math.sqrt(_fan_in(ref.shape)) / trunc_std
            torch.nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                        generator=gen)
        elif leaf == "weight":
            t.fill_(1.0)
        else:
            t.zero_()
        out[name] = t
    return out
