"""Checkpoint conversion: published text-to-video state dicts → param trees.

The reference mines zeroscopev2xl / damo through cog containers wrapping
the published weights (`templates/zeroscopev2xl.json`, `templates/
damo.json`). Both distributions are the diffusers layout — the ModelScope
`UNet3DConditionModel` (zeroscope v2 is a fine-tune of the same topology),
a standard `AutoencoderKL` VAE, and a CLIP text tower — so this module
maps that key space onto `models/video/unet3d.py`'s flax tree. The VAE
and text towers reuse sd15's converters verbatim: the published video
repos use the identical diffusers/CLIP naming, just other widths (1024-d
ViT-H-class text).

Same contract as sd15/convert.py (the family template): flat
`{key: numpy array}` in, completeness enforced, shape mismatches loud,
bijectivity tested in tests/test_video_convert.py. Numeric validation
against live published weights is a deployment-time step (zero egress) —
the boot self-test's golden CID is the final arbiter either way.
"""
from __future__ import annotations

import re

import numpy as np

from arbius_tpu_torch.models.sd15.convert import (
    _GEGLU_LEAVES,
    ConversionError,
    _conv,
    _convert_tree,
    _geglu_gate,
    _geglu_gate_b,
    _geglu_val,
    _geglu_val_b,
    _ident,
    _leaves,
    _linear,
    _unet_block_prefix,
    unet_key_for,
)
from arbius_tpu_torch.models.sd15.convert import (
    convert_sd15_text as convert_video_text,
)
from arbius_tpu_torch.models.sd15.convert import (
    convert_sd15_vae as convert_video_vae,
)

__all__ = ["convert_unet3d", "unet3d_key_for", "convert_video_vae",
           "convert_video_text", "export_tree"]


def _tconv3d(w):
    """torch Conv3d (3,1,1) kernel [O, I, 3, 1, 1] → flax frame-axis conv
    [3, I, O]."""
    w = np.asarray(w)[:, :, :, 0, 0]
    return np.ascontiguousarray(np.transpose(w, (2, 1, 0)))


def _proj_flex(w):
    """Spatial-transformer proj_in/out: published repos ship either a 1×1
    Conv2d [O, I, 1, 1] or (use_linear_projection) a Linear [O, I] —
    accept both into the flax 1×1-conv kernel [1, 1, I, O]."""
    w = np.asarray(w)
    if w.ndim == 2:
        w = w[:, :, None, None]
    return _conv(w)


# TemporalConvLayer: conv1 = Sequential(GN, SiLU, Conv3d) → .0/.2;
# conv2..4 = Sequential(GN, SiLU, Dropout, Conv3d) → .0/.3
def _tconv_leaf(rest: str):
    m = re.match(r"conv([1-4])_norm/GroupNorm_0/(scale|bias)$", rest)
    if m:
        leaf = "weight" if m.group(2) == "scale" else "bias"
        return f"conv{m.group(1)}.0.{leaf}", _ident
    m = re.match(r"conv([1-4])/(kernel|bias)$", rest)
    if m:
        conv_idx = 2 if m.group(1) == "1" else 3
        if m.group(2) == "kernel":
            return f"conv{m.group(1)}.{conv_idx}.weight", _tconv3d
        return f"conv{m.group(1)}.{conv_idx}.bias", _ident
    return None


# TemporalTransformerBlock (BasicTransformerBlock, double self-attention)
_TEMPORAL_BLOCK = {
    "norm1/scale": ("norm1.weight", _ident),
    "norm1/bias": ("norm1.bias", _ident),
    "norm2/scale": ("norm2.weight", _ident),
    "norm2/bias": ("norm2.bias", _ident),
    "norm3/scale": ("norm3.weight", _ident),
    "norm3/bias": ("norm3.bias", _ident),
    "attn1/to_q/kernel": ("attn1.to_q.weight", _linear),
    "attn1/to_k/kernel": ("attn1.to_k.weight", _linear),
    "attn1/to_v/kernel": ("attn1.to_v.weight", _linear),
    "attn1/to_out/kernel": ("attn1.to_out.0.weight", _linear),
    "attn1/to_out/bias": ("attn1.to_out.0.bias", _ident),
    "attn2/to_q/kernel": ("attn2.to_q.weight", _linear),
    "attn2/to_k/kernel": ("attn2.to_k.weight", _linear),
    "attn2/to_v/kernel": ("attn2.to_v.weight", _linear),
    "attn2/to_out/kernel": ("attn2.to_out.0.weight", _linear),
    "attn2/to_out/bias": ("attn2.to_out.0.bias", _ident),
    "ff_out/kernel": ("ff.net.2.weight", _linear),
    "ff_out/bias": ("ff.net.2.bias", _ident),
}


def _tattn_leaf(rest: str):
    """TransformerTemporalModel leaves under a temp_attentions prefix."""
    if rest == "norm/GroupNorm_0/scale":
        return "norm.weight", _ident
    if rest == "norm/GroupNorm_0/bias":
        return "norm.bias", _ident
    for proj in ("proj_in", "proj_out"):
        if rest == f"{proj}/kernel":
            return f"{proj}.weight", _linear
        if rest == f"{proj}/bias":
            return f"{proj}.bias", _ident
    m = re.match(r"block_(\d+)/(.+)$", rest)
    if m:
        tb = f"transformer_blocks.{m.group(1)}"
        leaf = _TEMPORAL_BLOCK.get(m.group(2)) or _GEGLU_LEAVES.get(
            m.group(2))
        if leaf:
            return f"{tb}.{leaf[0]}", leaf[1]
    return None


def _temporal_block_prefix(part: str, n_levels: int) -> str | None:
    """our 'down_2_tconv_1' style prefix -> diffusers temporal prefix."""
    m = re.match(r"down_(\d+)_tconv_(\d+)$", part)
    if m:
        return f"down_blocks.{m.group(1)}.temp_convs.{m.group(2)}"
    m = re.match(r"down_(\d+)_tattn_(\d+)$", part)
    if m:
        return f"down_blocks.{m.group(1)}.temp_attentions.{m.group(2)}"
    m = re.match(r"up_(\d+)_tconv_(\d+)$", part)
    if m:
        return (f"up_blocks.{n_levels - 1 - int(m.group(1))}"
                f".temp_convs.{m.group(2)}")
    m = re.match(r"up_(\d+)_tattn_(\d+)$", part)
    if m:
        return (f"up_blocks.{n_levels - 1 - int(m.group(1))}"
                f".temp_attentions.{m.group(2)}")
    m = re.match(r"mid_tconv_(\d+)$", part)
    if m:
        return f"mid_block.temp_convs.{m.group(1)}"
    if part == "mid_tattn":
        return "mid_block.temp_attentions.0"
    if part == "transformer_in":
        return "transformer_in"
    return None


def unet3d_key_for(path: str, n_levels: int = 4):
    """our flax path (joined with /) -> (diffusers key, transform).

    Temporal paths map here; everything else (conv_in/out, time embedding,
    resnets, spatial attentions, up/down samplers) is the 2D key space and
    delegates to sd15's unet_key_for."""
    part, _, rest = path.partition("/")
    prefix = _temporal_block_prefix(part, n_levels)
    if prefix is not None:
        if "tconv" in part:
            leaf = _tconv_leaf(rest)
        else:
            leaf = _tattn_leaf(rest)
        if leaf is None:
            raise ConversionError(f"unmapped temporal leaf {path!r}")
        return f"{prefix}.{leaf[0]}", leaf[1]
    key, tf = unet_key_for(path, n_levels)
    if tf is _conv and key.rsplit(".", 1)[0].endswith(("proj_in",
                                                       "proj_out")):
        return key, _proj_flex
    return key, tf


def convert_unet3d(state_dict: dict, template_params: dict,
                   n_levels: int = 4) -> dict:
    """Published UNet3DConditionModel state dict → UNet3DCondition tree."""
    return _convert_tree(template_params, state_dict,
                         lambda p: unet3d_key_for(p, n_levels))


def export_tree(params: dict, n_levels: int = 4) -> dict:
    """ours → published naming, inverting the leaf transforms (GEGLU
    halves re-fused; test round-trip + fixture fabrication)."""
    out: dict[str, np.ndarray] = {}
    fuse: dict[str, dict[str, np.ndarray]] = {}

    for parts, leaf in _leaves(params):
        key, tf = unet3d_key_for("/".join(parts), n_levels)
        w = np.asarray(leaf)
        if tf is _conv or tf is _proj_flex:
            out[key] = np.transpose(w, (3, 2, 0, 1))
        elif tf is _tconv3d:
            out[key] = np.transpose(w, (2, 1, 0))[:, :, :, None, None]
        elif tf is _linear:
            out[key] = np.transpose(w)
        elif tf in (_geglu_val, _geglu_gate):
            half = "val" if tf is _geglu_val else "gate"
            fuse.setdefault(key, {})[half] = np.transpose(w)
        elif tf in (_geglu_val_b, _geglu_gate_b):
            half = "val" if tf is _geglu_val_b else "gate"
            fuse.setdefault(key, {})[half] = w
        else:
            out[key] = w

    for key, halves in fuse.items():
        out[key] = np.concatenate([halves["val"], halves["gate"]], axis=0)
    return out
