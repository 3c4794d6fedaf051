"""Checkpoint conversion: published Kandinsky-2 state dicts → param trees.

The reference mines kandinsky2 through a cog container wrapping the
published Kandinsky-2 weights (`templates/kandinsky2.json` pins the repo;
`miner/src/index.ts:844-877` is the invocation). This module maps the
diffusers-format distribution of those weights — prior `PriorTransformer`,
decoder `UNet2DConditionModel` (image-conditioned), MOVQ `VQModel`
(norm_type="spatial"), and the CLIP text tower `*WithProjection` — onto
this framework's flax trees, so the same weights drive the TPU path.

Same contract as sd15/convert.py (the family template): input is a flat
`{key: numpy array}` dict; completeness is enforced (every target leaf
must be produced; shape mismatches fail loudly); bijectivity
(ours → published naming → ours) is tested in
tests/test_kandinsky_convert.py. Numeric validation against a live
reference pipeline needs real weights and is a deployment-time step —
the boot self-test's golden CID is the final arbiter either way.
"""
from __future__ import annotations

import re

import numpy as np

from arbius_tpu_torch.models.sd15.convert import (
    _RESNET_LEAVES,
    ConversionError,
    _conv,
    _convert_tree,
    _ident,
    _leaves,
    _linear,
)

__all__ = [
    "convert_kandinsky2_prior",
    "convert_kandinsky2_decoder",
    "convert_kandinsky2_movq",
    "convert_kandinsky2_text_projection",
    "prior_key_for",
    "decoder_key_for",
    "movq_key_for",
]


# -- prior -----------------------------------------------------------------

_PRIOR_SIMPLE = {
    "time_linear_1/kernel": ("time_embedding.linear_1.weight", _linear),
    "time_linear_1/bias": ("time_embedding.linear_1.bias", _ident),
    "time_linear_2/kernel": ("time_embedding.linear_2.weight", _linear),
    "time_linear_2/bias": ("time_embedding.linear_2.bias", _ident),
    "embed_proj/kernel": ("proj_in.weight", _linear),
    "embed_proj/bias": ("proj_in.bias", _ident),
    "pooled_proj/kernel": ("embedding_proj.weight", _linear),
    "pooled_proj/bias": ("embedding_proj.bias", _ident),
    "text_proj/kernel": ("encoder_hidden_states_proj.weight", _linear),
    "text_proj/bias": ("encoder_hidden_states_proj.bias", _ident),
    "pos_embed": ("positional_embedding", _ident),
    "prd_embed": ("prd_embedding", _ident),
    "norm_out/scale": ("norm_out.weight", _ident),
    "norm_out/bias": ("norm_out.bias", _ident),
    "out_proj/kernel": ("proj_to_clip_embeddings.weight", _linear),
    "out_proj/bias": ("proj_to_clip_embeddings.bias", _ident),
}

_PRIOR_BLOCK = {
    "norm1/scale": ("norm1.weight", _ident),
    "norm1/bias": ("norm1.bias", _ident),
    "norm3/scale": ("norm3.weight", _ident),
    "norm3/bias": ("norm3.bias", _ident),
    "attn1/to_q/kernel": ("attn1.to_q.weight", _linear),
    "attn1/to_q/bias": ("attn1.to_q.bias", _ident),
    "attn1/to_k/kernel": ("attn1.to_k.weight", _linear),
    "attn1/to_k/bias": ("attn1.to_k.bias", _ident),
    "attn1/to_v/kernel": ("attn1.to_v.weight", _linear),
    "attn1/to_v/bias": ("attn1.to_v.bias", _ident),
    "attn1/to_out/kernel": ("attn1.to_out.0.weight", _linear),
    "attn1/to_out/bias": ("attn1.to_out.0.bias", _ident),
    "ff_in/kernel": ("ff.net.0.proj.weight", _linear),
    "ff_in/bias": ("ff.net.0.proj.bias", _ident),
    "ff_out/kernel": ("ff.net.2.weight", _linear),
    "ff_out/bias": ("ff.net.2.bias", _ident),
}


def prior_key_for(path: str):
    """our PriorTransformer path -> (published PriorTransformer key, tf)."""
    leaf = _PRIOR_SIMPLE.get(path)
    if leaf:
        return leaf
    m = re.match(r"block_(\d+)/(.+)$", path)
    if m:
        leaf = _PRIOR_BLOCK.get(m.group(2))
        if leaf:
            return f"transformer_blocks.{m.group(1)}.{leaf[0]}", leaf[1]
    raise ConversionError(f"unmapped prior path {path!r}")


def convert_kandinsky2_prior(state_dict: dict, template_params: dict
                             ) -> tuple[dict, np.ndarray]:
    """published prior state dict → (our prior tree, clip stats [2, D]).

    The stats row order is (clip_mean, clip_std) — the layout
    `prior_stats_init` establishes and `prior_sample` de-normalizes with.
    """
    tree = _convert_tree(template_params, state_dict, prior_key_for)
    for k in ("clip_mean", "clip_std"):
        if k not in state_dict:
            raise ConversionError(f"prior state dict missing {k!r}")
    stats = np.stack([np.asarray(state_dict["clip_mean"]).reshape(-1),
                      np.asarray(state_dict["clip_std"]).reshape(-1)])
    return tree, stats


# -- decoder ---------------------------------------------------------------

_ADDED_KV_ATTN = {
    "group_norm/GroupNorm_0/scale": ("group_norm.weight", _ident),
    "group_norm/GroupNorm_0/bias": ("group_norm.bias", _ident),
    "to_q/kernel": ("to_q.weight", _linear),
    "to_q/bias": ("to_q.bias", _ident),
    "to_k/kernel": ("to_k.weight", _linear),
    "to_k/bias": ("to_k.bias", _ident),
    "to_v/kernel": ("to_v.weight", _linear),
    "to_v/bias": ("to_v.bias", _ident),
    "add_k_proj/kernel": ("add_k_proj.weight", _linear),
    "add_k_proj/bias": ("add_k_proj.bias", _ident),
    "add_v_proj/kernel": ("add_v_proj.weight", _linear),
    "add_v_proj/bias": ("add_v_proj.bias", _ident),
    "to_out/kernel": ("to_out.0.weight", _linear),
    "to_out/bias": ("to_out.0.bias", _ident),
}


def kandinsky_unet_key_for(path: str, n_levels: int = 4):
    """our KandinskyUNet path -> (published unCLIP-style UNet key, tf).

    Resnets (including the resnet-based down/upsamplers) reuse the shared
    resnet leaf table; attention is the added-KV single-layer form."""
    simple = {
        "conv_in/kernel": ("conv_in.weight", _conv),
        "conv_in/bias": ("conv_in.bias", _ident),
        "conv_out/kernel": ("conv_out.weight", _conv),
        "conv_out/bias": ("conv_out.bias", _ident),
        "norm_out/GroupNorm_0/scale": ("conv_norm_out.weight", _ident),
        "norm_out/GroupNorm_0/bias": ("conv_norm_out.bias", _ident),
    }
    if path in simple:
        return simple[path]
    m = re.match(r"TimestepEmbedding_0/Dense_(\d)/(kernel|bias)$", path)
    if m:
        which = "linear_1" if m.group(1) == "0" else "linear_2"
        tf = _linear if m.group(2) == "kernel" else _ident
        return f"time_embedding.{which}.{'weight' if m.group(2) == 'kernel' else 'bias'}", tf
    part, _, rest = path.partition("/")

    def res(prefix):
        leaf = _RESNET_LEAVES.get(rest)
        if leaf is None:
            raise ConversionError(f"unmapped kandinsky unet path {path!r}")
        return f"{prefix}.{leaf[0]}", leaf[1]

    def attn(prefix):
        leaf = _ADDED_KV_ATTN.get(rest)
        if leaf is None:
            raise ConversionError(f"unmapped kandinsky unet path {path!r}")
        return f"{prefix}.{leaf[0]}", leaf[1]

    m = re.match(r"down_(\d+)_res_(\d+)$", part)
    if m:
        return res(f"down_blocks.{m.group(1)}.resnets.{m.group(2)}")
    m = re.match(r"down_(\d+)_attn_(\d+)$", part)
    if m:
        return attn(f"down_blocks.{m.group(1)}.attentions.{m.group(2)}")
    m = re.match(r"down_(\d+)_ds$", part)
    if m:
        return res(f"down_blocks.{m.group(1)}.downsamplers.0")
    m = re.match(r"up_(\d+)_res_(\d+)$", part)
    if m:
        return res(f"up_blocks.{n_levels - 1 - int(m.group(1))}"
                   f".resnets.{m.group(2)}")
    m = re.match(r"up_(\d+)_attn_(\d+)$", part)
    if m:
        return attn(f"up_blocks.{n_levels - 1 - int(m.group(1))}"
                    f".attentions.{m.group(2)}")
    m = re.match(r"up_(\d+)_us$", part)
    if m:
        return res(f"up_blocks.{n_levels - 1 - int(m.group(1))}"
                   ".upsamplers.0")
    if part == "mid_res_0":
        return res("mid_block.resnets.0")
    if part == "mid_res_1":
        return res("mid_block.resnets.1")
    if part == "mid_attn":
        return attn("mid_block.attentions.0")
    raise ConversionError(f"unmapped kandinsky unet path {path!r}")


_DECODER_HEAD = {
    "embed_to_context/kernel": ("encoder_hid_proj.image_embeds.weight", _linear),
    "embed_to_context/bias": ("encoder_hid_proj.image_embeds.bias", _ident),
    "context_norm/scale": ("encoder_hid_proj.norm.weight", _ident),
    "context_norm/bias": ("encoder_hid_proj.norm.bias", _ident),
    "add_linear_1/kernel": ("add_embedding.linear_1.weight", _linear),
    "add_linear_1/bias": ("add_embedding.linear_1.bias", _ident),
    "add_linear_2/kernel": ("add_embedding.linear_2.weight", _linear),
    "add_linear_2/bias": ("add_embedding.linear_2.bias", _ident),
}


def decoder_key_for(path: str, n_levels: int = 4):
    """our DecoderUNet path -> (published image-conditioned UNet key, tf).

    The conditioning head maps to ImageProjection/add_embedding; the inner
    `unet/` scope is the unCLIP-style UNet (`kandinsky_unet_key_for`)."""
    leaf = _DECODER_HEAD.get(path)
    if leaf:
        return leaf
    if path.startswith("unet/"):
        return kandinsky_unet_key_for(path[len("unet/"):], n_levels)
    raise ConversionError(f"unmapped decoder path {path!r}")


def convert_kandinsky2_decoder(state_dict: dict, template_params: dict,
                               n_levels: int = 4) -> dict:
    return _convert_tree(template_params, state_dict,
                         lambda p: decoder_key_for(p, n_levels))


# -- movq ------------------------------------------------------------------

def _spatial_norm_leaves(rest: str):
    """leaves under one of our SpatialNorm scopes -> published suffix."""
    table = {
        "norm/GroupNorm_0/scale": ("norm_layer.weight", _ident),
        "norm/GroupNorm_0/bias": ("norm_layer.bias", _ident),
        "conv_y/kernel": ("conv_y.weight", _conv),
        "conv_y/bias": ("conv_y.bias", _ident),
        "conv_b/kernel": ("conv_b.weight", _conv),
        "conv_b/bias": ("conv_b.bias", _ident),
    }
    return table.get(rest)


def _movq_res_leaves(rest: str):
    for norm in ("norm1", "norm2"):
        if rest.startswith(norm + "/"):
            leaf = _spatial_norm_leaves(rest[len(norm) + 1:])
            if leaf:
                return f"{norm}.{leaf[0]}", leaf[1]
    table = {
        "Conv_0/kernel": ("conv1.weight", _conv),
        "Conv_0/bias": ("conv1.bias", _ident),
        "Conv_1/kernel": ("conv2.weight", _conv),
        "Conv_1/bias": ("conv2.bias", _ident),
        "skip/kernel": ("conv_shortcut.weight", _conv),
        "skip/bias": ("conv_shortcut.bias", _ident),
    }
    return table.get(rest)


_MOVQ_ATTN = {
    "to_q/kernel": ("to_q.weight", _linear),
    "to_q/bias": ("to_q.bias", _ident),
    "to_k/kernel": ("to_k.weight", _linear),
    "to_k/bias": ("to_k.bias", _ident),
    "to_v/kernel": ("to_v.weight", _linear),
    "to_v/bias": ("to_v.bias", _ident),
    "to_out/kernel": ("to_out.0.weight", _linear),
    "to_out/bias": ("to_out.0.bias", _ident),
}


def movq_key_for(path: str, n_levels: int = 4):
    """our MOVQDecoder path -> (published VQModel key, transform)."""
    simple = {
        "post_quant/kernel": ("post_quant_conv.weight", _conv),
        "post_quant/bias": ("post_quant_conv.bias", _ident),
        "conv_in/kernel": ("decoder.conv_in.weight", _conv),
        "conv_in/bias": ("decoder.conv_in.bias", _ident),
        "conv_out/kernel": ("decoder.conv_out.weight", _conv),
        "conv_out/bias": ("decoder.conv_out.bias", _ident),
    }
    if path in simple:
        return simple[path]
    part, _, rest = path.partition("/")
    if part == "norm_out":
        leaf = _spatial_norm_leaves(rest)
        if leaf:
            return f"decoder.conv_norm_out.{leaf[0]}", leaf[1]
    m = re.match(r"mid_res_(\d)$", part)
    if m:
        leaf = _movq_res_leaves(rest)
        if leaf:
            return (f"decoder.mid_block.resnets.{m.group(1)}.{leaf[0]}",
                    leaf[1])
    if part == "mid_attn_norm":
        leaf = _spatial_norm_leaves(rest)
        if leaf:
            return (f"decoder.mid_block.attentions.0.spatial_norm.{leaf[0]}",
                    leaf[1])
    if part == "mid_attn":
        leaf = _MOVQ_ATTN.get(rest)
        if leaf:
            return f"decoder.mid_block.attentions.0.{leaf[0]}", leaf[1]
    m = re.match(r"up_(\d+)_res_(\d+)$", part)
    if m:
        leaf = _movq_res_leaves(rest)
        if leaf:
            return (f"decoder.up_blocks.{n_levels - 1 - int(m.group(1))}"
                    f".resnets.{m.group(2)}.{leaf[0]}", leaf[1])
    m = re.match(r"up_(\d+)_us$", part)
    if m:
        if rest == "Conv_0/kernel":
            return (f"decoder.up_blocks.{n_levels - 1 - int(m.group(1))}"
                    ".upsamplers.0.conv.weight", _conv)
        if rest == "Conv_0/bias":
            return (f"decoder.up_blocks.{n_levels - 1 - int(m.group(1))}"
                    ".upsamplers.0.conv.bias", _ident)
    raise ConversionError(f"unmapped movq path {path!r}")


def convert_kandinsky2_movq(state_dict: dict, template_params: dict,
                            n_levels: int = 4) -> dict:
    return _convert_tree(template_params, state_dict,
                         lambda p: movq_key_for(p, n_levels))


# -- text projection -------------------------------------------------------

def convert_kandinsky2_text_projection(state_dict: dict,
                                       template_params: dict) -> dict:
    """`text_projection.weight` → our TextProjection tree."""
    return _convert_tree(template_params, state_dict,
                         lambda p: ("text_projection.weight", _linear)
                         if p == "proj/kernel"
                         else (_ for _ in ()).throw(
                             ConversionError(f"unmapped text-proj path {p!r}")))


# -- inverse direction (interop tests) -------------------------------------

def export_tree(params: dict, key_for) -> dict:
    """ours → published naming, inverting the leaf transforms. GEGLU halves
    (decoder unet ff) are re-fused like export_sd15_unet."""
    from arbius_tpu_torch.models.sd15.convert import (
        _geglu_gate,
        _geglu_gate_b,
        _geglu_val,
        _geglu_val_b,
    )

    out: dict[str, np.ndarray] = {}
    fuse: dict[str, dict[str, np.ndarray]] = {}

    for parts, leaf in _leaves(params):
        key, tf = key_for("/".join(parts))
        w = np.asarray(leaf)
        if tf is _conv:
            out[key] = np.transpose(w, (3, 2, 0, 1))
        elif tf is _linear:
            out[key] = np.transpose(w)
        elif tf in (_geglu_val, _geglu_gate, _geglu_val_b, _geglu_gate_b):
            half = "val" if tf in (_geglu_val, _geglu_val_b) else "gate"
            w2 = np.transpose(w) if tf in (_geglu_val, _geglu_gate) else w
            fuse.setdefault(key, {})[half] = w2
        else:
            out[key] = w

    for key, halves in fuse.items():
        out[key] = np.concatenate([halves["val"], halves["gate"]], axis=0)
    return out
