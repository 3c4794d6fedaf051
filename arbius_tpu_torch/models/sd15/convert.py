"""Checkpoint conversion: diffusers/CLIP state dicts → arbius param trees.

A user of the reference mines with published SD-1.5-family weights
(anythingv3's cog container wraps a diffusers checkpoint). This module
maps those state dicts onto the flax trees of the reference
(arbius_tpu/models/sd15/convert.py, whose key functions and leaf
transforms this twin copies as they are), which the port's modules take
through `bridge.params_from_jax`; the template tree comes from the
port's own modules (`bridge.template_from_models`), and the tree walks
are plain walks over nested dicts (`_leaves`), in jax's order:

  - torch Linear [out, in]      → flax kernel [in, out] (transpose)
  - torch Conv2d [O, I, kH, kW] → flax kernel [kH, kW, I, O]
  - diffusers fused GEGLU ff.net.0.proj → split into ff_val/ff_gate
    (value half first, matching diffusers' .chunk(2) order)
  - CLIP attention q/k/v/out [E, E] → flax attention heads
    [E, H, D] / [H, D, E]

Input is a flat `{key: numpy array}` dict (load a .safetensors /
torch .bin with your loader of choice and pass `{k: v.numpy()}`).
Completeness is enforced: every leaf of the target tree must be produced,
and shape mismatches fail loudly with both shapes in the message.
Bijectivity (ours → diffusers naming → ours is the identity) is tested in
tests/test_convert.py; numeric validation against a live diffusers
pipeline needs real weights and is a deployment-time step (the boot
self-test's golden CID is the final arbiter either way).
"""
from __future__ import annotations

import re

import numpy as np


class ConversionError(ValueError):
    pass


def _linear(w):  # torch [out, in] -> flax [in, out]
    return np.ascontiguousarray(np.transpose(w))


def _conv(w):    # torch [O, I, kH, kW] -> flax [kH, kW, I, O]
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def _ident(w):
    return np.asarray(w)


# -- UNet key translation --------------------------------------------------

def _unet_block_prefix(part: str, n_levels: int) -> str | None:
    """our 'down_2_res_1' style prefix -> diffusers block prefix."""
    m = re.match(r"down_(\d+)_res_(\d+)$", part)
    if m:
        return f"down_blocks.{m.group(1)}.resnets.{m.group(2)}"
    m = re.match(r"down_(\d+)_attn_(\d+)$", part)
    if m:
        return f"down_blocks.{m.group(1)}.attentions.{m.group(2)}"
    m = re.match(r"down_(\d+)_ds$", part)
    if m:
        return f"down_blocks.{m.group(1)}.downsamplers.0"
    m = re.match(r"up_(\d+)_res_(\d+)$", part)
    if m:
        return (f"up_blocks.{n_levels - 1 - int(m.group(1))}"
                f".resnets.{m.group(2)}")
    m = re.match(r"up_(\d+)_attn_(\d+)$", part)
    if m:
        return (f"up_blocks.{n_levels - 1 - int(m.group(1))}"
                f".attentions.{m.group(2)}")
    m = re.match(r"up_(\d+)_us$", part)
    if m:
        return f"up_blocks.{n_levels - 1 - int(m.group(1))}.upsamplers.0"
    if part == "mid_res_0":
        return "mid_block.resnets.0"
    if part == "mid_res_1":
        return "mid_block.resnets.1"
    if part == "mid_attn":
        return "mid_block.attentions.0"
    return None


_RESNET_LEAVES = {
    "GroupNorm32_0/GroupNorm_0/scale": ("norm1.weight", _ident),
    "GroupNorm32_0/GroupNorm_0/bias": ("norm1.bias", _ident),
    "Conv_0/kernel": ("conv1.weight", _conv),
    "Conv_0/bias": ("conv1.bias", _ident),
    "Dense_0/kernel": ("time_emb_proj.weight", _linear),
    "Dense_0/bias": ("time_emb_proj.bias", _ident),
    "GroupNorm32_1/GroupNorm_0/scale": ("norm2.weight", _ident),
    "GroupNorm32_1/GroupNorm_0/bias": ("norm2.bias", _ident),
    "Conv_1/kernel": ("conv2.weight", _conv),
    "Conv_1/bias": ("conv2.bias", _ident),
    "skip_proj/kernel": ("conv_shortcut.weight", _conv),
    "skip_proj/bias": ("conv_shortcut.bias", _ident),
}

_TXBLOCK_LEAVES = {
    "LayerNorm_0/scale": ("norm1.weight", _ident),
    "LayerNorm_0/bias": ("norm1.bias", _ident),
    "LayerNorm_1/scale": ("norm2.weight", _ident),
    "LayerNorm_1/bias": ("norm2.bias", _ident),
    "LayerNorm_2/scale": ("norm3.weight", _ident),
    "LayerNorm_2/bias": ("norm3.bias", _ident),
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


def _geglu_val(w):
    return _linear(np.split(np.asarray(w), 2, axis=0)[0])


def _geglu_gate(w):
    return _linear(np.split(np.asarray(w), 2, axis=0)[1])


def _geglu_val_b(b):
    return np.split(np.asarray(b), 2, axis=0)[0]


def _geglu_gate_b(b):
    return np.split(np.asarray(b), 2, axis=0)[1]


_GEGLU_LEAVES = {
    "ff/ff_val/kernel": ("ff.net.0.proj.weight", _geglu_val),
    "ff/ff_val/bias": ("ff.net.0.proj.bias", _geglu_val_b),
    "ff/ff_gate/kernel": ("ff.net.0.proj.weight", _geglu_gate),
    "ff/ff_gate/bias": ("ff.net.0.proj.bias", _geglu_gate_b),
}

_SPATIAL_LEAVES = {
    "GroupNorm32_0/GroupNorm_0/scale": ("norm.weight", _ident),
    "GroupNorm32_0/GroupNorm_0/bias": ("norm.bias", _ident),
    "proj_in/kernel": ("proj_in.weight", _conv),
    "proj_in/bias": ("proj_in.bias", _ident),
    "proj_out/kernel": ("proj_out.weight", _conv),
    "proj_out/bias": ("proj_out.bias", _ident),
}


def unet_key_for(path: str, n_levels: int):
    """our flax path (joined with /) -> (diffusers key, transform)."""
    if path == "conv_in/kernel":
        return "conv_in.weight", _conv
    if path == "conv_in/bias":
        return "conv_in.bias", _ident
    if path == "conv_out/kernel":
        return "conv_out.weight", _conv
    if path == "conv_out/bias":
        return "conv_out.bias", _ident
    if path == "norm_out/GroupNorm_0/scale":
        return "conv_norm_out.weight", _ident
    if path == "norm_out/GroupNorm_0/bias":
        return "conv_norm_out.bias", _ident
    m = re.match(r"TimestepEmbedding_0/Dense_(\d)/(kernel|bias)$", path)
    if m:
        which = "linear_1" if m.group(1) == "0" else "linear_2"
        if m.group(2) == "kernel":
            return f"time_embedding.{which}.weight", _linear
        return f"time_embedding.{which}.bias", _ident
    part, _, rest = path.partition("/")
    prefix = _unet_block_prefix(part, n_levels)
    if prefix is None:
        raise ConversionError(f"unmapped unet path {path!r}")
    if "_res_" in part or part.startswith("mid_res"):
        leaf = _RESNET_LEAVES.get(rest)
        if leaf:
            return f"{prefix}.{leaf[0]}", leaf[1]
    if part.endswith("_ds") or part.endswith("_us"):
        if rest == "Conv_0/kernel":
            return f"{prefix}.conv.weight", _conv
        if rest == "Conv_0/bias":
            return f"{prefix}.conv.bias", _ident
    if "_attn_" in part or part == "mid_attn":
        leaf = _SPATIAL_LEAVES.get(rest)
        if leaf:
            return f"{prefix}.{leaf[0]}", leaf[1]
        m = re.match(r"block_(\d+)/(.+)$", rest)
        if m:
            tb = f"{prefix}.transformer_blocks.{m.group(1)}"
            inner = m.group(2)
            leaf = _TXBLOCK_LEAVES.get(inner)
            if leaf:
                return f"{tb}.{leaf[0]}", leaf[1]
            leaf = _GEGLU_LEAVES.get(inner)
            if leaf:
                return f"{tb}.{leaf[0]}", leaf[1]
    raise ConversionError(f"unmapped unet path {path!r}")


# -- tree walk -------------------------------------------------------------

def _leaves(tree: dict, parts: tuple[str, ...] = ()):
    """(path parts, leaf) of a tree of nested dicts, keys in sorted order
    at every level: the order `jax.tree_util` visits a dict tree in. A
    leaf is anything that is not a dict (an array, or any object with a
    `.shape`, such as a tensor on the meta device)."""
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            yield from _leaves(val, parts + (str(key),))
        else:
            yield parts + (str(key),), val


def _convert_tree(template: dict, state_dict: dict, key_for) -> dict:
    out = {}
    missing = []
    for parts, leaf in _leaves(template):
        path = "/".join(parts)
        key, tf = key_for(path)
        if key not in state_dict:
            missing.append(key)
            continue
        w = tf(state_dict[key])
        if tuple(w.shape) != tuple(leaf.shape):
            raise ConversionError(
                f"{path}: converted shape {tuple(w.shape)} != expected "
                f"{tuple(leaf.shape)} (from {key})")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = w
    if missing:
        raise ConversionError(
            f"{len(missing)} keys missing from state dict, e.g. "
            f"{sorted(missing)[:5]}")
    return out


# -- VAE decoder key translation -------------------------------------------

_VAE_RESNET = {
    "GroupNorm32_0/GroupNorm_0/scale": ("norm1.weight", _ident),
    "GroupNorm32_0/GroupNorm_0/bias": ("norm1.bias", _ident),
    "Conv_0/kernel": ("conv1.weight", _conv),
    "Conv_0/bias": ("conv1.bias", _ident),
    "GroupNorm32_1/GroupNorm_0/scale": ("norm2.weight", _ident),
    "GroupNorm32_1/GroupNorm_0/bias": ("norm2.bias", _ident),
    "Conv_1/kernel": ("conv2.weight", _conv),
    "Conv_1/bias": ("conv2.bias", _ident),
    "skip_proj/kernel": ("conv_shortcut.weight", _conv),
    "skip_proj/bias": ("conv_shortcut.bias", _ident),
}

_VAE_ATTN = {
    "GroupNorm32_0/GroupNorm_0/scale": ("group_norm.weight", _ident),
    "GroupNorm32_0/GroupNorm_0/bias": ("group_norm.bias", _ident),
    "Attention_0/to_q/kernel": ("to_q.weight", _linear),
    "Attention_0/to_q/bias": ("to_q.bias", _ident),
    "Attention_0/to_k/kernel": ("to_k.weight", _linear),
    "Attention_0/to_k/bias": ("to_k.bias", _ident),
    "Attention_0/to_v/kernel": ("to_v.weight", _linear),
    "Attention_0/to_v/bias": ("to_v.bias", _ident),
    "Attention_0/to_out/kernel": ("to_out.0.weight", _linear),
    "Attention_0/to_out/bias": ("to_out.0.bias", _ident),
}


def vae_key_for(path: str, n_levels: int = 4):
    """our VAEDecoder path -> (diffusers AutoencoderKL key, transform)."""
    simple = {
        "post_quant/kernel": ("post_quant_conv.weight", _conv),
        "post_quant/bias": ("post_quant_conv.bias", _ident),
        "conv_in/kernel": ("decoder.conv_in.weight", _conv),
        "conv_in/bias": ("decoder.conv_in.bias", _ident),
        "conv_out/kernel": ("decoder.conv_out.weight", _conv),
        "conv_out/bias": ("decoder.conv_out.bias", _ident),
        "norm_out/GroupNorm_0/scale": ("decoder.conv_norm_out.weight", _ident),
        "norm_out/GroupNorm_0/bias": ("decoder.conv_norm_out.bias", _ident),
    }
    if path in simple:
        return simple[path]
    part, _, rest = path.partition("/")
    m = re.match(r"mid_res_(\d)$", part)
    if m:
        leaf = _VAE_RESNET.get(rest)
        if leaf:
            return (f"decoder.mid_block.resnets.{m.group(1)}.{leaf[0]}",
                    leaf[1])
    if part == "mid_attn":
        leaf = _VAE_ATTN.get(rest)
        if leaf:
            return f"decoder.mid_block.attentions.0.{leaf[0]}", leaf[1]
    m = re.match(r"up_(\d+)_res_(\d+)$", part)
    if m:
        leaf = _VAE_RESNET.get(rest)
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
    raise ConversionError(f"unmapped vae path {path!r}")


# -- CLIP text encoder key translation -------------------------------------

def _make_attn_head_tf(heads: int, head_dim: int, kind: str):
    """CLIP [E, E]/[E] projections -> flax SelfAttention head layout."""
    if kind == "qkv_kernel":
        return lambda w: _linear(w).reshape(-1, heads, head_dim)
    if kind == "qkv_bias":
        return lambda b: np.asarray(b).reshape(heads, head_dim)
    if kind == "out_kernel":
        return lambda w: _linear(w).reshape(heads, head_dim, -1)
    return _ident  # out bias


def text_key_for(path: str, heads: int, head_dim: int):
    """our TextEncoder path -> (transformers CLIPTextModel key, transform).

    Production note: real CLIP checkpoints pair with the CLIP BPE
    tokenizer; the TextEncoder consumes any id stream, so swap the
    ByteTokenizer for a BPE tokenizer when loading converted weights.
    """
    simple = {
        "token_embed/embedding":
            ("text_model.embeddings.token_embedding.weight", _ident),
        "pos_embed":
            ("text_model.embeddings.position_embedding.weight", _ident),
        "final_norm/scale": ("text_model.final_layer_norm.weight", _ident),
        "final_norm/bias": ("text_model.final_layer_norm.bias", _ident),
    }
    if path in simple:
        return simple[path]
    m = re.match(r"layer_(\d+)/(.+)$", path)
    if not m:
        raise ConversionError(f"unmapped text path {path!r}")
    base = f"text_model.encoder.layers.{m.group(1)}"
    rest = m.group(2)
    attn_names = {"query": "q_proj", "key": "k_proj", "value": "v_proj"}
    for ours, theirs in attn_names.items():
        if rest == f"attn/{ours}/kernel":
            return (f"{base}.self_attn.{theirs}.weight",
                    _make_attn_head_tf(heads, head_dim, "qkv_kernel"))
        if rest == f"attn/{ours}/bias":
            return (f"{base}.self_attn.{theirs}.bias",
                    _make_attn_head_tf(heads, head_dim, "qkv_bias"))
    if rest == "attn/out/kernel":
        return (f"{base}.self_attn.out_proj.weight",
                _make_attn_head_tf(heads, head_dim, "out_kernel"))
    if rest == "attn/out/bias":
        return f"{base}.self_attn.out_proj.bias", _ident
    mlp = {
        "Dense_0/kernel": ("mlp.fc1.weight", _linear),
        "Dense_0/bias": ("mlp.fc1.bias", _ident),
        "Dense_1/kernel": ("mlp.fc2.weight", _linear),
        "Dense_1/bias": ("mlp.fc2.bias", _ident),
        "LayerNorm_0/scale": ("layer_norm1.weight", _ident),
        "LayerNorm_0/bias": ("layer_norm1.bias", _ident),
        "LayerNorm_1/scale": ("layer_norm2.weight", _ident),
        "LayerNorm_1/bias": ("layer_norm2.bias", _ident),
    }
    if rest in mlp:
        key, tf = mlp[rest]
        return f"{base}.{key}", tf
    raise ConversionError(f"unmapped text path {path!r}")


def convert_sd15_vae(state_dict: dict, template_params: dict,
                     n_levels: int = 4) -> dict:
    """diffusers AutoencoderKL state dict → our VAEDecoder param tree."""
    return _convert_tree(template_params, state_dict,
                         lambda p: vae_key_for(p, n_levels))


def convert_sd15_text(state_dict: dict, template_params: dict,
                      heads: int, head_dim: int) -> dict:
    """transformers CLIPTextModel state dict → our TextEncoder tree."""
    return _convert_tree(template_params, state_dict,
                         lambda p: text_key_for(p, heads, head_dim))


def convert_sd15_unet(state_dict: dict, template_params: dict,
                      n_levels: int = 4) -> dict:
    """diffusers UNet2DConditionModel state dict → our unet param tree.

    `template_params` is an init_params()['unet'] tree providing the
    target structure and shapes.
    """
    return _convert_tree(template_params, state_dict,
                         lambda p: unet_key_for(p, n_levels))


def export_sd15_unet(params: dict, n_levels: int = 4) -> dict:
    """Inverse direction (ours → diffusers naming), for interop tests.

    GEGLU halves are re-fused; conv/linear transforms are inverted.
    """
    out: dict[str, np.ndarray] = {}
    fuse: dict[str, dict[str, np.ndarray]] = {}

    for parts, leaf in _leaves(params):
        key, tf = unet_key_for("/".join(parts), n_levels)
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
