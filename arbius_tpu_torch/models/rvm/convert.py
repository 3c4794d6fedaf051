"""Checkpoint conversion: published RVM state dict → param tree.

The reference mines robust_video_matting through a cog container wrapping
the published `rvm_mobilenetv3` checkpoint
(`templates/robust_video_matting.json` pins
github.com/PeterL1n/RobustVideoMatting). This module maps that checkpoint's
torch key space — torchvision MobileNetV3-Large `backbone.features.*`,
`aspp.*`, the recurrent `decoder.decode{4..0}.*`, `project_mat`/
`project_seg`, and the `refiner.*` deep-guided-filter head — onto
`models/rvm/model.py`'s flax tree, 1:1.

Same contract as sd15/convert.py (the family template): input is a flat
`{key: numpy array}` dict; completeness is enforced (every target leaf must
be produced; shape mismatches fail loudly; `num_batches_tracked` entries
are naturally ignored — conversion pulls, it doesn't push). Bijectivity
(ours → published naming → ours) is tested in tests/test_rvm_convert.py.
Numeric validation against the live published network needs real weights
and is a deployment-time step — the boot self-test's golden CID is the
final arbiter either way.
"""
from __future__ import annotations

import re

import numpy as np

from arbius_tpu_torch.models.rvm.model import RVMConfig
from arbius_tpu_torch.models.sd15.convert import (
    ConversionError,
    _conv,
    _convert_tree,
    _ident,
    _leaves,
)

__all__ = ["convert_rvm", "rvm_key_for", "export_tree"]

# BNInf leaf ↔ torch BatchNorm2d state-dict entry
_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean",
       "var": "running_var"}


def _block_layer_indices(row: tuple) -> dict[str, int]:
    """torch `block.{j}` index per stage, from the row alone — torchvision
    appends expand only when expanded≠in and SE only when use_se."""
    in_ch, _k, exp, _out, use_se, _act, _s, _d = row
    idx = {}
    j = 0
    if exp != in_ch:
        idx["expand"] = j
        j += 1
    idx["depthwise"] = j
    j += 1
    if use_se:
        idx["se"] = j
        j += 1
    idx["project"] = j
    return idx


def _cna(prefix: str, rest: str):
    """Conv2dNormActivation: `.0` conv(no bias), `.1` BN."""
    if rest == "conv/kernel":
        return f"{prefix}.0.weight", _conv
    m = re.match(r"bn/(scale|bias|mean|var)$", rest)
    if m:
        return f"{prefix}.1.{_BN[m.group(1)]}", _ident
    raise ConversionError(f"unmapped ConvBNAct leaf {rest!r} under {prefix}")


def _gru(prefix: str, rest: str):
    """ConvGRU: ih/hh are Sequential(Conv2d, activation) → `.0`."""
    m = re.match(r"(ih|hh)/(kernel|bias)$", rest)
    if m:
        leaf = "weight" if m.group(2) == "kernel" else "bias"
        tf = _conv if m.group(2) == "kernel" else _ident
        return f"{prefix}.{m.group(1)}.0.{leaf}", tf
    raise ConversionError(f"unmapped ConvGRU leaf {rest!r} under {prefix}")


def rvm_key_for(path: str, config: RVMConfig = RVMConfig()):
    """our param path → (published torch key, leaf transform)."""
    part, _, rest = path.partition("/")

    if part == "backbone":
        sub, _, rest = rest.partition("/")
        if sub == "stem":
            return _cna("backbone.features.0", rest)
        if sub == "lastconv":
            n = len(config.ir_rows) + 1
            return _cna(f"backbone.features.{n}", rest)
        m = re.match(r"block_(\d+)$", sub)
        if m:
            fi = int(m.group(1))
            row = config.ir_rows[fi - 1]
            idx = _block_layer_indices(row)
            stage, _, leaf = rest.partition("/")
            if stage == "se":
                mm = re.match(r"(fc1|fc2)/(kernel|bias)$", leaf)
                if mm:
                    tname = "weight" if mm.group(2) == "kernel" else "bias"
                    tf = _conv if mm.group(2) == "kernel" else _ident
                    return (f"backbone.features.{fi}.block.{idx['se']}."
                            f"{mm.group(1)}.{tname}"), tf
            elif stage in idx:
                return _cna(f"backbone.features.{fi}.block.{idx[stage]}",
                            leaf)

    elif part == "aspp":
        if rest == "aspp1_conv/kernel":
            return "aspp.aspp1.0.weight", _conv
        m = re.match(r"aspp1_bn/(scale|bias|mean|var)$", rest)
        if m:
            return f"aspp.aspp1.1.{_BN[m.group(1)]}", _ident
        if rest == "aspp2_conv/kernel":
            return "aspp.aspp2.1.weight", _conv

    elif part == "decoder":
        stage, _, rest = rest.partition("/")
        if stage == "decode4":
            if rest.startswith("gru/"):
                return _gru("decoder.decode4.gru", rest[4:])
        elif stage in ("decode3", "decode2", "decode1"):
            if rest == "conv/kernel":
                return f"decoder.{stage}.conv.0.weight", _conv
            m = re.match(r"bn/(scale|bias|mean|var)$", rest)
            if m:
                return f"decoder.{stage}.conv.1.{_BN[m.group(1)]}", _ident
            if rest.startswith("gru/"):
                return _gru(f"decoder.{stage}.gru", rest[4:])
        elif stage == "decode0":
            # Sequential(conv,BN,ReLU,conv,BN,ReLU) → 0,1,3,4
            if rest == "conv_a/kernel":
                return "decoder.decode0.conv.0.weight", _conv
            if rest == "conv_b/kernel":
                return "decoder.decode0.conv.3.weight", _conv
            m = re.match(r"bn_([ab])/(scale|bias|mean|var)$", rest)
            if m:
                j = 1 if m.group(1) == "a" else 4
                return f"decoder.decode0.conv.{j}.{_BN[m.group(2)]}", _ident

    elif part in ("project_mat", "project_seg"):
        if rest == "conv/kernel":
            return f"{part}.conv.weight", _conv
        if rest == "conv/bias":
            return f"{part}.conv.bias", _ident

    elif part == "refiner":
        if rest == "box_filter/kernel":
            return "refiner.box_filter.weight", _conv
        # Sequential(conv,BN,ReLU,conv,BN,ReLU,conv) → 0,1,3,4,6
        if rest == "conv_a/kernel":
            return "refiner.conv.0.weight", _conv
        if rest == "conv_b/kernel":
            return "refiner.conv.3.weight", _conv
        if rest == "conv_c/kernel":
            return "refiner.conv.6.weight", _conv
        if rest == "conv_c/bias":
            return "refiner.conv.6.bias", _ident
        m = re.match(r"bn_([ab])/(scale|bias|mean|var)$", rest)
        if m:
            j = 1 if m.group(1) == "a" else 4
            return f"refiner.conv.{j}.{_BN[m.group(2)]}", _ident

    raise ConversionError(f"unmapped rvm param path {path!r}")


def convert_rvm(state_dict: dict, template_params: dict,
                config: RVMConfig = RVMConfig()) -> dict:
    """Published MattingNetwork state dict → MattingStep param tree."""
    return _convert_tree(template_params, state_dict,
                         lambda p: rvm_key_for(p, config))


def export_tree(params: dict, config: RVMConfig = RVMConfig()) -> dict:
    """ours → published naming, inverting the leaf transforms (test
    round-trip + fixture fabrication)."""
    out: dict[str, np.ndarray] = {}
    for parts, leaf in _leaves(params):
        key, tf = rvm_key_for("/".join(parts), config)
        w = np.asarray(leaf)
        out[key] = np.transpose(w, (3, 2, 0, 1)) if tf is _conv else w
    return out
