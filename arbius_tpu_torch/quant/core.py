"""quantserve core for the port: int8/fp8 weights with per-output-channel
float32 scales, quantized once at load and dequantized at the start of
every bucket program.

Twin of arbius_tpu/quant/core.py in torch. The scheme is the reference's,
float32 arithmetic throughout:

    scale  = max(absmax(w over every axis but the output axis), 1e-12)
             * (1 / bound)                              (float32)
    int8   q = clip(round(w / scale), -127, 127)        (half to even)
    fp8    q = (w / scale) -> float8_e4m3fn             (nearest even)
    dequant  = q -> float32 * scale

The reference writes `absmax / bound`, but XLA rewrites a division by a
constant into a product with the constant's float32 reciprocal, so that
is what it computes (0.00787401572 for 127, 0.002232143 for 448); the
port multiplies by the same float32. `w / scale` is a true division in
both.

The reference's output axis is the last axis of the flax leaf. The port
stores many leaves transposed (models/sd15/bridge.py), so each quantized
leaf comes with a `QuantAxis`: the port's tensor reshaped to `view` has
the reference's output channels along `axis` (`bridge.quant_layout`
gives one per eligible key).

A quantized leaf is the reference's ``{"qs": scale, "qv": values}`` dict:
`qs` float32 with one entry per output channel, `qv` int8 or
float8_e4m3fn in the port's shape. `QuantizedWeights` holds a module's
quantized leaves resident at one byte per element with its parameters
emptied (each keeps its shape as a stride-0 view of one zero, so the
layout, a seeded init and a reload still read it), and
`dequantize_first` makes a pipeline's bucket program begin by filling
them (`qv.float() * qs`, rounded to the parameter's dtype, as flax casts
the float32 dequantized kernel at use) and end by emptying them, so the
full-width weights live only for the chunk.

`quantized_dot` (activation-quantized products) is not ported: its users
are multi-device (ROADMAP.md queue 1 item 11).
"""
from __future__ import annotations

import contextlib
import functools
from typing import NamedTuple

import numpy as np
import torch

from arbius_tpu_torch.quant.modes import (
    DEFAULT_MODE,
    FP8_BOUND,
    INT8_BOUND,
    validate_mode,
)

# guard against all-zero channels: a zero absmax would divide out to NaN
# scales; the floor keeps the scale finite and the dequantized value 0
_SCALE_FLOOR = 1e-12

# the keys a quantized leaf carries
QUANT_KEYS = frozenset({"qs", "qv"})

# 1 / bound in float32, the constant XLA multiplies by for `/ bound`
_RECIPROCAL = {"int8": float(np.float32(1) / np.float32(INT8_BOUND)),
               "fp8": float(np.float32(1) / np.float32(FP8_BOUND))}


class QuantAxis(NamedTuple):
    """Where a leaf's output channels are: the port's tensor reshaped to
    `view` has them along `axis`."""
    view: tuple[int, ...]
    axis: int

    def scale_shape(self) -> tuple[int, ...]:
        """`qs` shaped to broadcast against `view`."""
        return tuple(n if i == self.axis else 1
                     for i, n in enumerate(self.view))


def storage_dtype(mode: str) -> torch.dtype | None:
    """The dtype quantized values of `mode` are stored in (None for
    bf16, which quantizes nothing)."""
    validate_mode(mode)
    return {"int8": torch.int8,
            "fp8": torch.float8_e4m3fn}.get(mode)


def is_quantized_leaf(x) -> bool:
    """True for the {"qs": scale, "qv": values} dict a quantized leaf
    becomes."""
    return isinstance(x, dict) and set(x) == QUANT_KEYS


def quantize_leaf(w: torch.Tensor, mode: str, where: QuantAxis) -> dict:
    """One weight -> {"qs": float32 scale per output channel, "qv":
    quantized values in `w`'s shape}, the channels where `where` says."""
    if storage_dtype(mode) is None:
        raise ValueError("quantize_leaf needs a quantized mode (int8|fp8)")
    if len(where.view) < 2:
        raise ValueError(f"a quantized leaf has at least 2 axes, got "
                         f"view {where.view}")
    w32 = w.to(torch.float32).reshape(where.view)
    others = tuple(i for i in range(w32.dim()) if i != where.axis)
    absmax = w32.abs().amax(dim=others, keepdim=True)
    scale = absmax.clamp_min(_SCALE_FLOOR) * _RECIPROCAL[mode]
    scaled = w32 / scale
    if mode == "int8":
        scaled = scaled.round().clamp(-INT8_BOUND, INT8_BOUND)
    q = scaled.to(storage_dtype(mode))
    return {"qs": scale.reshape(-1), "qv": q.reshape(w.shape)}


def dequantize_leaf(leaf: dict, where: QuantAxis) -> torch.Tensor:
    """{"qs", "qv"} -> float32 weight: the values convert to float32
    first, then multiply by the float32 scale on the output axis."""
    qv = leaf["qv"]
    return (qv.reshape(where.view).float()
            * leaf["qs"].reshape(where.scale_shape())).reshape(qv.shape)


def quantize_state(state: dict[str, torch.Tensor], mode: str,
                   layout: dict[str, QuantAxis]) -> dict:
    """Quantize every floating leaf of a state_dict that `layout` names;
    bf16 returns `state` untouched."""
    validate_mode(mode)
    if mode == DEFAULT_MODE:
        return state
    return {k: quantize_leaf(v, mode, layout[k])
            if k in layout and v.is_floating_point() else v
            for k, v in state.items()}


def dequantize_state(state: dict, layout: dict[str, QuantAxis]
                     ) -> dict[str, torch.Tensor]:
    """The float32 weights of a quantized state_dict; full-width leaves
    pass through."""
    return {k: dequantize_leaf(v, layout[k]) if is_quantized_leaf(v)
            else v for k, v in state.items()}


class QuantizedWeights:
    """A module's weights in a quantized mode. The full-width leaves of
    `state` (quantize_state's output) are copied into the module; each
    quantized leaf's parameter is emptied (a stride-0 view of one zero
    of its dtype, in its shape) and its qv and qs are held here, on the
    parameter's device. The module can load another state the same
    way."""

    def __init__(self, module: torch.nn.Module, state: dict,
                 layout: dict[str, QuantAxis]):
        want = set(module.state_dict())
        if set(state) != want:
            raise KeyError(f"missing keys {sorted(want - set(state))[:3]}, "
                           f"unexpected {sorted(set(state) - want)[:3]}")
        plain = sorted(k for k in layout if not is_quantized_leaf(state[k]))
        if plain:
            raise ValueError(f"leaves {plain[:3]} are not quantized: load "
                             "quantize_state's output")
        module.load_state_dict({k: v for k, v in state.items()
                                if k not in layout}, strict=False)
        params = dict(module.named_parameters())
        self.leaves = []   # (parameter, {"qs", "qv"}, QuantAxis)
        for key, where in layout.items():
            p, leaf = params[key], state[key]
            if tuple(leaf["qv"].shape) != tuple(p.shape):
                raise ValueError(f"{key}: quantized shape "
                                 f"{tuple(leaf['qv'].shape)} != parameter "
                                 f"shape {tuple(p.shape)}")
            self.leaves.append((p, {k: v.to(p.device)
                                    for k, v in leaf.items()}, where))
        # made here, before any graph capture empties the parameters
        self._zeros = {(p.dtype, p.device): torch.zeros(
            (), dtype=p.dtype, device=p.device) for p, _, _ in self.leaves}
        self._empty()

    def _empty(self) -> None:
        for p, leaf, _ in self.leaves:
            p.data = self._zeros[p.dtype, p.device].expand(leaf["qv"].shape)

    def emptied(self) -> bool:
        """True when no quantized parameter holds full-width storage."""
        return all(p.untyped_storage().nbytes() <= p.element_size()
                   for p, _, _ in self.leaves)

    @contextlib.contextmanager
    def dequantized(self):
        """The module's full-width weights for the body: each parameter
        holds `dequantize_leaf` rounded to its own dtype, and is emptied
        again on exit."""
        for p, leaf, where in self.leaves:
            p.data = dequantize_leaf(leaf, where).to(p.dtype)
        try:
            yield
        finally:
            self._empty()


def dequantize_first(program):
    """For a pipeline's bucket program: with quantized weights resident
    (`self.quantized`), the program begins by dequantizing them and they
    are emptied when it returns; in bf16 it is the program itself."""

    @functools.wraps(program)
    def run(self, *args, **kwargs):
        if self.quantized is None:
            return program(self, *args, **kwargs)
        with self.quantized.dequantized():
            return program(self, *args, **kwargs)

    return run
