"""Checkpoints for the port: one file per model.

Twin of arbius_tpu/utils/checkpoint.py's `save_params`, `load_params` and
`cast_floating`, changed in its format. The reference writes orbax trees,
and orbax is JAX, so the port writes its own: the module bundle's
`state_dict` (the port's keys, the flax path joined with '.') as one file
by `torch.save`, read back by `torch.load(..., weights_only=True)`
memory-mapped, so a boot copies the weights to the card without first
holding a second copy on the host. A reference orbax checkpoint does not
load here: convert the published weights with the port's
`convert-checkpoint` instead. The compile-cache half of the reference's
module (`enable_compile_cache`, `with_cast`) is XLA's and has no twin
(ROADMAP.md queue 1 item 12).

`load_safetensors` reads the published `.safetensors` format with no
package: an 8-byte little-endian header length, a JSON header naming each
tensor's dtype, shape and byte range, then the raw little-endian data.
"""
from __future__ import annotations

import json
import math
import os
import struct

import torch

# the safetensors dtypes the published checkpoints of the five families use
_SAFETENSORS_DTYPES = {"F32": torch.float32, "BF16": torch.bfloat16,
                       "F16": torch.float16, "I64": torch.int64,
                       "I32": torch.int32}


def save_params(path: str, state: dict[str, torch.Tensor]) -> None:
    """Write a state_dict as one file, each tensor in its own dtype
    (written to a temporary name, then renamed into place)."""
    path = os.path.abspath(path)
    tmp = path + ".tmp"
    torch.save({k: v.detach().cpu().contiguous() for k, v in state.items()},
               tmp)
    os.replace(tmp, path)


def load_params(path: str) -> dict[str, torch.Tensor]:
    """Read a state_dict written by `save_params` (memory-mapped)."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory, not a checkpoint file: the port loads "
            "the one file its convert-checkpoint writes (a reference orbax "
            "tree does not load here)")
    state = torch.load(path, map_location="cpu", weights_only=True,
                       mmap=True)
    if not isinstance(state, dict) or not all(
            isinstance(v, torch.Tensor) for v in state.values()):
        raise ValueError(f"{path} does not hold a state_dict of tensors")
    return state


def cast_floating(state: dict[str, torch.Tensor],
                  dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """Cast every floating tensor of a state_dict to `dtype`; integer
    tensors pass through."""
    return {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in state.items()}


def load_safetensors(path: str) -> dict[str, torch.Tensor]:
    """Every tensor of a `.safetensors` file, in the header's order, on
    the CPU in its stored dtype."""
    with open(path, "rb") as f:
        (size,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(size))
        data = bytearray(f.read())
    out = {}
    for name, spec in header.items():
        if name == "__metadata__":
            continue
        dtype = _SAFETENSORS_DTYPES.get(spec["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has dtype {spec['dtype']!r}, "
                             f"not one of {sorted(_SAFETENSORS_DTYPES)}")
        begin, end = spec["data_offsets"]
        shape = tuple(spec["shape"])
        count = math.prod(shape)
        if end - begin != count * dtype.itemsize or end > len(data):
            raise ValueError(f"{path}: {name}'s byte range {begin}..{end} "
                             f"does not hold {shape} {spec['dtype']}")
        flat = (torch.frombuffer(data, dtype=dtype, count=count,
                                 offset=begin)
                if count else torch.empty(0, dtype=dtype))
        out[name] = flat.reshape(shape)
    return out
