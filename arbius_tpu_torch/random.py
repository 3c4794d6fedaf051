"""The `jax.random` calls of the SD-1.5 bucket, over threefry2x32, in torch.

Every noise tensor on the solve path comes from `jax.random` in the
reference (`models/sd15/pipeline.py`): the per-task key is
``fold_in(PRNGKey(seed_lo), seed_hi)``, the initial latents are
``normal(key)`` and the ancestral noise is ``normal(fold_in(key, i))``.
A `torch.Generator` would give a different picture for the same task id,
so this module reproduces jax 0.9.0's defaults instead:
``jax_default_prng_impl=threefry2x32`` and
``jax_threefry_partitionable=True`` (which lays the counters out as the
row-major flat index of the output, split into hi/lo 32-bit words).

uint32 values live in int64 tensors masked to 32 bits, because torch has
little uint32 arithmetic. A key is an int64 tensor ``[..., 2]``; leading
dimensions batch independent keys (the reference's `vmap` over tasks).
Raw bits, `fold_in` and `split` are bit-exact. `normal` goes through
`torch.erfinv`, which may differ from XLA's `erf_inv` by a few ULPs.
`categorical` is jax's Gumbel-max ("low" mode): its noise goes through
`torch.log`, a few ULPs from XLA's `log`, so hold its ids, not its noise,
to the reference.

Nothing here copies from the host to the device: an int `data` or a
seed becomes a device tensor by a fill kernel, and the bounds of
`uniform` enter as scalars. So every call can be captured in a CUDA
graph (the textgen bucket program).
"""
from __future__ import annotations

import math

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1, x2) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds), elementwise with broadcasting."""
    k3 = k1 ^ k2 ^ 0x1BD11BDA
    ks = (k1, k2, k3)
    x = [(x1 + k1) & _MASK, (x2 + k2) & _MASK]
    for step in range(5):
        for r in _ROTATIONS[step % 2]:
            x[0] = (x[0] + x[1]) & _MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(step + 1) % 3]) & _MASK
        x[1] = (x[1] + ks[(step + 2) % 3] + step + 1) & _MASK
    return x[0], x[1]


def _int64(data, device) -> torch.Tensor:
    """`data` as an int64 tensor on `device`: a Python int by a fill
    kernel (no host-to-device copy), a tensor as it is or cast."""
    if isinstance(data, int):
        return torch.full((), data, dtype=torch.int64, device=device)
    return torch.as_tensor(data, dtype=torch.int64, device=device)


def prng_key(seed, device: str | torch.device = "cuda") -> torch.Tensor:
    """`jax.random.PRNGKey(seed)`: the key is the seed's 64 bits as
    (hi word, lo word). The bucket passes 32-bit low words, so hi is 0.
    `seed` may be an int or an integer tensor of seeds (one key each)."""
    s = _int64(seed, device)
    return torch.stack([(s >> 32) & _MASK, s & _MASK], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in(key, data)` for 32-bit `data` (int or tensor
    broadcasting against the key's leading dimensions)."""
    d = _int64(data, key.device) & _MASK
    y1, y2 = threefry2x32(key[..., 0], key[..., 1],
                          torch.zeros_like(d), d)
    return torch.stack([y1, y2], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split(key, num)` (partitionable layout): ``[num, 2]``,
    or ``[..., num, 2]`` for a batch of keys."""
    idx = torch.arange(num, dtype=torch.int64, device=key.device)
    y1, y2 = threefry2x32(key[..., 0, None], key[..., 1, None],
                          torch.zeros_like(idx), idx)
    return torch.stack([y1, y2], dim=-1)


def random_bits(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """32 random bits per element of `shape` (as int64 in [0, 2**32)),
    ``[*key.shape[:-1], *shape]``: hash of the flat index's (hi, lo)."""
    n = math.prod(shape)
    flat = torch.arange(n, dtype=torch.int64, device=key.device)
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(*lead, *([1] * len(shape)))
    k2 = key[..., 1].reshape(*lead, *([1] * len(shape)))
    y1, y2 = threefry2x32(k1, k2, (flat >> 32).reshape(shape),
                          (flat & _MASK).reshape(shape))
    return y1 ^ y2


def uniform(key: torch.Tensor, shape: tuple[int, ...], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """`jax.random.uniform` in float32: 23 random mantissa bits under an
    exponent of one give [1, 2), shifted and scaled to [minval, maxval).
    The bounds are float32 values (the callers' are), so their difference
    taken in Python's float64 rounds to float32's difference: the scalars
    give the bits that float32 tensors would."""
    bits = random_bits(key, shape)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    return (floats * (maxval - minval) + minval).clamp_min(minval)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2)))


def normal(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """`jax.random.normal` in float32: sqrt(2) * erfinv(u), u uniform on
    (-1, 1)."""
    u = uniform(key, shape, _NORMAL_LO, 1.0)
    return torch.erfinv(u) * _SQRT2


_TINY = float(np.finfo(np.float32).tiny)


def gumbel(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """`jax.random.gumbel` in float32, mode "low" (jax 0.9.0's default):
    -log(-log(u)), u uniform on [tiny, 1)."""
    return -torch.log(-torch.log(uniform(key, shape, _TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """`jax.random.categorical(key, logits)` over the last axis, with
    replacement: argmax(logits + gumbel(key, logits.shape)), the first
    index among equal maxima. `key` ``[..., 2]`` batches the rows of
    `logits` ``[..., K]`` (the reference's vmap over tasks)."""
    g = gumbel(key, (logits.shape[-1],))
    return torch.argmax(g + logits.float(), dim=-1)
