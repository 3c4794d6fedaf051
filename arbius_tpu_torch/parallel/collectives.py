"""Collectives in lane form: ordered tensor operations over the lanes'
tensors.

Twin of arbius_tpu/parallel/collectives.py. Where the reference's
functions run inside `shard_map` on one device's shard, these take
`xs`, one tensor per lane, and return one per lane, each on its lane's
device (the device of that lane's input). With `mesh` given, `xs` holds
every lane of the mesh in lane order and the collective runs within
each group of lanes that differ only along `axis_name`; without it `xs`
is one such group, in `axis_name`'s order. Every result is a fixed
function of the inputs: a gather concatenates in lane order, `psum` adds
in lane order, `ppermute` re-indexes the lanes, `all_to_all` splits and
concatenates.
"""
from __future__ import annotations

from typing import Sequence

import torch

from arbius_tpu_torch.quant.core import _RECIPROCAL, _SCALE_FLOOR
from arbius_tpu_torch.quant.modes import (
    DEFAULT_MODE,
    INT8_BOUND,
    validate_mode,
)

Lanes = Sequence[torch.Tensor]


def _groups(xs: Lanes, axis_name: str, mesh) -> list[list[int]]:
    if mesh is None:
        return [list(range(len(xs)))]
    if len(xs) != mesh.size:
        raise ValueError(f"{len(xs)} tensors for a mesh of {mesh.size} "
                         "lanes")
    return mesh.groups(axis_name)


def ppermute(xs: Lanes, axis_name: str, perm, *, mesh=None) -> list:
    """`lax.ppermute`: the lane at index i of its group sends to index j
    for each (i, j) in `perm`; a lane no one sends to gets zeros."""
    out: list = [None] * len(xs)
    for g in _groups(xs, axis_name, mesh):
        got = {j: xs[g[i]] for i, j in perm}
        for j, lane in enumerate(g):
            src = got.get(j)
            out[lane] = (torch.zeros_like(xs[lane]) if src is None
                         else src.to(xs[lane].device))
    return out


def ring_pass(xs: Lanes, axis_name: str, *, reverse: bool = False,
              mesh=None) -> list:
    """Each lane's tensor moves to the next lane of the ring (the
    previous one with `reverse`): the step of ring attention."""
    n = len(_groups(xs, axis_name, mesh)[0])
    shift = -1 if reverse else 1
    return ppermute(xs, axis_name, [(i, (i + shift) % n) for i in range(n)],
                    mesh=mesh)


def all_gather_seq(xs: Lanes, axis_name: str, *, axis: int,
                   mesh=None) -> list:
    """Every lane gets the group's shards concatenated along `axis` in
    lane order (`lax.all_gather(..., tiled=True)`)."""
    out: list = [None] * len(xs)
    for g in _groups(xs, axis_name, mesh):
        for lane in g:
            dev = xs[lane].device
            out[lane] = torch.cat([xs[j].to(dev) for j in g], dim=axis)
    return out


def psum(xs: Lanes, axis_name: str, *, mesh=None) -> list:
    """Every lane gets the group's sum, added in lane order."""
    out: list = [None] * len(xs)
    for g in _groups(xs, axis_name, mesh):
        total = xs[g[0]]
        for j in g[1:]:
            total = total + xs[j].to(total.device)
        for lane in g:
            out[lane] = total.to(xs[lane].device)
    return out


def all_to_all(xs: Lanes, axis_name: str, *, split_axis: int,
               concat_axis: int, mesh=None) -> list:
    """`lax.all_to_all(..., tiled=True)`: each lane splits its tensor in
    n equal parts along `split_axis` and lane i gets every lane's part i,
    concatenated along `concat_axis` in lane order."""
    out: list = [None] * len(xs)
    for g in _groups(xs, axis_name, mesh):
        n = len(g)
        for j in g:
            if xs[j].shape[split_axis] % n:
                raise ValueError(
                    f"all_to_all: axis {split_axis} of size "
                    f"{xs[j].shape[split_axis]} does not split over {n} "
                    "lanes")
        parts = [xs[j].chunk(n, dim=split_axis) for j in g]
        for i, lane in enumerate(g):
            dev = xs[lane].device
            out[lane] = torch.cat([p[i].to(dev) for p in parts],
                                  dim=concat_axis)
    return out


def quantized_ring_allreduce(xs: Lanes, axis_name: str, *,
                             mode: str = "int8", mesh=None) -> list:
    """EQuARX-style quantized ring allreduce: the sum over the group with
    every wire payload quantized to `mode` (int8/fp8, 1 byte per element),
    accumulation in float32.

    The reference's schedule exactly: the flattened tensor splits into n
    ring chunks; phase 1 is a ring reduce-scatter (each hop dequantizes
    the incoming chunk, adds it in float32 and requantizes before
    forwarding), phase 2 ring-all-gathers the fully reduced chunks, still
    quantized. Every lane dequantizes every chunk from the same quantized
    form, so the n replicas are bit-identical. The arithmetic is the
    reference's as XLA compiles it (bit-equal to its jitted program on
    the CPU): a chunk's scale is `max(absmax, 1e-12)` times the float32
    reciprocal of the bound, and a hop's `row + q * scale` is one fused
    multiply-add (the float32 rounding of the exact value, taken here
    through float64, where q * scale is exact). `bf16` is the plain
    `psum`.

    Error model: one quantization per hop bounds the relative error by
    ~n / bound (n - 1 requantizations and the gather)."""
    validate_mode(mode)
    if mode == DEFAULT_MODE:
        return psum(xs, axis_name, mesh=mesh)
    out: list = [None] * len(xs)
    for g in _groups(xs, axis_name, mesh):
        for lane, y in zip(g, _ring_allreduce([xs[j] for j in g], mode)):
            out[lane] = y
    return out


def _quantize(c: torch.Tensor, mode: str):
    s = c.abs().amax().clamp_min(_SCALE_FLOOR) * _RECIPROCAL[mode]
    if mode == "int8":
        q = (c / s).round().clamp(-INT8_BOUND, INT8_BOUND).to(torch.int8)
    else:
        q = (c / s).to(torch.float8_e4m3fn)
    return q, s


def _dequantize(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return q.float() * s


def _dequantize_add(q: torch.Tensor, s: torch.Tensor,
                    acc: torch.Tensor) -> torch.Tensor:
    """acc + q * s rounded once to float32, as a fused multiply-add: in
    float64 q * s (at most 4 + 24 significant bits) is exact, and the sum
    rounds to float32 as the exact value does."""
    return (acc.double() + q.double() * s.double()).float()


def _ring_allreduce(group: list[torch.Tensor], mode: str) -> list:
    n = len(group)
    if n == 1:
        return list(group)
    shape, dtype = group[0].shape, group[0].dtype
    flat = [x.to(torch.float32).reshape(-1) for x in group]
    size = flat[0].numel()
    pad = (-size) % n
    chunks = [torch.nn.functional.pad(f, (0, pad)).reshape(n, -1)
              for f in flat]

    def fwd(payload: list) -> list:
        # lane i's payload arrives at lane i + 1
        return [payload[(i - 1) % n].to(group[i].device) for i in range(n)]

    # phase 1: after step t lane i has folded t + 1 contributions into
    # chunk (i - t - 1) % n; after n - 1 steps chunk (i + 1) % n is whole
    partial = [c.clone() for c in chunks]
    for t in range(n - 1):
        sent = [_quantize(partial[i][(i - t) % n], mode) for i in range(n)]
        qs = fwd([q for q, _ in sent])
        ss = fwd([s for _, s in sent])
        for i in range(n):
            r = (i - t - 1) % n
            partial[i][r] = _dequantize_add(qs[i], ss[i], partial[i][r])

    # phase 2: every lane's value of every chunk, its own included, comes
    # from the same quantized form
    out = [torch.zeros_like(c) for c in chunks]
    cur = [_quantize(partial[i][(i + 1) % n], mode) for i in range(n)]
    for i in range(n):
        out[i][(i + 1) % n] = _dequantize(*cur[i])
    for t in range(1, n):
        qs = fwd([q for q, _ in cur])
        ss = fwd([s for _, s in cur])
        cur = list(zip(qs, ss))
        for i in range(n):
            out[i][(i - t + 1) % n] = _dequantize(*cur[i])
    return [o.reshape(-1)[:size].reshape(shape).to(dtype) for o in out]


def halo_exchange(xs: Lanes, axis_name: str, *, axis: int, halo: int,
                  mesh=None) -> list:
    """Pad each lane's shard of a sharded axis with `halo` frames from
    each neighbour (non-periodic: the edge lanes get zeros), so a
    temporal convolution of size 2 * halo + 1 stays local."""
    for x in xs:
        if halo > x.shape[axis]:
            raise ValueError(
                f"halo {halo} exceeds per-shard extent {x.shape[axis]} on "
                f"axis {axis}; neighbours only hold {x.shape[axis]} frames")
    out: list = [None] * len(xs)
    for g in _groups(xs, axis_name, mesh):
        n = len(g)
        for i, lane in enumerate(g):
            x = xs[lane]
            if i > 0:
                nb = xs[g[i - 1]]
                left = nb.narrow(axis, nb.shape[axis] - halo, halo)
            else:
                left = torch.zeros_like(x.narrow(axis, 0, halo))
            if i < n - 1:
                right = xs[g[i + 1]].narrow(axis, 0, halo)
            else:
                right = torch.zeros_like(x.narrow(axis, 0, halo))
            out[lane] = torch.cat([left.to(x.device), x, right.to(x.device)],
                                  dim=axis)
    return out
