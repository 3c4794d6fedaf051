"""Sharding rules for the port: place state dicts and batches on a mesh's
lanes.

Twin of arbius_tpu/parallel/sharding.py. A `LaneSharding` is the twin of
jax's `NamedSharding`: a mesh and a spec with one entry per leading
dimension (an axis name, a tuple of axis names, or None), the tuple a
`PartitionSpec` is. `place` cuts a tensor into each lane's block and
moves it to the lane's device; a lane on the tensor's own device gets a
view, so lanes sharing a card share a replicated tensor's storage. The
result is a `Sharded`: the lanes' blocks with the global shape, which
`gather` puts back together.

Parameter placement is rule-based as in the reference: (path regex,
spec) pairs matched against a leaf's path (nested dict keys joined with
'/', or a state dict's own key), first match wins, replicated by default.
The port's tensor-parallel rule table for the model families comes with
their tp layouts (ROADMAP queue 1 item 11); the rules here are whatever
a caller passes (the image probe's column split).
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from arbius_tpu_torch.parallel.mesh import Mesh


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _axis_size(mesh: Mesh, entry) -> int:
    return math.prod(mesh.shape[a] for a in _axes(entry))


@dataclass(frozen=True)
class LaneSharding:
    """How a tensor lies on `mesh`'s lanes: dimension i split over the
    axes `spec[i]` names (the first outermost), the others whole."""

    mesh: Mesh
    spec: tuple = ()

    def block(self, shape, lane: int) -> tuple[slice, ...]:
        """The index of `lane`'s block of a tensor of global `shape`."""
        coords = self.mesh.coords(lane)
        out = []
        for i, entry in enumerate(self.spec):
            n, idx = 1, 0
            for a in _axes(entry):
                n *= self.mesh.shape[a]
                idx = idx * self.mesh.shape[a] + coords[a]
            size = shape[i] // n
            out.append(slice(idx * size, (idx + 1) * size))
        return tuple(out)

    def place(self, t) -> "Sharded":
        """Each lane's block of `t`, on the lane's device."""
        t = torch.as_tensor(t)
        for i, entry in enumerate(self.spec):
            if t.shape[i] % _axis_size(self.mesh, entry):
                raise ValueError(
                    f"dimension {i} of {tuple(t.shape)} does not split over "
                    f"{entry!r}")
        return Sharded(self, [t[self.block(t.shape, lane)].to(dev)
                              for lane, dev in enumerate(self.mesh.devices)],
                       tuple(t.shape))


class Sharded:
    """A tensor placed on a mesh: one block per lane (`shards`, lane
    order) under `sharding`, of global `shape`."""

    def __init__(self, sharding: LaneSharding, shards: list, shape):
        self.sharding = sharding
        self.shards = list(shards)
        self.shape = tuple(shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def gather(self) -> torch.Tensor:
        """The global tensor, on lane 0's device, each block from the
        first lane that holds it."""
        out = torch.empty(self.shape, dtype=self.dtype,
                          device=self.shards[0].device)
        seen = set()
        for lane, shard in enumerate(self.shards):
            idx = self.sharding.block(self.shape, lane)
            key = tuple((s.start, s.stop) for s in idx)
            if key not in seen:
                seen.add(key)
                out[idx] = shard.to(out.device)
        return out


def sharding_for(mesh: Mesh, *spec) -> LaneSharding:
    return LaneSharding(mesh, tuple(spec))


def replicated(mesh: Mesh) -> LaneSharding:
    return LaneSharding(mesh, ())


def batch_sharding(mesh: Mesh, ndim: int, axis: int = 0) -> LaneSharding:
    """Shard dimension `axis` of an ndim-array over dp (the task batch)."""
    spec = [None] * ndim
    spec[axis] = "dp"
    return LaneSharding(mesh, tuple(spec))


def _walk(tree, fn, path=()):
    if isinstance(tree, dict) and set(tree) == {"qs", "qv"}:
        # a quantized leaf: its two parts are leaves
        return {k: fn("/".join(path + (k,)), v) for k, v in tree.items()}
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (str(k),)) for k, v in tree.items()}
    return fn("/".join(path), tree)


def sharding_tree(params: Any, mesh: Mesh,
                  rules: tuple[tuple[str, tuple], ...] = ()) -> Any:
    """The tree of LaneShardings for `params` (tensors or arrays): each
    leaf gets its first matching rule's sharding, else replication.

    A rule that does not fit its leaf (more spec entries than the leaf
    has dimensions, or a dimension its axes do not divide) replicates
    the leaf. A quantized leaf's `qv` follows its kernel's rule and `qs`,
    the scale per output channel, the rule's last entry."""
    compiled = [(re.compile(pat), tuple(spec)) for pat, spec in rules]

    def pick(name: str, leaf):
        quant_part = None
        if name.endswith("/qv") or name.endswith("/qs"):
            quant_part, name = name[-2:], name[:-3]
        shape = tuple(np.shape(leaf))
        for pat, spec in compiled:
            if pat.match(name):
                if quant_part == "qs":
                    spec = (spec[-1],) if spec else ()
                ok = len(spec) <= len(shape) and all(
                    e is None or shape[i] % _axis_size(mesh, e) == 0
                    for i, e in enumerate(spec))
                if ok:
                    return LaneSharding(mesh, spec)
                break
        return LaneSharding(mesh, ())

    return _walk(params, pick)


def shard_params(params: Any, mesh: Mesh,
                 rules: tuple[tuple[str, tuple], ...] = ()) -> Any:
    """Place every leaf with its rule's sharding (default replicated):
    the tree with each leaf a `Sharded`."""
    shardings = sharding_tree(params, mesh, rules)

    def place(tree, sh):
        if isinstance(sh, LaneSharding):
            return sh.place(tree)
        return {k: place(tree[k], sh[k]) for k in sh}

    return place(params, shardings)


def lane_tree(placed: Any, lane: int) -> Any:
    """Lane `lane`'s blocks of a tree `shard_params` placed."""
    if isinstance(placed, Sharded):
        return placed.shards[lane]
    return {k: lane_tree(v, lane) for k, v in placed.items()}
