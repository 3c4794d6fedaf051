"""Mesh construction for the port: a declarative axis spec -> a `Mesh` of
lanes, one `torch.device` per lane.

Twin of arbius_tpu/parallel/mesh.py. JAX's `shard_map` and GSPMD run one
program over N devices from one process; the port does the same with
lanes. A `Mesh` holds the axis sizes in AXIS_ORDER and one device per
lane (lane order is row-major over AXIS_ORDER, as a jax mesh's device
array is laid out); a sharded program runs each lane's shard in lane
order (`Mesh.run`) and every collective is an ordered tensor operation
over the lanes' tensors (parallel/collectives.py). On a host with
several cards the lanes sit on cuda:0..N-1 and CUDA's asynchronous
launches overlap them.

The visible lanes are the host's CUDA devices, or, where a caller asked
for them explicitly with `set_virtual_lanes(n, device)`, n lanes on that
device type: the counterpart of the reference tests'
`force_cpu_devices(8)`. Tests set it on the CPU; on a one-card host
`set_virtual_lanes(2, "cuda")` puts two lanes on cuda:0. It is never a
default: without it a mesh larger than the host's cards is refused.

`validate_axes` is the reference's, JAX-free (node/config.py imports it
from here, as the reference's does); `abstract_mesh` (graph tracing)
waits for ROADMAP queue 1 item 12.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

__all__ = ["AXIS_ORDER", "Mesh", "MeshSpec", "build_mesh", "lane_devices",
           "lane_platform", "local_mesh", "mesh_tag", "on_device",
           "set_virtual_lanes", "validate_axes", "virtual_lanes"]

# Canonical axis order, outermost -> innermost. pp sits outermost: pipeline
# stage hand-offs are point-to-point and low-volume, so they tolerate the
# weakest links (DCN across hosts) while tp keeps the strongest (ICI).
AXIS_ORDER = ("pp", "dp", "sp", "tp")


def validate_axes(sizes: dict, n_devices: int | None = None,
                  *, where: str = "mesh") -> dict[str, int]:
    """Validate a requested axis->size mapping against the axis registry
    and (when given) the visible device count, with boot-quality errors.

    Before this check existed a bad shape survived until deep inside
    XLA device placement and surfaced as an opaque reshape failure; a
    miner operator mistyping ``{"dp": 4, "tp": 4}`` on an 8-chip host
    deserves one sentence naming the fix. Returns the full
    ``{axis: size}`` dict over AXIS_ORDER (missing axes filled with 1).
    """
    unknown = sorted(set(sizes) - set(AXIS_ORDER))
    if unknown:
        raise ValueError(
            f"{where}: unknown axis name(s) {unknown} — valid axes are "
            f"{list(AXIS_ORDER)} (dp=data/tasks, sp=sequence/frames, "
            "tp=tensor, pp=pipeline stages)")
    full: dict[str, int] = {}
    for axis in AXIS_ORDER:
        v = sizes.get(axis, 1)
        if not isinstance(v, int) or isinstance(v, bool) or v < 1:
            raise ValueError(
                f"{where}: axis {axis!r} must be a positive integer, got "
                f"{v!r}")
        full[axis] = v
    if n_devices is not None:
        want = int(np.prod(list(full.values())))
        if want > n_devices:
            hint = (" — shrink an axis, or (CPU testing) set XLA_FLAGS="
                    f"--xla_force_host_platform_device_count={want}")
            raise ValueError(
                f"{where}: shape {{{', '.join(f'{a}: {n}' for a, n in sizes.items())}}} "
                f"needs {want} devices but jax sees {n_devices}{hint}")
    return full


# (lane count, device type) set by set_virtual_lanes, else None
_VIRTUAL: tuple[int, str] | None = None


def set_virtual_lanes(n: int | None, device: str = "cpu"
                      ) -> tuple[int, str] | None:
    """Make `lane_devices` see `n` lanes on `device`'s type (cpu: all on
    the CPU; cuda: lane i on cuda:(i mod the card count)); None clears
    it. Returns the previous setting."""
    global _VIRTUAL
    prev = _VIRTUAL
    if n is None:
        _VIRTUAL = None
        return prev
    kind = torch.device(device).type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"unsupported lane device {device!r}")
    if not isinstance(n, int) or n < 1:
        raise ValueError(f"virtual lane count must be a positive int, "
                         f"got {n!r}")
    _VIRTUAL = (n, kind)
    return prev


@contextlib.contextmanager
def virtual_lanes(n: int, device: str = "cpu"):
    """`set_virtual_lanes(n, device)` for the body, restored on exit."""
    prev = set_virtual_lanes(n, device)
    try:
        yield
    finally:
        set_virtual_lanes(*(prev or (None,)))


def lane_platform(device: str | torch.device | None = None) -> str:
    """The device type lanes sit on: `device`'s, else the virtual
    lanes', else cuda."""
    if device is not None:
        return torch.device(device).type
    return _VIRTUAL[1] if _VIRTUAL is not None else "cuda"


def lane_devices(device: str | torch.device | None = None
                 ) -> list[torch.device]:
    """The lanes a mesh may use, one device each, on `lane_platform`'s
    type: the virtual lanes where they were set for that type, else the
    host's CUDA devices (none without CUDA) or the one CPU."""
    kind = lane_platform(device)
    if _VIRTUAL is not None and _VIRTUAL[1] == kind:
        n = _VIRTUAL[0]
        if kind == "cpu":
            return [torch.device("cpu")] * n
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("virtual CUDA lanes were set, but this host "
                               "has no CUDA device")
        return [torch.device("cuda", i % cards) for i in range(n)]
    if kind == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


class Mesh:
    """Axis sizes in AXIS_ORDER and one device per lane. Lane l's
    coordinates are l's digits in the mixed radix of the axis sizes,
    outermost axis first."""

    def __init__(self, sizes: dict[str, int],
                 devices: Sequence[torch.device]):
        self.shape = {a: int(sizes.get(a, 1)) for a in AXIS_ORDER}
        self.devices = tuple(torch.device(d) for d in devices)
        if len(self.devices) != self.size:
            raise ValueError(f"mesh {self.shape} has {self.size} lanes, got "
                             f"{len(self.devices)} devices")

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def coords(self, lane: int) -> dict[str, int]:
        out = {}
        for a in reversed(AXIS_ORDER):
            lane, out[a] = divmod(lane, self.shape[a])
        return {a: out[a] for a in AXIS_ORDER}

    def lane_of(self, coords: dict[str, int]) -> int:
        lane = 0
        for a in AXIS_ORDER:
            lane = lane * self.shape[a] + coords.get(a, 0)
        return lane

    def groups(self, axis: str) -> list[list[int]]:
        """The lanes that differ only along `axis`, one list per group in
        lane order of its first lane, each ordered by `axis`'s index."""
        if axis not in self.shape:
            raise ValueError(f"unknown mesh axis {axis!r}")
        out = []
        for lane in range(self.size):
            c = self.coords(lane)
            if c[axis] == 0:
                out.append([self.lane_of({**c, axis: i})
                            for i in range(self.shape[axis])])
        return out

    def run(self, fn, *lane_args) -> list:
        """A sharded program: `fn(lane, *args)` for each lane in lane
        order, each `lane_args` a per-lane sequence, with the lane's card
        current (so its kernels and events go to that card's stream)."""
        out = []
        for lane, dev in enumerate(self.devices):
            with on_device(dev):
                out.append(fn(lane, *(a[lane] for a in lane_args)))
        return out

    def __repr__(self) -> str:
        return f"Mesh({mesh_tag(self)}, {len(set(self.devices))} devices)"


def on_device(device: torch.device):
    """The context that makes `device` current: its card for CUDA,
    nothing for the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


@dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape. -1 on exactly one axis means 'absorb the rest'."""

    dp: int = -1
    sp: int = 1
    tp: int = 1
    pp: int = 1

    def resolve(self, n_devices: int) -> dict[str, int]:
        sizes = {"pp": self.pp, "dp": self.dp, "sp": self.sp, "tp": self.tp}
        bad = {k: v for k, v in sizes.items() if v < 1 and v != -1}
        if bad:
            raise ValueError(f"axis sizes must be >= 1 (or -1 wildcard): {bad}")
        wild = [k for k, v in sizes.items() if v == -1]
        if len(wild) > 1:
            raise ValueError(f"at most one wildcard axis, got {wild}")
        fixed = math.prod(v for v in sizes.values() if v != -1)
        if wild:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes {sizes}")
            sizes[wild[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(f"mesh {sizes} wants {fixed} devices, have {n_devices}")
        return sizes


def build_mesh(spec: MeshSpec | None = None, devices=None) -> Mesh:
    """A Mesh over `devices` (default: every lane `lane_devices` sees)
    with the spec's shape, lanes in the order given."""
    spec = spec or MeshSpec()
    devices = list(lane_devices() if devices is None else devices)
    return Mesh(spec.resolve(len(devices)), devices)


def mesh_tag(mesh) -> str:
    """Filename-safe layout tag: non-trivial axes only, canonical order —
    ``dp2.sp2.tp2``; the all-ones layout is ``single``."""
    parts = [f"{a}{mesh.shape[a]}" for a in AXIS_ORDER
             if mesh.shape.get(a, 1) > 1]
    return ".".join(parts) if parts else "single"


def local_mesh(n: int | None = None, spec: MeshSpec | None = None) -> Mesh:
    """Mesh over the first n lanes (testing / partial-slice use)."""
    devs = lane_devices()
    if n is not None:
        if n > len(devs):
            raise ValueError(f"asked for {n} devices, have {len(devs)}")
        devs = devs[:n]
    return build_mesh(spec or MeshSpec(), devices=devs)
