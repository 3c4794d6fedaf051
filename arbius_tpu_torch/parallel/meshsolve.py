"""meshsolve for the port: the mesh on the live solve path.

Twin of arbius_tpu/parallel/meshsolve.py over a mesh of lanes
(parallel/mesh.py): the boot-time half (config -> validated mesh -> obs
surface) and the dispatch-time half (batch placement, canonical gather,
collective-traffic accounting) that node/factory.py, node/node.py and
the pipelines share, and the sharded probe runners.

Determinism on the card. cuBLAS and cuDNN choose kernels by batch size,
so a model pipeline never splits a canonical batch over dp: each solve
dispatch runs a full canonical batch on one lane (the runners take the
lanes in turn), so every lane's program is the single-device program and
a dp mesh's CIDs equal mesh-off's by construction. `check_mesh_contract`
therefore has no canonical_batch % dp gate: no batch is ever cut. The
layout and axis-size gates are the reference's. `batch_specs` and
`shard_batch` split a batch over dp where it divides, as the reference's
do: the probes use them, whose bytes are batch-size-invariant by
construction.

The probes are the reference's layout-invariance oracles in lane form:
per-sample threefry draws (arbius_tpu_torch/random.py), a column-parallel
product accumulated in a fixed order (elementwise, so no lane's bytes
depend on its batch or column count), concatenation-only gathers, and an
int32 checksum summed over the lanes (`psum`, exact in any order). Their
int8 and fp8 modes dequantize the probe weights in-program; the sequence
probe's folds its cross-shard temporal mean through the lane-form
`quantized_ring_allreduce`.

Graph tracing (`golden_mesh`, `trace_specs`) waits for ROADMAP queue 1
item 12.
"""
# detlint: enforce[DET101,DET102,DET103,DET104,DET105]
from __future__ import annotations

import logging
import math
import zlib
from dataclasses import dataclass

import numpy as np
import torch

from arbius_tpu_torch.parallel.mesh import (
    AXIS_ORDER,
    MeshSpec,
    build_mesh,
    lane_devices,
    lane_platform,
    mesh_tag,
    on_device,
    validate_axes,
)

log = logging.getLogger("arbius.meshsolve")

_OBS_HELP_DEVICES = ("Devices in the solve mesh (product of the "
                     "configured axis sizes); 0 or absent = single-device")
_OBS_HELP_BYTES = ("Estimated cross-chip collective traffic on the solve "
                   "path, by mesh axis — compile-time byte-count model "
                   "(docs/multichip.md), not a profiler")


def boot_mesh(mesh_cfg: dict | None, *, registry=None, device=None):
    """Config -> a mesh of lanes, or None for the single-device path.

    Validates the requested shape against the lanes `lane_devices`
    sees (the host's cards, or the virtual lanes a caller set) with the
    reference's boot-quality error, builds the mesh over the first
    ``prod(axes)`` of them and (when an obs registry is given) publishes
    `arbius_mesh_devices`. A mesh of one lane asks the host for none."""
    if registry is not None:
        n = 1
        if mesh_cfg:
            for v in mesh_cfg.values():
                n *= int(v)
        registry.gauge("arbius_mesh_devices", _OBS_HELP_DEVICES).set(
            float(n if mesh_cfg else 0))
    if not mesh_cfg:
        return None
    want = math.prod(validate_axes(dict(mesh_cfg), None,
                                   where="mesh config").values())
    lanes = lane_devices(device)
    if want == 1 and not lanes:
        # a one-lane mesh is the single-device program: it names the
        # platform's device (cuda, unless the caller set CPU lanes) and
        # asks the host for no lane
        lanes = [torch.device(lane_platform(device))]
    sizes = validate_axes(dict(mesh_cfg), len(lanes), where="mesh config")
    spec = MeshSpec(dp=sizes["dp"], sp=sizes["sp"], tp=sizes["tp"],
                    pp=sizes["pp"])
    mesh = build_mesh(spec, devices=lanes[:want])
    log.info("solve mesh up: %s over %d lanes on %d device(s)",
             mesh_tag(mesh), want, len(set(mesh.devices)))
    return mesh


# non-dp axes are goldened at this size (the reference's per-layout
# goldens trace each MESH_LAYOUTS entry with every axis at 2); dp is the
# one size-free axis
GOLDEN_AXIS_SIZE = 2


def golden_layout_tag(axes) -> str:
    """Golden-key mesh tag for a MESH_LAYOUTS entry ("single" for ())."""
    return ".".join(f"{a}{GOLDEN_AXIS_SIZE}" for a in AXIS_ORDER
                    if a in axes) or "single"


def check_mesh_contract(mesh, contracts: dict, canonical_batch: int) -> None:
    """Boot-time audit of the configured mesh against each enabled
    family's shipped mesh contract. `contracts` maps template name -> the
    family's pipeline module, which publishes the contract as data
    (`MESH_LAYOUTS`); node/factory.mesh_contracts builds the dict.

    The active layout (axes of size > 1) must be one of the family's
    `MESH_LAYOUTS`, and every non-dp axis must run at the goldened size
    (`GOLDEN_AXIS_SIZE`): a layout or size with no golden could emit
    CIDs no other honest miner reproduces. Unlike the reference there is
    no canonical_batch % dp gate (and `MESH_BATCH_HARD` asks nothing):
    every lane runs whole canonical batches, so no batch is cut."""
    if mesh is None:
        return
    active = tuple(a for a in AXIS_ORDER if mesh.shape.get(a, 1) > 1)
    if contracts:
        for a in active:
            if a != "dp" and mesh.shape[a] != GOLDEN_AXIS_SIZE:
                raise ValueError(
                    f"mesh {a}={mesh.shape[a]} is not a goldened size: "
                    f"the per-layout graphlint goldens pin {a}="
                    f"{GOLDEN_AXIS_SIZE}, and a different {a} size is a "
                    "different reduction order — a determinism class no "
                    "golden pins (docs/multichip.md; dp is the only "
                    "size-free axis)")
    for family in sorted(contracts):
        layouts = getattr(contracts[family], "MESH_LAYOUTS", ())
        if active not in layouts:
            shipped = ", ".join("·".join(l) for l in layouts) or "(none)"
            raise ValueError(
                f"mesh layout {'·'.join(active) or '(all axes 1)'} is "
                f"not a shipped determinism class for template {family} "
                f"(shipped: {shipped}): no graphlint golden pins its "
                "program, so its CIDs are outside the cross-miner "
                f"contract — disable {family}, change the mesh, or ship "
                "the layout (MESH_LAYOUTS + regenerated goldens, "
                "docs/multichip.md)")
    dp = mesh.shape.get("dp", 1)
    if dp > 1 and contracts:
        log.info("mesh dp=%d: each solve dispatch runs a whole canonical "
                 "batch of %d on one lane, the lanes in turn",
                 dp, canonical_batch)


# -- dispatch-time placement ------------------------------------------------

def batch_specs(mesh, batch: int):
    """(spec, sharded) for a bucket of size `batch`: `spec(ndim)` shards
    the leading axis over dp when it divides, else replicates (dp lanes
    idle rather than erroring)."""
    from arbius_tpu_torch.parallel.sharding import batch_sharding, replicated

    dp = mesh.shape.get("dp", 1)
    sharded = dp > 1 and batch % dp == 0

    def spec(ndim: int):
        return batch_sharding(mesh, ndim) if sharded else replicated(mesh)

    return spec, sharded


def shard_batch(mesh, *arrays):
    """Place batch-leading arrays for one dispatch on the lanes (one
    `batch_specs` decision for the whole argument list); `mesh=None`
    returns them untouched."""
    if mesh is None:
        return arrays
    spec, _ = batch_specs(mesh, int(np.shape(arrays[0])[0]))
    return tuple(spec(np.ndim(a)).place(a) for a in arrays)


def gather_canonical(out) -> np.ndarray:
    """The result in canonical order on the host: a `Sharded` result is
    reassembled block by block (sample i of the output is sample i of
    the bucket on every layout)."""
    from arbius_tpu_torch.parallel.sharding import Sharded

    if isinstance(out, Sharded):
        out = out.gather()
    if isinstance(out, torch.Tensor):
        return out.cpu().numpy()
    return np.asarray(out)


# -- collective-traffic accounting ------------------------------------------

def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def estimate_collective_bytes(mesh, out_shape, out_dtype, params=None,
                              *, batch_sharded: bool = True,
                              wire_dtype=None) -> dict[str, int]:
    """Per-dispatch cross-lane traffic estimate, by mesh axis (a
    byte-count model, not a profiler):

      dp  the gather of the output bucket: each lane holds 1/dp of it
          and receives the rest (zero for a replicated batch);
      sp  the same gather model on the output;
      tp  2 (tp - 1) / tp of every tp-sharded parameter's bytes (a ring
          allreduce per sharded kernel), at `wire_dtype`'s width where a
          quantized collective moves 1-byte elements.

    Axes of size 1 contribute nothing. Returns {axis: bytes}."""
    est: dict[str, int] = {}
    if mesh is None:
        return est
    out_bytes = math.prod(out_shape) * _itemsize(out_dtype)
    if batch_sharded:
        for axis in ("dp", "sp"):
            n = mesh.shape.get(axis, 1)
            if n > 1:
                est[axis] = out_bytes * (n - 1) // n
    tp = mesh.shape.get("tp", 1)
    if tp > 1 and params is not None:
        sharded = 0
        for leaf in _leaves(params):
            spec = getattr(getattr(leaf, "sharding", None), "spec", None)
            if spec is not None and any(
                    s == "tp" or (isinstance(s, tuple) and "tp" in s)
                    for s in spec):
                width = _itemsize(wire_dtype if wire_dtype is not None
                                  else leaf.dtype)
                sharded += math.prod(leaf.shape) * width
        if sharded:
            est["tp"] = 2 * sharded * (tp - 1) // tp
    return est


def record_bucket_estimate(cache: dict, bucket_key, mesh, out, batch: int,
                           *, params=None, wire_dtype=None,
                           tag: str | None = None) -> None:
    """Record one dispatch's traffic, estimating at most once per bucket
    (the estimate is pure in mesh, bucket shape and parameter placement);
    a replicated-batch bucket is not charged dp/sp gathers."""
    if mesh is None:
        return
    est = cache.get(bucket_key)
    if est is None:
        _, sharded = batch_specs(mesh, batch)
        est = estimate_collective_bytes(mesh, out.shape, out.dtype,
                                        params=params, batch_sharded=sharded,
                                        wire_dtype=wire_dtype)
        cache[bucket_key] = est
    record_collective_bytes(est, tag=tag)


def record_collective_bytes(est: dict[str, int],
                            tag: str | None = None) -> None:
    """Add one dispatch's estimated traffic to
    `arbius_collective_bytes_total{axis}` in the ambient obs registry
    (no-op outside a node context)."""
    if not est:
        return
    from arbius_tpu_torch.obs import current_obs

    obs = current_obs()
    if obs is None:
        return
    c = obs.registry.counter("arbius_collective_bytes_total",
                             _OBS_HELP_BYTES, labelnames=("axis",))
    for axis, n in est.items():
        c.inc(float(n), axis=axis)
    if obs.perfscope is not None:
        obs.perfscope.record_collectives(tag, est)


# -- sharded probe runners --------------------------------------------------

_PROBE_DIM = 8


def _probe_params(dim: int = _PROBE_DIM) -> np.ndarray:
    # fixed, seed-free weights: the probe's identity is its program
    return (np.arange(dim * dim, dtype=np.float32).reshape(dim, dim)
            % 7.0) / 7.0 - 0.5


def _quantize_probe(raw: torch.Tensor, mode: str):
    from arbius_tpu_torch.quant.core import QuantAxis, quantize_leaf

    if mode == "bf16":
        return raw
    return quantize_leaf(raw, mode, QuantAxis(tuple(raw.shape), 1))


def _dequantize_probe(params):
    """float32 probe weights: a quantized {"qs", "qv"} leaf (output
    channels last) through the float32-scale dequantization."""
    from arbius_tpu_torch.quant.core import (
        QuantAxis,
        dequantize_leaf,
        is_quantized_leaf,
    )

    if is_quantized_leaf(params):
        shape = tuple(params["qv"].shape)
        return dequantize_leaf(params, QuantAxis(shape, len(shape) - 1))
    return params


def _product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ w [K, N] accumulated k = 0, 1, ... one elementwise
    product and sum at a time: each output element is the same float32
    sum whatever the batch or column count around it."""
    acc = x[..., 0:1] * w[0]
    for k in range(1, w.shape[0]):
        acc = acc + x[..., k:k + 1] * w[k]
    return acc


def _tanh(x: torch.Tensor) -> torch.Tensor:
    # in float64 then rounded: float32 tanh's vectorised and scalar code
    # paths on the CPU may differ in the last bit with the tensor's size
    return torch.tanh(x.double()).float()


def _probe_device(device):
    from arbius_tpu_torch.utils.platform import setup_device

    lanes = lane_devices(device)
    return setup_device(lanes[0] if lanes else lane_platform(device))


@dataclass
class _ProbeBase:
    """Shared probe surface: the canonical-batch Runner protocol over a
    lane program. `gate` (e.g. simnet's plane.runner_gate) is called once
    per dispatch so fault injection composes. `mode` is the precision
    mode: "bf16" is the plain probe program; int8/fp8 quantize the probe
    weights and dequantize them in-program, deterministic in (input,
    seed, layout, mode)."""

    mesh: object = None
    out_name: str = "out-1.png"
    gate: object = None
    mode: str = "bf16"

    def __call__(self, hydrated: dict, seed: int) -> dict:
        return self.finalize(self.dispatch([(hydrated, seed)]), 1)[0]

    def run_batch(self, items: list) -> list[dict]:
        return self.finalize(self.dispatch(items), len(items))

    def finalize(self, dev, n_real: int) -> list[dict]:
        arr = gather_canonical(dev)
        return [{self.out_name: b"\x89PNG" + arr[i].tobytes()}
                for i in range(n_real)]

    def _seeds(self, items) -> np.ndarray:
        # fold the prompt into the per-sample stream like taskid2seed
        # feeds real runners: bytes must depend on (input, seed)
        return np.asarray(
            [(s ^ zlib.crc32(str(h.get("prompt", "")).encode())) & 0xFFFFFFFF
             for h, s in items], dtype=np.uint32)

    def _device(self):
        return self.mesh.devices[0] if self.mesh is not None \
            else self._single_device

    def _raw_params(self):
        raw = torch.as_tensor(_probe_params())
        return _quantize_probe(raw, self.mode)


def _seed_tensor(seeds, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(seeds).astype(np.int64),
                           device=device)


def _image_program(params, seeds: torch.Tensor) -> torch.Tensor:
    """The image probe on one lane: per-sample normal draws times the
    lane's weight columns, then tanh. [b] seeds -> [b, 8, columns]."""
    from arbius_tpu_torch import random as jrandom

    w = _dequantize_probe(params)
    noise = jrandom.normal(jrandom.prng_key(seeds, seeds.device),
                           (_PROBE_DIM, _PROBE_DIM))
    return _tanh(_product(noise, w))


class ShardedImageProbe(_ProbeBase):
    """Image-shaped probe: per-sample PRNG draw, column-parallel product
    and tanh, samples over dp and columns over tp (gathered by
    concatenation), the SD-1.5 execution pattern in miniature: the bytes
    are exactly layout-invariant."""

    def __init__(self, mesh=None, out_name: str = "out-1.png", gate=None,
                 mode: str = "bf16", device=None):
        from arbius_tpu_torch.quant.modes import validate_mode

        super().__init__(mesh=mesh, out_name=out_name, gate=gate,
                         mode=validate_mode(mode))
        self._single_device = None if mesh is not None \
            else _probe_device(device)
        self._fns: dict[int, object] = {}
        self._est: dict[int, dict] = {}
        self._params = None

    def _param_sharding(self):
        from arbius_tpu_torch.parallel.sharding import sharding_for

        tp = self.mesh.shape.get("tp", 1)
        col = tp > 1 and _PROBE_DIM % tp == 0
        # column-parallel over tp when it divides: concat-gather, no psum
        kernel = sharding_for(self.mesh, None, "tp") if col \
            else sharding_for(self.mesh)
        if self.mode == "bf16":
            return kernel
        # the per-output-channel float32 scale shards with the columns
        scale = sharding_for(self.mesh, "tp") if col \
            else sharding_for(self.mesh)
        return {"qs": scale, "qv": kernel}

    def bucket_tag(self, batch: int) -> str:
        from arbius_tpu_torch.quant.modes import mode_tag

        return f"meshprobe.img.b{batch}" + mode_tag(self.mode)

    def cache_tag(self, hydrated: dict, batch: int) -> str:
        """The tag a dispatch of this bucket would cache under."""
        del hydrated  # probe buckets key on batch alone
        return self.bucket_tag(batch)

    def _get_fn(self, batch: int):
        from arbius_tpu_torch.obs import jit_cache_get

        return jit_cache_get(self._fns, batch,
                             lambda: self._build_fn(batch),
                             tag=self.bucket_tag(batch))

    def _build_fn(self, batch: int):
        mesh = self.mesh
        if mesh is None:
            return _image_program
        from arbius_tpu_torch.parallel.collectives import all_gather_seq
        from arbius_tpu_torch.parallel.sharding import Sharded

        spec, _ = batch_specs(mesh, batch)
        tp = mesh.shape.get("tp", 1)
        col = tp > 1 and _PROBE_DIM % tp == 0

        def run(params, seeds):
            def lane_params(lane):
                if isinstance(params, dict):
                    return {k: v.shards[lane] for k, v in params.items()}
                return params.shards[lane]

            outs = mesh.run(lambda lane, s: _image_program(
                lane_params(lane), s), seeds.shards)
            if col:
                outs = all_gather_seq(outs, "tp", axis=-1, mesh=mesh)
            return Sharded(spec(3), outs,
                           (batch, _PROBE_DIM, _PROBE_DIM))

        return run

    def _wire_dtype(self):
        """Quantized modes move 1-byte elements on the tp wire."""
        from arbius_tpu_torch.quant.core import storage_dtype

        return storage_dtype(self.mode) if self.mode != "bf16" else None

    def dispatch(self, items: list):
        if self.gate is not None:
            self.gate()
        from arbius_tpu_torch.obs import timed_dispatch

        if self._params is None:
            raw = self._raw_params()
            if self.mesh is None:
                self._params = {k: v.to(self._device()) for k, v in
                                raw.items()} if isinstance(raw, dict) \
                    else raw.to(self._device())
            else:
                sh = self._param_sharding()
                self._params = {k: sh[k].place(v) for k, v in raw.items()} \
                    if isinstance(raw, dict) else sh.place(raw)
        seeds = self._seeds(items)
        if self.mesh is None:
            seeds_dev = _seed_tensor(seeds, self._device())
        else:
            (seeds_dev,) = shard_batch(self.mesh, seeds.astype(np.int64))
        fn, warm, tag = self._get_fn(len(items))
        with on_device(self._device()), timed_dispatch(warm, tag):
            out = fn(self._params, seeds_dev)
        record_bucket_estimate(self._est, len(items), self.mesh, out,
                               len(items), params=self._params,
                               wire_dtype=self._wire_dtype(), tag=tag)
        return out


class ShardedSeqProbe(_ProbeBase):
    """Video-shaped probe: frames over sp, samples over dp, noise keyed
    by (sample, global frame) like the UNet3D pipeline's sp-invariant
    stream, plus an int32 checksum summed over the sp lanes (exact in any
    order)."""

    frames: int = 4

    def __init__(self, mesh=None, out_name: str = "out-1.png", gate=None,
                 frames: int = 4, mode: str = "bf16", device=None):
        from arbius_tpu_torch.quant.modes import validate_mode

        super().__init__(mesh=mesh, out_name=out_name, gate=gate,
                         mode=validate_mode(mode))
        self._single_device = None if mesh is not None \
            else _probe_device(device)
        self.frames = frames
        self._fns: dict[int, object] = {}
        self._est: dict[int, dict] = {}
        self._params = None

    def bucket_tag(self, batch: int) -> str:
        from arbius_tpu_torch.quant.modes import mode_tag

        return f"meshprobe.seq.b{batch}.f{self.frames}" \
            + mode_tag(self.mode)

    def cache_tag(self, hydrated: dict, batch: int) -> str:
        """See ShardedImageProbe.cache_tag."""
        del hydrated
        return self.bucket_tag(batch)

    def _get_fn(self, batch: int):
        from arbius_tpu_torch.obs import jit_cache_get

        def build():
            # the batch axis is hard-partitioned over dp: an under-filled
            # bucket (batch % dp != 0) runs the single-device program,
            # whose bytes the lane program matches by construction
            mesh = self.mesh
            if mesh is not None and batch % mesh.shape.get("dp", 1):
                mesh = None
            return build_seq_probe_fn(mesh, self.frames, mode=self.mode)

        return jit_cache_get(self._fns, batch, build,
                             tag=self.bucket_tag(batch))

    def dispatch(self, items: list):
        if self.gate is not None:
            self.gate()
        from arbius_tpu_torch.obs import timed_dispatch

        if self._params is None:
            raw = self._raw_params()
            dev = self._device()
            self._params = {k: v.to(dev) for k, v in raw.items()} \
                if isinstance(raw, dict) else raw.to(dev)
        seeds = self._seeds(items)
        fn, warm, tag = self._get_fn(len(items))
        with on_device(self._device()), timed_dispatch(warm, tag):
            out = fn(self._params, seeds)
        record_bucket_estimate(self._est, len(items), self.mesh, out,
                               len(items), tag=tag)
        return out


def build_seq_probe_fn(mesh, frames: int, *, psum_axes=("sp",),
                       mode: str = "bf16"):
    """The sequence probe's program: `fn(params, seeds)` with `seeds` a
    host array. With a mesh, lane (d, s) draws the samples of dp shard d
    at frames s * frames / sp onwards, keyed by the global frame index,
    and the one cross-lane reduction is an int32 `psum` over `psum_axes`
    in order. `mode` != "bf16" dequantizes the weights in-program and,
    when frames shard over sp, folds a temporal mean through the
    quantized ring allreduce. Returns a tensor (mesh None) or a
    `Sharded` over ("dp", "sp")."""
    from arbius_tpu_torch import random as jrandom

    sp = mesh.shape.get("sp", 1) if mesh is not None else 1
    if frames % sp:
        raise ValueError(f"frames {frames} not divisible by sp={sp}")
    t_local = frames // sp

    def lane_frames(params, seeds: torch.Tensor, frame0: int):
        w = _dequantize_probe(params)
        key = jrandom.prng_key(seeds, seeds.device)
        idx = torch.arange(frame0, frame0 + t_local, device=seeds.device)
        keys = jrandom.fold_in(key[:, None, :], idx[None, :])
        noise = jrandom.normal(keys, (_PROBE_DIM, _PROBE_DIM))
        return _tanh(_product(noise, w))

    def checksum(x: torch.Tensor) -> torch.Tensor:
        q = (x * 255.0).to(torch.int32) & 0xFF
        return q.sum(dim=(1, 2, 3), dtype=torch.int32)

    def finish(x, check):
        return x + (check % 3).to(torch.float32)[:, None, None, None]

    if mesh is None:
        def run(params, seeds):
            x = lane_frames(params, _seed_tensor(seeds, _param_device(
                params)), 0)
            return finish(x, checksum(x))

        return run

    from arbius_tpu_torch.parallel.collectives import (
        psum,
        quantized_ring_allreduce,
    )
    from arbius_tpu_torch.parallel.sharding import LaneSharding, Sharded

    dp = mesh.shape.get("dp", 1)

    def run(params, seeds):
        b = len(seeds) // dp
        xs = []
        for lane, dev in enumerate(mesh.devices):
            c = mesh.coords(lane)
            with on_device(dev):
                s = _seed_tensor(seeds[c["dp"] * b:(c["dp"] + 1) * b], dev)
                p = {k: v.to(dev) for k, v in params.items()} \
                    if isinstance(params, dict) else params.to(dev)
                xs.append(lane_frames(p, s, c["sp"] * t_local))
        if mode != "bf16" and sp > 1:
            means = [x.mean(dim=1) for x in xs]
            ms = quantized_ring_allreduce(means, "sp", mode=mode, mesh=mesh)
            xs = [x + m[:, None] * (1.0 / 16.0) for x, m in zip(xs, ms)]
        checks = [checksum(x) for x in xs]
        for axis in psum_axes:
            checks = psum(checks, axis, mesh=mesh)
        outs = [finish(x, c) for x, c in zip(xs, checks)]
        return Sharded(LaneSharding(mesh, ("dp", "sp")), outs,
                       (len(seeds), frames, _PROBE_DIM, _PROBE_DIM))

    return run


def _param_device(params) -> torch.device:
    return (params["qv"] if isinstance(params, dict) else params).device


# the probes' shipped layouts: the image probe's dp·tp, the sequence
# probe's dp·sp (its int32 psum the one real reduction)
IMG_LAYOUTS: tuple[tuple[str, ...], ...] = ((), ("dp", "tp"))
SEQ_LAYOUTS: tuple[tuple[str, ...], ...] = ((), ("dp", "sp"))
