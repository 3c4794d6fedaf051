"""Model registry + the deterministic solve path (inference -> bytes ->
CID), for the port's runners.

Twin of arbius_tpu/node/solver.py: `RegisteredModel`, `ModelRegistry`,
`bucket_key`/`bucket_mode`, `chunk_items`, `solve_files_batch`
(canonical-batch padding and the one-deep dispatch/finalize overlap),
`solve_cid`/`solve_cid_batch` (with `evilmode`), `SD15Runner`,
`Kandinsky2Runner`, `Text2VideoRunner`, `RVMRunner`, `count_decode_stall`
and `TextGenRunner`, under the reference's obs spans. The runners hold
their pipelines' weights (the reference passes `params` beside them).

Runners must be deterministic in (input, seed): the CID is what gets
keccak'd into the on-chain commitment. cuBLAS and cuDNN choose kernels by
batch size, so every dispatch is padded to the canonical batch: one
bucket, one batch size, one determinism class.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from arbius_tpu_torch.codecs import encode_mp4_h264, encode_png
from arbius_tpu_torch.l0.cid import cid_hex, cid_of_solution_files
from arbius_tpu_torch.obs import current_obs, span
from arbius_tpu_torch.templates.engine import Template

Runner = Callable[[dict, int], dict]


@dataclass
class RegisteredModel:
    id: str                       # 0x hash
    template: Template
    runner: Runner
    min_fee: int = 0
    allowed_owners: tuple[str, ...] = ()
    golden: tuple[dict, int, str] | None = None  # (input, seed, cid_hex)


class ModelRegistry:
    def __init__(self):
        self._models: dict[str, RegisteredModel] = {}

    def register(self, model: RegisteredModel) -> None:
        self._models[model.id.lower()] = model

    def get(self, model_id: str) -> RegisteredModel | None:
        return self._models.get(model_id.lower())

    def ids(self) -> list[str]:
        return list(self._models)


def bucket_key(model_id: str, hydrated: dict, mode: str = "bf16") -> tuple:
    """The shape-bucket identity of one task: every field that is part
    of the bucket program (w/h/steps/scheduler, and num_frames for video
    templates; image templates carry None there), plus the precision
    mode. Tasks sharing a key run as one batched dispatch; the key is
    also the cost model's bucket feature and the packer's unit of
    reordering (node/sched.py). Text templates fill the scheduler slot
    with their `sampler` and extend the key with `_prompt_bucket` and
    `_decode_bucket` (a 9-tuple); every other task gives the 7-tuple."""
    sched = hydrated.get("scheduler")
    if sched is None:
        sched = hydrated.get("sampler")
    key = (model_id, hydrated.get("width"), hydrated.get("height"),
           hydrated.get("num_inference_steps"), sched,
           hydrated.get("num_frames"), mode)
    pb = hydrated.get("_prompt_bucket")
    db = hydrated.get("_decode_bucket")
    if pb is None and db is None:
        return key
    return key + (pb, db)


def bucket_mode(key: tuple) -> str:
    """The precision mode a bucket key carries (6-tuples read as bf16)."""
    return key[6] if len(key) > 6 else "bf16"


def _check_declared(model: RegisteredModel, files: dict) -> dict:
    declared = {o.filename for o in model.template.outputs}
    if set(files) != declared:
        raise ValueError(
            f"runner produced {sorted(files)} but template declares "
            f"{sorted(declared)}")
    return files


def solve_files(model: RegisteredModel, hydrated: dict, seed: int) -> dict:
    """Run inference, return {filename: bytes} per the template outputs."""
    return _check_declared(model, model.runner(hydrated, seed))


def chunk_items(items: list[tuple[dict, int]],
                canonical_batch: int) -> list[tuple[list, int]]:
    """Split a bucket's items into canonical_batch-sized chunks, padding
    the last chunk by repeating its final real item, so every dispatch
    runs the fleet-wide batch size. Returns [(padded_items, n_real)]."""
    chunks = []
    for start in range(0, len(items), canonical_batch):
        chunk = items[start:start + canonical_batch]
        real = len(chunk)
        chunks.append((chunk + [chunk[-1]] * (canonical_batch - real), real))
    return chunks


def solve_files_batch(model: RegisteredModel, items: list[tuple[dict, int]],
                      *, canonical_batch: int = 1) -> list[dict]:
    """Batched inference over one shape bucket, always at the canonical
    batch size (runners without `run_batch` are the canonical_batch=1
    case by construction)."""
    with span("solve.infer", n=len(items), batch=canonical_batch):
        return _solve_files_batch(model, items,
                                  canonical_batch=canonical_batch)


def _solve_files_batch(model: RegisteredModel, items: list[tuple[dict, int]],
                       *, canonical_batch: int = 1) -> list[dict]:
    run_batch = getattr(model.runner, "run_batch", None)
    if run_batch is None or canonical_batch <= 1:
        return [solve_files(model, h, s) for h, s in items]
    chunks = chunk_items(items, canonical_batch)
    out: list[dict] = []
    dispatch = getattr(model.runner, "dispatch", None)
    finalize = getattr(model.runner, "finalize", None)
    if dispatch is not None and finalize is not None and len(chunks) > 1:
        # one-deep pipeline: queue chunk i+1 on the card BEFORE copying
        # and encoding chunk i, so the host PNG encode overlaps the
        # card's compute. Output order and bytes are identical to the
        # serial path; only the schedule changes.
        pending = None  # (dispatched chunk, real count)
        for chunk, real in chunks:
            dev = dispatch(chunk)
            if pending is not None:
                out.extend(_check_declared(model, f)
                           for f in finalize(*pending))
            pending = (dev, real)
        out.extend(_check_declared(model, f) for f in finalize(*pending))
        return out
    for chunk, real in chunks:
        files = run_batch(chunk)
        out.extend(_check_declared(model, f) for f in files[:real])
    return out


EVIL_CID = ("0x1220000000000000000000000000000000000000000000000000000000000"
            "0000666")


def solve_cid(model: RegisteredModel, hydrated: dict, seed: int,
              *, evilmode: bool = False) -> tuple[str, dict]:
    """The commitment-bound CID for a task: dir-wrapped root of the output
    files. evilmode emits a deliberately wrong CID for contestation
    drills."""
    if evilmode:
        return EVIL_CID, {}
    files = solve_files(model, hydrated, seed)
    with span("solve.cid", n=1):
        return cid_hex(cid_of_solution_files(files)), files


def solve_cid_batch(model: RegisteredModel, items: list[tuple[dict, int]],
                    *, evilmode: bool = False,
                    canonical_batch: int = 1) -> list[tuple[str, dict]]:
    """Batched solve -> (cid hex, files) per item, over one shape bucket."""
    if evilmode:
        return [(EVIL_CID, {})] * len(items)
    files_list = solve_files_batch(model, items,
                                   canonical_batch=canonical_batch)
    with span("solve.cid", n=len(files_list)):
        return [(cid_hex(cid_of_solution_files(files)), files)
                for files in files_list]


def _to_host(images: torch.Tensor):
    """Queue the images' copy to pinned host memory behind the card's
    work and record an event after it, so `finalize` waits for this chunk
    only and not for a chunk queued after it."""
    if images.device.type != "cuda":
        return images, None
    host = torch.empty(images.shape, dtype=images.dtype, pin_memory=True)
    host.copy_(images, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


class SD15Runner:
    """anythingv3-class runner: SD-1.5 pipeline -> deterministic PNG.

    Template variables (templates/data/anythingv3.json): prompt,
    negative_prompt, width, height, num_inference_steps, guidance_scale,
    scheduler (enum), seed (injected from taskid).
    """

    def __init__(self, pipeline, out_name: str = "out-1.png"):
        self.pipeline = pipeline
        self.out_name = out_name

    def __call__(self, hydrated: dict, seed: int) -> dict:
        return self.run_batch([(hydrated, seed)])[0]

    def run_batch(self, items: list[tuple[dict, int]]) -> list[dict]:
        """One batched dispatch for a whole shape bucket: every item shares
        (width, height, steps, scheduler), while prompts, guidance and
        seeds vary per sample."""
        return self.finalize(self.dispatch(items), len(items))

    def dispatch(self, items: list[tuple[dict, int]]):
        """Queue the bucket on the card and return without waiting for it
        (`_to_host`)."""
        first = items[0][0]
        return _to_host(self.pipeline.generate(
            prompts=[h["prompt"] for h, _ in items],
            negative_prompts=[h.get("negative_prompt", "") for h, _ in items],
            seeds=[s for _, s in items],
            width=int(first.get("width", 512)),
            height=int(first.get("height", 512)),
            num_inference_steps=int(first.get("num_inference_steps", 20)),
            guidance_scale=[float(h.get("guidance_scale", 7.5))
                            for h, _ in items],
            scheduler=first.get("scheduler", "DDIM"),
            as_device=True,
        ))

    def finalize(self, dispatched, n_real: int) -> list[dict]:
        """Dispatched chunk -> per-item encoded files (waits for the
        chunk's copy, then encodes on the host)."""
        images, done = dispatched
        if done is not None:
            done.synchronize()
        with span("solve.encode", n=n_real, codec="png"):
            images = images.numpy()
            return [{self.out_name:
                     encode_png(np.ascontiguousarray(images[i]))}
                    for i in range(n_real)]

    def cache_tag(self, hydrated: dict, batch: int) -> str:
        """The bucket tag a dispatch of this task would use; defaults
        mirror `dispatch` exactly."""
        return self.pipeline.bucket_tag(
            batch, int(hydrated.get("height", 512)),
            int(hydrated.get("width", 512)),
            int(hydrated.get("num_inference_steps", 20)),
            hydrated.get("scheduler", "DDIM"))


class Kandinsky2Runner(SD15Runner):
    """kandinsky2-template runner: prior + decoder + MOVQ -> deterministic
    PNG.

    Template variables (templates/data/kandinsky2.json): prompt,
    width/height in {768, 1024}; output out-1.png. The defaults are the
    reference's: 50 steps, guidance 4.0, DDIM (no template variable
    chooses the scheduler)."""

    def dispatch(self, items: list[tuple[dict, int]]):
        first = items[0][0]
        return _to_host(self.pipeline.generate(
            prompts=[h["prompt"] for h, _ in items],
            negative_prompts=None,
            seeds=[s for _, s in items],
            width=int(first.get("width", 768)),
            height=int(first.get("height", 768)),
            num_inference_steps=int(first.get("num_inference_steps", 50)),
            guidance_scale=[float(h.get("guidance_scale", 4.0))
                            for h, _ in items],
            as_device=True,
        ))

    def cache_tag(self, hydrated: dict, batch: int) -> str:
        """The bucket tag a dispatch of this task would use; defaults
        mirror `dispatch` exactly."""
        return self.pipeline.bucket_tag(
            batch, int(hydrated.get("height", 768)),
            int(hydrated.get("width", 768)),
            int(hydrated.get("num_inference_steps", 50)), "DDIM")


class Text2VideoRunner:
    """zeroscopev2xl- and damo-template runner: UNet3D -> deterministic
    H.264 MP4.

    Template variables (templates/data/zeroscopev2xl.json, damo.json):
    prompt, negative_prompt (zeroscopev2xl), num_frames,
    num_inference_steps, width/height (zeroscopev2xl), guidance_scale
    (zeroscopev2xl), fps; output out-1.mp4. What a task leaves out comes
    from `defaults`, the reference's: 16 frames at 256x256, 20 steps,
    guidance 9.0, fps 8 (hydration fills the template's own defaults
    first: damo's 50 steps). The scheduler is DDIM."""

    def __init__(self, pipeline, out_name: str = "out-1.mp4",
                 defaults: dict | None = None):
        self.pipeline = pipeline
        self.out_name = out_name
        self.defaults = {"num_frames": 16, "width": 256, "height": 256,
                         "num_inference_steps": 20, "guidance_scale": 9.0,
                         "fps": 8, **(defaults or {})}

    def __call__(self, hydrated: dict, seed: int) -> dict:
        return self.finalize(self.dispatch([(hydrated, seed)]), 1)[0]

    def run_batch(self, items: list[tuple[dict, int]]) -> list[dict]:
        """One batched dispatch for a whole shape bucket: every item
        shares (num_frames, width, height, steps), while prompts,
        negatives, seeds, guidance and the container-only fps vary per
        item."""
        return self.finalize(self.dispatch(items), len(items))

    def _get(self, hydrated: dict, key: str):
        v = hydrated.get(key)
        return v if v is not None else self.defaults[key]

    def dispatch(self, items: list[tuple[dict, int]]):
        """Queue the bucket on the card and return without waiting for it
        (`_to_host`); fps rides along to `finalize`, as it is the MP4
        container's and not part of the program."""
        first = items[0][0]
        frames = self.pipeline.generate(
            prompts=[h["prompt"] for h, _ in items],
            negative_prompts=[h.get("negative_prompt", "") for h, _ in items],
            seeds=[s for _, s in items],
            num_frames=int(self._get(first, "num_frames")),
            width=int(self._get(first, "width")),
            height=int(self._get(first, "height")),
            num_inference_steps=int(self._get(first, "num_inference_steps")),
            guidance_scale=[float(self._get(h, "guidance_scale"))
                            for h, _ in items],
            as_device=True,
        )
        return _to_host(frames), [int(self._get(h, "fps")) for h, _ in items]

    def finalize(self, dispatched, n_real: int) -> list[dict]:
        """Dispatched chunk -> per-item MP4 files (waits for the chunk's
        copy, then encodes on the host: all-intra H.264, codecs/h264.py)."""
        (frames, done), fps = dispatched
        if done is not None:
            done.synchronize()
        with span("solve.encode", n=n_real, codec="h264"):
            frames = frames.numpy()
            return [{self.out_name: encode_mp4_h264(
                np.ascontiguousarray(frames[i]), fps=fps[i])}
                for i in range(n_real)]

    def cache_tag(self, hydrated: dict, batch: int) -> str:
        """The bucket tag a dispatch of this task would use; defaults
        mirror `dispatch` exactly."""
        g = lambda k: self._get(hydrated, k)  # noqa: E731
        return self.pipeline.bucket_tag(
            batch, int(g("num_frames")), int(g("height")), int(g("width")),
            int(g("num_inference_steps")), "DDIM")


class RVMRunner:
    """robust_video_matting-template runner: ConvGRU matting stream ->
    deterministic H.264 MP4.

    The template's `input_video` is a file reference; `resolve_file`
    (cid -> bytes) is injected: a content store's `get_file`, or the
    probe resolver of a probe golden. The input is MJPEG or avc1, found
    by its sample entry; the output is all-intra H.264. Seed-independent,
    as the reference model is."""

    def __init__(self, pipeline, resolve_file, out_name: str = "out-1.mp4",
                 fps: int = 8):
        self.pipeline = pipeline
        self.resolve_file = resolve_file
        self.out_name = out_name
        self.fps = fps

    def __call__(self, hydrated: dict, seed: int) -> dict:
        from arbius_tpu_torch.codecs.mp4_demux import decode_video_mp4

        video = decode_video_mp4(self.resolve_file(hydrated["input_video"]))
        # the template's output_type enum has "" as its default, which the
        # published model treats as green-screen
        out = self.pipeline.matte(
            video, output_type=hydrated.get("output_type") or "green-screen")
        with span("solve.encode", n=1, codec="h264"):
            return {self.out_name: encode_mp4_h264(out, fps=self.fps)}


def count_decode_stall(n: int = 1) -> None:
    """Bump `arbius_decode_stalls_total`: a text solve whose decode gave
    zero output bytes (an immediate eos, or nothing representable).
    Observation only: the empty artifact is still the committed bytes."""
    obs = current_obs()
    if obs is not None:
        obs.registry.counter(
            "arbius_decode_stalls_total",
            "text solves whose decode produced zero output bytes",
        ).inc(n)


class TextGenRunner:
    """textgen-template runner: decoder-only LM -> deterministic UTF-8.

    Template variables (templates/data/textgen.json): prompt,
    max_new_tokens, sampler (enum); output out-1.txt. The sequence
    buckets ride the hydrated input as `_prompt_bucket`/`_decode_bucket`,
    stamped by `prepare_hydrated` at intake, so the node's bucket key,
    cost tags and packer all see them."""

    def __init__(self, pipeline, out_name: str = "out-1.txt"):
        self.pipeline = pipeline
        self.out_name = out_name

    def prepare_hydrated(self, hydrated: dict) -> dict:
        """Stamp the sequence-bucket fields onto the hydrated input (the
        node calls this right after hydration): a pure function of the
        input and the fleet-wide bucket edges."""
        h = dict(hydrated)
        h["_prompt_bucket"] = self.pipeline.prompt_bucket_for(
            h.get("prompt", ""))
        h["_decode_bucket"] = self.pipeline.decode_bucket_for(
            int(h.get("max_new_tokens") or 16))
        return h

    def _buckets_of(self, hydrated: dict) -> tuple[int, int]:
        pb = hydrated.get("_prompt_bucket")
        db = hydrated.get("_decode_bucket")
        if pb is None:
            pb = self.pipeline.prompt_bucket_for(hydrated.get("prompt", ""))
        if db is None:
            db = self.pipeline.decode_bucket_for(
                int(hydrated.get("max_new_tokens") or 16))
        return int(pb), int(db)

    def __call__(self, hydrated: dict, seed: int) -> dict:
        return self.run_batch([(hydrated, seed)])[0]

    def run_batch(self, items: list[tuple[dict, int]]) -> list[dict]:
        return self.finalize(self.dispatch(items), len(items))

    def dispatch(self, items: list[tuple[dict, int]]):
        """Queue the bucket on the card and return without waiting for it
        (`_to_host`). Each item's budget rides along to `finalize`: the
        program runs the whole decode bucket and the host truncates,
        which is byte-sound because generation is prefix-stable."""
        first = items[0][0]
        pb, db = self._buckets_of(first)
        tokens = self.pipeline.generate(
            prompts=[str(h.get("prompt", "")) for h, _ in items],
            seeds=[s for _, s in items],
            prompt_bucket=pb, decode_bucket=db,
            sampler=first.get("sampler") or "greedy",
            as_device=True,
        )
        return _to_host(tokens), [int(h.get("max_new_tokens") or 16)
                                  for h, _ in items]

    def finalize(self, dispatched, n_real: int) -> list[dict]:
        from arbius_tpu_torch.models.textgen import tokens_to_bytes

        (tokens, done), budgets = dispatched
        if done is not None:
            done.synchronize()
        with span("solve.encode", n=n_real, codec="text"):
            tokens = tokens.numpy()
            out = []
            stalls = 0
            for i in range(n_real):
                text = tokens_to_bytes(tokens[i], budgets[i],
                                       self.pipeline.EOS_ID)
                if not text:
                    stalls += 1
                out.append({self.out_name: text})
            if stalls:
                count_decode_stall(stalls)
            return out

    def cache_tag(self, hydrated: dict, batch: int) -> str:
        """The bucket tag a dispatch of this task would use; bucket policy
        identical to `dispatch`."""
        pb, db = self._buckets_of(hydrated)
        return self.pipeline.bucket_tag(
            batch, pb, db, hydrated.get("sampler") or "greedy")
