"""Model registry entry + the deterministic solve path (inference -> bytes
-> CID), for the port's runners.

Twin of the SD-1.5 half of arbius_tpu/node/solver.py: `RegisteredModel`,
`chunk_items`, `solve_files_batch` (canonical-batch padding and the
one-deep dispatch/finalize overlap), `solve_cid_batch`, and `SD15Runner`.
The reference's observability spans are left out for now.

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

from arbius_tpu_torch.codecs import encode_png
from arbius_tpu_torch.l0.cid import cid_hex, cid_of_solution_files
from arbius_tpu_torch.templates.engine import Template

Runner = Callable[[dict, int], dict]


@dataclass
class RegisteredModel:
    id: str                       # 0x hash
    template: Template
    runner: Runner


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


def solve_cid_batch(model: RegisteredModel, items: list[tuple[dict, int]],
                    *, canonical_batch: int = 1) -> list[tuple[str, dict]]:
    """Batched solve -> (cid hex, files) per item, over one shape bucket."""
    files_list = solve_files_batch(model, items,
                                   canonical_batch=canonical_batch)
    return [(cid_hex(cid_of_solution_files(files)), files)
            for files in files_list]


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
        """Queue the bucket on the card and return without waiting for it.
        The images' copy to the host is queued behind it, with an event
        recorded after the copy, so `finalize` waits for this chunk only
        and not for a chunk queued after it."""
        first = items[0][0]
        images = self.pipeline.generate(
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
        )
        if images.device.type != "cuda":
            return images, None
        host = torch.empty(images.shape, dtype=images.dtype, pin_memory=True)
        host.copy_(images, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def finalize(self, dispatched, n_real: int) -> list[dict]:
        """Dispatched chunk -> per-item encoded files (waits for the
        chunk's copy, then encodes on the host)."""
        images, done = dispatched
        if done is not None:
            done.synchronize()
        images = images.numpy()
        return [{self.out_name: encode_png(np.ascontiguousarray(images[i]))}
                for i in range(n_real)]

    def cache_tag(self, hydrated: dict, batch: int) -> str:
        """The bucket tag a dispatch of this task would use; defaults
        mirror `dispatch` exactly."""
        return self.pipeline.bucket_tag(
            batch, int(hydrated.get("height", 512)),
            int(hydrated.get("width", 512)),
            int(hydrated.get("num_inference_steps", 20)),
            hydrated.get("scheduler", "DDIM"))
