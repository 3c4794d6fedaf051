#!/usr/bin/env python3
"""Time a damo chunk on the card with the UNet3D's 2D convolutions run
one frame per cuDNN call against one task-half's T frames per call.

    python3 tools/video_conv_grouping.py

Needs one CUDA card. Builds damo at full width (seeded random weights,
bf16, the port's factory) and solves chunks of four template tasks (16
frames at 256x256, 50 steps, DDIM, guidance 9.0) in the order per-frame,
grouped, grouped, per-frame, so drift in the card's clocks shows as a
difference between the two runs of a mode. Each run solves two chunks
that share task 0 among different neighbours, and reports the task's
CID in both (each mode is its own determinism class; within a mode the
CIDs must be equal). One more chunk per mode is traced by
torch.profiler: kernels launched, device busy time and idle share. The
grouped mode is the port's (`models/common.py` `samples_per_conv`,
entered by `UNet3DCondition.forward`); the per-frame mode patches that
entry to one map per call. Prints one JSON line per run and the card.
"""
from __future__ import annotations

import contextlib
import json
import os
import pathlib
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from arbius_tpu_torch.l0 import taskid2seed  # noqa: E402
from arbius_tpu_torch.models.video import unet3d  # noqa: E402
from arbius_tpu_torch.node import (  # noqa: E402
    MiningConfig,
    ModelConfig,
    build_registry,
    solve_cid_batch,
)
from arbius_tpu_torch.templates import hydrate_input, load_template  # noqa: E402
from arbius_tpu_torch.utils import card_info, setup_device  # noqa: E402

GROUPED = unet3d.samples_per_conv
MODES = {"per_frame": lambda n: contextlib.nullcontext(),
         "grouped": GROUPED}
CHUNKS = ([0, 1, 2, 3], [4, 0, 5])


def main() -> int:
    setup_device("cuda")
    card = card_info()
    template = load_template("damo")
    items = [(hydrate_input(raw, template),
              taskid2seed("0x" + f"{i + 7:x}".rjust(64, "3")))
             for i, raw in enumerate(chip_smoke.video_inputs())]
    mid = "0x" + "00" * 32
    model = build_registry(MiningConfig(canonical_batch=4, models=(
        ModelConfig(id=mid, template="damo", weights_dtype="bfloat16"),)),
        device="cuda").get(mid)
    clock = chip_smoke.video_clock(torch, model.runner.pipeline.models)
    for mode in ("per_frame", "grouped", "grouped", "per_frame"):
        unet3d.samples_per_conv = MODES[mode]
        seconds, cids = [], []
        for chunk in CHUNKS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = solve_cid_batch(model, [items[i] for i in chunk],
                                  canonical_batch=4)
            seconds.append(time.perf_counter() - t0)
            cids.append(out[chunk.index(0)][0])
        stages = clock.read()
        print(json.dumps({"mode": mode, "chunk_s": seconds,
                          "denoise_loop_s": [s["denoise loop"]
                                             for s in stages],
                          "task0_cids": cids,
                          "neighbour_invariant": cids[0] == cids[1]}),
              flush=True)
    for mode in ("per_frame", "grouped"):
        unet3d.samples_per_conv = MODES[mode]
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            solve_cid_batch(model, [items[i] for i in CHUNKS[0]],
                            canonical_batch=4)
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as work:
            path = pathlib.Path(work) / "chunk.json"
            prof.export_chrome_trace(str(path))
            trace = chip_smoke.device_trace_summary(
                json.loads(path.read_text()))
        clock.read()
        print(json.dumps({"mode": mode, "traced": {
            k: trace[k] for k in ("kernels", "busy_ms", "span_ms",
                                  "idle_share")}}), flush=True)
    unet3d.samples_per_conv = GROUPED
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
