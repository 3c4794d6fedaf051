#!/usr/bin/env python3
"""Count the operations of one text-to-video chunk, on the CPU, without
weights.

    python3 tools/video_flops.py

Builds the port's full-width text-to-video modules (UNet3D, the SD VAE
decoder, the 24-layer text tower) on PyTorch's meta device (shapes only,
no memory, no card) and counts each stage's floating-point operations
with `torch.utils.flop_counter` at the canonical batch of 4, classifier-
free guidance doubling the UNet3D's batch: the text tower (prompts and
negative prompts), one UNet3D forward and a chunk's worth of them, and
the VAE over every frame, at damo's default bucket (16 frames, 256x256,
50 steps) and zeroscopev2xl's (24 frames, 1024x576, 50 steps), with each
bucket's spatial attention operations apart. Prints one JSON line. The
counter counts matmuls and convolutions (2 flops per multiply-add), not
elementwise work.
"""
from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from arbius_tpu_torch.models import common  # noqa: E402
from arbius_tpu_torch.models.video import (  # noqa: E402
    Text2VideoConfig,
    Text2VideoModels,
)
from arbius_tpu_torch.models.video import unet3d  # noqa: E402
from arbius_tpu_torch.ops import flash  # noqa: E402

BATCH, STEPS = 4, 50
# (name, frames, width, height): the two templates' default buckets
BUCKETS = (("damo", 16, 256, 256), ("zeroscopev2xl", 24, 1024, 576))


def tflop(fn) -> float:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops() / 1e12


def main() -> int:
    spatial = []

    def counted_attention(q, k, v):
        spatial.append(4 * q.shape[0] * q.shape[1] * q.shape[2]
                       * k.shape[2] * q.shape[3] / 1e12)
        return flash.flash_attention_reference(q, k, v)

    # the meta device has no kernels: the plain attention, batched convs
    common.fused_attention = counted_attention
    common.Conv2d.forward = torch.nn.Conv2d.forward
    unet3d.FrameConv.forward = torch.nn.Conv3d.forward
    cfg = Text2VideoConfig()
    m = Text2VideoModels(cfg, device="meta")
    z = dict(device="meta")
    length = cfg.text.max_length
    out = {"parameters": sum(p.numel() for p in m.parameters()),
           "unet3d_parameters": sum(p.numel() for p in m.unet.parameters()),
           "text_tflop_chunk": tflop(lambda: m.text(
               torch.zeros(2 * BATCH, length, dtype=torch.int64, **z)))}
    for name, frames, width, height in BUCKETS:
        lh, lw = height // 8, width // 8
        spatial.clear()
        fwd = tflop(lambda: m.unet(
            torch.zeros(2 * BATCH, frames, lh, lw, 4, **z),
            torch.zeros(2 * BATCH, **z),
            torch.zeros(2 * BATCH, length, cfg.unet.context_dim, **z)))
        out[name] = {
            "frames": frames, "width": width, "height": height,
            "unet3d_tflop_forward": fwd,
            "spatial_attention_tflop_forward": sum(spatial),
            f"unet3d_tflop_{STEPS}_steps": STEPS * fwd,
            "vae_tflop_chunk": tflop(lambda: m.vae(
                torch.zeros(BATCH * frames, lh, lw, 4, **z)))}
    print(json.dumps(out, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
