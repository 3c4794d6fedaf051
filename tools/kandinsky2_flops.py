#!/usr/bin/env python3
"""Count the operations of one kandinsky2 chunk, on the CPU, without
weights.

    python3 tools/kandinsky2_flops.py

Builds the port's full-width Kandinsky-2 modules on PyTorch's meta
device (shapes only, no memory, no card) and counts each stage's
floating-point operations with `torch.utils.flop_counter` at the
canonical batch of 4, classifier-free guidance doubling the prior's and
the decoder's batch: the decoder UNet per forward and per 50-step
chunk, MoVQ per chunk, the prior over its 25 steps, at 768x768 and
1024x1024. Prints one JSON line. The counter counts matmuls and
convolutions (2 flops per multiply-add), not elementwise work.
"""
from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from arbius_tpu_torch.models import common  # noqa: E402
from arbius_tpu_torch.models.kandinsky2 import Kandinsky2Config  # noqa: E402
from arbius_tpu_torch.models.kandinsky2.pipeline import (  # noqa: E402
    Kandinsky2Models,
)
from arbius_tpu_torch.ops import flash  # noqa: E402

BATCH, STEPS = 4, 50


def tflop(fn) -> float:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops() / 1e12


def main() -> int:
    # the meta device has no kernels: the plain attention, batched convs
    common.fused_attention = flash.flash_attention_reference
    common.Conv2d.forward = torch.nn.Conv2d.forward
    cfg = Kandinsky2Config()
    m = Kandinsky2Models(cfg, device="meta")
    z = dict(device="meta")
    b2, clip, text = 2 * BATCH, cfg.prior.clip_dim, cfg.text.width
    out = {"parameters": sum(p.numel() for p in m.parameters()),
           "prior_tflop_25_steps": cfg.prior_steps * tflop(lambda: m.prior(
               torch.zeros(b2, clip, **z), torch.zeros(b2, **z),
               torch.zeros(b2, cfg.prior.text_len, text, **z),
               torch.zeros(b2, clip, **z),
               torch.ones(b2, cfg.prior.text_len, **z)))}
    for side in (768, 1024):
        lat = side // 8
        fwd = tflop(lambda: m.decoder(torch.zeros(b2, lat, lat, 4, **z),
                                      torch.zeros(b2, **z),
                                      torch.zeros(b2, clip, **z)))
        out[f"{side}"] = {
            "decoder_tflop_forward": fwd,
            "decoder_tflop_chunk": STEPS * fwd,
            "movq_tflop_chunk": tflop(lambda: m.movq(
                torch.zeros(BATCH, lat, lat, 4, **z)))}
    print(json.dumps(out, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
