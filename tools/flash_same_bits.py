#!/usr/bin/env python3
"""Show that two checkouts' attention kernels give the same bits.

    python3 tools/flash_same_bits.py OTHER_CHECKOUT

Needs one CUDA card and nvcc; imports torch and the port only. For each
bf16 attention shape of chip_smoke.py's 512x512, 768x768 and 640x640
buckets and of damo's and zeroscopev2xl's chunks, in the models'
strided views, and each route that the rules of
both checkouts let take it (`ops.flash.routes_of`), runs the two
checkouts' kernels on the same seeded inputs and compares a SHA-256 of
each output. Each checkout runs in a process of its own and builds its
kernels from its own sources. Prints one JSON line per (route, shape)
and exits 0 only if every pair is bit-identical: the check that a
change to a kernel's source kept its results, run against the parent
commit unpacked with `git archive`.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def digests(root: str, shapes: list) -> dict[str, str]:
    """SHA-256 of each route's output at each shape, in the checkout at
    `root`: key "route b,h,sq,skv,d"."""
    sys.path.insert(0, root)
    import hashlib

    import torch

    from arbius_tpu_torch.ops import flash
    from arbius_tpu_torch.utils import setup_device

    setup_device("cuda")
    out = {}
    for b, h, sq, skv, d in shapes:
        gen = torch.Generator(device="cuda").manual_seed(sq * skv + d)
        q, k, v = (torch.randn(b, s, h * d, generator=gen, device="cuda")
                   .bfloat16().view(b, s, h, d).transpose(1, 2)
                   for s in (sq, skv, skv))
        for route in flash.routes_of(q, k, v):
            o = flash.flash_attention(q, k, v, kernel=route)
            raw = o.view(torch.int16).cpu().numpy().tobytes()
            out[f"{route} {b},{h},{sq},{skv},{d}"] = hashlib.sha256(
                raw).hexdigest()
        del q, k, v
        torch.cuda.empty_cache()
    return out


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--digests":
        print(json.dumps(digests(sys.argv[2], json.loads(sys.argv[3]))))
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke

    shapes = sorted({s[:5] for s in (*chip_smoke.MAIN_PATH_SHAPES,
                                     *chip_smoke.BUCKET_768_SHAPES,
                                     *chip_smoke.BUCKET_640_RAGGED_SHAPES,
                                     *chip_smoke.DAMO_SHAPES,
                                     *chip_smoke.ZEROSCOPE_SHAPES)})
    got = {}
    for root in (HERE, os.path.abspath(sys.argv[1])):
        run = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--digests", root,
             json.dumps(shapes)], cwd=root, capture_output=True, text=True)
        if run.returncode != 0:
            print(run.stderr, file=sys.stderr)
            return 1
        got[root] = json.loads(run.stdout.strip().splitlines()[-1])
    ours, theirs = got.values()
    same = True
    for key in sorted(ours.keys() & theirs.keys()):
        route, shape = key.split(" ")
        equal = ours[key] == theirs[key]
        same = same and equal
        print(json.dumps({"route": route, "shape": shape,
                          "bit_identical": equal}), flush=True)
    only = sorted(ours.keys() ^ theirs.keys())
    print(f"compared {len(ours.keys() & theirs.keys())} (route, shape) "
          f"pairs, all bit-identical: {same}; taken by one checkout's "
          f"rule only: {only}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
