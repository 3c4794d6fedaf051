#!/usr/bin/env python3
"""Summarise the attention kernels' times from chip_smoke.py logs.

    python3 tools/flash_times.py LOG [LOG ...]

Reads the `kernel {...}` lines that chip_smoke.py's phase 2 prints and,
for each log and bucket, prints chip_smoke.per_route's sums over one
canonical batch of 4 in bf16: each route's device ms and the host's
enqueue ms (median and mean per call, times the calls) over the calls
the bucket sends to it, and over the same calls each other route that
was timed at all of their shapes (forced). Logs from before the mean was
recorded give it as 0. Needs no card.
"""
from __future__ import annotations

import json
import os
import sys

# `python3 tools/<tool>.py` puts tools/, not the repository root, on sys.path
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    for path in sys.argv[1:]:
        with open(path) as log:
            lines = [json.loads(row[len("kernel "):]) for row in log
                     if row.startswith("kernel {")]
        for bucket in dict.fromkeys(ln["bucket"] for ln in lines):
            mine = [ln for ln in lines if ln["bucket"] == bucket]
            for route, t in chip_smoke.per_route(mine).items():
                if not t["launches_per_batch"]:
                    continue
                print(json.dumps({
                    "log": path, "bucket": bucket, "route": route,
                    "launches_per_batch": t["launches_per_batch"],
                    "ms": t["ms"], "host_ms": t["host_ms"],
                    "host_mean_ms": t["host_mean_ms"],
                    "forced": t["forced"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
