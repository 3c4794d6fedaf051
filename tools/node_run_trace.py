#!/usr/bin/env python3
"""Trace the miner's solve dispatches on the card, as `node-run` mines.

    python3 tools/node_run_trace.py

Needs one CUDA card; imports torch and the port only. Runs chip_smoke.py
phase 7's world (`node_run_world`: the port's devnet on localhost and
`node-run` as its own process, the staged pipeline on) at full width on
phase 4's six tasks, with `profile_dir` set and `profile_every: 1`, so
the node writes one torch.profiler Chrome trace per chunk dispatch.
The node boots with its self-test, on a golden this script records
first, so every traced dispatch follows a warm solve, as in a miner's
node. Reads each trace and prints one JSON line per dispatch:

  kernels, launches  device kernels, and the host's launch calls
  busy_ms            device time under at least one kernel or copy
  device_span_ms     first device start to last device end
  idle_share         1 - busy_ms / device_span_ms: the card waiting
  enqueue_ms         first launch call to last launch call, host clock
  host_us_per_launch enqueue_ms over the launch calls
  lag_ms             last device end minus last launch call's end: how
                     far the card runs behind the host

then the card and one summary JSON line (sums over the dispatches).
Profiling adds host work per launch, so enqueue_ms is an upper bound
of the unprofiled enqueue; the stage seconds of chip_smoke.py phase 7
are the unprofiled numbers.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
from pathlib import Path

# `python3 tools/<tool>.py` puts tools/, not the repository root, on sys.path
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _union_ms(intervals: list[tuple[float, float]]) -> float:
    """Total length, in ms, of the union of [start, end) us intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total / 1e3


def summarize(trace: dict) -> dict:
    """One dispatch's Chrome trace (torch.profiler's export) -> the
    numbers in the module docstring."""
    events = [e for e in trace["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    device = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("cat") in DEVICE_CATS]
    launches = [(e["ts"], e["ts"] + e["dur"]) for e in events
                if e.get("cat") in LAUNCH_CATS
                and "Launch" in e.get("name", "")]
    out = {"kernels": sum(1 for e in events if e.get("cat") == "kernel"),
           "launches": len(launches)}
    if not device or not launches:
        return out
    span = (max(b for _, b in device) - min(a for a, _ in device)) / 1e3
    busy = _union_ms(device)
    enqueue = (max(b for _, b in launches)
               - min(a for a, _ in launches)) / 1e3
    out.update(busy_ms=busy, device_span_ms=span,
               idle_share=1.0 - busy / span if span > 0 else 0.0,
               enqueue_ms=enqueue,
               host_us_per_launch=enqueue * 1e3 / len(launches),
               lag_ms=(max(b for _, b in device)
                       - max(b for _, b in launches)) / 1e3)
    return out


def record_golden_here(torch) -> dict:
    """The boot self-test's golden on this build (chip_smoke.py phase
    6's recording), with the model freed before the node starts."""
    from arbius_tpu_torch.cli import record_golden
    from arbius_tpu_torch.node import MiningConfig, ModelConfig, build_registry

    mid = "0x" + "00" * 32
    model = build_registry(MiningConfig(
        canonical_batch=chip_smoke.CANONICAL_BATCH, models=(ModelConfig(
            id=mid, template="anythingv3", weights_dtype="bfloat16"),)),
        device="cuda").get(mid)
    golden = record_golden(model, chip_smoke.GOLDEN_INPUT,
                           chip_smoke.GOLDEN_SEED,
                           canonical_batch=chip_smoke.CANONICAL_BATCH,
                           device="cuda")["golden"]
    del model
    torch.cuda.empty_cache()
    return golden


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("node_run_trace: CUDA is not available", file=sys.stderr)
        return 1
    from arbius_tpu_torch.l0 import taskid2seed
    from arbius_tpu_torch.templates import hydrate_input, load_template
    from arbius_tpu_torch.utils import card_info

    todo = chip_smoke.tasks(load_template("anythingv3"), hydrate_input,
                            taskid2seed)
    golden = record_golden_here(torch)
    with tempfile.TemporaryDirectory() as work:
        trace_dir = Path(work) / "traces"
        got = chip_smoke.node_run_world(
            [h for _, h, _ in todo], device="cuda", tiny=False, golden=golden,
            workdir=work, settings={"profile_dir": str(trace_dir),
                                    "profile_every": 1})
        lines = []
        for path in sorted(trace_dir.glob("solve-*.json"),
                           key=lambda p: int(p.stem.split("-")[1])):
            line = {"trace": path.name,
                    **summarize(json.loads(path.read_text()))}
            print(json.dumps(line, sort_keys=True), flush=True)
            lines.append(line)
    chip_smoke.check(bool(lines) and all("busy_ms" in ln for ln in lines),
                     f"no device activity in the traces: {lines}")
    keys = ("kernels", "launches", "busy_ms", "device_span_ms",
            "enqueue_ms")
    total = {k: sum(ln[k] for ln in lines) for k in keys}
    total["idle_share"] = 1.0 - total["busy_ms"] / total["device_span_ms"]
    total["dispatches"] = len(lines)
    total["claimed"] = got["summary"]["solutions_claimed"]
    print(card_info())
    print(json.dumps({"node_run_trace": total}, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
