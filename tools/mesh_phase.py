#!/usr/bin/env python3
"""Run chip_smoke.py's phase 15 (the mesh of lanes on the one card) alone.

    python3 tools/mesh_phase.py

On a machine with a CUDA card, from the root of a checkout: builds the
flash kernels, builds a full-width anythingv3 model (seed 0, bf16 weights)
and records its golden at the committed input, then runs
`chip_smoke.phase_mesh` with that model as the mesh-off solve and the
committed golden where the recorded one equals it. Prints the phase's
lines, its wall seconds and its result as JSON.
"""
import concurrent.futures
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from arbius_tpu_torch.cli import record_golden  # noqa: E402
from arbius_tpu_torch.node import (  # noqa: E402
    MiningConfig,
    ModelConfig,
    build_registry,
)
from arbius_tpu_torch.ops import _build, flash  # noqa: E402
from arbius_tpu_torch.utils import card_info, setup_device  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("mesh_phase: CUDA is not available", file=sys.stderr)
        return 1
    t_all = time.perf_counter()
    setup_device("cuda")
    print(card_info(), torch.__version__, torch.version.cuda, flush=True)
    sources = list(flash.SOURCES.values())
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(_build.build, sources))
    print(f"built in {time.perf_counter() - t_all:.1f} s", flush=True)
    expected = cs.expected_launches(torch, flash)
    mid = "0x" + "00" * 32
    cfg = MiningConfig(canonical_batch=cs.CANONICAL_BATCH, models=(
        ModelConfig(id=mid, template="anythingv3",
                    weights_dtype="bfloat16"),))
    fresh = build_registry(cfg, device="cuda").get(mid)
    root = pathlib.Path(cs.__file__).resolve().parent
    committed = json.loads((root / cs.GOLDEN_FILE).read_text())
    rec = record_golden(fresh, cs.GOLDEN_INPUT, cs.GOLDEN_SEED,
                        canonical_batch=cs.CANONICAL_BATCH, device="cuda")
    same = rec["golden"] == committed["golden"]
    print(f"golden {rec['golden']['cid']} equals committed: {same}",
          flush=True)
    t0 = time.perf_counter()
    out = cs.phase_mesh(torch, flash, expected,
                        fresh, committed["golden"] if same else
                        rec["golden"], "committed" if same else "recorded")
    print(f"phase 15: {time.perf_counter() - t0:.1f} s wall", flush=True)
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
