#!/usr/bin/env python3
"""Show that chip_smoke.py's kernel check catches a subtly wrong kernel,
on each of the six attention routes.

    python3 tools/flash_mutants.py

Needs one CUDA card and nvcc; imports torch and the port only. For each
kernel source (csrc/flash_attn_wgmma.cu, the wgmma route,
csrc/flash_attn_wgmma_short.cu, the short wgmma route,
csrc/flash_attn_wgmma_wide.cu, the wgmma wide route,
csrc/flash_attn_tc.cu, the mma.sync tensor-core route,
csrc/flash_attn_tc_wide.cu, the wide tensor-core route, and
csrc/flash_attn.cu, the CUDA-core route) builds the source
and copies of it with one deliberate fault each (MUTANTS) into a
temporary directory, all at once, and runs each build at the bf16
main-path shapes its kernel takes (`ops.flash.routes_of`: the short
wgmma route at the 5 with at most 128 keys, the wgmma and the mma.sync
routes at the 8 UNet shapes, the two wide ones at the VAE's, the
CUDA-core route at all 9) through
chip_smoke.py's check: the kernel against the plain
version in float32 on the same inputs, within ops/flash.py's
`error_bound` for the route. For each build it prints one JSON line: the
largest error, the output's RMS and the worst error/bound per shape,
whether the check passes, and whether the loose check the CUDA-core
route once had (rtol = atol = 2e-2 against the plain version in bf16)
would. Exits 0 only if, for each source, the faultless build passes and
every mutant fails at every shape.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import json
import os
import sys
import tempfile
from pathlib import Path

# `python3 tools/<tool>.py` puts tools/, not the repository root, on sys.path
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

# route -> name -> (text in the route's source, its replacement); None: no
# fault. Each route's two faults: the last key of every sequence is left
# out of the softmax; the scores are scaled by 1.01 / sqrt(D).
_TENSOR_CORE_FAULTS = {
    "faultless": None,
    "drops_last_key": ("const int kv_end = p.skv;",
                       "const int kv_end = p.skv - 1;"),
    "scale_1pct_high": ("const float sl2 = p.scale * kLog2e;",
                        "const float sl2 = 1.01f * p.scale * kLog2e;"),
}
MUTANTS = {
    "tensor_core_wgmma": _TENSOR_CORE_FAULTS,
    "tensor_core_wgmma_short": _TENSOR_CORE_FAULTS,
    "tensor_core_wgmma_wide": _TENSOR_CORE_FAULTS,
    "tensor_core": _TENSOR_CORE_FAULTS,
    "tensor_core_wide": _TENSOR_CORE_FAULTS,
    "cuda_core": {
        "faultless": None,
        "drops_last_key": ("const int nvalid = min(BK, p.skv - kv0);",
                           "const int nvalid = min(BK, p.skv - kv0)"
                           " - (kv0 + BK >= p.skv);"),
        "scale_1pct_high": ("? s[i][j] * p.scale",
                            "? s[i][j] * (1.01f * p.scale)"),
    },
}


def build_edited(tmp: Path, edits: dict, copies: dict | None = None
                 ) -> dict[tuple[str, str], Path]:
    """Compile into `tmp`, all at once, one copy of a route's source per
    key (route, name) of `edits`, with that key's list of (text,
    replacement) pairs applied; each text must occur once. `copies` maps
    more keys to source files written elsewhere, compiled with the rest
    (a source includes the headers beside it before csrc/'s). Returns the
    library of each key."""
    from arbius_tpu_torch.ops import _build, flash

    jobs = {key: (src, src.with_suffix(".so"))
            for key, src in (copies or {}).items()}
    for (route, name), pairs in edits.items():
        text = (_build.CSRC / flash.SOURCES[route]).read_text()
        for old, new in pairs:
            if text.count(old) != 1:
                raise RuntimeError(f"{route} {name}: {old!r} not found once")
            text = text.replace(old, new)
        src = tmp / f"{route}-{name}.cu"
        src.write_text(text)
        jobs[route, name] = (src, src.with_suffix(".so"))
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        list(pool.map(lambda job: _build.compile_library(*job),
                      jobs.values()))
    return {key: so for key, (_, so) in jobs.items()}


def build_all(tmp: Path) -> dict[tuple[str, str], Path]:
    return build_edited(tmp, {
        (route, name): [] if edit is None else [edit]
        for route, mutants in MUTANTS.items()
        for name, edit in mutants.items()})


def run(torch, flash, route: str, name: str) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes, all_pass, all_fail, old_ok = [], True, True, True
    for b, h, sq, skv, d, _ in chip_smoke.MAIN_PATH_SHAPES:
        q, k, v = (torch.randn(b, h, s, d, generator=gen, device="cuda")
                   .bfloat16() for s in (sq, skv, skv))
        if route not in flash.routes_of(q, k, v):
            continue
        out = flash.flash_attention(q, k, v, kernel=route)
        err = chip_smoke.kernel_error(torch, flash, q, k, v, out, route)
        plain = flash.flash_attention_reference(q, k, v).float()
        old = torch.allclose(out.float(), plain, rtol=2e-2, atol=2e-2)
        all_pass, all_fail = all_pass and err["ok"], all_fail and not err["ok"]
        old_ok = old_ok and old
        shapes.append({"shape": [b, h, sq, skv, d], **err,
                       "passes_old": old})
        del q, k, v, out, plain
    torch.cuda.empty_cache()
    return {"route": route, "build": name, "passes_check": all_pass,
            "fails_at_every_shape": all_fail,
            "passes_old_check": old_ok, "shapes": shapes}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_mutants: CUDA is not available", file=sys.stderr)
        return 1
    from arbius_tpu_torch.ops import _build, flash
    from arbius_tpu_torch.utils import card_info, setup_device

    setup_device("cuda")
    print(card_info(), flush=True)
    caught = True
    with tempfile.TemporaryDirectory() as tmp:
        for (route, name), so in build_all(Path(tmp)).items():
            lib = ctypes.CDLL(str(so))
            flash._declare(lib)
            # flash_attention loads the route's source through this cache
            _build._loaded[flash.SOURCES[route]] = lib
            result = run(torch, flash, route, name)
            caught &= (result["passes_check"] if name == "faultless"
                       else result["fails_at_every_shape"])
            print(json.dumps(result), flush=True)
    for source in flash.SOURCES.values():
        _build._loaded.pop(source, None)
    print(f"for each route the faultless build passes and every mutant "
          f"fails at every shape: {caught}")
    return 0 if caught else 1


if __name__ == "__main__":
    sys.exit(main())
