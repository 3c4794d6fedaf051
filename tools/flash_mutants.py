#!/usr/bin/env python3
"""Show that chip_smoke.py's kernel check catches a subtly wrong kernel.

    python3 tools/flash_mutants.py

Needs one CUDA card and nvcc; imports torch and the port only. Builds
csrc/flash_attn.cu and copies of it with one deliberate fault each
(MUTANTS) into a temporary directory, all at once, and runs each at the
main path's bf16 shapes through chip_smoke.py's check: the kernel against
the plain version in float32 on the same inputs. For each build it prints
one JSON line: the largest error and the output's RMS per shape, whether
the check passes, and whether the looser check it replaced (rtol = atol
= 2e-2 against the plain version in bf16) would have. Exits 0 only if
the faultless build passes and every mutant fails.
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

# name -> (text in csrc/flash_attn.cu, its replacement); None: no fault
MUTANTS = {
    "faultless": None,
    # the last key of every sequence is left out of the softmax
    "drops_last_key": ("const int nvalid = min(BK, p.skv - kv0);",
                       "const int nvalid = min(BK, p.skv - kv0)"
                       " - (kv0 + BK >= p.skv);"),
    # scores scaled by 1.01 / sqrt(D)
    "scale_1pct_high": ("? s[i][j] * p.scale", "? s[i][j] * (1.01f * p.scale)"),
}


def build_all(tmp: Path) -> dict[str, Path]:
    from arbius_tpu_torch.ops import _build, flash

    source = (_build.CSRC / flash.SOURCE).read_text()
    jobs = {}
    for name, edit in MUTANTS.items():
        text = source
        if edit is not None:
            if text.count(edit[0]) != 1:
                raise RuntimeError(f"{name}: {edit[0]!r} not found once")
            text = text.replace(*edit)
        (tmp / f"{name}.cu").write_text(text)
        jobs[name] = (tmp / f"{name}.cu", tmp / f"{name}.so")
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        list(pool.map(lambda job: _build.compile_library(*job),
                      jobs.values()))
    return {name: so for name, (_, so) in jobs.items()}


def run(torch, flash, name: str) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes, new_ok, old_ok = [], True, True
    for b, h, sq, skv, d, _ in chip_smoke.MAIN_PATH_SHAPES:
        q, k, v = (torch.randn(b, h, s, d, generator=gen, device="cuda")
                   .bfloat16() for s in (sq, skv, skv))
        out = flash.flash_attention(q, k, v)
        err, rms, ok = chip_smoke.kernel_error(torch, flash, q, k, v, out)
        plain = flash.flash_attention_reference(q, k, v).float()
        old = torch.allclose(out.float(), plain, rtol=2e-2, atol=2e-2)
        new_ok, old_ok = new_ok and ok, old_ok and old
        shapes.append({"shape": [b, h, sq, skv, d], "max_abs_err": err,
                       "ref_rms": rms, "passes": ok, "passes_old": old})
        del q, k, v, out, plain
    torch.cuda.empty_cache()
    return {"build": name, "passes_check": new_ok,
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
    verdicts = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, so in build_all(Path(tmp)).items():
            lib = ctypes.CDLL(str(so))
            flash._declare(lib)
            _build._loaded[flash.SOURCE] = lib   # flash_attention loads this
            result = run(torch, flash, name)
            verdicts[name] = result["passes_check"]
            print(json.dumps(result), flush=True)
    _build._loaded.pop(flash.SOURCE)
    caught = verdicts.pop("faultless") and not any(verdicts.values())
    print(f"faultless build passes and every mutant fails: {caught}")
    return 0 if caught else 1


if __name__ == "__main__":
    sys.exit(main())
