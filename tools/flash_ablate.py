#!/usr/bin/env python3
"""Time the wgmma attention kernel against copies of its source with one
part of the work taken out (ablations), to see what holds it back on a
card where no profiler runs.

    python3 tools/flash_ablate.py

Needs one CUDA card and nvcc; imports torch and the port only. Builds
csrc/flash_attn_wgmma.cu and each copy in ABLATIONS (flash_mutants.py's
build), checks the intact build against the plain version within
ops/flash.py's `error_bound`, and times every build, in two rounds in
opposite orders, at each self-attention the wgmma route takes at 512x512
and 768x768, in the models' strided views, beside the mma.sync route and
SDPA. An ablated build computes wrong results; only its time is read: the
time it saves is what the part taken out costs where nothing else takes
its place. Prints one JSON line per shape; exit 0 if the intact build
passes its check.
"""
from __future__ import annotations

import ctypes
import json
import os
import sys
import tempfile
from pathlib import Path

# `python3 tools/<tool>.py` puts tools/, not the repository root, on sys.path
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from flash_mutants import build_edited  # noqa: E402

ROUTE = "tensor_core_wgmma"
# name -> (text in csrc/flash_attn_wgmma.cu, its replacement) pairs
ABLATIONS = {
    "intact": [],
    # D = 40 on two consumer warpgroups (128-row tiles), as at D = 80
    "two_consumers": [
        ("kWarpgroups = D == 40 ? 3 : 2;", "kWarpgroups = 2;"),
        ("kProducerRegs = D == 40 ? 24 : 40;", "kProducerRegs = 40;"),
        ("kConsumerRegs = D == 40 ? 160 : 232;", "kConsumerRegs = 232;")],
    # the exponentials (the SFU's work) left out of the softmax
    "no_exp2": [("s[i] = ex2(fmaf(s[i], sl2, -msc[(i >> 1) & 1]));",
                 "s[i] = fmaf(s[i], sl2, -msc[(i >> 1) & 1]);")],
    # the product S = Q K^T, or O += P V, not issued
    "no_qk": [("          wgmma_ss_n128(\n",
               "          if (ks < 0) wgmma_ss_n128(\n")],
    "no_pv": [("wgmma_pv<D>(o, pa[kk],",
               "if (kk < 0) wgmma_pv<D>(o, pa[kk],")],
    # neither product: the loads, the softmax and the turns
    "no_products": [("          wgmma_ss_n128(\n",
                     "          if (ks < 0) wgmma_ss_n128(\n"),
                    ("wgmma_pv<D>(o, pa[kk],",
                     "if (kk < 0) wgmma_pv<D>(o, pa[kk],")],
    # half of each K/V tile loaded (its first 64 rows): half the bytes
    "half_loads": [("                     p.k_ss, kBK);",
                    "                     p.k_ss, 64);"),
                   ("                     p.v_ss, kBK);",
                    "                     p.v_ss, 64);"),
                   ("mbar_arrive_expect_tx(fk, L::kKV);",
                    "mbar_arrive_expect_tx(fk, L::kKV / 2);"),
                   ("mbar_arrive_expect_tx(fv, L::kKV);",
                    "mbar_arrive_expect_tx(fv, L::kKV / 2);")],
    # the consumers release each tile as it lands: the TMA loads alone
    "loads_only": [("      named_sync(kBarTurn + c, 256);\n",
                    "      if (has_s) mbar_arrive(smem_addr(&bars.empty_k"
                    "[st]));\n      if (has_pv) mbar_arrive(smem_addr("
                    "&bars.empty_v[pst]));\n      continue;\n")],
}


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("flash_ablate: CUDA is not available", file=sys.stderr)
        return 1
    from arbius_tpu_torch.ops import _build, flash
    from arbius_tpu_torch.utils import card_info, setup_device

    setup_device("cuda")
    print(card_info(), flush=True)
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        built = build_edited(Path(tmp), {(ROUTE, name): pairs
                                         for name, pairs in ABLATIONS.items()})
        libs = {}
        for (_, name), so in built.items():
            libs[name] = ctypes.CDLL(str(so))
            flash._declare(libs[name])
        gen = torch.Generator(device="cuda").manual_seed(0)
        for bucket, shapes in (("512x512", chip_smoke.MAIN_PATH_SHAPES),
                               ("768x768", chip_smoke.BUCKET_768_SHAPES)):
            for b, h, sq, skv, d, _ in shapes:
                q, k, v = (torch.randn(b, s, h * d, generator=gen,
                                       device="cuda").bfloat16()
                           .view(b, s, h, d).transpose(1, 2)
                           for s in (sq, skv, skv))
                if flash.route_of(q, k, v) != ROUTE:
                    continue
                row = {"bucket": bucket, "shape": [b, h, sq, skv, d]}
                _build._loaded[flash.SOURCES[ROUTE]] = libs["intact"]
                out = flash.flash_attention(q, k, v)
                err = chip_smoke.kernel_error(torch, flash, q, k, v, out,
                                              ROUTE)
                row["intact_check"] = err
                ok = ok and err["ok"]
                row["sdpa_ms"] = chip_smoke.cuda_ms(
                    torch, lambda: F.scaled_dot_product_attention(q, k, v),
                    10)
                row["tensor_core_ms"] = chip_smoke.cuda_ms(
                    torch, lambda: flash.flash_attention(
                        q, k, v, kernel="tensor_core"), 10)
                for rnd in range(2):
                    order = list(libs) if rnd == 0 else list(libs)[::-1]
                    for name in order:
                        _build._loaded[flash.SOURCES[ROUTE]] = libs[name]
                        row.setdefault(f"{name}_ms", []).append(
                            chip_smoke.cuda_ms(
                                torch, lambda: flash.flash_attention(q, k, v),
                                10))
                print(json.dumps(row), flush=True)
                del q, k, v, out
                torch.cuda.empty_cache()
    _build._loaded.pop(flash.SOURCES[ROUTE], None)
    print(f"intact build within its bound at every shape: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
