#!/usr/bin/env python3
"""Time the wgmma attention kernels against copies of their sources with
one part of the work taken out or one setting changed (ablations), to see
what holds them back on a card where no profiler runs.

    python3 tools/flash_ablate.py [ROUTE ...]

Needs one CUDA card and nvcc; imports torch and the port only. For each
route in ABLATIONS (the wgmma route, csrc/flash_attn_wgmma.cu, the short
wgmma route, csrc/flash_attn_wgmma_short.cu, and the wgmma wide route,
csrc/flash_attn_wgmma_wide.cu), or the ROUTEs named, builds its source
and each copy (flash_mutants.py's build), checks the intact build against
the plain version within ops/flash.py's `error_bound`, and times every
build, in two rounds in opposite orders, at each shape the route takes at
512x512 and 768x768, in the models' strided views, beside the route it
replaced (YARDSTICK: mma.sync, or mma.sync's wide kernel) and SDPA. Each time is the card's, from `chip_smoke.cuda_ms`: ten calls
captured in a CUDA graph and the graph replayed between two events, so
the host's enqueue is not in it. An ablated build computes wrong
results; only its time is read: the time it saves is what the part
taken out costs where nothing else takes its place. Prints one JSON line
per shape; exit 0 if the intact build passes its check.
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

# route -> name -> (text in the route's source, its replacement) pairs
WGMMA_ABLATIONS = {
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
    "no_qk": [("          wgmma_ss<kBK>(\n",
               "          if (ks < 0) wgmma_ss<kBK>(\n")],
    "no_pv": [("wgmma_rs<D>(o, pa[kk],",
               "if (kk < 0) wgmma_rs<D>(o, pa[kk],")],
    # neither product: the loads, the softmax and the turns
    "no_products": [("          wgmma_ss<kBK>(\n",
                     "          if (ks < 0) wgmma_ss<kBK>(\n"),
                    ("wgmma_rs<D>(o, pa[kk],",
                     "if (kk < 0) wgmma_rs<D>(o, pa[kk],")],
    # half of each K/V tile loaded (its first rows): half the bytes
    "half_loads": [("                     p.k_ss, L::kBK);",
                    "                     p.k_ss, L::kBK / 2);"),
                   ("                     p.v_ss, L::kBK);",
                    "                     p.v_ss, L::kBK / 2);"),
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
_WIDE_ONE_BLOCK = [("constexpr int kCluster = 2;",
                    "constexpr int kCluster = 1;")]
# a cluster of one issuing plain loads: the multicast form into the block
# alone costs the loads alone ~1.7x on the H100
_WIDE_CLUSTER_1 = _WIDE_ONE_BLOCK + [
    ("            tma_load_4d_multicast(sK + st * kBox, &tk, fk, kMask, 64 * c,\n"
     "                                  t * kBK, h, b);",
     "            tma_load_4d(sK + st * kBox, &tk, fk, 64 * c, t * kBK, h, b);"),
    ("            tma_load_4d_multicast(sV + c * kBox, &tv, fv, kMask, 64 * c,\n"
     "                                  t * kBK, h, b);",
     "            tma_load_4d(sV + c * kBox, &tv, fv, 64 * c, t * kBK, h, b);")]
_WIDE_CLUSTER_4 = [("constexpr int kCluster = 2;",
                    "constexpr int kCluster = 4;")]
_WIDE_LOADS_ONLY = [("      // S_t = Q K_t^T\n",
                     "      for (int box = 0; box < kBoxes; ++box)\n"
                     "        release(smem_addr(&bars.empty_k[(t * kBoxes"
                     " + box) % kKSlots]), lane);\n"
                     "      for (int i = 0; i < 4; ++i)\n"
                     "        mbar_wait(smem_addr(&bars.full_v[4 * c + i]"
                     "), t & 1);\n"
                     "      for (int i = 0; i < 4; ++i)\n"
                     "        release(smem_addr(&bars.empty_v[4 * c + i])"
                     ", lane);\n      continue;\n")]
_WIDE_QK_SPLIT = [
    ("constexpr int kKSlots = 12;", "constexpr int kKSlots = 8;"),
    ("constexpr int kSmem = kQ + (kKSlots + kBoxes) * kBox + 1024;",
     "constexpr int kSmem = kQ + (kKSlots + kBoxes) * kBox"
     " + 2 * kBQ * kBK * 4 + 1024;"),
    ("  const uint32_t sV = sK + kKSlots * kBox;     // [box][kBK][kRow]\n",
     "  const uint32_t sV = sK + kKSlots * kBox;\n"
     "  float* const sX = reinterpret_cast<float*>(\n"
     "      smem_raw + (sV + kBoxes * kBox - smem_addr(smem_raw)));\n"),
    ("      mbar_init(smem_addr(&bars.empty_k[s]), 4 * kConsumers * kCluster);",
     "      mbar_init(smem_addr(&bars.empty_k[s]), 4 * kCluster);"),
    ("      for (int box = 0; box < kBoxes; ++box) {\n"
     "        const int f = t * kBoxes + box;\n",
     "      for (int i = 0; i < 4; ++i) {\n"
     "        const int f = t * kBoxes + 4 * c + i;\n"),
    ("      for (int box = 0; box < kBoxes; ++box) {\n"
     "        const uint32_t slot",
     "      for (int i = 0; i < 4; ++i) {\n"
     "        const int box = 4 * c + i;\n"
     "        const uint32_t slot"),
    ("desc_sw128(slot + ks * 32, 16, 1024), box + ks > 0);",
     "desc_sw128(slot + ks * 32, 16, 1024), i + ks > 0);"),
    ("      for (int box = 0; box < kBoxes; ++box) {\n"
     "        wgmma_wait_n(kBoxes - 1 - box);\n"
     "        release(smem_addr(&bars.empty_k[(t * kBoxes + box) % kKSlots]),"
     "\n                lane);\n      }\n      fence_all();\n",
     "      for (int i = 0; i < 4; ++i) {\n"
     "        wgmma_wait_n(3 - i);\n"
     "        release(smem_addr(&bars.empty_k[(t * kBoxes + 4 * c + i)"
     " % kKSlots]), lane);\n      }\n      fence_all();\n"
     "      const int tid = threadIdx.x & 127;\n"
     "      for (int i = 0; i < kS; ++i) sX[(c * kS + i) * 128 + tid] ="
     " s[i];\n"
     "      named_sync(1, 256);\n"
     "      for (int i = 0; i < kS; ++i) s[i] += sX[((1 - c) * kS + i)"
     " * 128 + tid];\n"
     "      named_sync(2, 256);\n"),
]
ABLATIONS = {
    "tensor_core_wgmma": WGMMA_ABLATIONS,
    "tensor_core_wgmma_short": {
        "intact": [],
        # two consumer warpgroups at D = 40, 64 and 80 too, as at D = 160
        "two_consumers": [
            ("kConsumers = D == 160 ? 2 : 3;", "kConsumers = 2;"),
            ("kProducerRegs = D == 40 ? 24 : 40;", "kProducerRegs = 40;"),
            ("kConsumerRegs = D == 40 ? 160 : D == 160 ? 232 : 152;",
             "kConsumerRegs = 232;")],
        # one query-tile stage per consumer, not two or three
        "one_stage_each": [("constexpr int kMaxStages = 8;",
                            "constexpr int kMaxStages = 3;")],
    },
    "tensor_core_wgmma_wide": {
        "intact": [],
        # each block loads all of K and V itself (the L2 question), or a
        # cluster of four shares each load
        "cluster_1": _WIDE_CLUSTER_1,
        "cluster_4": _WIDE_CLUSTER_4,
        # the product O += P V, or S = Q K^T, not issued
        "no_pv": [("        wgmma_rs<256>(o, pa[kk],",
                   "        if (kk < 0) wgmma_rs<256>(o, pa[kk],")],
        "no_qk": [("          wgmma_ss<kBK>(s, desc_sw128(",
                   "          if (ks < 0) wgmma_ss<kBK>(s, desc_sw128(")],
        # the consumers release each box as it lands: the TMA loads alone,
        # at each cluster size (L2's share, against each SM's intake)
        "loads_only": _WIDE_LOADS_ONLY,
        "loads_only_cluster_1": _WIDE_LOADS_ONLY + _WIDE_CLUSTER_1,
        "loads_only_cluster_1_multicast": _WIDE_LOADS_ONLY + _WIDE_ONE_BLOCK,
        "loads_only_cluster_4": _WIDE_LOADS_ONLY + _WIDE_CLUSTER_4,
        # no spare K slots: the next tile's K boxes wait for this tile's
        "k_slots_8": [("constexpr int kKSlots = 12;",
                       "constexpr int kKSlots = 8;")],
        # Q K^T split over D instead of done twice: consumer c contracts
        # its half (K boxes 4c .. 4c + 3) and the two add their float32
        # partial sums through shared memory, two barriers a tile
        "qk_split_over_d": _WIDE_QK_SPLIT,
    },
}
# the route each one replaced on the main path, timed beside it
YARDSTICK = {"tensor_core_wgmma": "tensor_core",
             "tensor_core_wgmma_short": "tensor_core",
             "tensor_core_wgmma_wide": "tensor_core_wide"}


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("flash_ablate: CUDA is not available", file=sys.stderr)
        return 1
    from arbius_tpu_torch.ops import _build, flash
    from arbius_tpu_torch.utils import card_info, setup_device

    chosen = {route: ABLATIONS[route] for route in sys.argv[1:]
              } or ABLATIONS
    setup_device("cuda")
    print(card_info(), flush=True)
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        built = build_edited(Path(tmp), {
            (route, name): pairs for route, ablations in chosen.items()
            for name, pairs in ablations.items()})
        libs = {}
        for (route, name), so in built.items():
            libs[route, name] = ctypes.CDLL(str(so))
            flash._declare(libs[route, name])
        gen = torch.Generator(device="cuda").manual_seed(0)
        for route, ablations in chosen.items():
            source = flash.SOURCES[route]
            for bucket, shapes in (("512x512", chip_smoke.MAIN_PATH_SHAPES),
                                   ("768x768", chip_smoke.BUCKET_768_SHAPES)):
                for b, h, sq, skv, d, _ in shapes:
                    q, k, v = (torch.randn(b, s, h * d, generator=gen,
                                           device="cuda").bfloat16()
                               .view(b, s, h, d).transpose(1, 2)
                               for s in (sq, skv, skv))
                    if flash.route_of(q, k, v) != route:
                        continue
                    row = {"route": route, "bucket": bucket,
                           "shape": [b, h, sq, skv, d]}
                    _build._loaded[source] = libs[route, "intact"]
                    out = flash.flash_attention(q, k, v)
                    err = chip_smoke.kernel_error(torch, flash, q, k, v, out,
                                                  route)
                    row["intact_check"] = err
                    ok = ok and err["ok"]
                    row["sdpa_ms"] = chip_smoke.cuda_ms(
                        torch,
                        lambda: F.scaled_dot_product_attention(q, k, v), 10)
                    yard = YARDSTICK[route]
                    row[f"{yard}_ms"] = chip_smoke.cuda_ms(
                        torch, lambda: flash.flash_attention(
                            q, k, v, kernel=yard), 10)
                    for rnd in range(2):
                        order = (list(ablations) if rnd == 0
                                 else list(ablations)[::-1])
                        for name in order:
                            _build._loaded[source] = libs[route, name]
                            row.setdefault(f"{name}_ms", []).append(
                                chip_smoke.cuda_ms(
                                    torch,
                                    lambda: flash.flash_attention(q, k, v),
                                    10))
                    print(json.dumps(row), flush=True)
                    del q, k, v, out
                    torch.cuda.empty_cache()
            _build._loaded.pop(source, None)
    print(f"intact builds within their bound at every shape: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
