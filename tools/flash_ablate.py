#!/usr/bin/env python3
"""Time the wgmma attention kernels against copies of their sources with
one part of the work taken out or one setting changed (ablations), to see
what holds them back on a card where no profiler runs.

    python3 tools/flash_ablate.py [ROUTE ...] [--against OTHER_CHECKOUT]

Needs one CUDA card and nvcc; imports torch and the port only. For each
route in ABLATIONS (the wgmma route, csrc/flash_attn_wgmma.cu, the short
wgmma route, csrc/flash_attn_wgmma_short.cu, and the wgmma wide route,
csrc/flash_attn_wgmma_wide.cu), or the ROUTEs named, builds its source
and each copy (flash_mutants.py's build), checks the intact build against
the plain version within ops/flash.py's `error_bound`, and times every
build, in two rounds in opposite orders, at each shape the route takes at
512x512, 768x768 and 640x640's ragged lengths and in damo's and
zeroscopev2xl's chunks (`buckets`), in the models' strided views, beside
the routes forced onto the same calls as yardsticks (YARDSTICKS:
mma.sync, or mma.sync's wide kernel, and for the short route the wgmma
one too), SDPA and the shape's bound (`chip_smoke.bound_ms`). With
`--against`, the
other checkout's source of each route (the parent commit unpacked with
`git archive`), built with that checkout's own headers, is one more
build in both rounds. Each time is the card's, from `chip_smoke.cuda_ms`:
ten calls captured in a CUDA graph and the graph replayed between two
events, so the host's enqueue is not in it. An ablated build computes
wrong results; only its time is read: the time it saves is what the
part taken out costs where nothing else takes its place. Prints one JSON
line per shape (each build's times, the bound's share of the intact
build's mean, and the builds whose output has the intact build's bits),
then per bucket each build's and yardstick's mean time summed over one
anythingv3 batch or one video chunk's calls; exit 0 if the intact build
passes its check.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import statistics
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
    # two consumer warpgroups (128-row tiles) at D = 40 and 64
    "two_consumers": [
        ("  if (d == 40) return launch<40, 3>(p, batch, st);",
         "  if (d == 40) return launch<40, 2>(p, batch, st);"),
        ("return 5 * rows3 <= 6 * rows2 ? 3 : 2;", "return 2;")],
    # the exponentials (the SFU's work) left out of the softmax
    "no_exp2": [("s[j] = ex2(fmaf(s[j], sl2, -msc[(j >> 1) & 1]));",
                 "s[j] = fmaf(s[j], sl2, -msc[(j >> 1) & 1]);")],
    # the product S = Q K^T, or O += P V, not issued
    "no_qk": [("            wgmma_ss<kBK>(\n",
               "            if (ks < 0) wgmma_ss<kBK>(\n")],
    "no_pv": [("wgmma_rs<D>(o, pa[kk],",
               "if (kk < 0) wgmma_rs<D>(o, pa[kk],")],
    # neither product: the loads, the softmax and the turns
    "no_products": [("            wgmma_ss<kBK>(\n",
                     "            if (ks < 0) wgmma_ss<kBK>(\n"),
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
    # the consumers release each tile as it lands: the TMA loads (and
    # O's stores) alone
    "loads_only": [("        named_sync(kBarTurn + c, 256);\n",
                    "        if (has_s) mbar_arrive(smem_addr(&bars.empty_k"
                    "[st]));\n        if (has_s) mbar_arrive_if(smem_addr("
                    "&bars.empty_q), t == ntiles - 1);\n        if "
                    "(has_pv) mbar_arrive(smem_addr(&bars.empty_v[pst]));"
                    "\n        return;\n")],
    # three consumer warpgroups (192-row tiles) at D = 64 at every length
    "three_consumers": [("return 5 * rows3 <= 6 * rows2 ? 3 : 2;",
                         "return 3;")],
    # the consumers issue their products in no fixed turn
    "no_turns": [
        ("    if (c == 0) named_arrive(kBarTurn, 256);  // consumer 0 goes "
         "first\n", ""),
        ("        named_sync(kBarTurn + c, 256);\n", ""),
        ("        named_arrive_if(kBarTurn + (c + 1) % kWG, 256,\n"
         "                        has_s || c + 1 < kWG || !last_work);\n",
         "")],
    # P's bf16 conversion by integer rounding (the same bits for P's
    # finite values), off the pipe the exp2s take
    "p_pack_int": [
        ("template <int D, int WG>\n__global__",
         "__device__ __forceinline__ uint32_t pack_int(float lo, float hi) {\n"
         "  uint32_t a = __float_as_uint(lo), b = __float_as_uint(hi);\n"
         "  a += 0x7fffu + ((a >> 16) & 1u);\n"
         "  b += 0x7fffu + ((b >> 16) & 1u);\n"
         "  return __byte_perm(a, b, 0x7632);\n}\n\n"
         "template <int D, int WG>\n__global__"),
        *((f"pa[kk][{e}] = pack_bf16(s[8 * kk{a}],",
           f"pa[kk][{e}] = pack_int(s[8 * kk{a}],")
          for e, a in ((0, ""), (1, " + 2"), (2, " + 4"), (3, " + 6")))],
    # the K/V ring n stages deep where more would fit (D = 40, 64)
    **{f"ring_{n}": [("constexpr int kMaxStages = 6;",
                      f"constexpr int kMaxStages = {n};")]
       for n in (2, 3, 4)},
    # one block per work tile, as before the blocks persisted
    "a_block_per_tile": [
        ("const int grid = work < sm_count() ? work : sm_count();",
         "const int grid = work;")],
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
        # two consumer warpgroups at every D, as at D = 160
        "two_consumers": [
            ("kConsumers = D == 40 ? 4 : D == 160 ? 2 : 3;", "kConsumers = 2;"),
            ("kProducerRegs = D == 40 ? 24 : 40;", "kProducerRegs = 40;"),
            ("kConsumerRegs = D == 40 ? 112 : D == 160 ? 232 : 152;",
             "kConsumerRegs = 232;")],
        # three at D = 40, as at D = 64 and 80 (160 registers each)
        "three_consumers_d40": [
            ("kConsumers = D == 40 ? 4 : D == 160 ? 2 : 3;",
             "kConsumers = D == 160 ? 2 : 3;"),
            ("kConsumerRegs = D == 40 ? 112 : D == 160 ? 232 : 152;",
             "kConsumerRegs = D == 40 ? 160 : D == 160 ? 232 : 152;")],
        # the consumers release each Q stage as it lands: the loads alone
        "loads_only": [
            ("      mbar_wait(smem_addr(&bars.q_full[st]), (i / L::kQStages)"
             " & 1);\n",
             "      mbar_wait(smem_addr(&bars.q_full[st]), (i / L::kQStages)"
             " & 1);\n      mbar_arrive(smem_addr(&bars.q_empty[st]));\n"
             "      continue;\n")],
        # no O staging and no store
        "no_epilogue": [
            ("      if (t == 0) bulk_wait_read<0>();\n      named_sync(",
             "      if (l[0] != -1.f) continue;\n"
             "      if (t == 0) bulk_wait_read<0>();\n      named_sync(")],
        # one K/V slot: the next b*h's K and V wait for this one's tiles
        "one_kv_slot": [("constexpr int kMaxKVSlots = 8;",
                         "constexpr int kMaxKVSlots = 1;")],
        # two Q stages per consumer at D = 40 and 80 too
        "two_q_stages": [("kQStages = D == 64 ? 2 : 1;",
                          "kQStages = D == 160 ? 1 : 2;")],
        # the grid the SM count (or the tiles) at every shape, not equal
        # ranges aligned to the b*h where they cost no longer run
        "sm_count_grid": [
            ("  const int grid = blocks(bh, nq, L::kConsumers);",
             "  const int grid = work < sm_count() ? work : sm_count();")],
        # S = Q K^T not issued (S zero, so that the softmax and O / l see
        # ordinary values): what an S issued before the last tile's
        # epilogue could hide, at most
        "no_qk": [("        wgmma_ss<NK>(s_acc,",
                   "        if (ks < 0) wgmma_ss<NK>(s_acc,"),
                  ("      float s_acc[kS];\n",
                   "      float s_acc[kS];\n"
                   "      for (int e = 0; e < kS; ++e) s_acc[e] = 0.f;\n")],
        # two O staging tiles per consumer in turn: a store's reading of
        # one overlaps the next tile's epilogue
        "two_o_stages": [
            ("kFixed = kConsumers * (kQStages * kQ + kO) + 1024;",
             "kFixed = kConsumers * (kQStages * kQ + 2 * kO) + 1024;"),
            ("      const uint32_t my_o = sO + c * L::kO;",
             "      const uint32_t my_o = sO + (2 * c + i % 2) * L::kO;"),
            ("      if (t == 0) bulk_wait_read<0>();\n      named_sync(",
             "      if (t == 0) bulk_wait_read<1>();\n      named_sync(")],
        # one block per tile, not persistent
        "a_block_per_tile": [
            ("  const int grid = blocks(bh, nq, L::kConsumers);",
             "  const int grid = work;")],
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
# routes forced onto each route's calls and timed beside it: the one it
# replaced on the main path, and for the short route the wgmma route too
YARDSTICKS = {"tensor_core_wgmma": ("tensor_core",),
              "tensor_core_wgmma_short": ("tensor_core", "tensor_core_wgmma"),
              "tensor_core_wgmma_wide": ("tensor_core_wide",)}


def buckets() -> tuple:
    """(bucket, shapes) timed: anythingv3's 512x512 and 768x768, 640x640's
    ragged lengths, and the chunks of damo and zeroscopev2xl."""
    return (("512x512", chip_smoke.MAIN_PATH_SHAPES),
            ("768x768", chip_smoke.BUCKET_768_SHAPES),
            ("640x640", chip_smoke.BUCKET_640_RAGGED_SHAPES),
            ("damo 256x256x16", chip_smoke.DAMO_SHAPES),
            ("zeroscopev2xl 1024x576x24", chip_smoke.ZEROSCOPE_SHAPES))


def against_copy(tmp: Path, other: Path, source: str) -> Path:
    """The other checkout's `source` with its own headers, in a directory
    of their own under `tmp`."""
    where = tmp / "against"
    where.mkdir(parents=True, exist_ok=True)
    for header in (other / "arbius_tpu_torch" / "csrc").glob("*.cuh"):
        shutil.copy(header, where / header.name)
    return Path(shutil.copy(other / "arbius_tpu_torch" / "csrc" / source,
                            where / source))


def main() -> int:
    import torch
    import torch.nn.functional as F

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("routes", nargs="*", metavar="ROUTE",
                        help=f"routes to time (default: all of "
                        f"{', '.join(ABLATIONS)})")
    parser.add_argument("--against", metavar="OTHER_CHECKOUT",
                        help="also time the other checkout's source of "
                        "each route, built with its own headers")
    args = parser.parse_args()
    unknown = sorted(set(args.routes) - set(ABLATIONS))
    if unknown:
        parser.error(f"no ablations for {unknown}")
    if not torch.cuda.is_available():
        print("flash_ablate: CUDA is not available", file=sys.stderr)
        return 1
    from arbius_tpu_torch.ops import _build, flash
    from arbius_tpu_torch.utils import card_info, setup_device

    chosen = {route: dict(ABLATIONS[route]) for route in args.routes
              } or {route: dict(a) for route, a in ABLATIONS.items()}
    setup_device("cuda")
    print(card_info(), flush=True)
    ok = True
    # (route, bucket) -> build -> the mean ms of its shapes' calls in one
    # anythingv3 batch or one video chunk (the shapes' launch counts)
    totals: dict[tuple[str, str], dict[str, float]] = {}
    with tempfile.TemporaryDirectory() as tmp:
        copies = {}
        if args.against:
            for route, ablations in chosen.items():
                ablations["against"] = []
                copies[route, "against"] = against_copy(
                    Path(tmp) / route, Path(args.against),
                    flash.SOURCES[route])
        built = build_edited(Path(tmp), {
            (route, name): pairs for route, ablations in chosen.items()
            for name, pairs in ablations.items() if name != "against"},
            copies)
        libs = {}
        for (route, name), so in built.items():
            libs[route, name] = ctypes.CDLL(str(so))
            flash._declare(libs[route, name])
            report = so.with_suffix(".log").read_text()
            print(json.dumps({
                "route": route, "build": name,
                "spills": [r.strip() for r in report.splitlines()
                           if "spill" in r],
                "serialisation_notes":
                    chip_smoke.serialisation_notes(report)}), flush=True)
        gen = torch.Generator(device="cuda").manual_seed(0)
        for route, ablations in chosen.items():
            source = flash.SOURCES[route]
            for bucket, shapes in buckets():
                for b, h, sq, skv, d, calls in shapes:
                    q, k, v = (torch.randn(b, s, h * d, generator=gen,
                                           device="cuda").bfloat16()
                               .view(b, s, h, d).transpose(1, 2)
                               for s in (sq, skv, skv))
                    if flash.route_of(q, k, v) != route:
                        continue
                    row = {"route": route, "bucket": bucket,
                           "shape": [b, h, sq, skv, d],
                           "bound_ms": max(chip_smoke.bound_ms(
                               b, h, sq, skv, d, 2).values())}
                    _build._loaded[source] = libs[route, "intact"]
                    out = flash.flash_attention(q, k, v)
                    err = chip_smoke.kernel_error(torch, flash, q, k, v, out,
                                                  route)
                    row["intact_check"] = err
                    ok = ok and err["ok"]
                    row["sdpa_ms"] = chip_smoke.cuda_ms(
                        torch,
                        lambda: F.scaled_dot_product_attention(q, k, v), 10)
                    for yard in YARDSTICKS[route]:
                        row[f"{yard}_ms"] = chip_smoke.cuda_ms(
                            torch, lambda: flash.flash_attention(
                                q, k, v, kernel=yard), 10)
                    same = []
                    for name in ablations:
                        _build._loaded[source] = libs[route, name]
                        if torch.equal(out, flash.flash_attention(q, k, v)):
                            same.append(name)
                    row["bit_identical_to_intact"] = same
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
                    means = {name: statistics.fmean(row[f"{name}_ms"])
                             for name in ablations}
                    row["intact_bound_share"] = (row["bound_ms"]
                                                 / means["intact"])
                    total = totals.setdefault((route, bucket), {})
                    for name, ms in (*means.items(), ("bound", row["bound_ms"]),
                                     ("sdpa", row["sdpa_ms"]),
                                     *((y, row[f"{y}_ms"])
                                       for y in YARDSTICKS[route])):
                        total[name] = total.get(name, 0.0) + calls * ms
                    print(json.dumps(row), flush=True)
                    del q, k, v, out
                    torch.cuda.empty_cache()
            _build._loaded.pop(source, None)
    for (route, bucket), total in totals.items():
        print(json.dumps({"route": route, "bucket": bucket,
                          "ms_per_batch_or_chunk": total}), flush=True)
    print(f"intact builds within their bound at every shape: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
