#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (arbius_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card; it builds
everything it needs from the checkout's sources. Phases, each printing
its own lines with timings:

  1. setup: the card's name and power limit; build the flash-attention
     kernel (nvcc, csrc/flash_attn.cu) and the native PNG deflate (g++).
  2. kernels: the kernel against its plain PyTorch version run in
     float32 on the same inputs, at every shape the main path gives it,
     in bf16 and float32 (|out - ref| <= atol + rtol * |ref|, see TOL),
     bit-identical on relaunch; the kernel's time beside the plain
     version's, SDPA's (a yardstick the port never calls) and the least
     time the card could take.
  3. small reference: the tiny float32 config solved on the card and on
     the CPU from the same weights; uint8 pixels within one level.
  4. main path: anythingv3 at full width (seeded random weights) solves 6
     hydrated template tasks at 512x512, 20 steps, DPMSolverMultistep,
     canonical batch 4 (two chunks, the second padded); CIDv0s and
     32-byte commitments, finite non-constant images, and 641 kernel
     launches per chunk (16 transformers x 2 attentions x 20 steps + the
     VAE's one).
  5. determinism: a fresh pipeline solves the same tasks chunk by chunk
     with identical CIDs, and one task keeps its CID among different
     neighbours.

Any failed check raises and the exit code is not 0. The last lines are
the card, a `kernels` JSON line and `{"ok": true, "device": {...}}`.
Exits non-zero, printing no result, where CUDA is not available.
"""
from __future__ import annotations

import gc
import json
import statistics
import sys
import time

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 bandwidth
KV_TEXT = 77               # text tokens (cross-attention keys)
# (atol, rtol) of the kernel against the plain version in float32 on the
# same inputs. The kernel keeps scores and probabilities in float32, so in
# bf16 it is one rounding of the float32 result away (at most 2**-8 of the
# value) plus atol for float32 summation order; atol is under 1/200 of the
# output's RMS at the smallest-valued shapes (Skv = 4096, RMS ~0.026).
# float32 is tests/test_flash.py's 2e-5.
TOL = {"bfloat16": (1e-4, 2.0 ** -8), "float32": (2e-5, 2e-5)}
# (B, H, Sq, Skv, D, launches per 512x512 batch of 4): the UNet's 16
# transformers (5 at each of levels 0-2, 1 mid) x (self, cross) x 20
# steps at B = 4 x 2 (classifier-free guidance), and the VAE mid block
MAIN_PATH_SHAPES = (
    (8, 8, 4096, 4096, 40, 100), (8, 8, 4096, KV_TEXT, 40, 100),
    (8, 8, 1024, 1024, 80, 100), (8, 8, 1024, KV_TEXT, 80, 100),
    (8, 8, 256, 256, 160, 100), (8, 8, 256, KV_TEXT, 160, 100),
    (8, 8, 64, 64, 160, 20), (8, 8, 64, KV_TEXT, 160, 20),
    (4, 1, 4096, 4096, 512, 1),
)
LAUNCHES_PER_CHUNK = sum(s[-1] for s in MAIN_PATH_SHAPES)   # 641
STEPS, SIZE, SCHEDULER, CANONICAL_BATCH = 20, 512, "DPMSolverMultistep", 4
ADDRESS = "0x" + "5a" * 20   # the miner address committed to


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def cuda_ms(torch, fn, iters: int) -> float:
    """Mean device time of `fn` over `iters` launches, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_error(torch, flash, q, k, v, out) -> tuple[float, float, bool]:
    """(largest |out - ref|, RMS of ref, every element within TOL), with
    ref the plain version run in float32 on the same inputs q, k, v."""
    ref = flash.flash_attention_reference(q.float(), k.float(), v.float())
    diff = (out.float() - ref).abs()
    atol, rtol = TOL[str(q.dtype).split(".")[-1]]
    ok = bool((diff <= atol + rtol * ref.abs()).all())
    return diff.max().item(), ref.pow(2).mean().sqrt().item(), ok


def bound_ms(b, h, sq, skv, d, elem_bytes) -> tuple[float, float]:
    """(operations-bound ms, bytes-bound ms) of one attention call: q, k,
    v read once, o written once; 4*B*H*Sq*Skv*D operations."""
    ops = 4.0 * b * h * sq * skv * d
    nbytes = elem_bytes * b * h * d * (2 * sq + 2 * skv)
    return ops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3


def phase_kernels(torch, flash) -> dict:
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(0)
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
              "ops_ms": 0.0, "bytes_ms": 0.0, "bound_ms": 0.0}
    library_ok, max_err = True, 0.0
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for b, h, sq, skv, d, count in MAIN_PATH_SHAPES:
            q, k, v = (torch.randn(b, h, s, d, generator=gen, device="cuda")
                       .to(dtype) for s in (sq, skv, skv))
            out = flash.flash_attention(q, k, v)
            again = flash.flash_attention(q, k, v)
            err, rms, ok = kernel_error(torch, flash, q, k, v, out)
            max_err = max(max_err, err)
            check(ok, f"kernel != plain at {name} {(b, h, sq, skv, d)}: "
                  f"max error {err}, output RMS {rms}")
            check(torch.equal(out, again),
                  f"kernel not bit-identical on relaunch at {(b, h, sq, skv, d)}")
            line = {"dtype": name, "shape": [b, h, sq, skv, d],
                    "max_abs_err": err, "ref_rms": rms}
            if dtype == torch.bfloat16:
                iters = 5 if sq * skv >= 1 << 20 else 20
                ms = cuda_ms(torch, lambda: flash.flash_attention(q, k, v),
                             iters)
                plain_ms = cuda_ms(
                    torch, lambda: flash.flash_attention_reference(q, k, v),
                    iters)
                try:
                    lib_ms = cuda_ms(
                        torch,
                        lambda: F.scaled_dot_product_attention(q, k, v),
                        iters)
                except RuntimeError as exc:   # a yardstick, not the port
                    print(f"  sdpa unavailable at {(b, h, sq, skv, d)}: "
                          f"{exc}")
                    lib_ms, library_ok = None, False
                ops_ms, bytes_ms = bound_ms(b, h, sq, skv, d, 2)
                line.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                            bound_ms=max(ops_ms, bytes_ms),
                            bound_by="operations" if ops_ms >= bytes_ms
                            else "bytes", launches_per_batch=count)
                totals["ms"] += count * ms
                totals["plain_ms"] += count * plain_ms
                totals["library_ms"] += count * (lib_ms or 0.0)
                totals["ops_ms"] += count * ops_ms
                totals["bytes_ms"] += count * bytes_ms
                totals["bound_ms"] += count * max(ops_ms, bytes_ms)
            print("kernel " + json.dumps(line), flush=True)
            del q, k, v, out, again
        torch.cuda.empty_cache()
    totals["library_ms"] = totals["library_ms"] if library_ok else None
    totals["max_abs_err"] = max_err
    return totals


def phase_small_reference(torch) -> None:
    """Tiny float32 config on the card vs on the CPU, same weights."""
    import dataclasses

    from arbius_tpu_torch.models.sd15 import SD15Config, SD15Pipeline
    from arbius_tpu_torch.node.factory import tiny_byte_tokenizer

    tiny = SD15Config.tiny()
    cfg = SD15Config(*(dataclasses.replace(c, dtype="float32")
                       for c in (tiny.unet, tiny.vae, tiny.text)))
    pipes = [SD15Pipeline(cfg, tiny_byte_tokenizer(cfg.text), device=dev)
             for dev in ("cpu", "cuda")]
    params = pipes[0].init_params(seed=0)
    images = []
    for pipe in pipes:
        pipe.load_params(params)
        images.append(pipe.generate(
            ["a lighthouse", "b"], ["", "blurry"], [1, 2**40 + 3],
            width=64, height=64, num_inference_steps=2,
            scheduler=SCHEDULER, guidance_scale=[7.5, 3.0]).astype(int))
    diff = abs(images[0] - images[1])
    print(f"small reference: tiny f32 64x64 card vs CPU: max uint8 diff "
          f"{diff.max()}, differing fraction {(diff > 0).mean():.6f}",
          flush=True)
    check(diff.max() <= 1 and (diff > 0).mean() <= 0.01,
          "tiny card solve disagrees with the CPU solve")


def tasks(template, hydrate_input, taskid2seed) -> list[tuple[str, dict, int]]:
    out = []
    for i in range(6):
        taskid = "0x" + f"{0xA5A5 * (i + 1):x}".rjust(64, "7")
        raw = {"prompt": f"a lighthouse on a cliff at dusk, study {i}",
               "negative_prompt": "lowres, blurry",
               "width": SIZE, "height": SIZE,
               "num_inference_steps": STEPS, "scheduler": SCHEDULER,
               "guidance_scale": 7.5 + i}
        out.append((taskid, hydrate_input(raw, template),
                    taskid2seed(taskid)))
    return out


def watch_images(torch, model) -> list:
    """Record, on the card and without a sync, whether each decoded batch
    is finite and each image non-constant (a hook on the VAE)."""
    from arbius_tpu_torch.models.sd15 import decode_to_images

    flags = []

    def hook(_mod, _inp, pixels):
        u = decode_to_images(pixels).flatten(1)
        flags.append((torch.isfinite(pixels).all(),
                      (u.amax(1) > u.amin(1)).all()))

    model.runner.pipeline.models.vae.register_forward_hook(hook)
    return flags


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from arbius_tpu_torch.codecs import _native
    from arbius_tpu_torch.l0 import generate_commitment, taskid2seed
    from arbius_tpu_torch.node import build_anythingv3, solve_cid_batch
    from arbius_tpu_torch.ops import _build, flash
    from arbius_tpu_torch.templates import hydrate_input, load_template
    from arbius_tpu_torch.utils import card_info, setup_device

    # -- 1. setup -------------------------------------------------------
    setup_device("cuda")
    card = card_info()
    print(f"setup: card {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; devices {torch.cuda.device_count()}",
          flush=True)
    t0 = time.perf_counter()
    _build.load(flash.SOURCE, flash._declare)
    print(f"setup: built {flash.SOURCE} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for row in _build.build_report(flash.SOURCE).splitlines():
        if "registers" in row or "spill" in row:
            print("  ptxas" + row.split("ptxas", 1)[-1].strip())
    check(_native.deflate_fixed() is not None,
          "native deflate (csrc/codecs.cc) did not build")

    # -- 2. kernels -----------------------------------------------------
    t0 = time.perf_counter()
    k = phase_kernels(torch, flash)
    print(f"kernels: checked {2 * len(MAIN_PATH_SHAPES)} shape/dtype cases "
          f"in {time.perf_counter() - t0:.1f} s; per 512x512 batch "
          f"({LAUNCHES_PER_CHUNK} launches, bf16): kernel {k['ms']:.2f} ms, "
          f"plain {k['plain_ms']:.2f} ms, sdpa {k['library_ms']} ms, "
          f"bound {k['bound_ms']:.3f} ms", flush=True)

    # -- 3. small reference -----------------------------------------------
    phase_small_reference(torch)

    # -- 4. main path -----------------------------------------------------
    template = load_template("anythingv3")
    todo = tasks(template, hydrate_input, taskid2seed)
    items = [(h, s) for _, h, s in todo]
    t0 = time.perf_counter()
    model = build_anythingv3(tiny=False, device="cuda", seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in
                   model.runner.pipeline.models.parameters())
    print(f"main: built full-width anythingv3 ({n_params} parameters) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    flags = watch_images(torch, model)
    flash.flash_attention.launches = 0
    t0 = time.perf_counter()
    solved = solve_cid_batch(model, items, canonical_batch=CANONICAL_BATCH)
    wall = time.perf_counter() - t0
    launches = flash.flash_attention.launches
    n_chunks = -(-len(items) // CANONICAL_BATCH)
    cids = [cid for cid, _ in solved]
    print(f"main: solved {len(items)} tasks in {n_chunks} chunks in "
          f"{wall:.2f} s ({len(items) / wall * 3600:.1f} solutions/h on "
          f"{card}); kernel launches {launches}", flush=True)
    check(launches == LAUNCHES_PER_CHUNK * n_chunks,
          f"{launches} kernel launches, expected "
          f"{LAUNCHES_PER_CHUNK} x {n_chunks}")
    for (taskid, _, _), (cid, files) in zip(todo, solved):
        check(len(cid) == 2 + 68 and cid.startswith("0x1220")
              and int(cid, 16) > 0, f"bad CIDv0 {cid}")
        check(set(files) == {"out-1.png"}, f"unexpected files {set(files)}")
        check(len(generate_commitment(ADDRESS, taskid, cid)) == 32,
              "commitment is not 32 bytes")
    check(all(bool(f) and bool(c) for f, c in flags) and
          len(flags) == n_chunks, "non-finite or constant images")
    print("main: CIDs " + " ".join(cid[:18] + "…" for cid in cids))
    del model, flags
    gc.collect()
    torch.cuda.empty_cache()

    # -- 5. determinism ---------------------------------------------------
    fresh = build_anythingv3(tiny=False, device="cuda", seed=0)
    chunk_runs = [list(range(0, 4)), list(range(4, 6)), [2, 4, 0, 1]]
    latencies = []
    for idx in chunk_runs:
        flash.flash_attention.launches = 0
        t0 = time.perf_counter()
        again = solve_cid_batch(fresh, [items[i] for i in idx],
                                canonical_batch=CANONICAL_BATCH)
        latencies.append(time.perf_counter() - t0)
        check(flash.flash_attention.launches == LAUNCHES_PER_CHUNK,
              f"{flash.flash_attention.launches} launches in one chunk")
        for i, (cid, _) in zip(idx, again):
            check(cid == cids[i], f"task {i}: CID {cid} != {cids[i]} "
                  f"(chunk {idx})")
    p50 = statistics.median(latencies)
    print(f"determinism: fresh pipeline, chunks {chunk_runs}: CIDs "
          f"identical; per-batch latency s {[round(x, 3) for x in latencies]}"
          f", p50 {p50:.3f} s ({CANONICAL_BATCH * 3600 / p50:.1f} "
          f"solutions/h at full batches, {card}); the kernel's 641 calls "
          f"(phase 2 times) are {k['ms'] / 10 / p50:.1f}% of p50", flush=True)

    entry = {
        "name": "flash_attention", "route": "cuda",
        "source": "arbius_tpu_torch/csrc/flash_attn.cu",
        "replaces": "arbius_tpu/ops/flash.py:34",
        "launches": launches,
        "max_abs_err": k["max_abs_err"],
        # times: one 512x512 batch's 641 calls (bf16), summed over shapes
        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": "operations" if k["ops_ms"] >= k["bytes_ms"] else "bytes",
        "library_ms": k["library_ms"],
        # reached only if every check of phase 2 passed
        "check": {"cases": 2 * len(MAIN_PATH_SHAPES),
                  "against": "plain version in float32, same inputs",
                  "atol_rtol": TOL, "matches_plain": True,
                  "relaunch_identical": True},
    }
    print(card)
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
