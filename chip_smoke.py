#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (arbius_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card; it builds
everything it needs from the checkout's sources. Phases, each printing
its own lines with timings:

  1. setup: the card's name and power limit; build the six
     flash-attention kernels, the tensor-core routes (nvcc,
     csrc/flash_attn_wgmma.cu for the UNet's self-attentions over more
     than 128 keys, csrc/flash_attn_wgmma_short.cu for its attentions
     over at most 128 keys, csrc/flash_attn_wgmma_wide.cu for the VAE's
     D = 512, csrc/flash_attn_tc.cu (mma.sync) for other head dims and
     csrc/flash_attn_tc_wide.cu (mma.sync) at D = 512) and the CUDA-core
     route (nvcc, csrc/flash_attn.cu), and the native PNG deflate (g++),
     all at once; ptxas registers, spills and notes of serialised wgmma
     products per kernel (the wgmma kernels and the mma.sync wide one
     must not spill, the wgmma wide one must have no such note).
  2. kernels: each route against the plain PyTorch version run in
     float32 on the same inputs, at every shape the main path (512x512)
     and the template's default bucket (768x768) give it, and at the
     640x640 bucket's shapes whose lengths those two lack (1600^2 at
     D = 80, 400^2 and 100^2 at D = 160, and their cross-attentions),
     and the VAE's call at the buckets whose length those lack (S = 256
     at 128x128, 6400 at 640x640, 12288 at 1024x768 and 768x1024),
     kandinsky2's MoVQ call at 1024x1024 (S = 16384, B = 4, D = 512),
     and a text-to-video chunk's calls at damo's and zeroscopev2xl's
     default buckets (the UNet3D's D = 64 self- and cross-attentions,
     S = 1024 to 16 and 9216 to 144, and the VAE's over the frames):
     every route that takes the shape (`ops.flash.routes_of`): the
     rule's choice, and forced beside it the wgmma route at the short
     one's shapes, the mma.sync route at every UNet shape, the mma.sync
     wide route at the VAE's and the CUDA-core route at every shape in
     bf16 and in float32; per element
     within ops/flash.py's `error_bound` for that route, and
     bit-identical on relaunch. Each route's device time (a CUDA graph
     of its calls replayed between two events, `cuda_ms`) beside the
     plain version's, SDPA's (a yardstick the port never calls), the
     host's time to enqueue it (median and mean, `host_us`) and the
     least time the card could take (operations, bytes or
     exponentials).
  3. small reference: the tiny float32 config solved on the card and on
     the CPU from the same weights; uint8 pixels within one level.
  4. main path: anythingv3 at full width (seeded random weights) solves 6
     hydrated template tasks at 512x512, 20 steps, DPMSolverMultistep,
     canonical batch 4 (two chunks, the second padded); CIDv0s and
     32-byte commitments, finite non-constant images, and 641 kernel
     launches per chunk, per route as `expected_launches` derives them
     from ops/flash.py's rule (16 transformers x 2 attentions x 20 steps
     on the wgmma routes: 300 on the wgmma one, 340 on the short one;
     + the VAE's one on the wgmma wide route; none on mma.sync, its wide
     kernel or the CUDA cores).
  5. determinism: a fresh pipeline solves the same tasks chunk by chunk
     with identical CIDs and the same launches per route, and one task
     keeps its CID among different neighbours.
  5b. buckets: at 128x128, 640x640, 768x768, 1024x768 and 768x1024 (4
     steps) one task keeps its CID among different neighbours, each
     chunk launching each route as the rule says for that bucket.
  6. node: the port's miner node hosts anythingv3 at full width. The
     boot self-test golden (512x512, 20 steps, DPMSolverMultistep, seed
     1337, canonical batch 4, bf16 weights) is recorded with a fresh
     model through record-golden's function and must equal the committed
     arbius_tpu_torch/goldens/anythingv3.h100.bfloat16.json when the
     build (card, torch, CUDA, cuDNN) is the one it was recorded on; a
     MinerNode on an in-process chain (Engine + LocalChain) boots with
     it, passing the self-test on the card, mines phase 4's six tasks as
     on-chain tasks from TaskSubmitted through commit and reveal (641
     launches per chunk, per route as in phase 4), and claims them; each
     on-chain CID equals the fresh model's for the same hydrated input
     and taskid2seed(engine taskid) in another chunk grouping.
  7. node-run: the quickstart's two terminals. The port's DevnetNode
     serves a funded chain over HTTP on 127.0.0.1; `python -m
     arbius_tpu_torch.cli node-run` mines it as a separate process with
     MiningConfig.example.json's node settings (staged pipeline on,
     depth 2, 2 encode workers), booting with the committed golden
     (phase 6's where the build differs). Phase 4's six inputs go on
     chain as the user's signed transactions; the node commits and
     reveals them, the devnet's clock advances, the node claims them.
     Each revealed CID must equal phase 6's fresh model's direct solve,
     GET /metrics must show 6 solutions submitted, and the node's flash
     launches must be phase 4's per chunk, per route. Prints the host
     seconds from the first tick to the last reveal and claim, the
     stage seconds, the seconds per signed transaction and sol/h beside
     phases 4 and 6.
  8. kandinsky2: the reference miner's flagship template at full width
     (seeded random weights, bf16): six template inputs at 768x768 (50
     steps, DDIM, guidance 4.0) solved at canonical batch 4, with CIDv0s,
     commitments, finite non-constant images and one flash launch per
     chunk, on the wgmma wide route (MoVQ's mid attention); a fresh
     pipeline re-solves them in other chunks with the same CIDs, one
     chunk traced by torch.profiler (kernels per chunk, device busy and
     idle share); one task keeps its CID among different neighbours at
     1024x1024, 768x1024 and 1024x768 (4 steps); a MinerNode on
     LocalChain boots
     with arbius_tpu_torch/goldens/kandinsky2.h100.bfloat16.json where
     the build matches (re-recorded where it differs), passes its
     self-test, mines the six tasks through claim, and each on-chain CID
     equals the main path's. Prints sol/h, p50 per chunk, device seconds
     per stage (text + prior, decoder loop, MoVQ) and the host's PNG +
     CID seconds.
  9. text-to-video at full width (seeded random weights, bf16; the
     UNet3D, the 24-layer text tower, the SD VAE): the tiny float32
     config solved on the card and on the CPU with the temporal zero
     inits filled (uint8 within one level); damo's default task (16
     frames at 256x256, 50 steps, DDIM, guidance 9.0) for six template
     inputs at canonical batch 4, with CIDs of the MP4 bytes,
     commitments, finite frames none of them constant, and per chunk
     the flash launches `expected_launches` derives from
     `video_attention_shapes` (the D = 64 calls on the wgmma and short
     routes, none on mma.sync or the CUDA cores, the VAE's on the wgmma
     wide route); a fresh pipeline re-solves the tasks in other chunks
     with the same CIDs, one chunk traced by torch.profiler (kernels,
     busy and idle share); zeroscopev2xl's default bucket (24 frames at
     1024x576) at ZS_STEPS steps keeps one task's CID among different
     neighbours, printing the peak memory per stage; a MinerNode on
     LocalChain boots with arbius_tpu_torch/goldens/damo.h100.bfloat16
     .json where the build matches (re-recorded where it differs),
     passes its self-test, mines the six tasks through claim, and each
     on-chain CID equals the main path's. Prints sol/h, p50 per chunk,
     device seconds and peak memory per stage (text, denoise loop, VAE)
     and the host's H.264 + MP4 + CID seconds.

  10. textgen at full width (TextGenConfig(), 174,336 seeded parameters,
     bf16): the tiny float32 config on the card (CUDA graphs) and the CPU
     with identical token ids; each bucket of MiningConfig's default
     edges (prompt 32/64 x decode 16/32 x greedy/top-k, canonical batch
     4): the captured graph against the eager loop (identical ids, also
     after a replay with other prompts), p50 per chunk and tokens/s of
     both, device ms by CUDA events, launches per chunk and idle share
     from a traced chunk of each; prefix stability between decode 16 and
     32; six template tasks over four buckets solved one per chunk and
     by a fresh registry in other groupings with identical CIDs; a
     MinerNode on LocalChain boots with
     arbius_tpu_torch/goldens/textgen.h100.bfloat16.json where the build
     matches (re-recorded where it differs), mines the six and claims
     them, each on-chain CID the direct solve's.
  11. robust_video_matting at full width (RVMConfig(), 3,773,721 seeded
     parameters, bf16): the tiny float32 config on the card and the CPU
     (uint8 within one level, direct and refine paths); an avc1 clip of
     probe_clip(48, 1088, 1920) (a 1080p stream at the nearest size
     matte accepts, multiples of 16) through shrink and refine (base
     288x512) and a 16-frame 512x512 clip on the direct path: frames/s,
     device ms per frame, kernels per frame, idle share, peak GiB, the
     host's demux + decode and encode seconds, and the runner's bytes
     identical on a fresh model; a node with no content store boots
     with arbius_tpu_torch/goldens/robust_video_matting.h100.bfloat16
     .json (probe clip 8x128x128, MJPEG; re-recorded where the build
     differs), and a node with a store mines three tasks whose inputs
     are pinned to it (avc1 and MJPEG, all three output types, one
     through refine), each on-chain CID the direct solve's. Phases 10
     and 11 launch no flash kernel.
  12. precision modes (int8 and fp8: 1-byte weights with float32 scales
     per output channel, dequantized at the start of every bucket
     program): the tiny float32 config in int8 on the card and the CPU
     (uint8 within one level); for anythingv3 in int8 and fp8 (512x512,
     20 steps, DPMSolverMultistep), kandinsky2 (768x768, 50 steps), damo
     (16 frames at 256x256, 50 steps) and textgen in int8, a MinerNode
     on LocalChain booted with the committed
     arbius_tpu_torch/goldens/<template>.h100.<mode>.json (re-recorded
     into chiprun_out/goldens/ where the build differs) passes its
     self-test at the golden input
     and mines tasks through claim (anythingv3 six, kandinsky2 and damo
     four, textgen six), each chunk launching its bf16 twin's flash
     kernels, the cost model's rows and `arbius_precision_models`
     carrying the mode, no full-width weights left after a chunk; a
     fresh anythingv3 pipeline in each mode re-solves the six in other
     chunk groupings to the on-chain CIDs, each chunk beside bf16's (p50
     and sol/h per mode, paired); each mode's golden differs from bf16's
     at its input (textgen's samples top_k), and no two modes share an
     anythingv3 CID; per family
     and mode the resident weight GiB after the build and the peak over
     a PEAK_STEPS-step chunk (int8 resident below bf16's), and the
     dequantization's leaves, kernels and device ms.

Each phase prints its wall seconds. Any failed check raises and the exit
code is not 0. The last lines are the card, a `kernels` JSON line (with
each route's launches in phases 4, 6, 7, 8, 9, 10, 11 and 12) and
`{"ok": true, "device": {...}}`.
Exits non-zero, printing no result, where CUDA is not available.
"""
from __future__ import annotations

import concurrent.futures
import gc
import json
import pathlib
import statistics
import sys
import time

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 bandwidth
# The SFU's exp2: 16 per clock per SM against 4096 dense bf16 FLOP per
# clock per SM, so 3.87e12/s (132 SMs at the 1.83 GHz the bf16 peak
# implies); every score of an attention costs one
PEAK_EX2_PER_S = 16 * PEAK_BF16_FLOPS / 4096
KV_TEXT = 77               # text tokens (cross-attention keys)
# the UNet's transformers per latent level (1, 1/2, 1/4, 1/8 of the
# latent's side) and their head dim: 5 at each of levels 0-2 (two down,
# three up), 1 in the mid block; 8 heads each
UNET_LEVELS = ((40, 5), (80, 5), (160, 5), (160, 1))
STEPS, SIZE, SCHEDULER, CANONICAL_BATCH = 20, 512, "DPMSolverMultistep", 4


def attention_shapes(width: int, height: int, steps: int = STEPS,
                     batch: int = CANONICAL_BATCH) -> tuple:
    """(B, H, Sq, Skv, D, launches per batch) of every attention call of
    one canonical batch at `width` x `height`: each UNet transformer's
    self- and cross-attention (77 text keys) once per step at B = 2 x
    batch (classifier-free guidance), and the VAE mid block's one
    single-head attention at D = 512."""
    tokens = (width // 8) * (height // 8)
    out = []
    for level, (d, n) in enumerate(UNET_LEVELS):
        s = tokens // 4 ** level
        out += [(2 * batch, 8, s, s, d, n * steps),
                (2 * batch, 8, s, KV_TEXT, d, n * steps)]
    return (*out, (batch, 1, tokens, tokens, 512, 1))


# the main path's calls at 512x512, and the template default's
MAIN_PATH_SHAPES = attention_shapes(SIZE, SIZE)
BUCKET_768_SHAPES = attention_shapes(768, 768)
# the 640x640 bucket's D = 80 and D = 160 calls, whose lengths (1600,
# 400, 100) are not multiples of 128 as no length at 512 or 768 is
BUCKET_640_RAGGED_SHAPES = tuple(s for s in attention_shapes(640, 640)
                                 if 40 < s[4] < 512)
# the VAE's call (D = 512) at the buckets whose length 512x512 and 768x768
# lack: S = 256, 6400 and 12288 (768x1024's is 1024x768's)
VAE_BUCKET_SHAPES = tuple(next(s for s in attention_shapes(w, h)
                               if s[4] == 512)
                          for w, h in ((128, 128), (640, 640), (1024, 768)))
LAUNCHES_PER_CHUNK = sum(s[-1] for s in MAIN_PATH_SHAPES)   # 641
# the buckets the neighbour check covers beside 512x512: the template's
# smallest, one with lengths that are not multiples of 128, its default,
# and its two largest (non-square)
BUCKETS = ((128, 128), (640, 640), (768, 768), (1024, 768), (768, 1024))
# the routes of Hopper's warpgroup products (wgmma + TMA)
WGMMA_ROUTES = ("tensor_core_wgmma", "tensor_core_wgmma_short",
                "tensor_core_wgmma_wide")
BUCKET_STEPS = 4
ADDRESS = "0x" + "5a" * 20   # the miner address committed to
# the port's boot self-test vector, valid for the build it records
GOLDEN_FILE = "arbius_tpu_torch/goldens/anythingv3.h100.bfloat16.json"
GOLDEN_INPUT = {"prompt": "arbius test cat", "negative_prompt": "",
                "width": SIZE, "height": SIZE, "num_inference_steps": STEPS,
                "scheduler": SCHEDULER}
GOLDEN_SEED = 1337
BUILD_FIELDS = ("card", "torch", "cuda", "cudnn")
TASK_FEE = 10           # AIUS per on-chain task of phase 6
# phase 8, kandinsky2: the template's default bucket at the runner's
# defaults (50 steps, DDIM, guidance 4.0), and the buckets of the
# neighbour check beside it (at K2_BUCKET_STEPS)
K2_SIZE = 768
K2_BUCKETS = ((1024, 1024), (768, 1024), (1024, 768))
K2_BUCKET_STEPS = 4
K2_GOLDEN_FILE = "arbius_tpu_torch/goldens/kandinsky2.h100.bfloat16.json"
K2_GOLDEN_INPUT = {"prompt": "arbius test cat", "width": K2_SIZE,
                   "height": K2_SIZE}


# phase 9, text-to-video: damo's default task (the template's 16 frames
# and 50 steps, the runner's 256x256, guidance 9.0, DDIM) is the main
# path; zeroscopev2xl's template default (24 frames at 1024x576) is the
# second bucket, solved at ZS_STEPS
VIDEO_FRAMES, VIDEO_SIZE, VIDEO_STEPS = 16, 256, 50
ZS_FRAMES, ZS_WIDTH, ZS_HEIGHT, ZS_STEPS = 24, 1024, 576, 2
VIDEO_GOLDEN_FILE = "arbius_tpu_torch/goldens/damo.h100.bfloat16.json"
VIDEO_GOLDEN_INPUT = {"prompt": "arbius test cat"}
# the UNet3D's spatial transformers per latent level, as UNET_LEVELS:
# (channels, transformers); head dim 64, so channels / 64 heads
UNET3D_LEVELS = ((320, 5), (640, 5), (1280, 5), (1280, 1))


def video_attention_shapes(width: int, height: int, frames: int,
                           steps: int, batch: int = CANONICAL_BATCH
                           ) -> tuple:
    """(B, H, Sq, Skv, D, launches per chunk) of every flash call of one
    text-to-video chunk at `width` x `height` x `frames`: each UNet3D
    spatial transformer's self- and cross-attention (77 text keys) once
    per step over the 2 x batch x frames maps of the guidance batch, and
    the VAE mid block's single-head D = 512 attention over the
    batch x frames frames in `vae_frames_per_call` groups. The temporal
    attentions are plain torch, as in the reference: none reaches
    ops/flash."""
    from arbius_tpu_torch.models.video import vae_frames_per_call

    tokens = (width // 8) * (height // 8)
    out = []
    for level, (ch, n) in enumerate(UNET3D_LEVELS):
        s = tokens // 4 ** level
        b = 2 * batch * frames
        out += [(b, ch // 64, s, s, 64, n * steps),
                (b, ch // 64, s, KV_TEXT, 64, n * steps)]
    per = vae_frames_per_call(height, width)
    full, rest = divmod(batch * frames, per)
    if full:
        out.append((per, 1, tokens, tokens, 512, full))
    if rest:
        out.append((rest, 1, tokens, tokens, 512, 1))
    return tuple(out)


DAMO_SHAPES = video_attention_shapes(VIDEO_SIZE, VIDEO_SIZE, VIDEO_FRAMES,
                                     VIDEO_STEPS)
# zeroscopev2xl's default bucket at its template's 50 steps (phase 2's
# times per chunk); phase 9 runs it at ZS_STEPS
ZEROSCOPE_SHAPES = video_attention_shapes(ZS_WIDTH, ZS_HEIGHT, ZS_FRAMES,
                                          50)


def movq_attention_shapes(width: int, height: int,
                          batch: int = CANONICAL_BATCH) -> tuple:
    """(B, H, Sq, Skv, D, launches per chunk) of kandinsky2's flash
    calls at `width` x `height`: MoVQ's mid-block attention, one head of
    D = 512 over the latent's tokens, once per chunk. The prior's and the
    text tower's attentions take a mask and the decoder's added-KV
    attention is a matmul, as in the reference: none reaches ops/flash."""
    tokens = (width // 8) * (height // 8)
    return ((batch, 1, tokens, tokens, 512, 1),)


def expected_launches(torch, flash, shapes=MAIN_PATH_SHAPES
                      ) -> dict[str, int]:
    """Launches per route for one chunk (512x512 unless `shapes` names
    another bucket's): ops/flash.py's `route` applied to each shape in
    bf16, with the strides of the models' q/k/v views ([B, S, H*D]
    viewed as [B, H, S, D]) and 16-byte aligned data."""
    out = dict.fromkeys(flash.SOURCES, 0)
    for b, h, sq, skv, d, count in shapes:
        strides = [st for s in (sq, skv, skv) for st in (s * h * d, d, h * d)]
        out[flash.route(torch.bfloat16, d, strides, [0, 0, 0], sq,
                        skv)] += count
    return out


def serialisation_notes(report: str) -> dict[str, list[str]]:
    """ptxas's notes C7510-C7520 (wgmma products serialised) in a build
    report, by the template arguments of the kernel each names (`<64>`,
    `<64,128>`; `<?>` where the name carries none)."""
    import re

    out: dict[str, list[str]] = {}
    for line in report.splitlines():
        code = re.search(r"\((C75\d\d)\)", line)
        if code is None:
            continue
        args = re.findall(r"ILi(\d+)E(?:Li(\d+)E)?", line)
        key = "<" + ",".join(a for a in args[0] if a) + ">" if args else "<?>"
        out.setdefault(key, [])
        if code.group(1) not in out[key]:
            out[key].append(code.group(1))
    return out


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def cuda_ms(torch, fn, iters: int) -> float:
    """Mean device time of one call of `fn`: after a warm-up call,
    `iters` calls are captured in one CUDA graph (on a side stream, as
    torch.cuda.graph does; the kernels' ctypes launches go to
    torch.cuda.current_stream() and are captured like any other), and
    one replay of the graph is timed between two CUDA events. So the
    host's enqueue of each call is not in the time, as it was when the
    events bracketed a Python loop of launches (which measured the host
    wherever it was slower than the card)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()   # builds, loads and sets up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def host_us(torch, fn, calls: int = 50) -> dict[str, float]:
    """Host time, in microseconds, to enqueue one call of `fn` (the
    wrapper's own work and the launch; the card runs behind it), over
    `calls` calls timed one by one: the median (`host_us`), the typical
    call, and the mean (`host_mean_us`, the total over the calls
    divided by them), which keeps the host's pauses (the garbage
    collector, a page fault) that a batch of calls pays too."""
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return {"host_us": statistics.median(times) * 1e6,
            "host_mean_us": statistics.fmean(times) * 1e6}


def kernel_error(torch, flash, q, k, v, out, route,
                 max_bytes: int = 1 << 30) -> dict:
    """`route`'s output `out` against ref, the plain version run in
    float32 on the same inputs q, k, v: the largest |out - ref|, the RMS
    of ref, the largest ratio of |out - ref| to ops/flash.py's
    `error_bound` for `route`, and whether every element is within it.
    Both are computed over slices of B x H whose float32 scores take at
    most `max_bytes` (one batch entry and at least one head each), so
    S = 9216 fits on the card: the function and the bound are those of
    the whole call, only the peak memory differs."""
    b, h, sq, _ = q.shape
    heads = max(1, min(h, max_bytes // (4 * sq * k.shape[2])))
    worst = ratio_max = sumsq = 0.0
    ok = True
    for i in range(b):
        for j in range(0, h, heads):
            part = (slice(i, i + 1), slice(j, j + heads))
            qs, ks, vs = q[part], k[part], v[part]
            ref = flash.flash_attention_reference(qs.float(), ks.float(),
                                                  vs.float())
            err = (out[part].float() - ref).abs()
            ratio = err / flash.error_bound(qs, ks, vs, route)
            worst = max(worst, err.max().item())
            ratio_max = max(ratio_max, ratio.max().item())
            sumsq += ref.double().pow(2).sum().item()
            ok = ok and bool((ratio <= 1).all())
            del ref, err, ratio
    return {"max_abs_err": worst,
            "ref_rms": (sumsq / out.numel()) ** 0.5,
            "err_over_bound": ratio_max, "ok": ok}


def bound_ms(b, h, sq, skv, d, elem_bytes) -> dict[str, float]:
    """The least time, in ms, one attention call could take, by each of
    three limits: operations (4*B*H*Sq*Skv*D at the bf16 tensor-core
    peak), bytes (q, k, v read once, o written once, at the HBM rate)
    and exponentials (one exp2 per score, B*H*Sq*Skv, at the SFU's
    rate). The bound is the largest."""
    return {"operations": 4.0 * b * h * sq * skv * d / PEAK_BF16_FLOPS * 1e3,
            "bytes": elem_bytes * b * h * d * (2 * sq + 2 * skv)
            / PEAK_BYTES * 1e3,
            "exponentials": float(b * h * sq * skv) / PEAK_EX2_PER_S * 1e3}


_LIMITS = ("operations", "bytes", "exponentials")
_SUMMED = ("ms", "host_us", "host_mean_us", "plain_ms", "library_ms",
           *_LIMITS)
PLAIN_SLICE_BYTES = 4 << 30   # float32 scores per timed plain call


def _check_shape(torch, flash, gen, dtype, shape, bucket) -> list[dict]:
    """One main-path shape in `dtype`: every route that takes it
    (`ops.flash.routes_of`, the rule's choice first) checked against
    the plain version, and in bf16 each one's time beside the plain
    version's, SDPA's and the bound, so that the rule's choice and the
    routes it passed over are timed in one run."""
    import torch.nn.functional as F

    b, h, sq, skv, d, count = shape
    name = str(dtype).split(".")[-1]
    q, k, v = (torch.randn(b, h, s, d, generator=gen, device="cuda")
               .to(dtype) for s in (sq, skv, skv))
    routes = flash.routes_of(q, k, v)
    main = routes[0]
    # zeroscopev2xl's 9216^2 calls: ~2 s each on the CUDA cores
    huge = b * h * sq * skv >= 1 << 34
    iters = 2 if huge else 5 if sq * skv >= 1 << 20 else 20
    plain_ms = lib_ms = None
    if dtype == torch.bfloat16:
        # the plain version over slices of the batch where its scores
        # would not fit beside the rest (S = 9216: 2.7 GB per entry)
        per = max(1, PLAIN_SLICE_BYTES // (4 * h * sq * skv))
        plain_ms = cuda_ms(torch, lambda: [
            flash.flash_attention_reference(q[i:i + per], k[i:i + per],
                                            v[i:i + per])
            for i in range(0, b, per)], iters)
        try:
            lib_ms = cuda_ms(
                torch, lambda: F.scaled_dot_product_attention(q, k, v),
                iters)
        except RuntimeError as exc:   # a yardstick, not the port
            print(f"  sdpa unavailable at {shape[:5]}: {exc}")
    limits = bound_ms(b, h, sq, skv, d, 2)
    lines = []
    for route in routes:
        got = flash.flash_attention(q, k, v, kernel=route)
        again = flash.flash_attention(q, k, v, kernel=route)
        err = kernel_error(torch, flash, q, k, v, got, route)
        check(err["ok"], f"{route} kernel != plain at {bucket} {name} "
              f"{shape[:5]}: {err}")
        check(torch.equal(got, again), f"{route} kernel not bit-identical "
              f"on relaunch at {bucket} {shape[:5]}")
        del got, again
        line = {"route": route, "bucket": bucket, "dtype": name,
                "shape": list(shape[:5]), "main_path": route == main, **err}
        if dtype == torch.bfloat16:
            ms = cuda_ms(torch, lambda: flash.flash_attention(
                q, k, v, kernel=route), iters)
            enqueue = host_us(
                torch, lambda: flash.flash_attention(q, k, v, kernel=route),
                calls=5 if huge else 50)
            line.update(ms=ms, **enqueue, plain_ms=plain_ms,
                        library_ms=lib_ms, bound_ms=max(limits.values()),
                        bound_by=max(limits, key=limits.get),
                        launches_per_batch=count)
            if lib_ms is not None:
                line["vs_sdpa"] = ms / lib_ms
        print("kernel " + json.dumps(line), flush=True)
        lines.append({**line, **limits})
    return lines


def per_route(lines) -> dict:
    """Per route, the check's worst case and times summed over one
    batch's calls (ms, the host's median and mean, plain_ms, library_ms,
    the bound's three limits): over the calls the bucket sends to the
    route (launches_per_batch of them), or, for a route the bucket does
    not launch, over its calls at every bf16 shape the route was checked
    at, as if they were forced onto it. `timed_at` lists those shapes
    with their calls per batch. `forced` gives, for a route the bucket
    launches, each other route timed at all of its shapes, forced onto
    the same calls: ms, host_ms and host_mean_ms. Routes come in the
    order of `lines`; a figure a line lacks counts as 0."""
    routes = list(dict.fromkeys(ln["route"] for ln in lines))
    out = {}
    for route in routes:
        mine = [ln for ln in lines if ln["route"] == route]
        if not mine:
            continue
        timed = [ln for ln in mine if "ms" in ln]
        on_path = [ln for ln in timed if ln["main_path"]]
        timed = on_path or timed
        tot = {key: sum(ln["launches_per_batch"] * (ln.get(key) or 0.0)
                        for ln in timed) for key in _SUMMED}
        tot["host_ms"] = tot.pop("host_us") / 1e3
        tot["host_mean_ms"] = tot.pop("host_mean_us") / 1e3
        if any(ln["library_ms"] is None for ln in timed):
            tot["library_ms"] = None
        forced = {}
        for other in routes:
            alt = {tuple(ln["shape"]): ln for ln in lines
                   if ln["route"] == other and "ms" in ln}
            if other != route and on_path and all(
                    tuple(ln["shape"]) in alt for ln in on_path):
                forced[other] = {
                    name: sum(ln["launches_per_batch"]
                              * (alt[tuple(ln["shape"])].get(key) or 0.0)
                              for ln in on_path) / scale
                    for name, key, scale in (
                        ("ms", "ms", 1), ("host_ms", "host_us", 1e3),
                        ("host_mean_ms", "host_mean_us", 1e3))}
        out[route] = {
            **tot, "bound_ms": max(tot[key] for key in _LIMITS),
            "bound_by": max(_LIMITS, key=tot.get), "cases": len(mine),
            "launches_per_batch": sum(ln["launches_per_batch"]
                                      for ln in on_path),
            "timed_at": [ln["shape"] + [ln["launches_per_batch"]]
                         for ln in timed], "forced": forced,
            "max_abs_err": max(ln["max_abs_err"] for ln in mine),
            "err_over_bound": max(ln["err_over_bound"] for ln in mine)}
    return out


def kernel_buckets() -> tuple:
    """Phase 2's (bucket, shapes) sets: the main path (512x512), the
    template's default bucket (768x768), the 640x640 bucket's ragged
    UNet shapes, the VAE's call at each length those lack, kandinsky2's
    MoVQ call at 1024x1024 (S = 16384; its 768x768 and 768x1024 calls
    are the VAE's S = 9216 and 12288), and the text-to-video chunks at
    damo's and zeroscopev2xl's default buckets (the UNet3D's D = 64
    calls and the VAE's over the frames)."""
    return (("512x512", MAIN_PATH_SHAPES), ("768x768", BUCKET_768_SHAPES),
            ("640x640", BUCKET_640_RAGGED_SHAPES),
            *((f"VAE S={s[2]}", (s,)) for s in VAE_BUCKET_SHAPES),
            ("MoVQ S=16384", movq_attention_shapes(1024, 1024)),
            ("damo 256x256x16", DAMO_SHAPES),
            ("zeroscopev2xl 1024x576x24", ZEROSCOPE_SHAPES))


def phase_kernels(torch, flash) -> dict:
    """Check every route at every shape of `kernel_buckets`, in bf16 and
    float32, and time the bf16 cases. Returns, per bucket, `per_route`'s
    summary (at 640x640 over its ragged shapes only)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for bucket, shapes in kernel_buckets():
        lines = []
        for dtype in (torch.bfloat16, torch.float32):
            for shape in shapes:
                lines += _check_shape(torch, flash, gen, dtype, shape,
                                      bucket)
                torch.cuda.empty_cache()
        out[bucket] = per_route(lines)
    return out


def kernel_entries(flash, buckets: dict, launches: dict) -> list[dict]:
    """The `kernels` line: per route, phase 2's summaries (`buckets`, as
    `phase_kernels` returns them; times per 512x512 batch, and per batch
    of each other bucket timed) beside `launches`, each a name mapped to
    the route's launch counts of one run (phases 4, 6, 7, 8, 9, 10, 11
    and 12; 10 and 11 launch none)."""
    tc_bound = "1e-4 + 2^-8 (|ref| + P|V|) in bf16"
    names = {"cuda_core": "flash_attention",
             "tensor_core": "flash_attention_tc",
             "tensor_core_wide": "flash_attention_tc_wide",
             "tensor_core_wgmma": "flash_attention_wgmma",
             "tensor_core_wgmma_short": "flash_attention_wgmma_short",
             "tensor_core_wgmma_wide": "flash_attention_wgmma_wide"}
    summary = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
               "host_ms", "host_mean_ms", "launches_per_batch", "timed_at",
               "forced")
    entries = []
    for route in flash.SOURCES:
        t = buckets["512x512"][route]
        mine = {name: b[route] for name, b in buckets.items() if route in b}
        entry = {
            "name": names[route], "route": "cuda",
            "source": f"arbius_tpu_torch/csrc/{flash.SOURCES[route]}",
            "replaces": "arbius_tpu/ops/flash.py:34",
            **{name: counts[route] for name, counts in launches.items()},
            "max_abs_err": max(x["max_abs_err"] for x in mine.values()),
            # times: one 512x512 batch's calls (bf16) at timed_at,
            # summed; see per_route
            **{key: t[key] for key in summary},
            # the same at the other buckets the route was timed at
            **{f"bucket_{name}": {key: x[key] for key in summary}
               for name, x in mine.items()
               if name not in ("512x512", "640x640")},
            # reached only if every check of phase 2 passed
            "check": {"cases": sum(x["cases"] for x in mine.values()),
                      "buckets": [name if name != "640x640" else
                                  "640x640 (1600^2, 400^2, 100^2 and "
                                  "their cross-attentions)" for name in mine],
                      "against": "plain version in float32, same inputs",
                      "bound": tc_bound if route != "cuda_core" else
                      "1e-4 + 2^-8 |ref| in bf16, 2e-5 + 2e-5 |ref| in "
                      "float32",
                      "worst_err_over_bound": max(
                          x["err_over_bound"] for x in mine.values()),
                      "matches_plain": True, "relaunch_identical": True},
        }
        entries.append(entry)
    return entries


def phase_small_reference(torch, precision: str = "bf16") -> None:
    """Tiny float32 config on the card vs on the CPU, same weights, in
    `precision` (int8 and fp8 quantize them on each device at load)."""
    import dataclasses

    from arbius_tpu_torch.models.sd15 import SD15Config, SD15Pipeline
    from arbius_tpu_torch.node.factory import tiny_byte_tokenizer

    tiny = SD15Config.tiny()
    cfg = SD15Config(*(dataclasses.replace(c, dtype="float32")
                       for c in (tiny.unet, tiny.vae, tiny.text)))
    pipes = [SD15Pipeline(cfg, tiny_byte_tokenizer(cfg.text), device=dev,
                          precision=precision)
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
    print(f"small reference: tiny f32 64x64 ({precision} mode) card vs "
          f"CPU: max uint8 diff {diff.max()}, differing fraction "
          f"{(diff > 0).mean():.6f}", flush=True)
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


def phase_buckets(torch, flash, model, template, hydrate_input,
                  taskid2seed) -> None:
    """Phase 5b: the buckets beside 512x512 that the node mines. At each
    of BUCKETS one hydrated task is solved in two canonical chunks with
    different neighbours (first of four, then second of three, padded)
    and must keep its CID; each chunk launches each route as often as
    `expected_launches` derives from ops/flash.py's rule at that bucket.
    BUCKET_STEPS (4) inference steps keep the phase short: batch-position
    invariance is a property of each operation, and every step runs the
    same operations, so the step count does not change what is checked."""
    from arbius_tpu_torch.node import solve_cid_batch

    t_all = time.perf_counter()
    for width, height in BUCKETS:
        items = []
        for i in range(6):
            taskid = "0x" + f"{0x5A5A * (i + 3) + width:x}".rjust(64, "3")
            raw = {"prompt": f"a harbour at dawn, bucket study {i}",
                   "negative_prompt": "lowres", "width": width,
                   "height": height, "num_inference_steps": BUCKET_STEPS,
                   "scheduler": SCHEDULER, "guidance_scale": 6.0 + i}
            items.append((hydrate_input(raw, template), taskid2seed(taskid)))
        want = expected_launches(torch, flash, attention_shapes(
            width, height, steps=BUCKET_STEPS))
        t0 = time.perf_counter()
        cids = []
        for chunk in ([0, 1, 2, 3], [4, 0, 5]):
            flash.reset_launches()
            solved = solve_cid_batch(model, [items[i] for i in chunk],
                                     canonical_batch=CANONICAL_BATCH)
            got = dict(flash.flash_attention.launches_by_route)
            check(got == want, f"{width}x{height}: launches {got} in one "
                  f"chunk, expected {want}")
            for cid, _ in solved:
                check(len(cid) == 2 + 68 and cid.startswith("0x1220"),
                      f"{width}x{height}: bad CIDv0 {cid}")
            cids.append(solved[chunk.index(0)][0])
        check(cids[0] == cids[1], f"{width}x{height}: task 0's CID "
              f"{cids[0]} among neighbours 1-3, {cids[1]} among 4 and 5")
        print(f"buckets: {width}x{height}, {BUCKET_STEPS} steps: task 0 "
              f"keeps CID {cids[0]} among different neighbours; launches "
              f"per chunk {want}; {time.perf_counter() - t0:.1f} s",
              flush=True)
    print(f"buckets: {len(BUCKETS)} buckets in "
          f"{time.perf_counter() - t_all:.1f} s", flush=True)


def phase_node(torch, flash, expected, todo, main_wall) -> dict:
    """Phase 6: record the golden, boot a MinerNode on an in-process
    chain with it, mine `todo`'s inputs as on-chain tasks, claim them.
    Returns the launches per route of the mining run."""
    from arbius_tpu_torch.chain import WAD, Engine, TokenLedger
    from arbius_tpu_torch.cli import record_golden
    from arbius_tpu_torch.l0 import taskid2seed
    from arbius_tpu_torch.node import (
        LocalChain,
        MinerNode,
        MiningConfig,
        ModelConfig,
        build_registry,
        solve_cid_batch,
    )

    def config(mid, golden=None):
        return MiningConfig(canonical_batch=CANONICAL_BATCH, models=(
            ModelConfig(id=mid, template="anythingv3",
                        weights_dtype="bfloat16", golden=golden),))

    # -- record: the golden with a fresh full-width model ------------------
    rec_id = "0x" + "00" * 32
    fresh = build_registry(config(rec_id), device="cuda").get(rec_id)
    rec = record_golden(fresh, GOLDEN_INPUT, GOLDEN_SEED,
                        canonical_batch=CANONICAL_BATCH, device="cuda")
    committed = json.loads(
        (pathlib.Path(__file__).resolve().parent / GOLDEN_FILE).read_text())
    build = {k: rec["build"].get(k) for k in BUILD_FIELDS}
    built = {k: committed["build"].get(k) for k in BUILD_FIELDS}
    print(f"node: golden {rec['golden']['cid']} in {rec['elapsed_s']} s "
          f"(build {json.dumps(rec['build'])})", flush=True)
    if build == built:
        check(rec["golden"] == committed["golden"],
              f"golden {rec['golden']} != committed {committed['golden']}")
        print(f"node: golden equals {GOLDEN_FILE}", flush=True)
    else:
        print(f"node: this build {build} is not the build {built} of "
              f"{GOLDEN_FILE}; its CID is not compared", flush=True)

    # -- world: engine, token, the miner's chain view and stake -------------
    miner, user = "0x" + "aa" * 20, "0x" + "01" * 20
    tok = TokenLedger()
    eng = Engine(tok, start_time=0)
    tok.mint(Engine.ADDRESS, 600_000 * WAD)
    for a in (miner, user):
        tok.mint(a, 1000 * WAD)
        tok.approve(a, Engine.ADDRESS, 10**30)
    mid_b = eng.register_model(user, user, 0,
                               b'{"meta":{"title":"anythingv3"}}')
    mid = "0x" + mid_b.hex()
    chain = LocalChain(eng, miner)
    chain.validator_deposit(100 * WAD)

    # -- boot: registry on the card, the self-test at the main path's shape
    cfg = config(mid, rec["golden"])
    t0 = time.perf_counter()
    registry = build_registry(cfg, device="cuda")
    node = MinerNode(chain, cfg, registry)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    node.boot()
    boot_s = time.perf_counter() - t1
    print(f"node: registry built in {t1 - t0:.1f} s; booted with the "
          f"self-test passing in {boot_s:.2f} s", flush=True)
    flags = watch_images(torch, registry.get(mid))

    # -- mine: TaskSubmitted -> solve -> commit -> reveal ----------------------
    tids = ["0x" + eng.submit_task(
        user, 0, user, mid_b, TASK_FEE * WAD,
        json.dumps(h, sort_keys=True).encode()).hex() for _, h, _ in todo]
    flash.reset_launches()
    t0 = time.perf_counter()
    while node.tick():
        pass
    mine_s = time.perf_counter() - t0
    launches = dict(flash.flash_attention.launches_by_route)
    n_chunks = -(-len(todo) // CANONICAL_BATCH)
    check(node.db.failed_jobs() == [],
          f"failed jobs {node.db.failed_jobs()}")
    check(launches == {r: n * n_chunks for r, n in expected.items()},
          f"node kernel launches {launches}, expected {expected} x "
          f"{n_chunks}")
    check(len(flags) == n_chunks and all(bool(f) and bool(c)
                                         for f, c in flags),
          "node: non-finite or constant images")
    onchain = []
    for tid in tids:
        sol = eng.solutions.get(bytes.fromhex(tid[2:]))
        check(sol is not None and sol.validator == miner,
              f"task {tid} not solved by the miner: {sol}")
        cid = "0x" + sol.cid.hex()
        check(chain.generate_commitment(tid, cid) in eng.commitments,
              f"task {tid}: no commitment matching {cid}")
        onchain.append(cid)
    print("node: on-chain CIDs " + " ".join(onchain), flush=True)

    # the fresh model, in another chunk grouping, on the engine's seeds
    items = [(h, taskid2seed(tid)) for (_, h, _), tid in zip(todo, tids)]
    order = [5, 4, 3, 2, 1, 0]
    t0 = time.perf_counter()
    again = solve_cid_batch(fresh, [items[i] for i in order],
                            canonical_batch=CANONICAL_BATCH)
    direct_s = time.perf_counter() - t0
    for i, (cid, _) in zip(order, again):
        check(cid == onchain[i], f"task {tids[i]}: on-chain {onchain[i]} "
              f"!= fresh model {cid}")

    # -- claim -----------------------------------------------------------
    bal0 = tok.balance_of(miner)
    eng.advance_time(eng.min_claim_solution_time
                     + cfg.claim_delay_buffer + 1)
    while node.tick():
        pass
    rise = tok.balance_of(miner) - bal0
    want = len(tids) * TASK_FEE * WAD * 9 // 10   # the treasury keeps 10%
    check(node.metrics.solutions_claimed == len(tids)
          and all(eng.solutions[bytes.fromhex(t[2:])].claimed for t in tids),
          f"claimed {node.metrics.solutions_claimed} of {len(tids)}")
    check(rise == want, f"miner balance rose {rise}, expected {want}")

    stages = node.metrics.stage_seconds
    infer, commit = sum(stages["infer"]), sum(stages["commit"])
    card = rec["build"]["card"] + ", " + rec["build"]["power_limit"]
    node_sol_h = CANONICAL_BATCH * n_chunks * 3600 / infer
    print(f"node: mined {len(tids)} tasks in {n_chunks} chunks, "
          f"{mine_s:.2f} s host time from the first tick to the last "
          f"reveal; infer {infer:.3f} s, commit {commit:.4f} s "
          f"(arbius_stage_seconds sums); "
          f"{node_sol_h:.1f} sol/h at full "
          f"batches (phase 4: "
          f"{CANONICAL_BATCH * n_chunks * 3600 / main_wall:.1f}, the fresh "
          f"model's solve_cid_batch of the same tasks here "
          f"{CANONICAL_BATCH * n_chunks * 3600 / direct_s:.1f}); claimed "
          f"{len(tids)}, +{rise / WAD:g} AIUS; {card}", flush=True)
    node.close()
    # phase 7 boots from the committed golden where this is its build,
    # else from the one recorded above
    return {"launches": launches, "fresh": fresh, "sol_h": node_sol_h,
            "golden": (committed if build == built else rec)["golden"],
            "golden_source": GOLDEN_FILE if build == built else
            "re-recorded in phase 6 (another build)"}


def phase_node_run(torch, flash, expected, todo, fresh, golden,
                   golden_source: str, sol_h: dict) -> dict:
    """Phase 7: `node-run` as its own process against the port's devnet
    on localhost (`node_run_world`), mining `todo`'s inputs with the
    staged pipeline on, booting with `golden`. Each revealed CID must
    equal `fresh`'s direct solve of (input, taskid2seed(taskid)); the
    node's flash launches while mining must be phase 4's per chunk, per
    route, and its boot self-test's those of one chunk. Returns the
    mining launches."""
    import tempfile

    from arbius_tpu_torch.l0 import taskid2seed
    from arbius_tpu_torch.node import solve_cid_batch
    from arbius_tpu_torch.utils import card_info

    inputs = [h for _, h, _ in todo]
    with tempfile.TemporaryDirectory() as work:
        got = node_run_world(inputs, device="cuda", tiny=False,
                             golden=golden, workdir=work)
    summary, metrics = got["summary"], got["metrics"]
    submitted = _metric_sum(metrics, "arbius_solutions_submitted_total")
    check(submitted == len(inputs), f"GET /metrics shows "
          f"arbius_solutions_submitted_total {submitted}")
    check(summary["solutions_claimed"] == len(inputs)
          and summary["failed_jobs"] == 0, f"node-run summary {summary}")
    n_chunks = -(-len(inputs) // CANONICAL_BATCH)
    launches, boot = summary["flash_launches"], summary["flash_launches_boot"]
    check(boot == expected, f"node-run self-test launches {boot}, "
          f"expected one chunk's {expected}")
    check(launches == {r: n * n_chunks for r, n in expected.items()},
          f"node-run mining launches {launches}, expected {expected} x "
          f"{n_chunks} chunks")
    items = [(h, taskid2seed(tid)) for h, tid in zip(inputs, got["tids"])]
    direct = [cid for cid, _ in solve_cid_batch(
        fresh, items, canonical_batch=CANONICAL_BATCH)]
    for tid, cid, want in zip(got["tids"], got["cids"], direct):
        check(cid == want, f"task {tid}: revealed {cid} != direct {want}")
    print("node-run: revealed CIDs " + " ".join(got["cids"])
          + " equal the direct solve's; self-test passed with golden "
          + golden["cid"] + f" ({golden_source}); flash launches per "
          f"route, self-test {boot}, mining {launches}", flush=True)

    stage = {s: _metric_sum(metrics, "arbius_stage_seconds_sum", stage=s)
             for s in ("infer", "commit")}
    pipe = {s: _metric_sum(metrics, "arbius_pipeline_stage_seconds_sum",
                           stage=s) for s in ("device", "encode", "network")}
    sign = sign_seconds()
    n = len(inputs)
    sol_h = {**sol_h,
             "node-run, first tick to last reveal":
                 n * 3600 / got["to_last_reveal_s"],
             "node-run, infer at full batches":
                 CANONICAL_BATCH * n_chunks * 3600 / stage["infer"]}
    print(f"node-run: {n} tasks mined and claimed over JSON-RPC in "
          f"{summary['ticks']} ticks; spawn to first tick "
          f"{got['boot_s']:.2f} s (imports, model, kernels, self-test); "
          f"first tick to last reveal {got['to_last_reveal_s']:.2f} s, "
          f"to last claim {got['to_last_claim_s']:.2f} s (host clock)",
          flush=True)
    print("node-run: arbius_stage_seconds sums "
          + ", ".join(f"{k} {v:.4f} s" for k, v in stage.items())
          + "; arbius_pipeline_stage_seconds sums "
          + ", ".join(f"{k} {v:.4f} s" for k, v in pipe.items())
          + f" (depth 2, 2 encode workers; {n_chunks} chunks)", flush=True)
    print("node-run: seconds per signed transaction (pure-Python "
          "secp256k1, sign only) "
          + ", ".join(f"{k} {v:.5f}" for k, v in sign.items())
          + f"; submitTask sign + HTTP + apply {got['submit_s']:.5f}",
          flush=True)
    print("node-run: sol/h " + ", ".join(f"{k} {v:.1f}"
                                         for k, v in sol_h.items())
          + f"; {card_info()}", flush=True)
    return launches


NODE_RUN_KEYS = ("0x" + "11" * 32, "0x" + "22" * 32)   # miner, user
CHAIN_ID = 31337
NODE_RUN_MAX_TICKS = 20_000   # node-run ends itself if SIGTERM never comes


def _read_lines(stream, sink: list) -> None:
    for line in stream:
        sink.append(line.rstrip("\n"))


def _wait(cond, what: str, proc, timeout: float, poll: float = 0.05):
    """Poll `cond` until true; fail if `proc` exits or time runs out."""
    deadline = time.monotonic() + timeout
    while not cond():
        check(proc.poll() is None, f"node-run exited ({proc.returncode}) "
              f"while waiting for {what}")
        check(time.monotonic() < deadline, f"timed out waiting for {what}")
        time.sleep(poll)


def _metric_sum(text: str, name: str, **labels) -> float:
    """Sum of the Prometheus samples `name` whose labels include
    `labels` (a histogram's series differ by their cost tag)."""
    want = [f'{k}="{v}"' for k, v in labels.items()]
    total = 0.0
    for line in text.splitlines():
        head, _, value = line.rpartition(" ")
        if head.split("{")[0] == name and all(w in head for w in want):
            total += float(value)
    return total


def sign_seconds(reps: int = 5) -> dict[str, float]:
    """Host seconds to sign one EIP-1559 transaction (the pure-Python
    secp256k1 of chain/wallet.py) for each write the miner makes per
    task: commit, reveal and claim."""
    from arbius_tpu_torch.chain.rlp import Eip1559Tx
    from arbius_tpu_torch.chain.rpc_client import ENGINE_FNS, selector
    from arbius_tpu_torch.chain.wallet import Wallet
    from arbius_tpu_torch.l0.abi import abi_encode

    wallet = Wallet.from_hex(NODE_RUN_KEYS[0])
    word, cid = b"\x5a" * 32, bytes.fromhex("1220" + "ab" * 32)
    calls = {"commit": ("signalCommitment", [word]),
             "reveal": ("submitSolution", [word, cid]),
             "claim": ("claimSolution", [word])}
    out = {}
    for stage, (fn, args) in calls.items():
        sig, types = ENGINE_FNS[fn]
        tx = Eip1559Tx(chain_id=CHAIN_ID, nonce=7,
                       max_priority_fee_per_gas=1, max_fee_per_gas=10**9,
                       gas_limit=500_000, to="0x" + "e1" * 20, value=0,
                       data=selector(sig) + abi_encode(types, args))
        t0 = time.perf_counter()
        for _ in range(reps):
            tx.sign(wallet)
        out[stage] = (time.perf_counter() - t0) / reps
    return out


def node_run_world(inputs: list[dict], *, device: str, tiny: bool,
                   golden: dict | None, workdir: str,
                   timeout: float = 900.0,
                   settings: dict | None = None) -> dict:
    """The quickstart's two terminals (phase 7): the port's DevnetNode
    serves a funded chain with a registered anythingv3 model on
    127.0.0.1 at a free port; `python -m arbius_tpu_torch.cli node-run`
    mines it as a separate process with MiningConfig.example.json's node
    settings (the staged pipeline on), an ephemeral control RPC, no
    compile cache and the model `device`/`tiny`/`golden` (`settings`
    overrides the config's other keys). The user's
    wallet submits `inputs` as signed transactions; once the node has
    revealed them all the devnet's clock advances past the claim window;
    once they are claimed, GET /metrics is read from the node's control
    RPC and the node is stopped with SIGTERM, which must end it with
    exit code 0 and its summary line. Returns the taskids, the revealed
    CIDs, the metrics text, the summary and the host timings."""
    import os
    import signal
    import subprocess
    import threading
    import urllib.request

    from arbius_tpu_torch.chain import WAD, Engine, TokenLedger
    from arbius_tpu_torch.chain.devnet import DevnetNode
    from arbius_tpu_torch.chain.rpc_client import (
        EngineRpcClient,
        JsonRpcTransport,
    )
    from arbius_tpu_torch.chain.wallet import Wallet
    from arbius_tpu_torch.node.rpc_chain import RpcChain
    from arbius_tpu_torch.templates import load_template_bytes

    root = pathlib.Path(__file__).resolve().parent
    miner, user = (Wallet.from_hex(k) for k in NODE_RUN_KEYS)
    tok = TokenLedger()
    eng = Engine(tok, start_time=1000)
    tok.mint(Engine.ADDRESS, 600_000 * WAD)
    for w in (miner, user):
        tok.mint(w.address, 1000 * WAD)
    mid = "0x" + eng.register_model(
        user.address, user.address, 0,
        load_template_bytes("anythingv3")).hex()
    events: dict[str, list] = {"TaskSubmitted": [], "SolutionSubmitted": [],
                               "SolutionClaimed": []}

    def on_event(ev):   # runs on a devnet request thread, under its lock
        if ev.name in events:
            key = "id" if ev.name == "TaskSubmitted" else "task"
            events[ev.name].append(("0x" + ev.args[key].hex(), time.time()))

    eng.subscribe(on_event)
    dev = DevnetNode(eng, chain_id=CHAIN_ID)
    server = dev.serve("127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}"

    work = pathlib.Path(workdir)
    cfg = json.loads((root / "MiningConfig.example.json").read_text())
    cfg.update(db_path=str(work / "miner.db"), log_path=str(work /
               "miner.log"), store_dir=str(work / "store"), rpc_port=0,
               compile_cache_dir=None, models=[{
                   "id": mid, "template": "anythingv3", "tiny": tiny,
                   "weights_dtype": "bfloat16", "golden": golden}])
    cfg.update(settings or {})
    (work / "config.json").write_text(json.dumps(cfg))
    (work / "deployment.json").write_text(json.dumps({
        "rpc_url": url, "engine_address": dev.engine_address,
        "token_address": dev.token_address, "chain_id": CHAIN_ID}))
    (work / "miner.key").write_text("0x" + miner.private_key.hex())

    # -- the user's signed submitTask transactions ----------------------------
    user_chain = RpcChain(EngineRpcClient(JsonRpcTransport(url),
                                          dev.engine_address, user,
                                          chain_id=CHAIN_ID),
                          dev.token_address)
    user_chain.ensure_fee_allowance(TASK_FEE * WAD * len(inputs))
    t0 = time.perf_counter()
    for raw in inputs:
        user_chain.submit_task(0, user.address, mid, TASK_FEE * WAD,
                               json.dumps(raw, sort_keys=True).encode())
    submit_s = (time.perf_counter() - t0) / len(inputs)
    tids = [t for t, _ in events["TaskSubmitted"]]
    check(len(tids) == len(inputs), f"{len(tids)} tasks on chain")

    out_lines: list[str] = []
    err_lines: list[str] = []
    t_spawn = time.time()
    proc = subprocess.Popen(
        [sys.executable, "-m", "arbius_tpu_torch.cli", "node-run",
         str(work / "config.json"), "--deployment",
         str(work / "deployment.json"), "--key-file", str(work / "miner.key"),
         "--device", device, "--ticks", str(NODE_RUN_MAX_TICKS)],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ))
    readers = [threading.Thread(target=_read_lines, args=(stream, sink),
                                daemon=True)
               for stream, sink in ((proc.stdout, out_lines),
                                    (proc.stderr, err_lines))]
    for t in readers:
        t.start()
    try:
        prefix = "control RPC + explorer on 127.0.0.1:"
        _wait(lambda: any(ln.startswith(prefix) for ln in err_lines),
              "the node's control RPC", proc, timeout)
        port = int(next(ln for ln in err_lines
                        if ln.startswith(prefix))[len(prefix):])

        def mine(name):
            return {t for t, _ in events[name]} >= set(tids)

        _wait(lambda: mine("SolutionSubmitted"), "the reveals", proc,
              timeout)
        dev.request("evm_increaseTime", [eng.min_claim_solution_time
                                         + cfg["claim_delay_buffer"] + 1])
        dev.request("evm_mine", [])
        _wait(lambda: mine("SolutionClaimed"), "the claims", proc, timeout)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=30) as resp:
            metrics = resp.read().decode()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        for t in readers:
            t.join(timeout=10)
        server.shutdown()
        server.server_close()
    check(rc == 0, f"node-run exited {rc}: " + "\n".join(err_lines[-40:]))
    [summary] = [json.loads(ln)["node_run"] for ln in out_lines
                 if ln.startswith('{"node_run"')]
    cids = []
    for tid in tids:
        sol = eng.solutions[bytes.fromhex(tid[2:])]
        check(sol.validator == miner.address.lower() and sol.claimed,
              f"task {tid}: {sol}")
        cids.append("0x" + sol.cid.hex())
    first = summary["first_tick_unix"]
    return {"tids": tids, "cids": cids, "metrics": metrics,
            "summary": summary, "submit_s": submit_s,
            "boot_s": first - t_spawn,
            "to_last_reveal_s": max(t for _, t in
                                    events["SolutionSubmitted"]) - first,
            "to_last_claim_s": max(t for _, t in
                                   events["SolutionClaimed"]) - first}


def template_world(inputs: list[dict], miner: str, user: str,
                   template: str = "kandinsky2"):
    """An in-process chain with `template` registered, the miner and the
    user funded; `inputs` go on chain as the user's tasks when `submit`
    is called. Engine ids are deterministic, so two worlds built alike
    give the same taskids: phases 8 and 9 solve a first world's tasks
    directly and mine a second's."""
    from arbius_tpu_torch.chain import WAD, Engine, TokenLedger
    from arbius_tpu_torch.templates import load_template_bytes

    tok = TokenLedger()
    eng = Engine(tok, start_time=0)
    tok.mint(Engine.ADDRESS, 600_000 * WAD)
    for a in (miner, user):
        tok.mint(a, 1000 * WAD)
        tok.approve(a, Engine.ADDRESS, 10**30)
    mid_b = eng.register_model(user, user, 0,
                               load_template_bytes(template))

    def submit() -> list[str]:
        return ["0x" + eng.submit_task(
            user, 0, user, mid_b, TASK_FEE * WAD,
            json.dumps(raw, sort_keys=True).encode()).hex()
            for raw in inputs]

    return tok, eng, "0x" + mid_b.hex(), submit


def k2_inputs() -> list[dict]:
    """Phase 8's six template inputs at the default bucket."""
    return [{"prompt": f"a lighthouse on a cliff at dusk, study {i}",
             "width": K2_SIZE, "height": K2_SIZE} for i in range(6)]


class StageClock:
    """CUDA events at the stage boundaries of each chunk of a pipeline,
    from hooks on its modules: `stages` names each stage after the module
    whose first call in the chunk starts it ([(name, module), ...], in
    order; the first module's call after a chunk's end opens the next),
    and the last module's last call ends the chunk. Also the allocator's
    peak GiB over each stage (read and reset at those boundaries on the
    host, where the allocations are made), and whether each call of the
    last module gave finite pixels and no constant image. Nothing waits
    for the card until `read`."""

    def __init__(self, torch, stages):
        from arbius_tpu_torch.models.sd15 import decode_to_images

        self.torch, self.marks, self.peaks, self.flags = torch, [], [], []
        self.decode = decode_to_images
        self.names = [name for name, _ in stages]
        for name, module in stages:
            module.register_forward_pre_hook(self._hook(name))
        stages[-1][1].register_forward_hook(self._pixels)

    def _mark(self, key: str, ended: str | None) -> None:
        """An event under `key`, closing stage `ended`'s peak."""
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        self.marks[-1][key] = ev
        if ended is not None:
            peak = self.torch.cuda.max_memory_allocated() / 2**30
            self.peaks[-1][ended] = max(self.peaks[-1].get(ended, 0.0), peak)
        self.torch.cuda.reset_peak_memory_stats()

    def _hook(self, name):
        i = self.names.index(name)

        def hook(_mod, _inp):
            if i == 0 and (not self.marks or "end" in self.marks[-1]):
                self.marks.append({})
                self.peaks.append({})
            if name not in self.marks[-1]:   # the stage's first call
                self._mark(name, self.names[i - 1] if i else None)
        return hook

    def _pixels(self, _mod, _inp, pixels):
        self.marks[-1].pop("end", None)   # the chunk's last call ends it
        self._mark("end", self.names[-1])
        self.images = self.decode(pixels)   # the last call's, on the card
        u = self.images.flatten(1)
        self.flags.append((self.torch.isfinite(pixels).all(),
                           (u.amax(1) > u.amin(1)).all()))

    def read(self) -> list[dict]:
        """Per chunk since the last read, the device seconds of each
        stage and the peak GiB allocated in it; clears them."""
        self.torch.cuda.synchronize()
        bounds = list(zip(self.names, self.names[1:] + ["end"]))
        out = [{**{a: m[a].elapsed_time(m[b]) / 1e3 for a, b in bounds},
                **{f"peak GiB {k}": v for k, v in p.items()}}
               for m, p in zip(self.marks, self.peaks)]
        self.marks, self.peaks = [], []
        return out

    def images_ok(self, n: int) -> bool:
        """Whether the last module ran `n` times since the last check,
        each with finite pixels and no constant image; clears the
        flags."""
        ok = len(self.flags) == n and all(bool(f) and bool(c)
                                          for f, c in self.flags)
        self.flags = []
        return ok


def k2_clock(torch, models) -> StageClock:
    """Phase 8's stages: text + prior, the decoder loop, MoVQ."""
    return StageClock(torch, [("text+prior", models.text),
                              ("decoder loop", models.decoder),
                              ("movq", models.movq)])


def video_clock(torch, models) -> StageClock:
    """Phase 9's stages: text, the denoise loop, the VAE (its calls over
    the frame groups)."""
    return StageClock(torch, [("text", models.text),
                              ("denoise loop", models.unet),
                              ("vae", models.vae)])


def device_trace_summary(trace: dict, top: int = 8) -> dict:
    """A torch.profiler Chrome trace of CUDA activity: the kernels, the
    device time under at least one kernel or copy (busy_ms), first start
    to last end (span_ms), the idle share 1 - busy / span, and the `top`
    kernel names by summed device time (ms, launches)."""
    events = [e for e in trace["traceEvents"]
              if e.get("ph") == "X" and "dur" in e
              and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    by_name: dict[str, list] = {}
    for e in events:
        if e["cat"] == "kernel":
            acc = by_name.setdefault(e["name"][:90], [0.0, 0])
            acc[0] += e["dur"] / 1e3
            acc[1] += 1
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    span = spans[-1][1] - spans[0][0] if spans else 0.0
    return {"kernels": sum(n for _, n in by_name.values()),
            "busy_ms": busy / 1e3, "span_ms": span / 1e3,
            "idle_share": 1.0 - busy / span if span else None,
            "top": sorted(([name, ms, n] for name, (ms, n) in
                           by_name.items()), key=lambda x: -x[1])[:top]}


def phase_kandinsky2(torch, flash) -> dict:
    """Phase 8: kandinsky2 at full width (seeded random weights, bf16),
    the reference miner's flagship template. The main path solves six
    template inputs at 768x768 (50 steps, DDIM, guidance 4.0) at the
    canonical batch; a fresh pipeline re-solves them in other chunks
    (CIDs and launches equal, one chunk traced by torch.profiler); one
    task keeps its CID among different neighbours at 1024x1024 and
    768x1024 (K2_BUCKET_STEPS steps); a MinerNode on LocalChain boots
    with the committed golden (re-recorded where the build differs),
    passes its self-test, mines the six tasks from TaskSubmitted through
    claim, and each on-chain CID equals the main path's. Every chunk
    launches the flash kernels as `expected_launches` derives from
    `movq_attention_shapes`: once, on the wgmma wide route. Returns the
    launches per route of the main path and of the node's mining."""
    import tempfile

    from arbius_tpu_torch.chain import WAD
    from arbius_tpu_torch.cli import build_info, record_golden
    from arbius_tpu_torch.codecs import encode_png
    from arbius_tpu_torch.l0 import generate_commitment, taskid2seed
    from arbius_tpu_torch.l0.cid import cid_hex, cid_of_solution_files
    from arbius_tpu_torch.node import (
        LocalChain,
        MinerNode,
        MiningConfig,
        ModelConfig,
        build_registry,
        solve_cid_batch,
    )
    from arbius_tpu_torch.templates import hydrate_input, load_template
    from arbius_tpu_torch.utils import card_info

    card = card_info()
    template = load_template("kandinsky2")
    want = expected_launches(torch, flash,
                             movq_attention_shapes(K2_SIZE, K2_SIZE))
    check(want["tensor_core_wgmma_wide"] == 1 and sum(want.values()) == 1,
          f"the rule sends MoVQ's call elsewhere: {want}")
    miner, user = "0x" + "aa" * 20, "0x" + "01" * 20
    inputs = k2_inputs()
    tids = template_world(inputs, miner, user)[3]()
    items = [(hydrate_input(dict(raw), template), taskid2seed(tid))
             for raw, tid in zip(inputs, tids)]

    def config(mid, golden=None):
        return MiningConfig(canonical_batch=CANONICAL_BATCH, models=(
            ModelConfig(id=mid, template="kandinsky2",
                        weights_dtype="bfloat16", golden=golden),))

    def build(mid="0x" + "00" * 32, golden=None):
        return build_registry(config(mid, golden), device="cuda").get(mid)

    # -- main path: six tasks, two chunks ------------------------------------
    t0 = time.perf_counter()
    model = build()
    torch.cuda.synchronize()
    models = model.runner.pipeline.models
    n_params = sum(p.numel() for p in models.parameters())
    print(f"kandinsky2: built full width ({n_params} parameters, bf16 "
          f"weights) in {time.perf_counter() - t0:.1f} s", flush=True)
    clock = k2_clock(torch, models)
    flash.reset_launches()
    t0 = time.perf_counter()
    solved = solve_cid_batch(model, items, canonical_batch=CANONICAL_BATCH)
    wall = time.perf_counter() - t0
    launches = dict(flash.flash_attention.launches_by_route)
    n_chunks = -(-len(items) // CANONICAL_BATCH)
    check(launches == {r: n * n_chunks for r, n in want.items()},
          f"kandinsky2 launches {launches}, expected {want} x {n_chunks}")
    check(clock.images_ok(n_chunks), "kandinsky2: non-finite or constant "
          "images")
    stages = clock.read()
    cids = [cid for cid, _ in solved]
    for tid, (cid, files) in zip(tids, solved):
        check(len(cid) == 2 + 68 and cid.startswith("0x1220"),
              f"kandinsky2: bad CIDv0 {cid}")
        check(set(files) == {"out-1.png"}, f"unexpected files {set(files)}")
        check(len(generate_commitment(ADDRESS, tid, cid)) == 32,
              "commitment is not 32 bytes")
    print(f"kandinsky2: solved {len(items)} tasks at {K2_SIZE}x{K2_SIZE} "
          f"(50 steps, DDIM, guidance 4.0) in {n_chunks} chunks in "
          f"{wall:.2f} s ({len(items) / wall * 3600:.1f} solutions/h on "
          f"{card}); flash launches {launches}; CIDs " + " ".join(cids),
          flush=True)
    del model, models, clock
    gc.collect()
    torch.cuda.empty_cache()

    # -- determinism: a fresh pipeline, other chunks ---------------------------
    fresh = build()
    clock = k2_clock(torch, fresh.runner.pipeline.models)
    latencies, chunk_stages = [], []
    runs = ([2, 4, 0, 1], [5, 3], [1, 0, 3, 2])
    trace = None
    for n, idx in enumerate(runs):
        traced = n == len(runs) - 1
        flash.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if traced:   # the last run under torch.profiler, CUDA activity
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                again = solve_cid_batch(fresh, [items[i] for i in idx],
                                        canonical_batch=CANONICAL_BATCH)
                torch.cuda.synchronize()
            with tempfile.TemporaryDirectory() as work:
                path = pathlib.Path(work) / "chunk.json"
                prof.export_chrome_trace(str(path))
                trace = device_trace_summary(json.loads(path.read_text()))
        else:
            again = solve_cid_batch(fresh, [items[i] for i in idx],
                                    canonical_batch=CANONICAL_BATCH)
            latencies.append(time.perf_counter() - t0)
            chunk_stages += clock.read()
        check(flash.flash_attention.launches_by_route == want,
              f"kandinsky2 chunk {idx}: launches "
              f"{flash.flash_attention.launches_by_route}, expected {want}")
        for i, (cid, _) in zip(idx, again):
            check(cid == cids[i], f"kandinsky2 task {i}: CID {cid} != "
                  f"{cids[i]} (fresh pipeline, chunk {idx})")
    clock.read()    # the traced chunk's stages carry the profiler's cost
    check(clock.images_ok(len(runs)), "kandinsky2: non-finite or constant "
          "images in the determinism runs")
    check(trace is not None and trace["kernels"] > 0,
          f"kandinsky2: no kernels in the traced chunk: {trace}")
    p50 = statistics.median(latencies)
    # the host's PNG + CID of the last chunk's images, as the solver does
    images = clock.images.cpu().numpy()
    t0 = time.perf_counter()
    for img in images:
        cid_hex(cid_of_solution_files({"out-1.png": encode_png(img)}))
    encode_s = time.perf_counter() - t0
    print(f"kandinsky2 determinism: fresh pipeline, chunks {list(runs)}: "
          f"CIDs identical, 1 flash launch per chunk on "
          f"tensor_core_wgmma_wide; per-chunk latency s "
          f"{[round(x, 3) for x in latencies]} (host clock, to PNG and "
          f"CID), p50 {p50:.3f} s ({CANONICAL_BATCH * 3600 / p50:.1f} "
          f"solutions/h at full batches, {card})", flush=True)
    stage_s = {k: statistics.median(c[k] for c in stages + chunk_stages)
               for k in stages[0]}
    print("kandinsky2 stages (device seconds between CUDA events, median "
          f"of {len(stages + chunk_stages)} chunks): "
          + ", ".join(f"{k} {v:.3f}" for k, v in stage_s.items())
          + f"; PNG + CID of one chunk's {CANONICAL_BATCH} images "
          f"{encode_s:.3f} s (host); {card}", flush=True)
    print(f"kandinsky2 launches per chunk (chunk {runs[-1]} traced by "
          f"torch.profiler): {trace['kernels']} kernels, of them 1 flash "
          f"(tensor_core_wgmma_wide); device busy {trace['busy_ms']:.1f} ms "
          f"of a {trace['span_ms']:.1f} ms span, idle share "
          f"{trace['idle_share']:.3f}; {card}", flush=True)
    print("kandinsky2 traced chunk, kernels by device time (name, ms, "
          "launches): " + json.dumps(trace["top"]), flush=True)

    # -- buckets: one task among different neighbours --------------------------
    for width, height in K2_BUCKETS:
        bucket = []
        for i in range(6):
            raw = {"prompt": f"a harbour at dawn, kandinsky2 study {i}",
                   "width": width, "height": height}
            taskid = "0x" + f"{0x6B6B * (i + 5) + width:x}".rjust(64, "4")
            bucket.append(({**hydrate_input(raw, template),
                            "num_inference_steps": K2_BUCKET_STEPS},
                           taskid2seed(taskid)))
        shape_want = expected_launches(torch, flash, movq_attention_shapes(
            width, height))
        t0 = time.perf_counter()
        got = []
        for chunk in ([0, 1, 2, 3], [4, 0, 5]):
            flash.reset_launches()
            out = solve_cid_batch(fresh, [bucket[i] for i in chunk],
                                  canonical_batch=CANONICAL_BATCH)
            check(flash.flash_attention.launches_by_route == shape_want,
                  f"kandinsky2 {width}x{height}: launches "
                  f"{flash.flash_attention.launches_by_route}, expected "
                  f"{shape_want}")
            got.append(out[chunk.index(0)][0])
        check(got[0] == got[1], f"kandinsky2 {width}x{height}: task 0's "
              f"CID {got[0]} among neighbours 1-3, {got[1]} among 4 and 5")
        check(clock.images_ok(2), f"kandinsky2 {width}x{height}: "
              "non-finite or constant images")
        clock.read()
        print(f"kandinsky2 buckets: {width}x{height}, {K2_BUCKET_STEPS} "
              f"steps: task 0 keeps CID {got[0]} among different "
              f"neighbours; launches per chunk {shape_want}; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

    # -- node: golden, boot with the self-test, mine, claim ---------------------
    committed = json.loads(
        (pathlib.Path(__file__).resolve().parent / K2_GOLDEN_FILE)
        .read_text())
    check(committed["golden"]["input"] == K2_GOLDEN_INPUT
          and committed["golden"]["seed"] == GOLDEN_SEED
          and committed["canonical_batch"] == CANONICAL_BATCH
          and committed["template"] == "kandinsky2",
          f"{K2_GOLDEN_FILE} is not the vector phase 8 boots with")
    build_now = {k: build_info("cuda").get(k) for k in BUILD_FIELDS}
    built = {k: committed["build"].get(k) for k in BUILD_FIELDS}
    if build_now == built:
        golden, source = committed["golden"], K2_GOLDEN_FILE
    else:
        rec = record_golden(fresh, K2_GOLDEN_INPUT, GOLDEN_SEED,
                            canonical_batch=CANONICAL_BATCH, device="cuda")
        golden = rec["golden"]
        source = f"re-recorded here: this build {build_now} is not {built}"
    del fresh, clock
    gc.collect()
    torch.cuda.empty_cache()

    tok, eng, mid, submit = template_world(inputs, miner, user)
    chain = LocalChain(eng, miner)
    chain.validator_deposit(100 * WAD)
    cfg = config(mid, golden)
    registry = build_registry(cfg, device="cuda")
    node = MinerNode(chain, cfg, registry)
    flash.reset_launches()
    t0 = time.perf_counter()
    node.boot()
    boot_s = time.perf_counter() - t0
    check(flash.flash_attention.launches_by_route == want,
          f"kandinsky2 self-test launches "
          f"{flash.flash_attention.launches_by_route}, expected {want}")
    print(f"kandinsky2 node: booted with golden {golden['cid']} ({source}); "
          f"self-test passed in {boot_s:.2f} s", flush=True)
    clock = k2_clock(torch, registry.get(mid).runner.pipeline.models)
    check(submit() == tids, "kandinsky2: the second world's taskids differ")
    flash.reset_launches()
    t0 = time.perf_counter()
    while node.tick():
        pass
    mine_s = time.perf_counter() - t0
    node_launches = dict(flash.flash_attention.launches_by_route)
    check(node.db.failed_jobs() == [],
          f"kandinsky2 node: failed jobs {node.db.failed_jobs()}")
    check(node_launches == launches, f"kandinsky2 node: launches "
          f"{node_launches}, expected {launches}")
    check(clock.images_ok(n_chunks), "kandinsky2 node: non-finite or "
          "constant images")
    for tid, want_cid in zip(tids, cids):
        sol = eng.solutions.get(bytes.fromhex(tid[2:]))
        check(sol is not None and sol.validator == miner,
              f"kandinsky2 task {tid} not solved by the miner: {sol}")
        cid = "0x" + sol.cid.hex()
        check(cid == want_cid, f"kandinsky2 task {tid}: on-chain {cid} != "
              f"main path {want_cid}")
        check(chain.generate_commitment(tid, cid) in eng.commitments,
              f"kandinsky2 task {tid}: no commitment matching {cid}")
    bal0 = tok.balance_of(miner)
    eng.advance_time(eng.min_claim_solution_time
                     + cfg.claim_delay_buffer + 1)
    while node.tick():
        pass
    rise = tok.balance_of(miner) - bal0
    check(node.metrics.solutions_claimed == len(tids)
          and rise == len(tids) * TASK_FEE * WAD * 9 // 10,
          f"kandinsky2 node: claimed {node.metrics.solutions_claimed} of "
          f"{len(tids)}, +{rise}")
    infer = sum(node.metrics.stage_seconds["infer"])
    node.close()
    print(f"kandinsky2 node: mined {len(tids)} tasks in {n_chunks} chunks, "
          f"{mine_s:.2f} s host time from the first tick to the last "
          f"reveal (infer {infer:.3f} s, "
          f"{CANONICAL_BATCH * n_chunks * 3600 / infer:.1f} sol/h at full "
          f"batches); on-chain CIDs equal the main path's; claimed "
          f"{len(tids)}, +{rise / WAD:g} AIUS; {card}", flush=True)
    del node, registry, clock
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "launches_node": node_launches}


def video_inputs(n: int = 6, **extra) -> list[dict]:
    """Phase 9's template inputs: a prompt (the template's and the
    runner's defaults fill the rest), plus `extra`."""
    return [{"prompt": f"a lighthouse on a cliff at dusk, waves, clip {i}",
             **extra} for i in range(n)]


def phase_video_small_reference(torch) -> None:
    """The tiny float32 text-to-video config solved on the card and on the
    CPU from the same weights, the reference's temporal zero inits filled
    with seeded values (else the temporal branches add nothing)."""
    import dataclasses

    from arbius_tpu_torch.models.video import (
        Text2VideoConfig,
        Text2VideoPipeline,
    )
    from arbius_tpu_torch.node.factory import tiny_byte_tokenizer

    r = dataclasses.replace
    tiny = Text2VideoConfig.tiny()
    cfg = Text2VideoConfig(r(tiny.unet, dtype="float32"),
                           r(tiny.vae, dtype="float32"),
                           r(tiny.text, dtype="float32"))
    pipes = [Text2VideoPipeline(cfg, tiny_byte_tokenizer(cfg.text),
                                device=dev) for dev in ("cpu", "cuda")]
    params = pipes[0].init_params(seed=0)
    gen = torch.Generator().manual_seed(9)
    for key in pipes[0].models.unet.zero_init_keys():
        w = params[f"unet.{key}"]
        params[f"unet.{key}"] = 0.1 * torch.randn(w.shape, generator=gen)
    frames = []
    for pipe in pipes:
        pipe.load_params(params)
        frames.append(pipe.generate(
            ["a lighthouse", "b"], ["", "blurry"], [1, 2**40 + 3],
            num_frames=3, width=64, height=64, num_inference_steps=2,
            guidance_scale=[9.0, 3.0]).astype(int))
    diff = abs(frames[0] - frames[1])
    print(f"video small reference: tiny f32 3 frames 64x64, temporal zero "
          f"inits filled, card vs CPU: max uint8 diff {diff.max()}, "
          f"differing fraction {(diff > 0).mean():.6f}", flush=True)
    check(diff.max() <= 1 and (diff > 0).mean() <= 0.01,
          "tiny video card solve disagrees with the CPU solve")


def phase_video(torch, flash) -> dict:
    """Phase 9: text-to-video at full width (seeded random weights, bf16).
    The small reference first; then damo's default task (16 frames at
    256x256, 50 steps, DDIM, guidance 9.0): six template inputs at the
    canonical batch, CIDs of the MP4 bytes, commitments, finite and
    non-constant frames, launches per chunk per route as
    `expected_launches` derives them from `video_attention_shapes`; a
    fresh pipeline re-solves them in other chunks (CIDs equal, one chunk
    traced by torch.profiler); zeroscopev2xl's default bucket (24 frames
    at 1024x576) at ZS_STEPS steps keeps one task's CID among different
    neighbours, with the peak memory per stage; a MinerNode on
    LocalChain boots with the committed damo golden (re-recorded where
    the build differs), passes its self-test, mines the six tasks through
    claim, and each on-chain CID equals the main path's. Returns the
    launches per route of the main path and of the node's mining."""
    import tempfile

    from arbius_tpu_torch.chain import WAD
    from arbius_tpu_torch.cli import build_info, record_golden
    from arbius_tpu_torch.codecs import encode_mp4_h264
    from arbius_tpu_torch.l0 import generate_commitment, taskid2seed
    from arbius_tpu_torch.l0.cid import cid_hex, cid_of_solution_files
    from arbius_tpu_torch.node import (
        LocalChain,
        MinerNode,
        MiningConfig,
        ModelConfig,
        build_registry,
        solve_cid_batch,
    )
    from arbius_tpu_torch.templates import hydrate_input, load_template
    from arbius_tpu_torch.utils import card_info

    card = card_info()
    t_phase = time.perf_counter()
    phase_video_small_reference(torch)
    template = load_template("damo")
    want = expected_launches(torch, flash, DAMO_SHAPES)
    vae_calls = sum(n for *_, d, n in DAMO_SHAPES if d == 512)
    check(want["tensor_core_wgmma"] + want["tensor_core_wgmma_short"]
          == 16 * 2 * VIDEO_STEPS and want["tensor_core"] == 0
          and want["cuda_core"] == 0,
          f"the rule sends the UNet3D's D = 64 calls elsewhere: {want}")
    miner, user = "0x" + "aa" * 20, "0x" + "01" * 20
    inputs = video_inputs()
    tids = template_world(inputs, miner, user, "damo")[3]()
    items = [(hydrate_input(dict(raw), template), taskid2seed(tid))
             for raw, tid in zip(inputs, tids)]
    check(all(h["num_frames"] == VIDEO_FRAMES and
              h["num_inference_steps"] == VIDEO_STEPS for h, _ in items),
          "damo's template defaults are not 16 frames, 50 steps")

    def config(template_name, mid, golden=None):
        return MiningConfig(canonical_batch=CANONICAL_BATCH, models=(
            ModelConfig(id=mid, template=template_name,
                        weights_dtype="bfloat16", golden=golden),))

    def build(template_name="damo", mid="0x" + "00" * 32, golden=None):
        return build_registry(config(template_name, mid, golden),
                              device="cuda").get(mid)

    # -- main path: six tasks, two chunks ------------------------------------
    t0 = time.perf_counter()
    model = build()
    torch.cuda.synchronize()
    models = model.runner.pipeline.models
    n_params = sum(p.numel() for p in models.parameters())
    n_unet = sum(p.numel() for p in models.unet.parameters())
    print(f"video: built damo at full width ({n_params} parameters, "
          f"{n_unet} of them the UNet3D's; bf16 weights) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    clock = video_clock(torch, models)
    flash.reset_launches()
    n_chunks = -(-len(items) // CANONICAL_BATCH)
    t0 = time.perf_counter()
    solved = solve_cid_batch(model, items, canonical_batch=CANONICAL_BATCH)
    wall = time.perf_counter() - t0
    launches = dict(flash.flash_attention.launches_by_route)
    check(launches == {r: n * n_chunks for r, n in want.items()},
          f"video launches {launches}, expected {want} x {n_chunks}")
    check(clock.images_ok(n_chunks * vae_calls), "video: non-finite or "
          "constant frames")
    stages = clock.read()
    cids = [cid for cid, _ in solved]
    for tid, (cid, files) in zip(tids, solved):
        check(len(cid) == 2 + 68 and cid.startswith("0x1220"),
              f"video: bad CIDv0 {cid}")
        check(set(files) == {"out-1.mp4"} and
              files["out-1.mp4"][4:8] == b"ftyp",
              f"video: unexpected files {set(files)}")
        check(len(generate_commitment(ADDRESS, tid, cid)) == 32,
              "commitment is not 32 bytes")
    print(f"video: solved {len(items)} damo tasks ({VIDEO_FRAMES} frames "
          f"at {VIDEO_SIZE}x{VIDEO_SIZE}, {VIDEO_STEPS} steps, DDIM, "
          f"guidance 9.0) in {n_chunks} chunks in {wall:.2f} s "
          f"({len(items) / wall * 3600:.1f} solutions/h on {card}); flash "
          f"launches {launches}; CIDs " + " ".join(cids), flush=True)
    del model, models, clock
    gc.collect()
    torch.cuda.empty_cache()

    # -- determinism: a fresh pipeline, other chunks -------------------------
    fresh = build()
    clock = video_clock(torch, fresh.runner.pipeline.models)
    latencies, chunk_stages = [], []
    runs = ([2, 4, 0, 1], [5, 3], [1, 0, 3, 2])
    trace = None
    for n, idx in enumerate(runs):
        traced = n == len(runs) - 1
        flash.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if traced:   # the last run under torch.profiler, CUDA activity
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                again = solve_cid_batch(fresh, [items[i] for i in idx],
                                        canonical_batch=CANONICAL_BATCH)
                torch.cuda.synchronize()
            with tempfile.TemporaryDirectory() as work:
                path = pathlib.Path(work) / "chunk.json"
                prof.export_chrome_trace(str(path))
                trace = device_trace_summary(json.loads(path.read_text()))
        else:
            again = solve_cid_batch(fresh, [items[i] for i in idx],
                                    canonical_batch=CANONICAL_BATCH)
            latencies.append(time.perf_counter() - t0)
            chunk_stages += clock.read()
        check(flash.flash_attention.launches_by_route == want,
              f"video chunk {idx}: launches "
              f"{flash.flash_attention.launches_by_route}, expected {want}")
        for i, (cid, _) in zip(idx, again):
            check(cid == cids[i], f"video task {i}: CID {cid} != "
                  f"{cids[i]} (fresh pipeline, chunk {idx})")
    clock.read()    # the traced chunk's stages carry the profiler's cost
    check(clock.images_ok(len(runs) * vae_calls), "video: non-finite or "
          "constant frames in the determinism runs")
    check(trace is not None and trace["kernels"] > 0,
          f"video: no kernels in the traced chunk: {trace}")
    p50 = statistics.median(latencies)
    # the host's H.264 + MP4 + CID of the last chunk's videos, as the
    # solver does
    videos = clock.images.view(CANONICAL_BATCH, VIDEO_FRAMES,
                               *clock.images.shape[1:]).cpu().numpy()
    t0 = time.perf_counter()
    for video in videos:
        cid_hex(cid_of_solution_files(
            {"out-1.mp4": encode_mp4_h264(video, fps=8)}))
    encode_s = time.perf_counter() - t0
    print(f"video determinism: fresh pipeline, chunks {list(runs)}: CIDs "
          f"identical (task 0 among neighbours 1-3 and among 2, 4, 1), "
          f"launches per chunk {want}; per-chunk latency s "
          f"{[round(x, 3) for x in latencies]} (host clock, to MP4 and "
          f"CID), p50 {p50:.3f} s ({CANONICAL_BATCH * 3600 / p50:.1f} "
          f"solutions/h at full batches, {card})", flush=True)
    stage_s = {k: statistics.median(c[k] for c in stages + chunk_stages)
               for k in stages[0]}
    print("video stages (device seconds between CUDA events and peak GiB "
          f"allocated, median of {len(stages + chunk_stages)} chunks): "
          + ", ".join(f"{k} {v:.3f}" for k, v in stage_s.items())
          + f"; H.264 + MP4 + CID of one chunk's {CANONICAL_BATCH} videos "
          f"{encode_s:.3f} s (host); {card}", flush=True)
    flash_n = sum(want.values())
    print(f"video launches per chunk (chunk {runs[-1]} traced by "
          f"torch.profiler): {trace['kernels']} kernels, of them {flash_n} "
          f"flash; device busy {trace['busy_ms']:.1f} ms of a "
          f"{trace['span_ms']:.1f} ms span, idle share "
          f"{trace['idle_share']:.3f}; {card}", flush=True)
    print("video traced chunk, kernels by device time (name, ms, "
          "launches): " + json.dumps(trace["top"]), flush=True)

    # -- node: golden, boot with the self-test, mine, claim -------------------
    committed = json.loads(
        (pathlib.Path(__file__).resolve().parent / VIDEO_GOLDEN_FILE)
        .read_text())
    check(committed["golden"]["input"] == VIDEO_GOLDEN_INPUT
          and committed["golden"]["seed"] == GOLDEN_SEED
          and committed["canonical_batch"] == CANONICAL_BATCH
          and committed["template"] == "damo",
          f"{VIDEO_GOLDEN_FILE} is not the vector phase 9 boots with")
    build_now = {k: build_info("cuda").get(k) for k in BUILD_FIELDS}
    built = {k: committed["build"].get(k) for k in BUILD_FIELDS}
    if build_now == built:
        golden, source = committed["golden"], VIDEO_GOLDEN_FILE
    else:
        rec = record_golden(fresh, VIDEO_GOLDEN_INPUT, GOLDEN_SEED,
                            canonical_batch=CANONICAL_BATCH, device="cuda")
        golden = rec["golden"]
        source = f"re-recorded here: this build {build_now} is not {built}"
    del fresh, clock
    gc.collect()
    torch.cuda.empty_cache()

    tok, eng, mid, submit = template_world(inputs, miner, user, "damo")
    chain = LocalChain(eng, miner)
    chain.validator_deposit(100 * WAD)
    cfg = config("damo", mid, golden)
    registry = build_registry(cfg, device="cuda")
    node = MinerNode(chain, cfg, registry)
    flash.reset_launches()
    t0 = time.perf_counter()
    node.boot()
    boot_s = time.perf_counter() - t0
    check(flash.flash_attention.launches_by_route == want,
          f"video self-test launches "
          f"{flash.flash_attention.launches_by_route}, expected {want}")
    print(f"video node: booted with golden {golden['cid']} ({source}); "
          f"self-test passed in {boot_s:.2f} s", flush=True)
    check(submit() == tids, "video: the second world's taskids differ")
    flash.reset_launches()
    t0 = time.perf_counter()
    while node.tick():
        pass
    mine_s = time.perf_counter() - t0
    node_launches = dict(flash.flash_attention.launches_by_route)
    check(node.db.failed_jobs() == [],
          f"video node: failed jobs {node.db.failed_jobs()}")
    check(node_launches == launches, f"video node: launches "
          f"{node_launches}, expected {launches}")
    for tid, want_cid in zip(tids, cids):
        sol = eng.solutions.get(bytes.fromhex(tid[2:]))
        check(sol is not None and sol.validator == miner,
              f"video task {tid} not solved by the miner: {sol}")
        cid = "0x" + sol.cid.hex()
        check(cid == want_cid, f"video task {tid}: on-chain {cid} != "
              f"main path {want_cid}")
        check(chain.generate_commitment(tid, cid) in eng.commitments,
              f"video task {tid}: no commitment matching {cid}")
    bal0 = tok.balance_of(miner)
    eng.advance_time(eng.min_claim_solution_time
                     + cfg.claim_delay_buffer + 1)
    while node.tick():
        pass
    rise = tok.balance_of(miner) - bal0
    check(node.metrics.solutions_claimed == len(tids)
          and rise == len(tids) * TASK_FEE * WAD * 9 // 10,
          f"video node: claimed {node.metrics.solutions_claimed} of "
          f"{len(tids)}, +{rise}")
    infer = sum(node.metrics.stage_seconds["infer"])
    node.close()
    print(f"video node: mined {len(tids)} damo tasks in {n_chunks} "
          f"chunks, {mine_s:.2f} s host time from the first tick to the "
          f"last reveal (infer {infer:.3f} s, "
          f"{CANONICAL_BATCH * n_chunks * 3600 / infer:.1f} sol/h at full "
          f"batches); on-chain CIDs equal the main path's; claimed "
          f"{len(tids)}, +{rise / WAD:g} AIUS; {card}", flush=True)
    del node, registry
    gc.collect()
    torch.cuda.empty_cache()

    # -- zeroscopev2xl's default bucket: one task among neighbours ------------
    zs_template = load_template("zeroscopev2xl")
    zs_items = []
    # the template requires a negative prompt: its default
    for i, raw in enumerate(video_inputs(
            negative_prompt="noisy, washed out, ugly, distorted, broken",
            num_inference_steps=ZS_STEPS)):
        taskid = "0x" + f"{0x7C7C * (i + 3):x}".rjust(64, "5")
        zs_items.append((hydrate_input(raw, zs_template),
                         taskid2seed(taskid)))
    h0 = zs_items[0][0]
    check((h0["num_frames"], h0["width"], h0["height"]) ==
          (ZS_FRAMES, ZS_WIDTH, ZS_HEIGHT),
          f"zeroscopev2xl's template default is not {ZS_FRAMES} frames at "
          f"{ZS_WIDTH}x{ZS_HEIGHT}: {h0}")
    zs_want = expected_launches(torch, flash, video_attention_shapes(
        ZS_WIDTH, ZS_HEIGHT, ZS_FRAMES, ZS_STEPS))
    zs = build("zeroscopev2xl")
    clock = video_clock(torch, zs.runner.pipeline.models)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    got = []
    for chunk in ([0, 1, 2, 3], [4, 0, 5]):
        flash.reset_launches()
        out = solve_cid_batch(zs, [zs_items[i] for i in chunk],
                              canonical_batch=CANONICAL_BATCH)
        check(flash.flash_attention.launches_by_route == zs_want,
              f"zeroscopev2xl: launches "
              f"{flash.flash_attention.launches_by_route}, expected "
              f"{zs_want}")
        got.append(out[chunk.index(0)][0])
    zs_s = time.perf_counter() - t0
    check(got[0] == got[1], f"zeroscopev2xl: task 0's CID {got[0]} among "
          f"neighbours 1-3, {got[1]} among 4 and 5")
    check(clock.images_ok(2 * zs_want["tensor_core_wgmma_wide"]),
          "zeroscopev2xl: non-finite or constant frames")
    zs_stages = clock.read()
    print(f"video zeroscopev2xl: {ZS_FRAMES} frames at "
          f"{ZS_WIDTH}x{ZS_HEIGHT}, {ZS_STEPS} steps, guidance 17.5: task "
          f"0 keeps CID {got[0]} among different neighbours; launches per "
          f"chunk {zs_want}; two chunks in {zs_s:.1f} s; per chunk, device "
          "seconds and peak GiB allocated per stage "
          + json.dumps([{k: round(v, 3) for k, v in c.items()}
                        for c in zs_stages])
          + f"; {card}", flush=True)
    del zs, clock
    gc.collect()
    torch.cuda.empty_cache()
    print(f"video: phase 9 in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return {"launches": launches, "launches_node": node_launches}


# phase 10, textgen: the MiningConfig default sequence edges (prompt 32/64
# x decode 16/32) for both samplers at the canonical batch
TG_PROMPT_EDGES, TG_DECODE_EDGES = (32, 64), (16, 32)
TG_SAMPLERS = ("greedy", "top_k")
TG_REPS = 5             # timed chunks per bucket and path
TG_GOLDEN_FILE = "arbius_tpu_torch/goldens/textgen.h100.bfloat16.json"
TG_GOLDEN_INPUT = {"prompt": "arbius test cat"}
TG_PROMPTS = ["once upon a time", "the lighthouse keeper said",
              "a list of rivers:", "def main():"]


def textgen_inputs() -> list[dict]:
    """Phase 10's six template inputs, over four buckets: (prompt edge,
    decode edge, sampler) = (32, 16, greedy) x 2, (32, 32, top_k) x 2,
    (64, 32, greedy), (64, 16, top_k)."""
    long = "a lighthouse on a cliff at dusk, waves below"   # 45 bytes
    return [{"prompt": "once upon a time"},
            {"prompt": "the sea", "max_new_tokens": 8},
            {"prompt": "a list of rivers:", "max_new_tokens": 32,
             "sampler": "top_k"},
            {"prompt": "tell me a story", "max_new_tokens": 20,
             "sampler": "top_k"},
            {"prompt": long, "max_new_tokens": 30},
            {"prompt": long + "!", "max_new_tokens": 12,
             "sampler": "top_k"}]


def phase_textgen_small_reference(torch) -> None:
    """The tiny float32 textgen config on the card (its captured graphs)
    and on the CPU from the same weights: identical token ids."""
    import dataclasses

    from arbius_tpu_torch.models.textgen import TextGenConfig, TextGenPipeline

    cfg = dataclasses.replace(TextGenConfig.tiny(), dtype="float32")
    pipes = [TextGenPipeline(cfg, device=dev) for dev in ("cpu", "cuda")]
    params = pipes[0].init_params(seed=0)
    for pipe in pipes:
        pipe.load_params(params)
    seeds = [1, 2**40 + 3, 7, 0x1FFFFFFFFFFFEF]
    for sampler in TG_SAMPLERS:
        for p in TG_PROMPT_EDGES:
            got = [pipe.generate(TG_PROMPTS, seeds, prompt_bucket=p,
                                 decode_bucket=32, sampler=sampler)
                   for pipe in pipes]
            check((got[0] == got[1]).all(), f"textgen small reference: "
                  f"{sampler} at prompt edge {p}: card ids {got[1]} != "
                  f"CPU ids {got[0]}")
    print("textgen small reference: tiny f32, card (CUDA graphs) vs CPU: "
          "identical token ids, both samplers, prompt edges 32 and 64, "
          "decode edge 32", flush=True)


def phase_textgen(torch, flash) -> dict:
    """Phase 10: textgen at full width (TextGenConfig(), bf16 weights).
    The small reference; then each of the eight buckets (prompt 32/64 x
    decode 16/32 x greedy/top-k, canonical batch 4): the captured graph
    against the eager loop (identical ids, and again after a replay with
    other prompts), chunk latency and tokens/s for both, device ms by
    CUDA events, launches per chunk and the idle share from a traced
    chunk of each; prefix stability between decode 16 and 32; six
    template tasks over four buckets solved one by one and by a fresh
    registry in other groupings (identical CIDs); a MinerNode on
    LocalChain boots with the committed golden (re-recorded where the
    build differs), mines the six and claims them, each on-chain CID the
    direct solve's. No flash kernel runs. Returns the flash launches of
    the main path and of the node's mining."""
    import tempfile

    from arbius_tpu_torch.chain import WAD
    from arbius_tpu_torch.cli import build_info, record_golden
    from arbius_tpu_torch.l0 import taskid2seed
    from arbius_tpu_torch.node import (
        LocalChain,
        MinerNode,
        MiningConfig,
        ModelConfig,
        build_registry,
        solve_cid_batch,
    )
    from arbius_tpu_torch.node.solver import bucket_key
    from arbius_tpu_torch.templates import hydrate_input, load_template
    from arbius_tpu_torch.utils import card_info

    card = card_info()
    t_phase = time.perf_counter()
    phase_textgen_small_reference(torch)

    def config(mid="0x" + "00" * 32, golden=None):
        return MiningConfig(canonical_batch=CANONICAL_BATCH, models=(
            ModelConfig(id=mid, template="textgen", weights_dtype="bfloat16",
                        golden=golden),))

    def build(mid="0x" + "00" * 32):
        return build_registry(config(mid), device="cuda").get(mid)

    model = build()
    pipe = model.runner.pipeline
    check(pipe.prompt_buckets == TG_PROMPT_EDGES and
          pipe.decode_buckets == TG_DECODE_EDGES,
          f"MiningConfig's textgen edges are not {TG_PROMPT_EDGES} x "
          f"{TG_DECODE_EDGES}")
    n_params = sum(p.numel() for p in pipe.model.parameters())
    print(f"textgen: built TextGenConfig() ({n_params} parameters, bf16 "
          "weights)", flush=True)
    seeds = [11, 2**40 + 3, 977, 0x1FFFFFFFFFFFEF]
    other = [p[::-1] for p in TG_PROMPTS]
    flash.reset_launches()
    rows = []

    def timed(fn) -> tuple[float, float]:
        """Host seconds to tokens on the host, and the device ms between
        two CUDA events around the enqueue."""
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        a.record()
        fn()
        b.record()
        b.synchronize()
        return time.perf_counter() - t0, a.elapsed_time(b)

    for p in TG_PROMPT_EDGES:
        for t in TG_DECODE_EDGES:
            for sampler in TG_SAMPLERS:
                kw = dict(prompt_bucket=p, decode_bucket=t, sampler=sampler)
                t0 = time.perf_counter()
                graph = pipe.generate(TG_PROMPTS, seeds, **kw)
                capture_s = time.perf_counter() - t0
                eager = pipe.generate(TG_PROMPTS, seeds, eager=True, **kw)
                check((graph == eager).all(), f"textgen {kw}: the graph's "
                      f"ids {graph} != the eager loop's {eager}")
                again = pipe.generate(other, seeds[::-1], **kw)
                check((again == pipe.generate(other, seeds[::-1], eager=True,
                                              **kw)).all(),
                      f"textgen {kw}: a replay with other prompts differs "
                      "from the eager loop")
                g = [timed(lambda: pipe.generate(TG_PROMPTS, seeds, **kw))
                     for _ in range(TG_REPS)]
                e = [timed(lambda: pipe.generate(TG_PROMPTS, seeds,
                                                 eager=True, **kw))
                     for _ in range(TG_REPS)]
                med = {name: (statistics.median(x[0] for x in runs),
                              statistics.median(x[1] for x in runs))
                       for name, runs in (("graph", g), ("eager", e))}
                rows.append((p, t, sampler, capture_s, med))
                print(f"textgen bucket p{p} t{t} {sampler}: graph == eager "
                      f"(and after a replay with other prompts); capture "
                      f"{capture_s:.3f} s; p50 per chunk of "
                      f"{CANONICAL_BATCH} graph {med['graph'][0] * 1e3:.3f} "
                      f"ms ({CANONICAL_BATCH * t / med['graph'][0]:.1f} "
                      f"tokens/s, device {med['graph'][1]:.3f} ms), eager "
                      f"{med['eager'][0] * 1e3:.3f} ms "
                      f"({CANONICAL_BATCH * t / med['eager'][0]:.1f} "
                      f"tokens/s, device {med['eager'][1]:.3f} ms); {card}",
                      flush=True)
    # launches and idle share: one traced chunk of each path at the
    # largest bucket
    kw = dict(prompt_bucket=64, decode_bucket=32, sampler="top_k")
    traces = {}
    check(rows[-1][:3] == (64, 32, "top_k"), "textgen: the last bucket "
          "timed is not p64 t32 top_k")
    span = {name: ms for name, (_, ms) in rows[-1][4].items()}
    for name, eager in (("graph", False), ("eager", True)):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            pipe.generate(TG_PROMPTS, seeds, eager=eager, **kw)
            torch.cuda.synchronize()
        host_launches = sum(
            e.count for e in prof.key_averages()
            if e.key in ("cudaLaunchKernel", "cudaGraphLaunch",
                         "cudaLaunchKernelExC"))
        with tempfile.TemporaryDirectory() as work:
            path = pathlib.Path(work) / "chunk.json"
            prof.export_chrome_trace(str(path))
            traces[name] = device_trace_summary(json.loads(path.read_text()))
        traces[name]["host_launches"] = host_launches
        idle = 1.0 - traces[name]["busy_ms"] / span[name]
        traces[name]["idle_share_events"] = idle
        print(f"textgen traced chunk p64 t32 top_k, {name}: "
              f"{host_launches} launches from the host, "
              f"{traces[name]['kernels']} kernels on the card, busy "
              f"{traces[name]['busy_ms']:.3f} ms; against the untraced "
              f"chunk's {span[name]:.3f} ms between CUDA events an idle "
              f"share of {idle:.3f} (traced span "
              f"{traces[name]['span_ms']:.3f} ms); top "
              + json.dumps(traces[name]["top"][:4]) + f"; {card}",
              flush=True)
    check(traces["graph"]["kernels"] > 0 and traces["eager"]["kernels"] > 0,
          f"textgen: no kernels traced: {traces}")
    # prefix stability on the card
    for sampler in TG_SAMPLERS:
        for p in TG_PROMPT_EDGES:
            short, long = (pipe.generate(TG_PROMPTS, seeds, prompt_bucket=p,
                                         decode_bucket=t, sampler=sampler)
                           for t in TG_DECODE_EDGES)
            check((long[:, :TG_DECODE_EDGES[0]] == short).all(),
                  f"textgen: decode 32's prefix != decode 16 ({sampler}, "
                  f"prompt edge {p})")
    print("textgen prefix stability: decode 32's first 16 tokens equal "
          "decode 16's at both prompt edges, both samplers", flush=True)
    launches = dict(flash.flash_attention.launches_by_route)
    check(not any(launches.values()),
          f"textgen launched flash kernels: {launches}")

    # the runner: six tasks, each alone, then a fresh registry's groups
    template = load_template("textgen")
    miner, user = "0x" + "aa" * 20, "0x" + "01" * 20
    inputs = textgen_inputs()
    tids = template_world(inputs, miner, user, "textgen")[3]()
    items = [(model.runner.prepare_hydrated(hydrate_input(dict(raw),
                                                          template)),
              taskid2seed(tid)) for raw, tid in zip(inputs, tids)]
    buckets = {}
    for i, (h, _) in enumerate(items):
        buckets.setdefault(bucket_key("m", h), []).append(i)
    check(len(buckets) == 4, f"textgen: six tasks in {len(buckets)} "
          "buckets, not 4")
    t0 = time.perf_counter()
    cids = [solve_cid_batch(model, [item],
                            canonical_batch=CANONICAL_BATCH)[0][0]
            for item in items]
    alone_s = time.perf_counter() - t0
    fresh = build()
    for idx in buckets.values():
        idx = idx[::-1]
        again = solve_cid_batch(fresh, [items[i] for i in idx],
                                canonical_batch=CANONICAL_BATCH)
        for i, (cid, _) in zip(idx, again):
            check(cid == cids[i], f"textgen task {i}: CID {cid} != "
                  f"{cids[i]} (fresh registry, group {idx})")
    print(f"textgen: six tasks over {len(buckets)} buckets solved one per "
          f"chunk in {alone_s:.3f} s; a fresh registry's reordered "
          "bucket groups give identical CIDs: " + " ".join(cids),
          flush=True)

    # node: golden, boot with the self-test, mine, claim
    committed = json.loads(
        (pathlib.Path(__file__).resolve().parent / TG_GOLDEN_FILE)
        .read_text())
    check(committed["golden"]["input"] == TG_GOLDEN_INPUT
          and committed["golden"]["seed"] == GOLDEN_SEED
          and committed["canonical_batch"] == CANONICAL_BATCH
          and committed["template"] == "textgen",
          f"{TG_GOLDEN_FILE} is not the vector phase 10 boots with")
    build_now = {k: build_info("cuda").get(k) for k in BUILD_FIELDS}
    built = {k: committed["build"].get(k) for k in BUILD_FIELDS}
    if build_now == built:
        golden, source = committed["golden"], TG_GOLDEN_FILE
    else:
        golden = record_golden(fresh, TG_GOLDEN_INPUT, GOLDEN_SEED,
                               canonical_batch=CANONICAL_BATCH,
                               device="cuda")["golden"]
        source = f"re-recorded here: this build {build_now} is not {built}"
    tok, eng, mid, submit = template_world(inputs, miner, user, "textgen")
    chain = LocalChain(eng, miner)
    chain.validator_deposit(100 * WAD)
    cfg = config(mid, golden)
    node = MinerNode(chain, cfg, build_registry(cfg, device="cuda"))
    t0 = time.perf_counter()
    node.boot()
    print(f"textgen node: booted with golden {golden['cid']} ({source}); "
          f"self-test passed in {time.perf_counter() - t0:.3f} s",
          flush=True)
    check(submit() == tids, "textgen: the second world's taskids differ")
    flash.reset_launches()
    t0 = time.perf_counter()
    while node.tick():
        pass
    mine_s = time.perf_counter() - t0
    node_launches = dict(flash.flash_attention.launches_by_route)
    check(not any(node_launches.values()),
          f"textgen node launched flash kernels: {node_launches}")
    check(node.db.failed_jobs() == [],
          f"textgen node: failed jobs {node.db.failed_jobs()}")
    for tid, want_cid in zip(tids, cids):
        sol = eng.solutions.get(bytes.fromhex(tid[2:]))
        check(sol is not None and "0x" + sol.cid.hex() == want_cid,
              f"textgen task {tid}: on-chain {sol} != direct {want_cid}")
    bal0 = tok.balance_of(miner)
    eng.advance_time(eng.min_claim_solution_time
                     + cfg.claim_delay_buffer + 1)
    while node.tick():
        pass
    rise = tok.balance_of(miner) - bal0
    check(node.metrics.solutions_claimed == len(tids)
          and rise == len(tids) * TASK_FEE * WAD * 9 // 10,
          f"textgen node: claimed {node.metrics.solutions_claimed} of "
          f"{len(tids)}, +{rise}")
    node.close()
    print(f"textgen node: mined {len(tids)} tasks over {len(buckets)} "
          f"buckets in {mine_s:.3f} s host time from the first tick to the "
          f"last reveal; on-chain CIDs equal the direct solve's; claimed "
          f"{len(tids)}, +{rise / WAD:g} AIUS; {card}", flush=True)
    del model, fresh, node, pipe
    gc.collect()
    torch.cuda.empty_cache()
    print(f"textgen: phase 10 in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return {"launches": launches, "launches_node": node_launches,
            "buckets": rows, "traces": traces}


# phase 11, robust_video_matting: a "1080p stream" at 1088x1920 (the
# multiple of 16 nearest 1080 that matte accepts) through shrink and
# refine (base 288x512), and a 512x512 clip on the direct path
RVM_HD = (48, 1088, 1920)
RVM_SQ = (16, 512, 512)
RVM_PROBE = "8x128x128"    # MiningConfig.example.json's probe shape
RVM_GOLDEN_FILE = ("arbius_tpu_torch/goldens/"
                   "robust_video_matting.h100.bfloat16.json")


def phase_rvm_small_reference(torch) -> None:
    """The tiny float32 RVM config on the card and on the CPU from the
    same weights, on the direct path and through shrink and refine:
    uint8 frames within one level."""
    import dataclasses

    import numpy as np

    from arbius_tpu_torch.models.rvm import (
        RVMConfig,
        RVMPipeline,
        RVMPipelineConfig,
    )

    cfg = RVMPipelineConfig(model=dataclasses.replace(RVMConfig.tiny(),
                                                      dtype="float32"))
    pipes = [RVMPipeline(cfg, device=dev) for dev in ("cpu", "cuda")]
    params = pipes[0].init_params(seed=0)
    for pipe in pipes:
        pipe.load_params(params)
    rng = np.random.default_rng(0)
    for t, h, w in ((3, 64, 64), (2, 64, 576)):
        video = rng.integers(0, 256, (t, h, w, 3), dtype=np.uint8)
        a, b = (pipe.matte(video).astype(int) for pipe in pipes)
        diff = abs(a - b)
        print(f"rvm small reference: tiny f32 {t} frames {h}x{w} (base "
              f"{pipes[1].base_hw(h, w)}), card vs CPU: max uint8 diff "
              f"{diff.max()}, differing fraction {(diff > 0).mean():.6f}",
              flush=True)
        check(diff.max() <= 1, "tiny RVM card matte disagrees with the CPU")


def phase_rvm(torch, flash) -> dict:
    """Phase 11: robust_video_matting at full width (RVMConfig(), bf16
    weights). The small reference; then an avc1 clip of probe_clip(48,
    1088, 1920) through shrink and refine and a 16-frame 512x512 clip on
    the direct path, each solved by the runner on a model and on a fresh
    one with identical bytes, with the host's demux + decode and encode
    seconds, frames/s, device ms per frame (CUDA events), launches per
    frame and the idle share (a traced matte), and the peak GiB; a node
    with no content store boots with the committed probe golden
    (re-recorded where the build differs), and a node with a store mines
    tasks whose inputs are pinned to it, each on-chain CID the direct
    solve's. No flash kernel runs. Returns the flash launches of the
    main path and of the node's mining."""
    import tempfile

    from arbius_tpu_torch.chain import WAD
    from arbius_tpu_torch.cli import build_info, record_golden
    from arbius_tpu_torch.codecs import encode_mp4, encode_mp4_h264
    from arbius_tpu_torch.codecs.mp4_demux import decode_video_mp4
    from arbius_tpu_torch.codecs.probe import probe_clip
    from arbius_tpu_torch.l0.base58 import b58encode
    from arbius_tpu_torch.l0.cid import (
        cid_hex,
        cid_of_solution_files,
        dag_of_file,
    )
    from arbius_tpu_torch.node import (
        LocalChain,
        MinerNode,
        MiningConfig,
        ModelConfig,
        build_registry,
        solve_cid,
    )
    from arbius_tpu_torch.node.factory import probe_golden_input
    from arbius_tpu_torch.node.store import ContentStore
    from arbius_tpu_torch.templates import hydrate_input, load_template
    from arbius_tpu_torch.utils import card_info

    card = card_info()
    t_phase = time.perf_counter()
    phase_rvm_small_reference(torch)
    template = load_template("robust_video_matting")
    blobs = {}

    def pin(blob: bytes) -> str:
        cid = b58encode(dag_of_file(blob).cid)
        blobs[cid] = blob
        return cid

    def config(mid="0x" + "00" * 32, golden=None):
        return MiningConfig(canonical_batch=CANONICAL_BATCH, models=(
            ModelConfig(id=mid, template="robust_video_matting",
                        weights_dtype="bfloat16", golden=golden),))

    def build(resolve=blobs.get, mid="0x" + "00" * 32, golden=None):
        return build_registry(config(mid, golden), device="cuda",
                              resolve_file=resolve).get(mid)

    model = build()
    pipe = model.runner.pipeline
    n_params = sum(p.numel() for p in pipe.step.state_dict().values())
    print(f"rvm: built RVMConfig() ({n_params} parameters, bf16 weights)",
          flush=True)
    flash.reset_launches()
    stats = {}
    for name, (t, h, w) in (("1088x1920", RVM_HD), ("512x512", RVM_SQ)):
        t0 = time.perf_counter()
        blob = encode_mp4_h264(probe_clip(t, h, w), fps=8)
        make_s = time.perf_counter() - t0
        cid = pin(blob)
        hydrated = hydrate_input({"input_video": cid}, template)
        t0 = time.perf_counter()
        video = decode_video_mp4(blob)
        decode_s = time.perf_counter() - t0
        check(video.shape == (t, h, w, 3), f"rvm: decoded {video.shape}")
        src = pipe.to_device(video)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        a.record()
        alphas, fgrs = pipe.frames(src)
        b.record()
        b.synchronize()
        frames_s = time.perf_counter() - t0
        device_ms = a.elapsed_time(b)
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(bool(torch.isfinite(alphas).all() and torch.isfinite(fgrs).all())
              and float(alphas.std()) > 0, f"rvm {name}: non-finite or "
              "flat matte")
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            pipe.frames(src)
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as work:
            path = pathlib.Path(work) / "matte.json"
            prof.export_chrome_trace(str(path))
            trace = device_trace_summary(json.loads(path.read_text()))
        # the runner's steps one by one (matte: frames + the host's
        # composition), then the runner itself on a fresh model
        t0 = time.perf_counter()
        out = pipe.matte(video)
        matte_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        files = {"out-1.mp4": encode_mp4_h264(out, fps=8)}
        encode_s = time.perf_counter() - t0
        cid_a = cid_hex(cid_of_solution_files(files))
        del src, alphas, fgrs, video, out
        t0 = time.perf_counter()
        cid_b, _ = solve_cid(build(), hydrated, 0)
        solve_s = time.perf_counter() - t0
        check(cid_a == cid_b and files["out-1.mp4"][4:8] == b"ftyp",
              f"rvm {name}: CID {cid_a} != a fresh model's runner's {cid_b}")
        busy = trace["busy_ms"] / t
        stats[name] = {"frames": t, "base": pipe.base_hw(h, w),
                       "card_span_ms_per_frame": device_ms / t,
                       "busy_ms_per_frame": busy,
                       "frames_per_s": t / frames_s,
                       "kernels_per_frame": trace["kernels"] / t,
                       "idle_share": 1.0 - busy * t / device_ms,
                       "peak_gib": peak, "decode_s": decode_s,
                       "matte_s": matte_s, "encode_s": encode_s,
                       "solve_s": solve_s}
        print(f"rvm {name} x {t} frames (base {pipe.base_hw(h, w)}): "
              f"{t / frames_s:.2f} frames/s on the host clock; per frame "
              f"{device_ms / t:.3f} ms between CUDA events around the "
              f"frames, {busy:.3f} ms of it busy (traced, "
              f"{trace['kernels'] / t:.1f} kernels a frame): idle share "
              f"{stats[name]['idle_share']:.3f}; peak {peak:.2f} GiB "
              f"allocated; host: avc1 clip made in {make_s:.2f} s, demux + "
              f"decode {decode_s:.2f} s, matte (frames + composition) "
              f"{matte_s:.2f} s, H.264 + MP4 encode {encode_s:.2f} s; a "
              f"fresh model's runner (decode, matte, encode) {solve_s:.2f} "
              f"s to the same CID {cid_a}; top "
              + json.dumps(trace["top"][:4]) + f"; {card}", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    launches = dict(flash.flash_attention.launches_by_route)
    check(not any(launches.values()),
          f"rvm launched flash kernels: {launches}")

    # node: the probe golden, a boot with no store, mining from a store
    resolve, probe_raw = probe_golden_input(RVM_PROBE)
    committed = json.loads(
        (pathlib.Path(__file__).resolve().parent / RVM_GOLDEN_FILE)
        .read_text())
    check(committed["golden"]["input"] == probe_raw
          and committed["golden"]["probe_video"] == RVM_PROBE
          and committed["golden"]["seed"] == GOLDEN_SEED
          and committed["template"] == "robust_video_matting",
          f"{RVM_GOLDEN_FILE} is not the vector phase 11 boots with")
    build_now = {k: build_info("cuda").get(k) for k in BUILD_FIELDS}
    built = {k: committed["build"].get(k) for k in BUILD_FIELDS}
    if build_now == built:
        golden, source = committed["golden"], RVM_GOLDEN_FILE
    else:
        golden = dict(record_golden(
            build(resolve), probe_raw, GOLDEN_SEED,
            canonical_batch=CANONICAL_BATCH, device="cuda")["golden"],
            probe_video=RVM_PROBE)
        source = f"re-recorded here: this build {build_now} is not {built}"
    miner, user = "0x" + "aa" * 20, "0x" + "01" * 20
    clips = [encode_mp4_h264(probe_clip(8, 256, 256), fps=8),
             encode_mp4(probe_clip(8, 128, 128), fps=8),
             encode_mp4_h264(probe_clip(8, 576, 1024), fps=8)]
    inputs = [{"input_video": pin(c), "output_type": o} for c, o in
              zip(clips, ("green-screen", "alpha-mask", "foreground-mask"))]
    direct = [solve_cid(model, hydrate_input(dict(raw), template), 0)[0]
              for raw in inputs]
    del model, pipe
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        # a world of its own: a closed node stays subscribed to its chain
        eng, mid = template_world([], miner, user,
                                  "robust_video_matting")[1:3]
        cfg = config(mid, golden)
        bare = MinerNode(LocalChain(eng, miner), cfg,
                         build_registry(cfg, device="cuda"))
        check(bare.store is None, "rvm: the bare node has a store")
        t0 = time.perf_counter()
        bare.boot()
        print(f"rvm node: booted with no store and golden {golden['cid']} "
              f"({source}, the probe clip {RVM_PROBE} made from the "
              f"vector); self-test passed in {time.perf_counter() - t0:.2f} "
              "s", flush=True)
        bare.close()
        tok, eng, mid, submit = template_world(inputs, miner, user,
                                               "robust_video_matting")
        cfg = config(mid, golden)
        store = ContentStore(work)
        for blob in clips:
            store.put_blob(blob)
        chain = LocalChain(eng, miner)
        chain.validator_deposit(100 * WAD)
        node = MinerNode(chain, cfg, build_registry(
            cfg, device="cuda", resolve_file=store.get_file), store=store)
        node.boot()
        tids = submit()
        flash.reset_launches()
        t0 = time.perf_counter()
        while node.tick():
            pass
        mine_s = time.perf_counter() - t0
        node_launches = dict(flash.flash_attention.launches_by_route)
        check(not any(node_launches.values()),
              f"rvm node launched flash kernels: {node_launches}")
        check(node.db.failed_jobs() == [],
              f"rvm node: failed jobs {node.db.failed_jobs()}")
        for tid, want_cid in zip(tids, direct):
            sol = eng.solutions.get(bytes.fromhex(tid[2:]))
            check(sol is not None and "0x" + sol.cid.hex() == want_cid,
                  f"rvm task {tid}: on-chain {sol} != direct {want_cid}")
        node.close()
    print(f"rvm node: mined {len(tids)} tasks (avc1 256x256 green-screen, "
          f"MJPEG 128x128 alpha-mask, avc1 576x1024 foreground-mask, 8 "
          f"frames each) from its store in {mine_s:.2f} s host time from "
          f"the first tick to the last reveal; on-chain CIDs equal the "
          f"direct solve's; {card}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"rvm: phase 11 in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return {"launches": launches, "launches_node": node_launches,
            "stats": stats}


# phase 12, precision modes: the int8 and fp8 boot self-test vectors the
# port commits, by (template, mode): the golden input (seed GOLDEN_SEED,
# bf16 weights, canonical batch CANONICAL_BATCH), which
# `record_precision_golden` records. Each must tell its mode from bf16:
# textgen's greedy tokens at TG_GOLDEN_INPUT are the same in int8 as in
# bf16 on the H100, and so are its 16 top_k tokens, so its int8 vector
# samples 32 top_k tokens, where they differ
TG_INT8_GOLDEN_INPUT = {"prompt": "arbius test cat", "max_new_tokens": 32,
                        "sampler": "top_k"}
PRECISION_GOLDENS = {("anythingv3", "int8"): GOLDEN_INPUT,
                     ("anythingv3", "fp8"): GOLDEN_INPUT,
                     ("kandinsky2", "int8"): K2_GOLDEN_INPUT,
                     ("damo", "int8"): VIDEO_GOLDEN_INPUT,
                     ("textgen", "int8"): TG_INT8_GOLDEN_INPUT}
# each template's committed bf16 vector and its input
BF16_GOLDENS = {"anythingv3": (GOLDEN_FILE, GOLDEN_INPUT),
                "kandinsky2": (K2_GOLDEN_FILE, K2_GOLDEN_INPUT),
                "damo": (VIDEO_GOLDEN_FILE, VIDEO_GOLDEN_INPUT),
                "textgen": (TG_GOLDEN_FILE, TG_GOLDEN_INPUT)}
# the steps of the chunk whose peak memory phase 12 reads: every step
# runs the same operations on the same live tensors, so the peak does
# not depend on the count
PEAK_STEPS = 2
# allocations a node keeps beside its weights: a 32 MiB cuBLAS workspace
# per stream (CUBLAS_WORKSPACE_CONFIG=:4096:8), and textgen warms each
# captured graph up on a stream of its own (264 MiB after mining four
# buckets on the H100); phase 12 holds what mining leaves behind under
# the larger of this and half the full-width weights
KEPT_BYTES = 512 << 20


def precision_golden_file(template: str, mode: str) -> str:
    return f"arbius_tpu_torch/goldens/{template}.h100.{mode}.json"


def record_precision_golden(torch, template: str, mode: str) -> dict:
    """The boot self-test vector of `template` in `mode` on this card:
    record-golden's function (`cli.record_golden`; record-golden itself
    has no precision flag, as the reference's has none) over a registry
    built from a MiningConfig whose `precision` names the mode, at the
    PRECISION_GOLDENS input. Written, in the committed files' format,
    to chiprun_out/goldens/ beside this script, from where a new vector
    is committed under arbius_tpu_torch/goldens/. Phase 12 calls it
    where the card's build is not the committed vector's; with the
    kernels built, `python3 -c "import torch, chip_smoke;
    chip_smoke.record_precision_golden(torch, 'textgen', 'int8')"`
    records one alone."""
    from arbius_tpu_torch.cli import record_golden

    cfg = precision_config(template, mode)
    registry, _, _ = resident_build(torch, cfg)
    rec = record_golden(registry.get(cfg.models[0].id),
                        PRECISION_GOLDENS[template, mode], GOLDEN_SEED,
                        canonical_batch=CANONICAL_BATCH, device="cuda")
    vector = {"template": template, "tiny": False,
              "weights_dtype": cfg.models[0].weights_dtype,
              "precision": mode, "canonical_batch": CANONICAL_BATCH, **rec}
    out = pathlib.Path(__file__).resolve().parent / "chiprun_out" / "goldens"
    out.mkdir(parents=True, exist_ok=True)
    (out / pathlib.Path(precision_golden_file(template, mode)).name) \
        .write_text(json.dumps(vector, sort_keys=True) + "\n")
    del registry
    gc.collect()
    torch.cuda.empty_cache()
    return vector


def precision_config(template: str, mode: str, mid: str = "0x" + "00" * 32,
                     golden: dict | None = None):
    """One model of `template` served in precision `mode` at full width
    (seeded random weights, bf16) and the canonical batch."""
    from arbius_tpu_torch.node import MiningConfig, ModelConfig
    from arbius_tpu_torch.node.config import PrecisionConfig

    return MiningConfig(
        canonical_batch=CANONICAL_BATCH,
        precision=PrecisionConfig(templates={template: mode}),
        models=(ModelConfig(id=mid, template=template,
                            weights_dtype="bfloat16", golden=golden),))


def resident_build(torch, cfg):
    """(the registry `cfg` builds on the card, the bytes allocated before
    the build, the bytes its one model leaves allocated: the resident
    weights)."""
    from arbius_tpu_torch.node import build_registry

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    registry = build_registry(cfg, device="cuda")
    gc.collect()
    torch.cuda.synchronize()
    return registry, base, torch.cuda.memory_allocated() - base


def chunk_peak(torch, pipe, template: str) -> tuple[int, int]:
    """(peak bytes allocated over one canonical batch of `template`
    straight through its pipeline at PEAK_STEPS steps, the bytes
    allocated once its output is dropped)."""
    prompts = [f"a lighthouse, memory study {i}"
               for i in range(CANONICAL_BATCH)]
    seeds = list(range(1, CANONICAL_BATCH + 1))
    if template == "textgen":
        args = (prompts, seeds)
        kw = dict(prompt_bucket=32, decode_bucket=16)
    else:
        args = (prompts, [""] * CANONICAL_BATCH
                if template == "anythingv3" else None, seeds)
        kw = {"anythingv3": dict(width=SIZE, height=SIZE,
                                 scheduler=SCHEDULER),
              "kandinsky2": dict(width=K2_SIZE, height=K2_SIZE),
              "damo": dict(num_frames=VIDEO_FRAMES, width=VIDEO_SIZE,
                           height=VIDEO_SIZE)}[template]
        kw["num_inference_steps"] = PEAK_STEPS
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = pipe.generate(*args, as_device=True, **kw)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del out
    gc.collect()
    torch.cuda.synchronize()
    return peak, torch.cuda.memory_allocated()


def dequant_cost(torch, quantized) -> dict:
    """The dequantization a quantized bucket program begins with, alone
    on the card: device ms between CUDA events (median of 5 runs), and
    the kernels and busy ms of one run traced by torch.profiler."""
    import tempfile

    times = []
    for _ in range(5):
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        with quantized.dequantized():
            end.record()
            torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        with quantized.dequantized():
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as work:
        path = pathlib.Path(work) / "dequant.json"
        prof.export_chrome_trace(str(path))
        trace = device_trace_summary(json.loads(path.read_text()))
    return {"ms": statistics.median(times), "kernels": trace["kernels"],
            "busy_ms": trace["busy_ms"], "leaves": len(quantized.leaves)}


def full_width_bytes(quantized) -> int:
    """Bytes of the quantized leaves in their parameters' dtypes."""
    return sum(leaf["qv"].numel() * p.element_size()
               for p, leaf, _ in quantized.leaves)


def precision_node(torch, flash, template: str, mode: str,
                   inputs: list[dict], want: dict) -> dict:
    """A MinerNode on LocalChain serving `template` in `mode`, booted with
    the committed golden (re-recorded where the build differs): its
    self-test launches the flash kernels of one chunk (`want`); it mines
    `inputs` from TaskSubmitted through claim, each chunk launching
    `want`; the cost model's rows and `arbius_precision_models` carry the
    mode; no full-width weights outlive a chunk. Returns the model, the
    mined items and CIDs, launches, resident bytes and times."""
    from arbius_tpu_torch.chain import WAD
    from arbius_tpu_torch.cli import build_info
    from arbius_tpu_torch.l0 import taskid2seed
    from arbius_tpu_torch.node import LocalChain, MinerNode
    from arbius_tpu_torch.node.solver import bucket_key
    from arbius_tpu_torch.templates import hydrate_input

    path = precision_golden_file(template, mode)
    committed = json.loads(
        (pathlib.Path(__file__).resolve().parent / path).read_text())
    raw = PRECISION_GOLDENS[template, mode]
    check(committed["golden"]["input"] == raw
          and committed["golden"]["seed"] == GOLDEN_SEED
          and committed["canonical_batch"] == CANONICAL_BATCH
          and committed["template"] == template
          and committed["precision"] == mode
          and committed["weights_dtype"] == "bfloat16",
          f"{path} is not the vector phase 12 boots with")
    build_now = {k: build_info("cuda").get(k) for k in BUILD_FIELDS}
    built = {k: committed["build"].get(k) for k in BUILD_FIELDS}
    if build_now == built:
        golden, source = committed["golden"], path
    else:
        golden = record_precision_golden(torch, template, mode)["golden"]
        source = (f"re-recorded here into chiprun_out/goldens/: this build "
                  f"{build_now} is not {built}")

    miner, user = "0x" + "ac" * 20, "0x" + "02" * 20
    tok, eng, mid, submit = template_world(inputs, miner, user, template)
    chain = LocalChain(eng, miner)
    chain.validator_deposit(100 * WAD)
    cfg = precision_config(template, mode, mid, golden)
    registry, base, resident = resident_build(torch, cfg)
    model = registry.get(mid)
    quantized = model.runner.pipeline.quantized
    check(quantized is not None and model.runner.pipeline.precision == mode,
          f"{template} {mode}: the pipeline holds full-width weights")
    node = MinerNode(chain, cfg, registry)
    flash.reset_launches()
    t0 = time.perf_counter()
    node.boot()
    boot_s = time.perf_counter() - t0
    check(flash.flash_attention.launches_by_route == want,
          f"{template} {mode} self-test launches "
          f"{flash.flash_attention.launches_by_route}, expected {want}")
    tids = submit()
    flash.reset_launches()
    t0 = time.perf_counter()
    while node.tick():
        pass
    mine_s = time.perf_counter() - t0
    launches = dict(flash.flash_attention.launches_by_route)
    items = []
    for raw_i, tid in zip(inputs, tids):
        hydrated = hydrate_input(dict(raw_i), model.template)
        prepare = getattr(model.runner, "prepare_hydrated", None)
        items.append((prepare(hydrated) if prepare else hydrated,
                      taskid2seed(tid)))
    keys = [bucket_key(mid, h, mode) for h, _ in items]
    n_chunks = sum(-(-keys.count(k) // CANONICAL_BATCH) for k in set(keys))
    check(node.db.failed_jobs() == [],
          f"{template} {mode} node: failed jobs {node.db.failed_jobs()}")
    check(launches == {r: n * n_chunks for r, n in want.items()},
          f"{template} {mode} node: launches {launches}, expected {want} x "
          f"{n_chunks}")
    onchain = []
    for tid in tids:
        sol = eng.solutions.get(bytes.fromhex(tid[2:]))
        check(sol is not None and sol.validator == miner,
              f"{template} {mode} task {tid} not solved by the miner: {sol}")
        cid = "0x" + sol.cid.hex()
        check(chain.generate_commitment(tid, cid) in eng.commitments,
              f"{template} {mode} task {tid}: no commitment matching {cid}")
        onchain.append(cid)
    bal0 = tok.balance_of(miner)
    eng.advance_time(eng.min_claim_solution_time
                     + cfg.claim_delay_buffer + 1)
    while node.tick():
        pass
    rise = tok.balance_of(miner) - bal0
    check(node.metrics.solutions_claimed == len(tids)
          and rise == len(tids) * TASK_FEE * WAD * 9 // 10,
          f"{template} {mode} node: claimed "
          f"{node.metrics.solutions_claimed} of {len(tids)}, +{rise}")
    modes = {r.mode for r in node.costmodel.rows.values()}
    served = _metric_sum(node.obs.registry.render(),
                         "arbius_precision_models", mode=mode)
    check(modes == {mode} and served == 1
          and all(k[6] == mode for k in
                  {bucket_key(mid, h, node.solve_mode(mid))
                   for h, _ in items}),
          f"{template} {mode} node: cost rows {modes}, "
          f"arbius_precision_models {served}")
    infer = sum(node.metrics.stage_seconds["infer"])
    node.close()
    del node
    gc.collect()
    torch.cuda.synchronize()
    kept = torch.cuda.memory_allocated() - base - resident
    full = full_width_bytes(quantized)
    check(quantized.emptied() and kept < max(full // 2, KEPT_BYTES),
          f"{template} {mode}: {kept} bytes beyond the resident weights "
          f"after mining (full width {full})")
    print(f"precision {template} {mode}: node booted with golden "
          f"{golden['cid']} ({source}), self-test passed in {boot_s:.2f} s; "
          f"mined {len(tids)} tasks in {len(set(keys))} buckets, "
          f"{n_chunks} chunks,"
          f" {mine_s:.2f} s host time from the first tick to the last "
          f"reveal (infer {infer:.3f} s); claimed {len(tids)}, "
          f"+{rise / WAD:g} AIUS; cost rows and arbius_precision_models "
          f"carry {mode}; flash launches {launches}; allocated beyond the "
          f"resident weights after mining {kept / (1 << 20):.1f} MiB "
          f"(full width {full / (1 << 20):.1f} MiB)", flush=True)
    return {"model": model, "registry": registry, "items": items,
            "golden": golden, "onchain": onchain, "launches": launches,
            "base": base,
            "resident": resident,
            "kept": kept, "full": full, "infer_s": infer,
            "n_chunks": n_chunks}


def phase_precision(torch, flash) -> dict:
    """Phase 12: the int8 and fp8 precision modes at full width. The tiny
    float32 int8 model on the card against the CPU; anythingv3 in int8
    and fp8 mined through a node booted with each committed golden, then
    `precision_anythingv3`'s fresh pipelines beside bf16 (CIDs, p50 and
    sol/h); kandinsky2 (768x768, 50 steps), damo (16 frames at 256x256,
    50 steps) and textgen in int8, each solved at its golden input by its
    node's self-test and mining six tasks (kandinsky2 and damo four)
    through claim; each mode's golden differs from bf16's at the same
    input; for each family and mode the resident weight bytes after the
    build and the peak over a PEAK_STEPS chunk (int8 resident below
    bf16's), and the dequantization's kernels and device ms. Every chunk
    launches the flash kernels of its bf16 twin. Returns the flash
    launches of the nodes' mining, summed."""
    from arbius_tpu_torch.cli import record_golden
    from arbius_tpu_torch.l0 import taskid2seed
    from arbius_tpu_torch.templates import hydrate_input, load_template
    from arbius_tpu_torch.utils import card_info

    card = card_info()
    t_phase = time.perf_counter()
    phase_small_reference(torch, "int8")
    gib = 1 << 30
    total = dict.fromkeys(flash.SOURCES, 0)
    memory, dequant, separated = {}, {}, {}

    def measure(template, mode, pipe, base, resident):
        # the chunk's peak above what the process held before the build
        peak, _ = chunk_peak(torch, pipe, template)
        memory[template, mode] = {"resident": resident,
                                  "resident_gib": resident / gib,
                                  "peak_gib": (peak - base) / gib}
        if pipe.quantized is not None:
            dequant[template, mode] = dequant_cost(torch, pipe.quantized)

    # each family's tasks and the flash launches of one of its chunks
    families = {
        "anythingv3": ([h for _, h, _ in tasks(
            load_template("anythingv3"), hydrate_input, taskid2seed)],
            expected_launches(torch, flash)),
        "kandinsky2": (k2_inputs()[:CANONICAL_BATCH], expected_launches(
            torch, flash, movq_attention_shapes(K2_SIZE, K2_SIZE))),
        "damo": (video_inputs(CANONICAL_BATCH),
                 expected_launches(torch, flash, DAMO_SHAPES)),
        "textgen": (textgen_inputs(), dict.fromkeys(flash.SOURCES, 0))}
    root = pathlib.Path(__file__).resolve().parent
    for template in dict.fromkeys(t for t, _ in PRECISION_GOLDENS):
        inputs, want = families[template]
        modes = [m for t, m in PRECISION_GOLDENS if t == template]
        registry, base, resident = resident_build(
            torch, precision_config(template, "bf16"))
        bf16 = registry.get("0x" + "00" * 32)
        measure(template, "bf16", bf16.runner.pipeline, base, resident)
        mined = {}
        for mode in modes:
            node = precision_node(torch, flash, template, mode, inputs, want)
            for r, n in node["launches"].items():
                total[r] += n
            mined[mode] = {k: node[k] for k in ("items", "onchain")}
            measure(template, mode, node["model"].runner.pipeline,
                    node["base"], node["resident"])
            check(node["resident"] < memory[template, "bf16"]["resident"],
                  f"{template} {mode}: resident {node['resident']} bytes, "
                  f"not below bf16's")
            # the mode is another determinism class: bf16's CID at the
            # golden's input is not the golden's (the committed bf16
            # vector where its input is the same, else solved here)
            raw = PRECISION_GOLDENS[template, mode]
            bf16_file, bf16_input = BF16_GOLDENS[template]
            if bf16_input == raw:
                bf16_cid = json.loads((root / bf16_file).read_text())[
                    "golden"]["cid"]
            else:
                bf16_cid = record_golden(
                    bf16, raw, GOLDEN_SEED, canonical_batch=CANONICAL_BATCH,
                    device="cuda")["golden"]["cid"]
            separated[template, mode] = (node["golden"]["cid"], bf16_cid)
            check(node["golden"]["cid"] != bf16_cid,
                  f"{template} {mode}: its golden {node['golden']['cid']} "
                  f"is bf16's at the same input")
            del node
            gc.collect()
            torch.cuda.empty_cache()
        if template == "anythingv3":
            precision_anythingv3(torch, flash, bf16, mined, want, card)
        del registry, bf16
        gc.collect()
        torch.cuda.empty_cache()
    check(len({g for g, _ in separated.values()}) == len(separated),
          f"two modes share a golden: {separated}")
    for (template, mode), (cid, bf16_cid) in separated.items():
        print(f"precision golden {template} {mode}: {cid}; bf16 at the "
              f"same input {bf16_cid}", flush=True)
    for (template, mode), m in memory.items():
        d = dequant.get((template, mode))
        cost = (f"; dequantization {d['leaves']} leaves, {d['kernels']} "
                f"kernels, {d['ms']:.3f} ms between CUDA events, "
                f"{d['busy_ms']:.3f} ms busy (traced)") if d else ""
        print(f"precision memory {template} {mode}: resident "
              f"{m['resident_gib']:.3f} GiB ({m['resident']} bytes) after "
              f"the build, peak "
              f"{m['peak_gib']:.3f} GiB over a {PEAK_STEPS}-step chunk "
              f"(above what was allocated before the build)"
              f"{cost}; {card}", flush=True)
    print(f"precision: phase 12 in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return {"launches": total, "memory": memory, "dequant": dequant}


def precision_anythingv3(torch, flash, bf16, mined: dict, want: dict,
                         card: str) -> None:
    """A fresh anythingv3 pipeline in each mode of `mined` (the nodes'
    items and on-chain CIDs, by mode) re-solves the six mined tasks in
    phase 5's chunk groupings, each chunk beside the same chunk on the
    bf16 model `bf16`, the modes in turn: every int8 and fp8 CID equals
    the on-chain one, so it holds across pipelines and neighbours, and
    no two modes share a task's CID. p50 and sol/h per mode, from these
    paired chunks."""
    from arbius_tpu_torch.node import solve_cid_batch

    items = mined["int8"]["items"]
    check(all([s for _, s in m["items"]] == [s for _, s in items]
              for m in mined.values()),
          "anythingv3: the modes' nodes mined other seeds")
    models, registries = {"bf16": bf16}, []
    for mode in mined:
        registry, _, _ = resident_build(torch,
                                        precision_config("anythingv3", mode))
        registries.append(registry)
        models[mode] = registry.get("0x" + "00" * 32)
    groups = ([0, 1, 2, 3], [4, 5], [2, 4, 0, 1])
    latencies = {mode: [] for mode in models}
    for idx in groups:
        cids = {}
        for mode, model in models.items():
            flash.reset_launches()
            t0 = time.perf_counter()
            again = solve_cid_batch(model, [items[i] for i in idx],
                                    canonical_batch=CANONICAL_BATCH)
            latencies[mode].append(time.perf_counter() - t0)
            check(flash.flash_attention.launches_by_route == want,
                  f"anythingv3 {mode} chunk {idx}: launches "
                  f"{flash.flash_attention.launches_by_route}, expected "
                  f"{want}")
            cids[mode] = [cid for cid, _ in again]
            if mode in mined:
                onchain = mined[mode]["onchain"]
                for i, cid in zip(idx, cids[mode]):
                    check(cid == onchain[i], f"anythingv3 {mode} task {i}: "
                          f"fresh pipeline {cid} != on-chain {onchain[i]} "
                          f"(chunk {idx})")
        check(all(len(set(c)) == len(models) for c in zip(*cids.values())),
              f"anythingv3 chunk {idx}: two modes share a CID")
    p50 = {mode: statistics.median(x) for mode, x in latencies.items()}
    print(f"precision anythingv3: fresh int8 and fp8 pipelines, chunks "
          f"{[list(g) for g in groups]}, each beside bf16: CIDs equal the "
          f"on-chain ones, no two modes share one; per-batch latency s "
          + "; ".join(f"{mode} {[round(x, 3) for x in lat]} p50 "
                      f"{p50[mode]:.3f} s "
                      f"({CANONICAL_BATCH * 3600 / p50[mode]:.1f} "
                      f"solutions/h at full batches)"
                      for mode, lat in latencies.items())
          + f"; {card}", flush=True)
    del models, registries
    gc.collect()
    torch.cuda.empty_cache()


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

    walls, t_mark = {}, [time.perf_counter()]

    def wall_mark(name: str) -> None:
        """The wall seconds since the last mark, under `name`."""
        now = time.perf_counter()
        walls[name] = round(now - t_mark[0], 1)
        t_mark[0] = now
        print(f"phase {name}: {walls[name]} s wall", flush=True)

    # -- 1. setup -------------------------------------------------------
    setup_device("cuda")
    card = card_info()
    print(f"setup: card {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; devices {torch.cuda.device_count()}",
          flush=True)
    t0 = time.perf_counter()
    sources = [*flash.SOURCES.values(), "codecs.cc"]
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(_build.build, sources))   # one compiler per source
    print(f"setup: built {', '.join(sources)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for route, source in flash.SOURCES.items():
        _build.load(source, flash._declare)
        report = _build.build_report(source).splitlines()
        spills = [r.strip() for r in report if "spill" in r]
        regs = [r.split(":", 1)[-1].strip() for r in report
                if "registers" in r]
        for reg, spill in zip(regs, spills):   # one pair per instantiation
            print(f"  {source} ptxas: {reg}; {spill}")
        # ptxas's notes where it serialises wgmma products (C7510-C7520),
        # per instantiation (the template arguments in the mangled name)
        serial = serialisation_notes("\n".join(report))
        print(f"  {source} ptxas serialisation notes: "
              f"{json.dumps(serial) if serial else 'none'}")
        if route in ("tensor_core_wide", *WGMMA_ROUTES):
            check(spills and all("0 bytes spill stores, 0 bytes spill loads"
                                 in r for r in spills),
                  f"{source} spills registers: {spills}")
        if route == "tensor_core_wgmma_wide":
            check(not serial, f"{source}: ptxas serialises its products "
                  f"({serial})")
        if route in ("tensor_core_wgmma", "tensor_core_wgmma_short"):
            d64 = {k: v for k, v in serial.items() if k.startswith("<64")}
            check(not d64, f"{source}: ptxas serialises the D = 64 "
                  f"products ({d64})")
    check(_native.deflate_fixed() is not None,
          "native deflate (csrc/codecs.cc) did not build")
    wall_mark("1 setup")

    # -- 2. kernels: every route -----------------------------------------
    expected = expected_launches(torch, flash)
    t0 = time.perf_counter()
    buckets = phase_kernels(torch, flash)
    for bucket, shapes in kernel_buckets():
        if bucket == "640x640":   # a part of its bucket's calls only
            continue
        per_batch = {r: t["launches_per_batch"]
                     for r, t in buckets[bucket].items()}
        want = expected_launches(torch, flash, shapes)
        if bucket.startswith(("VAE", "MoVQ")):   # one call: its routes
            want = {r: n for r, n in want.items() if n or r in per_batch}
        check(per_batch == want, f"{bucket} launches per route "
              f"{per_batch}, expected {want}")
    k = buckets["512x512"]
    kernel_ms = sum(t["ms"] for t in k.values() if t["launches_per_batch"])
    cases = sum(t["cases"] for b in buckets.values() for t in b.values())
    print(f"kernels: checked {cases} route/shape/dtype cases in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for bucket, _ in kernel_buckets():
        if bucket == "640x640":
            continue
        for route, t in buckets[bucket].items():
            print(f"kernels: {route} per {bucket} batch "
                  f"({t['launches_per_batch']} launches, bf16, timed at "
                  f"{t['timed_at']}): kernel {t['ms']:.3f} ms, plain "
                  f"{t['plain_ms']:.3f} ms, sdpa {t['library_ms']} ms, "
                  f"bound {t['bound_ms']:.3f} ms ({t['bound_by']}); host "
                  f"{t['host_ms']:.3f} ms (median x calls), "
                  f"{t['host_mean_ms']:.3f} ms (mean x calls) to enqueue "
                  f"them; worst error/bound {t['err_over_bound']:.3f}",
                  flush=True)
            for other, f in t["forced"].items():
                print(f"kernels: {route}'s {bucket} calls forced onto "
                      f"{other}: kernel {f['ms']:.3f} ms; host "
                      f"{f['host_ms']:.3f} ms (median), "
                      f"{f['host_mean_ms']:.3f} ms (mean)", flush=True)

    wall_mark("2 kernels")

    # -- 3. small reference -----------------------------------------------
    phase_small_reference(torch)
    wall_mark("3 small reference")

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
    flash.reset_launches()
    t0 = time.perf_counter()
    solved = solve_cid_batch(model, items, canonical_batch=CANONICAL_BATCH)
    wall = time.perf_counter() - t0
    launches = dict(flash.flash_attention.launches_by_route)
    n_chunks = -(-len(items) // CANONICAL_BATCH)
    cids = [cid for cid, _ in solved]
    print(f"main: solved {len(items)} tasks in {n_chunks} chunks in "
          f"{wall:.2f} s ({len(items) / wall * 3600:.1f} solutions/h on "
          f"{card}); kernel launches {launches}", flush=True)
    check(flash.flash_attention.launches == LAUNCHES_PER_CHUNK * n_chunks
          and launches == {r: n * n_chunks for r, n in expected.items()},
          f"kernel launches {launches}, expected {expected} x {n_chunks}")
    for (taskid, _, _), (cid, files) in zip(todo, solved):
        check(len(cid) == 2 + 68 and cid.startswith("0x1220")
              and int(cid, 16) > 0, f"bad CIDv0 {cid}")
        check(set(files) == {"out-1.png"}, f"unexpected files {set(files)}")
        check(len(generate_commitment(ADDRESS, taskid, cid)) == 32,
              "commitment is not 32 bytes")
    check(all(bool(f) and bool(c) for f, c in flags) and
          len(flags) == n_chunks, "non-finite or constant images")
    print("main: CIDs " + " ".join(cids))
    wall_mark("4 main path")
    del model, flags
    gc.collect()
    torch.cuda.empty_cache()

    # -- 5. determinism ---------------------------------------------------
    fresh = build_anythingv3(tiny=False, device="cuda", seed=0)
    chunk_runs = [list(range(0, 4)), list(range(4, 6)), [2, 4, 0, 1]]
    latencies = []
    for idx in chunk_runs:
        flash.reset_launches()
        t0 = time.perf_counter()
        again = solve_cid_batch(fresh, [items[i] for i in idx],
                                canonical_batch=CANONICAL_BATCH)
        latencies.append(time.perf_counter() - t0)
        check(flash.flash_attention.launches_by_route == expected,
              f"{flash.flash_attention.launches_by_route} launches in one "
              "chunk")
        for i, (cid, _) in zip(idx, again):
            check(cid == cids[i], f"task {i}: CID {cid} != {cids[i]} "
                  f"(chunk {idx})")
    p50 = statistics.median(latencies)
    print(f"determinism: fresh pipeline, chunks {chunk_runs}: CIDs "
          f"identical; per-batch latency s {[round(x, 3) for x in latencies]}"
          f", p50 {p50:.3f} s ({CANONICAL_BATCH * 3600 / p50:.1f} "
          f"solutions/h at full batches, {card}); the kernels' "
          f"{LAUNCHES_PER_CHUNK} calls (phase 2 times, {kernel_ms:.1f} ms) "
          f"are {kernel_ms / 10 / p50:.1f}% of p50", flush=True)

    # -- 5b. buckets --------------------------------------------------------
    phase_buckets(torch, flash, fresh, template, hydrate_input, taskid2seed)
    wall_mark("5 determinism and buckets")
    del fresh
    gc.collect()
    torch.cuda.empty_cache()

    # -- 6. node ------------------------------------------------------------
    node = phase_node(torch, flash, expected, todo, wall)
    wall_mark("6 node")

    # -- 7. node-run ---------------------------------------------------------
    node_run_launches = phase_node_run(
        torch, flash, expected, todo, node["fresh"], node["golden"],
        node["golden_source"],
        {"phase 4 direct": len(items) / wall * 3600,
         "phase 6 LocalChain": node["sol_h"]})
    wall_mark("7 node-run")
    node_launches = node["launches"]
    del node
    gc.collect()
    torch.cuda.empty_cache()

    # -- 8. kandinsky2 -------------------------------------------------------
    k2 = phase_kandinsky2(torch, flash)
    wall_mark("8 kandinsky2")

    # -- 9. text-to-video ------------------------------------------------------
    video = phase_video(torch, flash)
    wall_mark("9 text-to-video")

    # -- 10. textgen ------------------------------------------------------------
    textgen = phase_textgen(torch, flash)
    wall_mark("10 textgen")

    # -- 11. robust_video_matting ------------------------------------------------
    rvm = phase_rvm(torch, flash)
    wall_mark("11 robust_video_matting")

    # -- 12. precision modes --------------------------------------------------
    precision = phase_precision(torch, flash)
    check(all(precision["launches"][r] > 0 for r, n in expected.items() if n),
          f"phase 12 launched {precision['launches']}, not every route of "
          f"{expected}")
    wall_mark("12 precision modes")

    entries = kernel_entries(flash, buckets, {
        "launches": launches, "launches_node": node_launches,
        "launches_node_run": node_run_launches,
        "launches_kandinsky2": k2["launches"],
        "launches_kandinsky2_node": k2["launches_node"],
        "launches_video": video["launches"],
        "launches_video_node": video["launches_node"],
        "launches_textgen": textgen["launches"],
        "launches_textgen_node": textgen["launches_node"],
        "launches_rvm": rvm["launches"],
        "launches_rvm_node": rvm["launches_node"],
        "launches_precision": precision["launches"]})
    print("phase wall seconds: " + json.dumps(walls), flush=True)
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
