#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (arbius_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card; it builds
everything it needs from the checkout's sources. Phases, each printing
its own lines with timings:

  1. setup: the card's name and power limit; build the three
     flash-attention kernels, the tensor-core routes (nvcc,
     csrc/flash_attn_tc.cu for D <= 160 and csrc/flash_attn_tc_wide.cu
     for D = 512) and the CUDA-core route (nvcc, csrc/flash_attn.cu), and
     the native PNG deflate (g++), all at once; ptxas registers and
     spills per kernel (the wide kernel must not spill).
  2. kernels: each route against the plain PyTorch version run in
     float32 on the same inputs, at every shape the main path gives it:
     the tensor-core route at the 8 bf16 UNet shapes, the wide
     tensor-core route at the bf16 VAE shape, the CUDA-core route at all
     9 in bf16 and in float32; per element within ops/flash.py's
     `error_bound` for that route, and bit-identical on relaunch. Each
     route's time beside the plain version's, SDPA's (a yardstick the
     port never calls) and the least time the card could take.
  3. small reference: the tiny float32 config solved on the card and on
     the CPU from the same weights; uint8 pixels within one level.
  4. main path: anythingv3 at full width (seeded random weights) solves 6
     hydrated template tasks at 512x512, 20 steps, DPMSolverMultistep,
     canonical batch 4 (two chunks, the second padded); CIDv0s and
     32-byte commitments, finite non-constant images, and 641 kernel
     launches per chunk, per route as `expected_launches` derives them
     from ops/flash.py's rule (16 transformers x 2 attentions x 20 steps
     on the tensor-core route + the VAE's one on the wide tensor-core
     route, none on the CUDA-core route).
  5. determinism: a fresh pipeline solves the same tasks chunk by chunk
     with identical CIDs and the same launches per route, and one task
     keeps its CID among different neighbours.
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

Any failed check raises and the exit code is not 0. The last lines are
the card, a `kernels` JSON line (with each route's launches in phase 4
and in phase 6) and `{"ok": true, "device": {...}}`.
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
KV_TEXT = 77               # text tokens (cross-attention keys)
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
# the port's boot self-test vector, valid for the build it records
GOLDEN_FILE = "arbius_tpu_torch/goldens/anythingv3.h100.bfloat16.json"
GOLDEN_INPUT = {"prompt": "arbius test cat", "negative_prompt": "",
                "width": SIZE, "height": SIZE, "num_inference_steps": STEPS,
                "scheduler": SCHEDULER}
GOLDEN_SEED = 1337
BUILD_FIELDS = ("card", "torch", "cuda", "cudnn")
TASK_FEE = 10           # AIUS per on-chain task of phase 6


def expected_launches(torch, flash) -> dict[str, int]:
    """Launches per route for one 512x512 chunk: ops/flash.py's `route`
    applied to each main-path shape in bf16, with the strides of the
    models' q/k/v views ([B, S, H*D] viewed as [B, H, S, D]) and
    16-byte aligned data."""
    out = dict.fromkeys(flash.SOURCES, 0)
    for b, h, sq, skv, d, count in MAIN_PATH_SHAPES:
        strides = [st for s in (sq, skv, skv) for st in (s * h * d, d, h * d)]
        out[flash.route(torch.bfloat16, d, strides, [0, 0, 0])] += count
    return out


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


def kernel_error(torch, flash, q, k, v, out, route) -> dict:
    """`route`'s output `out` against ref, the plain version run in
    float32 on the same inputs q, k, v: the largest |out - ref|, the RMS
    of ref, the largest ratio of |out - ref| to ops/flash.py's
    `error_bound` for `route`, and whether every element is within it."""
    ref = flash.flash_attention_reference(q.float(), k.float(), v.float())
    err = (out.float() - ref).abs()
    ratio = err / flash.error_bound(q, k, v, route)
    return {"max_abs_err": err.max().item(),
            "ref_rms": ref.pow(2).mean().sqrt().item(),
            "err_over_bound": ratio.max().item(),
            "ok": bool((ratio <= 1).all())}


def bound_ms(b, h, sq, skv, d, elem_bytes) -> tuple[float, float]:
    """(operations-bound ms, bytes-bound ms) of one attention call: q, k,
    v read once, o written once; 4*B*H*Sq*Skv*D operations."""
    ops = 4.0 * b * h * sq * skv * d
    nbytes = elem_bytes * b * h * d * (2 * sq + 2 * skv)
    return ops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3


_SUMMED = ("ms", "plain_ms", "library_ms", "ops_ms", "bytes_ms", "bound_ms")


def phase_kernels(torch, flash) -> dict:
    """Check every route at every main-path shape it is given here, and
    time the bf16 cases. Returns per route the check's worst case and
    times summed over one 512x512 batch's calls (ms, plain_ms,
    library_ms, bound parts): over the calls the main path sends to the
    route (launches_per_batch of them), or, for a route the main path
    does not launch, over the main path's calls at every bf16 shape the
    route was checked at, as if they were forced onto it. `timed_at`
    lists those shapes with their calls per batch."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(0)
    lines = []
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for b, h, sq, skv, d, count in MAIN_PATH_SHAPES:
            q, k, v = (torch.randn(b, h, s, d, generator=gen, device="cuda")
                       .to(dtype) for s in (sq, skv, skv))
            main = flash.route_of(q, k, v)
            routes = [main] if main == "cuda_core" else [main, "cuda_core"]
            iters = 5 if sq * skv >= 1 << 20 else 20
            plain_ms = lib_ms = None
            if dtype == torch.bfloat16:
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
            ops_ms, bytes_ms = bound_ms(b, h, sq, skv, d, 2)
            for route in routes:
                got = flash.flash_attention(q, k, v, kernel=route)
                again = flash.flash_attention(q, k, v, kernel=route)
                err = kernel_error(torch, flash, q, k, v, got, route)
                check(err["ok"], f"{route} kernel != plain at {name} "
                      f"{(b, h, sq, skv, d)}: {err}")
                check(torch.equal(got, again), f"{route} kernel not "
                      f"bit-identical on relaunch at {(b, h, sq, skv, d)}")
                line = {"route": route, "dtype": name,
                        "shape": [b, h, sq, skv, d],
                        "main_path": route == main, **err}
                if dtype == torch.bfloat16:
                    ms = cuda_ms(torch, lambda: flash.flash_attention(
                        q, k, v, kernel=route), iters)
                    line.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                bound_ms=max(ops_ms, bytes_ms),
                                bound_by="operations" if ops_ms >= bytes_ms
                                else "bytes", launches_per_batch=count)
                    if lib_ms is not None:
                        line["vs_sdpa"] = ms / lib_ms
                print("kernel " + json.dumps(line), flush=True)
                lines.append({**line, "ops_ms": ops_ms, "bytes_ms": bytes_ms})
                del got, again
            del q, k, v
        torch.cuda.empty_cache()
    out = {}
    for route in flash.SOURCES:
        mine = [ln for ln in lines if ln["route"] == route]
        timed = [ln for ln in mine if "ms" in ln]
        on_path = [ln for ln in timed if ln["main_path"]]
        timed = on_path or timed
        tot = {key: sum(ln["launches_per_batch"] * (ln[key] or 0.0)
                        for ln in timed) for key in _SUMMED}
        if any(ln["library_ms"] is None for ln in timed):
            tot["library_ms"] = None
        out[route] = {
            **tot, "cases": len(mine),
            "launches_per_batch": sum(ln["launches_per_batch"]
                                      for ln in on_path),
            "timed_at": [ln["shape"] + [ln["launches_per_batch"]]
                         for ln in timed],
            "max_abs_err": max(ln["max_abs_err"] for ln in mine),
            "err_over_bound": max(ln["err_over_bound"] for ln in mine)}
    return out


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
    print(f"node: mined {len(tids)} tasks in {n_chunks} chunks, "
          f"{mine_s:.2f} s host time from the first tick to the last "
          f"reveal; infer {infer:.3f} s, commit {commit:.4f} s "
          f"(arbius_stage_seconds sums); "
          f"{CANONICAL_BATCH * n_chunks * 3600 / infer:.1f} sol/h at full "
          f"batches (phase 4: "
          f"{CANONICAL_BATCH * n_chunks * 3600 / main_wall:.1f}, the fresh "
          f"model's solve_cid_batch of the same tasks here "
          f"{CANONICAL_BATCH * n_chunks * 3600 / direct_s:.1f}); claimed "
          f"{len(tids)}, +{rise / WAD:g} AIUS; {card}", flush=True)
    node.close()
    return launches


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
        if route == "tensor_core_wide":
            check(spills and all("0 bytes spill stores, 0 bytes spill loads"
                                 in r for r in spills),
                  f"{source} spills registers: {spills}")
    check(_native.deflate_fixed() is not None,
          "native deflate (csrc/codecs.cc) did not build")

    # -- 2. kernels: every route -----------------------------------------
    expected = expected_launches(torch, flash)
    t0 = time.perf_counter()
    k = phase_kernels(torch, flash)
    per_batch = {r: t["launches_per_batch"] for r, t in k.items()}
    check(per_batch == expected, f"main-path launches per route "
          f"{per_batch}, expected {expected}")
    kernel_ms = sum(t["ms"] for t in k.values() if t["launches_per_batch"])
    print(f"kernels: checked {sum(t['cases'] for t in k.values())} "
          f"route/shape/dtype cases in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for route, t in k.items():
        print(f"kernels: {route} per 512x512 batch ({t['launches_per_batch']}"
              f" main-path launches, bf16, timed at {t['timed_at']}): kernel "
              f"{t['ms']:.3f} ms, plain {t['plain_ms']:.3f} ms, sdpa "
              f"{t['library_ms']} ms, bound {t['bound_ms']:.3f} ms; worst "
              f"error/bound {t['err_over_bound']:.3f}", flush=True)

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
    del fresh
    gc.collect()
    torch.cuda.empty_cache()

    # -- 6. node ------------------------------------------------------------
    node_launches = phase_node(torch, flash, expected, todo, wall)

    bounds = {"tensor_core": "1e-4 + 2^-8 (|ref| + P|V|) in bf16",
              "tensor_core_wide": "1e-4 + 2^-8 (|ref| + P|V|) in bf16",
              "cuda_core": "1e-4 + 2^-8 |ref| in bf16, "
                           "2e-5 + 2e-5 |ref| in float32"}
    entries = []
    for route, name in (("cuda_core", "flash_attention"),
                        ("tensor_core", "flash_attention_tc"),
                        ("tensor_core_wide", "flash_attention_tc_wide")):
        t = k[route]
        entries.append({
            "name": name, "route": "cuda",
            "source": f"arbius_tpu_torch/csrc/{flash.SOURCES[route]}",
            "replaces": "arbius_tpu/ops/flash.py:34",
            "launches": launches[route],
            "launches_node": node_launches[route],
            "max_abs_err": t["max_abs_err"],
            # times: one 512x512 batch's calls (bf16) at timed_at,
            # summed; see phase_kernels
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": "operations" if t["ops_ms"] >= t["bytes_ms"]
            else "bytes",
            "library_ms": t["library_ms"],
            "launches_per_batch": t["launches_per_batch"],
            "timed_at": t["timed_at"],
            # reached only if every check of phase 2 passed
            "check": {"cases": t["cases"],
                      "against": "plain version in float32, same inputs",
                      "bound": bounds[route],
                      "worst_err_over_bound": t["err_over_bound"],
                      "matches_plain": True, "relaunch_identical": True},
        })
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
