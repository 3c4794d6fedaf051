"""arbius-tpu port CLI — the twins of arbius_tpu/cli.py's node commands.

  demo-mine      end-to-end local mine: in-process chain + SD-1.5,
                 task -> solve -> commit -> reveal -> claim, full width
                 on the card by default, or `--tiny --device cpu`
  record-golden  boot self-test golden CID on this card and build,
                 printed with the build it is valid for

Run: python -m arbius_tpu_torch.cli <command> [...args]
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def build_info(device) -> dict:
    """The build a golden vector is valid for: the platform, torch, CUDA
    and cuDNN versions and, on a card, its name and power limit."""
    import torch

    info = {"platform": torch.device(device).type,
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "cudnn": torch.backends.cudnn.version()}
    if info["platform"] == "cuda":
        from arbius_tpu_torch.utils import card_info

        name, _, power = card_info().rpartition(", ")
        info.update(card=name, power_limit=power)
    return info


def record_golden(model, raw: dict, seed: int, *, canonical_batch: int,
                  device) -> dict:
    """Solve `raw` at `seed` on `model` as the boot self-test does (one
    canonical batch, padded) and return the golden with its build."""
    from arbius_tpu_torch.node.solver import solve_cid_batch
    from arbius_tpu_torch.templates.engine import hydrate_input

    hydrated = hydrate_input(dict(raw), model.template)
    t0 = time.perf_counter()
    [(cid, _)] = solve_cid_batch(model, [(hydrated, seed)],
                                 canonical_batch=canonical_batch)
    return {"build": build_info(device),
            "elapsed_s": round(time.perf_counter() - t0, 1),
            "golden": {"input": raw, "seed": seed, "cid": cid}}


def cmd_record_golden(args) -> int:
    """Compute anythingv3's golden CID for the boot self-test
    (`MinerNode.boot`) on this card and build, as the reference's record-golden does on its
    platform (input {prompt: "arbius test cat"}, seed 1337)."""
    from arbius_tpu_torch.node.config import MiningConfig, ModelConfig
    from arbius_tpu_torch.node.factory import build_registry

    raw = (json.loads(args.input) if args.input
           else {"prompt": "arbius test cat", "negative_prompt": ""})
    mid = "0x" + "00" * 32
    mc = ModelConfig(id=mid, template="anythingv3", tiny=args.tiny,
                     weights_dtype=args.weights_dtype)
    model = build_registry(MiningConfig(models=(mc,)),
                           device=args.device).get(mid)
    rec = record_golden(model, raw, args.seed,
                        canonical_batch=args.canonical_batch,
                        device=args.device)
    print(json.dumps({"template": "anythingv3", "tiny": args.tiny,
                      "weights_dtype": args.weights_dtype,
                      "canonical_batch": args.canonical_batch, **rec}))
    return 0


def cmd_demo_mine(args) -> int:
    from arbius_tpu_torch.chain import WAD, Engine, TokenLedger
    from arbius_tpu_torch.node import (
        LocalChain,
        MinerNode,
        MiningConfig,
        ModelConfig,
        build_registry,
    )

    miner, user = "0x" + "aa" * 20, "0x" + "01" * 20
    tok = TokenLedger()
    eng = Engine(tok, start_time=0)
    tok.mint(Engine.ADDRESS, 600_000 * WAD)
    for a in (miner, user):
        tok.mint(a, 1000 * WAD)
        tok.approve(a, Engine.ADDRESS, 10**30)
    mid_b = eng.register_model(user, user, 0, b'{"meta":{"title":"demo"}}')
    mid = "0x" + mid_b.hex()
    print(f"model registered: {mid}")

    cfg = MiningConfig(models=(ModelConfig(id=mid, template="anythingv3",
                                           tiny=args.tiny),))
    chain = LocalChain(eng, miner)
    chain.validator_deposit(100 * WAD)
    node = MinerNode(chain, cfg, build_registry(cfg, device=args.device))
    node.boot()

    size = args.size or (128 if args.tiny else 512)
    steps = args.steps or (2 if args.tiny else 20)
    tid = eng.submit_task(user, 0, user, mid_b, 0, json.dumps({
        "prompt": args.prompt, "negative_prompt": "", "width": size,
        "height": size, "num_inference_steps": steps,
        "scheduler": "DDIM"}).encode())
    print(f"task submitted: 0x{tid.hex()}")
    while node.tick():
        pass
    sol = eng.solutions.get(tid)
    if sol is None:
        print(f"no solution; failed jobs: {node.db.failed_jobs()}")
        return 1
    print(f"solution by {sol.validator}: cid 0x{sol.cid.hex()}")
    eng.advance_time(2200)
    while node.tick():
        pass
    claimed = node.metrics.solutions_claimed == 1
    print(f"claimed: {claimed}")
    return 0 if claimed else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="arbius_tpu_torch.cli")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("demo-mine")
    sp.add_argument("--prompt", default="arbius test cat")
    sp.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    sp.add_argument("--tiny", action="store_true",
                    help="the reduced test topology (default: full width)")
    sp.add_argument("--size", type=int,
                    help="width = height (default 512, or 128 with --tiny)")
    sp.add_argument("--steps", type=int,
                    help="inference steps (default 20, or 2 with --tiny)")
    sp.set_defaults(fn=cmd_demo_mine)

    sp = sub.add_parser(
        "record-golden",
        help="compute anythingv3's boot self-test golden CID on this build")
    sp.add_argument("--input", help='hydratable input JSON (default: '
                                    '{"prompt": "arbius test cat", ...})')
    sp.add_argument("--seed", type=int, default=1337)  # index.ts:988
    sp.add_argument("--tiny", action="store_true")
    sp.add_argument("--weights-dtype", dest="weights_dtype",
                    default="float32", choices=["float32", "bfloat16"],
                    help="goldens are dtype-specific: record with the "
                         "fleet's production weights dtype")
    sp.add_argument("--canonical-batch", dest="canonical_batch", type=int,
                    default=4, help="the node's canonical_batch: a golden "
                                    "holds for that batch size only")
    sp.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    sp.set_defaults(fn=cmd_record_golden)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
