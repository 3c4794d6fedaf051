"""arbius-tpu port CLI — the twins of arbius_tpu/cli.py's node commands.

  demo-mine      end-to-end local mine: in-process chain + SD-1.5,
                 task -> solve -> commit -> reveal -> claim, full width
                 on the card by default, or `--tiny --device cpu`
  record-golden  boot self-test golden CID on this card and build,
                 printed with the build it is valid for
  wallet-gen     new private key + address
  devnet         serve a funded in-process chain over JSON-RPC
  node-run       mine against a JSON-RPC endpoint (start.ts parity), on
                 the card unless `--device cpu`

Ops verbs against an endpoint (--deployment + --key, signed txs):
  model-register    template -> on-chain model id
  validator-stake   approve + deposit to the validator minimum
  task-submit       submitTask with hydrate validation + fee approval
                    (`--sign-only` prints the signed raw tx instead)
  task-status       task/solution view
  claim             claimSolution
  balance           token balance

The reference's other ops verbs (transfer, decode-tx, treasury-withdraw,
engine-admin, task-retract, signal-support, timetravel, governance) are
not ported yet (ROADMAP queue 1 item 5).

Run: python -m arbius_tpu_torch.cli <command> [...args]
"""
from __future__ import annotations

import argparse
import json
import re
import signal
import sys
import time


def _wad(amount: str) -> int:
    """Exact decimal AIUS string → wei wad (parseEther semantics). Float
    would drift off-by-wei for most decimal inputs — e.g. int(1.1*10**18)
    is not 11*10**17 — and a drifted fee reverts submitTask or skews the
    registered model id."""
    from decimal import Decimal, InvalidOperation

    try:
        wad = Decimal(amount) * 10**18
    except InvalidOperation:
        raise SystemExit(f"bad AIUS amount {amount!r}")
    if not wad.is_finite() or wad < 0:
        raise SystemExit(f"AIUS amount must be finite and >= 0, "
                         f"got {amount!r}")
    if wad != int(wad):
        raise SystemExit(f"{amount!r} has more than 18 decimal places")
    return int(wad)


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
    # detlint: allow[DET101] operator-facing elapsed_s; never hashed
    t0 = time.perf_counter()
    [(cid, _)] = solve_cid_batch(model, [(hydrated, seed)],
                                 canonical_batch=canonical_batch)
    return {"build": build_info(device),
            # detlint: allow[DET101] operator-facing elapsed_s; never hashed
            "elapsed_s": round(time.perf_counter() - t0, 1),
            "golden": {"input": raw, "seed": seed, "cid": cid}}


def cmd_record_golden(args) -> int:
    """Compute a model's golden CID for the boot self-test
    (`MinerNode.boot`) on this card and build, as the reference's
    record-golden does on its platform (input {prompt: "arbius test
    cat"}, seed 1337)."""
    from arbius_tpu_torch.node.config import MiningConfig, ModelConfig
    from arbius_tpu_torch.node.factory import build_registry

    raw = json.loads(args.input) if args.input else {
        "prompt": "arbius test cat",
        # only anythingv3's template takes a negative prompt without a
        # default; zeroscopev2xl's hydrates its own
        **({"negative_prompt": ""} if args.template == "anythingv3"
           else {})}
    resolve_file = None
    if args.template == "robust_video_matting" and not args.probe_video:
        raise SystemExit(
            "robust_video_matting's input is a video FILE: pass "
            "--probe-video TxHxW to pin the deterministic probe clip as "
            "input_video (codecs/probe.py)")
    if args.probe_video:
        # file-input templates: the probe clip, pinned by its CID and
        # resolved in memory, so the golden reproduces on any platform
        from arbius_tpu_torch.node.factory import probe_golden_input

        resolve_file, probe_raw = probe_golden_input(args.probe_video)
        raw.pop("prompt", None)
        raw.pop("negative_prompt", None)
        raw.update(probe_raw)
    mid = "0x" + "00" * 32
    mc = ModelConfig(id=mid, template=args.template, tiny=args.tiny,
                     weights_dtype=args.weights_dtype)
    model = build_registry(MiningConfig(models=(mc,)), device=args.device,
                           resolve_file=resolve_file).get(mid)
    rec = record_golden(model, raw, args.seed,
                        canonical_batch=args.canonical_batch,
                        device=args.device)
    if args.probe_video:
        # the recipe rides in the vector: a node whose golden carries
        # probe_video makes the clip at boot (factory.probe_resolver)
        rec["golden"]["probe_video"] = args.probe_video
    print(json.dumps({"template": args.template, "tiny": args.tiny,
                      "weights_dtype": args.weights_dtype,
                      "canonical_batch": args.canonical_batch, **rec},
                     sort_keys=True))
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


def cmd_wallet_gen(args) -> int:
    from arbius_tpu_torch.chain.wallet import Wallet

    w = Wallet.generate()
    print(json.dumps({"address": w.address,
                      "privateKey": "0x" + w.private_key.hex()}))
    return 0


def cmd_devnet(args) -> int:
    """Local chain world (setup_local.sh parity): funded devnet over HTTP
    with a registered model, ready for `node-run` against it. Prints the
    deployment constants (`node-run --deployment` reads them, less
    `model_id`) with the port actually bound."""
    from arbius_tpu_torch.chain import WAD, Engine, TokenLedger
    from arbius_tpu_torch.chain.devnet import DevnetNode

    tok = TokenLedger()
    owner = args.owner
    if owner and not re.fullmatch(r"0x[0-9a-fA-F]{40}", owner):
        raise SystemExit(f"bad owner address {owner!r}")
    eng = Engine(tok, start_time=args.start_time, owner=owner)
    tok.mint(Engine.ADDRESS, 600_000 * WAD)
    node = DevnetNode(eng, chain_id=args.chain_id)
    for addr in args.fund or []:
        tok.mint(addr.lower(), 1000 * WAD)
        print(f"funded {addr} with 1000 AIUS")
    if owner:
        print(f"engine owner/pauser: {owner}")
    mid = eng.register_model("0x" + "01" * 20, "0x" + "01" * 20, 0,
                             b'{"meta":{"title":"devnet"}}')
    server = node.serve(args.host, args.port)
    port = server.server_address[1]
    print(json.dumps({
        "rpc_url": f"http://{args.host}:{port}",
        "engine_address": node.engine_address,
        "token_address": node.token_address,
        "governor_address": node.governor_address,
        "chain_id": args.chain_id,
        "model_id": "0x" + mid.hex(),
    }, indent=2, sort_keys=True), flush=True)
    print(f"devnet listening on {args.host}:{port} (ctrl-c to stop)",
          file=sys.stderr, flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    return 0


def _rpc_client(args):
    """Build the signed-tx client every ops verb composes
    (contract/tasks/index.ts boilerplate: provider + wallet + contracts)."""
    from arbius_tpu_torch.chain.rpc_client import (
        EngineRpcClient,
        JsonRpcTransport,
    )
    from arbius_tpu_torch.chain.wallet import Wallet
    from arbius_tpu_torch.node.config import load_deployment

    dep = load_deployment(open(args.deployment).read())
    key = args.key or (open(args.key_file).read().strip()
                       if args.key_file else None)
    # read-only verbs may omit the key; views don't sign
    wallet = Wallet.from_hex(key) if key else Wallet.generate()
    client = EngineRpcClient(JsonRpcTransport(dep.rpc_url),
                             dep.engine_address, wallet,
                             chain_id=dep.chain_id)
    return client, dep


def cmd_model_register(args) -> int:
    """model:register parity (contract/tasks/index.ts:106-143): register a
    template as an on-chain model and print the derived model id."""
    from arbius_tpu_torch.l0.abi import abi_encode
    from arbius_tpu_torch.l0.cid import cid_onchain
    from arbius_tpu_torch.l0.keccak import keccak256
    from arbius_tpu_torch.templates.engine import (
        load_template,
        load_template_bytes,
    )

    client, dep = _rpc_client(args)
    if args.template_file:
        template_bytes = open(args.template_file, "rb").read()
    else:
        load_template(args.template)  # validate it parses
        template_bytes = load_template_bytes(args.template)
    fee = _wad(args.fee)
    addr = args.addr or client.wallet.address
    txhash = client.send("registerModel", [addr, fee, template_bytes])
    # id = keccak(abi.encode(sender, addr, fee, cid)) — EngineV1.sol:421-426
    cid = cid_onchain(template_bytes)
    mid = keccak256(abi_encode(["address", "address", "uint256", "bytes"],
                               [client.wallet.address, addr, fee, cid]))
    print(json.dumps({"txhash": txhash, "model_id": "0x" + mid.hex(),
                      "template_cid": "0x" + cid.hex()}))
    return 0


def cmd_validator_stake(args) -> int:
    """validator:stake parity (contract/tasks/index.ts:145-157):
    approve-then-deposit up to the validator minimum (with headroom)."""
    from arbius_tpu_torch.node.rpc_chain import RpcChain

    client, dep = _rpc_client(args)
    chain = RpcChain(client, dep.token_address)
    if args.amount is not None:
        amount = _wad(args.amount)
    else:
        # reference default: minimum * 1.1 headroom against emission drift
        amount = chain.get_validator_minimum() * 11 // 10
    chain.validator_deposit(amount)
    staked = chain.validator_staked()
    print(json.dumps({"staked_wad": str(staked),
                      "staked": staked / 10**18}))
    return 0


def cmd_task_submit(args) -> int:
    """submitTask from the command line (the dapp's generate page /
    Example/SubmitTask.sol path): hydrate input against the template,
    submit, and print the taskid recovered from the TaskSubmitted log."""
    from arbius_tpu_torch.templates.engine import hydrate_input, load_template

    client, dep = _rpc_client(args)
    raw = json.loads(args.input) if args.input else {}
    if args.template:
        hydrate_input(dict(raw), load_template(args.template))  # validate
    fee = _wad(args.fee)
    if fee:
        # self-heal the fee allowance like the dapp's approve-then-submit
        from arbius_tpu_torch.node.rpc_chain import RpcChain

        RpcChain(client, dep.token_address).ensure_fee_allowance(fee)
    # canonical form (sorted keys, tight separators) — the same bytes the
    # node's POST /api/task path would submit for this input
    input_bytes = json.dumps(raw, separators=(",", ":"),
                             sort_keys=True).encode()
    if args.sign_only:
        # user-wallet dapp path (generate.tsx wagmi parity): sign here,
        # let the node forward the bytes via POST /api/tx/raw. Nonce/gas
        # are read from the endpoint; nothing is sent. (A nonzero --fee
        # already sent its approve above — allowance is a separate tx.)
        raw = client.sign_engine_call("submitTask", [
            args.version, client.wallet.address, args.model, fee,
            input_bytes])
        print(json.dumps({"raw": "0x" + raw.hex(),
                          "from": client.wallet.address}))
        return 0
    from_block = client.block_number()
    txhash = client.send("submitTask", [
        args.version, client.wallet.address, args.model, fee, input_bytes])
    # the id is assigned on-chain (hash chains prevhash) — recover it from
    # our TaskSubmitted log, like the dapp does from the receipt
    taskid = None
    me = client.wallet.address.lower()
    for lg in client.get_logs("TaskSubmitted", from_block,
                              client.block_number()):
        sender = "0x" + lg["topics"][3][-40:]
        if sender.lower() == me:
            taskid = lg["topics"][1]
    print(json.dumps({"txhash": txhash, "taskid": taskid}))
    return 0


def cmd_task_status(args) -> int:
    """Task / solution view (task/[taskid] page data), through the same
    RpcChain decode the node mines with (incl. its missing-key sentinels)."""
    from arbius_tpu_torch.node.rpc_chain import RpcChain

    client, dep = _rpc_client(args)
    chain = RpcChain(client, dep.token_address)
    task = chain.get_task(args.taskid)
    if task is None:
        print(json.dumps({"taskid": args.taskid, "error": "task not found"}))
        return 1
    sol = chain.get_solution(args.taskid)
    out = {
        "taskid": args.taskid,
        "model": "0x" + task.model.hex(), "fee": str(task.fee),
        "owner": task.owner, "blocktime": task.blocktime,
        "version": task.version, "input_cid": "0x" + task.cid.hex(),
        "solution": None,
    }
    if sol is not None:
        out["solution"] = {"validator": sol.validator,
                           "blocktime": sol.blocktime,
                           "claimed": sol.claimed,
                           "cid": "0x" + sol.cid.hex()}
    print(json.dumps(out, indent=2, sort_keys=True))
    return 0


def cmd_claim(args) -> int:
    """mining:claimSolution parity (contract/tasks/index.ts:87-94)."""
    client, _ = _rpc_client(args)
    txhash = client.send("claimSolution", [args.taskid])
    print(json.dumps({"txhash": txhash}))
    return 0


def cmd_balance(args) -> int:
    """mining:balance parity (contract/tasks/index.ts:67-74)."""
    from arbius_tpu_torch.l0.abi import abi_decode

    client, dep = _rpc_client(args)
    addr = args.address or client.wallet.address
    bal = abi_decode(["uint256"], client.eth_call_to(
        dep.token_address, "balanceOf(address)", ["address"], [addr]))[0]
    print(json.dumps({"address": addr, "balance_wad": str(bal),
                      "balance": bal / 10**18}))
    return 0


def cmd_node_run(args) -> int:
    """Run the miner against a JSON-RPC endpoint (start.ts parity), on
    `--device` (the card unless `cpu` is asked for). Ticks at the
    config's poll cadence until SIGTERM/SIGINT, or for at most `--ticks`
    ticks; on exit prints one JSON summary line: ticks run, the wall
    clock of the first tick, the node's counters and the flash-attention
    launches per route, those of boot (the self-test) apart from those
    of mining."""
    from arbius_tpu_torch.utils import setup_device

    # before anything touches CUDA: setup_device raises on a late call
    device = setup_device(args.device)
    from arbius_tpu_torch.chain.rpc_client import (
        EngineRpcClient,
        JsonRpcTransport,
    )
    from arbius_tpu_torch.chain.wallet import Wallet
    from arbius_tpu_torch.node import MinerNode, load_config
    from arbius_tpu_torch.node.config import load_deployment
    from arbius_tpu_torch.node.factory import build_registry
    from arbius_tpu_torch.node.rpc_chain import RpcChain
    from arbius_tpu_torch.ops import flash

    cfg = load_config(open(args.config).read())
    dep = load_deployment(open(args.deployment).read())
    key = args.key or open(args.key_file).read().strip()
    wallet = Wallet.from_hex(key)
    client = EngineRpcClient(JsonRpcTransport(dep.rpc_url),
                             dep.engine_address, wallet,
                             chain_id=dep.chain_id)
    chain = RpcChain(client, dep.token_address, start_block=dep.start_block,
                     validator_address=cfg.delegated_validator)
    store = None
    if cfg.store_dir:
        from arbius_tpu_torch.node.store import ContentStore

        store = ContentStore(cfg.store_dir)
    registry = build_registry(
        cfg, device=device, resolve_file=store.get_file if store else None)
    node = MinerNode(chain, cfg, registry, store=store)
    node.boot(skip_self_test=args.skip_self_test)
    boot_launches = dict(flash.flash_attention.launches_by_route)
    flash.reset_launches()
    rpc = None
    if cfg.rpc_port is not None:
        from arbius_tpu_torch.node.rpc import ControlRPC

        rpc = ControlRPC(node, port=cfg.rpc_port)
        rpc.start()
        print(f"control RPC + explorer on 127.0.0.1:{rpc.port}",
              file=sys.stderr, flush=True)
    print(f"mining as {wallet.address} against {dep.rpc_url} on {device}",
          file=sys.stderr, flush=True)
    stopping = []
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stopping.append(True))
    ticks = 0

    def stop() -> bool:
        # MinerNode.run asks once before each tick
        nonlocal ticks
        if stopping or 0 < args.ticks <= ticks:
            return True
        ticks += 1
        return False

    # detlint: allow[DET101] operator-facing summary; never hashed
    first_tick = time.time()
    try:
        node.run(stop=stop)
    finally:
        if rpc is not None:
            rpc.stop()
        m = node.metrics
        print(json.dumps({"node_run": {
            "ticks": ticks, "first_tick_unix": first_tick,
            "solutions_submitted": m.solutions_submitted,
            "solutions_claimed": m.solutions_claimed,
            "failed_jobs": len(node.db.failed_jobs()),
            "flash_launches_boot": boot_launches,
            "flash_launches": dict(
                flash.flash_attention.launches_by_route)}},
            sort_keys=True), flush=True)
        node.close()
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="arbius_tpu_torch.cli",
                                description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
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
        help="compute a model's boot self-test golden CID on this build")
    sp.add_argument("--template", default="anythingv3",
                    choices=["anythingv3", "kandinsky2", "zeroscopev2xl",
                             "damo", "textgen", "robust_video_matting"])
    sp.add_argument("--input", help='hydratable input JSON (default: '
                                    '{"prompt": "arbius test cat", ...})')
    sp.add_argument("--seed", type=int, default=1337)  # index.ts:988
    sp.add_argument("--probe-video", dest="probe_video", metavar="TxHxW",
                    help="file-input templates (robust_video_matting): "
                         "pin the deterministic probe clip of this shape "
                         "as input_video")
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

    sub.add_parser("wallet-gen").set_defaults(fn=cmd_wallet_gen)

    sp = sub.add_parser("devnet")
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=8545,
                    help="0 picks a free port")
    sp.add_argument("--chain-id", type=int, default=31337)
    sp.add_argument("--start-time", type=int, default=1000)
    sp.add_argument("--fund", action="append",
                    help="address to mint 1000 AIUS to (repeatable)")
    sp.add_argument("--owner", help="engine owner/pauser address; unset "
                                    "leaves roles unconfigured (direct "
                                    "admin calls denied, governance path "
                                    "unrestricted)")
    sp.set_defaults(fn=cmd_devnet)

    def add_rpc_args(sp, *, key_required=True):
        sp.add_argument("--deployment", required=True,
                        help="deployment constants json")
        keyg = sp.add_mutually_exclusive_group(required=key_required)
        keyg.add_argument("--key", help="0x private key")
        keyg.add_argument("--key-file", help="file holding the private key")

    sp = sub.add_parser("model-register",
                        help="register a template as an on-chain model")
    add_rpc_args(sp)
    tgroup = sp.add_mutually_exclusive_group(required=True)
    tgroup.add_argument("--template", help="bundled template name")
    tgroup.add_argument("--template-file", help="path to a template json")
    sp.add_argument("--fee", default="0", help="model fee (AIUS)")
    sp.add_argument("--addr", help="model payee address (default: wallet)")
    sp.set_defaults(fn=cmd_model_register)

    sp = sub.add_parser("validator-stake",
                        help="approve + deposit validator stake")
    add_rpc_args(sp)
    sp.add_argument("--amount",
                    help="AIUS to deposit (default: minimum * 1.1)")
    sp.set_defaults(fn=cmd_validator_stake)

    sp = sub.add_parser("task-submit", help="submit a task on-chain")
    add_rpc_args(sp)
    sp.add_argument("--model", required=True, help="0x model id")
    sp.add_argument("--input", help="input json object")
    sp.add_argument("--template", help="validate input against template")
    sp.add_argument("--fee", default="0")
    sp.add_argument("--version", type=int, default=0)
    sp.add_argument("--sign-only", action="store_true",
                    help="print the signed raw tx instead of sending it "
                         "(paste into the explorer's raw-tx form / POST "
                         "/api/tx/raw — the user-wallet path)")
    sp.set_defaults(fn=cmd_task_submit)

    sp = sub.add_parser("task-status", help="task/solution view")
    add_rpc_args(sp, key_required=False)
    sp.add_argument("taskid")
    sp.set_defaults(fn=cmd_task_status)

    sp = sub.add_parser("claim", help="claim a solved task's fee+reward")
    add_rpc_args(sp)
    sp.add_argument("taskid")
    sp.set_defaults(fn=cmd_claim)

    sp = sub.add_parser("balance", help="token balance lookup")
    add_rpc_args(sp, key_required=False)
    sp.add_argument("--address", help="default: wallet address")
    sp.set_defaults(fn=cmd_balance)

    sp = sub.add_parser("node-run")
    sp.add_argument("config", help="MiningConfig.json path")
    sp.add_argument("--deployment", required=True,
                    help="deployment constants json")
    keyg = sp.add_mutually_exclusive_group(required=True)
    keyg.add_argument("--key", help="0x private key")
    keyg.add_argument("--key-file", help="file holding the private key")
    sp.add_argument("--skip-self-test", action="store_true")
    sp.add_argument("--ticks", type=int, default=0,
                    help="run at most N ticks, then exit (0 = until "
                         "SIGTERM/SIGINT)")
    sp.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    sp.set_defaults(fn=cmd_node_run)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
