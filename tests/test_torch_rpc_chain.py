"""The port's real-chain half against the reference's, on the CPU: wallet
(secp256k1, RFC-6979 signing), EIP-1559 RLP, the JSON-RPC client, the
in-process devnet and `RpcChain`.

Differential scenarios: the cases of tests/test_rpc_chain.py run in both
packages on the same inputs (the same keys, engine and calls). Signing
is deterministic, so every raw transaction, hash, log, revert message
and the engine's state must equal a run of the reference's.

Then the port's `MinerNode` mines over the devnet end to end with the
tiny anythingv3 on `--device cpu` (float32, seeded init), with the staged
pipeline off and on: the reference's `MinerNode` mining the same tasks
over its own devnet with the port's images (the reference's PNG and CID
path) lands the same chain writes, byte for byte. Last, `node-run
--ticks` drives the port's CLI as a separate process against a devnet
on localhost (chip_smoke.py phase 7's world at the tiny size).
"""
from __future__ import annotations

import dataclasses
import functools
import importlib
import json
import threading
import types

import pytest

import chip_smoke

PACKAGES = ("arbius_tpu", "arbius_tpu_torch")
CHAIN_ID = 31337
KEY_MINER = "0x" + "11" * 32
KEY_USER = "0x" + "22" * 32


@functools.cache
def _pkg(name: str) -> types.SimpleNamespace:
    def mod(path):
        return importlib.import_module(f"{name}.{path}")

    chain = mod("chain")
    return types.SimpleNamespace(
        name=name, chain=chain, WAD=chain.WAD, devnet=mod("chain.devnet"),
        rlp=mod("chain.rlp"), rpc_client=mod("chain.rpc_client"),
        wallet=mod("chain.wallet"), abi=mod("l0.abi"),
        rpc_chain=mod("node.rpc_chain"), node=mod("node"),
        config=mod("node.config"), cid=mod("l0.cid"),
        commitment=mod("l0.commitment"), templates=mod("templates.engine"))


class DevnetTransport:
    """JsonRpcTransport semantics without HTTP."""

    def __init__(self, P, node):
        self.P, self.node = P, node

    def request(self, method, params):
        try:
            return self.node.request(method, params)
        except self.P.devnet.DevnetError as e:
            raise self.P.rpc_client.RpcError(str(e)) from None


def make_world(P):
    tok = P.chain.TokenLedger()
    eng = P.chain.Engine(tok, start_time=1000)
    tok.mint(P.chain.Engine.ADDRESS, 600_000 * P.WAD)
    dev = P.devnet.DevnetNode(eng, chain_id=CHAIN_ID)
    miner = P.wallet.Wallet.from_hex(KEY_MINER)
    user = P.wallet.Wallet.from_hex(KEY_USER)
    tok.mint(miner.address, 1000 * P.WAD)
    tok.mint(user.address, 1000 * P.WAD)
    mid = eng.register_model(user.address, user.address, 0,
                             b'{"meta":{"title":"t"}}')
    return eng, dev, miner, user, "0x" + mid.hex()


def make_chain(P, dev, wallet, transport=None):
    client = P.rpc_client.EngineRpcClient(
        transport or DevnetTransport(P, dev), dev.engine_address, wallet,
        chain_id=CHAIN_ID)
    return P.rpc_chain.RpcChain(client, dev.token_address)


def engine_state(eng, dev) -> dict:
    """What both packages must agree on: the chain's state and every
    transaction and log the devnet recorded."""
    def rows(table):
        return {k.hex(): dataclasses.astuple(v)
                for k, v in sorted(table.items())}

    return {"tasks": rows(eng.tasks), "solutions": rows(eng.solutions),
            "commitments": {k.hex(): v for k, v in
                            sorted(eng.commitments.items())},
            "validators": {k: dataclasses.astuple(v) for k, v in
                           sorted(eng.validators.items())},
            "balances": dict(sorted(eng.token.balances.items())),
            "now": eng.now, "block": eng.block_number,
            "txs": list(dev.txs), "logs": dev.logs,
            "nonces": dict(sorted(dev.nonces.items()))}


def _raises(exc_type, fn) -> str:
    with pytest.raises(exc_type) as e:
        fn()
    return f"{type(e.value).__name__}: {e.value}"


# -- scenarios (tests/test_rpc_chain.py) ------------------------------------

def sc_rlp_roundtrip(P):
    enc, dec = P.rlp.rlp_encode, P.rlp.rlp_decode
    cases = [b"", b"\x01", b"dog", b"a" * 60, [b"cat", [b"", b"\x7f"]],
             [], [b"x" * 300, [b"y"] * 20]]
    for item in cases:
        assert dec(enc(item)) == item
    errors = [_raises(ValueError, lambda b=b: dec(b)) for b in (
        enc(b"dog") + b"\x00", b"\x85abc", b"\xc5\x83do")]
    return {"encoded": [enc(c).hex() for c in cases], "errors": errors}


def sc_signed_tx_recovers_sender(P):
    w = P.wallet.Wallet.from_hex(KEY_MINER)
    tx = P.rlp.Eip1559Tx(chain_id=CHAIN_ID, nonce=7,
                         max_priority_fee_per_gas=1, max_fee_per_gas=100,
                         gas_limit=21000, to="0x" + "e1" * 20, value=5,
                         data=b"\xde\xad")
    raw = tx.sign(w)
    dec = P.rlp.decode_signed_eip1559(raw)
    assert dec.sender == w.address and dec.tx == tx
    assert dec.tx_hash == tx.tx_hash(w)
    digest = bytes(range(32))
    r, s, rec = w.sign(digest)
    assert P.wallet.recover_address(digest, r, s, rec) == w.address
    return {"raw": raw.hex(), "sender": dec.sender, "hash": dec.tx_hash,
            "sig": [r, s, rec], "pub": w.public_key.hex()}


def sc_abi_roundtrip(P):
    types_ = ["address", "bytes32", "uint256", "bool", "bytes", "string",
              "uint64", "uint8"]
    values = ["0x" + "ab" * 20, b"\x01" * 32, 2**200, True, b"xyz" * 30,
              "hello", 2**40, 7]
    data = P.abi.abi_encode(types_, values)
    assert P.abi.abi_decode(types_, data) == values
    err = _raises(ValueError,
                  lambda: P.abi.abi_decode(["uint256"], b"\x00" * 16))
    return {"data": data.hex(), "error": err}


def sc_devnet_signed_task_submission(P):
    eng, dev, miner, user, mid = make_world(P)
    client = P.rpc_client.EngineRpcClient(DevnetTransport(P, dev),
                                          dev.engine_address, user,
                                          chain_id=CHAIN_ID)
    input_bytes = json.dumps({"prompt": "hi"}).encode()
    client.send("submitTask", [0, user.address, mid, 0, input_bytes])
    assert len(eng.tasks) == 1
    tid = next(iter(eng.tasks))
    raw = client.eth_call("tasks(bytes32)", ["bytes32"], ["0x" + tid.hex()])
    model, fee, owner, blocktime, version, cid = P.abi.abi_decode(
        ["bytes32", "uint256", "address", "uint64", "uint8", "bytes"], raw)
    assert model == bytes.fromhex(mid[2:]) and owner == user.address.lower()
    logs = client.get_logs("TaskSubmitted", 0, dev.engine.block_number)
    assert len(logs) == 1
    tx = client.get_transaction(logs[0]["transactionHash"])
    assert bytes.fromhex(tx["input"][2:]).endswith(
        input_bytes.ljust((len(input_bytes) + 31) // 32 * 32, b"\x00"))
    return {"view": raw.hex(), "tx": tx, **engine_state(eng, dev)}


def sc_devnet_rejects_nonce_and_chain_id(P):
    eng, dev, miner, user, mid = make_world(P)
    tx = P.rlp.Eip1559Tx(chain_id=CHAIN_ID, nonce=5,
                         max_priority_fee_per_gas=1, max_fee_per_gas=2,
                         gas_limit=100000, to=dev.engine_address, value=0,
                         data=bytes.fromhex("00000000"))
    nonce = _raises(P.devnet.DevnetError, lambda: dev.request(
        "eth_sendRawTransaction", ["0x" + tx.sign(miner).hex()]))
    tx2 = P.rlp.Eip1559Tx(chain_id=999, nonce=0, max_priority_fee_per_gas=1,
                          max_fee_per_gas=2, gas_limit=100000,
                          to=dev.engine_address, value=0, data=b"\x00" * 4)
    chain_id = _raises(P.devnet.DevnetError, lambda: dev.request(
        "eth_sendRawTransaction", ["0x" + tx2.sign(miner).hex()]))
    assert "nonce" in nonce and "chain id" in chain_id
    return {"nonce": nonce, "chain_id": chain_id, **engine_state(eng, dev)}


def sc_devnet_http_transport(P):
    eng, dev, miner, user, mid = make_world(P)
    server = dev.serve("127.0.0.1", 0)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        tr = P.rpc_client.JsonRpcTransport(f"http://127.0.0.1:{port}")
        block = int(tr.request("eth_blockNumber", []), 16)
        client = P.rpc_client.EngineRpcClient(tr, dev.engine_address, user,
                                              chain_id=CHAIN_ID)
        client.send("submitTask", [0, user.address, mid, 0, b"{}"])
        assert len(eng.tasks) == 1
        revert = _raises(P.rpc_client.RpcError, lambda: client.send(
            "claimSolution", ["0x" + "77" * 32]))
        assert "revert" in revert
    finally:
        server.shutdown()
        server.server_close()
    return {"block": block, "revert": revert, **engine_state(eng, dev)}


def sc_rpc_chain_reads(P):
    eng, dev, miner, user, mid = make_world(P)
    chain = make_chain(P, dev, miner)
    zero = "0x" + "00" * 32
    assert chain.get_task(zero) is None
    assert chain.get_solution(zero) is None
    assert chain.get_contestation(zero) is None
    out = {"version": chain.version(), "balance": chain.token_balance(),
           "staked": chain.validator_staked(),
           "min_claim": chain.min_claim_solution_time(), "now": chain.now}
    assert out["balance"] == 1000 * P.WAD and out["staked"] == 0
    assert out["min_claim"] == eng.min_claim_solution_time
    assert out["now"] == eng.now
    return out


def sc_validator_deposit_self_heals(P):
    eng, dev, miner, user, mid = make_world(P)
    chain = make_chain(P, dev, miner)
    assert chain.token_allowance(dev.engine_address) == 0
    chain.validator_deposit(10 * P.WAD)
    assert chain.validator_staked() == 10 * P.WAD
    assert chain.token_allowance(dev.engine_address) > 0
    return engine_state(eng, dev)


def sc_revert_maps_to_engine_error(P):
    eng, dev, miner, user, mid = make_world(P)
    chain = make_chain(P, dev, miner)
    return {"error": _raises(P.chain.EngineError, lambda: chain.
                             claim_solution("0x" + "42" * 32))}


def sc_event_polling(P):
    eng, dev, miner, user, mid = make_world(P)
    chain = make_chain(P, dev, miner)
    seen = []
    chain.subscribe(seen.append)
    make_chain(P, dev, user).submit_task(
        0, user.address, mid, 0, json.dumps({"prompt": "x"}).encode())
    assert chain.poll_events() == 1 and seen[0].name == "TaskSubmitted"
    args = seen[0].args
    tid = "0x" + args["id"].hex()
    assert args["sender"] == user.address.lower() and args["fee"] == 0
    assert isinstance(args["model"], bytes)
    assert chain.get_task_input_bytes(tid) == \
        json.dumps({"prompt": "x"}).encode()
    assert chain.poll_events() == 0    # replays are not re-delivered
    return {"events": [(e.name, {k: v.hex() if isinstance(v, bytes) else v
                                 for k, v in sorted(e.args.items())})
                       for e in seen]}


def sc_commit_reveal_claim(P):
    eng, dev, miner, user, mid = make_world(P)
    chain = make_chain(P, dev, miner)
    chain.validator_deposit(100 * P.WAD)
    make_chain(P, dev, user).submit_task(0, user.address, mid, 0, b"{}")
    chain.poll_events()
    tid = "0x" + next(iter(eng.tasks)).hex()
    cid = "0x1220" + "ab" * 32
    chain.signal_commitment(chain.generate_commitment(tid, cid))
    chain.submit_solution(tid, cid)
    sol = chain.get_solution(tid)
    assert sol is not None and sol.validator == miner.address.lower()
    dev.request("evm_increaseTime", [eng.min_claim_solution_time + 100])
    dev.request("evm_mine", [])
    before = chain.token_balance()
    chain.claim_solution(tid)
    assert eng.solutions[next(iter(eng.tasks))].claimed
    assert chain.token_balance() >= before
    return engine_state(eng, dev)


def sc_nonce_conflict_parsed_structurally(P):
    """A conflict is read from the error's MESSAGE field (the devnet's
    `nonce N != expected M`, or a geth phrase), never from calldata
    echoed in `data`."""
    RpcError = P.rpc_client.RpcError
    rc = P.rpc_chain
    cases = [RpcError("nonce 5 != expected 3"),
             RpcError("{'code': -32000, ...}", code=-32000,
                      message="err: nonce 12 != expected 11"),
             RpcError("server error", code=-32000,
                      message="internal failure",
                      data='{"input": "write a poem about a nonce"}'),
             RpcError("nonce mismatch somewhere"),
             RpcError("execution revert: no"),
             RpcError("nonce too low: next nonce 3, tx nonce 5")]
    out = [(rc.nonce_conflict(e), type(rc._engine_error(e)).__name__)
           for e in cases]
    assert out[:5] == [((5, 3), "EngineError"), ((12, 11), "EngineError"),
                       (None, "ChainRpcError"), (None, "ChainRpcError"),
                       (None, "EngineError")]
    return {"classified": out}


def sc_devnet_nonce_rejection_via_transport(P):
    """A wrong-nonce tx into the devnet surfaces as EngineError (a
    state-dependent retry), not as a retryable transport fault."""
    eng, dev, miner, user, mid = make_world(P)
    tx = P.rlp.Eip1559Tx(chain_id=CHAIN_ID, nonce=9,
                         max_priority_fee_per_gas=1, max_fee_per_gas=10,
                         gas_limit=100000, to=dev.engine_address, value=0,
                         data=b"")
    with pytest.raises(P.rpc_client.RpcError) as e:
        DevnetTransport(P, dev).request("eth_sendRawTransaction",
                                        ["0x" + tx.sign(miner).hex()])
    assert P.rpc_chain.nonce_conflict(e.value) == (9, 0)
    assert isinstance(P.rpc_chain._engine_error(e.value), P.chain.EngineError)
    return {"error": str(e.value)}


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_rlp_roundtrip, sc_signed_tx_recovers_sender, sc_abi_roundtrip,
    sc_devnet_signed_task_submission, sc_devnet_rejects_nonce_and_chain_id,
    sc_devnet_http_transport, sc_rpc_chain_reads,
    sc_validator_deposit_self_heals, sc_revert_maps_to_engine_error,
    sc_event_polling, sc_commit_reveal_claim,
    sc_nonce_conflict_parsed_structurally,
    sc_devnet_nonce_rejection_via_transport)}


@functools.cache
def _reference(name: str):
    return SCENARIOS[name](_pkg("arbius_tpu"))


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_rpc_chain_scenario_matches_reference(name, pkg):
    """The scenario's checks hold in `pkg`, and what it records equals a
    run of the reference's (for the reference itself: a second run)."""
    assert SCENARIOS[name](_pkg(pkg)) == _reference(name)


# -- MinerNode over the devnet, the tiny model on the CPU ---------------------

def _task(i):
    return {"prompt": f"a lighthouse, study {i}", "negative_prompt": "",
            "width": 128, "height": 128, "num_inference_steps": 2,
            "guidance_scale": 5.0 + i}


@pytest.fixture(scope="module")
def tiny():
    P = _pkg("arbius_tpu_torch")
    mid = "0x" + "00" * 32
    cfg = P.node.MiningConfig(compile_cache_dir=None, models=(
        P.node.ModelConfig(id=mid, template="anythingv3", tiny=True),))
    return P.node.build_registry(cfg, device="cpu").get(mid)


class Replay:
    """The reference's runner for the differential: the reference's PNG
    encoder over the port's uint8 images, keyed by seed."""

    def __init__(self, images):
        from arbius_tpu.codecs import encode_png

        self.images, self.encode = images, encode_png

    def __call__(self, hydrated, seed):
        return {"out-1.png": self.encode(self.images[seed])}

    def run_batch(self, items):
        return [self(h, s) for h, s in items]


def _mine_over_devnet(P, runner, *, pipeline: bool):
    """test_rpc_chain.py's end-to-end case with three tasks at canonical
    batch 2: poll logs -> hydrate -> solve -> signed commit -> signed
    reveal -> time travel -> signed claim."""
    eng, dev, miner, user, mid = make_world(P)
    chain = make_chain(P, dev, miner)
    registry = P.node.ModelRegistry()
    registry.register(P.node.RegisteredModel(
        id=mid, template=P.templates.load_template("anythingv3"),
        runner=runner))
    cfg = P.node.MiningConfig(
        compile_cache_dir=None, canonical_batch=2,
        models=(P.node.ModelConfig(id=mid, template="anythingv3"),),
        pipeline=P.config.PipelineConfig(enabled=pipeline, depth=2,
                                         encode_workers=2))
    node = P.node.MinerNode(chain, cfg, registry)
    node.boot(skip_self_test=True)
    user_chain = make_chain(P, dev, user)
    for i in range(3):
        user_chain.submit_task(0, user.address, mid, 0,
                               json.dumps(_task(i)).encode())
    for _ in range(6):
        node.tick()
    assert len(eng.solutions) == 3, node.db.failed_jobs()
    assert chain.validator_staked() >= eng.get_validator_minimum()
    dev.request("evm_increaseTime", [eng.min_claim_solution_time + 200])
    dev.request("evm_mine", [])
    for _ in range(4):
        node.tick()
    assert node.metrics.solutions_claimed == 3
    assert all(s.claimed for s in eng.solutions.values())
    node.close()
    return {"order": ["0x" + t.hex() for t in eng.tasks],
            **engine_state(eng, dev)}


@pytest.fixture(scope="module")
def port_mined(tiny):
    return _mine_over_devnet(_pkg("arbius_tpu_torch"), tiny.runner,
                             pipeline=False)


@pytest.fixture(scope="module")
def reference_mined(tiny, port_mined):
    """The reference's node over its devnet, mining the port's images of
    the port's run's tasks (the same taskids, if the chain writes agree)."""
    P = _pkg("arbius_tpu_torch")
    images = {}
    for i, tid in enumerate(port_mined["order"]):
        seed = P.commitment.taskid2seed(tid)
        h = P.templates.hydrate_input(_task(i), tiny.template)
        [images[seed]] = tiny.runner.pipeline.generate(
            [h["prompt"]], [h["negative_prompt"]], [seed], width=128,
            height=128, num_inference_steps=2,
            guidance_scale=[h["guidance_scale"]], scheduler=h["scheduler"])
    return _mine_over_devnet(_pkg("arbius_tpu"), Replay(images),
                             pipeline=False)


@pytest.mark.parametrize("pipeline", [False, True],
                         ids=["pipeline_off", "pipeline_on"])
def test_port_node_mines_over_devnet_as_reference(tiny, port_mined,
                                                  reference_mined, pipeline):
    """The port's MinerNode with the real tiny runner lands, byte for
    byte, the reference's chain writes (every raw transaction, log and
    the engine's state, each revealed CID included), pipeline on or
    off; and each revealed CID is the port's solve_cid_batch of the
    same (input, taskid2seed(taskid))."""
    P = _pkg("arbius_tpu_torch")
    got = (_mine_over_devnet(P, tiny.runner, pipeline=True) if pipeline
           else port_mined)
    assert got == reference_mined
    items = [(P.templates.hydrate_input(_task(i), tiny.template),
              P.commitment.taskid2seed(tid))
             for i, tid in enumerate(got["order"])]
    want = P.node.solve_cid_batch(tiny, items, canonical_batch=2)
    assert ["0x" + got["solutions"][tid[2:]][3].hex()
            for tid in got["order"]] == [c for c, _ in want]


def test_node_run_ticks_subprocess(tiny, tmp_path):
    """`python -m arbius_tpu_torch.cli node-run --device cpu --ticks N`
    as its own process against a devnet on localhost (chip_smoke.py
    phase 7's world, tiny model, bf16 weights, MiningConfig.example.json's
    node settings with the pipeline on and phase 7's alert engine): it
    boots with a golden from the port's record-golden, mines and claims
    three tasks, GET /metrics counts them and exports every alert rule's
    state with none firing, SIGTERM ends it with exit code 0 and its
    summary, and each revealed CID is the in-process solve's."""
    from arbius_tpu_torch.cli import record_golden
    from arbius_tpu_torch.l0 import taskid2seed
    from arbius_tpu_torch.obs.healthwatch import RULE_NAMES
    from arbius_tpu_torch.node import (
        MiningConfig,
        ModelConfig,
        build_registry,
        solve_cid_batch,
    )

    mid = "0x" + "00" * 32
    model = build_registry(MiningConfig(compile_cache_dir=None, models=(
        ModelConfig(id=mid, template="anythingv3", tiny=True,
                    weights_dtype="bfloat16"),)), device="cpu").get(mid)
    golden = record_golden(model, {**_task(9), "prompt": "arbius test cat"},
                           1337, canonical_batch=4, device="cpu")["golden"]
    inputs = [_task(i) for i in range(3)]
    got = chip_smoke.node_run_world(inputs, device="cpu", tiny=True,
                                    golden=golden, workdir=str(tmp_path),
                                    timeout=240,
                                    settings=chip_smoke.NODE_RUN_SETTINGS)
    summary = got["summary"]
    assert summary["solutions_submitted"] == 3
    assert summary["solutions_claimed"] == 3 and summary["failed_jobs"] == 0
    assert chip_smoke._metric_sum(
        got["metrics"], "arbius_solutions_submitted_total") == 3
    states = chip_smoke.alert_states(got["metrics"])
    assert set(states) == set(RULE_NAMES) and "firing" not in states.values()
    # CPU: no kernel, at boot or while mining
    assert set(summary["flash_launches"].values()) == {0}
    assert set(summary["flash_launches_boot"].values()) == {0}
    hydrate = _pkg("arbius_tpu_torch").templates.hydrate_input
    items = [(hydrate(dict(raw), model.template), taskid2seed(tid))
             for raw, tid in zip(inputs, got["tids"])]
    assert got["cids"] == [c for c, _ in solve_cid_batch(
        model, items, canonical_batch=4)]
