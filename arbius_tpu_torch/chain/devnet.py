"""In-process devnet: a JSON-RPC Ethereum node backed by the Engine.

The reference boots a local mining world with hardhat node + deploy
scripts (`setup_local.sh:1-24`, `contract/scripts/000-003`); here the
same role is played by one object: `DevnetNode` speaks enough of the
eth_* JSON-RPC surface for the real miner stack — wallet, EIP-1559
signing, `EngineRpcClient`, `RpcChain` — to mine against the in-process
EngineV1 state machine with **real signed transactions**. Raw txs are
RLP-decoded, the sender is recovered from the secp256k1 signature, and
the call data is ABI-decoded and applied, closing the
sign → RLP → decode → state-change loop the reference only exercises
against live Nova (`miner/test/utils.test.ts:60-69`).

`request(method, params)` is transport-compatible with
`JsonRpcTransport`, so tests inject a DevnetNode directly; `serve()`
exposes it over real HTTP for the CLI `devnet` command (hardhat-node
parity, incl. `evm_increaseTime`/`evm_mine`).
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from arbius_tpu_torch.chain.engine import Engine, EngineError
from arbius_tpu_torch.chain.governance import GovernanceError, Governor
from arbius_tpu_torch.chain.rlp import decode_signed_eip1559
from arbius_tpu_torch.chain.rpc_client import RpcError
from arbius_tpu_torch.l0.abi import abi_decode, abi_encode
from arbius_tpu_torch.l0.keccak import keccak256

TOKEN_ADDRESS = "0x" + "70" * 20
GOVERNOR_ADDRESS = "0x" + "60" * 20

_ZERO32 = b"\x00" * 32


def _selector(signature: str) -> bytes:
    return keccak256(signature.encode())[:4]


def _h32(b: bytes) -> str:
    return "0x" + b.hex()


# Event ABI (EngineV1.sol:141-206): name -> (signature, [(arg, type, indexed)]).
# arg names match the in-process engine's `_emit` kwargs so a decoded log
# reproduces the exact Event.args dict the node's handlers consume.
EVENT_ABI = {
    "TaskSubmitted": ("TaskSubmitted(bytes32,bytes32,uint256,address)", [
        ("id", "bytes32", True), ("model", "bytes32", True),
        ("fee", "uint256", False), ("sender", "address", True)]),
    "TaskRetracted": ("TaskRetracted(bytes32)", [("id", "bytes32", True)]),
    "SignalSupport": ("SignalSupport(address,bytes32,bool)", [
        ("addr", "address", True), ("model", "bytes32", True),
        ("support", "bool", False)]),
    "SignalCommitment": ("SignalCommitment(address,bytes32)", [
        ("addr", "address", True), ("commitment", "bytes32", True)]),
    "SolutionSubmitted": ("SolutionSubmitted(address,bytes32)", [
        ("addr", "address", True), ("task", "bytes32", True)]),
    "SolutionClaimed": ("SolutionClaimed(address,bytes32)", [
        ("addr", "address", True), ("task", "bytes32", True)]),
    "ContestationSubmitted": ("ContestationSubmitted(address,bytes32)", [
        ("addr", "address", True), ("task", "bytes32", True)]),
    "ContestationVote": ("ContestationVote(address,bytes32,bool)", [
        ("addr", "address", True), ("task", "bytes32", True),
        ("yea", "bool", False)]),
    "VersionChanged": ("VersionChanged(uint256)", [
        ("version", "uint256", False)]),
    "PausedChanged": ("PausedChanged(bool)", [
        ("paused", "bool", False)]),
    "PauserTransferred": ("PauserTransferred(address)", [
        ("to", "address", True)]),
    "OwnershipTransferred": (
        "OwnershipTransferred(address,address)", [
            ("previous", "address", True), ("to", "address", True)]),
    "TreasuryTransferred": ("TreasuryTransferred(address)", [
        ("to", "address", True)]),
    "ProposalCreated": ("ProposalCreated(bytes32,address)", [
        ("id", "bytes32", True), ("proposer", "address", True)]),
}

EVENT_TOPIC0 = {name: keccak256(sig.encode())
                for name, (sig, _) in EVENT_ABI.items()}


class DevnetError(RpcError):
    """JSON-RPC level error (revert reason or bad request).

    Subclasses RpcError so a DevnetNode injected directly as a transport
    (its `request` is JsonRpcTransport-compatible) surfaces reverts the
    way every RpcError consumer expects."""


class DevnetNode:
    """One Engine + one token, served over JSON-RPC semantics."""

    def __init__(self, engine: Engine | None = None,
                 chain_id: int = 31337):
        self.engine = engine or Engine()
        self.chain_id = chain_id
        self.engine_address = self.engine.ADDRESS.lower()
        self.token_address = TOKEN_ADDRESS
        self._lock = threading.Lock()
        self.txs: dict[str, dict] = {}        # txhash -> tx record
        self.nonces: dict[str, int] = {}
        self.logs: list[dict] = []
        self._current_txhash: str | None = None
        self.engine.subscribe(self._record_event)

        eng = self.engine

        def dispatch(fn_name):
            # sender-first engine methods keyed by ABI signature
            return {
                "submitTask(uint8,address,bytes32,uint256,bytes)":
                    lambda s, v: eng.submit_task(
                        s, v[0], v[1], v[2], v[3], v[4]),
                "signalCommitment(bytes32)":
                    lambda s, v: eng.signal_commitment(s, v[0]),
                "submitSolution(bytes32,bytes)":
                    lambda s, v: eng.submit_solution(s, v[0], v[1]),
                "claimSolution(bytes32)":
                    lambda s, v: eng.claim_solution(s, v[0]),
                "submitContestation(bytes32)":
                    lambda s, v: eng.submit_contestation(s, v[0]),
                "voteOnContestation(bytes32,bool)":
                    lambda s, v: eng.vote_on_contestation(s, v[0], v[1]),
                "contestationVoteFinish(bytes32,uint32)":
                    lambda s, v: eng.contestation_vote_finish(s, v[0], v[1]),
                "validatorDeposit(address,uint256)":
                    lambda s, v: eng.validator_deposit(s, v[0], v[1]),
                "registerModel(address,uint256,bytes)":
                    lambda s, v: eng.register_model(s, v[0], v[1], v[2]),
                "retractTask(bytes32)":
                    lambda s, v: eng.retract_task(s, v[0]),
                "signalSupport(bytes32,bool)":
                    lambda s, v: eng.signal_support(s, v[0], v[1]),
            }[fn_name]

        self._engine_writes = {}
        for sig in ("submitTask(uint8,address,bytes32,uint256,bytes)",
                    "signalCommitment(bytes32)",
                    "submitSolution(bytes32,bytes)",
                    "claimSolution(bytes32)",
                    "submitContestation(bytes32)",
                    "voteOnContestation(bytes32,bool)",
                    "contestationVoteFinish(bytes32,uint32)",
                    "validatorDeposit(address,uint256)",
                    "registerModel(address,uint256,bytes)",
                    "retractTask(bytes32)",
                    "signalSupport(bytes32,bool)"):
            types = sig[sig.index("(") + 1:-1].split(",")
            self._engine_writes[_selector(sig)] = (types, dispatch(sig))
        # treasury sweep (EngineV1.sol:544-552) — no arguments
        self._engine_writes[_selector("withdrawAccruedFees()")] = (
            [], lambda s, v: eng.withdraw_accrued_fees())
        # owner/pauser-gated admin surface (EngineV1.sol:266-306) — the
        # direct form of the calls governance reaches via the timelock
        self._engine_writes[_selector("setPaused(bool)")] = (
            ["bool"], lambda s, v: eng.set_paused(v[0], sender=s))
        self._engine_writes[_selector("setVersion(uint256)")] = (
            ["uint256"], lambda s, v: eng.set_version(v[0], sender=s))
        self._engine_writes[_selector("transferPauser(address)")] = (
            ["address"], lambda s, v: eng.transfer_pauser(v[0], sender=s))
        self._engine_writes[_selector("transferOwnership(address)")] = (
            ["address"], lambda s, v: eng.transfer_ownership(v[0], sender=s))

        self._token_writes = {
            _selector("approve(address,uint256)"): (
                ["address", "uint256"],
                lambda s, v: eng.token.approve(s, v[0], v[1])),
            _selector("transfer(address,uint256)"): (
                ["address", "uint256"],
                lambda s, v: eng.token.transfer(s, v[0], v[1])),
            _selector("delegate(address)"): (
                ["address"],
                lambda s, v: eng.token.delegate(s, v[0])),
        }

        # -- governor (GovernorV1/TimelockV1 over RPC) --------------------
        # Our ABI codec has no dynamic arrays, so the RPC surface takes
        # SINGLE-action proposals: propose(target, value, calldata,
        # description). Multi-action proposals stay available in-process
        # (chain/governance.py); the reference CLI's governance verbs
        # (`contract/tasks/index.ts:244-360`) are likewise one action per
        # proposal in practice.
        self.governor = Governor(eng)
        self.governor_address = GOVERNOR_ADDRESS

        # calls a passed proposal may execute, dispatched by (target,
        # selector) with the timelock as the implied sender — the
        # governance-gated admin surface (setSolutionMineableRate via
        # governance: `contract/test/governance.test.ts:128-444`)
        self._timelock_calls = {
            (self.engine_address,
             _selector("setSolutionMineableRate(bytes32,uint256)")): (
                # same timelock-identity rule as setPaused below: with a
                # configured owner the onlyOwner check applies to the
                # governor exactly as EngineV1.sol:293 would
                ["bytes32", "uint256"],
                lambda v: eng.set_solution_mineable_rate(
                    v[0], v[1], sender=(self.governor_address
                                        if eng.owner is not None
                                        else None))),
            (self.engine_address, _selector("setPaused(bool)")): (
                # the timelock executes as the governor identity: with a
                # configured pauser the role check applies to it exactly
                # as EngineV1's onlyPauser would (production transfers the
                # role to the timelock; a devnet that moved it elsewhere
                # must see this revert); unconfigured roles keep the
                # legacy unrestricted path
                ["bool"], lambda v: eng.set_paused(
                    v[0], sender=(self.governor_address
                                  if eng.pauser is not None else None))),
        }

        # every owner-tunable parameter setter, governable via the
        # timelock and callable directly by the owner (EngineV1.sol:306-386)
        self._param_views: dict = {}
        for _setter in Engine.PARAMS:
            _sig = f"{_setter}(uint256)"
            self._timelock_calls[(self.engine_address,
                                  _selector(_sig))] = (
                ["uint256"],
                lambda v, _s=_setter: eng.set_param(
                    _s, v[0], sender=(self.governor_address
                                      if eng.owner is not None else None)))
            self._engine_writes[_selector(_sig)] = (
                ["uint256"],
                lambda s, v, _s=_setter: eng.set_param(_s, v[0], sender=s))
            # matching eth_call getter (solidity public-var accessor name:
            # setter minus the 'set' prefix, lowerCamel)
            _getter = _setter[3].lower() + _setter[4:] + "()"
            _attr = Engine.PARAMS[_setter]
            self._param_views[_selector(_getter)] = (
                [], ["uint256"],
                lambda v, _a=_attr: [getattr(eng, _a)])
        self._timelock_calls[(self.engine_address,
                              _selector("transferTreasury(address)"))] = (
            ["address"],
            lambda v: eng.transfer_treasury(
                v[0], sender=(self.governor_address
                              if eng.owner is not None else None)))
        self._engine_writes[_selector("transferTreasury(address)")] = (
            ["address"], lambda s, v: eng.transfer_treasury(v[0], sender=s))

        def _gov_action(target: str, value: int, calldata: bytes):
            if value != 0:
                raise DevnetError("devnet proposals cannot carry ETH value")
            key = (target.lower(), calldata[:4])
            if key not in self._timelock_calls:
                raise DevnetError(
                    f"no governance-executable call at {target} for "
                    f"{calldata[:4].hex()}")
            types, fn = self._timelock_calls[key]
            values = abi_decode(types, calldata[4:])
            return lambda: fn(values)

        def _propose(s, v):
            action = _gov_action(v[0], v[1], v[2])
            # bind the id to the action content like OZ (targets, values,
            # calldatas): same-description proposals with different
            # calldata must not collide
            digest = keccak256(abi_encode(
                ["address", "uint256", "bytes"], [v[0], v[1], v[2]]))
            return self.governor.propose(s, [action], v[3], digest=digest)

        self._governor_writes = {
            _selector("propose(address,uint256,bytes,string)"): (
                ["address", "uint256", "bytes", "string"], _propose),
            _selector("castVote(bytes32,uint8)"): (
                ["bytes32", "uint8"],
                lambda s, v: self.governor.cast_vote(s, v[0], v[1])),
            _selector("queue(bytes32)"): (
                ["bytes32"], lambda s, v: self.governor.queue(v[0])),
            _selector("execute(bytes32)"): (
                ["bytes32"], lambda s, v: self.governor.execute(v[0])),
            _selector("cancel(bytes32)"): (
                ["bytes32"], lambda s, v: self.governor.cancel(s, v[0])),
        }

        def _gov_proposal(pid: bytes):
            p = self.governor.proposals.get(pid)
            if p is None:
                raise DevnetError("unknown proposal")
            return p

        self._governor_views = {
            _selector("state(bytes32)"): (
                ["bytes32"], ["uint8"],
                lambda v: [self.governor.state(v[0]).value]),
            _selector("proposalVotes(bytes32)"): (
                ["bytes32"], ["uint256", "uint256", "uint256"],
                lambda v: [_gov_proposal(v[0]).against_votes,
                           _gov_proposal(v[0]).for_votes,
                           _gov_proposal(v[0]).abstain_votes]),
            _selector("proposalSnapshot(bytes32)"): (
                ["bytes32"], ["uint256"],
                lambda v: [_gov_proposal(v[0]).snapshot_block]),
            _selector("proposalDeadline(bytes32)"): (
                ["bytes32"], ["uint256"],
                lambda v: [_gov_proposal(v[0]).deadline_block]),
            _selector("proposalEta(bytes32)"): (
                ["bytes32"], ["uint256"],
                lambda v: [_gov_proposal(v[0]).eta or 0]),
        }

        # views: selector -> (arg types, result types, fn(values) -> list)
        def _task(v):
            t = eng.tasks.get(v[0])
            return ([t.model, t.fee, t.owner, t.blocktime, t.version, t.cid]
                    if t else [_ZERO32, 0, "0x" + "00" * 20, 0, 0, b""])

        def _solution(v):
            s = eng.solutions.get(v[0])
            return ([s.validator, s.blocktime, s.claimed, s.cid]
                    if s else ["0x" + "00" * 20, 0, False, b""])

        def _contestation(v):
            c = eng.contestations.get(v[0])
            return ([c.validator, c.blocktime, c.finish_start_index,
                     c.slash_amount]
                    if c else ["0x" + "00" * 20, 0, 0, 0])

        def _validator(v):
            w = eng.validators.get(v[0].lower())
            return ([w.staked, w.since, w.addr]
                    if w else [0, 0, "0x" + "00" * 20])

        def _model(v):
            m = eng.models.get(v[0])
            return ([m.fee, m.addr, m.rate, m.cid]
                    if m else [0, "0x" + "00" * 20, 0, b""])

        self._engine_views = {
            **self._param_views,  # solidity public-var accessors per param
            _selector("accruedFees()"): (
                [], ["uint256"], lambda v: [eng.accrued_fees]),
            _selector("treasury()"): (
                [], ["address"], lambda v: [eng.treasury]),
            _selector("models(bytes32)"): (
                ["bytes32"], ["uint256", "address", "uint256", "bytes"],
                _model),
            _selector("tasks(bytes32)"): (
                ["bytes32"],
                ["bytes32", "uint256", "address", "uint64", "uint8", "bytes"],
                _task),
            _selector("solutions(bytes32)"): (
                ["bytes32"], ["address", "uint64", "bool", "bytes"],
                _solution),
            _selector("contestations(bytes32)"): (
                ["bytes32"], ["address", "uint64", "uint32", "uint256"],
                _contestation),
            _selector("validators(address)"): (
                ["address"], ["uint256", "uint256", "address"], _validator),
            _selector("commitments(bytes32)"): (
                ["bytes32"], ["uint256"],
                lambda v: [eng.commitments.get(v[0], 0)]),
            _selector("validatorWithdrawPendingAmount(address)"): (
                ["address"], ["uint256"],
                lambda v: [eng.withdraw_pending.get(v[0].lower(), 0)]),
            _selector("getValidatorMinimum()"): (
                [], ["uint256"], lambda v: [eng.get_validator_minimum()]),
            _selector("minClaimSolutionTime()"): (
                [], ["uint256"], lambda v: [eng.min_claim_solution_time]),
            _selector("minContestationVotePeriodTime()"): (
                [], ["uint256"],
                lambda v: [eng.min_contestation_vote_period_time]),
            _selector("version()"): (
                [], ["uint256"], lambda v: [eng.version]),
            _selector("prevhash()"): (
                [], ["bytes32"], lambda v: [eng.prevhash]),
            _selector("contestationVoted(bytes32,address)"): (
                ["bytes32", "address"], ["bool"],
                lambda v: [v[1].lower() in
                           eng.contestation_voted.get(v[0], set())]),
            _selector("validatorCanVote(address,bytes32)"): (
                ["address", "bytes32"], ["uint256"],
                lambda v: [eng.validator_can_vote(v[0], v[1])]),
        }
        self._token_views = {
            _selector("balanceOf(address)"): (
                ["address"], ["uint256"],
                lambda v: [eng.token.balance_of(v[0])]),
            _selector("allowance(address,address)"): (
                ["address", "address"], ["uint256"],
                lambda v: [eng.token.allowances.get(
                    (v[0].lower(), v[1].lower()), 0)]),
        }

    # -- event → log ------------------------------------------------------
    def _record_event(self, ev) -> None:
        abi = EVENT_ABI.get(ev.name)
        if abi is None:
            return
        _, fields = abi
        topics = [_h32(EVENT_TOPIC0[ev.name])]
        data_types, data_values = [], []
        for arg, typ, indexed in fields:
            value = ev.args[arg]
            if indexed:
                topics.append(_h32(abi_encode([typ], [value])))
            else:
                data_types.append(typ)
                data_values.append(value)
        self.logs.append({
            "address": self.engine_address,
            "topics": topics,
            "data": "0x" + abi_encode(data_types, data_values).hex(),
            # the tx lands in the block BEING mined (block_number + 1
            # after the automine), not the already-reported latest one: a
            # poller that saw latest=N must find this log at N+1, or any
            # event racing a poll of the same number is lost forever
            # (found by simnet's clean scenario)
            "blockNumber": hex(self.engine.block_number + 1),
            "transactionHash": self._current_txhash or "0x" + "00" * 32,
            "logIndex": hex(len(self.logs)),
        })

    # -- JSON-RPC surface --------------------------------------------------
    def request(self, method: str, params: list):
        """Transport-compatible entry point (raises DevnetError on revert)."""
        with self._lock:
            return self._request(method, params)

    def _request(self, method: str, params: list):
        eng = self.engine
        if method == "eth_chainId":
            return hex(self.chain_id)
        if method == "eth_blockNumber":
            return hex(eng.block_number)
        if method == "eth_gasPrice":
            return hex(10**8)
        if method == "eth_getTransactionCount":
            return hex(self.nonces.get(params[0].lower(), 0))
        if method == "eth_getBlockByNumber":
            return {"number": hex(eng.block_number),
                    "timestamp": hex(eng.now)}
        if method == "eth_getTransactionByHash":
            return self.txs.get(params[0])
        if method == "eth_call":
            return self._eth_call(params[0])
        if method == "eth_getLogs":
            return self._eth_get_logs(params[0])
        if method == "eth_sendRawTransaction":
            return self._send_raw(params[0])
        if method == "evm_increaseTime":
            eng.advance_time(int(params[0]), blocks=0)
            return hex(int(params[0]))
        if method == "evm_mine":
            # standard semantics: optional param is a TIMESTAMP for the
            # mined block (ganache/hardhat), never a count
            if params:
                ts = (int(params[0], 16) if isinstance(params[0], str)
                      else int(params[0]))
                if ts > eng.now:
                    eng.advance_time(ts - eng.now, blocks=0)
            eng.mine_block()
            return hex(eng.block_number)
        if method == "hardhat_mine":
            # batch mining lives under its real hardhat name, so voting
            # delays of thousands of blocks don't need thousands of calls
            count = (int(params[0], 16) if isinstance(params[0], str)
                     else int(params[0])) if params else 1
            for _ in range(count):
                eng.mine_block()
            return hex(eng.block_number)
        raise DevnetError(f"method {method} not supported")

    def _eth_call(self, call: dict) -> str:
        to = call["to"].lower()
        data = bytes.fromhex(call["data"][2:])
        views = (self._engine_views if to == self.engine_address
                 else self._token_views if to == self.token_address
                 else self._governor_views if to == self.governor_address
                 else None)
        if views is None or data[:4] not in views:
            raise DevnetError(f"no view at {to} for {data[:4].hex()}")
        arg_types, ret_types, fn = views[data[:4]]
        values = abi_decode(arg_types, data[4:])
        try:
            result = fn(values)
        except (EngineError, GovernanceError, ValueError) as e:
            raise DevnetError(f"execution reverted: {e}") from None
        return "0x" + abi_encode(ret_types, result).hex()

    def _eth_get_logs(self, flt: dict) -> list:
        frm = int(flt.get("fromBlock", "0x0"), 16)
        to = flt.get("toBlock", "latest")
        to = self.engine.block_number if to == "latest" else int(to, 16)
        topics = flt.get("topics") or []
        address = flt.get("address", "").lower()
        out = []
        for lg in self.logs:
            if address and lg["address"] != address:
                continue
            blk = int(lg["blockNumber"], 16)
            if not frm <= blk <= to:
                continue
            if topics and topics[0] is not None and \
                    lg["topics"][0] != topics[0]:
                continue
            out.append(lg)
        return out

    def _send_raw(self, raw_hex: str) -> str:
        raw = bytes.fromhex(raw_hex[2:])
        dec = decode_signed_eip1559(raw)
        if dec.tx.chain_id != self.chain_id:
            raise DevnetError(
                f"wrong chain id {dec.tx.chain_id} != {self.chain_id}")
        sender = dec.sender.lower()
        expected = self.nonces.get(sender, 0)
        if dec.tx.nonce != expected:
            raise DevnetError(f"nonce {dec.tx.nonce} != expected {expected}")
        to = (dec.tx.to or "").lower()
        writes = (self._engine_writes if to == self.engine_address
                  else self._token_writes if to == self.token_address
                  else self._governor_writes if to == self.governor_address
                  else None)
        sel = dec.tx.data[:4]
        if writes is None or sel not in writes:
            raise DevnetError(f"no method at {to} for {sel.hex()}")
        types, fn = writes[sel]
        values = abi_decode(types, dec.tx.data[4:])
        txhash = _h32(dec.tx_hash)
        self._current_txhash = txhash
        try:
            fn(sender, values)
        except (EngineError, GovernanceError, ValueError) as e:
            # ValueError: TokenLedger's ERC20 reverts
            raise DevnetError(f"execution reverted: {e}") from None
        finally:
            self._current_txhash = None
        # tx accepted: consume nonce, mine its block (automine, as the
        # reference's hardhat localnet does)
        self.nonces[sender] = expected + 1
        self.txs[txhash] = {
            "hash": txhash, "from": dec.sender,
            "to": dec.tx.to, "nonce": hex(dec.tx.nonce),
            "input": "0x" + dec.tx.data.hex(),
            # same block-numbering rule as the logs: the tx lands in the
            # block the automine below seals
            "blockNumber": hex(self.engine.block_number + 1),
        }
        self.engine.mine_block()
        return txhash

    # -- HTTP serving ------------------------------------------------------
    def serve(self, host: str = "127.0.0.1", port: int = 8545):
        """Serve JSON-RPC over HTTP; returns the server (use
        server.serve_forever() / .shutdown())."""
        node = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802 (http.server API)
                length = int(self.headers.get("Content-Length", 0))
                req_id = None
                try:
                    req = json.loads(self.rfile.read(length))
                    req_id = req.get("id")
                    result = node.request(req["method"],
                                          req.get("params", []))
                    body = {"jsonrpc": "2.0", "id": req_id,
                            "result": result}
                except DevnetError as e:
                    body = {"jsonrpc": "2.0", "id": req_id,
                            "error": {"code": -32000, "message": str(e)}}
                except Exception as e:  # noqa: BLE001 — malformed request
                    body = {"jsonrpc": "2.0", "id": req_id,
                            "error": {"code": -32600, "message": repr(e)}}
                payload = json.dumps(body, sort_keys=True).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def log_message(self, *a):  # quiet
                pass

        server = ThreadingHTTPServer((host, port), Handler)
        return server
