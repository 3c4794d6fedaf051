"""Arbitrum JSON-RPC chain client — the real-chain backend of the node's
chain facade.

Implements the same surface as `node.chain_client.LocalChain` against a
live JSON-RPC endpoint (the reference's ethers provider + typechain
contracts, `miner/src/blockchain.ts:22-36`), with everything in-repo:
ABI call encoding via L0, EIP-1559 signing via chain/rlp.py, transport
via urllib (no web3 dependency). Function selectors are
keccak(signature)[:4], exactly solc's.

Networkless environments can still exercise every layer below transport:
`call_data` / `decode_result` build and parse the exact bytes; tests pin
them against known-good vectors. The engine's event topics and struct
layouts mirror EngineV1.sol.
"""
from __future__ import annotations

import json
import urllib.request
from dataclasses import dataclass

from arbius_tpu_torch.chain.rlp import Eip1559Tx
from arbius_tpu_torch.chain.wallet import Wallet
from arbius_tpu_torch.l0.abi import abi_encode
from arbius_tpu_torch.l0.keccak import keccak256

ARBITRUM_NOVA_CHAINID = 0xA4BA


def selector(signature: str) -> bytes:
    return keccak256(signature.encode())[:4]


def call_data(signature: str, types: list[str], values: list) -> bytes:
    return selector(signature) + abi_encode(types, values)


def event_topic(signature: str) -> str:
    return "0x" + keccak256(signature.encode()).hex()


# EngineV1 external surface the miner uses (signatures from EngineV1.sol)
ENGINE_FNS = {
    "submitTask": ("submitTask(uint8,address,bytes32,uint256,bytes)",
                   ["uint8", "address", "bytes32", "uint256", "bytes"]),
    "signalCommitment": ("signalCommitment(bytes32)", ["bytes32"]),
    "submitSolution": ("submitSolution(bytes32,bytes)", ["bytes32", "bytes"]),
    "claimSolution": ("claimSolution(bytes32)", ["bytes32"]),
    "submitContestation": ("submitContestation(bytes32)", ["bytes32"]),
    "voteOnContestation": ("voteOnContestation(bytes32,bool)",
                           ["bytes32", "bool"]),
    "contestationVoteFinish": ("contestationVoteFinish(bytes32,uint32)",
                               ["bytes32", "uint32"]),
    "validatorDeposit": ("validatorDeposit(address,uint256)",
                         ["address", "uint256"]),
    "registerModel": ("registerModel(address,uint256,bytes)",
                      ["address", "uint256", "bytes"]),
    "withdrawAccruedFees": ("withdrawAccruedFees()", []),
    "retractTask": ("retractTask(bytes32)", ["bytes32"]),
    "signalSupport": ("signalSupport(bytes32,bool)", ["bytes32", "bool"]),
}

ENGINE_EVENTS = {
    "TaskSubmitted": "TaskSubmitted(bytes32,bytes32,uint256,address)",
    "SolutionSubmitted": "SolutionSubmitted(address,bytes32)",
    "ContestationSubmitted": "ContestationSubmitted(address,bytes32)",
    "SignalCommitment": "SignalCommitment(address,bytes32)",
    "VersionChanged": "VersionChanged(uint256)",
    "PausedChanged": "PausedChanged(bool)",
    "ProposalCreated": "ProposalCreated(bytes32,address)",
}


class RpcError(Exception):
    """JSON-RPC failure. When the endpoint answered a structured error
    object, `code`/`message`/`data` carry its fields; transport-level
    faults (socket death, timeouts) leave them None. Classifiers
    (node/rpc_chain._engine_error) must read `message` — the `data`
    field can echo request payloads (e.g. submitTask input bytes), so
    substring-scanning the stringified exception would let a task
    payload impersonate a revert or a nonce conflict."""

    def __init__(self, text: str, *, code: int | None = None,
                 message: str | None = None, data=None):
        super().__init__(text)
        self.code = code
        self.message = message if message is not None else text
        self.data = data


@dataclass
class JsonRpcTransport:
    url: str
    timeout: float = 30.0
    _id: int = 0

    def request(self, method: str, params: list):
        self._id += 1
        body = json.dumps({"jsonrpc": "2.0", "id": self._id,
                           "method": method, "params": params}).encode()
        req = urllib.request.Request(
            self.url, data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            payload = json.loads(r.read())
        if "error" in payload:
            err = payload["error"]
            if isinstance(err, dict):
                raise RpcError(str(err), code=err.get("code"),
                               message=str(err.get("message", "")),
                               data=err.get("data"))
            raise RpcError(str(err))
        return payload["result"]


class EngineRpcClient:
    """Signs and sends EngineV1 transactions; reads state via eth_call.

    `transport` is injectable (tests use a fake); production passes a
    JsonRpcTransport pointed at an Arbitrum endpoint.
    """

    def __init__(self, transport, engine_address: str, wallet: Wallet,
                 chain_id: int = ARBITRUM_NOVA_CHAINID, tx_guard=None):
        self.transport = transport
        self.engine_address = engine_address.lower()
        self.wallet = wallet
        self.chain_id = chain_id
        # fleet shared-wallet seam (docs/fleet.md): a context-manager
        # factory held across the nonce-read → sign → send window so
        # several processes sharing one wallet cannot draw the same
        # nonce. None = no coordination (the single-wallet default).
        self.tx_guard = tx_guard

    # -- reads -----------------------------------------------------------
    def eth_call(self, signature: str, types: list[str], values: list) -> bytes:
        return self.eth_call_to(self.engine_address, signature, types, values)

    def eth_call_to(self, address: str, signature: str, types: list[str],
                    values: list) -> bytes:
        data = call_data(signature, types, values)
        result = self.transport.request("eth_call", [{
            "to": address.lower(), "data": "0x" + data.hex()}, "latest"])
        return bytes.fromhex(result[2:])

    def block_number(self) -> int:
        return int(self.transport.request("eth_blockNumber", []), 16)

    def block_timestamp(self) -> int:
        blk = self.transport.request("eth_getBlockByNumber",
                                     ["latest", False])
        return int(blk["timestamp"], 16)

    def get_transaction(self, txhash: str) -> dict | None:
        return self.transport.request("eth_getTransactionByHash", [txhash])

    def nonce(self) -> int:
        return int(self.transport.request(
            "eth_getTransactionCount",
            [self.wallet.address, "pending"]), 16)

    def gas_fees(self) -> tuple[int, int]:
        base = int(self.transport.request("eth_gasPrice", []), 16)
        return base * 2, base // 10 or 1  # (max_fee, priority)

    # -- writes ----------------------------------------------------------
    def send(self, fn: str, values: list, *, gas_limit: int = 2_000_000,
             value: int = 0) -> str:
        signature, types = ENGINE_FNS[fn]
        return self.send_to(self.engine_address, signature, types, values,
                            gas_limit=gas_limit, value=value)

    def sign_call(self, address: str, signature: str, types: list[str],
                  values: list, *, gas_limit: int = 2_000_000,
                  value: int = 0) -> bytes:
        """Build + sign the EIP-1559 tx WITHOUT sending (nonce/gas read
        from the endpoint). The one tx-construction path: `send_to` is
        this + eth_sendRawTransaction, and the CLI's `--sign-only`
        user-wallet flow returns these bytes for the dapp's raw-tx form."""
        max_fee, priority = self.gas_fees()
        tx = Eip1559Tx(
            chain_id=self.chain_id, nonce=self.nonce(),
            max_priority_fee_per_gas=priority, max_fee_per_gas=max_fee,
            gas_limit=gas_limit, to=address.lower(), value=value,
            data=call_data(signature, types, values))
        return tx.sign(self.wallet)

    def sign_engine_call(self, fn: str, values: list, *,
                         gas_limit: int = 2_000_000, value: int = 0) -> bytes:
        signature, types = ENGINE_FNS[fn]
        return self.sign_call(self.engine_address, signature, types, values,
                              gas_limit=gas_limit, value=value)

    def send_to(self, address: str, signature: str, types: list[str],
                values: list, *, gas_limit: int = 2_000_000,
                value: int = 0) -> str:
        if self.tx_guard is None:
            raw = self.sign_call(address, signature, types, values,
                                 gas_limit=gas_limit, value=value)
            return self.transport.request("eth_sendRawTransaction",
                                          ["0x" + raw.hex()])
        # shared-wallet mode: the nonce MUST be read inside the guard —
        # signing outside it and sending inside would still race the
        # read (two workers sign nonce N, one send reverts)
        with self.tx_guard():
            raw = self.sign_call(address, signature, types, values,
                                 gas_limit=gas_limit, value=value)
            return self.transport.request("eth_sendRawTransaction",
                                          ["0x" + raw.hex()])

    # -- logs ------------------------------------------------------------
    def get_logs(self, event: str, from_block: int, to_block: int) -> list:
        topic = event_topic(ENGINE_EVENTS[event])
        return self.transport.request("eth_getLogs", [{
            "address": self.engine_address,
            "topics": [topic],
            "fromBlock": hex(from_block), "toBlock": hex(to_block)}])
