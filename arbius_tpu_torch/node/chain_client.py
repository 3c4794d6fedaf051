"""Chain client facade — the node's only window onto the protocol.

One interface, two backends: `LocalChain` wraps the in-process Engine
(tests, local mining); a JSON-RPC backend can implement the same surface
against Arbitrum later (`miner/src/blockchain.ts:22-36` equivalent). The
node never imports Engine directly, so the seam is explicit and narrow.

Hex-string convention at this boundary: task/model ids and CIDs cross as
0x-hex strings (what event logs and JSON carry); the facade converts to
the engine's bytes domain.
"""
from __future__ import annotations

from typing import Callable

from arbius_tpu_torch.chain import Engine, EngineError
from arbius_tpu_torch.obs import span


def _b(hexstr: str) -> bytes:
    return bytes.fromhex(hexstr[2:] if hexstr.startswith("0x") else hexstr)


def _h(b: bytes) -> str:
    return "0x" + b.hex()


class LocalChain:
    """The engine as seen by one wallet (`sender`).

    `validator_address` is the delegated-validator seam
    (blockchain.ts:44-67): stake reads/deposits target it; it defaults
    to the wallet itself (delegation disabled — reference parity)."""

    def __init__(self, engine: Engine, sender: str,
                 validator_address: str | None = None):
        self.engine = engine
        self.address = sender.lower()
        self.validator_address = (validator_address or sender).lower()

    # -- chain state -----------------------------------------------------
    @property
    def now(self) -> int:
        return self.engine.now

    def version(self) -> int:
        return self.engine.version

    def subscribe(self, fn: Callable) -> None:
        self.engine.subscribe(fn)

    def get_task(self, taskid: str):
        return self.engine.tasks.get(_b(taskid))

    def get_task_input_bytes(self, taskid: str) -> bytes | None:
        return self.engine.task_input_data.get(_b(taskid))

    def get_solution(self, taskid: str):
        return self.engine.solutions.get(_b(taskid))

    def get_contestation(self, taskid: str):
        return self.engine.contestations.get(_b(taskid))

    def validator_staked(self) -> int:
        v = self.engine.validators.get(self.validator_address)
        return v.staked if v else 0

    def validator_withdraw_pending(self) -> int:
        return self.engine.withdraw_pending.get(self.validator_address, 0)

    def get_validator_minimum(self) -> int:
        return self.engine.get_validator_minimum()

    def min_claim_solution_time(self) -> int:
        return self.engine.min_claim_solution_time

    def min_contestation_vote_period(self) -> int:
        return self.engine.min_contestation_vote_period_time

    def token_balance(self) -> int:
        return self.engine.token.balance_of(self.address)

    def validator_can_vote(self, taskid: str) -> int:
        return self.engine.validator_can_vote(self.address, _b(taskid))

    def contestation_voted(self, taskid: str) -> bool:
        return self.address in self.engine.contestation_voted.get(
            _b(taskid), set())

    # -- transactions ----------------------------------------------------
    # Each tx mines a block afterward (hardhat-automine style): on the real
    # chain a commit tx always lands in an earlier block than the reveal,
    # which the engine's "commitment must be in past" check requires.
    def _tx(self, fn, op: str = "tx"):
        with span("chain." + op):
            result = fn()
            self.engine.mine_block()
        return result

    def submit_task(self, version: int, owner: str, model: str, fee: int,
                    input_: bytes) -> str:
        return _h(self._tx(lambda: self.engine.submit_task(
            self.address, version, owner, _b(model), fee, input_),
            op="submit_task"))

    def ensure_fee_allowance(self, fee: int) -> None:
        """Approve the engine to pull `fee` before submitTask — EngineV1
        collects via transferFrom (the dapp's approve-then-submit)."""
        if fee and self.engine.token.allowances.get(
                (self.address, self.engine.ADDRESS), 0) < fee:
            self._tx(lambda: self.engine.token.approve(
                self.address, self.engine.ADDRESS, fee), op="approve")

    def signal_commitment(self, commitment: bytes) -> None:
        self._tx(lambda: self.engine.signal_commitment(
            self.address, commitment), op="signal_commitment")

    def submit_solution(self, taskid: str, cid: str) -> None:
        self._tx(lambda: self.engine.submit_solution(
            self.address, _b(taskid), _b(cid)), op="submit_solution")

    def claim_solution(self, taskid: str) -> None:
        self._tx(lambda: self.engine.claim_solution(
            self.address, _b(taskid)), op="claim_solution")

    def submit_contestation(self, taskid: str) -> None:
        self._tx(lambda: self.engine.submit_contestation(
            self.address, _b(taskid)), op="submit_contestation")

    def vote_on_contestation(self, taskid: str, yea: bool) -> None:
        self._tx(lambda: self.engine.vote_on_contestation(
            self.address, _b(taskid), yea), op="vote_on_contestation")

    def contestation_vote_finish(self, taskid: str, amnt: int) -> None:
        self._tx(lambda: self.engine.contestation_vote_finish(
            self.address, _b(taskid), amnt),
            op="contestation_vote_finish")

    def validator_deposit(self, amount: int) -> None:
        self._tx(lambda: self.engine.validator_deposit(
            self.address, self.validator_address, amount),
            op="validator_deposit")

    def generate_commitment(self, taskid: str, cid: str) -> bytes:
        return self.engine.generate_commitment(self.address, _b(taskid),
                                               _b(cid))


__all__ = ["LocalChain", "EngineError"]
