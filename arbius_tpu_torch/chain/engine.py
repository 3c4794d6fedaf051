"""In-process EngineV1 — the protocol state machine, faithfully in Python.

The reference has no miner-loop tests because testing needed a live chain
(SURVEY.md §4 gap). This fake engine closes that: the full task/solution/
contestation state machine of `contract/contracts/EngineV1.sol` runs
in-process with a controllable clock, so node integration tests cover
event → job → solve → commit → reveal → claim and every contestation
branch without an RPC endpoint.

Semantics mirrored 1:1 (each method cites its EngineV1.sol source):
task-id chaining through `prevhash`, commit-must-age-one-block, first
solution wins, fee splits, auto yea/nay votes on contestation, escrowed
slash per vote, paginated vote finish with ties siding nay, stake-age vote
gate, and the supply thresholds that turn on validator minimums and
slashing. Amounts are Python ints in wad (exact EVM uint semantics).

Events are appended to `self.events` and also pushed to subscribers —
the node's event loop consumes them exactly as it would ethers
`contract.on(...)` callbacks.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from arbius_tpu_torch.chain.fixedpoint import (
    BASE_TOKEN_STARTING_REWARD,
    STARTING_ENGINE_TOKEN_AMOUNT,
    WAD,
    diff_mul,
    reward,
    target_ts,
)
from arbius_tpu_torch.chain.token import TokenLedger
from arbius_tpu_torch.l0.abi import abi_encode
from arbius_tpu_torch.l0.cid import cid_onchain
from arbius_tpu_torch.l0.commitment import generate_commitment as l0_generate_commitment
from arbius_tpu_torch.l0.keccak import keccak256

# supply thresholds, EngineV1.sol:17-19
MIN_SUPPLY_FOR_VALIDATOR_DEPOSITS = 1_000 * WAD
MIN_SUPPLY_FOR_SLASHING = 2_000 * WAD

ZERO = "0x" + "00" * 20


def _addr(a: str) -> str:
    if not (isinstance(a, str) and a.startswith("0x") and len(a) == 42):
        raise ValueError(f"bad address {a!r}")
    return a.lower()


@dataclass
class Model:
    fee: int
    addr: str
    rate: int
    cid: bytes


@dataclass
class Validator:
    staked: int = 0
    since: int = 0
    addr: str = ZERO


@dataclass
class Task:
    model: bytes
    fee: int
    owner: str
    blocktime: int
    version: int
    cid: bytes


@dataclass
class Solution:
    validator: str
    blocktime: int
    claimed: bool
    cid: bytes


@dataclass
class Contestation:
    validator: str
    blocktime: int
    finish_start_index: int
    slash_amount: int


@dataclass
class Event:
    name: str
    args: dict


@dataclass
class WithdrawRequest:
    unlock_time: int
    amount: int


class EngineError(Exception):
    """Raised with the same revert strings the contract uses."""


class Engine:
    """EngineV1 state machine; `sender` plays msg.sender on each call."""

    ADDRESS = "0x" + "e1" * 20

    def __init__(self, token: TokenLedger | None = None, treasury: str = "0x" + "77" * 20,
                 start_time: int = 0, owner: str | None = None):
        self.token = token or TokenLedger()
        self.token.block_fn = lambda: self.block_number
        self.treasury = _addr(treasury)
        # owner/pauser roles (EngineV1.sol:73-74, both = deployer at init
        # :246-247; production transfers them to the timelock). None =
        # role checks disabled (in-process tests drive methods directly).
        self.owner = _addr(owner) if owner else None
        self.pauser = self.owner
        self.paused = False
        self.accrued_fees = 0
        self.prevhash = b"\x00" * 32
        self.start_block_time = start_time
        self.version = 0
        self.now = start_time
        self.block_number = 1

        # parameter block, EngineV1.sol:250-259
        self.validator_minimum_percentage = 8 * 10**14      # 0.08%
        self.slash_amount_percentage = 1 * 10**14           # 0.01%
        self.solution_fee_percentage = WAD // 10             # 10%
        self.retraction_fee_percentage = WAD // 10
        self.treasury_reward_percentage = WAD // 10
        self.min_claim_solution_time = 2000
        self.min_retraction_wait_time = 10000
        self.min_contestation_vote_period_time = 4000
        self.max_contestation_validator_stake_since = 120
        self.exit_validator_min_unlock_time = 86400

        self.models: dict[bytes, Model] = {}
        self.validators: dict[str, Validator] = {}
        self.tasks: dict[bytes, Task] = {}
        self.task_input_data: dict[bytes, bytes] = {}
        self.commitments: dict[bytes, int] = {}
        self.solutions: dict[bytes, Solution] = {}
        self.contestations: dict[bytes, Contestation] = {}
        self.contestation_voted: dict[bytes, set[str]] = {}
        self.contestation_yeas: dict[bytes, list[str]] = {}
        self.contestation_nays: dict[bytes, list[str]] = {}
        self.withdraw_requests: dict[str, dict[int, WithdrawRequest]] = {}
        self.withdraw_request_count: dict[str, int] = {}
        self.withdraw_pending: dict[str, int] = {}

        self.events: list[Event] = []
        self._subscribers: list[Callable[[Event], None]] = []

    # -- chain simulation -------------------------------------------------
    def subscribe(self, fn: Callable[[Event], None]) -> None:
        self._subscribers.append(fn)

    def _emit(self, name: str, **args) -> None:
        ev = Event(name, args)
        self.events.append(ev)
        for fn in self._subscribers:
            fn(ev)

    def advance_time(self, seconds: int, blocks: int = 1) -> None:
        self.now += seconds
        self.block_number += blocks

    def mine_block(self) -> None:
        self.block_number += 1

    def _not_paused(self):
        if self.paused:
            raise EngineError("paused")

    # -- supply / emission ------------------------------------------------
    def get_psuedo_total_supply(self) -> int:
        """EngineV1.sol:521-527 (sic: the contract spells it 'Psuedo')."""
        b = self.token.balance_of(self.ADDRESS)
        if b >= STARTING_ENGINE_TOKEN_AMOUNT:
            return 0
        return STARTING_ENGINE_TOKEN_AMOUNT - b

    def get_slash_amount(self) -> int:
        """EngineV1.sol:387-394."""
        ts = self.get_psuedo_total_supply()
        if ts < MIN_SUPPLY_FOR_SLASHING:
            return 0
        return ts - (ts * (WAD - self.slash_amount_percentage)) // WAD

    def get_validator_minimum(self) -> int:
        """EngineV1.sol:398-404."""
        ts = self.get_psuedo_total_supply()
        if ts < MIN_SUPPLY_FOR_VALIDATOR_DEPOSITS:
            return 0
        return ts - (ts * (WAD - self.validator_minimum_percentage)) // WAD

    def get_reward(self) -> int:
        """EngineV1.sol:531-533."""
        return reward(self.now - self.start_block_time,
                      self.get_psuedo_total_supply())

    # -- hashing ----------------------------------------------------------
    def hash_model(self, m: Model, sender: str) -> bytes:
        """EngineV1.sol:421-426: keccak(abi.encode(sender, addr, fee, cid))."""
        return keccak256(abi_encode(
            ["address", "address", "uint256", "bytes"],
            [sender, m.addr, m.fee, m.cid]))

    def hash_task(self, t: Task, sender: str, prevhash: bytes) -> bytes:
        """EngineV1.sol:431-438: keccak(abi.encode(sender, prevhash, model,
        fee, cid))."""
        return keccak256(abi_encode(
            ["address", "bytes32", "bytes32", "uint256", "bytes"],
            [sender, prevhash, t.model, t.fee, t.cid]))

    def generate_commitment(self, sender: str, taskid: bytes,
                            cid: bytes) -> bytes:
        """EngineV1.sol:537-543 ≡ miner utils.ts:42-49 (delegates to the
        single L0 implementation so the two can never diverge)."""
        return l0_generate_commitment(sender, taskid, cid)

    # -- validator lifecycle ---------------------------------------------
    def _validator(self, addr: str) -> Validator:
        return self.validators.setdefault(_addr(addr), Validator(addr=_addr(addr)))

    def _only_validator(self, sender: str):
        """onlyValidator modifier, EngineV1.sol:222-229: usable stake
        (staked minus pending withdraws) must cover the minimum."""
        v = self.validators.get(_addr(sender))
        usable = (v.staked if v else 0) - self.withdraw_pending.get(_addr(sender), 0)
        if usable < self.get_validator_minimum():
            raise EngineError("min staked too low")

    def validator_deposit(self, sender: str, validator: str, amount: int):
        """EngineV1.sol:581-604: anyone may top up; `since` resets only when
        the deposit crosses the minimum from below (stake-age gate input)."""
        self._not_paused()
        sender, validator = _addr(sender), _addr(validator)
        # token-level spender is the engine contract (ERC20 transferFrom)
        self.token.transfer_from(self.ADDRESS, sender, self.ADDRESS, amount)
        v = self._validator(validator)
        minimum = self.get_validator_minimum()
        if v.staked <= minimum and v.staked + amount >= minimum:
            v.since = self.now
        v.staked += amount
        self._emit("ValidatorDeposit", addr=sender, validator=validator,
                   amount=amount)

    def initiate_validator_withdraw(self, sender: str, amount: int) -> int:
        """EngineV1.sol:610-637: step 1, escrow the request until unlock."""
        self._not_paused()
        sender = _addr(sender)
        v = self._validator(sender)
        if v.staked - self.withdraw_pending.get(sender, 0) < amount:
            raise EngineError("")
        unlock = self.now + self.exit_validator_min_unlock_time
        count = self.withdraw_request_count.get(sender, 0) + 1
        self.withdraw_request_count[sender] = count
        self.withdraw_requests.setdefault(sender, {})[count] = \
            WithdrawRequest(unlock, amount)
        self.withdraw_pending[sender] = \
            self.withdraw_pending.get(sender, 0) + amount
        self._emit("ValidatorWithdrawInitiated", addr=sender, count=count,
                   unlockTime=unlock, amount=amount)
        return count

    def cancel_validator_withdraw(self, sender: str, count: int):
        """EngineV1.sol:641-651."""
        self._not_paused()
        sender = _addr(sender)
        req = self.withdraw_requests.get(sender, {}).get(count)
        if req is None:
            raise EngineError("request not exist")
        self.withdraw_pending[sender] -= req.amount
        del self.withdraw_requests[sender][count]
        self._emit("ValidatorWithdrawCancelled", addr=sender, count=count)

    def validator_withdraw(self, sender: str, count: int, to: str):
        """EngineV1.sol:656-672: step 2 after the unlock time."""
        self._not_paused()
        sender = _addr(sender)
        req = self.withdraw_requests.get(sender, {}).get(count)
        if req is None:
            raise EngineError("request not exist")
        if self.now < req.unlock_time:
            raise EngineError("wait longer")
        v = self._validator(sender)
        if v.staked < req.amount:
            raise EngineError("stake insufficient")
        self.token.transfer(self.ADDRESS, _addr(to), req.amount)
        v.staked -= req.amount
        self.withdraw_pending[sender] -= req.amount
        del self.withdraw_requests[sender][count]
        self._emit("ValidatorWithdraw", addr=sender, to=_addr(to),
                   count=count, amount=req.amount)

    # -- models -----------------------------------------------------------
    def register_model(self, sender: str, addr: str, fee: int,
                       template: bytes) -> bytes:
        """EngineV1.sol:557-575."""
        self._not_paused()
        if _addr(addr) == ZERO:
            raise EngineError("address must be non-zero")
        m = Model(fee=fee, addr=_addr(addr), rate=0, cid=cid_onchain(template))
        mid = self.hash_model(m, _addr(sender))
        if mid in self.models:
            raise EngineError("model already registered")
        self.models[mid] = m
        self._emit("ModelRegistered", id=mid)
        return mid

    def set_solution_mineable_rate(self, model: bytes, rate: int,
                                   *, sender: str | None = None):
        """EngineV1.sol:293-301 (onlyOwner; governance reaches it with the
        timelock as owner)."""
        self._only(sender, self.owner, "owner")
        if model not in self.models:
            raise EngineError("model does not exist")
        self.models[model].rate = rate
        self._emit("SolutionMineableRateChange", id=model, rate=rate)

    # -- tasks ------------------------------------------------------------
    def submit_task(self, sender: str, version: int, owner: str, model: bytes,
                    fee: int, input_: bytes) -> bytes:
        """EngineV1.sol:681-711: CID the input, chain the id via prevhash,
        escrow the fee."""
        self._not_paused()
        sender = _addr(sender)
        if model not in self.models:
            raise EngineError("model does not exist")
        if fee < self.models[model].fee:
            raise EngineError("lower fee than model fee")
        task = Task(model=model, fee=fee, owner=_addr(owner),
                    blocktime=self.now, version=version,
                    cid=cid_onchain(input_))
        tid = self.hash_task(task, sender, self.prevhash)
        self.token.transfer_from(self.ADDRESS, sender, self.ADDRESS, fee)
        self.tasks[tid] = task
        # calldata is public on-chain: miners recover the raw input from the
        # submitting tx (miner/src/index.ts:151-155); this models that
        self.task_input_data[tid] = bytes(input_)
        self.prevhash = tid
        # the contract emits before the transfer, but an EVM revert rolls
        # logs back; here exceptions don't, so emit only once state is final
        self._emit("TaskSubmitted", id=tid, model=model, fee=fee,
                   sender=sender)
        return tid

    def retract_task(self, sender: str, taskid: bytes):
        """EngineV1.sol:718-736: owner reclaims fee minus retraction cut
        after the wait, only while unsolved."""
        self._not_paused()
        t = self.tasks.get(taskid)
        if t is None or t.owner != _addr(sender):
            raise EngineError("not owner")
        if taskid in self.solutions:
            raise EngineError("has solution")
        if self.now - t.blocktime <= self.min_retraction_wait_time:
            raise EngineError("did not wait long enough")
        amount_minus_fee = (t.fee * (WAD - self.retraction_fee_percentage)) // WAD
        self.token.transfer(self.ADDRESS, _addr(sender), amount_minus_fee)
        self.accrued_fees += t.fee - amount_minus_fee
        del self.tasks[taskid]
        self._emit("TaskRetracted", id=taskid)

    def signal_support(self, sender: str, model: bytes, support: bool):
        """EngineV1.sol:775-781: validator-gated, event-only (indexer
        convenience — lets miners advertise which models they serve)."""
        self._only_validator(sender)
        if model not in self.models:
            raise EngineError("model does not exist")
        self._emit("SignalSupport", addr=_addr(sender), model=model,
                   support=support)

    # -- commit-reveal solutions -----------------------------------------
    def signal_commitment(self, sender: str, commitment: bytes):
        """EngineV1.sol:764-768: anyone may register, never reset."""
        self._not_paused()
        if self.commitments.get(commitment, 0) != 0:
            raise EngineError("commitment exists")
        self.commitments[commitment] = self.block_number
        self._emit("SignalCommitment", addr=_addr(sender),
                   commitment=commitment)

    def submit_solution(self, sender: str, taskid: bytes, cid: bytes):
        """EngineV1.sol:786-812: first reveal wins; commitment must exist
        and be at least one block old."""
        self._not_paused()
        sender = _addr(sender)
        self._only_validator(sender)
        if taskid not in self.tasks:
            raise EngineError("task does not exist")
        if taskid in self.solutions:
            raise EngineError("solution already submitted")
        commitment = self.generate_commitment(sender, taskid, cid)
        at = self.commitments.get(commitment, 0)
        if at == 0:
            raise EngineError("non existent commitment")
        if at >= self.block_number:
            raise EngineError("commitment must be in past")
        self.solutions[taskid] = Solution(validator=sender,
                                          blocktime=self.now,
                                          claimed=False, cid=cid)
        self._emit("SolutionSubmitted", addr=sender, task=taskid)

    def _claim_solution_fees_and_reward(self, taskid: bytes):
        """EngineV1.sol:819-862: model fee → model addr, 10% of the rest to
        treasury (accrued), remainder to the solver; mineable models add
        emission split 90/10 solver/treasury."""
        t = self.tasks[taskid]
        m = self.models[t.model]
        model_fee = m.fee if m.fee <= t.fee else 0
        if model_fee > 0:
            self.token.transfer(self.ADDRESS, m.addr, model_fee)
        remaining = t.fee - model_fee
        treasury_fee = remaining - (remaining * (WAD - self.solution_fee_percentage)) // WAD
        self.accrued_fees += treasury_fee
        validator_fee = remaining - treasury_fee
        if validator_fee > 0:
            self.token.transfer(self.ADDRESS, self.solutions[taskid].validator,
                                validator_fee)
        if m.rate > 0:
            total = (self.get_reward() * m.rate) // WAD
            if total > 0:
                treasury_reward = total - (total * (WAD - self.treasury_reward_percentage)) // WAD
                self.token.transfer(self.ADDRESS,
                                    self.solutions[taskid].validator,
                                    total - treasury_reward)
                self.token.transfer(self.ADDRESS, self.treasury,
                                    treasury_reward)

    def claim_solution(self, sender: str, taskid: bytes):
        """EngineV1.sol:867-889: anyone may claim after the delay; blocked
        while a contestation exists."""
        self._not_paused()
        sol = self.solutions.get(taskid)
        if sol is None:
            raise EngineError("solution not found")
        if taskid in self.contestations:
            raise EngineError("has contestation")
        if sol.blocktime >= self.now - self.min_claim_solution_time:
            raise EngineError("not enough delay")
        if sol.claimed:
            raise EngineError("already claimed")
        sol.claimed = True
        self._emit("SolutionClaimed", addr=sol.validator, task=taskid)
        self._claim_solution_fees_and_reward(taskid)

    # -- contestations ----------------------------------------------------
    def submit_contestation(self, sender: str, taskid: bytes):
        """EngineV1.sol:893-935: within the claim window only; snapshots the
        slash amount; contester auto-votes yea, accused auto-votes nay (if
        they still have the stake for the escrow)."""
        self._not_paused()
        sender = _addr(sender)
        self._only_validator(sender)
        sol = self.solutions.get(taskid)
        if sol is None:
            raise EngineError("solution does not exist")
        if taskid in self.contestations:
            raise EngineError("contestation already exists")
        if self.now >= sol.blocktime + self.min_claim_solution_time:
            raise EngineError("too late")
        if sol.claimed:
            raise EngineError("wtf")  # sic, EngineV1.sol:909
        slash = self.get_slash_amount()
        self.contestations[taskid] = Contestation(
            validator=sender, blocktime=self.now,
            finish_start_index=0, slash_amount=slash)
        self._emit("ContestationSubmitted", addr=sender, task=taskid)
        self._vote(taskid, True, sender)
        if self._validator(sol.validator).staked >= slash:
            self._vote(taskid, False, sol.validator)

    def validator_can_vote(self, addr: str, taskid: bytes) -> int:
        """EngineV1.sol:942-985: 0 = allowed, else reason code."""
        addr = _addr(addr)
        con = self.contestations.get(taskid)
        if con is None:
            return 0x01
        if self.now > con.blocktime + self.min_contestation_vote_period_time:
            return 0x02
        if addr in self.contestation_voted.get(taskid, set()):
            return 0x03
        v = self.validators.get(addr)
        if v is None or v.since == 0:
            return 0x04
        if v.since < self.max_contestation_validator_stake_since:
            return 0x05
        if v.since - self.max_contestation_validator_stake_since > con.blocktime:
            return 0x06
        return 0x00

    def _vote(self, taskid: bytes, yea: bool, addr: str):
        """EngineV1.sol:992-1012: record + escrow the slash immediately
        (refunded on the winning side at finish)."""
        self.contestation_voted.setdefault(taskid, set()).add(addr)
        side = self.contestation_yeas if yea else self.contestation_nays
        side.setdefault(taskid, []).append(addr)
        v = self._validator(addr)
        slash = self.contestations[taskid].slash_amount
        if v.staked < slash:
            raise EngineError("stake underflow")  # EVM would revert on sub
        v.staked -= slash
        self._emit("ContestationVote", addr=addr, task=taskid, yea=yea)

    def vote_on_contestation(self, sender: str, taskid: bytes, yea: bool):
        """EngineV1.sol:1015-1021."""
        self._not_paused()
        sender = _addr(sender)
        self._only_validator(sender)
        if self.validator_can_vote(sender, taskid) != 0:
            raise EngineError("not allowed")
        self._vote(taskid, yea, sender)

    def contestation_vote_finish(self, sender: str, taskid: bytes, amnt: int):
        """EngineV1.sol:1026-1106: paginated payout after the vote period.

        yeas > nays ⇒ contestation succeeds: yeas refunded + split the nays'
        escrow (originator gets half, or all if alone), task fee refunded to
        owner. Ties side with nays ⇒ solution stands: nays refunded + split
        yeas' escrow, solver paid via the normal claim path.
        """
        self._not_paused()
        con = self.contestations.get(taskid)
        if con is None:
            raise EngineError("contestation doesn't exist")
        if self.now < con.blocktime + self.min_contestation_vote_period_time:
            raise EngineError("voting period not ended")
        if amnt <= 0:
            raise EngineError("amnt too small")
        yeas = self.contestation_yeas.get(taskid, [])
        nays = self.contestation_nays.get(taskid, [])
        start_idx = con.finish_start_index
        end_idx = start_idx + amnt
        slash = con.slash_amount
        if len(yeas) > len(nays):
            total_val = len(nays) * slash
            val_to_originator = total_val if len(yeas) == 1 \
                else total_val - total_val // 2
            val_to_other_yeas = 0 if len(yeas) == 1 \
                else (total_val - val_to_originator) // (len(yeas) - 1)
            for i in range(start_idx, end_idx):
                if i < len(yeas):
                    a = yeas[i]
                    self._validator(a).staked += slash
                    self.token.transfer(
                        self.ADDRESS, a,
                        val_to_originator if i == 0 else val_to_other_yeas)
            if start_idx == 0:
                self.token.transfer(self.ADDRESS, self.tasks[taskid].owner,
                                    self.tasks[taskid].fee)
        else:
            total_val = len(yeas) * slash
            val_to_accused = total_val if len(nays) == 1 else total_val // 2
            val_to_other_nays = 0 if len(nays) == 1 \
                else (total_val - val_to_accused) // (len(nays) - 1)
            for i in range(start_idx, end_idx):
                if i < len(nays):
                    a = nays[i]
                    self._validator(a).staked += slash
                    self.token.transfer(
                        self.ADDRESS, a,
                        val_to_accused if i == 0 else val_to_other_nays)
            if start_idx == 0:
                self._claim_solution_fees_and_reward(taskid)
        con.finish_start_index = end_idx
        self._emit("ContestationVoteFinish", id=taskid, start_idx=start_idx,
                   end_idx=end_idx)

    # -- misc -------------------------------------------------------------
    def withdraw_accrued_fees(self):
        """EngineV1.sol:548-552."""
        self._not_paused()
        self.token.transfer(self.ADDRESS, self.treasury, self.accrued_fees)
        self.accrued_fees = 0

    def _only(self, sender: str | None, role: str | None, name: str):
        """onlyOwner/onlyPauser (EngineV1.sol:199-211). sender=None is the
        in-process/timelock caller (unrestricted — the governance path's
        implied msg.sender IS the authorized timelock); an RPC caller must
        match the configured role, and an unconfigured role authorizes
        nobody over RPC."""
        if sender is None:
            return
        if role is None or _addr(sender) != role:
            raise EngineError(f"not {name}")

    def set_paused(self, paused: bool, *, sender: str | None = None):
        self._only(sender, self.pauser, "pauser")
        self.paused = paused
        self._emit("PausedChanged", paused=paused)

    def transfer_pauser(self, to: str, *, sender: str | None = None):
        """EngineV1.sol:279-281."""
        self._only(sender, self.owner, "owner")
        self.pauser = _addr(to)
        self._emit("PauserTransferred", to=self.pauser)

    def transfer_ownership(self, to: str, *, sender: str | None = None):
        """OwnableUpgradeable surface (EngineV1.sol:266): the zero
        address is rejected — ownership would be irrecoverably burned."""
        self._only(sender, self.owner, "owner")
        if int(_addr(to)[2:], 16) == 0:
            raise EngineError("new owner is the zero address")
        prev = self.owner
        self.owner = _addr(to)
        # OZ OwnableUpgradeable event shape: (previousOwner, newOwner)
        self._emit("OwnershipTransferred", previous=prev or ZERO,
                   to=self.owner)

    # owner-tunable protocol parameters (EngineV1.sol:313-386): Solidity
    # setter name → engine attribute
    PARAMS = {
        "setValidatorMinimumPercentage": "validator_minimum_percentage",
        "setSlashAmountPercentage": "slash_amount_percentage",
        "setSolutionFeePercentage": "solution_fee_percentage",
        "setRetractionFeePercentage": "retraction_fee_percentage",
        "setTreasuryRewardPercentage": "treasury_reward_percentage",
        "setMinClaimSolutionTime": "min_claim_solution_time",
        "setMinRetractionWaitTime": "min_retraction_wait_time",
        "setMinContestationVotePeriodTime":
            "min_contestation_vote_period_time",
        "setMaxContestationValidatorStakeSince":
            "max_contestation_validator_stake_since",
        "setExitValidatorMinUnlockTime": "exit_validator_min_unlock_time",
    }

    def set_param(self, setter: str, value: int, *,
                  sender: str | None = None):
        """Owner-gated protocol-parameter setters, one per EngineV1
        onlyOwner function (the *Changed event per setter is collapsed to
        a generic ParamChanged — the devnet's log surface doesn't carry
        the per-setter events either)."""
        self._only(sender, self.owner, "owner")
        attr = self.PARAMS.get(setter)
        if attr is None:
            raise EngineError(f"unknown parameter setter {setter!r}")
        setattr(self, attr, int(value))
        self._emit("ParamChanged", setter=setter, value=int(value))

    def transfer_treasury(self, to: str, *, sender: str | None = None):
        """EngineV1.sol:272-275."""
        self._only(sender, self.owner, "owner")
        self.treasury = _addr(to)
        self._emit("TreasuryTransferred", to=self.treasury)

    def set_version(self, version: int, *, sender: str | None = None):
        self._only(sender, self.owner, "owner")
        self.version = version
        self._emit("VersionChanged", version=version)


# re-exported emission functions (the node uses them for profitability)
__all__ = ["Engine", "EngineError", "Event", "Model", "Task", "Solution",
           "Contestation", "Validator", "target_ts", "diff_mul", "reward",
           "BASE_TOKEN_STARTING_REWARD"]
