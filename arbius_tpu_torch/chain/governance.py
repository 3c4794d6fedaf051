"""Governance layer — GovernorV1 + TimelockV1 semantics in-process.

Mirror of `contract/contracts/GovernorV1.sol` (OZ Governor Bravo-compat:
votingDelay = votingPeriod = 6575 blocks, proposalThreshold 1e18, quorum
4% of past total supply, timelock execution) and `TimelockV1.sol`, over
the same fake chain the engine runs on — so the reference's governance
test flow (delegate → propose → vote → queue → execute,
`contract/test/governance.test.ts:128-444`) runs in-process.

Votes come from ERC20Votes-style delegation checkpoints added to
`TokenLedger` (delegate_votes / checkpoints); proposal actions are Python
callables (the fake-chain analogue of calldatas), and the proposal id
binds the action list + description hash like the OZ implementation.
Description CIDs are stored via the L0 on-chain CID (getIPFSCIDMemory
parity, `GovernorV1.sol` descriptionCids).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Callable

from arbius_tpu_torch.l0.abi import abi_encode
from arbius_tpu_torch.l0.cid import cid_onchain
from arbius_tpu_torch.l0.keccak import keccak256

VOTING_DELAY = 6575       # blocks (GovernorV1.sol GovernorSettings)
VOTING_PERIOD = 6575
PROPOSAL_THRESHOLD = 10**18
QUORUM_FRACTION = 4       # percent of past total supply
TIMELOCK_MIN_DELAY = 60   # seconds (TimelockV1 deploy arg in scripts)


class ProposalState(enum.Enum):
    PENDING = 0
    ACTIVE = 1
    CANCELED = 2
    DEFEATED = 3
    SUCCEEDED = 4
    QUEUED = 5
    EXECUTED = 7


class GovernanceError(Exception):
    pass


@dataclass
class Proposal:
    id: bytes
    proposer: str
    actions: list[Callable[[], None]]
    description: str
    description_cid: bytes
    snapshot_block: int
    deadline_block: int
    for_votes: int = 0
    against_votes: int = 0
    abstain_votes: int = 0
    eta: int | None = None
    executed: bool = False
    canceled: bool = False
    executed_actions: int = 0   # progress cursor for failure-safe retry
    voted: set = field(default_factory=set)


class Governor:
    """Proposal lifecycle over an Engine's clock/blocks and TokenLedger."""

    def __init__(self, engine):
        self.engine = engine
        self.token = engine.token
        self.proposals: dict[bytes, Proposal] = {}
        self.proposals_created: list[bytes] = []

    # -- id & state ------------------------------------------------------
    def _proposal_id(self, actions, description: str,
                     digest: bytes | None = None) -> bytes:
        """OZ hashes (targets, values, calldatas, descriptionHash). Python
        callables have no canonical calldata, so callers that DO have
        calldata (the devnet's propose(target,value,calldata,description)
        surface) pass its keccak as `digest`, restoring the OZ property
        that different actions under the same description get distinct
        ids. Without a digest the id binds action COUNT + description
        hash only — then descriptions must be unique per proposal."""
        desc_hash = keccak256(description.encode())
        if digest is not None:
            return keccak256(abi_encode(["bytes32", "bytes32"],
                                        [digest, desc_hash]))
        return keccak256(abi_encode(["uint256", "bytes32"],
                                    [len(actions), desc_hash]))

    def _get(self, pid: bytes) -> Proposal:
        p = self.proposals.get(pid)
        if p is None:
            raise GovernanceError("unknown proposal")
        return p

    def state(self, pid: bytes) -> ProposalState:
        p = self._get(pid)
        if p.canceled:
            return ProposalState.CANCELED
        if p.executed:
            return ProposalState.EXECUTED
        if p.eta is not None:
            return ProposalState.QUEUED
        block = self.engine.block_number
        if block <= p.snapshot_block:
            return ProposalState.PENDING
        if block <= p.deadline_block:
            return ProposalState.ACTIVE
        if self._succeeded(p):
            return ProposalState.SUCCEEDED
        return ProposalState.DEFEATED

    def _succeeded(self, p: Proposal) -> bool:
        quorum = (self.token.past_total_supply(p.snapshot_block)
                  * QUORUM_FRACTION) // 100
        return (p.for_votes + p.abstain_votes >= quorum
                and p.for_votes > p.against_votes)

    # -- lifecycle -------------------------------------------------------
    def propose(self, sender: str, actions: list[Callable[[], None]],
                description: str, digest: bytes | None = None) -> bytes:
        sender = sender.lower()
        if self.token.get_past_votes(
                sender, self.engine.block_number - 1) < PROPOSAL_THRESHOLD:
            raise GovernanceError("proposer votes below proposal threshold")
        pid = self._proposal_id(actions, description, digest)
        if pid in self.proposals:
            raise GovernanceError("proposal already exists")
        block = self.engine.block_number
        p = Proposal(
            id=pid, proposer=sender, actions=list(actions),
            description=description,
            description_cid=cid_onchain(description.encode()),
            snapshot_block=block + VOTING_DELAY,
            deadline_block=block + VOTING_DELAY + VOTING_PERIOD)
        self.proposals[pid] = p
        self.proposals_created.append(pid)
        self.engine._emit("ProposalCreated", id=pid, proposer=sender)
        return pid

    def cast_vote(self, sender: str, pid: bytes, support: int) -> int:
        """support: 0=against, 1=for, 2=abstain (Bravo-compat)."""
        sender = sender.lower()
        p = self._get(pid)
        if support not in (0, 1, 2):
            raise GovernanceError("invalid vote type")
        if self.state(pid) != ProposalState.ACTIVE:
            raise GovernanceError("proposal not active")
        if sender in p.voted:
            raise GovernanceError("already voted")
        p.voted.add(sender)
        weight = self.token.get_past_votes(sender, p.snapshot_block)
        if support == 0:
            p.against_votes += weight
        elif support == 1:
            p.for_votes += weight
        else:
            p.abstain_votes += weight
        self.engine._emit("VoteCast", voter=sender, id=pid,
                          support=support, weight=weight)
        return weight

    def cancel(self, sender: str, pid: bytes) -> None:
        """OZ Governor.cancel: only the proposer, only while PENDING
        (before the vote snapshot)."""
        p = self._get(pid)
        if sender.lower() != p.proposer:
            raise GovernanceError("only proposer can cancel")
        if self.state(pid) != ProposalState.PENDING:
            raise GovernanceError("too late to cancel")
        p.canceled = True
        self.engine._emit("ProposalCanceled", id=pid)

    def queue(self, pid: bytes) -> int:
        if self.state(pid) != ProposalState.SUCCEEDED:
            raise GovernanceError("proposal not successful")
        p = self._get(pid)
        p.eta = self.engine.now + TIMELOCK_MIN_DELAY
        self.engine._emit("ProposalQueued", id=pid, eta=p.eta)
        return p.eta

    def execute(self, pid: bytes) -> None:
        p = self._get(pid)
        if self.state(pid) != ProposalState.QUEUED:
            raise GovernanceError("proposal not queued")
        if self.engine.now < p.eta:
            raise GovernanceError("timelock delay not elapsed")
        # run the actions BEFORE marking executed: there is no EVM-style
        # tx rollback here, so a reverting action must leave the proposal
        # QUEUED (re-executable after the cause is fixed), not permanently
        # EXECUTED-with-no-effect. The progress cursor makes a retry
        # resume AFTER the actions that already applied — re-running them
        # would double-apply (e.g. a treasury transfer before the failing
        # action).
        while p.executed_actions < len(p.actions):
            p.actions[p.executed_actions]()
            p.executed_actions += 1
        p.executed = True
        self.engine._emit("ProposalExecuted", id=pid)
