"""Chain layer (L1'): protocol state machine + emission math.

`Engine` is an in-process, behavior-exact EngineV1 for integration tests
and local mining (the reference's untested seam, SURVEY.md §4); the
emission curve in `fixedpoint` is bit-exact against the on-chain PRB-math
fixed-point code, so reward/difficulty predictions match chain state.
"""
from arbius_tpu_torch.chain.engine import (
    Contestation,
    Engine,
    EngineError,
    Event,
    Model,
    Solution,
    Task,
    Validator,
)
from arbius_tpu_torch.chain.fixedpoint import (
    BASE_TOKEN_STARTING_REWARD,
    STARTING_ENGINE_TOKEN_AMOUNT,
    WAD,
    diff_mul,
    reward,
    target_ts,
)
from arbius_tpu_torch.chain.governance import (
    GovernanceError,
    Governor,
    Proposal,
    ProposalState,
)
from arbius_tpu_torch.chain.l1token import L1CustomGateway, L1Token, L2GatewayRouter
from arbius_tpu_torch.chain.token import TokenLedger
from arbius_tpu_torch.chain.wallet import Wallet, recover_address

__all__ = [
    "Contestation", "Engine", "EngineError", "Event", "GovernanceError",
    "Governor", "L1CustomGateway", "L1Token", "L2GatewayRouter",
    "Model", "Proposal", "ProposalState", "Solution", "Task",
    "Validator", "TokenLedger", "Wallet", "recover_address",
    "BASE_TOKEN_STARTING_REWARD", "STARTING_ENGINE_TOKEN_AMOUNT", "WAD",
    "diff_mul", "reward", "target_ts",
]
