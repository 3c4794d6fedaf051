"""Chain layer (L1'): protocol state machine + emission math.

`Engine` is an in-process, behavior-exact EngineV1 for integration tests
and local mining; the emission curve in `fixedpoint` is bit-exact against
the on-chain PRB-math fixed-point code. Copies of arbius_tpu/chain's
`engine.py`, `fixedpoint.py` and `token.py`; this module exports only
what those three define (governance, the L1 token and the wallet are not
ported).
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
from arbius_tpu_torch.chain.token import TokenLedger

__all__ = [
    "Contestation", "Engine", "EngineError", "Event", "Model", "Solution",
    "Task", "Validator", "TokenLedger",
    "BASE_TOKEN_STARTING_REWARD", "STARTING_ENGINE_TOKEN_AMOUNT", "WAD",
    "diff_mul", "reward", "target_ts",
]
