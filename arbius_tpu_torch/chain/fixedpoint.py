"""EVM fixed-point math for the emission schedule — exact integer port.

The protocol's difficulty/reward curve (`EngineV1.sol:443-516`) is computed
on-chain in PRB-math UD60x18/SD59x18 fixed point. The node needs the same
numbers (to predict rewards, decide whether solving is profitable, and run
the in-process fake engine for tests), and "approximately the same" is not
good enough when asserting against on-chain state — so this is a bit-exact
integer reimplementation:

  - exp2 over 192.64-bit fixed point via the classic square-root-of-two
    magic-constant ladder (constant i = round(2^(2^-(i+1)) * 2^64), which
    we *derive* here with integer square roots rather than hardcode)
  - UD60x18 wrapping: x_192x64 = (x << 64) // 1e18, result scaled by
    10^18 then >> (191 - integer_part)
  - all divisions floor (EVM uint semantics; operands here are positive)

Golden values asserted in tests/test_engine.py come from the reference's
`contract/test/reward.test.ts:154-179`.
"""
from __future__ import annotations

from math import isqrt

WAD = 10**18
STARTING_ENGINE_TOKEN_AMOUNT = 600_000 * WAD
BASE_TOKEN_STARTING_REWARD = 1 * WAD
SECONDS_PER_YEAR = 60 * 60 * 24 * 365


def _exp2_constants() -> list[int]:
    """C_i = round(2^(2^-(i+1)) * 2^64) for i in 0..63.

    Derived by repeated integer square roots at extended precision:
    sqrt in 2^256 scale keeps ~77 digits, far beyond the 20 needed.
    """
    consts = []
    scale_bits = 256
    # r_i = 2^(2^-(i+1)) represented at scale 2^scale_bits
    r = isqrt(2 << (2 * scale_bits))       # sqrt(2) * 2^scale_bits
    for _ in range(64):
        # round to 64-bit scale
        c = (r * (1 << 64) + (1 << (scale_bits - 1))) >> scale_bits
        consts.append(c)
        r = isqrt(r << scale_bits)         # next: sqrt(r) at same scale
    return consts


_EXP2_CONSTS = _exp2_constants()


def exp2_192x64(x: int) -> int:
    """Common.exp2: input 192.64 fixed point, output UD60x18 (1e18 scale)."""
    result = 1 << 191   # 0.5 in 192.64; the final shift compensates
    for i in range(64):
        if x & (1 << (63 - i)):
            result = (result * _EXP2_CONSTS[i]) >> 64
    result *= WAD
    return result >> (191 - (x >> 64))


def ud_exp2(x_wad: int) -> int:
    """UD60x18 exp2: x and result in 1e18 scale. Requires x < 192e18."""
    if x_wad >= 192 * WAD:
        raise OverflowError("exp2 input too large")
    return exp2_192x64((x_wad << 64) // WAD)


def target_ts(t: int) -> int:
    """EngineV1.targetTs (`EngineV1.sol:443-454`): supply target at time t.

    600000e18 * (1 - 2^-(t/1yr)), saturating at 100 years.
    """
    if t > 3_153_600_000:
        return STARTING_ENGINE_TOKEN_AMOUNT
    # ud(t).div(ud(SECONDS_PER_YEAR)): raw values divide with WAD scaling
    frac = (t * WAD) // SECONDS_PER_YEAR
    e = ud_exp2(frac)
    return (STARTING_ENGINE_TOKEN_AMOUNT
            - (STARTING_ENGINE_TOKEN_AMOUNT * WAD * WAD) // e // WAD)


def diff_mul(t: int, ts: int) -> int:
    """EngineV1.diffMul (`EngineV1.sol:464-498`): difficulty multiplier.

    1e18 = neutral; >1e18 when supply lags target (capped 100e18),
    0 when supply runs ≥ ~20% ahead.
    """
    if t <= 0 or ts <= 0:
        raise ValueError("min vals")
    e = target_ts(t)
    d = (ts * WAD) // e                     # SD59x18 div, operands positive
    if d < 933_561_438_102_252_700:
        return 100 * WAD
    c = WAD + ((d - WAD) * 100 * WAD) // WAD - WAD   # (d-1)*100 in wad
    if c >= 20 * WAD:
        return 0
    if c < 0:
        return ud_exp2(-c)
    return (WAD * WAD) // ud_exp2(c)


def reward(t: int, ts: int) -> int:
    """EngineV1.reward (`EngineV1.sol:504-516`): per-solution emission."""
    if ts == 0:
        return BASE_TOKEN_STARTING_REWARD
    return ((STARTING_ENGINE_TOKEN_AMOUNT - ts) * BASE_TOKEN_STARTING_REWARD
            * diff_mul(t, ts)) // STARTING_ENGINE_TOKEN_AMOUNT // WAD
