"""L1 side of the custom Arbitrum gateway token — completes the bridge pair.

The L2 surface (`TokenLedger.bridge_mint/bridge_burn`, token.py) mirrors
BaseTokenV1; this module mirrors the L1 counterpart
(`contract/contracts/L1Token.sol:34-60`): the premined AIUS ERC20 with the
custom-gateway registration handshake (`isArbitrumEnabled` must answer the
magic byte 0xb1, but only during `registerTokenOnL2` — the
`shouldRegisterGateway` latch), plus the escrow gateway the Solidity repo
pulls in from Arbitrum's contracts: deposits lock L1 tokens in the gateway
and mint on L2; withdrawals burn on L2 and release the escrow. Together the
pair maintains the global invariant the L2 cap check relies on
(token.py bridge_mint: "the L1 escrow guarantees the global invariant").
"""
from __future__ import annotations

from arbius_tpu_torch.chain.fixedpoint import WAD
from arbius_tpu_torch.chain.token import TokenLedger

ARBITRUM_ENABLED_MAGIC = 0xB1  # ICustomToken handshake (L1Token.sol:55-58)


class L1Token:
    """Plain L1 ERC20 (name AIUS) with the ICustomToken surface.

    Unlike the L2 token there is no mint cap logic here: the entire
    1M-wad supply is preminted to the deployer at construction
    (L1Token.sol:44-52) and only moves — the gateway escrow, not
    minting, backs L2 supply.
    """

    def __init__(self, deployer: str, custom_gateway: "L1CustomGateway",
                 router: "L2GatewayRouter", initial_supply_tokens: int):
        self.owner = deployer
        self.custom_gateway = custom_gateway
        self.router = router
        self._should_register_gateway = False
        self.balances: dict[str, int] = {
            deployer: initial_supply_tokens * WAD}
        self.allowances: dict[tuple[str, str], int] = {}
        self.total_supply = initial_supply_tokens * WAD

    # -- ERC20 -----------------------------------------------------------
    def balance_of(self, addr: str) -> int:
        return self.balances.get(addr, 0)

    def approve(self, owner: str, spender: str, amount: int) -> None:
        self.allowances[(owner, spender)] = amount

    def transfer(self, sender: str, to: str, amount: int) -> None:
        bal = self.balances.get(sender, 0)
        if bal < amount:
            raise ValueError("ERC20: transfer amount exceeds balance")
        self.balances[sender] = bal - amount
        self.balances[to] = self.balances.get(to, 0) + amount

    def transfer_from(self, spender: str, owner: str, to: str,
                      amount: int) -> None:
        allowed = self.allowances.get((owner, spender), 0)
        if allowed < amount:
            raise ValueError("ERC20: insufficient allowance")
        self.allowances[(owner, spender)] = allowed - amount
        self.transfer(owner, to, amount)

    # -- ICustomToken handshake (L1Token.sol:55-96) ----------------------
    def is_arbitrum_enabled(self) -> int:
        if not self._should_register_gateway:
            raise ValueError("NOT_EXPECTED_CALL")
        return ARBITRUM_ENABLED_MAGIC

    def register_token_on_l2(self, sender: str, l2_token_address: str) -> None:
        """Owner-only registration: latches `shouldRegisterGateway` around
        the gateway + router callbacks exactly like L1Token.sol:62-97 so
        the gateway's `is_arbitrum_enabled` probe succeeds only here."""
        if sender != self.owner:
            raise ValueError("Ownable: caller is not the owner")
        prev = self._should_register_gateway
        self._should_register_gateway = True
        try:
            self.custom_gateway.register_token_to_l2(self, l2_token_address)
            self.router.set_gateway(self, self.custom_gateway)
        finally:
            self._should_register_gateway = prev


class L2GatewayRouter:
    """Maps an L1 token to the gateway that handles its transfers."""

    def __init__(self):
        self.gateways: dict[int, "L1CustomGateway"] = {}

    def set_gateway(self, token: L1Token, gateway: "L1CustomGateway") -> None:
        if token.is_arbitrum_enabled() != ARBITRUM_ENABLED_MAGIC:
            raise ValueError("NOT_ARB_ENABLED")
        self.gateways[id(token)] = gateway


class L1CustomGateway:
    """Escrow half of the bridge.

    `outbound_transfer` (deposit L1→L2) pulls tokens into the gateway's
    escrow balance and mints on the registered L2 token via its gateway
    gate; `finalize_inbound_transfer` (withdraw L2→L1) burns on L2 and
    releases escrow. Escrowed == L2 total supply minus L2-native mining
    emissions is *not* an invariant here — mining mints on L2 directly —
    but bridged amounts always round-trip exactly.
    """

    ADDRESS = "0x" + "9a" * 20  # the gateway's address on both sides

    def __init__(self):
        self.l2_tokens: dict[int, tuple[str, TokenLedger]] = {}

    def register_token_to_l2(self, token: L1Token,
                             l2_token_address: str) -> None:
        if token.is_arbitrum_enabled() != ARBITRUM_ENABLED_MAGIC:
            raise ValueError("NOT_ARB_ENABLED")
        self.l2_tokens[id(token)] = (l2_token_address, None)

    def connect_l2(self, token: L1Token, ledger: TokenLedger) -> None:
        """Wire the in-process L2 ledger for the registered token and
        claim the gateway role on it (deployment-time plumbing; on the
        real chain this is the retryable-ticket round trip)."""
        if id(token) not in self.l2_tokens:
            raise ValueError("token not registered")
        addr, _ = self.l2_tokens[id(token)]
        ledger.gateway = self.ADDRESS
        self.l2_tokens[id(token)] = (addr, ledger)

    def _l2(self, token: L1Token) -> TokenLedger:
        entry = self.l2_tokens.get(id(token))
        if entry is None or entry[1] is None:
            raise ValueError("token not registered")
        return entry[1]

    def outbound_transfer(self, token: L1Token, sender: str, to: str,
                          amount: int) -> None:
        """Deposit: escrow `amount` of `sender`'s L1 tokens, mint to `to`
        on L2 (requires prior ERC20 approval of the gateway)."""
        ledger = self._l2(token)
        token.transfer_from(self.ADDRESS, sender, self.ADDRESS, amount)
        try:
            ledger.bridge_mint(self.ADDRESS, to, amount)
        except Exception:
            # the Solidity pair is atomic per tx; mirror that — a cap
            # revert on L2 must not strand the deposit in escrow
            token.transfer(self.ADDRESS, sender, amount)
            raise

    def finalize_inbound_transfer(self, token: L1Token, sender: str,
                                  to: str, amount: int) -> None:
        """Withdraw: burn `sender`'s L2 tokens, release escrow to `to`
        on L1."""
        ledger = self._l2(token)
        if token.balance_of(self.ADDRESS) < amount:
            # L2-native mining emissions are not escrow-backed; refuse
            # before burning so tokens can't vanish from both chains
            raise ValueError("gateway escrow insufficient")
        ledger.bridge_burn(self.ADDRESS, sender, amount)
        token.transfer(self.ADDRESS, to, amount)

    def escrowed(self, token: L1Token) -> int:
        return token.balance_of(self.ADDRESS)
