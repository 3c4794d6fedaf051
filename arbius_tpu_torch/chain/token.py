"""In-process ERC20 ledger — the AIUS base token for the fake chain.

Mirrors what the engine needs of BaseTokenV1 (`BaseTokenV1.sol:37-68`):
balances, allowances, transfer/transferFrom. Fixed 1M wad supply minted to
a deployer, of which the engine is seeded with 600k (the mining emission
pool, `EngineV1.sol:12-13` MAX_SUPPLY/STARTING_ENGINE_TOKEN_AMOUNT).
"""
from __future__ import annotations

from arbius_tpu_torch.chain.fixedpoint import WAD

MAX_SUPPLY = 1_000_000 * WAD


class TokenLedger:
    """Balances + allowances + ERC20Votes-style delegation checkpoints.

    `block_fn` supplies the current block (the Engine wires it to its own
    block counter) so vote checkpoints are block-indexed exactly like
    OZ ERC20Votes — the governance layer reads past votes at a proposal's
    snapshot block.
    """

    def __init__(self):
        self.balances: dict[str, int] = {}
        self.allowances: dict[tuple[str, str], int] = {}
        self.block_fn = lambda: 0
        self.delegates: dict[str, str] = {}
        self._vote_ckpts: dict[str, list[tuple[int, int]]] = {}
        self._supply_ckpts: list[tuple[int, int]] = []
        self.total_supply = 0
        self.gateway: str | None = None   # L2 gateway, set at deployment

    # -- ERC20 -----------------------------------------------------------
    def mint(self, to: str, amount: int) -> None:
        self.balances[to] = self.balances.get(to, 0) + amount
        self.total_supply += amount
        self._push(self._supply_ckpts, self.total_supply)
        self._move_votes(None, self.delegates.get(to), amount)

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
        self._move_votes(self.delegates.get(sender),
                         self.delegates.get(to), amount)

    def transfer_from(self, spender: str, owner: str, to: str,
                      amount: int) -> None:
        allowed = self.allowances.get((owner, spender), 0)
        if allowed < amount:
            raise ValueError("ERC20: insufficient allowance")
        self.allowances[(owner, spender)] = allowed - amount
        self.transfer(owner, to, amount)

    # -- Arbitrum gateway (BaseTokenV1.sol:54-68) ------------------------
    def bridge_mint(self, sender: str, account: str, amount: int) -> None:
        """Only the registered L2 gateway mints bridged deposits, capped
        at MAX_SUPPLY (the L1 escrow guarantees the global invariant)."""
        if sender != self.gateway:
            raise ValueError("NOT_GATEWAY")
        if self.total_supply + amount > MAX_SUPPLY:
            raise ValueError("mint exceeds max supply")
        self.mint(account, amount)

    def bridge_burn(self, sender: str, account: str, amount: int) -> None:
        """Gateway burns on withdrawal back to L1."""
        if sender != self.gateway:
            raise ValueError("NOT_GATEWAY")
        bal = self.balances.get(account, 0)
        if bal < amount:
            raise ValueError("ERC20: burn amount exceeds balance")
        self.balances[account] = bal - amount
        self.total_supply -= amount
        self._push(self._supply_ckpts, self.total_supply)
        self._move_votes(self.delegates.get(account), None, amount)

    # -- votes (ERC20Votes subset) ---------------------------------------
    def delegate(self, owner: str, delegatee: str) -> None:
        prev = self.delegates.get(owner)
        self.delegates[owner] = delegatee
        self._move_votes(prev, delegatee, self.balance_of(owner))

    def _push(self, ckpts: list, value: int) -> None:
        block = self.block_fn()
        if ckpts and ckpts[-1][0] == block:
            ckpts[-1] = (block, value)
        else:
            ckpts.append((block, value))

    def _move_votes(self, src: str | None, dst: str | None,
                    amount: int) -> None:
        if amount == 0 or src == dst:
            return
        if src is not None:
            ck = self._vote_ckpts.setdefault(src, [])
            self._push(ck, (ck[-1][1] if ck else 0) - amount)
        if dst is not None:
            ck = self._vote_ckpts.setdefault(dst, [])
            self._push(ck, (ck[-1][1] if ck else 0) + amount)

    @staticmethod
    def _at_block(ckpts: list[tuple[int, int]], block: int) -> int:
        value = 0
        for b, v in ckpts:
            if b > block:
                break
            value = v
        return value

    def get_votes(self, addr: str) -> int:
        ck = self._vote_ckpts.get(addr, [])
        return ck[-1][1] if ck else 0

    def get_past_votes(self, addr: str, block: int) -> int:
        return self._at_block(self._vote_ckpts.get(addr, []), block)

    def past_total_supply(self, block: int) -> int:
        return self._at_block(self._supply_ckpts, block)
