"""RLP encoding + EIP-1559 transaction serialization/signing.

The reference signs transactions through ethers.js Wallet
(`miner/src/blockchain.ts:22-36`); here the full path is in-repo: RLP
(Ethereum's recursive length prefix encoding), the typed EIP-1559
(0x02) transaction payload, and signing via the RFC-6979 wallet — no
external web3 dependency.

Encodings verified against the canonical RLP test vectors and known
signed-transaction fixtures in tests/test_rpc_client.py.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from arbius_tpu_torch.chain.wallet import Wallet
from arbius_tpu_torch.l0.keccak import keccak256


def _int_bytes(v: int) -> bytes:
    """Minimal big-endian bytes; 0 encodes as empty (RLP canonical)."""
    if v == 0:
        return b""
    return v.to_bytes((v.bit_length() + 7) // 8, "big")


def rlp_encode(item) -> bytes:
    """item: bytes | int | list (recursively)."""
    if isinstance(item, int):
        item = _int_bytes(item)
    if isinstance(item, (bytes, bytearray)):
        item = bytes(item)
        if len(item) == 1 and item[0] < 0x80:
            return item
        return _length_prefix(len(item), 0x80) + item
    if isinstance(item, (list, tuple)):
        payload = b"".join(rlp_encode(x) for x in item)
        return _length_prefix(len(payload), 0xC0) + payload
    raise TypeError(f"cannot RLP-encode {type(item)}")


def _length_prefix(length: int, offset: int) -> bytes:
    if length < 56:
        return bytes([offset + length])
    lb = _int_bytes(length)
    return bytes([offset + 55 + len(lb)]) + lb


def _addr_bytes(addr: str | None) -> bytes:
    if addr is None:
        return b""   # contract creation
    return bytes.fromhex(addr[2:] if addr.startswith("0x") else addr)


@dataclass(frozen=True)
class Eip1559Tx:
    chain_id: int
    nonce: int
    max_priority_fee_per_gas: int
    max_fee_per_gas: int
    gas_limit: int
    to: str | None
    value: int
    data: bytes
    access_list: tuple = field(default=())

    def _payload(self) -> list:
        return [self.chain_id, self.nonce, self.max_priority_fee_per_gas,
                self.max_fee_per_gas, self.gas_limit, _addr_bytes(self.to),
                self.value, self.data, list(self.access_list)]

    def signing_hash(self) -> bytes:
        return keccak256(b"\x02" + rlp_encode(self._payload()))

    def sign(self, wallet: Wallet) -> bytes:
        """Signed raw transaction bytes (what eth_sendRawTransaction takes)."""
        r, s, y = wallet.sign(self.signing_hash())
        return b"\x02" + rlp_encode(self._payload() + [y, r, s])

    def tx_hash(self, wallet: Wallet) -> bytes:
        return keccak256(self.sign(wallet))


def rlp_decode(data: bytes):
    """Decode one RLP item; raises on trailing bytes (canonical payloads)."""
    item, rest = _decode_item(memoryview(data))
    if len(rest):
        raise ValueError("trailing bytes after RLP item")
    return item


def _decode_item(mv):
    if not len(mv):
        raise ValueError("empty RLP input")
    b0 = mv[0]
    if b0 < 0x80:
        return bytes(mv[:1]), mv[1:]
    if b0 < 0xC0:
        length, mv = _decode_length(mv, 0x80)
        if length > len(mv):
            raise ValueError("RLP string length exceeds input")
        return bytes(mv[:length]), mv[length:]
    length, mv = _decode_length(mv, 0xC0)
    if length > len(mv):
        raise ValueError("RLP list length exceeds input")
    payload, rest = mv[:length], mv[length:]
    items = []
    while len(payload):
        item, payload = _decode_item(payload)
        items.append(item)
    return items, rest


def _decode_length(mv, offset: int):
    b0 = mv[0]
    if b0 <= offset + 55:
        return b0 - offset, mv[1:]
    n = b0 - offset - 55
    if 1 + n > len(mv):
        raise ValueError("RLP length prefix out of range")
    length = int.from_bytes(bytes(mv[1:1 + n]), "big")
    return length, mv[1 + n:]


def _as_int(b: bytes) -> int:
    return int.from_bytes(b, "big")


@dataclass(frozen=True)
class DecodedTx:
    """A signed EIP-1559 transaction as recovered by a receiving node."""
    tx: Eip1559Tx
    sender: str
    tx_hash: bytes
    r: int
    s: int
    y_parity: int


def decode_signed_eip1559(raw: bytes) -> DecodedTx:
    """Parse + verify a raw 0x02 transaction: the receiving side of
    `Eip1559Tx.sign`. Recovers the sender from the signature, so a fake
    chain node (or test) can apply the state change the tx encodes —
    closing the sign → RLP → decode → state-change loop the reference
    only exercises against live Nova (`miner/test/utils.test.ts:60-69`).
    """
    from arbius_tpu_torch.chain.wallet import recover_address

    if not raw or raw[0] != 0x02:
        raise ValueError("not an EIP-1559 (0x02) transaction")
    fields = rlp_decode(raw[1:])
    if not isinstance(fields, list) or len(fields) != 12:
        raise ValueError("signed EIP-1559 payload must have 12 fields")
    (chain_id, nonce, prio, max_fee, gas, to, value, data,
     access_list, y, r, s) = fields
    tx = Eip1559Tx(
        chain_id=_as_int(chain_id), nonce=_as_int(nonce),
        max_priority_fee_per_gas=_as_int(prio),
        max_fee_per_gas=_as_int(max_fee), gas_limit=_as_int(gas),
        to="0x" + to.hex() if to else None, value=_as_int(value),
        data=data, access_list=tuple(access_list))
    sender = recover_address(tx.signing_hash(), _as_int(r), _as_int(s),
                             _as_int(y))
    return DecodedTx(tx=tx, sender=sender, tx_hash=keccak256(raw),
                     r=_as_int(r), s=_as_int(s), y_parity=_as_int(y))
