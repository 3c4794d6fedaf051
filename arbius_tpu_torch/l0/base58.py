"""Base58 (bitcoin alphabet) codec.

The miner converts IPFS daemon base58 CIDs to 0x-hex multihashes before
submitting solutions (reference `miner/src/models.ts:52`, via @scure/base).
This module is the standalone equivalent — no external dependency.
"""
from __future__ import annotations

_ALPHABET = "123456789ABCDEFGHJKLMNPQRSTUVWXYZabcdefghijkmnopqrstuvwxyz"
_INDEX = {c: i for i, c in enumerate(_ALPHABET)}


def b58encode(data: bytes) -> str:
    n = int.from_bytes(data, "big")
    out = []
    while n:
        n, r = divmod(n, 58)
        out.append(_ALPHABET[r])
    # preserve leading zero bytes as '1's
    pad = 0
    for byte in data:
        if byte == 0:
            pad += 1
        else:
            break
    return "1" * pad + "".join(reversed(out))


def b58decode(s: str) -> bytes:
    n = 0
    for c in s:
        try:
            n = n * 58 + _INDEX[c]
        except KeyError:
            raise ValueError(f"invalid base58 character {c!r}") from None
    body = n.to_bytes((n.bit_length() + 7) // 8, "big") if n else b""
    pad = 0
    for c in s:
        if c == "1":
            pad += 1
        else:
            break
    return b"\x00" * pad + body


def cid_to_hex(cid58: str) -> str:
    """base58 CID -> 0x-hex multihash (reference `miner/src/models.ts:52`)."""
    return "0x" + b58decode(cid58).hex()


def hex_to_cid(hexstr: str) -> str:
    """0x-hex multihash -> base58 CID (reference `website/src/utils.ts:22-27`)."""
    if hexstr.startswith("0x"):
        hexstr = hexstr[2:]
    return b58encode(bytes.fromhex(hexstr))
