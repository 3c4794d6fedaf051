"""Protobuf unsigned varint encoding.

Behavioral parity with the reference's on-chain encoder
(`contract/contracts/libraries/IPFS.sol:12-34`, encode_varint): little-endian
base-128 groups, continuation bit on every byte except the last.
"""
from __future__ import annotations


def encode_varint(n: int) -> bytes:
    """Encode a non-negative integer as a protobuf varint."""
    if n < 0:
        raise ValueError("varint requires a non-negative integer")
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def decode_varint(buf: bytes, offset: int = 0) -> tuple[int, int]:
    """Decode a varint from ``buf`` at ``offset``. Returns (value, next_offset)."""
    shift = 0
    value = 0
    while True:
        byte = buf[offset]
        value |= (byte & 0x7F) << shift
        offset += 1
        if not byte & 0x80:
            return value, offset
        shift += 7
