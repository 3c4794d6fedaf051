"""MurmurHash3 x64-128 — the hash kubo's HAMT directory sharding uses.

go-unixfs hashes each entry name with murmur3-64 (the first half of the
x64-128 variant, seed 0) and consumes the digest 8 bits at a time as HAMT
slot indices (go-unixfs/hamt). Pure-Python, integer-exact; vectors from
the reference smhasher suite are pinned in tests/test_l0.py.
"""
from __future__ import annotations

_MASK = (1 << 64) - 1
_C1 = 0x87C37B91114253D5
_C2 = 0x4CF5AD432745937F


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _MASK


def _fmix(k: int) -> int:
    k ^= k >> 33
    k = (k * 0xFF51AFD7ED558CCD) & _MASK
    k ^= k >> 33
    k = (k * 0xC4CEB9FE1A85EC53) & _MASK
    k ^= k >> 33
    return k


def murmur3_x64_128(data: bytes, seed: int = 0) -> tuple[int, int]:
    """(h1, h2) of the x64-128 variant."""
    h1 = h2 = seed & _MASK
    n_blocks = len(data) // 16
    for i in range(n_blocks):
        k1 = int.from_bytes(data[16 * i:16 * i + 8], "little")
        k2 = int.from_bytes(data[16 * i + 8:16 * i + 16], "little")
        k1 = (k1 * _C1) & _MASK
        k1 = _rotl(k1, 31)
        k1 = (k1 * _C2) & _MASK
        h1 ^= k1
        h1 = _rotl(h1, 27)
        h1 = (h1 + h2) & _MASK
        h1 = (h1 * 5 + 0x52DCE729) & _MASK
        k2 = (k2 * _C2) & _MASK
        k2 = _rotl(k2, 33)
        k2 = (k2 * _C1) & _MASK
        h2 ^= k2
        h2 = _rotl(h2, 31)
        h2 = (h2 + h1) & _MASK
        h2 = (h2 * 5 + 0x38495AB5) & _MASK

    tail = data[16 * n_blocks:]
    k1 = k2 = 0
    if len(tail) > 8:
        k2 = int.from_bytes(tail[8:].ljust(8, b"\x00"), "little")
        k2 = (k2 * _C2) & _MASK
        k2 = _rotl(k2, 33)
        k2 = (k2 * _C1) & _MASK
        h2 ^= k2
    if tail:
        k1 = int.from_bytes(tail[:8].ljust(8, b"\x00"), "little")
        k1 = (k1 * _C1) & _MASK
        k1 = _rotl(k1, 31)
        k1 = (k1 * _C2) & _MASK
        h1 ^= k1

    h1 ^= len(data)
    h2 ^= len(data)
    h1 = (h1 + h2) & _MASK
    h2 = (h2 + h1) & _MASK
    h1 = _fmix(h1)
    h2 = _fmix(h2)
    h1 = (h1 + h2) & _MASK
    h2 = (h2 + h1) & _MASK
    return h1, h2


def hamt_hash(name: str) -> bytes:
    """go-unixfs HAMT name hash: murmur3-64 (x64-128 first half, seed 0)
    of the utf-8 name, as 8 big-endian bytes — slot at depth d is byte d."""
    h1, _ = murmur3_x64_128(name.encode("utf-8"))
    return h1.to_bytes(8, "big")
