"""Deterministic DEFLATE (fixed-Huffman) — the compression core of PNG.

Why not stdlib zlib: `zlib.compress` output bytes depend on the zlib build
(version, vendor patches), and the solution CID is keccak-committed on-chain
(reference pins via its IPFS daemon, `miner/src/ipfs.ts:11-16`; the CID of
the PNG bytes IS the solution). A fleet of miners must agree on every
byte, so the encoder is pinned by *specification*, not by library version:

  - one final block, BTYPE=01 (fixed Huffman codes, RFC 1951 §3.2.6)
  - greedy LZ77, window 32768, match length 3..258
  - hash over 3 bytes: h = (b0<<16 | b1<<8 | b2) * 2654435761 mod 2^32,
    top 15 bits; hash chains most-recent-first, walk capped at MAX_CHAIN
  - longest match wins; ties go to the nearest distance (first found)
  - every consumed byte position is inserted into the chain

Any implementation of this spec (the C++ one in csrc/codecs.cc and the
pure-Python one here) produces identical bytes for identical input. The
decompressed stream is standard DEFLATE — `zlib.decompress` verifies it.

`zlib_wrap` adds the RFC 1950 container (CMF/FLG 0x78 0x01 + adler32),
which is what PNG IDAT carries.
"""
from __future__ import annotations

import zlib

MIN_MATCH = 3
MAX_MATCH = 258
WINDOW = 32768
MAX_CHAIN = 32
HASH_BITS = 15

# RFC 1951 §3.2.5: length code, extra bits, base length for codes 257..285
_LENGTH_TABLE = []          # index: length-3 -> (code, extra_bits, extra_val)
_LEN_BASES = [
    (257, 0, 3), (258, 0, 4), (259, 0, 5), (260, 0, 6), (261, 0, 7),
    (262, 0, 8), (263, 0, 9), (264, 0, 10), (265, 1, 11), (266, 1, 13),
    (267, 1, 15), (268, 1, 17), (269, 2, 19), (270, 2, 23), (271, 2, 27),
    (272, 2, 31), (273, 3, 35), (274, 3, 43), (275, 3, 51), (276, 3, 59),
    (277, 4, 67), (278, 4, 83), (279, 4, 99), (280, 4, 115), (281, 5, 131),
    (282, 5, 163), (283, 5, 195), (284, 5, 227), (285, 0, 258),
]
_DIST_BASES = [
    (0, 0, 1), (1, 0, 2), (2, 0, 3), (3, 0, 4), (4, 1, 5), (5, 1, 7),
    (6, 2, 9), (7, 2, 13), (8, 3, 17), (9, 3, 25), (10, 4, 33), (11, 4, 49),
    (12, 5, 65), (13, 5, 97), (14, 6, 129), (15, 6, 193), (16, 7, 257),
    (17, 7, 385), (18, 8, 513), (19, 8, 769), (20, 9, 1025), (21, 9, 1537),
    (22, 10, 2049), (23, 10, 3073), (24, 11, 4097), (25, 11, 6145),
    (26, 12, 8193), (27, 12, 12289), (28, 13, 16385), (29, 13, 24577),
]


def _build_length_table():
    for length in range(MIN_MATCH, MAX_MATCH + 1):
        for i in range(len(_LEN_BASES) - 1, -1, -1):
            code, extra, base = _LEN_BASES[i]
            if length >= base:
                _LENGTH_TABLE.append((code, extra, length - base))
                break
    # code 285 (length 258) has 0 extra bits; the scan above handles it
    assert len(_LENGTH_TABLE) == MAX_MATCH - MIN_MATCH + 1


_build_length_table()

_DIST_TABLE = {}            # small distances precomputed; large ones computed


def _dist_code(dist: int):
    got = _DIST_TABLE.get(dist)
    if got is None:
        for i in range(len(_DIST_BASES) - 1, -1, -1):
            code, extra, base = _DIST_BASES[i]
            if dist >= base:
                got = (code, extra, dist - base)
                break
        if dist <= 4096:
            _DIST_TABLE[dist] = got
    return got


def _fixed_litlen_code(sym: int):
    """RFC 1951 §3.2.6 fixed literal/length code -> (codebits, nbits)."""
    if sym <= 143:
        return 0x30 + sym, 8
    if sym <= 255:
        return 0x190 + (sym - 144), 9
    if sym <= 279:
        return sym - 256, 7
    return 0xC0 + (sym - 280), 8


class _BitWriter:
    """LSB-first bit packing; Huffman codes are emitted bit-reversed."""

    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nbits = 0

    def bits(self, value: int, n: int):
        self.acc |= value << self.nbits
        self.nbits += n
        while self.nbits >= 8:
            self.out.append(self.acc & 0xFF)
            self.acc >>= 8
            self.nbits -= 8

    def huff(self, code: int, n: int):
        rev = 0
        for _ in range(n):
            rev = (rev << 1) | (code & 1)
            code >>= 1
        self.bits(rev, n)

    def finish(self) -> bytes:
        if self.nbits:
            self.out.append(self.acc & 0xFF)
            self.acc = 0
            self.nbits = 0
        return bytes(self.out)


def _hash3(data: bytes, i: int) -> int:
    word = (data[i] << 16) | (data[i + 1] << 8) | data[i + 2]
    return ((word * 2654435761) & 0xFFFFFFFF) >> (32 - HASH_BITS)


def deflate_fixed(data: bytes) -> bytes:
    """Compress per the module-docstring spec. Pure-Python reference path."""
    w = _BitWriter()
    w.bits(1, 1)        # BFINAL
    w.bits(1, 2)        # BTYPE=01 fixed Huffman
    n = len(data)
    head = [-1] * (1 << HASH_BITS)
    prev = [-1] * WINDOW
    i = 0
    while i < n:
        match_len = 0
        match_dist = 0
        if i + MIN_MATCH <= n:
            h = _hash3(data, i)
            cand = head[h]
            chain = 0
            limit = min(MAX_MATCH, n - i)
            while cand >= 0 and i - cand <= WINDOW and chain < MAX_CHAIN:
                # a candidate can only beat the current best if it also
                # matches at offset match_len — cheap pre-check, no effect
                # on which match is chosen
                if match_len == 0 or (match_len < limit and
                                      data[cand + match_len] == data[i + match_len]):
                    length = 0
                    while length < limit and data[cand + length] == data[i + length]:
                        length += 1
                    if length > match_len:
                        match_len = length
                        match_dist = i - cand
                        if length == limit:
                            break
                cand = prev[cand % WINDOW]
                chain += 1
        if match_len >= MIN_MATCH:
            code, extra, ev = _LENGTH_TABLE[match_len - MIN_MATCH]
            cb, cn = _fixed_litlen_code(code)
            w.huff(cb, cn)
            if extra:
                w.bits(ev, extra)
            dcode, dextra, dev = _dist_code(match_dist)
            w.huff(dcode, 5)
            if dextra:
                w.bits(dev, dextra)
            end = i + match_len
            while i < end:
                if i + MIN_MATCH <= n:
                    h = _hash3(data, i)
                    prev[i % WINDOW] = head[h]
                    head[h] = i
                i += 1
        else:
            cb, cn = _fixed_litlen_code(data[i])
            w.huff(cb, cn)
            if i + MIN_MATCH <= n:
                h = _hash3(data, i)
                prev[i % WINDOW] = head[h]
                head[h] = i
            i += 1
    cb, cn = _fixed_litlen_code(256)    # end of block
    w.huff(cb, cn)
    return w.finish()


def compress(data: bytes) -> bytes:
    """Spec-deflate via the native fast path when available, else Python."""
    from arbius_tpu_torch.codecs import _native

    fn = _native.deflate_fixed()
    if fn is not None:
        return fn(data)
    return deflate_fixed(data)


def zlib_wrap(raw_deflate: bytes, data: bytes) -> bytes:
    """RFC 1950 container: 0x78 0x01 header + stream + adler32(data)."""
    return b"\x78\x01" + raw_deflate + zlib.adler32(data).to_bytes(4, "big")


def zlib_compress(data: bytes) -> bytes:
    return zlib_wrap(compress(data), data)
