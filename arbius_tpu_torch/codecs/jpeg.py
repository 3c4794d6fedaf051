"""Deterministic baseline JPEG encoder (integer-exact).

Video solutions need a container the dapp can render (`out-1.mp4`,
`templates/zeroscopev2xl.json` / `damo.json`); we mux Motion-JPEG samples
into MP4 (see mp4.py), so the JPEG bytes must be deterministic across every
miner host. All arithmetic here is integer fixed-point with explicitly
defined rounding — no libm, no floats at encode time — so the output is
pinned by this file, not by a library version:

  - RGB->YCbCr: 16-bit fixed-point constants, add-half then >>16
  - 8x8 FDCT: two 1D passes with a hardcoded 13-bit fixed-point
    cosine matrix, (acc + 4096) >> 13 after each pass
  - quantization: Annex K tables scaled by the libjpeg quality formula,
    coefficient rounding sign * ((|v| + q//2) // q)
  - entropy: standard Annex K Huffman tables, 4:4:4 sampling

Quality defaults to 90 — MJPEG frames are an intermediate the template's
output.type=video consumer decodes, not a fidelity benchmark.
"""
from __future__ import annotations

import struct

import numpy as np

# round(alpha(u)/2 * cos((2x+1)u*pi/16) * 8192); alpha(0)=1/sqrt(2), else 1.
# Hardcoded so no libm call can perturb the table across platforms.
_DCT_M = np.array([
    [2896,  2896,  2896,  2896,  2896,  2896,  2896,  2896],
    [4017,  3406,  2276,   799,  -799, -2276, -3406, -4017],
    [3784,  1567, -1567, -3784, -3784, -1567,  1567,  3784],
    [3406,  -799, -4017, -2276,  2276,  4017,   799, -3406],
    [2896, -2896, -2896,  2896,  2896, -2896, -2896,  2896],
    [2276, -4017,   799,  3406, -3406,  -799,  4017, -2276],
    [1567, -3784,  3784, -1567, -1567,  3784, -3784,  1567],
    [ 799, -2276,  3406, -4017,  4017, -3406,  2276,  -799],
], dtype=np.int64)

_Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
], dtype=np.int64)
_Q_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
], dtype=np.int64)

_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], dtype=np.int64)

# Annex K Huffman table specs: (bits[1..16], huffval[])
_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0],
            list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
              list(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
    0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
    0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1,
    0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A,
    0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7,
    0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])


def _build_huff(bits, huffval):
    """Canonical JPEG Huffman: symbol -> (code, size)."""
    table = {}
    code = 0
    k = 0
    for size in range(1, 17):
        for _ in range(bits[size - 1]):
            table[huffval[k]] = (code, size)
            code += 1
            k += 1
        code <<= 1
    return table

_HUFF_DC = (_build_huff(*_DC_LUMA), _build_huff(*_DC_CHROMA))
_HUFF_AC = (_build_huff(*_AC_LUMA), _build_huff(*_AC_CHROMA))


def _quality_tables(quality: int):
    quality = max(1, min(100, quality))
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    out = []
    for base in (_Q_LUMA, _Q_CHROMA):
        q = (base * scale + 50) // 100
        out.append(np.clip(q, 1, 255).astype(np.int64))
    return out


def _rgb_to_ycbcr(img: np.ndarray):
    r = img[..., 0].astype(np.int64)
    g = img[..., 1].astype(np.int64)
    b = img[..., 2].astype(np.int64)
    y = (19595 * r + 38470 * g + 7471 * b + 32768) >> 16
    cb = ((-11056 * r - 21712 * g + 32768 * b + 32768) >> 16) + 128
    cr = ((32768 * r - 27440 * g - 5328 * b + 32768) >> 16) + 128
    return (np.clip(y, 0, 255), np.clip(cb, 0, 255), np.clip(cr, 0, 255))


def _fdct_blocks(blocks: np.ndarray) -> np.ndarray:
    """[N,8,8] level-shifted samples -> [N,8,8] DCT coefficients."""
    t = (np.einsum("ux,nxy->nuy", _DCT_M, blocks) + 4096) >> 13
    return (np.einsum("vy,nuy->nuv", _DCT_M, t) + 4096) >> 13


def _to_blocks(plane: np.ndarray) -> np.ndarray:
    """[H,W] (multiples of 8) -> [N,8,8] in raster block order."""
    h, w = plane.shape
    return (plane.reshape(h // 8, 8, w // 8, 8)
            .transpose(0, 2, 1, 3).reshape(-1, 8, 8))


class _BitWriter:
    """MSB-first JPEG entropy bits with 0xFF byte stuffing."""

    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, code: int, size: int):
        self.acc = (self.acc << size) | (code & ((1 << size) - 1))
        self.nbits += size
        while self.nbits >= 8:
            byte = (self.acc >> (self.nbits - 8)) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0x00)
            self.nbits -= 8
        self.acc &= (1 << self.nbits) - 1

    def finish(self) -> bytes:
        if self.nbits:
            pad = 8 - self.nbits
            self.write((1 << pad) - 1, pad)  # pad with 1-bits per spec
        return bytes(self.out)


def _magnitude(v: int):
    """JPEG magnitude category + value bits (one's-complement negatives)."""
    if v == 0:
        return 0, 0
    a = v if v > 0 else -v
    size = a.bit_length()
    bits = v if v > 0 else v + (1 << size) - 1
    return size, bits


def _dqt(tables) -> bytes:
    payload = b""
    for tid, q in enumerate(tables):
        payload += bytes([tid]) + bytes(int(q[z]) for z in _ZIGZAG)
    return b"\xff\xdb" + struct.pack(">H", len(payload) + 2) + payload


def _dht() -> bytes:
    payload = b""
    for tc, specs in ((0, (_DC_LUMA, _DC_CHROMA)), (1, (_AC_LUMA, _AC_CHROMA))):
        for th, (bits, huffval) in enumerate(specs):
            payload += bytes([(tc << 4) | th]) + bytes(bits) + bytes(huffval)
    return b"\xff\xc4" + struct.pack(">H", len(payload) + 2) + payload


def encode_jpeg(image: np.ndarray, quality: int = 90) -> bytes:
    """uint8 [H,W,3] RGB (H,W multiples of 8) -> baseline JPEG, 4:4:4."""
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"expected uint8 [H,W,3] RGB, got "
                         f"{image.dtype} {image.shape}")
    h, w = image.shape[:2]
    if h % 8 or w % 8:
        raise ValueError("JPEG encoder requires H, W multiples of 8")
    qt = _quality_tables(quality)
    planes = _rgb_to_ycbcr(image)

    coeffs = []
    for ci, plane in enumerate(planes):
        blocks = _to_blocks(plane) - 128
        dct = _fdct_blocks(blocks)
        # DQT stores tables zigzagged; quantization applies in natural order
        qnat = qt[0 if ci == 0 else 1].reshape(8, 8)
        a = np.abs(dct)
        quant = np.sign(dct) * ((a + qnat // 2) // qnat)
        coeffs.append(quant.astype(np.int64))

    bw = _BitWriter()
    dc = [0, 0, 0]
    # interleaved MCU scan, 4:4:4: one block per component per MCU
    zzs = [c.reshape(-1, 64)[:, _ZIGZAG] for c in coeffs]
    n_mcu = zzs[0].shape[0]
    for m in range(n_mcu):
        for ci in range(3):
            chroma = ci > 0
            dc_tab = _HUFF_DC[1 if chroma else 0]
            ac_tab = _HUFF_AC[1 if chroma else 0]
            block = zzs[ci][m]
            diff = int(block[0]) - dc[ci]
            dc[ci] = int(block[0])
            size, bits = _magnitude(diff)
            code, n = dc_tab[size]
            bw.write(code, n)
            if size:
                bw.write(bits, size)
            nz = np.nonzero(block[1:])[0]
            prev = 0
            for idx in nz:
                run = int(idx) - prev
                prev = int(idx) + 1
                while run > 15:
                    code, n = ac_tab[0xF0]
                    bw.write(code, n)
                    run -= 16
                size, bits = _magnitude(int(block[1 + idx]))
                code, n = ac_tab[(run << 4) | size]
                bw.write(code, n)
                bw.write(bits, size)
            if prev < 63:
                code, n = ac_tab[0x00]
                bw.write(code, n)
    scan = bw.finish()

    out = bytearray(b"\xff\xd8")                       # SOI
    out += (b"\xff\xe0" + struct.pack(">H", 16) + b"JFIF\x00"
            + bytes([1, 1, 0]) + struct.pack(">HH", 1, 1) + bytes([0, 0]))
    out += _dqt(qt)
    sof = struct.pack(">BHHB", 8, h, w, 3)
    for cid in range(3):
        sof += bytes([cid + 1, 0x11, 0 if cid == 0 else 1])
    out += b"\xff\xc0" + struct.pack(">H", len(sof) + 2) + sof
    out += _dht()
    sos = bytes([3])
    for cid in range(3):
        th = 0 if cid == 0 else 1
        sos += bytes([cid + 1, (th << 4) | th])
    sos += bytes([0, 63, 0])
    out += b"\xff\xda" + struct.pack(">H", len(sos) + 2) + sos
    out += scan
    out += b"\xff\xd9"                                 # EOI
    return bytes(out)
