"""Deterministic PNG encoder.

The reference gets its output PNG bytes from inside the cog container
(`miner/src/index.ts:867-872` base64-decodes whatever the container wrote),
so the container's libpng version silently defines the determinism class.
Here the encoder IS part of the framework: RGB8, one IDAT, a fixed
per-row filter (Paeth, filter type 4 — good on natural images and fully
deterministic), and the spec-pinned DEFLATE from `deflate.py`. Every miner
running this code produces the same bytes, hence the same solution CID.

CRC32 and Adler32 are fully specified checksums (not compression), so the
stdlib implementations are safe to use.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from arbius_tpu_torch.codecs.deflate import compress, zlib_wrap

_SIG = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload)))


def _paeth_filter_rows(img: np.ndarray) -> bytes:
    """Filter type 4 (Paeth) applied to every row; returns the raw stream."""
    h, w, c = img.shape
    x = img.astype(np.int32)
    left = np.zeros_like(x)
    left[:, 1:] = x[:, :-1]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    upleft = np.zeros_like(x)
    upleft[1:, 1:] = x[:-1, :-1]
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    pred = np.where((pa <= pb) & (pa <= pc), left,
                    np.where(pb <= pc, up, upleft))
    filtered = ((x - pred) & 0xFF).astype(np.uint8)
    rows = np.concatenate(
        [np.full((h, 1), 4, np.uint8), filtered.reshape(h, w * c)], axis=1)
    return rows.tobytes()


def encode_png(image: np.ndarray) -> bytes:
    """uint8 [H, W, 3] RGB -> PNG bytes, deterministically."""
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"expected uint8 [H,W,3] RGB, got "
                         f"{image.dtype} {image.shape}")
    h, w, _ = image.shape
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit, color type 2
    raw = _paeth_filter_rows(np.ascontiguousarray(image))
    idat = zlib_wrap(compress(raw), raw)
    return (_SIG + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", idat)
            + _chunk(b"IEND", b""))
