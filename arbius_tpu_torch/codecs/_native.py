"""Loader for the port's native codec core (csrc/codecs.cc, a byte-equal
copy of the reference's native/codecs.cc).

Built with g++ on first use by ops/_build.py into
``arbius_tpu_torch/build/``; where it cannot be built, `deflate_fixed`
returns None so callers use the pure-Python reference implementation.
Both paths implement the same byte-exact spec, so the fallback changes
speed, never output.
"""
from __future__ import annotations

import ctypes
import functools
import subprocess

from arbius_tpu_torch.ops import _build


def _declare(lib: ctypes.CDLL) -> None:
    lib.arbius_deflate_fixed.restype = ctypes.c_size_t
    lib.arbius_deflate_fixed.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t]


@functools.cache
def _load() -> ctypes.CDLL | None:
    try:
        return _build.load("codecs.cc", _declare)
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return None


def deflate_fixed():
    """Return a bytes->bytes compressor backed by the .so, or None."""
    lib = _load()
    if lib is None:
        return None

    def fn(data: bytes) -> bytes:
        # worst case fixed-Huffman: 9 bits/literal + 3-bit header + EOB
        cap = len(data) + len(data) // 4 + 64
        out = (ctypes.c_uint8 * cap)()
        written = lib.arbius_deflate_fixed(data, len(data), out, cap)
        if written == 0 and data:
            raise RuntimeError("native deflate overflow (bug: cap too small)")
        return bytes(out[:written])

    return fn
