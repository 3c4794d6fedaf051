"""Deterministic media codecs: the artifact-byte layer of the solve path.

Copies of the reference's `codecs/png.py`, `codecs/deflate.py` (and its
native deflate core, as csrc/codecs.cc), `codecs/jpeg.py`,
`codecs/h264.py` and `codecs/mp4.py`: the solution CID is computed over
the encoded bytes, so they are pinned by specification and every miner
produces the same bytes. The video templates' out-1.mp4 is
`encode_mp4_h264`'s all-intra H.264 in an MP4 container.
"""
from arbius_tpu_torch.codecs.jpeg import encode_jpeg
from arbius_tpu_torch.codecs.mp4 import (
    encode_mp4,
    encode_mp4_h264,
    mux_avc1_mp4,
    mux_mjpeg_mp4,
)
from arbius_tpu_torch.codecs.png import encode_png

__all__ = ["encode_jpeg", "encode_mp4", "encode_mp4_h264", "encode_png",
           "mux_avc1_mp4", "mux_mjpeg_mp4"]
