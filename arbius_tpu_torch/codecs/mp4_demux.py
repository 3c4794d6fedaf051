"""MJPEG-MP4 demuxer — the input side of the video-matting path.

RVM's template input is a video *file* (`templates/robust_video_matting
.json`, type file); the node must turn those bytes into frames before
inference. This parses the ISO BMFF structure (stsz/stco sample tables)
and decodes the JPEG samples via PIL — handles the framework's own muxer
profile (codecs/mp4.py) and any MJPEG-in-MP4 file.

Note on determinism: input decoding sits UPSTREAM of inference, so the
decoder build is part of the solve's determinism class exactly like the
model weights are — the environment pins PIL. Output encoding (the bytes
that get CID'd) never goes through a third-party codec.
"""
from __future__ import annotations

import io
import struct

import numpy as np


def _boxes(data: bytes, start: int, end: int):
    off = start
    while off + 8 <= end:
        size = struct.unpack(">I", data[off:off + 4])[0]
        tag = data[off + 4:off + 8]
        if size == 1:  # 64-bit largesize
            size = struct.unpack(">Q", data[off + 8:off + 16])[0]
            yield tag, off + 16, off + size
        else:
            if size == 0:
                size = end - off
            yield tag, off + 8, off + size
        off += size


def _find(data: bytes, path: list[bytes], start=0, end=None):
    if end is None:
        end = len(data)
    if not path:
        return start, end
    for tag, s, e in _boxes(data, start, end):
        if tag == path[0]:
            return _find(data, path[1:], s, e)
    raise ValueError(f"box {path[0]!r} not found")


def _video_stbl(data: bytes):
    """(start, end) of the first VIDEO trak's stbl — external muxers
    often put an audio trak first, so trak selection must check the
    hdlr handler_type, not take the first trak."""
    moov = _find(data, [b"moov"])
    last_err = None
    for tag, s, e in _boxes(data, *moov):
        if tag != b"trak":
            continue
        try:
            mdia = _find(data, [b"mdia"], s, e)
            hs, _ = _find(data, [b"hdlr"], *mdia)
            if data[hs + 8:hs + 12] != b"vide":
                continue
            return _find(data, [b"minf", b"stbl"], *mdia)
        except ValueError as exc:
            last_err = exc
    raise ValueError(f"no video trak found ({last_err})")


def demux_samples(data: bytes) -> list[bytes]:
    """Walk the full sample tables (stsz/stco/co64/stsc incl. run
    expansion) of the first video track → per-sample bytes. Shared by the
    MJPEG and H.264 demux paths — an external muxer may pack many samples
    per chunk, which a naive zip(stco, stsz) silently truncates."""
    stbl = _video_stbl(data)
    sizes = chunk_offsets = stsc = None
    for tag, s, e in _boxes(data, *stbl):
        if tag == b"stsz":
            sample_size, count = struct.unpack(">II", data[s + 4:s + 12])
            if sample_size:
                sizes = [sample_size] * count
            else:
                sizes = list(struct.unpack(f">{count}I",
                                           data[s + 12:s + 12 + 4 * count]))
        elif tag == b"stco":
            count = struct.unpack(">I", data[s + 4:s + 8])[0]
            chunk_offsets = list(struct.unpack(
                f">{count}I", data[s + 8:s + 8 + 4 * count]))
        elif tag == b"co64":
            count = struct.unpack(">I", data[s + 4:s + 8])[0]
            chunk_offsets = list(struct.unpack(
                f">{count}Q", data[s + 8:s + 8 + 8 * count]))
        elif tag == b"stsc":
            count = struct.unpack(">I", data[s + 4:s + 8])[0]
            stsc = [struct.unpack(">III", data[s + 8 + 12 * i:
                                               s + 20 + 12 * i])
                    for i in range(count)]  # (first_chunk, per_chunk, desc)
    if sizes is None or chunk_offsets is None:
        raise ValueError("no sample tables (stsz/stco) found")

    # expand stsc runs into samples-per-chunk, then walk chunks laying
    # samples contiguously from each chunk offset
    n_chunks = len(chunk_offsets)
    per_chunk = [1] * n_chunks
    if stsc:
        for i, (first, count, _) in enumerate(stsc):
            last = stsc[i + 1][0] - 1 if i + 1 < len(stsc) else n_chunks
            for c in range(first - 1, last):
                per_chunk[c] = count
    offsets = []
    si = 0
    for ci, base in enumerate(chunk_offsets):
        off = base
        for _ in range(per_chunk[ci]):
            if si >= len(sizes):
                break
            offsets.append(off)
            off += sizes[si]
            si += 1
    if si != len(sizes):
        raise ValueError(
            f"sample tables inconsistent: stsc/stco cover {si} samples, "
            f"stsz declares {len(sizes)}")
    return [data[off:off + sz] for off, sz in zip(offsets, sizes)]


def demux_mjpeg_mp4(data: bytes) -> list[bytes]:
    """Extract per-sample JPEG bytes from an MJPEG MP4."""
    samples = demux_samples(data)
    for i, blob in enumerate(samples):
        if blob[:2] != b"\xff\xd8":
            raise ValueError(f"sample {i} is not a JPEG (MJPEG only)")
    return samples


def decode_mjpeg_mp4(data: bytes) -> np.ndarray:
    """MJPEG MP4 bytes → uint8 [T, H, W, 3] RGB frames."""
    from PIL import Image

    frames = [np.asarray(Image.open(io.BytesIO(s)).convert("RGB"))
              for s in demux_mjpeg_mp4(data)]
    if not frames:
        raise ValueError("no frames")
    return np.stack(frames)


def decode_video_mp4(data: bytes) -> np.ndarray:
    """MP4 bytes → uint8 [T, H, W, 3] RGB, dispatching on the sample
    entry: `avc1` (the framework's H.264 I_PCM class, codecs/h264.py)
    or MJPEG. The input side of the video-matting path."""
    try:
        stsd_s, stsd_e = _find(data, [b"stsd"], *_video_stbl(data))
    except ValueError:
        raise ValueError("not an ISO BMFF video file (no video stsd)")
    entry_tags = [tag for tag, _, _ in _boxes(data, stsd_s + 8, stsd_e)]
    if b"avc1" in entry_tags:
        from arbius_tpu_torch.codecs.h264_decode import (
            decode_h264_mp4_yuv,
            yuv420_to_rgb,
        )

        frames = [yuv420_to_rgb(y, cb, cr)
                  for y, cb, cr in decode_h264_mp4_yuv(data)]
        if not frames:
            raise ValueError("no frames")
        return np.stack(frames)
    return decode_mjpeg_mp4(data)
