"""Deterministic MP4 (ISO BMFF) muxer — Motion-JPEG video track.

Video templates output `out-1.mp4` (`templates/zeroscopev2xl.json`,
`damo.json`, `robust_video_matting.json`); the reference takes whatever mp4
its cog container produced, so ffmpeg's encoder build defines its bytes.
Here the mp4 IS the framework's artifact, so every field that is normally
"now()" or encoder-version-dependent is pinned:

  - creation_time / modification_time = 0 in every box
  - Motion-JPEG samples ('jpeg' VisualSampleEntry — I-frame only, each
    sample an independent baseline JPEG from jpeg.py), so no inter-frame
    encoder state can introduce nondeterminism
  - fixed box order: ftyp, mdat, moov; fixed track/handler metadata

Layout is the classic single-track progressive file: stts (one run),
stsc (one run), stsz (per-sample sizes), stco (absolute offsets into mdat).
"""
from __future__ import annotations

import struct

import numpy as np

from arbius_tpu_torch.codecs.jpeg import encode_jpeg


def _box(tag: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", len(payload) + 8) + tag + payload


def _full(tag: bytes, version: int, flags: int, payload: bytes) -> bytes:
    return _box(tag, struct.pack(">B", version) + struct.pack(">I", flags)[1:]
                + payload)


_MATRIX = struct.pack(">9i", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)


def _mvhd(timescale: int, duration: int) -> bytes:
    p = struct.pack(">IIII", 0, 0, timescale, duration)
    p += struct.pack(">iH", 0x10000, 0x100) + b"\x00" * 10  # rate, volume
    p += _MATRIX + b"\x00" * 24 + struct.pack(">I", 2)      # next track id
    return _full(b"mvhd", 0, 0, p)


def _tkhd(duration: int, width: int, height: int) -> bytes:
    p = struct.pack(">IIIII", 0, 0, 1, 0, duration)         # track id 1
    p += b"\x00" * 8 + struct.pack(">HHHH", 0, 0, 0, 0)
    p += _MATRIX
    p += struct.pack(">II", width << 16, height << 16)
    return _full(b"tkhd", 0, 3, p)                          # enabled|in-movie


def _mdhd(timescale: int, duration: int) -> bytes:
    p = struct.pack(">IIII", 0, 0, timescale, duration)
    p += struct.pack(">HH", 0x55C4, 0)                      # language 'und'
    return _full(b"mdhd", 0, 0, p)


def _hdlr() -> bytes:
    p = struct.pack(">I", 0) + b"vide" + b"\x00" * 12 + b"arbius video\x00"
    return _full(b"hdlr", 0, 0, p)


def _visual_entry(tag: bytes, width: int, height: int, name: bytes,
                  extra: bytes = b"") -> bytes:
    """VisualSampleEntry (78 fixed bytes) + child boxes (`extra`)."""
    entry = b"\x00" * 6 + struct.pack(">H", 1)              # reserved, dref 1
    entry += struct.pack(">HHIII", 0, 0, 0, 0, 0)           # pre-defined
    entry += struct.pack(">HH", width, height)
    entry += struct.pack(">II", 0x480000, 0x480000)         # 72 dpi
    entry += struct.pack(">IH", 0, 1)                       # frame count 1
    entry += bytes([len(name)]) + name + b"\x00" * (31 - len(name))
    entry += struct.pack(">Hh", 24, -1)                     # depth, color table
    return _box(tag, entry + extra)


def _stsd(sample_entry: bytes) -> bytes:
    return _full(b"stsd", 0, 0, struct.pack(">I", 1) + sample_entry)


def mux_mjpeg_mp4(jpeg_frames: list[bytes], fps: int,
                  width: int, height: int) -> bytes:
    return _mux_video(jpeg_frames, fps,
                      _visual_entry(b"jpeg", width, height, b"arbius mjpeg"),
                      width, height)


def mux_avc1_mp4(access_units: list[bytes], sps: bytes, pps: bytes,
                 fps: int, width: int, height: int) -> bytes:
    """H.264-in-MP4: each sample is one length-prefixed IDR NAL; SPS/PPS
    travel out-of-band in the avcC record (standard avc1 storage). Every
    sample is a sync sample (all-IDR), so no stss box is needed — its
    absence declares exactly that."""
    from arbius_tpu_torch.codecs.h264 import avcc_box_payload

    samples = [struct.pack(">I", len(au)) + au for au in access_units]
    # avcC carries complete NAL units (header byte + escaped payload),
    # which is exactly what h264.sps_bytes/pps_bytes return
    avcc = _box(b"avcC", avcc_box_payload(sps, pps))
    entry = _visual_entry(b"avc1", width, height, b"arbius avc", avcc)
    return _mux_video(samples, fps, entry, width, height)


def _mux_video(samples: list[bytes], fps: int, sample_entry: bytes,
               width: int, height: int) -> bytes:
    n = len(samples)
    if n == 0:
        raise ValueError("need at least one frame")
    timescale = fps
    duration = n

    mdat_payload = b"".join(samples)
    ftyp = _box(b"ftyp", b"isom" + struct.pack(">I", 0x200) + b"isomiso2mp41")
    mdat = _box(b"mdat", mdat_payload)

    # sample offsets are absolute file offsets; mdat follows ftyp
    data_start = len(ftyp) + 8
    offsets = []
    off = data_start
    for f in samples:
        offsets.append(off)
        off += len(f)

    stts = _full(b"stts", 0, 0, struct.pack(">III", 1, n, 1))
    stsc = _full(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, 1, 1))
    stsz = _full(b"stsz", 0, 0, struct.pack(">II", 0, n)
                 + b"".join(struct.pack(">I", len(f)) for f in samples))
    stco = _full(b"stco", 0, 0, struct.pack(">I", n)
                 + b"".join(struct.pack(">I", o) for o in offsets))
    stbl = _box(b"stbl", _stsd(sample_entry) + stts + stsc + stsz + stco)

    dref = _full(b"dref", 0, 0, struct.pack(">I", 1) + _full(b"url ", 0, 1, b""))
    dinf = _box(b"dinf", dref)
    vmhd = _full(b"vmhd", 0, 1, struct.pack(">HHHH", 0, 0, 0, 0))
    minf = _box(b"minf", vmhd + dinf + stbl)
    mdia = _box(b"mdia", _mdhd(timescale, duration) + _hdlr() + minf)
    trak = _box(b"trak", _tkhd(duration, width, height) + mdia)
    moov = _box(b"moov", _mvhd(timescale, duration) + trak)
    return ftyp + mdat + moov


def encode_mp4(frames: np.ndarray, fps: int = 8, quality: int = 90) -> bytes:
    """uint8 [T,H,W,3] RGB -> deterministic MJPEG-in-MP4 bytes."""
    if frames.dtype != np.uint8 or frames.ndim != 4 or frames.shape[3] != 3:
        raise ValueError(f"expected uint8 [T,H,W,3] RGB, got "
                         f"{frames.dtype} {frames.shape}")
    t, h, w, _ = frames.shape
    jpegs = [encode_jpeg(frames[i], quality=quality) for i in range(t)]
    return mux_mjpeg_mp4(jpegs, fps=fps, width=w, height=h)


def encode_mp4_h264(frames: np.ndarray, fps: int = 8) -> bytes:
    """uint8 [T,H,W,3] RGB -> deterministic H.264 (all-intra I_PCM,
    lossless-in-YCbCr) MP4 bytes — the browser-playable artifact class
    the reference's cog/ffmpeg outputs belong to (codecs/h264.py)."""
    from arbius_tpu_torch.codecs.h264 import encode_h264

    t, h, w, _ = frames.shape
    sps, pps, aus = encode_h264(frames)
    return mux_avc1_mp4(aus, sps, pps, fps=fps, width=w, height=h)
