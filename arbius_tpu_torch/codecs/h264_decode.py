"""H.264 I_PCM decoder — the round-trip oracle for codecs/h264.py.

A from-scratch parser for the exact stream class the encoder emits
(all-IDR, single slice, I_PCM macroblocks, CAVLC mode, 4:2:0): it walks
the avc1 MP4 sample tables, strips emulation prevention, parses SPS/PPS/
slice headers field-by-field (validating the pinned profile), and
reassembles the raw PCM planes. Because I_PCM is lossless, the decode
must recover the encoder's YCbCr samples BIT-EXACTLY — asserted by
tests/test_h264.py. The environment ships no third-party H.264 decoder,
so this is both the test oracle and the input-side capability for
H.264-class video files (the MJPEG analogue is mp4_demux.py).
"""
from __future__ import annotations

import re
import struct

import numpy as np

from arbius_tpu_torch.codecs.mp4_demux import _boxes, _find

_UNESCAPE = re.compile(rb"\x00\x00\x03(?=[\x00-\x03])")


def unescape_rbsp(ebsp: bytes) -> bytes:
    return _UNESCAPE.sub(b"\x00\x00", ebsp)


class BitReader:
    def __init__(self, data: bytes):
        self._d = data
        self._pos = 0  # bit position

    def u(self, bits: int) -> int:
        v = 0
        for _ in range(bits):
            byte = self._d[self._pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self._pos & 7))) & 1)
            self._pos += 1
        return v

    def ue(self) -> int:
        zeros = 0
        while self.u(1) == 0:
            zeros += 1
            if zeros > 32:
                raise ValueError("malformed exp-golomb code")
        return (1 << zeros) - 1 + (self.u(zeros) if zeros else 0)

    def se(self) -> int:
        code = self.ue()
        return (code + 1) // 2 if code % 2 else -(code // 2)

    def align(self) -> None:
        self._pos = (self._pos + 7) & ~7

    def raw(self, n: int) -> bytes:
        assert self._pos % 8 == 0
        start = self._pos >> 3
        self._pos += 8 * n
        return self._d[start:start + n]


def parse_sps(rbsp: bytes) -> dict:
    r = BitReader(rbsp)
    profile = r.u(8)
    r.u(8)  # constraint flags + reserved
    level = r.u(8)
    r.ue()  # sps id
    if profile in (100, 110, 122, 244, 44, 83, 86, 118, 128):
        raise ValueError("high-profile SPS not supported by this decoder")
    log2_max_frame_num = r.ue() + 4
    poc_type = r.ue()
    log2_max_poc_lsb = 0
    if poc_type == 0:
        log2_max_poc_lsb = r.ue() + 4
    elif poc_type == 1:
        raise ValueError("poc_type 1 not supported")
    r.ue()   # max_num_ref_frames
    r.u(1)   # gaps_in_frame_num_value_allowed_flag
    mbs_w = r.ue() + 1
    mbs_h = r.ue() + 1
    frame_mbs_only = r.u(1)
    if not frame_mbs_only:
        raise ValueError("interlaced streams not supported")
    r.u(1)   # direct_8x8_inference_flag
    crop = [0, 0, 0, 0]
    if r.u(1):
        crop = [r.ue(), r.ue(), r.ue(), r.ue()]  # l, r, t, b (chroma units)
    return {"profile": profile, "level": level,
            "log2_max_frame_num": log2_max_frame_num,
            "poc_type": poc_type, "log2_max_poc_lsb": log2_max_poc_lsb,
            "mbs_w": mbs_w, "mbs_h": mbs_h,
            "width": mbs_w * 16 - 2 * (crop[0] + crop[1]),
            "height": mbs_h * 16 - 2 * (crop[2] + crop[3])}


def parse_pps(rbsp: bytes) -> dict:
    r = BitReader(rbsp)
    r.ue()  # pps id
    r.ue()  # sps id
    cavlc = r.u(1) == 0
    if not cavlc:
        raise ValueError("CABAC streams not supported")
    r.u(1)
    if r.ue() != 0:
        raise ValueError("slice groups not supported")
    r.ue(); r.ue(); r.u(1); r.u(2)
    pic_init_qp = 26 + r.se()
    r.se(); r.se()
    deblock_control = r.u(1)
    return {"pic_init_qp": pic_init_qp, "deblock_control": deblock_control}


def decode_idr_ipcm(rbsp: bytes, sps: dict, pps: dict
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One IDR slice of I_PCM macroblocks → (Y, Cb, Cr) uint8 planes
    (uncropped)."""
    r = BitReader(rbsp)
    if r.ue() != 0:
        raise ValueError("multi-slice pictures not supported")
    slice_type = r.ue()
    if slice_type % 5 != 2:
        raise ValueError(f"not an I slice (slice_type {slice_type})")
    r.ue()                          # pps id
    r.u(sps["log2_max_frame_num"])  # frame_num
    r.ue()                          # idr_pic_id
    if sps.get("poc_type", 2) == 0:
        # poc_type-0 streams carry pic_order_cnt_lsb in EVERY slice
        # header (7.3.3) — skipping it misaligns the macroblock parse
        r.u(sps["log2_max_poc_lsb"])
    r.u(1); r.u(1)                  # dec_ref_pic_marking (IDR)
    r.se()                          # slice_qp_delta
    if pps["deblock_control"]:
        # alpha/beta offsets are present whenever idc != 1 (7.3.3) —
        # including idc == 0 (deblocking on; harmless for I_PCM samples,
        # which the filter bypasses)
        if r.ue() != 1:             # disable_deblocking_filter_idc
            r.se(); r.se()
    mbs_w, mbs_h = sps["mbs_w"], sps["mbs_h"]
    y = np.empty((mbs_h * 16, mbs_w * 16), np.uint8)
    cb = np.empty((mbs_h * 8, mbs_w * 8), np.uint8)
    cr = np.empty((mbs_h * 8, mbs_w * 8), np.uint8)
    for my in range(mbs_h):
        for mx in range(mbs_w):
            mb_type = r.ue()
            if mb_type != 25:
                raise ValueError(f"non-I_PCM mb_type {mb_type} "
                                 "not supported by this decoder")
            r.align()
            y[my * 16:(my + 1) * 16, mx * 16:(mx + 1) * 16] = \
                np.frombuffer(r.raw(256), np.uint8).reshape(16, 16)
            cb[my * 8:(my + 1) * 8, mx * 8:(mx + 1) * 8] = \
                np.frombuffer(r.raw(64), np.uint8).reshape(8, 8)
            cr[my * 8:(my + 1) * 8, mx * 8:(mx + 1) * 8] = \
                np.frombuffer(r.raw(64), np.uint8).reshape(8, 8)
    return y, cb, cr


def _avc_config(data: bytes) -> tuple[dict, dict]:
    """Parse avcC out of the avc1 sample entry → (sps, pps) dicts."""
    from arbius_tpu_torch.codecs.mp4_demux import _video_stbl

    s, e = _find(data, [b"stsd"], *_video_stbl(data))
    payload = data[s:e]
    # stsd: version/flags + entry_count, then the avc1 entry
    entry_start = s + 8
    for tag, bs, be in _boxes(data, entry_start, e):
        if tag == b"avc1":
            # 78 bytes of VisualSampleEntry fields before child boxes
            for ctag, cs, ce in _boxes(data, bs + 78, be):
                if ctag == b"avcC":
                    cfg = data[cs:ce]
                    n_sps = cfg[5] & 0x1F
                    off = 6
                    sps_rbsp = None
                    for _ in range(n_sps):
                        ln = struct.unpack(">H", cfg[off:off + 2])[0]
                        sps_rbsp = unescape_rbsp(cfg[off + 3:off + 2 + ln])
                        off += 2 + ln
                    n_pps = cfg[off]
                    off += 1
                    pps_rbsp = None
                    for _ in range(n_pps):
                        ln = struct.unpack(">H", cfg[off:off + 2])[0]
                        pps_rbsp = unescape_rbsp(cfg[off + 3:off + 2 + ln])
                        off += 2 + ln
                    return parse_sps(sps_rbsp), parse_pps(pps_rbsp)
    raise ValueError("no avc1/avcC sample entry found")


def _samples(data: bytes) -> list[bytes]:
    # the full stsz/stco/co64/stsc walker (run expansion included) —
    # external muxers pack many samples per chunk, which a naive
    # zip(stco, stsz) silently truncates
    from arbius_tpu_torch.codecs.mp4_demux import demux_samples

    return demux_samples(data)


def decode_h264_mp4_yuv(data: bytes
                        ) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """avc1 MP4 → per-frame (Y, Cb, Cr) uint8 planes, cropped to the
    SPS-declared geometry.

    Supported input is the repo's own artifact class ONLY: all-IDR
    I_PCM streams (every frame a type-5 IDR slice, as codecs/h264.py
    emits). Inter-predicted input (VCL NAL types 1-4: non-IDR /
    partitioned slices, what a general encoder produces) is REJECTED
    rather than skipped — silently dropping those frames used to matte
    a truncated clip from an external avc1 file, which looks like a
    model bug instead of an input-format error."""
    sps, pps = _avc_config(data)
    out = []
    for sample in _samples(data):
        off = 0
        while off + 4 <= len(sample):
            ln = struct.unpack(">I", sample[off:off + 4])[0]
            nal = sample[off + 4:off + 4 + ln]
            off += 4 + ln
            nal_type = nal[0] & 0x1F
            if nal_type == 5:
                y, cb, cr = decode_idr_ipcm(unescape_rbsp(nal[1:]), sps, pps)
                h, wd = sps["height"], sps["width"]
                out.append((y[:h, :wd], cb[:h // 2, :wd // 2],
                            cr[:h // 2, :wd // 2]))
            elif nal_type in (1, 2, 3, 4):
                raise ValueError(
                    f"inter-predicted H.264 input (VCL NAL type {nal_type}"
                    f" at frame {len(out)}): only all-IDR I_PCM avc1 "
                    "streams are supported — re-encode the clip intra-only "
                    "(e.g. the codecs/h264.py encoder) before submitting")
    return out


def yuv420_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray
                  ) -> np.ndarray:
    """Inverse of h264.rgb_to_yuv420's color transform (pinned integer
    BT.601 limited-range), chroma upsampled by sample replication."""
    yf = (y.astype(np.int32) - 16) * 298
    cbu = np.repeat(np.repeat(cb.astype(np.int32) - 128, 2, 0), 2, 1)
    cru = np.repeat(np.repeat(cr.astype(np.int32) - 128, 2, 0), 2, 1)
    r = (yf + 409 * cru + 128) >> 8
    g = (yf - 100 * cbu - 208 * cru + 128) >> 8
    b = (yf + 516 * cbu + 128) >> 8
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)
