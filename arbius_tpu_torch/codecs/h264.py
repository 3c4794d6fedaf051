"""Deterministic H.264 (AVC) encoder — all-intra I_PCM, Constrained Baseline.

Why this exists: the reference's video models ship standard H.264 MP4s
produced by ffmpeg inside cog containers (templates/zeroscopev2xl.json
declares `out-1.mp4` type video; website/src/pages/task/[taskid].tsx
renders it in a <video> tag). The framework's round-4 artifact was
Motion-JPEG-in-MP4 — deterministic but not decodable by mainstream
browser <video> elements. This module closes the artifact-class gap while
keeping the determinism contract absolute:

  - Every coded field is a fixed function of the input pixels. There is
    no rate control, no lookahead, no encoder state across frames, no
    floating point — identical frames always produce identical bytes.
  - Every frame is an IDR picture made of I_PCM macroblocks: raw 8-bit
    YCbCr samples carried verbatim in the bitstream (spec 7.3.5 /
    8.3.5). I_PCM support is mandatory for every conformant decoder at
    every profile, and the mode is exactly LOSSLESS — the decoder
    reconstructs bit-identical samples, so the deblocking filter is the
    only possible mutation and the slice header turns it off
    (disable_deblocking_filter_idc=1).
  - The cost is size: PCM is uncompressed (1.5 bytes/pixel for 4:2:0),
    the honest trade for a byte-stable, universally decodable artifact.
    (A fixed-QP CAVLC transform path can layer under the same API later;
    it changes size, never the determinism story.)

Color: BT.601 limited-range RGB→YCbCr in pinned integer arithmetic
(8-bit coefficients, round-half-up, 2x2 chroma average with fixed
rounding) — the same class of pinned math as codecs/jpeg.py.

Geometry: dimensions must be even (4:2:0 chroma siting); non-multiples
of 16 are edge-replicated up to whole macroblocks and declared via SPS
frame cropping, so decoders output exactly HxW.

Self-validation: codecs/h264_decode.py is a from-scratch I_PCM decoder;
tests/test_h264.py round-trips encoder→decoder and asserts LOSSLESS
sample recovery (the environment has no third-party H.264 decoder, and
output bytes must never depend on one anyway).
"""
from __future__ import annotations

import re
import struct

import numpy as np

PROFILE_IDC = 66          # Baseline
CONSTRAINT_FLAGS = 0xC0   # constraint_set0+1: Constrained Baseline
LEVEL_IDC = 51            # 5.1 — PCM bitrates exceed low-level caps

_EP_PATTERN = re.compile(rb"\x00\x00(?=[\x00-\x03])")


class BitWriter:
    """MSB-first RBSP bit writer."""

    def __init__(self):
        self._bytes = bytearray()
        self._acc = 0
        self._n = 0

    def u(self, value: int, bits: int) -> None:
        for i in range(bits - 1, -1, -1):
            self._acc = (self._acc << 1) | ((value >> i) & 1)
            self._n += 1
            if self._n == 8:
                self._bytes.append(self._acc)
                self._acc = 0
                self._n = 0

    def ue(self, value: int) -> None:
        code = value + 1
        nbits = code.bit_length()
        self.u(0, nbits - 1)
        self.u(code, nbits)

    def se(self, value: int) -> None:
        self.ue(2 * value - 1 if value > 0 else -2 * value)

    def align_zero(self) -> None:
        if self._n:
            self.u(0, 8 - self._n)

    def raw(self, data: bytes) -> None:
        assert self._n == 0, "raw() requires byte alignment"
        self._bytes += data

    def trailing(self) -> None:
        """rbsp_stop_one_bit + alignment zeros."""
        self.u(1, 1)
        self.align_zero()

    def bytes(self) -> bytes:
        assert self._n == 0, "unterminated bitstream"
        return bytes(self._bytes)


def escape_rbsp(rbsp: bytes) -> bytes:
    """Emulation prevention: 00 00 0x -> 00 00 03 0x (spec 7.4.1.1)."""
    return _EP_PATTERN.sub(b"\x00\x00\x03", rbsp)


def _nal(ref_idc: int, nal_type: int, rbsp: bytes) -> bytes:
    return bytes([(ref_idc << 5) | nal_type]) + escape_rbsp(rbsp)


def sps_bytes(width: int, height: int) -> bytes:
    """Sequence parameter set for WxH all-IDR 4:2:0 video (NAL included)."""
    mbs_w = (width + 15) // 16
    mbs_h = (height + 15) // 16
    w = BitWriter()
    w.u(PROFILE_IDC, 8)
    w.u(CONSTRAINT_FLAGS, 8)
    w.u(LEVEL_IDC, 8)
    w.ue(0)            # seq_parameter_set_id
    w.ue(0)            # log2_max_frame_num_minus4 (frame_num is 0: all IDR)
    w.ue(2)            # pic_order_cnt_type 2: POC = output order, no syntax
    w.ue(1)            # max_num_ref_frames (unused by all-IDR, legal floor)
    w.u(0, 1)          # gaps_in_frame_num_value_allowed_flag
    w.ue(mbs_w - 1)    # pic_width_in_mbs_minus1
    w.ue(mbs_h - 1)    # pic_height_in_map_units_minus1
    w.u(1, 1)          # frame_mbs_only_flag
    w.u(1, 1)          # direct_8x8_inference_flag
    crop_r = mbs_w * 16 - width
    crop_b = mbs_h * 16 - height
    if crop_r or crop_b:
        if crop_r % 2 or crop_b % 2:
            raise ValueError("width/height must be even (4:2:0 crop units)")
        w.u(1, 1)
        w.ue(0)                 # left
        w.ue(crop_r // 2)       # right, in 2-sample crop units
        w.ue(0)                 # top
        w.ue(crop_b // 2)       # bottom
    else:
        w.u(0, 1)
    w.u(0, 1)          # vui_parameters_present_flag
    w.trailing()
    return _nal(3, 7, w.bytes())


def pps_bytes() -> bytes:
    """Picture parameter set (NAL included): CAVLC, deblock control on."""
    w = BitWriter()
    w.ue(0)            # pic_parameter_set_id
    w.ue(0)            # seq_parameter_set_id
    w.u(0, 1)          # entropy_coding_mode_flag: CAVLC
    w.u(0, 1)          # bottom_field_pic_order_in_frame_present_flag
    w.ue(0)            # num_slice_groups_minus1
    w.ue(0)            # num_ref_idx_l0_default_active_minus1
    w.ue(0)            # num_ref_idx_l1_default_active_minus1
    w.u(0, 1)          # weighted_pred_flag
    w.u(0, 2)          # weighted_bipred_idc
    w.se(0)            # pic_init_qp_minus26
    w.se(0)            # pic_init_qs_minus26
    w.se(0)            # chroma_qp_index_offset
    w.u(1, 1)          # deblocking_filter_control_present_flag
    w.u(0, 1)          # constrained_intra_pred_flag
    w.u(0, 1)          # redundant_pic_cnt_present_flag
    w.trailing()
    return _nal(3, 8, w.bytes())


def rgb_to_yuv420(frame: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """uint8 [H,W,3] RGB → (Y [H,W], Cb [H/2,W/2], Cr) — BT.601 limited
    range, pinned integer math (JFIF-class determinism; see jpeg.py)."""
    if frame.dtype != np.uint8 or frame.ndim != 3 or frame.shape[2] != 3:
        raise ValueError(f"expected uint8 [H,W,3], got {frame.dtype} "
                         f"{frame.shape}")
    h, wd = frame.shape[:2]
    if h % 2 or wd % 2:
        raise ValueError("height/width must be even for 4:2:0")
    r = frame[:, :, 0].astype(np.int32)
    g = frame[:, :, 1].astype(np.int32)
    b = frame[:, :, 2].astype(np.int32)
    y = 16 + ((66 * r + 129 * g + 25 * b + 128) >> 8)
    cb = 128 + ((-38 * r - 74 * g + 112 * b + 128) >> 8)
    cr = 128 + ((112 * r - 94 * g - 18 * b + 128) >> 8)
    # 2x2 chroma average with fixed round-half-up
    def sub(c):
        return (c[0::2, 0::2] + c[0::2, 1::2] + c[1::2, 0::2]
                + c[1::2, 1::2] + 2) >> 2
    return (np.clip(y, 0, 255).astype(np.uint8),
            np.clip(sub(cb), 0, 255).astype(np.uint8),
            np.clip(sub(cr), 0, 255).astype(np.uint8))


def _pad_to_mbs(plane: np.ndarray, mb: int) -> np.ndarray:
    """Edge-replicate a plane up to whole macroblock multiples (the
    decoder crops these samples away; replication keeps them pinned)."""
    h, wd = plane.shape
    ph = (-h) % mb
    pw = (-wd) % mb
    if ph == 0 and pw == 0:
        return plane
    return np.pad(plane, ((0, ph), (0, pw)), mode="edge")


def _mb_blocks(plane: np.ndarray, mb: int) -> np.ndarray:
    """[H, W] plane → [n_mbs, mb*mb] raster-ordered macroblock payloads."""
    h, wd = plane.shape
    return (plane.reshape(h // mb, mb, wd // mb, mb)
            .transpose(0, 2, 1, 3).reshape(-1, mb * mb))


def idr_slice_ipcm(y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
                   idr_pic_id: int) -> bytes:
    """One IDR picture (single slice, all I_PCM macroblocks) as a NAL.

    y: uint8 [H,W] (H,W multiples of 16); cb/cr: uint8 [H/2,W/2].

    Vectorized: after the slice header's first macroblock, every MB
    starts byte-aligned, so its syntax is a CONSTANT 2-byte prefix
    (ue(25) = '000011010' → 0x0D, then the 9th bit + 7 pcm-alignment
    zeros → 0x00) followed by 384 raw sample bytes — the whole slice
    body is one numpy concatenation instead of a 2304-iteration Python
    loop per 1024×576 frame (~20× faster, byte-identical; equality vs
    the scalar BitWriter construction is asserted in tests/test_h264.py).
    """
    mbs_h, mbs_w = y.shape[0] // 16, y.shape[1] // 16
    n = mbs_h * mbs_w
    w = BitWriter()
    w.ue(0)            # first_mb_in_slice
    w.ue(7)            # slice_type: I (all slices in picture are I)
    w.ue(0)            # pic_parameter_set_id
    w.u(0, 4)          # frame_num (log2_max_frame_num = 4; IDR ⇒ 0)
    w.ue(idr_pic_id & 1)  # idr_pic_id (consecutive IDRs must differ)
    w.u(0, 1)          # no_output_of_prior_pics_flag
    w.u(0, 1)          # long_term_reference_flag
    w.se(0)            # slice_qp_delta
    w.ue(1)            # disable_deblocking_filter_idc: OFF (losslessness)
    # first MB via the bit writer (the header leaves an arbitrary bit
    # position; ue(25) + pcm alignment re-aligns)
    w.u(25 + 1, 9)     # ue(25): 4 zeros + '11010'
    w.align_zero()
    mb = np.concatenate([_mb_blocks(y, 16), _mb_blocks(cb, 8),
                         _mb_blocks(cr, 8)], axis=1)   # [n, 384]
    w.raw(mb[0].tobytes())
    if n > 1:
        body = np.concatenate(
            [np.tile(np.array([[0x0D, 0x00]], np.uint8), (n - 1, 1)),
             mb[1:]], axis=1)
        w.raw(body.tobytes())
    w.trailing()
    return _nal(3, 5, w.bytes())


def encode_h264(frames: np.ndarray) -> tuple[bytes, bytes, list[bytes]]:
    """uint8 [T,H,W,3] RGB → (sps_nal, pps_nal, [access_unit_nal, ...])."""
    if frames.dtype != np.uint8 or frames.ndim != 4 or frames.shape[3] != 3:
        raise ValueError(f"expected uint8 [T,H,W,3] RGB, got "
                         f"{frames.dtype} {frames.shape}")
    t, h, wd, _ = frames.shape
    sps = sps_bytes(wd, h)
    pps = pps_bytes()
    aus = []
    for i in range(t):
        y, cb, cr = rgb_to_yuv420(frames[i])
        aus.append(idr_slice_ipcm(_pad_to_mbs(y, 16), _pad_to_mbs(cb, 8),
                                  _pad_to_mbs(cr, 8), idr_pic_id=i))
    return sps, pps, aus


def avcc_box_payload(sps: bytes, pps: bytes) -> bytes:
    """AVCDecoderConfigurationRecord (the avcC box payload)."""
    return (bytes([1, PROFILE_IDC, CONSTRAINT_FLAGS, LEVEL_IDC,
                   0xFF,            # reserved | lengthSizeMinusOne=3
                   0xE1])           # reserved | numOfSPS=1
            + struct.pack(">H", len(sps)) + sps
            + bytes([1])            # numOfPPS
            + struct.pack(">H", len(pps)) + pps)
