"""Exact softmax attention for [B, H, S, D]: the Hopper kernel and its
plain PyTorch version, side by side.

`flash_attention` launches the hand-written CUDA kernel in
``csrc/flash_attn.cu`` (the twin of the Pallas kernel in
arbius_tpu/ops/flash.py; the source says what bounds it and how it is
laid out). It takes CUDA tensors only and raises on anything else.
`flash_attention_reference` is the plain version, the twin of
`sp_attention_reference` (arbius_tpu/ops/ring.py): scores in the input
dtype, softmax in float32, probabilities cast back to v's dtype.
`attention` is what the models call: the kernel for every CUDA tensor,
the plain version for a CPU tensor. There is no other switch and no
fallback.

The kernel's arithmetic differs from the plain version's in bf16: it
keeps the scores and probabilities in float32 and rounds only its
output. So its bf16 output is held against the plain version run in
float32 on the same inputs, one bf16 rounding apart.
"""
from __future__ import annotations

import ctypes
import math

import torch

from arbius_tpu_torch.ops import _build

SOURCE = "flash_attn.cu"
MAX_HEAD_DIM = 512
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor) -> torch.Tensor:
    """Plain exact attention; q/k/v [B, H, S, D] -> [B, H, Sq, D]."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v).to(q.dtype)


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.arbius_flash_attn_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 9
                   + [ctypes.c_float, ctypes.c_void_p])


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, H, S, D]")
    b, h, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[1] != h \
            or k.shape[3] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes must match and be float32 or bfloat16, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if min(d, k.shape[2]) < 1 or d > MAX_HEAD_DIM:
        raise ValueError(f"need 1 <= D <= {MAX_HEAD_DIM} and S_kv >= 1, "
                         f"got D={d}, S_kv={k.shape[2]}")
    if b * h > 65535:
        raise ValueError(f"B*H = {b * h} exceeds the grid limit 65535")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k, v need a contiguous last (head) dimension")


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel: q/k/v [B, H, S, D] (any strides over B, H
    and S, unit stride over D) -> contiguous [B, H, Sq, D] in q's dtype.
    Launches on the current stream and does not synchronise."""
    _check(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention takes CUDA tensors, got "
                         f"{q.device}; attention() uses the plain version "
                         "for CPU tensors")
    lib = _build.load(SOURCE, _declare)
    b, h, sq, d = q.shape
    out = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    err = lib.arbius_flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPES[q.dtype], b, h, sq, k.shape[2], d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        1.0 / math.sqrt(d), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash attention launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0  # kernel launches since the last reset


def attention(q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """Exact attention for [B, H, S, D]: the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    if q.device.type == "cuda":
        return flash_attention(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v)
    raise ValueError(f"unsupported device {q.device}")
