"""Exact softmax attention for [B, H, S, D]: the Hopper kernels and their
plain PyTorch version, side by side.

`flash_attention` launches one of six hand-written CUDA kernels, all
twins of the Pallas kernel in arbius_tpu/ops/flash.py (each source says
what bounds it and how it is laid out). The five tensor-core routes take
bf16 with B/H/S strides that are multiples of 8 elements and 16-byte
aligned data (their loads are 16-byte copies or TMA boxes):

  - ``tensor_core_wgmma`` (``csrc/flash_attn_wgmma.cu``): Hopper's
    warpgroup products (wgmma) fed by TMA, consumer warpgroups taking
    turns on them over a ring of key tiles, in persistent blocks (one
    per SM) that walk (b*h, query tile) work tiles in a fixed order, O
    written by TMA stores, for D = 40, 64, 80 and 160 at any lengths.
    The UNets' self-attentions over more than 128 keys take it.
  - ``tensor_core_wgmma_short`` (``csrc/flash_attn_wgmma_short.cu``):
    wgmma over one key tile, K and V resident and the query tiles
    streamed through a TMA ring, O written by TMA stores, for D = 40, 64,
    80 and 160 with Skv <= 128. The UNets' 77-key cross-attentions and
    their self-attentions of 128 tokens or fewer take it.
  - ``tensor_core_wgmma_wide`` (``csrc/flash_attn_wgmma_wide.cu``): wgmma
    for D = 512 at any lengths, two consumer warpgroups splitting O by
    columns, each K/V box loaded once per thread-block cluster and
    multicast into its blocks. The VAE's mid-block attention takes it.
  - ``tensor_core`` (``csrc/flash_attn_tc.cu``): mma.sync with bf16
    operands, for 8 <= D <= 160, D % 8 == 0. No anythingv3 attention
    takes it; it stays for other head dims.
  - ``tensor_core_wide`` (``csrc/flash_attn_tc_wide.cu``): mma.sync with
    bf16 operands, the accumulator and S split over 8 warps, for
    D = 512. No anythingv3 attention takes it; checks force it.
  - ``cuda_core`` (``csrc/flash_attn.cu``): float32 arithmetic on the
    CUDA cores, for everything else (float32, other head dims, odd
    strides).

`route` is the rule between them: a pure function of dtype, head dim,
strides, pointers and lengths, so a given call always takes the same
kernel and the route is part of the determinism class. It is not a
fallback: a launch that fails raises. The kernels take CUDA tensors only.
`flash_attention_reference` is the plain version, the twin of
`sp_attention_reference` (arbius_tpu/ops/ring.py): scores in the input
dtype, softmax in float32, probabilities cast back to v's dtype.
`attention` is what the models call: the kernels for every CUDA tensor,
the plain version for a CPU tensor.

All kernels keep the scores, the softmax statistics and the accumulator
in float32, so their output is held against the plain version run in
float32 on the same inputs, within `error_bound`.
"""
from __future__ import annotations

import ctypes
import math

import torch

from arbius_tpu_torch.ops import _build

SOURCES = {"tensor_core_wgmma": "flash_attn_wgmma.cu",
           "tensor_core_wgmma_short": "flash_attn_wgmma_short.cu",
           "tensor_core_wgmma_wide": "flash_attn_wgmma_wide.cu",
           "tensor_core": "flash_attn_tc.cu",
           "tensor_core_wide": "flash_attn_tc_wide.cu",
           "cuda_core": "flash_attn.cu"}
_ENTRY = {"tensor_core_wgmma": "arbius_flash_attn_wgmma_fwd",
          "tensor_core_wgmma_short": "arbius_flash_attn_wgmma_short_fwd",
          "tensor_core_wgmma_wide": "arbius_flash_attn_wgmma_wide_fwd",
          "tensor_core": "arbius_flash_attn_tc_fwd",
          "tensor_core_wide": "arbius_flash_attn_tc_wide_fwd",
          "cuda_core": "arbius_flash_attn_fwd"}
MAX_HEAD_DIM = 512
# the wgmma kernels' head dims; the short one takes key lengths up to
# WGMMA_SHORT_MAX_KV (one key tile)
WGMMA_HEAD_DIMS = (40, 64, 80, 160)
WGMMA_SHORT_MAX_KV = 128
TC_MAX_HEAD_DIM = 160
TC_WIDE_HEAD_DIM = 512
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (atol, rtol) of a kernel's output against the plain version run in
# float32 on the same inputs; see error_bound
TOL = {"bfloat16": (1e-4, 2.0 ** -8), "float32": (2e-5, 2e-5)}


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor) -> torch.Tensor:
    """Plain exact attention; q/k/v [B, H, S, D] -> [B, H, Sq, D]."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v).to(q.dtype)


def error_bound(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                route: str) -> torch.Tensor:
    """Per-element bound [B, H, Sq, D] on |kernel - ref|, with ref the
    plain version run in float32 on the same inputs, for `route`'s
    output in q's dtype. From the plain version's float32 probabilities P:

      - float32: 2e-5 + 2e-5 * |ref| (summation order);
      - bf16, cuda_core: 1e-4 + 2**-8 * |ref|: one rounding of the
        float32 result (<= 2**-9 of it), doubled, plus atol for float32
        summation order;
      - bf16, the five tensor-core routes: 1e-4 + 2**-8 * (|ref| +
        P |V|): P is rounded to bf16 before P V (<= 2**-9 of each
        p_i |v_i|, doubled as above), while l sums the unrounded P.
    """
    if route not in SOURCES:
        raise ValueError(f"unknown route {route!r}")
    atol, rtol = TOL[str(q.dtype).split(".")[-1]]
    scale = 1.0 / math.sqrt(q.shape[-1])
    vf = v.float()
    p = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", q.float(),
                                   k.float()) * scale, dim=-1)
    size = torch.einsum("bhqk,bhkd->bhqd", p, vf).abs()
    if route != "cuda_core" and q.dtype == torch.bfloat16:
        size += torch.einsum("bhqk,bhkd->bhqd", p, vf.abs())
    return atol + rtol * size


def routes(dtype: torch.dtype, d: int, strides, pointers, sq: int,
           skv: int) -> list[str]:
    """Every route whose kernel takes a call, the rule's choice first. The
    tensor-core routes need bf16 with every stride in `strides` (the B, H
    and S strides of q, k and v, in elements) a multiple of 8 and every
    data pointer in `pointers` 16-byte aligned; then
    "tensor_core_wgmma_short" takes d in {40, 64, 80, 160} with `skv` <=
    128, "tensor_core_wgmma" d in {40, 64, 80, 160}, "tensor_core" 8 <= d <= 160
    with d % 8 == 0, and "tensor_core_wgmma_wide" then "tensor_core_wide"
    d = 512. "cuda_core" takes every call. The short route comes before
    the wgmma one wherever both take a call: on the H100 it was 1.2-2.2x
    faster at every anythingv3 shape of at most 128 keys (PERF.md
    section 6); the wgmma wide route comes before the mma.sync one for
    the same reason at the VAE's shapes."""
    out = []
    if (dtype == torch.bfloat16 and all(s % 8 == 0 for s in strides)
            and all(ptr % 16 == 0 for ptr in pointers)):
        if d in WGMMA_HEAD_DIMS and sq > 0 and skv > 0:
            if skv <= WGMMA_SHORT_MAX_KV:
                out.append("tensor_core_wgmma_short")
            out.append("tensor_core_wgmma")
        if 8 <= d <= TC_MAX_HEAD_DIM and d % 8 == 0:
            out.append("tensor_core")
        if d == TC_WIDE_HEAD_DIM:
            if sq > 0 and skv > 0:
                out.append("tensor_core_wgmma_wide")
            out.append("tensor_core_wide")
    return [*out, "cuda_core"]


def route(dtype: torch.dtype, d: int, strides, pointers, sq: int,
          skv: int) -> str:
    """The kernel a call takes: the first of `routes`. A pure function of
    q's dtype, the head dim, the strides, the data pointers and the
    query and key lengths."""
    return routes(dtype, d, strides, pointers, sq, skv)[0]


def routes_of(q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> list[str]:
    """`routes` applied to the tensors of one call."""
    return routes(q.dtype, q.shape[-1],
                  [s for t in (q, k, v) for s in t.stride()[:3]],
                  [t.data_ptr() for t in (q, k, v)], q.shape[2], k.shape[2])


def route_of(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """`route` applied to the tensors of one call."""
    return routes_of(q, k, v)[0]


def _declare(lib: ctypes.CDLL) -> None:
    for name in _ENTRY.values():
        if hasattr(lib, name):
            fn = getattr(lib, name)
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kernel: str | None = None) -> torch.Tensor:
    """Launch a CUDA kernel: q/k/v [B, H, S, D] (any strides over B, H
    and S, unit stride over D) -> contiguous [B, H, Sq, D] in q's dtype.
    The kernel is `route_of(q, k, v)`; `kernel` names one instead, for
    checking a route, and must be one the inputs allow ("cuda_core"
    takes every input). Launches on the current stream and does not
    synchronise."""
    _check(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention takes CUDA tensors, got "
                         f"{q.device}; attention() uses the plain version "
                         "for CPU tensors")
    able = routes_of(q, k, v)
    which = able[0]
    if kernel is not None:
        if kernel not in able:
            raise ValueError(f"kernel {kernel!r} cannot take these inputs "
                             f"(their route is {which!r})")
        which = kernel
    lib = _build.load(SOURCES[which], _declare)
    b, h, sq, d = q.shape
    out = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    err = getattr(lib, _ENTRY[which])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPES[q.dtype], b, h, sq, k.shape[2], d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        1.0 / math.sqrt(d), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash attention ({which}) launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    flash_attention.launches_by_route[which] += 1
    return out


def reset_launches() -> None:
    """Set the launch counts (total and per route) to 0."""
    flash_attention.launches = 0
    flash_attention.launches_by_route = dict.fromkeys(SOURCES, 0)


reset_launches()  # kernel launches since the last reset


def attention(q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """Exact attention for [B, H, S, D]: a CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    if q.device.type == "cuda":
        return flash_attention(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v)
    raise ValueError(f"unsupported device {q.device}")
