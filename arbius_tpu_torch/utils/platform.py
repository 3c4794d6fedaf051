"""Device setup: pick the device and pin the determinism settings.

A solution's bytes are keccak'd into an on-chain commitment, so one
process must produce the same bits from run to run at a fixed bucket.
On CUDA that takes:

  - ``torch.use_deterministic_algorithms(True)``;
  - ``CUBLAS_WORKSPACE_CONFIG=:4096:8``, set before the first cuBLAS call
    (cuBLAS reads it when it creates its handle); `setup_device` raises
    when it finds CUDA initialised and the variable not already pinned;
  - TF32 off for matmuls and for cuDNN convolutions (float32 convs
    default to TF32, which keeps about three decimal digits);
  - ``cudnn.benchmark = False``, so cuDNN does not pick an algorithm by
    timing it.

cuBLAS and cuDNN still choose kernels by batch size, which is why the
solve path pads every dispatch to the canonical batch (node/solver.py).
"""
from __future__ import annotations

import os
import subprocess

import torch

CUBLAS_WORKSPACE = ":4096:8"


def setup_device(device: str | torch.device = "cuda") -> torch.device:
    """Resolve `device` and apply the determinism settings.

    Raises when CUDA is asked for and not present: nothing falls back to
    the CPU unless the caller passes ``device="cpu"``. Raises, too, when
    CUDA is already initialised in the process and
    ``CUBLAS_WORKSPACE_CONFIG`` is unset or holds another value: the
    setting may then come too late."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; pass device='cpu' to run "
            "the port on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    pinned = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    if pinned != CUBLAS_WORKSPACE and torch.cuda.is_initialized():
        raise RuntimeError(
            f"CUBLAS_WORKSPACE_CONFIG is {pinned!r}, not "
            f"{CUBLAS_WORKSPACE!r}, and CUDA is already initialised in this "
            "process: cuBLAS may have read it already, so pinning it now "
            "would not take. Call setup_device before the first CUDA call, "
            "or export the variable before the process starts")
    # detlint: allow[DET106] process-boot pinning — the guard above makes
    # a call after CUDA's initialisation raise instead
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = CUBLAS_WORKSPACE
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    return dev


def card_info() -> str:
    """The card's ``name, power.limit`` as nvidia-smi prints them — the
    label every timing taken on the card carries."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]
