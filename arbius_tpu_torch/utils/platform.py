"""Device setup: pick the device and pin the determinism settings.

A solution's bytes are keccak'd into an on-chain commitment, so one
process must produce the same bits from run to run at a fixed bucket.
On CUDA that takes:

  - ``torch.use_deterministic_algorithms(True)``;
  - ``CUBLAS_WORKSPACE_CONFIG=:4096:8``, set before the first cuBLAS call
    (cuBLAS reads it when it creates its handle);
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


def setup_device(device: str | torch.device = "cuda") -> torch.device:
    """Resolve `device` and apply the determinism settings.

    Raises when CUDA is asked for and not present: nothing falls back to
    the CPU unless the caller passes ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; pass device='cpu' to run "
            "the port on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
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
