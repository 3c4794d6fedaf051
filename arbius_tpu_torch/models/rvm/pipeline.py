"""RVM matting pipeline: streamed video -> matted video.

Twin of arbius_tpu/models/rvm/pipeline.py, single-device. The reference
scans the frames in one jitted program with the four ConvGRU states as
carry (`lax.scan`); here a Python loop carries them on the device, one
frame per `MattingStep` call, and enqueues without waiting. The published
auto-downsample rule picks the working size per bucket: min(512 /
max(H, W), 1) of the source snapped to the encoder's granule of 16, with
the DeepGuidedFilter refiner recovering full resolution; at or under 512
pixels the direct path runs (no refiner).

Output composition follows the template's output_type enum
(templates/data/robust_video_matting.json), on the host as in the
reference: green-screen (foreground over solid green), alpha-mask (alpha
as grayscale), foreground-mask (alpha > 0.5 as black and white). No
sampling anywhere: the bytes depend only on the build, the input video
and output_type.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from arbius_tpu_torch.models.rvm.model import MattingStep, RVMConfig
from arbius_tpu_torch.models.sd15.bridge import init_params
from arbius_tpu_torch.utils.platform import setup_device

OUTPUT_TYPES = ("green-screen", "alpha-mask", "foreground-mask")


@dataclass(frozen=True)
class RVMPipelineConfig:
    model: RVMConfig = field(default_factory=RVMConfig)
    # the published inference.py's auto_downsample_ratio:
    # min(512 / max(h, w), 1)
    auto_downsample_px: int = 512

    @classmethod
    def tiny(cls) -> "RVMPipelineConfig":
        return cls(model=RVMConfig.tiny())


class RVMPipeline:
    """The matting network on one device plus the frame stream."""

    GRANULE = 16  # the encoder pyramid's depth: H and W divide by it

    def __init__(self, config: RVMPipelineConfig | None = None,
                 device: str | torch.device = "cuda"):
        self.config = config or RVMPipelineConfig()
        self.device = setup_device(device)
        self.step = MattingStep(self.config.model, self.device).eval()
        self.step.requires_grad_(False)

    def base_hw(self, height: int, width: int) -> tuple[int, int] | None:
        """The working size per the published auto rule, snapped to
        GRANULE; None runs the direct path (no refiner)."""
        ratio = min(self.config.auto_downsample_px / max(height, width), 1.0)
        if ratio >= 1.0:
            return None
        g = self.GRANULE
        snap = lambda v: max(g, int(round(v * ratio / g)) * g)  # noqa: E731
        return snap(height), snap(width)

    def init_params(self, seed: int = 0) -> dict[str, torch.Tensor]:
        """Seeded random weights on the pipeline's device
        (bridge.init_params), with the BatchNorms' running variances at
        one, as the reference's init has them."""
        state = init_params(self.step, seed, self.device)
        for key, t in state.items():
            if key.endswith(".var"):
                t.fill_(1.0)
        return state

    def load_params(self, state_dict: dict[str, torch.Tensor]) -> None:
        """Copy a state_dict in (every key required); conv weights round
        to their compute dtype here, once."""
        self.step.load_state_dict(state_dict, strict=True)

    def to_device(self, video: np.ndarray) -> torch.Tensor:
        """uint8 [T, H, W, 3] -> float32 [T, 3, H, W] in [0, 1] on the
        device, contiguous (a channels-last view would take cuDNN's
        channels-last kernels and strided elementwise ones)."""
        src = torch.from_numpy(np.ascontiguousarray(video)).to(self.device)
        return (src.permute(0, 3, 1, 2).float() / 255.0).contiguous()

    @torch.no_grad()
    def frames(self, video: torch.Tensor):
        """float32 [T, 3, H, W] in [0, 1] on the device -> (alphas [T, 1,
        H, W], foregrounds [T, 3, H, W]), float32 on the device; the
        ConvGRU states carried frame to frame."""
        t, _, h, w = video.shape
        base = self.base_hw(h, w)
        rec = self.step.init_rec(1, *(base or (h, w)), device=self.device)
        alphas, fgrs = [], []
        for i in range(t):
            fgr, pha, rec = self.step(video[i:i + 1], rec, base)
            alphas.append(pha)
            fgrs.append(fgr)
        return torch.cat(alphas), torch.cat(fgrs)

    def matte(self, video: np.ndarray, *,
              output_type: str = "green-screen") -> np.ndarray:
        """uint8 [T, H, W, 3] video -> uint8 [T, H, W, 3] matted video."""
        if output_type not in OUTPUT_TYPES:
            raise ValueError(f"output_type must be one of {OUTPUT_TYPES}")
        if video.dtype != np.uint8 or video.ndim != 4 or video.shape[3] != 3:
            raise ValueError(f"expected uint8 [T,H,W,3], got "
                             f"{video.dtype} {video.shape}")
        _, h, w, _ = video.shape
        if h % self.GRANULE or w % self.GRANULE:
            raise ValueError(f"H, W must be multiples of {self.GRANULE}")
        alphas, fgrs = self.frames(self.to_device(video))
        alphas = alphas.permute(0, 2, 3, 1).cpu().numpy()
        fgrs = fgrs.permute(0, 2, 3, 1).cpu().numpy()
        if output_type == "alpha-mask":
            out = np.repeat(alphas, 3, axis=-1)
        elif output_type == "foreground-mask":
            out = np.repeat((alphas > 0.5).astype(np.float32), 3, axis=-1)
        else:  # green-screen composite
            green = np.zeros_like(fgrs)
            green[..., 1] = 1.0
            out = fgrs * alphas + green * (1.0 - alphas)
        return np.clip(np.rint(out * 255.0), 0, 255).astype(np.uint8)
