"""Deterministic probe clip: the pinned input for file-input goldens.

`robust_video_matting`'s template input is a video FILE
(`templates/robust_video_matting.json: input_video`), so its boot
self-test golden must pin input bytes, not just a prompt. This clip is
generated with integer-only numpy — identical bytes on every platform
and numpy version — then MJPEG-MP4 encoded by the in-repo deterministic
codec, so (shape → clip bytes → CID) is reproducible anywhere and the
golden stays portable (`cli.py record-golden --probe-video TxHxW`).

Content: a quantized two-axis gradient background with a bright square
translating one step per frame — enough structure for the matting
network to produce non-trivial output on every frame.
"""
from __future__ import annotations

import numpy as np


def probe_clip(frames: int = 4, height: int = 64, width: int = 64) -> np.ndarray:
    """uint8 [T, H, W, 3] deterministic test pattern (integer ops only)."""
    y = np.arange(height, dtype=np.uint32)
    x = np.arange(width, dtype=np.uint32)
    base = np.zeros((height, width, 3), np.uint8)
    base[:, :, 0] = ((y[:, None] * 255) // max(height - 1, 1)).astype(np.uint8)
    base[:, :, 1] = ((x[None, :] * 255) // max(width - 1, 1)).astype(np.uint8)
    base[:, :, 2] = 32

    clip = np.empty((frames, height, width, 3), np.uint8)
    side = max(2, min(height, width) // 4)
    for t in range(frames):
        frame = base.copy()
        top = (t * max(1, height // max(frames, 1))) % max(height - side, 1)
        left = (t * max(1, width // max(frames, 1))) % max(width - side, 1)
        frame[top:top + side, left:left + side] = (255, 255, 224)
        clip[t] = frame
    return clip
