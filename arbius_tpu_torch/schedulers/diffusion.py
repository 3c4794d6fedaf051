"""Shared diffusion-process tables.

The reference's image models are Stable-Diffusion-family latent diffusion
(templates/anythingv3.json declares the six scheduler choices; the cog
containers run diffusers samplers on top of the SD-1.5 noise schedule).
All schedule math is done host-side in float64 numpy — tables are static
per (scheduler, num_steps) so jit caching is clean — and cast to float32
for the device.
"""
from __future__ import annotations

import numpy as np

NUM_TRAIN_TIMESTEPS = 1000
BETA_START = 0.00085
BETA_END = 0.012


def alphas_cumprod(
    num_train_timesteps: int = NUM_TRAIN_TIMESTEPS,
    beta_start: float = BETA_START,
    beta_end: float = BETA_END,
) -> np.ndarray:
    """SD "scaled_linear" schedule: betas linear in sqrt-space."""
    betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                        num_train_timesteps, dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas)


def leading_timesteps(num_steps: int, num_train: int = NUM_TRAIN_TIMESTEPS,
                      steps_offset: int = 1) -> np.ndarray:
    """'leading' spacing with offset, descending (DDIM / PNDM family)."""
    ratio = num_train // num_steps
    ts = (np.arange(num_steps) * ratio).round()[::-1].astype(np.int64)
    return ts + steps_offset


def linspace_timesteps(num_steps: int, num_train: int = NUM_TRAIN_TIMESTEPS) -> np.ndarray:
    """'linspace' spacing, descending, float (Euler / LMS family)."""
    return np.linspace(0, num_train - 1, num_steps, dtype=np.float64)[::-1].copy()


def karras_style_sigmas(timesteps: np.ndarray,
                        acp: np.ndarray) -> np.ndarray:
    """sigma(t) = sqrt((1-acp)/acp) interpolated at (possibly fractional) t."""
    full_sigmas = np.sqrt((1.0 - acp) / acp)
    return np.interp(timesteps, np.arange(len(acp)), full_sigmas)
