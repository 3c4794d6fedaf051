"""Deterministic diffusion samplers (template enum `scheduler`)."""
from arbius_tpu_torch.schedulers.samplers import (
    SAMPLER_NAMES,
    Sampler,
    get_sampler,
)

__all__ = ["SAMPLER_NAMES", "Sampler", "get_sampler"]
