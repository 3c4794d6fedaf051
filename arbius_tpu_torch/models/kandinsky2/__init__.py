"""Kandinsky-2 model family (the kandinsky2 template class), in PyTorch:
diffusion prior + decoder UNet + MOVQ. Checkpoint conversion waits for a
checkpoint in the repository (ROADMAP queue 1 item 7)."""
from arbius_tpu_torch.models.kandinsky2.decoder import (
    DecoderConfig,
    DecoderUNet,
)
from arbius_tpu_torch.models.kandinsky2.movq import MOVQConfig, MOVQDecoder
from arbius_tpu_torch.models.kandinsky2.pipeline import (
    Kandinsky2Config,
    Kandinsky2Pipeline,
)
from arbius_tpu_torch.models.kandinsky2.prior import (
    PriorConfig,
    PriorTransformer,
    prior_sample,
)
from arbius_tpu_torch.models.sd15.bridge import params_from_jax

__all__ = [
    "DecoderConfig", "DecoderUNet", "Kandinsky2Config", "Kandinsky2Pipeline",
    "MOVQConfig", "MOVQDecoder", "PriorConfig", "PriorTransformer",
    "params_from_jax", "prior_sample",
]
