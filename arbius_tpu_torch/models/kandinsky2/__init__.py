"""Kandinsky-2 model family (the kandinsky2 template class), in PyTorch:
diffusion prior + decoder UNet + MOVQ, and the checkpoint converters
(convert.py)."""
from arbius_tpu_torch.models.kandinsky2.convert import (
    convert_kandinsky2_decoder,
    convert_kandinsky2_movq,
    convert_kandinsky2_prior,
    convert_kandinsky2_text_projection,
)
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
    "convert_kandinsky2_decoder", "convert_kandinsky2_movq",
    "convert_kandinsky2_prior", "convert_kandinsky2_text_projection",
    "params_from_jax", "prior_sample",
]
