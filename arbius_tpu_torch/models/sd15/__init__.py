"""SD-1.5 model family (anythingv3 template class), in PyTorch."""
from arbius_tpu_torch.models.sd15.bridge import params_from_jax
from arbius_tpu_torch.models.sd15.pipeline import SD15Config, SD15Pipeline
from arbius_tpu_torch.models.sd15.text_encoder import (
    TextEncoder,
    TextEncoderConfig,
)
from arbius_tpu_torch.models.sd15.tokenizer import (
    ByteTokenizer,
    CLIPBPETokenizer,
)
from arbius_tpu_torch.models.sd15.unet import UNet2DCondition, UNetConfig
from arbius_tpu_torch.models.sd15.vae import (
    VAEConfig,
    VAEDecoder,
    VAEEncoder,
    decode_to_images,
)

__all__ = [
    "ByteTokenizer",
    "CLIPBPETokenizer",
    "SD15Config",
    "SD15Pipeline",
    "TextEncoder",
    "TextEncoderConfig",
    "UNet2DCondition",
    "UNetConfig",
    "VAEConfig",
    "VAEDecoder",
    "VAEEncoder",
    "decode_to_images",
    "params_from_jax",
]
