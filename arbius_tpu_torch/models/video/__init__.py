"""Text-to-video model family (the zeroscopev2xl and damo template class),
in PyTorch: the UNet3DConditionModel topology, single-device, and its
checkpoint converter (convert.py). Its dp·sp·tp layout (frames over the
sp lanes with halo_exchange and ring or Ulysses attention, which
parallel/ and ops/ hold) waits for ROADMAP queue 1 item 11."""
from arbius_tpu_torch.models.sd15.bridge import params_from_jax
from arbius_tpu_torch.models.video.convert import (
    convert_unet3d,
    unet3d_key_for,
)
from arbius_tpu_torch.models.video.pipeline import (
    Text2VideoConfig,
    Text2VideoModels,
    Text2VideoPipeline,
    vae_frames_per_call,
)
from arbius_tpu_torch.models.video.unet3d import (
    TemporalConvLayer,
    TemporalSelfAttention,
    TemporalTransformer,
    TemporalTransformerBlock,
    UNet3DCondition,
    UNet3DConfig,
)

__all__ = [
    "TemporalConvLayer", "TemporalSelfAttention", "TemporalTransformer",
    "TemporalTransformerBlock", "Text2VideoConfig", "Text2VideoModels",
    "Text2VideoPipeline", "UNet3DCondition", "UNet3DConfig",
    "convert_unet3d", "params_from_jax", "unet3d_key_for",
    "vae_frames_per_call",
]
