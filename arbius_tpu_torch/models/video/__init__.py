"""Text-to-video model family (the zeroscopev2xl and damo template class),
in PyTorch: the UNet3DConditionModel topology, single-device. Checkpoint
conversion (the reference's video/convert.py) waits for a checkpoint in
the repository, and frame-axis sequence parallelism for ROADMAP queue 1
item 11."""
from arbius_tpu_torch.models.sd15.bridge import params_from_jax
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
    "params_from_jax", "vae_frames_per_call",
]
