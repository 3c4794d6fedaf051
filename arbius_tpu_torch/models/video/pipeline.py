"""Text-to-video pipeline: the zeroscopev2xl and damo templates' solve
path, in-process.

Twin of arbius_tpu/models/video/pipeline.py (`_build_bucket`'s `run` and
`generate`), single-device: text encode -> classifier-free-guided UNet3D
denoise loop -> per-frame VAE decode -> uint8 frames [B, T, H, W, 3]. The
node's video runner (node/solver.py `Text2VideoRunner`) encodes them to
H.264 MP4 (codecs/mp4.py) and CIDs the bytes.

Noise is keyed as in the reference: the sample key is
``fold_in(PRNGKey(seed_lo), seed_hi)``; a frame's noise at a step is
``normal(fold_in(fold_in(key, step_tag), frame))`` of shape
(h, w, C), the initial latents taking the tag 1 << 30, outside the
steps' range (arbius_tpu_torch/random.py reproduces jax.random). The
classifier-free batch is [unconditional; conditional], one doubled
UNet call per step. The reference's `lax.scan` is a Python loop that
enqueues without waiting, so `generate(..., as_device=True)` returns
before the card has finished.

The VAE decodes the B*T frames in groups of at most
`vae_frames_per_call` frames: every VAE operation is per frame (the
convolutions run one sample per call, the GroupNorms per sample, the mid
attention per batch and head), so a frame's bits do not depend on the
grouping, and the groups bound the decoder's transient memory (at
1024x576 all 96 frames at once would want ~30 GB for one float32
GroupNorm copy). Same determinism contract as the image families: the
solver pads every dispatch to the canonical batch.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
from torch import nn

from arbius_tpu_torch import random as jrandom
from arbius_tpu_torch.models.sd15.bridge import init_params, load_weights
from arbius_tpu_torch.models.sd15.text_encoder import (
    TextEncoder,
    TextEncoderConfig,
)
from arbius_tpu_torch.models.sd15.tokenizer import ByteTokenizer
from arbius_tpu_torch.models.sd15.vae import (
    SD_LATENT_SCALE,
    VAEConfig,
    VAEDecoder,
    decode_to_images,
)
from arbius_tpu_torch.models.video.unet3d import UNet3DCondition, UNet3DConfig
from arbius_tpu_torch.quant.core import dequantize_first
from arbius_tpu_torch.quant.modes import mode_tag, validate_mode
from arbius_tpu_torch.schedulers import get_sampler
from arbius_tpu_torch.utils.platform import setup_device

# the noise tag of the initial latents, outside [0, steps)
INIT_NOISE_TAG = 1 << 30
# pixels one VAE call decodes at most: damo's default chunk (4 tasks x 16
# frames at 256x256) in one call
VAE_PIXELS_PER_CALL = 64 * 256 * 256


@dataclass(frozen=True)
class Text2VideoConfig:
    unet: UNet3DConfig = field(default_factory=UNet3DConfig)
    vae: VAEConfig = field(default_factory=VAEConfig)
    # the published ModelScope/zeroscope text tower: OpenCLIP ViT-H class,
    # 1024 wide, 16 heads, 24 layers, exact gelu
    text: TextEncoderConfig = field(default_factory=lambda: TextEncoderConfig(
        width=1024, heads=16, layers=24, act="gelu"))

    @classmethod
    def tiny(cls) -> "Text2VideoConfig":
        return cls(UNet3DConfig.tiny(), VAEConfig.tiny(),
                   TextEncoderConfig.tiny())


def vae_frames_per_call(height: int, width: int) -> int:
    """Frames the VAE decodes in one call at `height` x `width`."""
    return max(1, VAE_PIXELS_PER_CALL // (height * width))


class Text2VideoModels(nn.Module):
    """The three networks under the reference tree's top-level names
    ('unet.*', 'vae.*', 'text.*'), so one state_dict covers them all."""

    def __init__(self, config: Text2VideoConfig, device=None):
        super().__init__()
        self.unet = UNet3DCondition(config.unet, device)
        self.vae = VAEDecoder(config.vae, device)
        self.text = TextEncoder(config.text, device)


class Text2VideoPipeline:
    """The text-to-video networks on one device plus the bucket program."""

    VAE_FACTOR = 8

    def __init__(self, config: Text2VideoConfig | None = None, tokenizer=None,
                 device: str | torch.device = "cuda",
                 precision: str = "bf16"):
        self.config = config or Text2VideoConfig()
        # precision mode (docs/quantization.md): int8 and fp8 hold the
        # eligible weights quantized and each bucket program begins by
        # dequantizing them; each mode is its own determinism class
        self.precision = validate_mode(precision)
        self.quantized = None
        if self.config.text.width != self.config.unet.context_dim:
            raise ValueError(
                f"text width ({self.config.text.width}) must equal unet "
                f"context_dim ({self.config.unet.context_dim})")
        self.device = setup_device(device)
        self.tokenizer = tokenizer or ByteTokenizer(
            max_length=self.config.text.max_length)
        self.models = Text2VideoModels(self.config, self.device).eval()
        self.models.requires_grad_(False)

    # -- params ----------------------------------------------------------
    def init_params(self, seed: int = 0) -> dict[str, torch.Tensor]:
        """Seeded random weights, drawn on the pipeline's device
        (bridge.init_params), with the reference's zero inits: each
        TemporalConvLayer's last conv and each TemporalTransformer's
        proj_out."""
        state = init_params(self.models, seed, self.device)
        for key in self.models.unet.zero_init_keys():
            state[f"unet.{key}"].zero_()
        return state

    def load_params(self, state_dict: dict[str, torch.Tensor]) -> None:
        """Copy a state_dict in (every key required); linear and conv
        weights round to their compute dtype here, once. In int8 or fp8
        the eligible leaves are quantized here instead
        (bridge.load_weights)."""
        self.quantized = load_weights(self.models, state_dict,
                                      self.precision)

    def bucket_tag(self, batch: int, frames: int, height: int, width: int,
                   steps: int, scheduler: str) -> str:
        """The one definition of this family's bucket tag; a quantized
        mode suffixes it (".int8"/".fp8")."""
        return "video." + ".".join(
            str(k) for k in (batch, frames, height, width, steps,
                             scheduler)) + mode_tag(self.precision)

    # -- the bucket program ------------------------------------------------
    def noise(self, keys: torch.Tensor, tag: int, frames: int,
              lat_shape: tuple[int, int, int]) -> torch.Tensor:
        """[B, T, h, w, C] float32: frame f of sample b draws from
        fold_in(fold_in(keys[b], tag), f)."""
        kk = jrandom.fold_in(keys, tag)
        idx = torch.arange(frames, dtype=torch.int64, device=keys.device)
        return jrandom.normal(jrandom.fold_in(kk[:, None, :], idx[None, :]),
                              lat_shape)

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Latents [N, h, w, C] -> uint8 frames [N, H, W, 3], in VAE calls
        of at most `vae_frames_per_call` frames each."""
        f = self.VAE_FACTOR
        per = vae_frames_per_call(latents.shape[1] * f, latents.shape[2] * f)
        vae = self.models.vae
        return torch.cat([decode_to_images(vae(latents[i:i + per]
                                               / SD_LATENT_SCALE))
                          for i in range(0, latents.shape[0], per)])

    @torch.no_grad()
    @dequantize_first
    def _run(self, ids_c, ids_u, guidance, seeds_lo, seeds_hi, frames,
             height, width, steps, scheduler) -> torch.Tensor:
        m = self.models
        sampler = get_sampler(scheduler, steps)
        batch = ids_c.shape[0]
        lat_shape = (height // self.VAE_FACTOR, width // self.VAE_FACTOR,
                     self.config.unet.in_channels)
        context = torch.cat([m.text(ids_u), m.text(ids_c)], dim=0)

        keys = jrandom.fold_in(jrandom.prng_key(seeds_lo, self.device),
                               seeds_hi)
        x = self.noise(keys, INIT_NOISE_TAG, frames, lat_shape) \
            * sampler.init_noise_sigma
        g = guidance[:, None, None, None, None]
        state = sampler.init_carry(x)
        for i in range(sampler.num_model_calls):
            xin = torch.cat([x, x], dim=0) * float(sampler.input_scale[i])
            t = torch.full((2 * batch,), float(sampler.timesteps[i]),
                           device=self.device)
            eps = m.unet(xin, t, context).float()
            eps_u, eps_c = eps.chunk(2, dim=0)
            eps = eps_u + g * (eps_c - eps_u)
            noise = (self.noise(keys, i, frames, lat_shape)
                     if sampler.needs_noise else None)
            x, state = sampler.step(i, x, eps, state, noise)
        images = self.decode(x.reshape(batch * frames, *lat_shape))
        return images.view(batch, frames, *images.shape[1:])

    def generate(
        self,
        prompts: list[str],
        negative_prompts: list[str] | None,
        seeds: list[int],
        *,
        num_frames: int = 16,
        width: int = 256,
        height: int = 256,
        fps: int = 8,
        num_inference_steps: int = 20,
        guidance_scale: float | list[float] = 9.0,
        scheduler: str = "DDIM",
        as_device: bool = False,
    ) -> np.ndarray | torch.Tensor:
        """Run a shape bucket; returns uint8 frames [B, T, H, W, 3].

        `fps` is the MP4 container's (the runner's muxer takes it), not
        part of the program. With `as_device=True` the device tensor
        comes back without waiting for the card; same bits either way."""
        del fps
        batch = len(prompts)
        negs = negative_prompts or [""] * batch
        if len(negs) != batch or len(seeds) != batch:
            raise ValueError("prompts/negative_prompts/seeds must align")
        # latents must survive the UNet's downsample pyramid
        levels = len(self.config.unet.block_channels)
        granule = self.VAE_FACTOR * (2 ** (levels - 1))
        if height % granule or width % granule:
            raise ValueError(f"height/width must be multiples of {granule}")
        g = list(guidance_scale) if isinstance(guidance_scale, (list, tuple)) \
            else [guidance_scale] * batch
        if len(g) != batch:
            raise ValueError("guidance_scale list must align with prompts")
        ids_c = self.tokenizer.encode_batch(prompts)
        ids_u = self.tokenizer.encode_batch(negs)
        vocab = self.config.text.vocab_size
        if int(ids_c.max()) >= vocab or int(ids_u.max()) >= vocab:
            raise ValueError(
                f"tokenizer produced id >= vocab_size ({vocab}); "
                "tokenizer and text-encoder config are mismatched")
        seeds_arr = np.asarray(seeds, dtype=np.uint64)

        def dev(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype).to(
                self.device, non_blocking=True)

        frames = self._run(
            dev(ids_c, torch.int64), dev(ids_u, torch.int64),
            dev(np.asarray(g, np.float32), torch.float32),
            dev((seeds_arr & np.uint64(0xFFFFFFFF)).astype(np.int64),
                torch.int64),
            dev((seeds_arr >> np.uint64(32)).astype(np.int64), torch.int64),
            num_frames, height, width, num_inference_steps, scheduler)
        if as_device:
            return frames
        return frames.cpu().numpy()


# mesh layouts this family ships, the reference's data: samples over dp,
# frames over sp (ring or Ulysses temporal attention, halo-exchanged
# frame-axis convolutions), kernels over tp; its batch axis is
# hard-partitioned over dp. On the port the factory refuses it until it
# is ported (ROADMAP queue 1 item 11).
MESH_LAYOUTS: tuple[tuple[str, ...], ...] = (("dp", "sp", "tp"),)
MESH_BATCH_HARD = True
