"""SD-1.5 txt2img pipeline — the anythingv3 execution path, in-process.

Twin of arbius_tpu/models/sd15/pipeline.py (`_build_bucket`'s `run` and
`generate`). Determinism root: the per-task seed (taskid2seed) feeds a
threefry key exactly as `jax.random` does (arbius_tpu_torch/random.py);
the initial latents and every ancestral noise draw derive from it via
`fold_in`, so a task id always produces the same bytes on the same build.

Batching: `generate` takes a batch of tasks sharing one shape bucket
(width, height, steps, scheduler). Per-sample guidance scales and seeds
vary freely within a batch. cuBLAS and cuDNN choose kernels by batch
size, so a task's bytes would depend on the batch it shared; the solver
(node/solver.py) therefore pads every dispatch to the canonical batch.

The reference's `lax.scan` over steps is a Python loop here: each step
enqueues its kernels on the current CUDA stream without waiting, so
`generate(..., as_device=True)` returns the device tensor before the
card has finished it.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
from torch import nn

from arbius_tpu_torch import random as jrandom
from arbius_tpu_torch.models.sd15.bridge import init_params
from arbius_tpu_torch.models.sd15.text_encoder import (
    TextEncoder,
    TextEncoderConfig,
)
from arbius_tpu_torch.models.sd15.tokenizer import ByteTokenizer
from arbius_tpu_torch.models.sd15.unet import UNet2DCondition, UNetConfig
from arbius_tpu_torch.models.sd15.vae import (
    SD_LATENT_SCALE,
    VAEConfig,
    VAEDecoder,
    decode_to_images,
)
from arbius_tpu_torch.schedulers import get_sampler
from arbius_tpu_torch.utils.platform import setup_device


@dataclass(frozen=True)
class SD15Config:
    unet: UNetConfig = field(default_factory=UNetConfig)
    vae: VAEConfig = field(default_factory=VAEConfig)
    text: TextEncoderConfig = field(default_factory=TextEncoderConfig)

    @classmethod
    def tiny(cls) -> "SD15Config":
        return cls(UNetConfig.tiny(), VAEConfig.tiny(), TextEncoderConfig.tiny())


class SD15Models(nn.Module):
    """The three networks under the reference tree's top-level names, so
    one state_dict covers them all (keys 'unet.*', 'vae.*', 'text.*')."""

    def __init__(self, config: SD15Config, device=None):
        super().__init__()
        self.unet = UNet2DCondition(config.unet, device)
        self.vae = VAEDecoder(config.vae, device)
        self.text = TextEncoder(config.text, device)


class SD15Pipeline:
    """The SD-1.5 networks on one device plus the bucket program."""

    VAE_FACTOR = 8

    def __init__(self, config: SD15Config | None = None, tokenizer=None,
                 device: str | torch.device = "cuda"):
        self.config = config or SD15Config()
        if self.config.text.width != self.config.unet.context_dim:
            raise ValueError(
                f"text encoder width ({self.config.text.width}) must equal "
                f"unet context_dim ({self.config.unet.context_dim})")
        self.device = setup_device(device)
        self.tokenizer = tokenizer or ByteTokenizer(
            max_length=self.config.text.max_length)
        self.models = SD15Models(self.config, self.device).eval()
        self.models.requires_grad_(False)

    # -- params ----------------------------------------------------------
    def init_params(self, seed: int = 0) -> dict[str, torch.Tensor]:
        """Seeded random weights (stand in for converted weights), drawn
        on the pipeline's device (bridge.init_params)."""
        return init_params(self.models, seed, self.device)

    def load_params(self, state_dict: dict[str, torch.Tensor]) -> None:
        """Copy a state_dict in (every key required); linear and conv
        weights round to their compute dtype here, once."""
        self.models.load_state_dict(state_dict, strict=True)

    def bucket_tag(self, batch: int, height: int, width: int, steps: int,
                   scheduler: str) -> str:
        """The one definition of this family's bucket tag."""
        return "sd15." + ".".join(
            str(k) for k in (batch, height, width, steps, scheduler))

    # -- the bucket program ------------------------------------------------
    @torch.no_grad()
    def _run(self, ids_c, ids_u, guidance, seeds_lo, seeds_hi, height,
             width, steps, scheduler) -> torch.Tensor:
        m = self.models
        sampler = get_sampler(scheduler, steps)
        batch = ids_c.shape[0]
        lat_shape = (height // self.VAE_FACTOR, width // self.VAE_FACTOR,
                     self.config.unet.in_channels)
        context = torch.cat([m.text(ids_u), m.text(ids_c)], dim=0)

        # full 53-bit taskid2seed space: low word keys, high word folded in
        keys = jrandom.fold_in(jrandom.prng_key(seeds_lo, self.device),
                               seeds_hi)
        x = jrandom.normal(keys, lat_shape) * sampler.init_noise_sigma
        g = guidance[:, None, None, None]
        state = sampler.init_carry(x)
        for i in range(sampler.num_model_calls):
            xin = torch.cat([x, x], dim=0) * float(sampler.input_scale[i])
            t = torch.full((2 * batch,), float(sampler.timesteps[i]),
                           device=self.device)
            eps = m.unet(xin, t, context).float()
            eps_u, eps_c = eps.chunk(2, dim=0)
            eps = eps_u + g * (eps_c - eps_u)
            noise = (jrandom.normal(jrandom.fold_in(keys, i), lat_shape)
                     if sampler.needs_noise else None)
            x, state = sampler.step(i, x, eps, state, noise)
        return decode_to_images(m.vae(x / SD_LATENT_SCALE))

    def generate(
        self,
        prompts: list[str],
        negative_prompts: list[str],
        seeds: list[int],
        *,
        width: int = 512,
        height: int = 512,
        num_inference_steps: int = 20,
        guidance_scale: float | list[float] = 7.5,
        scheduler: str = "DDIM",
        as_device: bool = False,
    ) -> np.ndarray | torch.Tensor:
        """Run a shape bucket; returns uint8 images [B, H, W, 3].

        `as_device=True` returns the device tensor without waiting for the
        card, so the caller can queue the next bucket and encode this one
        while it runs (the solver's one-deep overlap). Same bits either
        way."""
        batch = len(prompts)
        if len(negative_prompts) != batch or len(seeds) != batch:
            raise ValueError("prompts/negative_prompts/seeds must align")
        # latents must survive the UNet's downsample pyramid and re-align
        # with every skip connection on the way up
        levels = len(self.config.unet.block_channels)
        granule = self.VAE_FACTOR * (2 ** (levels - 1))
        if height % granule or width % granule:
            raise ValueError(f"height/width must be multiples of {granule}")
        g = list(guidance_scale) if isinstance(guidance_scale, (list, tuple)) \
            else [guidance_scale] * batch
        if len(g) != batch:
            raise ValueError("guidance_scale list must align with prompts")
        ids_c = self.tokenizer.encode_batch(prompts)
        ids_u = self.tokenizer.encode_batch(negative_prompts)
        vocab = self.config.text.vocab_size
        if int(ids_c.max()) >= vocab or int(ids_u.max()) >= vocab:
            raise ValueError(
                f"tokenizer produced id >= vocab_size ({vocab}); "
                "tokenizer and text-encoder config are mismatched")
        seeds_arr = np.asarray(seeds, dtype=np.uint64)

        def dev(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype).to(
                self.device, non_blocking=True)

        images = self._run(
            dev(ids_c, torch.int64), dev(ids_u, torch.int64),
            dev(np.asarray(g, np.float32), torch.float32),
            dev((seeds_arr & np.uint64(0xFFFFFFFF)).astype(np.int64),
                torch.int64),
            dev((seeds_arr >> np.uint64(32)).astype(np.int64), torch.int64),
            height, width, num_inference_steps, scheduler)
        if as_device:
            return images
        return images.cpu().numpy()
