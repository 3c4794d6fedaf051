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

On a dp mesh of lanes (parallel/mesh.py; `mesh=`) the pipeline holds the
networks once per device its lanes sit on (lanes sharing a card share
them) and `generate(..., lane=l)` runs the whole batch on lane l's. A
batch is never split over dp: at a smaller batch cuBLAS and cuDNN may
pick other kernels, so a lane's bytes would differ from mesh-off's. The
runner gives each lane whole canonical batches (node/solver.py), so each
lane runs the single-device program. `mesh=None` is the single-device
program the goldens pin. `MESH_LAYOUTS` is the reference's; dp·tp waits
for the port's tp rules (ROADMAP queue 1 item 11).
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
from arbius_tpu_torch.models.sd15.unet import UNet2DCondition, UNetConfig
from arbius_tpu_torch.models.sd15.vae import (
    SD_LATENT_SCALE,
    VAEConfig,
    VAEDecoder,
    decode_to_images,
)
from arbius_tpu_torch.quant.core import dequantize_first
from arbius_tpu_torch.quant.modes import mode_tag, validate_mode
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
                 device: str | torch.device = "cuda",
                 precision: str = "bf16", mesh=None):
        self.config = config or SD15Config()
        # precision mode (docs/quantization.md): int8 and fp8 hold the
        # eligible weights quantized and each bucket program begins by
        # dequantizing them; each mode is its own determinism class
        self.precision = validate_mode(precision)
        self.quantized = None
        if self.config.text.width != self.config.unet.context_dim:
            raise ValueError(
                f"text encoder width ({self.config.text.width}) must equal "
                f"unet context_dim ({self.config.unet.context_dim})")
        self.mesh = mesh
        self.dp = 1
        if mesh is not None:
            unported = [a for a in ("pp", "sp", "tp") if mesh.shape[a] > 1]
            if unported:
                raise ValueError(
                    f"mesh axes {unported}: SD-1.5 runs dp only on the "
                    "port; its tp rules wait for multi-device (ROADMAP "
                    "queue 1 item 11)")
            self.dp = mesh.shape["dp"]
            device = mesh.devices[0]
        self.device = setup_device(device)
        self.tokenizer = tokenizer or ByteTokenizer(
            max_length=self.config.text.max_length)
        self.models = SD15Models(self.config, self.device).eval()
        self.models.requires_grad_(False)
        # the pipeline that runs each device's lanes: this one for its
        # own device, one single-device pipeline for each other
        self._by_device = {self.device: self}
        for dev in (mesh.devices if mesh is not None else ()):
            if dev not in self._by_device:
                self._by_device[dev] = SD15Pipeline(
                    self.config, self.tokenizer, device=dev,
                    precision=precision)

    def lane_pipeline(self, lane: int) -> "SD15Pipeline":
        """The single-device pipeline that runs lane `lane`'s batches."""
        if not 0 <= lane < self.dp:
            raise ValueError(f"lane {lane} outside dp={self.dp}")
        if self.mesh is None:
            return self
        return self._by_device[self.mesh.devices[lane]]

    # -- params ----------------------------------------------------------
    def init_params(self, seed: int = 0) -> dict[str, torch.Tensor]:
        """Seeded random weights (stand in for converted weights), drawn
        on the pipeline's device (bridge.init_params)."""
        return init_params(self.models, seed, self.device)

    def load_params(self, state_dict: dict[str, torch.Tensor]) -> None:
        """Copy a state_dict in (every key required); linear and conv
        weights round to their compute dtype here, once. In int8 or fp8
        the eligible leaves are quantized here instead
        (bridge.load_weights). On a mesh every lane's device gets the
        weights as `place_params` places them."""
        if self.mesh is None:
            self.quantized = load_weights(self.models, state_dict,
                                          self.precision)
            return
        from arbius_tpu_torch.parallel.sharding import lane_tree

        placed = self.place_params(state_dict)
        for lane, dev in enumerate(self.mesh.devices):
            pipe = self._by_device[dev]
            if self.mesh.devices.index(dev) == lane:   # first lane there
                pipe.quantized = load_weights(pipe.models,
                                              lane_tree(placed, lane),
                                              self.precision)

    def place_params(self, state_dict: dict[str, torch.Tensor]) -> dict:
        """The state_dict placed on the mesh's lanes
        (`parallel.shard_params`, replicated: the tp rules wait for the
        dp·tp layout): each key a `Sharded`. A lane on the tensor's own
        device shares its storage."""
        if self.mesh is None:
            return state_dict
        from arbius_tpu_torch.parallel.sharding import shard_params

        return shard_params(state_dict, self.mesh)

    def bucket_tag(self, batch: int, height: int, width: int, steps: int,
                   scheduler: str) -> str:
        """The one definition of this family's bucket tag; a quantized
        mode suffixes it (".int8"/".fp8")."""
        return "sd15." + ".".join(
            str(k) for k in (batch, height, width, steps, scheduler)) \
            + mode_tag(self.precision)

    # -- the bucket program ------------------------------------------------
    @torch.no_grad()
    @dequantize_first
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
        lane: int = 0,
    ) -> np.ndarray | torch.Tensor:
        """Run a shape bucket; returns uint8 images [B, H, W, 3].

        `as_device=True` returns the device tensor without waiting for the
        card, so the caller can queue the next bucket and encode this one
        while it runs (the solver's one-deep overlap). Same bits either
        way. On a mesh the whole batch runs on lane `lane`."""
        pipe = self.lane_pipeline(lane)
        if pipe is not self:
            from arbius_tpu_torch.parallel.mesh import on_device

            with on_device(pipe.device):
                return pipe.generate(
                    prompts, negative_prompts, seeds, width=width,
                    height=height, num_inference_steps=num_inference_steps,
                    guidance_scale=guidance_scale, scheduler=scheduler,
                    as_device=as_device)
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


# mesh layouts this family ships, the reference's data: dp scales tasks
# (on the port each lane runs whole canonical batches); dp·tp waits for
# the port's tp rules (ROADMAP queue 1 item 11). The batch axis is not
# hard-partitioned.
MESH_LAYOUTS: tuple[tuple[str, ...], ...] = (("dp",), ("dp", "tp"))
MESH_BATCH_HARD = False
