"""Kandinsky-2 txt2img pipeline: text -> prior -> decoder -> MOVQ.

Twin of arbius_tpu/models/kandinsky2/pipeline.py (`_build_bucket`'s `run`
and `generate`), the kandinsky2 template's solve path:

  text tower (+ projection)  -> hidden states, EOT-pooled projected embed
  prior                      -> CLIP-image embedding (de-normalised by
                                the [mean; std] rows `prior_stats`)
  decoder UNet               -> epsilon (the learned-variance half of the
                                8-channel output is dropped)
  MOVQ                       -> pixels -> uint8

Same determinism contract as SD-1.5 (models/sd15/pipeline.py): the
task's seed keys every draw through threefry `fold_in`, and the solver
pads every dispatch to the canonical batch. The prior and the decoder run
classifier-free guidance as one doubled batch, the unconditional half
first, so both chunks of a run see the same shapes. The reference's
`lax.scan`s are Python loops that enqueue without waiting, so
`generate(..., as_device=True)` returns before the card has finished.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from arbius_tpu_torch import random as jrandom
from arbius_tpu_torch.models.kandinsky2.decoder import (
    DecoderConfig,
    DecoderUNet,
)
from arbius_tpu_torch.models.kandinsky2.movq import MOVQConfig, MOVQDecoder
from arbius_tpu_torch.models.kandinsky2.prior import (
    PriorConfig,
    PriorTransformer,
    prior_sample,
    prior_stats_init,
)
from arbius_tpu_torch.models.sd15.bridge import init_params, load_weights
from arbius_tpu_torch.models.sd15.text_encoder import (
    TextEncoder,
    TextEncoderConfig,
)
from arbius_tpu_torch.models.sd15.tokenizer import ByteTokenizer
from arbius_tpu_torch.models.sd15.vae import decode_to_images
from arbius_tpu_torch.quant.core import dequantize_first
from arbius_tpu_torch.quant.modes import mode_tag, validate_mode
from arbius_tpu_torch.schedulers import get_sampler
from arbius_tpu_torch.utils.platform import setup_device

@dataclass(frozen=True)
class Kandinsky2Config:
    prior: PriorConfig = PriorConfig()
    decoder: DecoderConfig = DecoderConfig()
    movq: MOVQConfig = MOVQConfig()
    # the open_clip bigG text tower: 1280 wide, exact gelu
    text: TextEncoderConfig = TextEncoderConfig(width=1280, layers=32,
                                                heads=20, act="gelu")
    prior_steps: int = 25

    @classmethod
    def tiny(cls) -> "Kandinsky2Config":
        dec = DecoderConfig.tiny()
        # out_channels 8 keeps the learned-variance slice at toy size
        dec = dataclasses.replace(
            dec, unet=dataclasses.replace(dec.unet, out_channels=8))
        return cls(prior=PriorConfig.tiny(), decoder=dec,
                   movq=MOVQConfig.tiny(), text=TextEncoderConfig.tiny(),
                   prior_steps=2)


class TextProjection(nn.Module):
    """CLIP text_projection: EOT-pooled hidden state -> embedding space,
    float32, no bias."""

    def __init__(self, width: int, dim: int, device=None):
        super().__init__()
        self.proj = nn.Linear(width, dim, bias=False, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x)


class Kandinsky2Models(nn.Module):
    """The networks under the reference tree's top-level names ('text.*',
    'text_proj.*', 'prior.*', 'prior_stats', 'decoder.*', 'movq.*'), so
    one state_dict covers them all."""

    def __init__(self, config: Kandinsky2Config, device=None):
        super().__init__()
        clip = config.prior.clip_dim
        self.text = TextEncoder(config.text, device)
        self.text_proj = TextProjection(config.text.width, clip, device)
        self.prior = PriorTransformer(config.prior, config.text.width,
                                      device)
        # [clip_mean; clip_std], float32
        self.prior_stats = nn.Parameter(torch.zeros(2, clip, device=device))
        self.decoder = DecoderUNet(config.decoder, device)
        self.movq = MOVQDecoder(config.movq, device)


class Kandinsky2Pipeline:
    """The Kandinsky-2 networks on one device plus the bucket program."""

    MOVQ_FACTOR = 8

    def __init__(self, config: Kandinsky2Config | None = None, tokenizer=None,
                 device: str | torch.device = "cuda",
                 precision: str = "bf16"):
        self.config = config or Kandinsky2Config()
        # precision mode (docs/quantization.md): int8 and fp8 hold the
        # eligible weights quantized and each bucket program begins by
        # dequantizing them; each mode is its own determinism class
        self.precision = validate_mode(precision)
        self.quantized = None
        if self.config.text.max_length < self.config.prior.text_len:
            raise ValueError(
                f"text max_length ({self.config.text.max_length}) must be "
                f">= prior text_len ({self.config.prior.text_len})")
        self.device = setup_device(device)
        self.tokenizer = tokenizer or ByteTokenizer(
            max_length=self.config.text.max_length)
        self.models = Kandinsky2Models(self.config, self.device).eval()
        self.models.requires_grad_(False)

    # -- params ----------------------------------------------------------
    def init_params(self, seed: int = 0) -> dict[str, torch.Tensor]:
        """Seeded random weights, drawn on the pipeline's device
        (bridge.init_params), and `prior_stats_init`'s mean 0, std 1."""
        state = init_params(self.models, seed, self.device)
        state["prior_stats"] = prior_stats_init(self.config.prior.clip_dim,
                                                self.device)
        return state

    def load_params(self, state_dict: dict[str, torch.Tensor]) -> None:
        """Copy a state_dict in (every key required); linear and conv
        weights round to their compute dtype here, once. In int8 or fp8
        the eligible leaves are quantized here instead
        (bridge.load_weights)."""
        self.quantized = load_weights(self.models, state_dict,
                                      self.precision)

    def bucket_tag(self, batch: int, height: int, width: int, steps: int,
                   scheduler: str) -> str:
        """The one definition of this family's bucket tag; a quantized
        mode suffixes it (".int8"/".fp8")."""
        return "kandinsky2." + ".".join(
            str(k) for k in (batch, height, width, steps, scheduler)) \
            + mode_tag(self.precision)

    # -- the bucket program ------------------------------------------------
    @torch.no_grad()
    @dequantize_first
    def _run(self, ids, guidance, seeds_lo, seeds_hi, height, width, steps,
             scheduler) -> torch.Tensor:
        m, cfg = self.models, self.config
        sampler = get_sampler(scheduler, steps)
        batch = ids.shape[0]
        in_ch = cfg.decoder.unet.in_channels
        lat_shape = (height // self.MOVQ_FACTOR, width // self.MOVQ_FACTOR,
                     in_ch)
        text_len = cfg.prior.text_len

        states = m.text(ids)
        # EOT pooling: the hidden state at the first EOS, projected into
        # the embedding space (CLIP *WithProjection heads)
        first_eos = (ids == self.tokenizer.eos_id).int().argmax(dim=1)
        pooled = m.text_proj(states[torch.arange(batch, device=ids.device),
                                    first_eos])
        # attention mask: real tokens up to and including the EOT
        positions = torch.arange(ids.shape[1], device=ids.device)[None, :]
        mask = (positions <= first_eos[:, None]).float()

        keys = jrandom.fold_in(jrandom.prng_key(seeds_lo, self.device),
                               seeds_hi)
        embed = prior_sample(m.prior, states[:, :text_len], pooled, keys,
                             guidance, steps=cfg.prior_steps,
                             text_mask=mask[:, :text_len],
                             clip_stats=m.prior_stats)

        x = jrandom.normal(keys, lat_shape) * sampler.init_noise_sigma
        emb2 = torch.cat([torch.zeros_like(embed), embed])
        g = guidance[:, None, None, None]
        state = sampler.init_carry(x)
        for i in range(sampler.num_model_calls):
            xin = torch.cat([x, x]) * float(sampler.input_scale[i])
            t = torch.full((2 * batch,), float(sampler.timesteps[i]),
                           device=self.device)
            # the learned-variance half is dropped: the samplers are
            # deterministic
            eps = m.decoder(xin, t, emb2).float()[..., :in_ch]
            eps_u, eps_c = eps.chunk(2)
            eps = eps_u + g * (eps_c - eps_u)
            noise = (jrandom.normal(jrandom.fold_in(keys, i), lat_shape)
                     if sampler.needs_noise else None)
            x, state = sampler.step(i, x, eps, state, noise)
        return decode_to_images(m.movq(x))

    def generate(
        self,
        prompts: list[str],
        negative_prompts: list[str] | None,
        seeds: list[int],
        *,
        width: int = 768,
        height: int = 768,
        num_inference_steps: int = 50,
        guidance_scale: float | list[float] = 4.0,
        scheduler: str = "DDIM",
        as_device: bool = False,
    ) -> np.ndarray | torch.Tensor:
        """Run a shape bucket; returns uint8 images [B, H, W, 3].

        `negative_prompts` is accepted and unused: the prior's and the
        decoder's unconditional branches zero their context. With
        `as_device=True` the device tensor comes back without waiting for
        the card; same bits either way."""
        batch = len(prompts)
        if len(seeds) != batch:
            raise ValueError("prompts/seeds must align")
        # latents must survive the decoder's downsample pyramid
        levels = len(self.config.decoder.unet.block_channels)
        granule = self.MOVQ_FACTOR * (2 ** (levels - 1))
        if height % granule or width % granule:
            raise ValueError(f"height/width must be multiples of {granule}")
        g = list(guidance_scale) if isinstance(guidance_scale, (list, tuple)) \
            else [guidance_scale] * batch
        if len(g) != batch:
            raise ValueError("guidance_scale list must align with prompts")
        ids = self.tokenizer.encode_batch(prompts)
        vocab = self.config.text.vocab_size
        if int(ids.max()) >= vocab:
            raise ValueError(
                f"tokenizer produced id >= vocab_size ({vocab}); "
                "tokenizer and text-encoder config are mismatched")
        seeds_arr = np.asarray(seeds, dtype=np.uint64)

        def dev(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype).to(
                self.device, non_blocking=True)

        images = self._run(
            dev(ids, torch.int64), dev(np.asarray(g, np.float32),
                                       torch.float32),
            dev((seeds_arr & np.uint64(0xFFFFFFFF)).astype(np.int64),
                torch.int64),
            dev((seeds_arr >> np.uint64(32)).astype(np.int64), torch.int64),
            height, width, num_inference_steps, scheduler)
        if as_device:
            return images
        return images.cpu().numpy()


# mesh layouts this family ships, the reference's data (dp and dp·tp);
# on the port the factory refuses both until they are ported (ROADMAP
# queue 1 item 11)
MESH_LAYOUTS: tuple[tuple[str, ...], ...] = (("dp",), ("dp", "tp"))
