"""Build the port's anythingv3 registry entry.

Twin of the SD-1.5 part of arbius_tpu/node/factory.py. Weights come from
the caller (e.g. the bridge's `params_from_jax`) or from the pipeline's
seeded random init (same FLOPs, no weights download).
"""
from __future__ import annotations

import torch

from arbius_tpu_torch.models.sd15 import ByteTokenizer, SD15Config, SD15Pipeline
from arbius_tpu_torch.node.solver import RegisteredModel, SD15Runner
from arbius_tpu_torch.templates.engine import load_template

# the anythingv3 model id of MiningConfig.example.json
ANYTHINGV3_MODEL_ID = ("0x98617a8cd4a11db63100ad44bea4e5e296aecfd78b2ef06a"
                       "ee3e364c7307f212")


def tiny_byte_tokenizer(text_cfg) -> ByteTokenizer:
    """Byte tokenizer whose special ids fit a reduced-vocab text tower."""
    return ByteTokenizer(max_length=text_cfg.max_length, bos_id=257,
                         eos_id=258)


def build_anythingv3(tiny: bool = False,
                     device: str | torch.device = "cuda",
                     params: dict[str, torch.Tensor] | None = None,
                     seed: int = 0) -> RegisteredModel:
    """anythingv3 on `device`: the full SD-1.5 config (or the tiny test
    config), with `params` if given, else seeded random weights."""
    cfg = SD15Config.tiny() if tiny else SD15Config()
    pipe = SD15Pipeline(cfg, tokenizer=tiny_byte_tokenizer(cfg.text)
                        if tiny else None, device=device)
    pipe.load_params(params if params is not None
                     else pipe.init_params(seed))
    return RegisteredModel(id=ANYTHINGV3_MODEL_ID,
                           template=load_template("anythingv3"),
                           runner=SD15Runner(pipe))
