"""Registry factory — MiningConfig → live ModelRegistry, for the port.

Twin of the anythingv3 and kandinsky2 parts of arbius_tpu/node/factory.py.
Weights come from the caller (e.g. the bridge's `params_from_jax`) or
from the pipeline's seeded random init (same FLOPs, no weights download).
The other families, checkpoints and the CLIP BPE tokenizer are not ported
yet: a config that names one raises `ConfigError` naming the ROADMAP.md
queue 1 item that ports it.
"""
from __future__ import annotations

import logging

import torch

from arbius_tpu_torch.models.kandinsky2 import (
    Kandinsky2Config,
    Kandinsky2Pipeline,
)
from arbius_tpu_torch.models.sd15 import ByteTokenizer, SD15Config, SD15Pipeline
from arbius_tpu_torch.node.config import ConfigError, MiningConfig, ModelConfig
from arbius_tpu_torch.node.solver import (
    Kandinsky2Runner,
    ModelRegistry,
    RegisteredModel,
    SD15Runner,
)
from arbius_tpu_torch.templates.engine import load_template

log = logging.getLogger("arbius.factory")

# the anythingv3 model id of MiningConfig.example.json
ANYTHINGV3_MODEL_ID = ("0x98617a8cd4a11db63100ad44bea4e5e296aecfd78b2ef06a"
                       "ee3e364c7307f212")

# templates of the reference that wait for a later slice, by ROADMAP.md
# queue 1 item
_QUEUED = {"textgen": 8, "zeroscopev2xl": 9, "damo": 9,
           "robust_video_matting": 10}


def tiny_byte_tokenizer(text_cfg) -> ByteTokenizer:
    """Byte tokenizer whose special ids fit a reduced-vocab text tower."""
    return ByteTokenizer(max_length=text_cfg.max_length, bos_id=257,
                         eos_id=258)


# the ported templates' families: config, pipeline, runner
_FAMILIES = {"anythingv3": (SD15Config, SD15Pipeline, SD15Runner),
             "kandinsky2": (Kandinsky2Config, Kandinsky2Pipeline,
                            Kandinsky2Runner)}


def _runner(template: str, *, tiny: bool, device, params, seed: int,
            weights_dtype: str = "float32"):
    """`template`'s runner over its pipeline (tiny or full config) on
    `device` with `params`, else seeded random weights. weights_dtype
    "bfloat16" rounds every floating parameter to bf16 once (the
    reference casts its whole tree); linear and conv weights are stored
    in the compute dtype either way."""
    config_cls, pipeline_cls, runner_cls = _FAMILIES[template]
    cfg = config_cls.tiny() if tiny else config_cls()
    pipe = pipeline_cls(cfg, tokenizer=tiny_byte_tokenizer(cfg.text)
                        if tiny else None, device=device)
    state = params if params is not None else pipe.init_params(seed)
    if weights_dtype == "bfloat16":
        state = {k: v.to(torch.bfloat16).to(v.dtype)
                 if v.is_floating_point() else v for k, v in state.items()}
    pipe.load_params(state)
    return runner_cls(pipe)


def _sd15_runner(**kw) -> SD15Runner:
    """SD-1.5 (anythingv3); see `_runner`."""
    return _runner("anythingv3", **kw)


def build_anythingv3(tiny: bool = False,
                     device: str | torch.device = "cuda",
                     params: dict[str, torch.Tensor] | None = None,
                     seed: int = 0) -> RegisteredModel:
    """anythingv3 on `device`: the full SD-1.5 config (or the tiny test
    config), with `params` if given, else seeded random weights."""
    return RegisteredModel(id=ANYTHINGV3_MODEL_ID,
                           template=load_template("anythingv3"),
                           runner=_sd15_runner(tiny=tiny, device=device,
                                               params=params, seed=seed))


def _check_ported(m: ModelConfig, mode: str) -> None:
    if m.template in _QUEUED:
        raise ConfigError(
            f"model {m.id}: template {m.template!r} is not ported yet "
            f"(ROADMAP queue 1 item {_QUEUED[m.template]})")
    if mode != "bf16":
        raise ConfigError(f"model {m.id}: precision mode {mode!r} is not "
                          "ported yet (ROADMAP queue 1 item 6)")
    if m.checkpoint:
        raise ConfigError(f"model {m.id}: checkpoints are not ported yet; "
                          "weights come from `params` or the seeded init "
                          "(ROADMAP queue 1 item 3)")
    if m.tokenizer != "byte":
        raise ConfigError(f"model {m.id}: tokenizer {m.tokenizer!r} is not "
                          "ported yet (ROADMAP queue 1 item 3)")


def build_registry(cfg: MiningConfig, device: str | torch.device = "cuda",
                   params: dict[str, torch.Tensor] | None = None
                   ) -> ModelRegistry:
    """Construct runners for every enabled model in the config, on
    `device`, with `params` (a state dict from the bridge, for a config
    whose enabled models are of one family) or the seeded random init
    (seed 0, as the reference's factory)."""
    reg = ModelRegistry()
    for m in cfg.models:
        if not m.enabled:
            continue
        if m.template not in _FAMILIES and m.template not in _QUEUED:
            log.warning("model %s: unknown template %r; skipping",
                        m.id, m.template)
            continue
        _check_ported(m, cfg.precision.mode_for(m.template))
        if params is None:
            log.warning("model %s: no params given, using random init",
                        m.id)
        runner = _runner(m.template, tiny=m.tiny, device=device,
                         params=params, seed=0,
                         weights_dtype=m.weights_dtype)
        golden = None
        if m.golden is not None:
            golden = (dict(m.golden["input"]), int(m.golden["seed"]),
                      str(m.golden["cid"]))
        reg.register(RegisteredModel(
            id=m.id, template=load_template(m.template), runner=runner,
            min_fee=m.min_fee, allowed_owners=list(m.allowed_owners),
            golden=golden))
    return reg
