"""Registry factory — MiningConfig → live ModelRegistry, for the port.

Twin of arbius_tpu/node/factory.py for all six templates, on a torch
device. Weights come from the caller (e.g. the bridge's `params_from_jax`)
or from the pipeline's seeded random init (same FLOPs, no weights
download). Each pipeline serves its template's precision mode
(`cfg.precision.mode_for`): in int8 or fp8 it quantizes the weights once
at load, after the `weights_dtype` cast, as the reference's factory does
(init, cast, quantize). Checkpoints, the CLIP BPE tokenizer and meshes
are not ported yet: a config that names one raises `ConfigError` naming
the ROADMAP.md queue 1 item that ports it.
"""
from __future__ import annotations

import logging

import torch

from arbius_tpu_torch.models.kandinsky2 import (
    Kandinsky2Config,
    Kandinsky2Pipeline,
)
from arbius_tpu_torch.models.rvm import RVMPipeline, RVMPipelineConfig
from arbius_tpu_torch.models.sd15 import ByteTokenizer, SD15Config, SD15Pipeline
from arbius_tpu_torch.models.textgen import TextGenConfig, TextGenPipeline
from arbius_tpu_torch.models.video import Text2VideoConfig, Text2VideoPipeline
from arbius_tpu_torch.node.config import (
    ConfigError,
    MiningConfig,
    ModelConfig,
    TextgenConfig,
)
from arbius_tpu_torch.node.solver import (
    Kandinsky2Runner,
    ModelRegistry,
    RegisteredModel,
    RVMRunner,
    SD15Runner,
    Text2VideoRunner,
    TextGenRunner,
)
from arbius_tpu_torch.templates.engine import load_template

log = logging.getLogger("arbius.factory")

# the anythingv3 model id of MiningConfig.example.json
ANYTHINGV3_MODEL_ID = ("0x98617a8cd4a11db63100ad44bea4e5e296aecfd78b2ef06a"
                       "ee3e364c7307f212")


def tiny_byte_tokenizer(text_cfg) -> ByteTokenizer:
    """Byte tokenizer whose special ids fit a reduced-vocab text tower."""
    return ByteTokenizer(max_length=text_cfg.max_length, bos_id=257,
                         eos_id=258)


# the text-to-image and text-to-video templates' families: config,
# pipeline, runner
_FAMILIES = {"anythingv3": (SD15Config, SD15Pipeline, SD15Runner),
             "kandinsky2": (Kandinsky2Config, Kandinsky2Pipeline,
                            Kandinsky2Runner),
             "zeroscopev2xl": (Text2VideoConfig, Text2VideoPipeline,
                               Text2VideoRunner),
             "damo": (Text2VideoConfig, Text2VideoPipeline,
                      Text2VideoRunner)}
TEMPLATES = (*_FAMILIES, "textgen", "robust_video_matting")


def _load(pipe, params, seed: int, weights_dtype: str):
    """Load `params` into `pipe`, else its seeded random weights.
    weights_dtype "bfloat16" rounds every floating parameter to bf16 once
    (the reference casts its whole tree); linear and conv weights are
    stored in the compute dtype either way. A pipeline in int8 or fp8
    quantizes the cast weights as it loads them (`load_params`)."""
    state = params if params is not None else pipe.init_params(seed)
    if weights_dtype == "bfloat16":
        state = {k: v.to(torch.bfloat16).to(v.dtype)
                 if v.is_floating_point() else v for k, v in state.items()}
    pipe.load_params(state)
    return pipe


def _runner(template: str, *, tiny: bool, device, params, seed: int,
            weights_dtype: str = "float32", precision: str = "bf16"):
    """`template`'s runner over its pipeline (tiny or full config) on
    `device` in `precision` with `params`, else seeded random weights
    (`_load`)."""
    config_cls, pipeline_cls, runner_cls = _FAMILIES[template]
    cfg = config_cls.tiny() if tiny else config_cls()
    pipe = pipeline_cls(cfg, tokenizer=tiny_byte_tokenizer(cfg.text)
                        if tiny else None, device=device,
                        precision=precision)
    return runner_cls(_load(pipe, params, seed, weights_dtype))


def _textgen(m: ModelConfig, tg: TextgenConfig, *, device, params,
             seed: int, precision: str) -> TextGenRunner:
    """textgen's runner: the fleet-wide sequence-bucket policy
    (`cfg.textgen`: the edges and top_k) on top of the model's config."""
    cfg = TextGenConfig.tiny() if m.tiny else TextGenConfig()
    pipe = TextGenPipeline(cfg, device=device,
                           prompt_buckets=tuple(tg.prompt_buckets),
                           decode_buckets=tuple(tg.decode_buckets),
                           top_k=tg.top_k, precision=precision)
    return TextGenRunner(_load(pipe, params, seed, m.weights_dtype))


def probe_resolver(shape: str, base=None):
    """cid -> bytes resolver that makes the deterministic probe clip for
    its own CID and defers everything else to `base`: a golden carrying
    `probe_video: "TxHxW"` self-tests with no clip pinned in any store
    (codecs/probe.py: the same bytes on every platform)."""
    from arbius_tpu_torch.codecs import encode_mp4
    from arbius_tpu_torch.codecs.probe import probe_clip
    from arbius_tpu_torch.l0.base58 import b58encode
    from arbius_tpu_torch.l0.cid import dag_of_file

    t, h, w = (int(x) for x in shape.lower().split("x"))
    blob = encode_mp4(probe_clip(t, h, w), fps=8)
    pcid = b58encode(dag_of_file(blob).cid)

    def resolve(cid):
        if cid == pcid:
            return blob
        return base(cid) if base is not None else None

    return resolve, pcid


def probe_golden_input(shape: str):
    """(resolver, raw input) for recording a file-input golden against
    the probe clip: the one definition of a probe vector's input."""
    resolve_file, clip_cid = probe_resolver(shape)
    return resolve_file, {"input_video": clip_cid}


def _rvm(m: ModelConfig, resolve_file, *, device, params,
         seed: int) -> RVMRunner:
    """robust_video_matting's runner; a probe golden's clip resolves
    in memory ahead of `resolve_file`."""
    probe = (m.golden or {}).get("probe_video")
    if probe:
        resolve_file, _ = probe_resolver(probe, base=resolve_file)
    cfg = RVMPipelineConfig.tiny() if m.tiny else RVMPipelineConfig()
    pipe = RVMPipeline(cfg, device=device)
    return RVMRunner(_load(pipe, params, seed, m.weights_dtype),
                     resolve_file)


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


def _check_ported(m: ModelConfig, mode: str, mesh: dict | None) -> None:
    devices = 1
    for size in (mesh or {}).values():
        devices *= int(size)
    if m.template in ("zeroscopev2xl", "damo") and devices > 1:
        raise ConfigError(
            f"model {m.id}: mesh {mesh} (sp_strategy "
            f"{m.sp_strategy!r}): the video family runs on one device; "
            "frame-axis sequence parallelism waits for multi-device "
            "(ROADMAP queue 1 item 11)")
    if m.template == "robust_video_matting" and mode != "bf16":
        # the stateful ConvGRU matting stream ships no quantized goldens
        raise ConfigError(
            f"precision mode {mode!r} is not shipped for template "
            "robust_video_matting — the matting family serves bf16 only "
            "(docs/quantization.md)")
    if m.checkpoint:
        raise ConfigError(f"model {m.id}: checkpoints are not ported yet; "
                          "weights come from `params` or the seeded init "
                          "(ROADMAP queue 1 item 3)")
    if m.tokenizer != "byte":
        raise ConfigError(f"model {m.id}: tokenizer {m.tokenizer!r} is not "
                          "ported yet (ROADMAP queue 1 item 3)")


def build_registry(cfg: MiningConfig, device: str | torch.device = "cuda",
                   params: dict[str, torch.Tensor] | None = None,
                   resolve_file=None) -> ModelRegistry:
    """Construct runners for every enabled model in the config, on
    `device`, with `params` (a state dict from the bridge, for a config
    whose enabled models are of one family) or the seeded random init
    (seed 0, as the reference's factory).

    `resolve_file` (cid -> bytes) is needed only by file-input templates
    (robust_video_matting); without it, and without a probe golden, such
    a model is skipped with a warning rather than failing the node."""
    reg = ModelRegistry()
    for m in cfg.models:
        if not m.enabled:
            continue
        if m.template not in TEMPLATES:
            log.warning("model %s: unknown template %r; skipping",
                        m.id, m.template)
            continue
        mode = cfg.precision.mode_for(m.template)
        _check_ported(m, mode, cfg.mesh)
        if m.template == "robust_video_matting" and resolve_file is None \
                and not (m.golden or {}).get("probe_video"):
            log.warning("model %s: robust_video_matting needs a "
                        "resolve_file (or a probe_video golden); "
                        "skipping", m.id)
            continue
        if params is None:
            log.warning("model %s: no params given, using random init",
                        m.id)
        kw = dict(device=device, params=params, seed=0)
        if m.template == "textgen":
            runner = _textgen(m, cfg.textgen, precision=mode, **kw)
        elif m.template == "robust_video_matting":
            runner = _rvm(m, resolve_file, **kw)
        else:
            runner = _runner(m.template, tiny=m.tiny,
                             weights_dtype=m.weights_dtype, precision=mode,
                             **kw)
        golden = None
        if m.golden is not None:
            golden = (dict(m.golden["input"]), int(m.golden["seed"]),
                      str(m.golden["cid"]))
        reg.register(RegisteredModel(
            id=m.id, template=load_template(m.template), runner=runner,
            min_fee=m.min_fee, allowed_owners=list(m.allowed_owners),
            golden=golden))
    return reg
