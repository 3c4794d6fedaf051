"""Registry factory — MiningConfig → live ModelRegistry, for the port.

Twin of arbius_tpu/node/factory.py for all six templates, on a torch
device. Weights come from the model's checkpoint (`ModelConfig.checkpoint`:
the one file `convert-checkpoint` writes, utils/checkpoint.py), from the
caller (e.g. the bridge's `params_from_jax`) or from the pipeline's
seeded random init (same FLOPs, no weights download). Each pipeline
serves its template's precision mode (`cfg.precision.mode_for`): in int8
or fp8 it quantizes the weights once at load, after the `weights_dtype`
cast, as the reference's factory does (load or init, cast, quantize), so
a loaded checkpoint is quantized exactly as the seeded init is. The
prompt tokenizer is the byte tokenizer or, with `tokenizer: "clip_bpe"`,
CLIP's BPE over the configured vocabulary files. A mesh is the port's
mesh of lanes (parallel/mesh.py), built and audited here as the
reference's factory does (`mesh_contracts`, `build_registry(mesh=)`):
anythingv3 runs on a dp mesh, each lane a replica of its pipeline;
robust_video_matting stays single-device. A layout a family does not run
on the port yet (`mesh_refusal`: anythingv3's dp·tp, kandinsky2's and
textgen's dp, the video family's dp·sp·tp, pp) raises `ConfigError`
naming the ROADMAP.md queue 1 item that ports it.
"""
from __future__ import annotations

import logging
import os

import torch

from arbius_tpu_torch.models.kandinsky2 import (
    Kandinsky2Config,
    Kandinsky2Pipeline,
)
from arbius_tpu_torch.models.rvm import RVMPipeline, RVMPipelineConfig
from arbius_tpu_torch.models.sd15 import (
    ByteTokenizer,
    CLIPBPETokenizer,
    SD15Config,
    SD15Pipeline,
)
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
from arbius_tpu_torch.utils.checkpoint import load_params

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


def _tokenizer_for(m: ModelConfig, text_cfg):
    """ModelConfig.tokenizer -> live tokenizer (None = pipeline default).

    `clip_bpe` loads the standard CLIP vocab/merges from the configured
    local files: the pairing converted CLIP weights need (byte-level ids
    feed garbage conditioning into a pretrained text tower)."""
    if m.tokenizer == "clip_bpe":
        tok = CLIPBPETokenizer.from_files(m.vocab_path, m.merges_path)
        tok.max_length = text_cfg.max_length
        return tok
    return tiny_byte_tokenizer(text_cfg) if m.tiny else None


def _load(pipe, m: ModelConfig, params, seed: int):
    """Load the model's weights into `pipe`: its checkpoint file, else
    `params`, else the seeded random init. weights_dtype "bfloat16"
    rounds every floating parameter stored in another dtype to bf16 once
    (the reference casts its whole tree); linear and conv weights are
    stored in the compute dtype either way. A pipeline in int8 or fp8
    quantizes the cast weights as it loads them (`load_params`)."""
    if m.checkpoint:
        state = {k: v.to(pipe.device)
                 for k, v in load_params(m.checkpoint).items()}
    elif params is not None:
        state = params
    else:
        state = pipe.init_params(seed)
    if m.weights_dtype == "bfloat16":
        state = {k: v.to(torch.bfloat16).to(v.dtype)
                 if v.is_floating_point() and v.dtype != torch.bfloat16
                 else v for k, v in state.items()}
    pipe.load_params(state)
    return pipe


def _runner(m: ModelConfig, *, device, params, seed: int,
            precision: str = "bf16", mesh=None):
    """`m.template`'s runner over its pipeline (tiny or full config) on
    `device` in `precision` (on `mesh`'s lanes, for anythingv3), with
    the weights `_load` picks."""
    config_cls, pipeline_cls, runner_cls = _FAMILIES[m.template]
    cfg = config_cls.tiny() if m.tiny else config_cls()
    kw = {"mesh": mesh} if mesh is not None else {}
    pipe = pipeline_cls(cfg, tokenizer=_tokenizer_for(m, cfg.text),
                        device=device, precision=precision, **kw)
    return runner_cls(_load(pipe, m, params, seed))


def _textgen(m: ModelConfig, tg: TextgenConfig, *, device, params,
             seed: int, precision: str) -> TextGenRunner:
    """textgen's runner: the fleet-wide sequence-bucket policy
    (`cfg.textgen`: the edges and top_k) on top of the model's config."""
    cfg = TextGenConfig.tiny() if m.tiny else TextGenConfig()
    pipe = TextGenPipeline(cfg, device=device,
                           prompt_buckets=tuple(tg.prompt_buckets),
                           decode_buckets=tuple(tg.decode_buckets),
                           top_k=tg.top_k, precision=precision)
    return TextGenRunner(_load(pipe, m, params, seed))


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
    return RVMRunner(_load(pipe, m, params, seed), resolve_file)


def build_anythingv3(tiny: bool = False,
                     device: str | torch.device = "cuda",
                     params: dict[str, torch.Tensor] | None = None,
                     seed: int = 0) -> RegisteredModel:
    """anythingv3 on `device`: the full SD-1.5 config (or the tiny test
    config), with `params` if given, else seeded random weights."""
    return RegisteredModel(id=ANYTHINGV3_MODEL_ID,
                           template=load_template("anythingv3"),
                           runner=_runner(ModelConfig(
                               id=ANYTHINGV3_MODEL_ID, template="anythingv3",
                               tiny=tiny), device=device, params=params,
                               seed=seed))


# the mesh layouts each family runs on the port (beside no mesh); the
# rest of its MESH_LAYOUTS waits for ROADMAP queue 1 item 11
_PORTED_LAYOUTS = {"anythingv3": (("dp",),)}


def mesh_refusal(template: str | None, mesh: dict | None) -> str | None:
    """Why `mesh` cannot run on the port yet, for `template` (None: for
    any model), naming the ROADMAP.md queue 1 item that ports it; None
    when it can."""
    from arbius_tpu_torch.parallel.mesh import AXIS_ORDER

    active = tuple(a for a in AXIS_ORDER if int((mesh or {}).get(a, 1)) > 1)
    if "pp" in active:
        return (f"mesh {mesh}: pipeline stages (parallel/pipeline.py) are "
                "not ported yet (ROADMAP queue 1 item 11)")
    if not active or template in (None, "robust_video_matting"):
        return None   # matting stays single-device, as the reference's
    if template in ("zeroscopev2xl", "damo"):
        return (f"mesh {mesh}: the video family runs on one device; "
                "frame-axis sequence parallelism waits for multi-device "
                "(ROADMAP queue 1 item 11)")
    if active not in _PORTED_LAYOUTS.get(template, ()):
        return (f"mesh {mesh}: template {template} does not run the "
                f"{'·'.join(active)} layout on the port yet (ROADMAP queue "
                "1 item 11)")
    return None


def _check_ported(m: ModelConfig, mode: str, mesh: dict | None) -> None:
    why = mesh_refusal(m.template, mesh)
    if why:
        raise ConfigError(f"model {m.id}: {why}")
    if m.template == "robust_video_matting" and mode != "bf16":
        # the stateful ConvGRU matting stream ships no quantized goldens
        raise ConfigError(
            f"precision mode {mode!r} is not shipped for template "
            "robust_video_matting — the matting family serves bf16 only "
            "(docs/quantization.md)")
    if m.checkpoint and not os.path.isfile(m.checkpoint):
        raise ConfigError(f"model {m.id}: checkpoint {m.checkpoint!r} is "
                          "not a file (convert-checkpoint writes one)")


# template -> the pipeline module publishing that family's mesh contract
# as data (MESH_LAYOUTS, MESH_BATCH_HARD); robust_video_matting is absent
# on purpose (never meshed). The family list check_mesh_contract audits.
_MESH_CONTRACT_MODULES = {
    "anythingv3": "arbius_tpu_torch.models.sd15.pipeline",
    "kandinsky2": "arbius_tpu_torch.models.kandinsky2.pipeline",
    "zeroscopev2xl": "arbius_tpu_torch.models.video.pipeline",
    "damo": "arbius_tpu_torch.models.video.pipeline",
    "textgen": "arbius_tpu_torch.models.textgen.pipeline",
}


def mesh_contracts(cfg: MiningConfig) -> dict:
    """Enabled mesh-capable templates -> their pipeline modules, the
    contract table `meshsolve.check_mesh_contract` boot-audits."""
    import importlib

    return {m.template: importlib.import_module(
                _MESH_CONTRACT_MODULES[m.template])
            for m in cfg.models
            if m.enabled and m.template in _MESH_CONTRACT_MODULES}


def build_registry(cfg: MiningConfig, device: str | torch.device = "cuda",
                   params: dict[str, torch.Tensor] | None = None,
                   resolve_file=None, *, mesh=None) -> ModelRegistry:
    """Construct runners for every enabled model in the config, on
    `device`, with `params` (a state dict from the bridge, for a config
    whose enabled models are of one family) or the seeded random init
    (seed 0, as the reference's factory).

    When `cfg.mesh` is set (and no `mesh` is passed) the solve mesh is
    built here over `device`'s lanes, validated against the lanes the
    host has, and audited against the families' contracts; anythingv3's
    pipeline then holds its weights on every lane's device.

    `resolve_file` (cid -> bytes) is needed only by file-input templates
    (robust_video_matting); without it, and without a probe golden, such
    a model is skipped with a warning rather than failing the node."""
    enabled = [m for m in cfg.models if m.enabled]
    for m in enabled:
        if m.template in TEMPLATES:
            _check_ported(m, cfg.precision.mode_for(m.template), cfg.mesh)
    if mesh is None and cfg.mesh is not None:
        from arbius_tpu_torch.parallel import meshsolve

        mesh = meshsolve.boot_mesh(cfg.mesh, device=device)
        meshsolve.check_mesh_contract(mesh, mesh_contracts(cfg),
                                      cfg.canonical_batch)
    reg = ModelRegistry()
    for m in enabled:
        if m.template not in TEMPLATES:
            log.warning("model %s: unknown template %r; skipping",
                        m.id, m.template)
            continue
        mode = cfg.precision.mode_for(m.template)
        if m.template == "robust_video_matting" and resolve_file is None \
                and not (m.golden or {}).get("probe_video"):
            log.warning("model %s: robust_video_matting needs a "
                        "resolve_file (or a probe_video golden); "
                        "skipping", m.id)
            continue
        if params is None and not m.checkpoint:
            log.warning("model %s: no checkpoint or params given, using "
                        "random init", m.id)
        kw = dict(device=device, params=params, seed=0)
        if m.template == "textgen":
            runner = _textgen(m, cfg.textgen, precision=mode, **kw)
        elif m.template == "robust_video_matting":
            runner = _rvm(m, resolve_file, **kw)
        else:
            runner = _runner(m, precision=mode, **kw,
                             mesh=mesh if m.template == "anythingv3"
                             else None)
        golden = None
        if m.golden is not None:
            golden = (dict(m.golden["input"]), int(m.golden["seed"]),
                      str(m.golden["cid"]))
        reg.register(RegisteredModel(
            id=m.id, template=load_template(m.template), runner=runner,
            min_fee=m.min_fee, allowed_owners=list(m.allowed_owners),
            golden=golden))
    return reg
