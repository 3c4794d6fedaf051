"""The port's checkpoint converters (arbius_tpu_torch/models/{sd15,
kandinsky2,video,rvm}/convert.py) against the reference's, for each
family at its tiny config, on the CPU.

The reference's tree is its `jax.eval_shape` tree filled with seeded
numpy draws (no jitted init). For each family:
  1. the port's template (`bridge.template_from_models` over its module
     bundle on the meta device) equals the reference's tree in paths and
     shapes;
  2. a published-layout state dict synthesized from the reference's tree
     (its exporters; the reference test's `_synthesize` for the VAE and
     text towers) converts to bit-equal trees through the reference's
     converter and the port's;
  3. the port's tiny pipeline on the converted tree gives exactly the
     output it gives on `params_from_jax` of the reference's tree;
  4. the port's export -> convert is an exact round trip (anythingv3
     through chip_smoke.py's `published_anythingv3`, the export its
     phase 14 converts on the card);
  5. a missing key and a wrong shape each raise `ConversionError`.
"""
from __future__ import annotations

import math

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from arbius_tpu.models.kandinsky2 import convert as ref_k2
from arbius_tpu.models.rvm import convert as ref_rvm
from arbius_tpu.models.sd15 import convert as ref_sd15
from arbius_tpu.models.video import convert as ref_video
from arbius_tpu_torch.models.kandinsky2 import convert as k2
from arbius_tpu_torch.models.rvm import convert as rvm
from arbius_tpu_torch.models.sd15 import convert as sd15
from arbius_tpu_torch.models.sd15.bridge import (
    init_params,
    params_from_jax,
    template_from_models,
    tree_from_state,
)
from arbius_tpu_torch.models.video import convert as video
from test_convert import _synthesize

FAMILIES = ("anythingv3", "kandinsky2", "video", "rvm")
META = torch.device("meta")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's small torch ops on one thread (the suite's workers
    share the host's cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flat(tree: dict, parts=()) -> dict:
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, parts + (k,)))
        else:
            out["/".join(parts + (k,))] = v
    return out


def _draw(shapes: dict, seed: int) -> dict:
    """numpy float32 weights for an eval_shape tree: kernels
    normal(1/sqrt(fan in)), norm scales 1 +- 0.1, BN variances in
    [0.5, 1.5], everything else normal(0.1)."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name == "kernel":
            w = rng.standard_normal(s.shape) / math.sqrt(
                math.prod(s.shape[:-1]))
        elif name == "scale":
            w = 1 + 0.1 * rng.standard_normal(s.shape)
        elif name == "var":
            w = rng.uniform(0.5, 1.5, s.shape)
        else:
            w = 0.1 * rng.standard_normal(s.shape)
        return w.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


class Family:
    """One family's reference tree, the port's module bundle and tiny
    pipeline, and both packages' published-layout round trips."""

    def __init__(self, name: str):
        self.name = name
        if name == "anythingv3":
            from arbius_tpu.models.sd15 import SD15Config, SD15Pipeline
            from arbius_tpu.node.factory import tiny_byte_tokenizer
            from arbius_tpu_torch.models.sd15.pipeline import (
                SD15Config as TConfig,
            )
            from arbius_tpu_torch.models.sd15.pipeline import (
                SD15Models,
                SD15Pipeline as TPipeline,
            )

            cfg = SD15Config.tiny()
            ref = SD15Pipeline(cfg, tokenizer=tiny_byte_tokenizer(cfg.text))
            self.models = lambda device=None: SD15Models(TConfig.tiny(),
                                                          device)
            self.pipe = lambda: TPipeline(TConfig.tiny(), tokenizer=_tiny(
                TConfig.tiny().text), device="cpu")
            self.heads = (cfg.text.heads, cfg.text.width // cfg.text.heads)
        elif name == "kandinsky2":
            from arbius_tpu.models.kandinsky2 import (
                Kandinsky2Config,
                Kandinsky2Pipeline,
            )
            from arbius_tpu.node.factory import tiny_byte_tokenizer
            from arbius_tpu_torch.models.kandinsky2.pipeline import (
                Kandinsky2Config as TConfig,
            )
            from arbius_tpu_torch.models.kandinsky2.pipeline import (
                Kandinsky2Models,
                Kandinsky2Pipeline as TPipeline,
            )

            cfg = Kandinsky2Config.tiny()
            ref = Kandinsky2Pipeline(cfg,
                                     tokenizer=tiny_byte_tokenizer(cfg.text))
            self.models = lambda device=None: Kandinsky2Models(
                TConfig.tiny(), device)
            self.pipe = lambda: TPipeline(TConfig.tiny(), tokenizer=_tiny(
                TConfig.tiny().text), device="cpu")
            self.heads = (cfg.text.heads, cfg.text.width // cfg.text.heads)
        elif name == "video":
            from arbius_tpu.models.video import (
                Text2VideoConfig,
                Text2VideoPipeline,
            )
            from arbius_tpu.node.factory import tiny_byte_tokenizer
            from arbius_tpu_torch.models.video.pipeline import (
                Text2VideoConfig as TConfig,
            )
            from arbius_tpu_torch.models.video.pipeline import (
                Text2VideoModels,
                Text2VideoPipeline as TPipeline,
            )

            cfg = Text2VideoConfig.tiny()
            ref = Text2VideoPipeline(cfg,
                                     tokenizer=tiny_byte_tokenizer(cfg.text))
            self.models = lambda device=None: Text2VideoModels(
                TConfig.tiny(), device)
            self.pipe = lambda: TPipeline(TConfig.tiny(), tokenizer=_tiny(
                TConfig.tiny().text), device="cpu")
            self.heads = (cfg.text.heads, cfg.text.width // cfg.text.heads)
        else:
            from arbius_tpu.models.rvm import RVMPipeline, RVMPipelineConfig
            from arbius_tpu_torch.models.rvm import MattingStep
            from arbius_tpu_torch.models.rvm.pipeline import (
                RVMPipeline as TPipeline,
            )
            from arbius_tpu_torch.models.rvm.pipeline import (
                RVMPipelineConfig as TConfig,
            )

            ref = RVMPipeline(RVMPipelineConfig.tiny())
            self.models = lambda device=None: MattingStep(
                TConfig.tiny().model, device)
            self.pipe = lambda: TPipeline(TConfig.tiny(), device="cpu")
            self.rvm_config = RVMPipelineConfig.tiny().model
            self.port_rvm_config = TConfig.tiny().model
        self.shapes = jax.eval_shape(lambda: ref.init_params(seed=0))
        self.tree = _draw(self.shapes, FAMILIES.index(name))

    # -- the published layout, written by each package's exporters ----------
    def publish(self, tree: dict) -> dict:
        """The reference's tree -> {part: published state dict}, through
        the reference's exporters (and its test's `_synthesize`)."""
        heads = getattr(self, "heads", None)
        if self.name == "anythingv3":
            return {"unet": ref_sd15.export_sd15_unet(tree["unet"]),
                    "vae": _synthesize(tree["vae"], ref_sd15.vae_key_for),
                    "text": _synthesize(tree["text"], lambda p:
                                        ref_sd15.text_key_for(p, *heads))}
        if self.name == "video":
            return {"unet": ref_video.export_tree(tree["unet"]),
                    "vae": _synthesize(tree["vae"], ref_sd15.vae_key_for),
                    "text": _synthesize(tree["text"], lambda p:
                                        ref_sd15.text_key_for(p, *heads))}
        if self.name == "kandinsky2":
            prior = ref_k2.export_tree(tree["prior"], ref_k2.prior_key_for)
            prior["clip_mean"], prior["clip_std"] = tree["prior_stats"]
            text = _synthesize(tree["text"], lambda p:
                               ref_sd15.text_key_for(p, *heads))
            text["text_projection.weight"] = np.transpose(
                tree["text_proj"]["proj"]["kernel"])
            return {"prior": prior, "text": text,
                    "decoder": ref_k2.export_tree(tree["decoder"],
                                                  ref_k2.decoder_key_for),
                    "movq": ref_k2.export_tree(tree["movq"],
                                               ref_k2.movq_key_for)}
        return {"weights": ref_rvm.export_tree(tree, self.rvm_config)}

    def export(self, tree: dict) -> dict:
        """The same through the port's exporters and chip_smoke.py's
        `export_published`."""
        heads = getattr(self, "heads", None)
        text = (lambda p: sd15.text_key_for(p, *heads)) if heads else None
        if self.name == "anythingv3":
            models = self.models()
            return chip_smoke.published_anythingv3(
                models, params_from_jax(tree))
        if self.name == "video":
            return {"unet": video.export_tree(tree["unet"]),
                    "vae": chip_smoke.export_published(tree["vae"],
                                                       sd15.vae_key_for),
                    "text": chip_smoke.export_published(tree["text"], text)}
        if self.name == "kandinsky2":
            prior = k2.export_tree(tree["prior"], k2.prior_key_for)
            prior["clip_mean"], prior["clip_std"] = tree["prior_stats"]
            out = chip_smoke.export_published(tree["text"], text)
            out["text_projection.weight"] = np.transpose(
                tree["text_proj"]["proj"]["kernel"])
            return {"prior": prior, "text": out,
                    "decoder": k2.export_tree(tree["decoder"],
                                              k2.decoder_key_for),
                    "movq": k2.export_tree(tree["movq"], k2.movq_key_for)}
        return {"weights": rvm.export_tree(tree, self.port_rvm_config)}

    # -- conversion, as each package's convert-checkpoint does it ------------
    def convert(self, pkg, sds: dict, tmpl: dict) -> dict:
        """`pkg`'s converters (a namespace of the four modules) over the
        published parts `sds` into template `tmpl`."""
        if self.name == "anythingv3":
            return {"unet": pkg.sd15.convert_sd15_unet(sds["unet"],
                                                       tmpl["unet"]),
                    "vae": pkg.sd15.convert_sd15_vae(sds["vae"], tmpl["vae"]),
                    "text": pkg.sd15.convert_sd15_text(sds["text"],
                                                       tmpl["text"],
                                                       *self.heads)}
        if self.name == "video":
            return {"unet": pkg.video.convert_unet3d(sds["unet"],
                                                     tmpl["unet"]),
                    "vae": pkg.video.convert_video_vae(sds["vae"],
                                                       tmpl["vae"]),
                    "text": pkg.video.convert_video_text(sds["text"],
                                                         tmpl["text"],
                                                         *self.heads)}
        if self.name == "kandinsky2":
            prior, stats = pkg.k2.convert_kandinsky2_prior(sds["prior"],
                                                           tmpl["prior"])
            return {"prior": prior, "prior_stats": stats,
                    "decoder": pkg.k2.convert_kandinsky2_decoder(
                        sds["decoder"], tmpl["decoder"]),
                    "movq": pkg.k2.convert_kandinsky2_movq(sds["movq"],
                                                           tmpl["movq"]),
                    "text": pkg.sd15.convert_sd15_text(
                        sds["text"], tmpl["text"], *self.heads),
                    "text_proj": pkg.k2.convert_kandinsky2_text_projection(
                        sds["text"], tmpl["text_proj"])}
        return pkg.rvm.convert_rvm(sds["weights"], tmpl,
                                   pkg.rvm_config(self))

    def template(self) -> dict:
        return template_from_models(self.models(META))

    def run(self, state: dict) -> np.ndarray:
        """The port's tiny pipeline on `state`: one small solve."""
        pipe = self.pipe()
        pipe.load_params(state)
        if self.name == "anythingv3":
            return pipe.generate(["a lighthouse", "b"], ["", "blurry"],
                                 [1, 2**40 + 3], width=64, height=64,
                                 num_inference_steps=2, scheduler="DDIM")
        if self.name == "kandinsky2":
            return pipe.generate(["a lighthouse", "b"], None, [1, 2],
                                 width=64, height=64, num_inference_steps=2)
        if self.name == "video":
            return pipe.generate(["a rocket", "b"], ["", "blurry"], [7, 8],
                                 num_frames=2, width=64, height=64,
                                 num_inference_steps=2)
        video_in = np.random.default_rng(5).integers(
            0, 256, (3, 64, 64, 3), dtype=np.uint8)
        return pipe.matte(video_in, output_type="alpha-mask")


def _tiny(text_cfg):
    from arbius_tpu_torch.node.factory import tiny_byte_tokenizer

    return tiny_byte_tokenizer(text_cfg)


class _Pkg:
    def __init__(self, sd15, video, k2, rvm, rvm_config):
        self.sd15, self.video, self.k2, self.rvm = sd15, video, k2, rvm
        self.rvm_config = rvm_config


REF = _Pkg(ref_sd15, ref_video, ref_k2, ref_rvm, lambda f: f.rvm_config)
PORT = _Pkg(sd15, video, k2, rvm, lambda f: f.port_rvm_config)


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    return Family(request.param)


def _assert_bit_equal(a: dict, b: dict) -> None:
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        x, y = np.asarray(fa[k]), np.asarray(fb[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def test_template_equals_reference_tree(family):
    ours = {k: tuple(v.shape) for k, v in _flat(family.template()).items()}
    ref = {k: tuple(v.shape) for k, v in _flat(family.shapes).items()}
    assert ours == ref


def test_converted_tree_bit_equal_to_reference(family):
    published = family.publish(family.tree)
    ours = family.convert(PORT, published, family.template())
    ref = family.convert(REF, published, family.shapes)
    _assert_bit_equal(ours, ref)
    _assert_bit_equal(ours, family.tree)


def test_pipeline_output_on_converted_weights_exact(family):
    converted = family.convert(PORT, family.publish(family.tree),
                               family.template())
    got = family.run(params_from_jax(converted))
    want = family.run(params_from_jax(family.tree))
    assert np.isfinite(got.astype(np.float64)).all()
    np.testing.assert_array_equal(got, want)


def test_export_convert_round_trip(family):
    state = init_params(family.models(), 3, "cpu")
    tree = tree_from_state(family.models(), state)
    back = family.convert(PORT, family.export(tree), family.template())
    _assert_bit_equal(back, tree)
    again = params_from_jax(back)
    assert again.keys() == state.keys()
    assert all(torch.equal(again[k], state[k]) for k in state)


@pytest.mark.parametrize("fault", ["missing", "shape"])
def test_bad_published_dict_raises(family, fault):
    published = family.publish(family.tree)
    part = next(iter(published))
    key = sorted(k for k, v in published[part].items()
                 if np.asarray(v).ndim >= 2)[0]
    if fault == "missing":
        del published[part][key]
        match = "missing"
    else:
        published[part][key] = np.zeros((1, 2, 3, 4), np.float32)
        match = "converted shape"
    with pytest.raises(sd15.ConversionError, match=match):
        family.convert(PORT, published, family.template())
