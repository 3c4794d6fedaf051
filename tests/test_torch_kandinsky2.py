"""The port's Kandinsky-2 slice against the JAX reference on the CPU, at
the tiny config: the weight bridge, models/common.py's `ResnetBlock`
variants, the text encoder's exact gelu, the prior and its sampler, the
decoder's added-KV attention and UNet, MOVQ's spatial norm and decoder,
and the whole `generate`. Weights are the reference's own `init_params`
(one jitted init), carried across by `params_from_jax`; inputs come from
numpy with a seed.

Tolerances: float32 modules agree to 5e-5, as in tests/test_torch_sd15.py
(reduction order differs between XLA and torch). The tiny decoder's random
weights drive the float pixels of the 2-step generate to about +-22 with
DDIM and +-214 with Euler ancestral (SD-1.5's tiny stays within +-4), and
float32 noise grows with them: they are held to 1e-4 of their largest
magnitude (measured 4.4e-5 and 3.5e-5 of it), and the uint8 images differ
by at most one level on at most 1% of pixels (measured 0.31% and 0.34%).
The bf16 generate is ill-conditioned at this config: the reference's own
bf16 pixels differ from its float32 ones by up to 2.9 (mean 0.14), and
XLA on the CPU keeps fused elementwise chains in float32 where torch
rounds each op to bf16. So the port's bf16 pixels are held to the
reference's bf16 ones within 4x the reference's own bf16-vs-float32 mean
difference and 6x its largest (measured 3.1x and 4.5x).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arbius_tpu.models import common as jcommon
from arbius_tpu.models.kandinsky2 import Kandinsky2Config as JConfig
from arbius_tpu.models.kandinsky2 import Kandinsky2Pipeline as JPipeline
from arbius_tpu.models.kandinsky2 import decoder as jdecoder
from arbius_tpu.models.kandinsky2 import movq as jmovq
from arbius_tpu.models.kandinsky2 import pipeline as jpipeline
from arbius_tpu.models.kandinsky2 import prior as jprior
from arbius_tpu.models.sd15 import text_encoder as jtext
from arbius_tpu.models.sd15.vae import decode_to_images as jax_decode
from arbius_tpu.node.factory import tiny_byte_tokenizer as jax_tiny_tokenizer
from arbius_tpu_torch.models import common
from arbius_tpu_torch.models.kandinsky2 import (
    Kandinsky2Config,
    Kandinsky2Pipeline,
    params_from_jax,
    prior_sample,
)
from arbius_tpu_torch.models.kandinsky2 import decoder, movq
from arbius_tpu_torch.models.kandinsky2 import pipeline as tpipeline
from arbius_tpu_torch.models.sd15 import decode_to_images, text_encoder
from arbius_tpu_torch.models.sd15.bridge import quant_layout
from arbius_tpu_torch.node.factory import tiny_byte_tokenizer
from test_torch_quant import check_dequantized_weights, check_output_axes

F32_TOL = 5e-5
PROMPTS = ["a lighthouse at dusk", "b"]
SEEDS = [1, 2**40 + 3]
GUIDANCE = [4.0, 2.5]


def _config(cls, dtype):
    """The tiny config with every module's compute dtype set."""
    r = dataclasses.replace
    cfg = cls.tiny()
    return r(cfg, prior=r(cfg.prior, dtype=dtype),
             decoder=r(cfg.decoder, unet=r(cfg.decoder.unet, dtype=dtype)),
             movq=r(cfg.movq, dtype=dtype), text=r(cfg.text, dtype=dtype))


def _plain(tree):
    tree = jax.tree_util.tree_map(np.asarray, tree)

    def plain(node):
        return {k: plain(v) if hasattr(v, "items") else v
                for k, v in node.items()}

    return plain(tree)


@pytest.fixture(scope="module")
def jax_tree():
    """The reference's tiny init (float32 parameters whatever the compute
    dtype), as nested dicts of numpy arrays."""
    return _plain(JPipeline(_config(JConfig, "float32")).init_params(seed=0))


@pytest.fixture(scope="module")
def port_f32(jax_tree):
    cfg = _config(Kandinsky2Config, "float32")
    pipe = Kandinsky2Pipeline(cfg, tokenizer=tiny_byte_tokenizer(cfg.text),
                              device="cpu")
    pipe.load_params(params_from_jax(jax_tree))
    return pipe


@pytest.fixture(scope="module")
def jpipe_f32():
    cfg = _config(JConfig, "float32")
    return JPipeline(cfg, tokenizer=jax_tiny_tokenizer(cfg.text))


def _leaves(tree):
    return sum(_leaves(v) if isinstance(v, dict) else 1
               for v in tree.values())


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_bridge_covers_every_leaf(jax_tree, port_f32):
    sd = params_from_jax(jax_tree)
    assert len(sd) == _leaves(jax_tree)
    assert set(sd) == set(port_f32.models.state_dict())
    for name in ("prior.pos_embed", "prior.prd_embed"):
        want = jax_tree["prior"][name.split(".")[1]]
        assert want.ndim == 3
        np.testing.assert_array_equal(sd[name].numpy(), want)
    np.testing.assert_array_equal(sd["prior_stats"].numpy(),
                                  jax_tree["prior_stats"])
    k = jax_tree["decoder"]["unet"]["conv_in"]["kernel"]
    np.testing.assert_array_equal(sd["decoder.unet.conv_in.weight"].numpy(),
                                  k.transpose(3, 2, 0, 1))
    p = jax_tree["text_proj"]["proj"]["kernel"]
    np.testing.assert_array_equal(sd["text_proj.proj.weight"].numpy(), p.T)


def _apply_both(jmod, tmod, args, nchw=True, **kw):
    """Init `jmod` on `args` (NHWC maps), load its weights into `tmod`,
    and return both outputs as NHWC numpy arrays."""
    variables = jmod.init(jax.random.PRNGKey(0), *map(jnp.asarray, args),
                          **kw)
    want = np.asarray(jmod.apply(variables, *map(jnp.asarray, args), **kw))
    tmod.load_state_dict(params_from_jax(_plain(dict(variables["params"]))))
    targs = [_t(a) for a in args]
    if nchw:
        targs = [a.permute(0, 3, 1, 2) if a.dim() == 4 else a for a in targs]
    with torch.no_grad():
        got = tmod(*targs, **kw)
    if nchw and got.dim() == 4:
        got = got.permute(0, 2, 3, 1)
    return got.numpy(), want


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_dequantized_weights_equal_reference_bit_for_bit(jax_tree, port_f32,
                                                         mode):
    """kandinsky2 in int8 and fp8 (tests/test_torch_quant.py (a)), on this
    module's reference tree: the reference's quantize_params and
    dequantize_tree through the bridge equal the port's dequantized
    state bit for bit, over the same quantized leaves."""
    check_dequantized_weights(jax_tree, quant_layout(port_f32.models), mode)


def test_quant_output_axis_is_where_convert_puts_the_reference_last_axis(
        jax_tree, port_f32):
    layout = quant_layout(port_f32.models)
    check_output_axes(jax_tree, layout)
    # the text tower's DenseGeneral bias [H, D] is scaled per D
    assert layout["text.layer_0.attn.query.bias"].axis == 1


@pytest.mark.parametrize("resample", ["none", "down", "up"])
@pytest.mark.parametrize("scale_shift", [False, True])
def test_resnet_block_variants_match(scale_shift, resample):
    rng = np.random.default_rng(7)
    args = [rng.standard_normal(s).astype(np.float32)
            for s in ((2, 4, 4, 16), (2, 32))]
    got, want = _apply_both(
        jcommon.ResnetBlock(24, jnp.float32, scale_shift, resample),
        common.ResnetBlock(16, 24, torch.float32, 32,
                           scale_shift=scale_shift, resample=resample),
        args)
    side = {"none": 4, "down": 2, "up": 8}[resample]
    assert got.shape == want.shape == (2, side, side, 24)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


def test_text_encoder_gelu_matches():
    cfg = dataclasses.replace(jtext.TextEncoderConfig.tiny(), act="gelu",
                              dtype="float32")
    ids = np.random.default_rng(0).integers(0, 512, (2, 16)).astype(np.int32)
    tcfg = dataclasses.replace(text_encoder.TextEncoderConfig.tiny(),
                               act="gelu", dtype="float32")
    got, want = _apply_both(jtext.TextEncoder(cfg),
                            text_encoder.TextEncoder(tcfg), [ids],
                            nchw=False)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    # SD-1.5's default tower keeps quick-gelu
    default = text_encoder.TextEncoder(text_encoder.TextEncoderConfig.tiny())
    assert default.layer_0.act is text_encoder.quick_gelu


def _prior_inputs(cfg, text_width, b=2, seed=3):
    rng = np.random.default_rng(seed)
    tok = rng.standard_normal((b, cfg.text_len, text_width)).astype(
        np.float32)
    pooled = rng.standard_normal((b, cfg.clip_dim)).astype(np.float32)
    mask = np.ones((b, cfg.text_len), np.float32)
    mask[0, 3:] = 0.0      # a short prompt: the padding is masked
    return tok, pooled, mask


def test_prior_transformer_matches_with_text_mask(jax_tree, port_f32):
    cfg = port_f32.config.prior
    tok, pooled, mask = _prior_inputs(cfg, port_f32.config.text.width)
    embed = np.random.default_rng(4).standard_normal(
        (2, cfg.clip_dim)).astype(np.float32)
    t = np.array([999.0, 41.0], np.float32)
    jmod = jprior.PriorTransformer(_config(JConfig, "float32").prior)
    for m in (mask, None):
        want = np.asarray(jmod.apply(
            {"params": jax_tree["prior"]}, *map(jnp.asarray, (embed, t, tok,
                                                              pooled)),
            None if m is None else jnp.asarray(m)))
        with torch.no_grad():
            got = port_f32.models.prior(_t(embed), _t(t), _t(tok),
                                        _t(pooled),
                                        None if m is None else _t(m))
        assert got.dtype == torch.float32 and got.shape == (2, cfg.clip_dim)
        np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL,
                                   atol=F32_TOL)


def test_prior_sample_matches_and_denormalises(jax_tree, port_f32):
    """Three DDIM steps from the same threefry keys; then the same run
    de-normalised by [mean; std] rows is that result times std plus
    mean, in both packages."""
    cfg = port_f32.config.prior
    tok, pooled, mask = _prior_inputs(cfg, port_f32.config.text.width)
    g = np.array([4.0, 1.5], np.float32)
    stats = np.stack([np.linspace(-1, 1, cfg.clip_dim),
                      np.linspace(0.5, 2, cfg.clip_dim)]).astype(np.float32)
    jkeys = jax.vmap(lambda lo, hi: jax.random.fold_in(
        jax.random.PRNGKey(lo), hi))(jnp.asarray([1, 5], jnp.uint32),
                                     jnp.asarray([0, 9], jnp.uint32))
    from arbius_tpu_torch import random as jrandom

    tkeys = jrandom.fold_in(jrandom.prng_key(torch.tensor([1, 5]), "cpu"),
                            torch.tensor([0, 9]))
    np.testing.assert_array_equal(tkeys.numpy(), np.asarray(jkeys))
    jmod = jprior.PriorTransformer(_config(JConfig, "float32").prior)
    runs = {}
    for s in (None, stats):
        want = np.asarray(jprior.prior_sample(
            jmod, jax_tree["prior"], jnp.asarray(tok), jnp.asarray(pooled),
            jkeys, jnp.asarray(g), steps=3, text_mask=jnp.asarray(mask),
            clip_stats=None if s is None else jnp.asarray(s)))
        got = prior_sample(port_f32.models.prior, _t(tok), _t(pooled),
                           tkeys, _t(g), steps=3, text_mask=_t(mask),
                           clip_stats=None if s is None else _t(s)).numpy()
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
        runs["raw" if s is None else "stats"] = got
    np.testing.assert_allclose(runs["stats"],
                               runs["raw"] * stats[1] + stats[0],
                               rtol=1e-6, atol=1e-6)


def test_attn_added_kv_matches():
    rng = np.random.default_rng(5)
    args = [rng.standard_normal(s).astype(np.float32)
            for s in ((2, 4, 4, 16), (2, 3, 12))]
    got, want = _apply_both(
        jdecoder.AttnAddedKV(2, 8, 12, jnp.float32),
        decoder.AttnAddedKV(16, 2, 8, 12, torch.float32), args)
    assert got.shape == want.shape == (2, 4, 4, 16)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


def test_decoder_unet_matches_with_its_variance_half(jax_tree, port_f32):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([999.0, 10.0], np.float32)
    emb = rng.standard_normal((2, 16)).astype(np.float32)
    jmod = jdecoder.DecoderUNet(_config(JConfig, "float32").decoder)
    want = np.asarray(jmod.apply({"params": jax_tree["decoder"]},
                                 *map(jnp.asarray, (x, t, emb))))
    with torch.no_grad():
        got = port_f32.models.decoder(_t(x), _t(t), _t(emb)).numpy()
    assert got.shape == want.shape == (2, 8, 8, 8)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    # the epsilon half the samplers read is the first four channels
    np.testing.assert_allclose(got[..., :4], want[..., :4], rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("factor", [2, 4, 8])
def test_spatial_norm_matches_at_resize_factor(factor):
    """The latent resized nearest by 2, 4 and 8 (each output pixel i
    reads latent pixel i // factor, exactly)."""
    rng = np.random.default_rng(factor)
    z = rng.standard_normal((2, 3, 2, 4)).astype(np.float32)
    h = rng.standard_normal((2, 3 * factor, 2 * factor, 16)).astype(
        np.float32)
    got, want = _apply_both(jmovq.SpatialNorm(jnp.float32),
                            movq.SpatialNorm(16, 4, torch.float32), [h, z])
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    z_up = torch.nn.functional.interpolate(_t(z).permute(0, 3, 1, 2),
                                           size=h.shape[1:3],
                                           mode="nearest")
    want_up = jax.image.resize(jnp.asarray(z), h.shape[:3] + (4,),
                               method="nearest")
    np.testing.assert_array_equal(z_up.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want_up))


def test_movq_decoder_matches(jax_tree, port_f32):
    z = np.random.default_rng(8).standard_normal((2, 8, 8, 4)).astype(
        np.float32)
    jmod = jmovq.MOVQDecoder(_config(JConfig, "float32").movq)
    want = np.asarray(jmod.apply({"params": jax_tree["movq"]},
                                 jnp.asarray(z)))
    with torch.no_grad():
        got = port_f32.models.movq(_t(z)).numpy()
    assert got.shape == want.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


def _float_pixels(monkeypatch, jax_tree, port, jpipe, scheduler):
    """Both pipelines' float pixels, with `decode_to_images` patched to
    the identity for this call only."""
    kw = dict(width=64, height=64, num_inference_steps=2,
              guidance_scale=GUIDANCE, scheduler=scheduler)
    with monkeypatch.context() as m:
        m.setattr(jpipeline, "decode_to_images", lambda p: p)
        m.setattr(tpipeline, "decode_to_images", lambda p: p)
        want = np.asarray(jpipe.generate(jax_tree, PROMPTS, None, SEEDS,
                                         **kw))
        got = port.generate(PROMPTS, None, SEEDS, **kw)
    return got, want


@pytest.mark.parametrize("scheduler", ["DDIM", "K_EULER_ANCESTRAL"])
def test_generate_matches_f32(monkeypatch, jax_tree, port_f32, jpipe_f32,
                              scheduler):
    got, want = _float_pixels(monkeypatch, jax_tree, port_f32, jpipe_f32,
                              scheduler)
    assert got.shape == want.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    ju = np.asarray(jax_decode(jnp.asarray(want))).astype(int)
    tu = decode_to_images(torch.from_numpy(got)).numpy().astype(int)
    diff = np.abs(ju - tu)
    print(f"{scheduler}: float pixels differ by at most "
          f"{np.abs(got - want).max() / np.abs(want).max():.2e} of their "
          f"range; uint8 on {(diff > 0).mean():.6f} of pixels, max "
          f"{diff.max()}")
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-2


def test_generate_bf16_looser(monkeypatch, jax_tree, port_f32, jpipe_f32):
    cfg = Kandinsky2Config.tiny()
    port = Kandinsky2Pipeline(cfg, tokenizer=tiny_byte_tokenizer(cfg.text),
                              device="cpu")
    port.load_params(params_from_jax(jax_tree))
    jcfg = JConfig.tiny()
    jpipe = JPipeline(jcfg, tokenizer=jax_tiny_tokenizer(jcfg.text))
    got, want = _float_pixels(monkeypatch, jax_tree, port, jpipe, "DDIM")
    _, want_f32 = _float_pixels(monkeypatch, jax_tree, port_f32, jpipe_f32,
                                "DDIM")
    own = np.abs(want - want_f32)        # the reference's own bf16 error
    diff = np.abs(got - want)
    print(f"bf16: port vs reference {diff.mean():.4f} mean, "
          f"{diff.max():.4f} max; the reference's bf16 vs float32 "
          f"{own.mean():.4f}, {own.max():.4f}")
    assert diff.mean() <= 4 * own.mean()
    assert diff.max() <= 6 * own.max()


def test_generate_uint8_run_to_run_and_batch_content_invariance(port_f32):
    """Same bytes from run to run; a sample's bytes do not depend on its
    neighbours' prompt, seed or guidance at one batch size."""
    kw = dict(width=64, height=64, num_inference_steps=2)
    a = port_f32.generate(PROMPTS, None, SEEDS, guidance_scale=GUIDANCE,
                          **kw)
    b = port_f32.generate(PROMPTS, None, SEEDS, guidance_scale=GUIDANCE,
                          **kw)
    assert a.dtype == np.uint8 and a.shape == (2, 64, 64, 3)
    np.testing.assert_array_equal(a, b)
    c = port_f32.generate([PROMPTS[0], "wolf howling"], None, [SEEDS[0], 99],
                          guidance_scale=[GUIDANCE[0], 7.0], **kw)
    np.testing.assert_array_equal(a[0], c[0])
    d = port_f32.generate(PROMPTS, None, [SEEDS[0] + 1, SEEDS[1]],
                          guidance_scale=GUIDANCE, **kw)
    assert not np.array_equal(a[0], d[0])


def test_generate_checks_inputs(port_f32):
    with pytest.raises(ValueError, match="multiples of 64"):
        port_f32.generate(["a"], None, [1], width=96, height=64)
    with pytest.raises(ValueError, match="vocab_size"):
        Kandinsky2Pipeline(Kandinsky2Config.tiny(), device="cpu").generate(
            ["a"], None, [1], width=64, height=64)
    cfg = dataclasses.replace(Kandinsky2Config.tiny(), prior=dataclasses.
                              replace(Kandinsky2Config.tiny().prior,
                                      text_len=77))
    with pytest.raises(ValueError, match="max_length"):
        Kandinsky2Pipeline(cfg, device="cpu")
