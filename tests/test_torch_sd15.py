"""The port's SD-1.5 slice against the JAX reference on the CPU, at the
tiny config: the blocks of models/common.py, the weight bridge, the text
encoder, the UNet (NHWC in and out), the VAE decoder and the whole
`generate`. Weights are the reference's own `init_params` (one jitted
init for the module), carried across by `params_from_jax`; inputs come
from numpy with a seed.

Tolerances: float32 modules agree to 5e-5 (reduction order differs
between XLA and torch); float pixels of the 2-step tiny generate agree
to 1e-4 and the uint8 images differ by at most one level on at most 0.1%
of pixels (a pixel at a rounding edge flips). The bf16 generate rounds
at different places in the two frameworks (for example whether a bias
is added before or after the product is rounded to bf16), about one
bf16 ULP per layer: its float pixels (range about +-4) are held to 0.25
with a mean difference under 0.03, and uint8 to 32 levels (measured on
this config: 0.18, 0.015 and 18).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arbius_tpu.models import common as jcommon
from arbius_tpu.models.sd15 import SD15Config as JConfig
from arbius_tpu.models.sd15 import SD15Pipeline as JPipeline
from arbius_tpu.models.sd15 import pipeline as jpipeline
from arbius_tpu.models.sd15.vae import decode_to_images as jax_decode
from arbius_tpu.node.factory import tiny_byte_tokenizer as jax_tiny_tokenizer
from arbius_tpu_torch.models import common
from arbius_tpu_torch.models.sd15 import (
    SD15Config,
    SD15Pipeline,
    decode_to_images,
    params_from_jax,
)
from arbius_tpu_torch.models.sd15 import pipeline as tpipeline
from arbius_tpu_torch.models.sd15.bridge import quant_layout
from arbius_tpu_torch.node.factory import tiny_byte_tokenizer
from test_torch_quant import check_dequantized_weights, check_output_axes

F32_TOL = 5e-5
PROMPTS = ["a lighthouse at dusk", "b"]
NEGATIVES = ["", "blurry"]
SEEDS = [1, 2**40 + 3]
GUIDANCE = [7.5, 3.0]


def _config(cls, dtype):
    tiny = cls.tiny()
    return cls(*(dataclasses.replace(c, dtype=dtype)
                 for c in (tiny.unet, tiny.vae, tiny.text)))


@pytest.fixture(scope="module")
def jax_tree():
    """The reference's tiny init (float32 parameters whatever the compute
    dtype), as nested dicts of numpy arrays."""
    pipe = JPipeline(_config(JConfig, "float32"))
    tree = jax.tree_util.tree_map(np.asarray, pipe.init_params(seed=0))

    def plain(node):
        return {k: plain(v) if hasattr(v, "items") else v
                for k, v in node.items()}

    return plain(tree)


@pytest.fixture(scope="module")
def port_f32(jax_tree):
    pipe = SD15Pipeline(_config(SD15Config, "float32"),
                        tokenizer=tiny_byte_tokenizer(
                            SD15Config.tiny().text), device="cpu")
    pipe.load_params(params_from_jax(jax_tree))
    return pipe


def _leaves(tree):
    return sum(_leaves(v) if isinstance(v, dict) else 1
               for v in tree.values())


def test_bridge_covers_every_leaf(jax_tree, port_f32):
    sd = params_from_jax(jax_tree)
    assert len(sd) == _leaves(jax_tree)
    assert set(sd) == set(port_f32.models.state_dict())
    # flax Dense [in, out] -> Linear [out, in]; Conv HWIO -> OIHW
    k = jax_tree["unet"]["conv_in"]["kernel"]
    np.testing.assert_array_equal(sd["unet.conv_in.weight"].numpy(),
                                  k.transpose(3, 2, 0, 1))
    q = jax_tree["text"]["layer_0"]["attn"]["query"]["kernel"]
    np.testing.assert_array_equal(sd["text.layer_0.attn.query.weight"]
                                  .numpy(), q.reshape(q.shape[0], -1).T)


def test_text_encoder_matches(jax_tree, port_f32):
    jpipe = JPipeline(_config(JConfig, "float32"))
    ids = np.random.default_rng(0).integers(0, 512, (2, 16)).astype(np.int32)
    want = np.asarray(jpipe.text_encoder.apply(
        {"params": jax_tree["text"]}, jnp.asarray(ids)))
    got = port_f32.models.text(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


def test_unet_matches_nhwc(jax_tree, port_f32):
    jpipe = JPipeline(_config(JConfig, "float32"))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([999.0, 10.0], np.float32)
    ctx = rng.standard_normal((2, 16, 16)).astype(np.float32)
    want = np.asarray(jpipe.unet.apply({"params": jax_tree["unet"]},
                                       jnp.asarray(x), jnp.asarray(t),
                                       jnp.asarray(ctx)))
    got = port_f32.models.unet(torch.from_numpy(x), torch.from_numpy(t),
                               torch.from_numpy(ctx)).numpy()
    assert got.shape == want.shape == (2, 8, 8, 4)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


def test_vae_decoder_matches_nhwc(jax_tree, port_f32):
    jpipe = JPipeline(_config(JConfig, "float32"))
    z = np.random.default_rng(2).standard_normal((2, 8, 8, 4)).astype(
        np.float32)
    want = np.asarray(jpipe.vae.apply({"params": jax_tree["vae"]},
                                      jnp.asarray(z)))
    got = port_f32.models.vae(torch.from_numpy(z)).numpy()
    assert got.shape == want.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


def _block_cases():
    ctx = (2, 5, 12)
    return {
        "group_norm_1e-6": (jcommon.GroupNorm32(epsilon=1e-6),
                            lambda: common.GroupNorm32(48, 1e-6),
                            [(2, 4, 4, 48)]),
        "resnet": (jcommon.ResnetBlock(24, jnp.float32),
                   lambda: common.ResnetBlock(16, 24, torch.float32, 32),
                   [(2, 4, 4, 16), (2, 32)]),
        "attention_self": (jcommon.Attention(2, 8, jnp.float32),
                           lambda: common.Attention(16, 2, 8, torch.float32),
                           [(2, 24, 16)]),
        "spatial_transformer": (
            jcommon.SpatialTransformer(2, 8, 1, jnp.float32),
            lambda: common.SpatialTransformer(16, 2, 8, 12, torch.float32),
            [(2, 4, 4, 16), ctx]),
        "downsample": (jcommon.Downsample(8, jnp.float32),
                       lambda: common.Downsample(8, torch.float32),
                       [(1, 6, 6, 8)]),
        "upsample": (jcommon.Upsample(8, jnp.float32),
                     lambda: common.Upsample(8, torch.float32),
                     [(1, 3, 3, 8)]),
    }


@pytest.mark.parametrize("name", sorted(_block_cases()))
def test_block_matches(name):
    """Each block of models/common.py, on its own flax init; NHWC maps are
    handed to the port's NCHW blocks transposed."""
    jmod, make, shapes = _block_cases()[name]
    rng = np.random.default_rng(len(name))
    args = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    variables = jmod.init(jax.random.PRNGKey(0), *map(jnp.asarray, args))
    want = np.asarray(jmod.apply(variables, *map(jnp.asarray, args)))
    block = make()
    block.load_state_dict(params_from_jax(jax.tree_util.tree_map(
        np.asarray, dict(variables["params"]))))
    targs = [torch.from_numpy(a) for a in args]
    if targs[0].dim() == 4:
        targs[0] = targs[0].permute(0, 3, 1, 2)
    with torch.no_grad():
        got = block(*targs)
    if got.dim() == 4:
        got = got.permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


def test_sinusoidal_embedding_matches():
    """exp and sin/cos may differ by an ULP between XLA and torch; at
    t = 999 an ULP of the frequency moves the argument by ~1e-4."""
    t = np.array([0.0, 1.0, 10.0, 999.0], np.float32)
    want = np.asarray(jcommon.sinusoidal_embedding(jnp.asarray(t), 320))
    got = common.sinusoidal_embedding(torch.from_numpy(t), 320).numpy()
    np.testing.assert_allclose(got[:3], want[:3], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)


def _float_pixels(monkeypatch, jax_tree, port, dtype, scheduler,
                  precision="bf16"):
    """Both pipelines' float pixels, with `decode_to_images` patched to
    the identity for this call only. In int8 or fp8 the reference runs
    its quantized program on `quantize_params(jax_tree)`."""
    jpipe = JPipeline(_config(JConfig, dtype),
                      tokenizer=jax_tiny_tokenizer(JConfig.tiny().text),
                      precision=precision)
    if precision != "bf16":
        from arbius_tpu.quant import quantize_params

        jax_tree = quantize_params(jax_tree, precision)
    kw = dict(width=64, height=64, num_inference_steps=2,
              guidance_scale=GUIDANCE, scheduler=scheduler)
    with monkeypatch.context() as m:
        m.setattr(jpipeline, "decode_to_images", lambda p: p)
        m.setattr(tpipeline, "decode_to_images", lambda p: p)
        want = np.asarray(jpipe.generate(jax_tree, PROMPTS, NEGATIVES,
                                         SEEDS, **kw))
        got = port.generate(PROMPTS, NEGATIVES, SEEDS, **kw)
    return got, want


@pytest.mark.parametrize("scheduler", ["DPMSolverMultistep",
                                       "K_EULER_ANCESTRAL"])
def test_generate_matches_f32(monkeypatch, jax_tree, port_f32, scheduler):
    got, want = _float_pixels(monkeypatch, jax_tree, port_f32, "float32",
                              scheduler)
    assert got.shape == want.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    ju = np.asarray(jax_decode(jnp.asarray(want))).astype(int)
    tu = decode_to_images(torch.from_numpy(got)).numpy().astype(int)
    diff = np.abs(ju - tu)
    print(f"{scheduler}: uint8 differs on {(diff > 0).mean():.6f} of "
          f"pixels, max {diff.max()}")
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


@pytest.mark.parametrize("precision", ["int8", "fp8"])
def test_generate_quantized_matches_reference(monkeypatch, jax_tree,
                                              precision):
    """anythingv3 in int8 and fp8 (tiny, float32 compute): the port's
    pipeline quantizes the bridged weights at load and dequantizes them
    at the start of the bucket program; the reference runs its quantized
    program. The float32 generate's tolerances hold (1e-4 on float
    pixels; uint8 one level on at most 0.1% of pixels)."""
    port = SD15Pipeline(_config(SD15Config, "float32"),
                        tokenizer=tiny_byte_tokenizer(SD15Config.tiny().text),
                        device="cpu", precision=precision)
    port.load_params(params_from_jax(jax_tree))
    assert port.quantized is not None
    got, want = _float_pixels(monkeypatch, jax_tree, port, "float32",
                              "DPMSolverMultistep", precision)
    assert got.shape == want.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    ju = np.asarray(jax_decode(jnp.asarray(want))).astype(int)
    tu = decode_to_images(torch.from_numpy(got)).numpy().astype(int)
    diff = np.abs(ju - tu)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_dequantized_weights_equal_reference_bit_for_bit(jax_tree, port_f32,
                                                         mode):
    """anythingv3 (sd15) in int8 and fp8 (tests/test_torch_quant.py (a)),
    on this module's reference tree: the reference's quantize_params and
    dequantize_tree through the bridge equal the port's dequantized
    state bit for bit, over the same quantized leaves."""
    check_dequantized_weights(jax_tree, quant_layout(port_f32.models), mode)


def test_quant_output_axis_is_where_convert_puts_the_reference_last_axis(
        jax_tree, port_f32):
    layout = quant_layout(port_f32.models)
    check_output_axes(jax_tree, layout)
    # the text tower's DenseGeneral bias [H, D] is scaled per D
    assert layout["text.layer_0.attn.query.bias"].axis == 1


def test_generate_bf16_looser(monkeypatch, jax_tree):
    port = SD15Pipeline(SD15Config.tiny(), tokenizer=tiny_byte_tokenizer(
        SD15Config.tiny().text), device="cpu")
    port.load_params(params_from_jax(jax_tree))
    got, want = _float_pixels(monkeypatch, jax_tree, port, "bfloat16",
                              "DPMSolverMultistep")
    np.testing.assert_allclose(got, want, rtol=0, atol=0.25)
    assert np.abs(got - want).mean() < 0.03
    ju = np.asarray(jax_decode(jnp.asarray(want))).astype(int)
    tu = decode_to_images(torch.from_numpy(got)).numpy().astype(int)
    assert np.abs(ju - tu).max() <= 32


def test_factory_bf16_weights_match_cast_floating(monkeypatch, jax_tree):
    """`weights_dtype: "bfloat16"`, the path the node mines and the
    golden was recorded on: the factory's runner (node/factory.py
    `_runner`) holds exactly the reference's `cast_floating` tree,
    and the two generate the same float pixels from it at float32
    compute, within the float32 generate's tolerance of 1e-4 (measured
    6.3e-6 on this config)."""
    from arbius_tpu.utils import cast_floating
    from arbius_tpu_torch.node.config import ModelConfig
    from arbius_tpu_torch.node.factory import _runner

    runner = _runner(ModelConfig(id="0x" + "00" * 32, template="anythingv3",
                                 tiny=True, weights_dtype="bfloat16"),
                     device="cpu", params=params_from_jax(jax_tree), seed=0)
    state = {k: v.float() for k, v in
             runner.pipeline.models.state_dict().items()}
    cast = jax.tree_util.tree_map(
        lambda a: np.asarray(a).astype(np.float32),
        cast_floating(jax_tree, jnp.bfloat16))
    want_state = params_from_jax(cast)
    assert state.keys() == want_state.keys()
    for k, v in state.items():
        assert torch.equal(v, want_state[k]), k

    port = SD15Pipeline(_config(SD15Config, "float32"),
                        tokenizer=tiny_byte_tokenizer(SD15Config.tiny().text),
                        device="cpu")
    port.load_params(state)
    got, want = _float_pixels(monkeypatch, cast, port, "float32",
                              "DPMSolverMultistep")
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_generate_uint8_and_run_to_run(port_f32):
    kw = dict(width=64, height=64, num_inference_steps=2,
              guidance_scale=GUIDANCE, scheduler="DPMSolverMultistep")
    a = port_f32.generate(PROMPTS, NEGATIVES, SEEDS, **kw)
    b = port_f32.generate(PROMPTS, NEGATIVES, SEEDS, **kw)
    assert a.dtype == np.uint8 and a.shape == (2, 64, 64, 3)
    np.testing.assert_array_equal(a, b)


def test_generate_checks_inputs(port_f32):
    with pytest.raises(ValueError, match="multiples of 64"):
        port_f32.generate(["a"], [""], [1], width=96, height=64)
    with pytest.raises(ValueError, match="vocab_size"):
        SD15Pipeline(SD15Config.tiny(), device="cpu").generate(
            ["a"], [""], [1], width=64, height=64)
