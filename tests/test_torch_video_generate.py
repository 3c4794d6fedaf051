"""The port's whole text-to-video `generate` (models/video/pipeline.py)
against the JAX reference's on the CPU, at the tiny config, 4 frames at
64x64, 2 DDIM steps, guidance per sample: the text tower, the noise keyed
by (sample, step, frame), the [uncond; cond] guidance batch, the UNet3D
loop, the VAE over the B*T frames and the uint8 conversion.

Weights: the reference's parameter tree drawn with numpy from a seed
(tests/test_torch_video_modules.py `fill`, every leaf including the
temporal zero inits), bridged by `params_from_jax`.

Tolerances. Float32: the float pixels within 1e-4 of their largest
magnitude, and the uint8 frames within one level on at most 1% of
pixels. bf16 rounds at different places in the two frameworks (XLA on
the CPU keeps fused elementwise chains in float32): the port's bf16
pixels are held to the reference's bf16 ones within 4x the reference's
own bf16-versus-float32 mean difference and 6x its largest, the factors
tests/test_torch_kandinsky2.py uses.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arbius_tpu.models.sd15.vae import decode_to_images as jax_decode
from arbius_tpu.models.video import Text2VideoConfig as JConfig
from arbius_tpu.models.video import Text2VideoPipeline as JPipeline
from arbius_tpu.models.video import pipeline as jpipeline
from arbius_tpu.node.factory import tiny_byte_tokenizer as jax_tiny_tokenizer
from arbius_tpu_torch.models.sd15 import decode_to_images
from arbius_tpu_torch.models.video import (
    Text2VideoConfig,
    Text2VideoPipeline,
    params_from_jax,
)
from arbius_tpu_torch.models.video import pipeline as tpipeline
from arbius_tpu_torch.node.factory import tiny_byte_tokenizer
from test_torch_video_modules import fill

PROMPTS = ["a rocket over the sea", "b"]
NEGATIVES = ["", "blurry"]
SEEDS = [7, 2**40 + 3]
GUIDANCE = [9.0, 4.0]
KW = dict(num_frames=4, width=64, height=64, num_inference_steps=2,
          scheduler="DDIM")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's tiny torch ops on one thread: with the suite's
    workers sharing the host's cores, torch's per-op thread pool
    otherwise waits on oversubscribed cores at every small op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(cls, dtype):
    r = dataclasses.replace
    cfg = cls.tiny()
    return r(cfg, unet=r(cfg.unet, dtype=dtype), vae=r(cfg.vae, dtype=dtype),
             text=r(cfg.text, dtype=dtype))


def _jpipe(dtype):
    cfg = _config(JConfig, dtype)
    return JPipeline(cfg, tokenizer=jax_tiny_tokenizer(cfg.text))


def _port(dtype, tree):
    cfg = _config(Text2VideoConfig, dtype)
    pipe = Text2VideoPipeline(cfg, tokenizer=tiny_byte_tokenizer(cfg.text),
                              device="cpu")
    pipe.load_params(params_from_jax(tree))
    return pipe


@pytest.fixture(scope="module")
def tree():
    shapes = jax.eval_shape(lambda: _jpipe("float32").init_params(seed=0))
    return fill(shapes, seed=11)


@pytest.fixture(scope="module")
def pixels(tree):
    """Float pixels [B, T, H, W, 3] of both packages in float32 and bf16
    (`decode_to_images` made the identity for these runs)."""
    out = {}
    mp = pytest.MonkeyPatch()
    mp.setattr(jpipeline, "decode_to_images", lambda p: p)
    mp.setattr(tpipeline, "decode_to_images", lambda p: p)
    try:
        for dtype in ("float32", "bfloat16"):
            jparams = jax.tree_util.tree_map(jnp.asarray, tree)
            out["ref", dtype] = np.asarray(_jpipe(dtype).generate(
                jparams, PROMPTS, NEGATIVES, SEEDS,
                guidance_scale=GUIDANCE, **KW))
            out["port", dtype] = _port(dtype, tree).generate(
                PROMPTS, NEGATIVES, SEEDS, guidance_scale=GUIDANCE, **KW)
    finally:
        mp.undo()
    return out


def test_generate_matches_f32(pixels):
    got, want = pixels["port", "float32"], pixels["ref", "float32"]
    assert got.shape == want.shape == (2, 4, 64, 64, 3)
    scale = np.abs(want).max()
    err = np.abs(got - want).max() / scale
    ju = np.asarray(jax_decode(jnp.asarray(want))).astype(int)
    tu = decode_to_images(torch.from_numpy(got)).numpy().astype(int)
    diff = np.abs(ju - tu)
    print(f"float32: pixels (range +-{scale:.2f}) differ by at most "
          f"{err:.2e} of it; uint8 on {(diff > 0).mean():.6f} of pixels, "
          f"max {diff.max()}")
    assert err <= 1e-4
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-2
    # the frames of a sample differ: the per-frame noise reached them
    assert not np.array_equal(tu[0, 0], tu[0, 1])


def test_generate_bf16_looser(pixels):
    got, want = pixels["port", "bfloat16"], pixels["ref", "bfloat16"]
    own = np.abs(want - pixels["ref", "float32"])
    diff = np.abs(got - want)
    print(f"bf16: port vs reference {diff.mean():.4f} mean, "
          f"{diff.max():.4f} max; the reference's bf16 vs float32 "
          f"{own.mean():.4f}, {own.max():.4f}")
    assert diff.mean() <= 4 * own.mean()
    assert diff.max() <= 6 * own.max()


def test_generate_uint8_run_to_run_and_batch_content_invariance(tree):
    """Same bytes from run to run; a sample's frames do not depend on
    its neighbour's prompt, seed or guidance at one batch size; another
    seed gives other frames."""
    pipe = _port("float32", tree)
    a = pipe.generate(PROMPTS, NEGATIVES, SEEDS, guidance_scale=GUIDANCE,
                      **KW)
    assert a.dtype == np.uint8 and a.shape == (2, 4, 64, 64, 3)
    np.testing.assert_array_equal(
        a, pipe.generate(PROMPTS, NEGATIVES, SEEDS, guidance_scale=GUIDANCE,
                         **KW))
    c = pipe.generate([PROMPTS[0], "a wolf"], [NEGATIVES[0], "dark"],
                      [SEEDS[0], 99], guidance_scale=[GUIDANCE[0], 2.0],
                      **KW)
    np.testing.assert_array_equal(a[0], c[0])
    d = pipe.generate(PROMPTS, NEGATIVES, [SEEDS[0] + 1, SEEDS[1]],
                      guidance_scale=GUIDANCE, **KW)
    assert not np.array_equal(a[0], d[0])


def test_generate_checks_inputs(tree):
    pipe = _port("float32", tree)
    with pytest.raises(ValueError, match="multiples of 64"):
        pipe.generate(["a"], None, [1], width=96, height=64, num_frames=2)
    with pytest.raises(ValueError, match="align"):
        pipe.generate(["a", "b"], None, [1], num_frames=2, width=64,
                      height=64)
    with pytest.raises(ValueError, match="vocab_size"):
        Text2VideoPipeline(Text2VideoConfig.tiny(), device="cpu").generate(
            ["a"], None, [1], width=64, height=64, num_frames=2)
    with pytest.raises(ValueError, match="context_dim"):
        Text2VideoPipeline(dataclasses.replace(
            Text2VideoConfig.tiny(), text=Text2VideoConfig().text),
            device="cpu")
