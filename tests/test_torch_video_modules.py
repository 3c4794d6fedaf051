"""The port's UNet3D (models/video/unet3d.py) against the JAX reference on
the CPU, module by module, at the tiny config in float32 with T >= 3
frames: TemporalConvLayer, TemporalSelfAttention, TemporalTransformerBlock,
TemporalTransformer (transformer_in's inner width differing from its
channels) and the whole UNet3DCondition; the weight bridge's frame-axis
conv kernels; the per-(sample, step, frame) noise; the VAE decoded in
frame groups.

Weights are drawn with numpy from a seed into the reference's parameter
tree (its shapes from `jax.eval_shape` of `init`, so no jitted init is
paid) and carried across by `params_from_jax`. Every leaf is drawn,
including the reference's zero inits (TemporalConvLayer's conv4 and
TemporalTransformer's proj_out): at those zeros the temporal branches add
nothing, and a comparison would not see them.

Tolerance: float32 within 1e-5 relative to each output's magnitude
(reduction order differs between XLA and torch), the whole UNet3D within
2e-4 (its test says why); the noise within `normal`'s rtol 2e-5
(tests/test_torch_random.py).
"""
from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arbius_tpu.models.video import unet3d as junet3d
from arbius_tpu_torch import random as trandom
from arbius_tpu_torch.models.sd15 import VAEConfig, VAEDecoder
from arbius_tpu_torch.models.video import (
    Text2VideoConfig,
    Text2VideoPipeline,
    params_from_jax,
    unet3d,
    vae_frames_per_call,
)

RTOL = 1e-5
UNET_RTOL = 2e-4
FRAMES = 3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's tiny torch ops on one thread: with the suite's
    workers sharing the host's cores, torch's per-op thread pool
    otherwise waits on oversubscribed cores at every small op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def fill(shapes, seed: int) -> dict:
    """A parameter tree of `shapes` (jax.ShapeDtypeStructs) drawn with
    numpy: kernels normal / sqrt(fan_in), norm scales 1 + 0.2 normal,
    biases and other leaves 0.1 normal, all float32."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            a = rng.standard_normal(leaf.shape) / math.sqrt(
                math.prod(leaf.shape[:-1]))
        elif name == "scale":
            a = 1 + 0.2 * rng.standard_normal(leaf.shape)
        else:
            a = 0.1 * rng.standard_normal(leaf.shape)
        return a.astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(draw, shapes)

    def plain(node):
        return {k: plain(v) if hasattr(v, "items") else v
                for k, v in node.items()}

    return plain(tree)


def _both(jmod, tmod, args, seed=0):
    """`jmod` applied to `args` with drawn parameters, and `tmod` loaded
    with the same; both outputs as numpy."""
    jargs = [jnp.asarray(a) for a in args]
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0),
                                              *jargs))["params"]
    params = fill(shapes, seed)
    want = np.asarray(jax.jit(jmod.apply)({"params": params}, *jargs))
    tmod.load_state_dict(params_from_jax(params))
    return params, want


def _close(got, want, rtol=RTOL):
    err = float(np.abs(got - want).max() / np.abs(want).max())
    assert got.shape == want.shape
    assert err <= rtol, f"largest difference {err:.2e} of the magnitude"
    return err


def _ncthw(x):
    """[B, T, H, W, C] numpy -> [B, C, T, H, W] torch."""
    return torch.from_numpy(x).permute(0, 4, 1, 2, 3)


def _bthwc(x):
    return x.permute(0, 2, 3, 4, 1).numpy()


def _video(seed, shape=(2, FRAMES, 4, 6, 16)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_temporal_conv_layer_matches():
    x = _video(1)
    tmod = unet3d.TemporalConvLayer(16, torch.float32)
    params, want = _both(junet3d.TemporalConvLayer(16, dtype=jnp.float32),
                         tmod, [x])
    assert np.abs(params["conv4"]["kernel"]).max() > 0
    with torch.no_grad():
        got = _bthwc(tmod(_ncthw(x)))
    _close(got, want)


def test_temporal_conv_kernel_bridges_to_frame_conv():
    """flax's (3, Cin, Cout) frame-axis kernel -> Conv3d [Cout, Cin, 3,
    1, 1]: tap 0 reads the previous frame, as in the reference."""
    k = np.arange(3 * 2 * 5, dtype=np.float32).reshape(3, 2, 5)
    sd = params_from_jax({"down_0_tconv_0": {"conv2": {"kernel": k}}})
    w = sd["down_0_tconv_0.conv2.weight"].numpy()
    assert w.shape == (5, 2, 3, 1, 1)
    np.testing.assert_array_equal(w[..., 0, 0], k.transpose(2, 1, 0))


@pytest.mark.parametrize("frames", [3, 5])
def test_temporal_self_attention_matches(frames):
    x = np.random.default_rng(frames).standard_normal(
        (6, frames, 16)).astype(np.float32)
    tmod = unet3d.TemporalSelfAttention(16, 2, 8, torch.float32)
    _, want = _both(junet3d.TemporalSelfAttention(2, 8, dtype=jnp.float32),
                    tmod, [x])
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    _close(got, want)


def test_temporal_transformer_block_matches():
    x = np.random.default_rng(3).standard_normal((6, FRAMES, 16)).astype(
        np.float32)
    tmod = unet3d.TemporalTransformerBlock(16, 2, 8, torch.float32)
    _, want = _both(junet3d.TemporalTransformerBlock(2, 8,
                                                     dtype=jnp.float32),
                    tmod, [x])
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    _close(got, want)


@pytest.mark.parametrize("heads,head_dim", [(2, 8), (4, 8)])
def test_temporal_transformer_matches(heads, head_dim):
    """(4, 8): inner 32 over 16 channels, as transformer_in's 512 over
    320 at full width."""
    x = _video(4)
    tmod = unet3d.TemporalTransformer(16, heads, head_dim, torch.float32)
    params, want = _both(
        junet3d.TemporalTransformer(heads, head_dim, dtype=jnp.float32),
        tmod, [x])
    assert np.abs(params["proj_out"]["kernel"]).max() > 0
    with torch.no_grad():
        got = _bthwc(tmod(_ncthw(x)))
    _close(got, want)


def test_temporal_transformer_sees_each_site_over_frames():
    """Changing one site of one frame moves, through the temporal
    attention, the other frames at that site only: frames and sites are
    not swapped."""
    x = _video(5)
    tmod = unet3d.TemporalTransformer(16, 2, 8, torch.float32)
    _both(junet3d.TemporalTransformer(2, 8, dtype=jnp.float32), tmod, [x])
    tmod.norm = torch.nn.Identity()    # the GroupNorm mixes every site
    y = x.copy()
    y[0, 0, 1, 2] += 1.0
    with torch.no_grad():
        a, b = (_bthwc(tmod(_ncthw(v))) for v in (x, y))
    moved = np.abs(a - b).max(axis=-1) > 0
    assert moved[0, :, 1, 2].all()
    moved[0, :, 1, 2] = False
    assert not moved.any()


@pytest.fixture(scope="module")
def unet_pair():
    cfg = dataclasses.replace(junet3d.UNet3DConfig.tiny(), dtype="float32")
    tcfg = dataclasses.replace(unet3d.UNet3DConfig.tiny(), dtype="float32")
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, FRAMES, 8, 8, 4)).astype(np.float32)
    t = np.array([999.0, 21.0], np.float32)
    ctx = rng.standard_normal((2, 5, 16)).astype(np.float32)
    tmod = unet3d.UNet3DCondition(tcfg)
    params, want = _both(junet3d.UNet3DCondition(cfg), tmod, [x, t, ctx])
    return tmod, params, (x, t, ctx), want


def test_unet3d_matches_with_temporal_branches_filled(unet_pair):
    """Held to UNET_RTOL of the output's magnitude, not RTOL: the
    flax-form GroupNorm's E[x^2] - E[x]^2 cancels where a group's mean
    is large against its spread, and the two packages' summation orders
    then part by up to ~1e-4 of the output on these random weights
    (measured 7e-6 to 1.1e-4 over three weight seeds and two timestep
    pairs against the op-by-op reference; 8.2e-5 here, jitted). The
    reference alone shows it: its jitted and op-by-op runs of this call
    differ by 7.0e-5 of the magnitude, and a 1e-7 relative change of its
    input moves its output by 2.2e-4."""
    tmod, params, (x, t, ctx), want = unet_pair
    assert np.abs(params["down_0_tconv_0"]["conv4"]["kernel"]).max() > 0
    with torch.no_grad():
        got = tmod(*map(torch.from_numpy, (x, t, ctx)))
    assert got.dtype == torch.float32
    err = _close(got.numpy(), want, rtol=UNET_RTOL)
    print(f"unet3d: largest difference {err:.2e} of the magnitude")


def test_unet3d_convs_take_one_sample_per_call(unet_pair, monkeypatch):
    """Each 2D convolution of the UNet3D runs one sample's frames per
    call and each frame-axis convolution one sample; the VAE's 2D
    convolutions run one frame per call."""
    tmod, _, (x, t, ctx), _ = unet_pair
    sizes = {"2d": [], "frames": []}
    conv2d, conv3d = torch.nn.Conv2d.forward, torch.nn.Conv3d.forward

    def spy2d(self, a):
        sizes["2d"].append(a.shape[0])
        return conv2d(self, a)

    def spy3d(self, a):
        sizes["frames"].append(a.shape[0])
        return conv3d(self, a)

    monkeypatch.setattr(torch.nn.Conv2d, "forward", spy2d)
    monkeypatch.setattr(torch.nn.Conv3d, "forward", spy3d)
    with torch.no_grad():
        tmod(*map(torch.from_numpy, (x, t, ctx)))
    assert set(sizes["2d"]) == {FRAMES} and set(sizes["frames"]) == {1}
    n2d = sum(isinstance(m, torch.nn.Conv2d) for m in tmod.modules())
    n3d = sum(isinstance(m, torch.nn.Conv3d) for m in tmod.modules())
    assert len(sizes["2d"]) == 2 * n2d and len(sizes["frames"]) == 2 * n3d
    sizes["2d"].clear()
    vae = Text2VideoPipeline(Text2VideoConfig.tiny(), device="cpu").models.vae
    with torch.no_grad():
        vae(torch.zeros(3, 4, 4, 4))
    assert set(sizes["2d"]) == {1}


def test_unet3d_zero_inits_are_the_reference_ones(unet_pair):
    """The reference's own init zeroes TemporalConvLayer's conv4 and
    TemporalTransformer's proj_out kernels and no other weight;
    `zero_init_keys` names those leaves of every such module in the
    UNet3D, and the pipeline's seeded init zeroes them."""
    x = _video(9)
    for jmod, zero in ((junet3d.TemporalConvLayer(16, dtype=jnp.float32),
                        {"conv4.weight"}),
                       (junet3d.TemporalTransformer(2, 8, dtype=jnp.float32),
                        {"proj_out.weight"})):
        init = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
        sd = params_from_jax(jax.tree_util.tree_map(np.asarray, dict(init)))
        assert {k for k, v in sd.items() if k.endswith(".weight")
                and not v.any()} == zero
    tmod = unet_pair[0]
    want = sorted(
        f"{name}.{'conv4' if isinstance(m, unet3d.TemporalConvLayer) else 'proj_out'}.weight"
        for name, m in tmod.named_modules()
        if isinstance(m, (unet3d.TemporalConvLayer,
                          unet3d.TemporalTransformer)))
    assert sorted(tmod.zero_init_keys()) == want and len(want) == 25
    state = Text2VideoPipeline(Text2VideoConfig.tiny(),
                               device="cpu").init_params(seed=0)
    for key in want:
        assert not state[f"unet.{key}"].any()
    assert state["unet.down_0_tconv_0.conv3.weight"].any()


def test_unet3d_refuses_sequence_parallelism():
    with pytest.raises(ValueError, match="queue 1 item 11"):
        unet3d.UNet3DConfig(sp_axis="sp")


@pytest.mark.parametrize("seed", [7, 2**40 + 3])
def test_noise_per_sample_step_and_frame_matches(seed):
    """The reference's `noise_for(tag)`: per sample key
    fold_in(PRNGKey(lo), hi), then fold_in(tag), then fold_in(frame)."""
    lo, hi = seed & 0xFFFFFFFF, seed >> 32
    shape = (4, 6, 4)

    def jnoise(tag):
        key = jax.random.fold_in(jax.random.PRNGKey(lo), hi)
        kk = jax.random.fold_in(key, tag)
        return np.asarray(jax.vmap(lambda f: jax.random.normal(
            jax.random.fold_in(kk, f), shape, jnp.float32))(
            jnp.arange(FRAMES)))

    keys = trandom.fold_in(trandom.prng_key(torch.tensor([lo, 5]), "cpu"),
                           torch.tensor([hi, 0]))
    pipe = Text2VideoPipeline(Text2VideoConfig.tiny(), device="cpu")
    for tag in (1 << 30, 0, 1):
        got = pipe.noise(keys, tag, FRAMES, shape).numpy()
        assert got.shape == (2, FRAMES, *shape)
        np.testing.assert_allclose(got[0], jnoise(jnp.int32(tag)),
                                   rtol=2e-5, atol=1e-6)


def test_vae_in_frame_groups_is_bit_equal_to_one_call(monkeypatch):
    """Decoding N frames in groups gives the bits of one call over all
    of them: every VAE operation is per frame."""
    from arbius_tpu_torch.models.video import pipeline as vpipeline

    pipe = Text2VideoPipeline(Text2VideoConfig.tiny(), device="cpu")
    pipe.load_params(pipe.init_params(seed=3))
    lat = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (7, 4, 4, 4)).astype(np.float32))
    calls = []
    pipe.models.vae.register_forward_hook(
        lambda _m, inp, _o: calls.append(inp[0].shape[0]))
    with monkeypatch.context() as m:
        m.setattr(vpipeline, "VAE_PIXELS_PER_CALL", 7 * 32 * 32)
        whole = pipe.decode(lat)
        m.setattr(vpipeline, "VAE_PIXELS_PER_CALL", 3 * 32 * 32)
        grouped = pipe.decode(lat)
    assert calls == [7, 3, 3, 1]
    assert whole.dtype == torch.uint8 and whole.shape == (7, 32, 32, 3)
    assert torch.equal(whole, grouped)


def test_vae_frames_per_call_at_the_template_buckets():
    assert vae_frames_per_call(256, 256) == 64       # damo: one call
    assert vae_frames_per_call(576, 1024) == 7       # zeroscope: 14 calls
    assert vae_frames_per_call(4096, 4096) == 1
    # the VAE is models/sd15's decoder, unchanged
    assert isinstance(Text2VideoPipeline(Text2VideoConfig.tiny(),
                                         device="cpu").models.vae,
                      VAEDecoder)
    assert Text2VideoConfig().vae == VAEConfig()
