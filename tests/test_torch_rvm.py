"""The port's robust_video_matting family against the JAX reference on
the CPU, at the tiny config in float32: the bilinear resizes at the
published path's ratios, `ConvGRU`, an `InvertedResidual` with
squeeze-excite and dilation, the DeepGuidedFilter refiner, `MattingStep`
on the direct and the downsample-then-refine paths over frames carrying
the ConvGRU states, `matte`'s three output types, and the node's boot
self-test with a probe golden and no content store.

The reference's weights are drawn with numpy into its `eval_shape` tree
(kernels normal(1/sqrt(fan_in)), BatchNorm statistics and affines away
from their identity init, so every BNInf term shows); each module runs
through one jitted flax `apply` (the reference's eager apply takes tens
of seconds on the CPU), and the bridge carries the tree across.

Tolerances: resizes within 1e-6 (measured 2.4e-7 for the antialiased
shrink); modules and frames within 1e-5 (float32; conv and reduction
orders differ between XLA and torch, measured up to ~4e-7); `matte`'s
uint8 frames within one level (a value on a rounding edge may round
either way). At bf16 (the served dtype; XLA on the CPU keeps some bf16
chains in float32 where torch rounds each op), `matte` is held to the
reference's bf16 frames within one level and within twice the
reference's own bf16-versus-float32 mean difference (measured 1.3-1.4x).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arbius_tpu.models.rvm import RVMConfig as JConfig
from arbius_tpu.models.rvm import RVMPipeline as JPipeline
from arbius_tpu.models.rvm import RVMPipelineConfig as JPipelineConfig
from arbius_tpu.models.rvm import model as jmodel
from arbius_tpu_torch.models.rvm import (
    RVMConfig,
    RVMPipeline,
    RVMPipelineConfig,
)
from arbius_tpu_torch.models.rvm import model as tmodel
from arbius_tpu_torch.models.sd15.bridge import params_from_jax
from test_torch_node import MINER, _config, _pkg

RESIZE_TOL = 1e-6
F32_TOL = 1e-5
F32 = jnp.float32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's small torch ops on one thread (the suite's workers
    share the host's cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _draw(shapes, seed: int) -> dict:
    """numpy weights for an eval_shape tree: kernels normal(1/sqrt(fan
    in)), biases normal(0.1), BN scale 1 +- 0.1, mean normal(0.1), var in
    [0.5, 1.5]."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name == "kernel":
            std = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
            v = rng.normal(0, std, s.shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, s.shape)
        elif name == "scale":
            v = 1.0 + rng.normal(0, 0.1, s.shape)
        else:
            v = rng.normal(0, 0.1, s.shape)
        return v.astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(draw, shapes)

    def plain(node):
        return {k: plain(v) if hasattr(v, "items") else v
                for k, v in node.items()}

    return plain(tree)


def _flax(module, seed: int, *args):
    """(numpy params drawn for `module`, its jitted apply)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                *args))["params"]
    params = _draw(shapes, seed)
    return params, jax.jit(lambda p, *a: module.apply({"params": p}, *a))


def _port(module: torch.nn.Module, params: dict) -> torch.nn.Module:
    module.load_state_dict(params_from_jax(params), strict=True)
    return module.eval().requires_grad_(False)


def nchw(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2).contiguous()


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("src,dst", [
    ((1088, 1920), (288, 512)),    # the published shrink of a 1080p clip
    ((9, 13), (18, 26)),           # UpsamplingBlock / OutputBlock's x2
    ((288, 512), (1088, 1920)),    # the refiner's growth back
    ((32, 48), (16, 48)),          # a shrink along one axis only
])
def test_resize_matches_jax_image_resize(src, dst):
    rng = np.random.default_rng(sum(src))
    x = rng.uniform(0, 1, (1, *src, 2)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (1, *dst, 2), method="bilinear")
    got = tmodel.resize(nchw(x), dst)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=0,
                               atol=RESIZE_TOL)


def test_conv_gru_matches():
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (1, 12, 10, 6)).astype(np.float32)
    h = rng.normal(0, 0.5, (1, 12, 10, 6)).astype(np.float32)
    params, apply = _flax(jmodel.ConvGRU(6, dtype=F32), 2, x, h)
    port = _port(tmodel.ConvGRU(6, torch.float32), params)
    want = apply(params, x, h)
    got = port(nchw(x), nchw(h))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=0,
                               atol=F32_TOL)


@pytest.mark.parametrize("row", [
    (12, 5, 36, 16, True, "hardswish", 2, 2),   # SE, dilation forces stride 1
    (16, 3, 48, 16, True, "relu", 1, 1),        # SE, residual
    (8, 3, 8, 12, False, "hardswish", 2, 1),    # no expand, stride 2
])
def test_inverted_residual_matches(row):
    rng = np.random.default_rng(len(row) + row[2])
    x = rng.normal(0, 1, (1, 18, 14, row[0])).astype(np.float32)
    params, apply = _flax(jmodel.InvertedResidual(row, dtype=F32), 3, x)
    port = _port(tmodel.InvertedResidual(row, torch.float32), params)
    want = np.asarray(apply(params, x))
    got = nhwc(port(nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)


def test_refiner_matches():
    rng = np.random.default_rng(4)
    fine = rng.uniform(0, 1, (1, 48, 64, 3)).astype(np.float32)
    base = np.asarray(jax.image.resize(jnp.asarray(fine), (1, 16, 32, 3),
                                       method="bilinear"))
    fgr = rng.normal(0, 0.2, (1, 16, 32, 3)).astype(np.float32)
    pha = rng.uniform(0, 1, (1, 16, 32, 1)).astype(np.float32)
    hid = rng.normal(0, 1, (1, 16, 32, 8)).astype(np.float32)
    args = (fine, base, fgr, pha, hid)
    params, apply = _flax(jmodel.DeepGuidedFilterRefiner(8), 5, *args)
    port = _port(tmodel.DeepGuidedFilterRefiner(8), params)
    want = apply(params, *args)
    got = port(*(nchw(a) for a in args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), rtol=0,
                                   atol=F32_TOL)


@pytest.fixture(scope="module")
def tiny():
    """(reference pipeline, drawn params, the port's pipeline with them),
    tiny config in float32."""
    cfg = dataclasses.replace(JConfig.tiny(), dtype="float32")
    ref = JPipeline(JPipelineConfig(model=cfg))
    frame = jnp.zeros((1, 64, 64, 3))
    shapes = jax.eval_shape(lambda: ref.step.init(
        jax.random.PRNGKey(0), frame, ref.step.init_rec(1, 32, 32),
        (32, 32)))["params"]
    params = _draw(shapes, 6)
    port = RVMPipeline(RVMPipelineConfig(model=dataclasses.replace(
        RVMConfig.tiny(), dtype="float32")), device="cpu")
    port.load_params(params_from_jax(params))
    return ref, params, port


@pytest.mark.parametrize("hw,base", [((32, 48), None), ((64, 64), (32, 32))])
def test_matting_step_matches_over_frames(tiny, hw, base):
    """Three frames with the ConvGRU states carried, on the direct path
    and on the downsample-then-refine path."""
    ref, params, port = tiny
    step = jax.jit(lambda p, s, r: ref.step.apply({"params": p}, s, r,
                                                  base))
    rng = np.random.default_rng(hw[0])
    jrec = ref.step.init_rec(1, *(base or hw))
    trec = port.step.init_rec(1, *(base or hw))
    for _ in range(3):
        src = rng.uniform(0, 1, (1, *hw, 3)).astype(np.float32)
        jf, jp, jrec = step(params, src, jrec)
        tf, tp, trec = port.step(nchw(src), trec, base)
        np.testing.assert_allclose(nhwc(tf), np.asarray(jf), rtol=0,
                                   atol=F32_TOL)
        np.testing.assert_allclose(nhwc(tp), np.asarray(jp), rtol=0,
                                   atol=F32_TOL)
        for t, j in zip(trec, jrec):
            np.testing.assert_allclose(nhwc(t), np.asarray(j), rtol=0,
                                       atol=F32_TOL)
    assert np.asarray(jp).std() > 1e-3   # the matte is not flat


@pytest.mark.parametrize("output_type,shape", [
    ("green-screen", (3, 48, 64)), ("alpha-mask", (3, 48, 64)),
    ("foreground-mask", (3, 48, 64)),
    ("green-screen", (2, 32, 528)),   # over 512 px: shrink and refine
])
def test_matte_output_types_match(tiny, output_type, shape):
    ref, params, port = tiny
    t, h, w = shape
    assert (port.base_hw(h, w) is None) == (max(h, w) <= 512)
    video = np.random.default_rng(w).integers(0, 256, (t, h, w, 3),
                                              dtype=np.uint8)
    want = ref.matte(params, video, output_type=output_type)
    got = port.matte(video, output_type=output_type)
    assert got.dtype == np.uint8 and got.shape == want.shape
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1, diff.max()


@pytest.mark.parametrize("output_type,shape", [
    ("alpha-mask", (3, 48, 64)), ("green-screen", (2, 32, 528))])
def test_bf16_matte_within_the_reference_bf16_gap(tiny, output_type, shape):
    ref32, params, _ = tiny
    ref16 = JPipeline(JPipelineConfig(model=JConfig.tiny()))
    port = RVMPipeline(RVMPipelineConfig.tiny(), device="cpu")
    port.load_params(params_from_jax(params))
    t, h, w = shape
    video = np.random.default_rng(w).integers(0, 256, (t, h, w, 3),
                                              dtype=np.uint8)
    want16, want32 = (ref.matte(params, video, output_type=output_type)
                      .astype(int) for ref in (ref16, ref32))
    got = port.matte(video, output_type=output_type).astype(int)
    err, gap = np.abs(got - want16), np.abs(want16 - want32)
    assert err.max() <= 1 and err.mean() <= 2 * gap.mean(), \
        (err.mean(), gap.mean())


def test_input_checks():
    port = RVMPipeline(RVMPipelineConfig.tiny(), device="cpu")
    with pytest.raises(ValueError, match="output_type"):
        port.matte(np.zeros((1, 16, 16, 3), np.uint8), output_type="blue")
    with pytest.raises(ValueError, match="expected uint8"):
        port.matte(np.zeros((1, 16, 16, 3), np.float32))
    with pytest.raises(ValueError, match="multiples of 16"):
        port.matte(np.zeros((1, 24, 16, 3), np.uint8))
    assert port.base_hw(1088, 1920) == (288, 512)
    assert port.base_hw(512, 512) is None


@pytest.mark.parametrize("corrupt", [False, True])
def test_boot_self_test_with_probe_golden_and_no_store(corrupt):
    """record-golden's function records the tiny model's vector on the
    probe clip (MJPEG, resolved in memory); a node with no content store
    and no resolver boots with it, the factory making the clip from the
    golden's `probe_video`; a corrupted CID fails the self-test."""
    from arbius_tpu_torch.cli import record_golden
    from arbius_tpu_torch.node import BootError
    from arbius_tpu_torch.node.factory import probe_golden_input

    P = _pkg("arbius_tpu_torch")
    mid = "0x" + "00" * 32
    resolve, raw = probe_golden_input("2x32x32")

    def config(golden=None):
        return _config(P, canonical_batch=1, models=(P.node.ModelConfig(
            id=mid, template="robust_video_matting", tiny=True,
            weights_dtype="bfloat16", golden=golden),))

    model = P.node.build_registry(config(), device="cpu",
                                  resolve_file=resolve).get(mid)
    golden = dict(record_golden(model, raw, 1337, canonical_batch=1,
                                device="cpu")["golden"], probe_video="2x32x32")
    if corrupt:
        golden["cid"] = golden["cid"][:-1] + (
            "0" if golden["cid"][-1] != "0" else "1")
    cfg = config(golden)
    registry = P.node.build_registry(cfg, device="cpu")
    assert registry.get(mid) is not None
    node = P.node.MinerNode(P.node.LocalChain(
        P.Engine(P.TokenLedger(), start_time=0), MINER), cfg, registry)
    assert node.store is None
    if corrupt:
        with pytest.raises(BootError, match="self-test failed"):
            node.boot()
    else:
        node.boot()
    node.close()
