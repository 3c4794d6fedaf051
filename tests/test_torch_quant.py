"""The port's precision modes (arbius_tpu_torch/quant/core.py and the
bridge's `quant_layout`) against the reference's quant/core.py on the
CPU, for every family that serves int8 and fp8: sd15 (anythingv3),
kandinsky2, the text-to-video UNet3D family and textgen.

(a) The reference's `quantize_params` then `dequantize_tree`, carried
    across by `params_from_jax`, equals the port's `dequantize_state` of
    its own `quantize_state(params_from_jax(tree))` key by key, bit for
    bit; the port quantizes exactly the leaves the reference does, and
    `quant_layout`'s output axis is where `_convert` puts the reference's
    last axis. `check_dequantized_weights` and `check_output_axes` hold
    these; textgen's cases are here, and sd15's, kandinsky2's and the
    video family's run in tests/test_torch_sd15.py,
    test_torch_kandinsky2.py and test_torch_video_generate.py on the
    reference trees those modules already build.
(b) Each family's int8 `generate` is bit-equal to the bf16-mode
    `generate` of a pipeline loaded with the dequantized state: the
    reference's quantized program is `dequantize_tree` followed by its
    bf16 program, which the family's own tests hold the port to.
(c) Edge cases against the reference's `quantize_params`: an all-zero
    channel, int8 half-way points, fp8 rounding midpoints and values next
    to +-448, and bf16 as the identity.

The reference's `quantize_params` is its one jitted program per tree and
mode; its `dequantize_tree` runs on the numpy leaves (`qv` to float32,
times `qs`). No tolerance: every comparison is exact.
"""
from __future__ import annotations

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from arbius_tpu.models.textgen import TextGenConfig as JTGConfig
from arbius_tpu.models.textgen import TextGenPipeline as JTGPipeline
from arbius_tpu.quant import (
    dequantize_tree,
    is_quantized_leaf as ref_is_quantized,
    quantize_params,
)
from arbius_tpu.utils import cast_floating
from arbius_tpu_torch.models.kandinsky2 import (
    Kandinsky2Config,
    Kandinsky2Pipeline,
)
from arbius_tpu_torch.models.sd15 import SD15Config, SD15Pipeline
from arbius_tpu_torch.models.sd15 import bridge
from arbius_tpu_torch.models.textgen import TextGenConfig, TextGenPipeline
from arbius_tpu_torch.models.video import Text2VideoConfig, Text2VideoPipeline
from arbius_tpu_torch.node.config import ModelConfig, TextgenConfig
from arbius_tpu_torch.node.factory import _textgen, tiny_byte_tokenizer
from arbius_tpu_torch.quant.core import (
    QuantAxis,
    QuantizedWeights,
    dequantize_leaf,
    dequantize_state,
    is_quantized_leaf,
    quantize_leaf,
    quantize_state,
    storage_dtype,
)

MODES = ("int8", "fp8")
TG_EDGES = dict(prompt_buckets=(8, 16), decode_buckets=(4, 8), top_k=4)
FAMILIES = ("sd15", "kandinsky2", "video", "textgen")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's tiny torch ops on one thread: with the suite's
    workers sharing the host's cores, torch's per-op thread pool
    otherwise waits on oversubscribed cores at every small op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port(family: str, precision: str = "bf16"):
    """The family's tiny port pipeline on the CPU (bf16 compute)."""
    if family == "textgen":
        return TextGenPipeline(TextGenConfig.tiny(), device="cpu",
                               precision=precision, **TG_EDGES)
    cls = {"sd15": (SD15Config, SD15Pipeline),
           "kandinsky2": (Kandinsky2Config, Kandinsky2Pipeline),
           "video": (Text2VideoConfig, Text2VideoPipeline)}[family]
    cfg = cls[0].tiny()
    return cls[1](cfg, tokenizer=tiny_byte_tokenizer(cfg.text),
                  device="cpu", precision=precision)


def _modules(pipe) -> torch.nn.Module:
    return pipe.model if isinstance(pipe, TextGenPipeline) else pipe.models


def _plain(tree):
    tree = jax.tree_util.tree_map(np.asarray, tree)

    def plain(node):
        return {k: plain(v) if hasattr(v, "items") else v
                for k, v in node.items()}

    return plain(tree)


def _drawn_textgen(seed: int = 0) -> dict:
    """The reference's tiny textgen tree, drawn with numpy (normal, std
    0.1; every seventh leaf's first output channel zeroed, so the scale
    floor is on the path)."""
    ref = JTGPipeline(JTGConfig.tiny(), **TG_EDGES)
    shapes = jax.eval_shape(lambda: ref.init_params(seed=0))
    rng = np.random.default_rng(seed)
    count = [0]

    def draw(leaf):
        a = (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        count[0] += 1
        if a.ndim >= 2 and count[0] % 7 == 0:
            a[..., 0] = 0.0
        return a

    return _plain(jax.tree_util.tree_map(draw, shapes))


@pytest.fixture(scope="module")
def textgen_tree():
    """(the reference's tree, the port's layout) for tiny textgen."""
    return _drawn_textgen(), bridge.quant_layout(_modules(_port("textgen")))


def _flat(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict) and not ref_is_quantized(v):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def check_dequantized_weights(tree: dict, layout: dict, mode: str) -> None:
    """(a) for one reference tree (nested dicts of float32 numpy) and the
    port's `quant_layout` of the same family: the reference's quantized
    then dequantized tree through the bridge equals the port's
    dequantized state bit for bit, and both quantize the same leaves."""
    qtree = _plain_q(quantize_params(tree, mode))
    want = bridge.params_from_jax(dequantize_tree(qtree))
    qstate = quantize_state(bridge.params_from_jax(tree), mode, layout)
    got = dequantize_state(qstate, layout)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == torch.float32, k
        assert torch.equal(got[k], want[k]), k
    # the same leaves, mapped through the bridge
    ref_keys = {bridge._convert(path, leaf["qv"])[0]
                for path, leaf in _flat(qtree) if ref_is_quantized(leaf)}
    assert {k for k, v in qstate.items() if is_quantized_leaf(v)} \
        == set(layout) == ref_keys
    for k in layout:
        assert qstate[k]["qv"].dtype == storage_dtype(mode), k
        assert qstate[k]["qs"].dtype == torch.float32, k


def _plain_q(qtree):
    """A quantized tree as nested dicts of numpy, its {"qs", "qv"} dicts
    kept (float8 values as ml_dtypes arrays)."""
    return jax.tree_util.tree_map(np.asarray, _plain(qtree))


def check_output_axes(tree: dict, layout: dict) -> None:
    """Each eligible leaf's output-channel index, carried through the
    bridge's `_convert`, is the channel `quant_layout`'s QuantAxis gives
    every element of the port's tensor."""
    seen = set()
    for path, leaf in _flat(tree):
        if leaf.ndim < 2:
            continue
        chan = np.broadcast_to(np.arange(leaf.shape[-1]), leaf.shape)
        key, ported = bridge._convert(path, chan)
        where = layout[key]
        want = np.broadcast_to(
            np.arange(where.view[where.axis]).reshape(where.scale_shape()),
            where.view).reshape(ported.shape)
        np.testing.assert_array_equal(ported, want, err_msg=key)
        seen.add(key)
    assert seen == set(layout)


@pytest.mark.parametrize("mode", MODES)
def test_dequantized_weights_equal_reference_bit_for_bit(textgen_tree,
                                                         mode):
    check_dequantized_weights(*textgen_tree, mode)


def test_output_axis_is_where_convert_puts_the_reference_last_axis(
        textgen_tree):
    check_output_axes(*textgen_tree)


def _generate(pipe):
    if isinstance(pipe, TextGenPipeline):
        return pipe.generate(["hello world", "ab"], [1, 2**40 + 3],
                             prompt_bucket=16, decode_bucket=8,
                             sampler="top_k")
    kw = dict(width=64, height=64, num_inference_steps=2,
              guidance_scale=[5.0, 2.5])
    if isinstance(pipe, Text2VideoPipeline):
        kw["num_frames"] = 2
    negatives = ["", "blurry"] if isinstance(pipe, SD15Pipeline) else None
    return pipe.generate(["a lighthouse at dusk", "b"], negatives,
                         [1, 2**40 + 3], **kw)


@pytest.mark.parametrize("name", FAMILIES)
def test_int8_generate_equals_bf16_mode_on_dequantized_state(name):
    """The int8 pipeline holds qv + qs with its eligible parameters
    emptied before and after a chunk, and generates exactly what a
    bf16-mode pipeline does on the dequantized state loaded full
    width."""
    q = _port(name, "int8")
    state = q.init_params(seed=3)
    layout = bridge.quant_layout(_modules(q))
    q.load_params(state)
    assert q.quantized.emptied()
    got = _generate(q)
    assert q.quantized.emptied()
    held = sum(t.numel() * t.element_size()
               for _, leaf, _ in q.quantized.leaves for t in leaf.values())
    assert held < sum(state[k].numel() * 2 for k in layout)  # below bf16

    full = _port(name)
    full.load_params(dequantize_state(
        quantize_state(state, "int8", layout), layout))
    want = _generate(full)
    np.testing.assert_array_equal(got, want)
    assert q.bucket_tag(*_tag_args(name)).endswith(".int8")
    assert full.bucket_tag(*_tag_args(name)) + ".int8" \
        == q.bucket_tag(*_tag_args(name))


def _tag_args(name):
    return {"textgen": (2, 16, 8, "top_k"),
            "video": (2, 2, 64, 64, 2, "DDIM")}.get(
        name, (2, 64, 64, 2, "DDIM"))


def test_factory_quantizes_after_the_weights_dtype_cast():
    """The reference factory's order: params, the `weights_dtype` cast,
    then quantize. textgen's runner in int8 over bfloat16 weights holds
    the reference's quantize_params(cast_floating(tree, bf16)) exactly."""
    tree = _drawn_textgen(seed=5)
    runner = _textgen(ModelConfig(id="0x" + "00" * 32, template="textgen",
                                  tiny=True, weights_dtype="bfloat16"),
                      TextgenConfig(prompt_buckets=(8, 16),
                                    decode_buckets=(4, 8), top_k=4,
                                    max_new_tokens=8),
                      device="cpu", params=bridge.params_from_jax(tree),
                      seed=0, precision="int8")
    pipe = runner.pipeline
    want = _plain_q(quantize_params(cast_floating(tree, jax.numpy.bfloat16),
                                    "int8"))
    params = dict(pipe.model.named_parameters())
    held = {id(p): leaf for p, leaf, _ in pipe.quantized.leaves}
    n = 0
    for path, leaf in _flat(want):
        if ref_is_quantized(leaf):
            key, qv = bridge._convert(path, leaf["qv"])
            got = held[id(params[key])]
            np.testing.assert_array_equal(got["qv"].numpy(), qv)
            np.testing.assert_array_equal(got["qs"].numpy(), leaf["qs"])
            n += 1
        else:
            key, ported = bridge._convert(path, leaf.astype(np.float32))
            np.testing.assert_array_equal(params[key].float().numpy(),
                                          ported)
    assert n == len(pipe.quantized.leaves) > 0


# -- (c) edge cases -----------------------------------------------------------

def _edge_leaf() -> np.ndarray:
    """[in 8, out 7] columns: all zero; int8 half-way points at scale 1,
    2 and 3 (a multiply by 1/3 lands 10.5 / 3 below 3.5); fp8 rounding
    midpoints at scale 1 (absmax 448); random values whose absmax lands
    w / scale just above or below 448; an absmax (0.31) whose scale
    differs between `/ bound` and the reference's `* f32(1 / bound)`."""
    w = np.zeros((8, 7), np.float32)
    w[:, 1] = [127, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -126.5]
    w[:, 2] = [254, 5.0, -7.0, 1.0, 3.0, -253.0, 0.0, 9.0]
    w[:, 3] = [381, 10.5, -10.5, 1.5, 4.5, 7.5, -370.5, 0.0]
    w[:, 4] = [448, 1.0625, 1.1875, 272, -272, 3 * 2.0 ** -10, 2.0 ** -10,
               -440]
    rng = np.random.default_rng(7)
    w[:, 5] = rng.standard_normal(8).astype(np.float32) * 1.2345678
    w[:, 6] = [0.31, -0.2, 0.1, 0.0, 0.155, -0.31, 0.3, 0.01]
    return w


def _ref_leaf(w: np.ndarray, mode: str) -> dict:
    q = quantize_params({"w": w}, mode)["w"]
    return {"qs": np.asarray(q["qs"]), "qv": np.asarray(q["qv"]),
            "deq": np.asarray(jax.jit(dequantize_tree)(q))}


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint8) if a.dtype == ml_dtypes.float8_e4m3fn else a


@pytest.mark.parametrize("mode", MODES)
def test_edge_values_quantize_to_reference_bits(mode):
    w = _edge_leaf()
    # the port stores this leaf transposed, as a Linear weight [out, in]
    where = QuantAxis((7, 8), 0)
    got = quantize_leaf(torch.from_numpy(w.T.copy()), mode, where)
    ref = _ref_leaf(w, mode)
    np.testing.assert_array_equal(got["qs"].numpy(), ref["qs"])
    qv = got["qv"].T.contiguous()
    if mode == "fp8":
        qv = qv.view(torch.uint8)
    np.testing.assert_array_equal(qv.numpy(), _bits(ref["qv"]))
    deq = dequantize_leaf(got, where).T.numpy()
    np.testing.assert_array_equal(deq, ref["deq"])
    assert (deq[:, 0] == 0).all() and np.isfinite(got["qs"].numpy()).all()
    assert not np.isnan(deq).any()
    if mode == "int8":
        # half to even at scale 1, 2 and 3 (true divisions)
        assert got["qv"][1:4, 1:4].tolist() == [[2, -4, 0], [2, -4, 0],
                                               [4, -4, 0]]
    else:
        assert qv[1:7, 4].tolist() == list(torch.tensor(
            [1.0, 1.25, 256, -256, 2.0 ** -8, 0.0],
            dtype=torch.float8_e4m3fn).view(torch.uint8).tolist())


def test_bf16_is_the_identity():
    state = {"w": torch.ones(3, 2)}
    assert quantize_state(state, "bf16", {"w": QuantAxis((3, 2), 0)}) \
        is state
    assert storage_dtype("bf16") is None
    pipe = _port("textgen")
    pipe.load_params(pipe.init_params(seed=0))
    assert pipe.quantized is None
    assert all(p.numel() > 0 for p in pipe.model.parameters())
    with pytest.raises(ValueError, match="unknown precision mode"):
        _port("textgen", "int4")


def test_layout_views_rank_three_and_flattened_leaves():
    """The leaves whose port shape hides the reference's: kandinsky2's
    rank-3 prior embeddings and top-level prior_stats (last axis), the
    DenseGeneral q/k/v kernels and 2-D biases (per head_dim), Embed's
    weight (per width, not per token), the frame-axis Conv3d (dim 0)."""
    k2 = bridge.quant_layout(_modules(_port("kandinsky2")))
    assert k2["prior.pos_embed"] == QuantAxis((1, 12, 32), 2)
    assert k2["prior.prd_embed"] == QuantAxis((1, 1, 32), 2)
    assert k2["prior_stats"] == QuantAxis((2, 16), 1)
    assert k2["text.layer_0.attn.key.weight"] == QuantAxis((2, 8, 16), 1)
    assert k2["text.layer_0.attn.key.bias"] == QuantAxis((2, 8), 1)
    assert k2["text.layer_0.attn.out.weight"] == QuantAxis((16, 16), 0)
    assert k2["text.token_embed.weight"] == QuantAxis((512, 16), 1)
    assert "text.layer_0.attn.out.bias" not in k2
    video = bridge.quant_layout(_modules(_port("video")))
    assert video["unet.down_0_tconv_0.conv1.weight"] == QuantAxis(
        (8, 8, 3, 1, 1), 0)


def test_quantized_pipeline_refuses_a_state_it_cannot_hold():
    pipe = _port("textgen", "int8")
    state = pipe.init_params(seed=0)
    with pytest.raises(KeyError, match="missing keys"):
        pipe.load_params({k: v for k, v in state.items()
                          if k != "pos_embed"})
    layout = bridge.quant_layout(pipe.model)
    with pytest.raises(ValueError, match="not quantized"):
        QuantizedWeights(pipe.model, state, layout)


def test_quantized_pipeline_inits_and_reloads():
    """Emptied parameters keep their shapes: a quantized pipeline draws the
    same seeded state as a fresh one, and loads another state over the
    first to generate what a fresh pipeline loaded with it does."""
    q = _port("textgen", "int8")
    q.load_params(q.init_params(seed=0))
    fresh = _port("textgen", "int8")
    state = fresh.init_params(seed=4)
    again = q.init_params(seed=4)
    assert again.keys() == state.keys()
    assert all(torch.equal(again[k], state[k]) for k in state)
    q.load_params(state)
    fresh.load_params(state)
    assert q.quantized.emptied()
    np.testing.assert_array_equal(_generate(q), _generate(fresh))
