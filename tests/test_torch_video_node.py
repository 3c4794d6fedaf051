"""The port's video serving path on the CPU: the copied codecs (JPEG,
H.264, MP4) byte-equal to the reference's from equal frames, the port's
`Text2VideoRunner` producing the reference runner's files and cache tags
from equal frames, the factory building both video templates, and a
tiny damo task mined by the port's MinerNode on LocalChain from
TaskSubmitted through claim, its on-chain CID the one record-golden's
function gives for the same input and seed."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from arbius_tpu.codecs import encode_jpeg as ref_encode_jpeg
from arbius_tpu.codecs import encode_mp4 as ref_encode_mp4
from arbius_tpu.codecs import encode_mp4_h264 as ref_encode_mp4_h264
from arbius_tpu.models.video import Text2VideoConfig as JConfig
from arbius_tpu.models.video import Text2VideoPipeline as JPipeline
from arbius_tpu.node.solver import Text2VideoRunner as RefRunner
from arbius_tpu_torch.codecs import encode_jpeg, encode_mp4, encode_mp4_h264
from arbius_tpu_torch.models.video import Text2VideoConfig, Text2VideoPipeline
from arbius_tpu_torch.node.solver import Text2VideoRunner
from test_torch_node import MINER, MODEL_ADDR, USER, _config, _pkg


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's tiny torch ops on one thread: with the suite's
    workers sharing the host's cores, torch's per-op thread pool
    otherwise waits on oversubscribed cores at every small op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frames(seed: int, shape=(3, 32, 48, 3)) -> np.ndarray:
    """uint8 frames with smooth regions and noise (both the encoders'
    cases)."""
    rng = np.random.default_rng(seed)
    t, h, w, _ = shape
    ramp = (np.arange(h)[:, None] * 3 + np.arange(w)[None, :] * 5)
    base = (ramp[None, :, :, None] + 40 * np.arange(t)[:, None, None, None]
            + np.array([0, 60, 120]))
    noise = rng.integers(0, 24, shape)
    return ((base + noise) % 256).astype(np.uint8)


@pytest.mark.parametrize("shape", [(3, 32, 48, 3), (1, 16, 16, 3),
                                   (5, 24, 40, 3)])
@pytest.mark.parametrize("fps", [8, 24])
def test_mp4_bytes_equal_reference(shape, fps):
    frames = _frames(sum(shape) + fps, shape)
    a = encode_mp4_h264(frames, fps=fps)
    assert a == ref_encode_mp4_h264(frames, fps=fps)
    assert a[4:8] == b"ftyp"
    assert encode_mp4(frames, fps=fps) == ref_encode_mp4(frames, fps=fps)


@pytest.mark.parametrize("quality", [50, 90])
def test_jpeg_bytes_equal_reference(quality):
    frame = _frames(quality)[0]
    assert encode_jpeg(frame, quality=quality) == \
        ref_encode_jpeg(frame, quality=quality)


class _FramesPipe:
    """A stand-in pipeline returning fixed frames, as the reference's
    (numpy) or the port's (a CPU tensor), and recording its calls."""

    def __init__(self, frames, torch_out: bool):
        self.frames, self.torch_out, self.calls = frames, torch_out, []

    def generate(self, *args, **kw):
        self.calls.append(kw)
        n = len(kw["prompts"])
        out = self.frames[:n]
        return torch.from_numpy(out) if self.torch_out else out


@pytest.mark.parametrize("hydrated", [
    {"prompt": "a"},                                           # damo
    {"prompt": "a", "negative_prompt": "noisy", "num_frames": 3,
     "width": 48, "height": 32, "guidance_scale": 17.5, "fps": 24},
])
def test_runner_files_and_tags_equal_reference(hydrated):
    """From equal frames the two runners write equal MP4s (per item fps),
    pass the pipeline the same settings (the defaults filling what the
    task leaves out), and name the same bucket tag."""
    frames = np.stack([_frames(1), _frames(2)])
    items = [(hydrated, 5), ({**hydrated, "prompt": "b", "fps": 12}, 6)]
    ref_pipe, pipe = _FramesPipe(frames, False), _FramesPipe(frames, True)
    want = RefRunner(ref_pipe, params=None).run_batch(items)
    got = Text2VideoRunner(pipe).run_batch(items)
    assert got == want and set(got[0]) == {"out-1.mp4"}
    ref_kw = {k: v for k, v in ref_pipe.calls[0].items() if k != "as_device"}
    assert {k: v for k, v in pipe.calls[0].items()
            if k != "as_device"} == ref_kw
    ref_tag = RefRunner(JPipeline(JConfig.tiny()), None).cache_tag(hydrated,
                                                                   4)
    tag = Text2VideoRunner(Text2VideoPipeline(
        Text2VideoConfig.tiny(), device="cpu")).cache_tag(hydrated, 4)
    assert tag == ref_tag


@pytest.mark.parametrize("template", ["damo", "zeroscopev2xl"])
def test_factory_builds_the_video_templates(template):
    P = _pkg("arbius_tpu_torch")
    mid = "0x" + "00" * 32
    model = P.node.build_registry(_config(P, models=(P.node.ModelConfig(
        id=mid, template=template, tiny=True),)), device="cpu").get(mid)
    assert isinstance(model.runner, Text2VideoRunner)
    assert model.template.outputs[0].filename == "out-1.mp4"
    assert model.runner.pipeline.device.type == "cpu"


def test_damo_boots_with_recorded_golden_and_mines():
    """The tiny damo model on the CPU (the port's seeded init, bf16
    weights, canonical batch 2): record-golden's function records the
    self-test vector for the input and seed of a task the node will mine
    (its taskid taken from a twin world); a node boots with it, mines two
    tasks on LocalChain through reveal and claim in one padded chunk,
    and the first task's on-chain CID is the golden's."""
    from arbius_tpu_torch.cli import record_golden

    P = _pkg("arbius_tpu_torch")
    WAD = P.WAD
    raws = [{"prompt": "arbius test cat", "num_frames": 3,
             "num_inference_steps": 2},
            {"prompt": "a second clip", "num_frames": 3,
             "num_inference_steps": 2, "fps": 12}]

    def world():
        tok = P.TokenLedger()
        eng = P.Engine(tok, start_time=10_000)
        tok.mint(P.Engine.ADDRESS, 600_000 * WAD)
        for a in (MINER, USER):
            tok.mint(a, 1_000 * WAD)
            tok.approve(a, P.Engine.ADDRESS, 10**30)
        mid_b = eng.register_model(USER, MODEL_ADDR, 0, b'{"meta":{}}')
        return tok, eng, mid_b

    def submit(eng, mid_b):
        return ["0x" + eng.submit_task(USER, 0, USER, mid_b, WAD,
                                       json.dumps(raw).encode()).hex()
                for raw in raws]

    tids = submit(*world()[1:])
    tok, eng, mid_b = world()
    mid = "0x" + mid_b.hex()

    def config(golden=None):
        return _config(P, canonical_batch=2, models=(P.node.ModelConfig(
            id=mid, template="damo", tiny=True, weights_dtype="bfloat16",
            golden=golden),))

    model = P.node.build_registry(config(), device="cpu").get(mid)
    rec = record_golden(model, raws[0], P.taskid2seed(tids[0]),
                        canonical_batch=2, device="cpu")
    chain = P.node.LocalChain(eng, MINER)
    chain.validator_deposit(100 * WAD)
    cfg = config(rec["golden"])
    node = P.node.MinerNode(chain, cfg, P.node.build_registry(
        cfg, device="cpu"))
    node.boot()
    assert submit(eng, mid_b) == tids
    while node.tick():
        pass
    bal0 = tok.balance_of(MINER)
    eng.advance_time(2000 + 121)
    while node.tick():
        pass
    sols = [eng.solutions[bytes.fromhex(t[2:])] for t in tids]
    assert all(s.claimed for s in sols)
    assert "0x" + sols[0].cid.hex() == rec["golden"]["cid"]
    assert sols[1].cid != sols[0].cid
    assert tok.balance_of(MINER) - bal0 == 2 * WAD * 9 // 10


def test_chip_smoke_video_launch_rule():
    """Phase 9's launches per chunk, as ops/flash.py's rule sends the
    UNet3D's D = 64 calls (the self-attentions over more than 128 tokens
    to the wgmma route, the rest to the short one) and the VAE's D = 512
    calls over the frames, in `vae_frames_per_call` groups, to the wgmma
    wide route."""
    import chip_smoke
    from arbius_tpu_torch.ops import flash

    damo = chip_smoke.expected_launches(torch, flash, chip_smoke.DAMO_SHAPES)
    assert damo == {"tensor_core_wgmma": 500, "tensor_core_wgmma_short": 1100,
                    "tensor_core_wgmma_wide": 1, "tensor_core": 0,
                    "tensor_core_wide": 0, "cuda_core": 0}
    assert chip_smoke.DAMO_SHAPES[0] == (128, 5, 1024, 1024, 64, 250)
    assert chip_smoke.DAMO_SHAPES[-1] == (64, 1, 1024, 1024, 512, 1)
    zs = chip_smoke.expected_launches(torch, flash, chip_smoke.
                                      video_attention_shapes(1024, 576, 24, 2))
    assert zs == {"tensor_core_wgmma": 32, "tensor_core_wgmma_short": 32,
                  "tensor_core_wgmma_wide": 14, "tensor_core": 0,
                  "tensor_core_wide": 0, "cuda_core": 0}
    assert [s[2] for s in chip_smoke.ZEROSCOPE_SHAPES[:8:2]] == [
        9216, 2304, 576, 144]
    assert chip_smoke.ZEROSCOPE_SHAPES[-2:] == (
        (7, 1, 9216, 9216, 512, 13), (5, 1, 9216, 9216, 512, 1))
