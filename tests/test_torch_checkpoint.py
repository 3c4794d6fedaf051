"""The port's checkpoint files (arbius_tpu_torch/utils/checkpoint.py), its
published-file reader and `convert-checkpoint` (arbius_tpu_torch/cli.py),
and the factory booting from `ModelConfig.checkpoint`, on the CPU.

The port writes one file per model, its state_dict by `torch.save`, where
the reference writes an orbax tree; the two are held to the same weights
through the bridge (`convert-checkpoint --family robust_video_matting` at
full width through both CLIs). The `.safetensors` reader is the port's
own (the card's machine has no `safetensors` package) and is held to
that package where this host has it."""
from __future__ import annotations

import json
import pathlib

import numpy as np
import pytest
import torch

from arbius_tpu_torch.cli import _load_torch_state_dict
from arbius_tpu_torch.cli import main as port_main
from arbius_tpu_torch.models.sd15.bridge import load_weights, params_from_jax
from arbius_tpu_torch.utils import (
    cast_floating,
    load_params,
    load_safetensors,
    save_params,
)
from test_torch_node import MINER, MODEL_ADDR, USER, _config, _pkg, _task

REPO = pathlib.Path(__file__).resolve().parent.parent
CANONICAL = 2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's small torch ops on one thread (the suite's workers
    share the host's cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def state():
    """The tiny anythingv3's seeded state_dict (float32, CPU)."""
    from arbius_tpu_torch.models.sd15 import SD15Config, SD15Pipeline

    return SD15Pipeline(SD15Config.tiny(), device="cpu").init_params(seed=0)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory, state):
    path = str(tmp_path_factory.mktemp("ckpt") / "anythingv3.pt")
    save_params(path, state)
    return path


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_save_load_bit_exact(tmp_path, state, dtype):
    want = cast_floating(state, dtype)
    want["counter"] = torch.arange(5, dtype=torch.int64)
    path = str(tmp_path / "c.pt")
    save_params(path, want)
    got = load_params(path)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    assert got["counter"].dtype == torch.int64


def test_load_refuses_a_directory_and_a_non_state(tmp_path):
    with pytest.raises(ValueError, match="orbax"):
        load_params(str(tmp_path))
    torch.save([torch.zeros(2)], tmp_path / "list.pt")
    with pytest.raises(ValueError, match="state_dict"):
        load_params(str(tmp_path / "list.pt"))


@pytest.mark.parametrize("stored", [torch.float32, torch.bfloat16])
def test_weights_dtype_cast_equals_load_weights(tmp_path, state, stored):
    """A checkpoint stored in float32 or bf16, booted with weights_dtype
    bfloat16, holds exactly `load_weights` of the bf16-rounded state."""
    from arbius_tpu_torch.models.sd15 import SD15Config, SD15Pipeline
    from arbius_tpu_torch.node import ModelConfig
    from arbius_tpu_torch.node.factory import _runner

    path = str(tmp_path / "c.pt")
    save_params(path, cast_floating(state, stored))
    runner = _runner(ModelConfig(id="0x" + "00" * 32, template="anythingv3",
                                 tiny=True, weights_dtype="bfloat16",
                                 checkpoint=path),
                     device="cpu", params=None, seed=0)
    want = SD15Pipeline(SD15Config.tiny(), device="cpu")
    load_weights(want.models, {k: v.to(torch.bfloat16).to(v.dtype)
                               for k, v in state.items()}, "bf16")
    got = runner.pipeline.models.state_dict()
    for k, v in want.models.state_dict().items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("dtype", ["F32", "BF16", "F16", "I64", "I32"])
def test_safetensors_reader_equals_the_package(tmp_path, dtype):
    st = pytest.importorskip("safetensors.torch")
    tdtype = {"F32": torch.float32, "BF16": torch.bfloat16,
              "F16": torch.float16, "I64": torch.int64,
              "I32": torch.int32}[dtype]
    gen = torch.Generator().manual_seed(len(dtype))
    tensors = {"a.weight": torch.randn(3, 5, generator=gen),
               "b.bias": torch.randn(7, generator=gen),
               "c.scalar": torch.randn((), generator=gen),
               "d.empty": torch.zeros(0, 4)}
    tensors = {k: (v * 1000).to(tdtype) for k, v in tensors.items()}
    path = str(tmp_path / "w.safetensors")
    st.save_file(tensors, path, metadata={"format": "pt"})
    got, want = load_safetensors(path), st.load_file(path)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == \
            want[k].shape and torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("fmt", [".safetensors", ".bin", ".pt"])
def test_published_reader_equals_reference(tmp_path, fmt):
    """`_load_torch_state_dict` of both CLIs on one published file: bf16
    and f16 upcast to float32, integers kept, a {"state_dict": ...}
    envelope unwrapped (.bin here)."""
    from arbius_tpu.cli import _load_torch_state_dict as ref_load

    if fmt == ".safetensors":
        pytest.importorskip("safetensors.torch")
    gen = torch.Generator().manual_seed(3)
    sd = {"w": torch.randn(4, 6, generator=gen).to(torch.bfloat16),
          "h": torch.randn(5, generator=gen).to(torch.float16),
          "f": torch.randn(2, 2, generator=gen),
          "n": torch.tensor([7, 8], dtype=torch.int64)}
    path = str(tmp_path / f"w{fmt}")
    if fmt == ".safetensors":
        from safetensors.torch import save_file

        save_file(sd, path)
    else:
        torch.save({"state_dict": sd} if fmt == ".bin" else sd, path)
    got, want = _load_torch_state_dict(path), ref_load(path)
    assert got.keys() == want.keys() == sd.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and \
            np.array_equal(got[k], want[k]), k
    assert got["w"].dtype == np.float32 and got["n"].dtype == np.int64


def test_convert_checkpoint_rvm_full_width_equals_reference(tmp_path,
                                                            capsys):
    """robust_video_matting at full width (3,773,721 parameters): a
    published-format checkpoint (torch-hub envelope, an extra
    num_batches_tracked entry) through the reference's convert-checkpoint
    (an orbax tree) and the port's (one file): the same weights through
    the bridge, and the same JSON line but for the output path."""
    import jax

    from arbius_tpu.cli import main as ref_main
    from arbius_tpu.models.rvm import RVMPipeline, RVMPipelineConfig
    from arbius_tpu.models.rvm.convert import export_tree
    from arbius_tpu.utils import load_params as ref_load_params
    from test_torch_convert import _draw

    shapes = jax.eval_shape(
        lambda: RVMPipeline(RVMPipelineConfig()).init_params(seed=0))
    tree = _draw(shapes, 11)
    sd = {k: torch.from_numpy(np.asarray(v))
          for k, v in export_tree(tree).items()}
    sd["backbone.features.0.1.num_batches_tracked"] = torch.tensor(7)
    published = tmp_path / "rvm_mobilenetv3.pth"
    torch.save({"state_dict": sd}, published)

    lines = []
    for main, out in ((ref_main, tmp_path / "ref_orbax"),
                      (port_main, tmp_path / "rvm.pt")):
        assert main(["convert-checkpoint", "--family",
                     "robust_video_matting", "--weights", str(published),
                     "--out", str(out)]) == 0
        lines.append(json.loads(capsys.readouterr().out.strip()))
    assert lines[1] == {**lines[0], "out": str(tmp_path / "rvm.pt")}
    assert lines[1]["param_count"] == 3_773_721
    want = params_from_jax(jax.tree_util.tree_map(
        np.asarray, ref_load_params(str(tmp_path / "ref_orbax"))))
    got = load_params(str(tmp_path / "rvm.pt"))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == torch.float32 and torch.equal(got[k],
                                                             want[k]), k
    with pytest.raises(SystemExit, match="--weights is required"):
        port_main(["convert-checkpoint", "--family", "robust_video_matting",
                   "--out", str(tmp_path / "x.pt")])


def _mine_world(cfg_for, tasks):
    """A port world on LocalChain whose node (built by `cfg_for(mid)`)
    boots (self-test included) and mines `tasks`; returns (model,
    [(hydrated, seed)], on-chain CIDs)."""
    P = _pkg("arbius_tpu_torch")
    WAD = P.WAD
    tok = P.TokenLedger()
    eng = P.Engine(tok, start_time=10_000)
    tok.mint(P.Engine.ADDRESS, 600_000 * WAD)
    for a in (MINER, USER):
        tok.mint(a, 1_000 * WAD)
        tok.approve(a, P.Engine.ADDRESS, 10**30)
    mid_b = eng.register_model(USER, MODEL_ADDR, 0, b'{"meta":{}}')
    mid = "0x" + mid_b.hex()
    cfg = cfg_for(mid)
    registry = P.node.build_registry(cfg, device="cpu")
    chain = P.node.LocalChain(eng, MINER)
    chain.validator_deposit(100 * WAD)
    node = P.node.MinerNode(chain, cfg, registry)
    node.boot()
    tids = ["0x" + eng.submit_task(USER, 0, USER, mid_b, WAD,
                                   json.dumps(t).encode()).hex()
            for t in tasks]
    while node.tick():
        pass
    assert node.db.failed_jobs() == []
    model = registry.get(mid)
    items = [(P.hydrate_input(t, model.template), P.taskid2seed(tid))
             for t, tid in zip(tasks, tids)]
    node.close()
    return model, items, ["0x" + eng.solutions[bytes.fromhex(
        t[2:])].cid.hex() for t in tids]


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_node_booted_from_checkpoint_mines_params_cids(state, ckpt, mode):
    """A tiny anythingv3 MinerNode on LocalChain booted from the
    checkpoint file passes the self-test of a golden recorded with the
    same weights given as `params`, and commits the CIDs the `params`
    model solves, in bf16 and in int8 (the loaded file quantized as the
    params are)."""
    from arbius_tpu_torch.cli import record_golden
    from arbius_tpu_torch.node import solve_cid_batch
    from arbius_tpu_torch.node.config import PrecisionConfig

    P = _pkg("arbius_tpu_torch")
    precision = PrecisionConfig(default=mode)

    def config(mid, golden=None, **kw):
        return _config(P, canonical_batch=CANONICAL, precision=precision,
                       models=(P.node.ModelConfig(
                           id=mid, template="anythingv3", tiny=True,
                           weights_dtype="bfloat16", golden=golden, **kw),))

    mid = "0x" + "00" * 32
    by_params = P.node.build_registry(config(mid), device="cpu",
                                      params=state).get(mid)
    assert by_params.runner.pipeline.precision == mode
    raw = {"prompt": "arbius test cat", "negative_prompt": "",
           "width": 128, "height": 128, "num_inference_steps": 2}
    golden = record_golden(by_params, raw, 1337, canonical_batch=CANONICAL,
                           device="cpu")["golden"]
    model, items, onchain = _mine_world(
        lambda m: config(m, golden, checkpoint=ckpt),
        [_task(0), _task(1)])
    assert (model.runner.pipeline.quantized is not None) == (mode == "int8")
    assert [c for c, _ in solve_cid_batch(
        by_params, items, canonical_batch=CANONICAL)] == onchain


def test_example_config_checkpoint_passes_the_factory_checks(tmp_path):
    """MiningConfig.example.json's anythingv3 entry (checkpoint, bf16
    weights, clip_bpe) passes the port's factory checks given files at
    its paths, and names a file that must exist."""
    from arbius_tpu_torch.node import load_config
    from arbius_tpu_torch.node.config import ConfigError
    from arbius_tpu_torch.node.factory import _check_ported

    raw = json.loads((REPO / "MiningConfig.example.json").read_text())
    entry = next(m for m in raw["models"] if m["template"] == "anythingv3")
    assert entry["tokenizer"] == "clip_bpe" and entry["checkpoint"]
    cfg = load_config({**raw, "compile_cache_dir": None, "models": [entry]})
    with pytest.raises(ConfigError, match="not a file"):
        _check_ported(cfg.models[0], "bf16", cfg.mesh)
    for key in ("checkpoint", "vocab_path", "merges_path"):
        (tmp_path / key).write_bytes(b"")
        entry[key] = str(tmp_path / key)
    cfg = load_config({**raw, "compile_cache_dir": None, "models": [entry]})
    _check_ported(cfg.models[0], cfg.precision.mode_for("anythingv3"),
                  cfg.mesh)
