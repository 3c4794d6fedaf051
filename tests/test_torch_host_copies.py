"""The port keeps its own copies of the reference's host layers (L0,
codecs (PNG, JPEG, H.264 and MP4, and the input side: the MP4 demuxer,
the H.264 decoder and the probe clip), templates, tokenizer, diffusion tables, and the node's host
modules: obs, chain, config, db, store, pinners, retry, scheduler, the
JSON-RPC chain and the staged pipeline; the alert engine, fleetscope,
the fleet, simnet and the runtime witness; the checkpoint converters
and files) and imports nothing of
arbius_tpu; these tests hold each copy's output
byte-equal to its twin's, the files that are copied verbatim byte-equal
on disk, and the copied modules' text equal to their twins' once
`arbius_tpu.` reads `arbius_tpu_torch.`."""
from __future__ import annotations

import pathlib

import numpy as np
import pytest

from arbius_tpu.codecs import png as ref_png
from arbius_tpu.codecs.deflate import deflate_fixed as ref_deflate_fixed
from arbius_tpu.l0 import cid as ref_cid
from arbius_tpu.l0 import commitment as ref_commitment
from arbius_tpu.models.sd15.tokenizer import ByteTokenizer as RefTokenizer
from arbius_tpu.templates import engine as ref_engine
from arbius_tpu_torch.codecs import _native, png
from arbius_tpu_torch.codecs.deflate import deflate_fixed
from arbius_tpu_torch.l0 import cid, commitment
from arbius_tpu_torch.models.sd15.tokenizer import ByteTokenizer
from arbius_tpu_torch.templates import engine

REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures"
IPFS = sorted(FIXTURES.glob("ipfs_*.bin"))
EMPTY_DIR = "QmUNLLsPACCz1vLxQVkXqqLX5R1X345qqfHbsf67hvA3Nn"


@pytest.mark.parametrize("copy,original", [
    ("arbius_tpu_torch/csrc/codecs.cc", "native/codecs.cc"),
    ("arbius_tpu_torch/templates/data/anythingv3.json",
     "arbius_tpu/templates/data/anythingv3.json"),
    ("arbius_tpu_torch/templates/data/kandinsky2.json",
     "arbius_tpu/templates/data/kandinsky2.json"),
    ("arbius_tpu_torch/templates/data/zeroscopev2xl.json",
     "arbius_tpu/templates/data/zeroscopev2xl.json"),
    ("arbius_tpu_torch/templates/data/damo.json",
     "arbius_tpu/templates/data/damo.json"),
    ("arbius_tpu_torch/templates/data/textgen.json",
     "arbius_tpu/templates/data/textgen.json"),
    ("arbius_tpu_torch/templates/data/robust_video_matting.json",
     "arbius_tpu/templates/data/robust_video_matting.json"),
    ("arbius_tpu_torch/schedulers/diffusion.py",
     "arbius_tpu/schedulers/diffusion.py"),
    ("arbius_tpu_torch/models/sd15/tokenizer.py",
     "arbius_tpu/models/sd15/tokenizer.py"),
])
def test_verbatim_copies(copy, original):
    assert (REPO / copy).read_bytes() == (REPO / original).read_bytes()


# modules copied whole: only their imports name the port's package
RENAMED_COPIES = [
    "obs/__init__.py", "obs/journal.py", "obs/registry.py", "obs/trace.py",
    "chain/__init__.py", "chain/devnet.py", "chain/engine.py",
    "chain/fixedpoint.py", "chain/governance.py", "chain/l1token.py",
    "chain/rlp.py", "chain/rpc_client.py", "chain/token.py",
    "chain/wallet.py",
    "quant/modes.py", "templates/engine.py",
    "codecs/jpeg.py", "codecs/h264.py", "codecs/mp4.py",
    "codecs/mp4_demux.py", "codecs/h264_decode.py", "codecs/probe.py",
    "node/chain_client.py", "node/costmodel.py", "node/db.py",
    "node/pinners.py", "node/pipeline.py", "node/retry.py",
    "node/rpc.py", "node/rpc_chain.py", "node/store.py",
    "obs/healthwatch.py", "analysis/conc/witness.py",
    "sim/__init__.py", "sim/bugs.py", "sim/clock.py",
    "sim/faults.py", "sim/invariants.py", "sim/rng.py", "sim/scenario.py",
    "fleet/__init__.py", "fleet/__main__.py", "fleet/coordinator.py",
    "fleet/lease.py", "fleet/worker.py",
]

# twins whose body differs, and why (each module's docstring says how)
CHANGED_TWINS = {
    "node/node.py": "refuses unported settings at boot (a mesh layout a "
                    "family does not run on the port yet, pp, AOT cache, "
                    "perfscope); the mesh of lanes; self-test at the "
                    "canonical batch; torch.profiler",
    "cli.py": "demo-mine and record-golden on --device (the golden "
              "with its build); convert-checkpoint writes the port's "
              "one-file checkpoint from a meta-device template and reads "
              ".safetensors with its own reader; node-run on --device, "
              "paced ticks, SIGTERM and an exit summary",
    "node/config.py": "no compile cache by default; a checkpoint is one "
                      "file",
    "sim/harness.py": "refuses perfscope; the probe runs on the mesh's "
                      "lanes",
    "sim/fleet.py": "refuses aot_dir (no AOT cache)",
    "sim/cli.py": "own exit codes and parse-collect-render loop: the "
                  "lint package stays the reference's",
    "sim/__main__.py": "runs under `if __name__ == \"__main__\"` only, so "
                       "importing every module runs nothing",
    "analysis/__init__.py": "the witness only: the lint machinery stays "
                            "the reference's",
    "analysis/conc/__init__.py": "the witness only: the static conclint "
                                 "stays the reference's",
    "node/solver.py": "runners hold their pipelines' weights; results "
                      "come back through pinned memory and CUDA events; "
                      "on a dp mesh each dispatch, a whole canonical "
                      "batch, takes the next lane",
    "node/factory.py": "on a torch device; anythingv3 alone on a dp mesh "
                       "(mesh_refusal); a checkpoint is the port's one "
                       "file, loaded to the device and cast there; the "
                       "pipeline quantizes as it loads",
    "parallel/meshsolve.py": "a mesh of lanes for jax's devices; no "
                             "canonical_batch % dp gate in "
                             "check_mesh_contract, since no lane ever "
                             "runs less than a whole canonical batch; "
                             "the probes' products in a fixed order; no "
                             "trace specs",
    "parallel/mesh.py": "lanes for devices, virtual lanes set "
                        "explicitly; no abstract_mesh",
    "parallel/collectives.py": "each collective over the lanes' tensors",
    "parallel/sharding.py": "LaneSharding and Sharded for NamedSharding "
                            "and placed arrays; no DEFAULT_TP_RULES yet",
    "parallel/distributed.py": "torch.distributed over TCP, from the "
                               "ARBIUS_* environment",
    "parallel/__init__.py": "the lane mesh's exports; no abstract_mesh, "
                            "tp rules or pipeline stages",
    "models/sd15/convert.py": "plain walks over nested dicts (`_leaves`) "
                              "for jax.tree_util's; the key functions and "
                              "leaf transforms as they are",
    "models/video/convert.py": "export_tree walks `_leaves`, not "
                               "jax.tree_util",
    "models/kandinsky2/convert.py": "export_tree walks `_leaves`, not "
                                    "jax.tree_util",
    "models/rvm/convert.py": "export_tree walks `_leaves`, not "
                             "jax.tree_util; RVMConfig is the port's",
    "utils/checkpoint.py": "orbax is JAX: one torch.save file of the "
                           "state_dict, loaded memory-mapped; its own "
                           ".safetensors reader; no compile cache",
    "models/sd15/vae.py": "the flax modules rewritten in torch, NCHW "
                          "inside",
    "node/sched.py": "module docstring only: no project history",
    "obs/fleetscope.py": "module docstring only: no project history",
}


@pytest.mark.parametrize("path", RENAMED_COPIES)
def test_renamed_copies(path):
    ours = (REPO / "arbius_tpu_torch" / path).read_text()
    theirs = (REPO / "arbius_tpu" / path).read_text()
    assert ours == theirs.replace("arbius_tpu.", "arbius_tpu_torch.")


@pytest.mark.parametrize("path", sorted(CHANGED_TWINS))
def test_changed_twins_are_listed_truthfully(path):
    """A twin listed as changed really differs (else it belongs in
    RENAMED_COPIES), and is not also listed as a copy."""
    ours = (REPO / "arbius_tpu_torch" / path).read_text()
    theirs = (REPO / "arbius_tpu" / path).read_text()
    assert ours != theirs.replace("arbius_tpu.", "arbius_tpu_torch.")
    assert path not in RENAMED_COPIES


def test_chain_exports_equal_reference():
    """chain/__init__.py exports a subset of the reference's names, each
    the same kind of object, with equal constants and emission curve."""
    from arbius_tpu import chain as ref_chain
    from arbius_tpu_torch import chain

    assert set(chain.__all__) <= set(ref_chain.__all__)
    for name in chain.__all__:
        ours, theirs = getattr(chain, name), getattr(ref_chain, name)
        if isinstance(theirs, int):
            assert ours == theirs, name
        else:
            assert type(ours) is type(theirs) and \
                ours.__name__ == theirs.__name__, name
    for t in (1, 86400, 10**7, 10**9):
        assert chain.target_ts(t) == ref_chain.target_ts(t)
        for supply in (10**18, 10**22, 5 * 10**23):
            assert chain.diff_mul(t, supply) == ref_chain.diff_mul(t, supply)
            assert chain.reward(t, supply) == ref_chain.reward(t, supply)


@pytest.mark.parametrize("path", IPFS, ids=lambda p: p.name)
def test_cids_equal(path):
    data = path.read_bytes()
    assert cid.cid_onchain(data) == ref_cid.cid_onchain(data)
    files = {"out-1.png": data, "b.bin": data[::-1]}
    assert cid.cid_of_solution_files(files) == \
        ref_cid.cid_of_solution_files(files)


def test_empty_dir_cid():
    assert cid.cid_base58(cid.cid_of_solution_files({})) == EMPTY_DIR


@pytest.mark.parametrize("taskid", ["0x00", "0x1FFFFFFFFFFFF0",
                                    "0x1FFFFFFFFFFFF1", "0x" + "ff" * 32])
def test_taskid2seed_equal(taskid):
    assert commitment.taskid2seed(taskid) == ref_commitment.taskid2seed(taskid)


@pytest.mark.parametrize("addr,taskid,cid_hex", [
    ("0x" + "ab" * 20, "0x" + "cd" * 32, "0x1220" + "ee" * 32),
    ("0x" + "01" * 20, "0x" + "02" * 32, "0x1220" + "03" * 32),
    ("0x" + "01" * 20, "0x" + "02" * 32, "0x03"),
])
def test_commitment_equal(addr, taskid, cid_hex):
    got = commitment.generate_commitment_hex(addr, taskid, cid_hex)
    assert got == ref_commitment.generate_commitment_hex(addr, taskid, cid_hex)


@pytest.mark.parametrize("shape", [(7, 5, 3), (64, 64, 3)])
def test_png_bytes_equal(shape):
    rng = np.random.default_rng(shape[0])
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    img[: shape[0] // 2] = img[0]          # runs for the LZ77 matcher
    assert png.encode_png(img) == ref_png.encode_png(img)
    raw = img.tobytes()
    assert deflate_fixed(raw) == ref_deflate_fixed(raw)   # pure Python


def test_native_deflate_matches_pure_python():
    fn = _native.deflate_fixed()
    if fn is None:
        pytest.skip("no g++ to build csrc/codecs.cc")
    raw = np.random.default_rng(0).integers(0, 4, 5000, dtype=np.uint8)
    assert fn(raw.tobytes()) == deflate_fixed(raw.tobytes())


def test_hydrate_input_equal():
    raw = {"prompt": "a lighthouse", "negative_prompt": "", "width": 512,
           "height": 512, "num_inference_steps": 20, "guidance_scale": 7.5}
    ours = engine.hydrate_input(raw, engine.load_template("anythingv3"))
    ref = ref_engine.hydrate_input(raw, ref_engine.load_template("anythingv3"))
    assert ours == ref
    assert ours["scheduler"] == "DPMSolverMultistep"
    assert engine.load_template_bytes("anythingv3") == \
        ref_engine.load_template_bytes("anythingv3")
    with pytest.raises(engine.HydrationError, match="enum"):
        engine.hydrate_input({**raw, "width": 500},
                             engine.load_template("anythingv3"))


@pytest.mark.parametrize("kwargs", [{}, {"max_length": 16, "bos_id": 257,
                                         "eos_id": 258}])
def test_byte_tokenizer_ids_equal(kwargs):
    texts = ["a lighthouse at dusk", "", "ünïcödé ✓", "x" * 200]
    np.testing.assert_array_equal(ByteTokenizer(**kwargs).encode_batch(texts),
                                  RefTokenizer(**kwargs).encode_batch(texts))
