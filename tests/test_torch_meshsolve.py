"""The port's meshsolve (arbius_tpu_torch/parallel/meshsolve.py) and the
mesh on its solve path: the probes, the tiny SD-1.5 on a dp mesh of
lanes, a port node booting `{"dp": 2}` and mining, simnet on a dp2 mesh,
and the refusals, on 8 virtual CPU lanes.

The reference's tier-1 tests of tests/test_meshsolve.py whose text needs
no JAX run on the port through tests/torch_ported.py (their names bound
to the port's objects). Two of the reference's change with the port's dp
semantics and are rewritten here: `check_mesh_contract` has no
canonical_batch % dp gate (each lane runs whole canonical batches), and
the tp traffic estimate reads the lanes' `Sharded` placement. The probes'
outputs are held to the reference's at mesh-off (its program jitted on
the CPU) within 1e-5: the port's column products accumulate in a fixed
order and its tanh runs in float64, so their bytes are the same at every
layout, but not XLA's to the bit.
"""
from __future__ import annotations

import json
import logging
import pathlib

import numpy as np
import pytest
import torch

from arbius_tpu_torch import parallel
from arbius_tpu_torch.node import (
    MiningConfig,
    ModelConfig,
    build_registry,
    solve_cid_batch,
)
from arbius_tpu_torch.node.config import ConfigError
from arbius_tpu_torch.node.solver import RegisteredModel
from arbius_tpu_torch.obs import Obs, use_obs
from arbius_tpu_torch.parallel import MeshSpec, meshsolve, validate_axes
from arbius_tpu_torch.templates.engine import hydrate_input, load_template
from torch_ported import parametrized_cases, renamed_definitions, run_case

REPO = pathlib.Path(__file__).resolve().parent.parent
PORTED_NAMES = (
    "test_validate_axes_unknown_axis_names_the_registry",
    "test_validate_axes_rejects_non_positive_int",
    "test_validate_axes_device_count_is_one_clear_sentence",
    "test_boot_mesh_rejects_oversized_shape",
    "test_mining_config_validates_mesh_at_load",
    "test_mining_config_accepts_mesh_layouts",
    "test_boot_mesh_publishes_device_gauge",
    "test_check_mesh_contract_rejects_unshipped_layout",
    "test_check_mesh_contract_rejects_ungoldened_axis_size",
    "test_batch_specs_shard_when_divisible_else_replicate",
    "test_estimate_and_record_collective_bytes",
    "test_record_bucket_estimate_caches_and_skips_degraded_batch",
    "test_probe_cids_identical_at_every_layout",
    "test_seq_probe_underfilled_bucket_degrades_bitwise",
    "test_simnet_clean_and_crash_restart_hold_on_dp2_mesh",
)
PORTED = renamed_definitions(
    REPO / "tests" / "test_meshsolve.py",
    PORTED_NAMES + ("_TMPL", "_items", "_cids"),
    env={"validate_axes": validate_axes, "meshsolve": meshsolve,
         "MeshSpec": MeshSpec, "MiningConfig": MiningConfig,
         "ModelConfig": ModelConfig, "ConfigError": ConfigError,
         "RegisteredModel": RegisteredModel,
         "solve_cid_batch": solve_cid_batch, "Obs": Obs, "use_obs": use_obs,
         "hydrate_input": hydrate_input, "load_template": load_template})
CASES = parametrized_cases(PORTED, list(PORTED_NAMES))
TMPL = load_template("anythingv3")
MID = "0x" + "11" * 32


@pytest.fixture(autouse=True)
def eight_lanes():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with parallel.virtual_lanes(8, "cpu"):
        yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_reference_case_on_the_port(case, request):
    _, name, params = case
    run_case(PORTED, name, request, params)


def test_ported_cases_run_the_port():
    assert PORTED.meshsolve.ShardedImageProbe.__module__ == \
        "arbius_tpu_torch.parallel.meshsolve"
    assert len(CASES) >= 25


# -- changed twins ------------------------------------------------------------

def test_check_mesh_contract_has_no_batch_gate(caplog):
    """The reference warns (image) or fails (video) when canonical_batch
    does not divide dp, since it splits a batch over dp; the port never
    splits one (each lane runs whole canonical batches), so neither
    applies: it says how the lanes take the batches instead."""
    from arbius_tpu_torch.models.sd15 import pipeline as sd15
    from arbius_tpu_torch.models.video import pipeline as video

    mesh = meshsolve.boot_mesh({"dp": 2})
    with caplog.at_level(logging.INFO, logger="arbius.meshsolve"):
        meshsolve.check_mesh_contract(mesh, {"anythingv3": sd15}, 3)
    assert not any("not divisible" in r.message for r in caplog.records)
    assert any("whole canonical batch of 3 on one lane" in r.message
               for r in caplog.records)
    mesh3 = meshsolve.boot_mesh({"dp": 2, "sp": 2, "tp": 2})
    assert video.MESH_BATCH_HARD
    meshsolve.check_mesh_contract(mesh3, {"zeroscopev2xl": video}, 3)
    with pytest.raises(ValueError, match="zeroscopev2xl"):
        meshsolve.check_mesh_contract(mesh, {"zeroscopev2xl": video}, 4)


def test_tp_estimate_counts_rule_sharded_params():
    mesh = meshsolve.boot_mesh({"dp": 2, "tp": 2})
    params = {
        "qkv": parallel.sharding_for(mesh, None, "tp").place(
            torch.zeros(8, 8)),
        "norm": parallel.replicated(mesh).place(torch.zeros(8)),
    }
    est = meshsolve.estimate_collective_bytes(mesh, (2, 8, 8), np.float32,
                                              params=params)
    # 2 (tp - 1) / tp of the 256-byte sharded slab; the norm adds nothing
    assert est == {"dp": 256, "tp": 256}
    est = meshsolve.estimate_collective_bytes(
        mesh, (2, 8, 8), torch.float32, params=params, wire_dtype=torch.int8)
    assert est["tp"] == 64


def test_factory_mesh_contracts_cover_every_mesh_family():
    from arbius_tpu_torch.node import factory

    cfg = MiningConfig(models=tuple(
        ModelConfig(id="0x" + f"{i:02x}" * 32, template=t, tiny=True)
        for i, t in enumerate(factory.TEMPLATES)))
    contracts = factory.mesh_contracts(cfg)
    assert set(contracts) == set(factory.TEMPLATES) - {
        "robust_video_matting"}
    assert all(getattr(mod, "MESH_LAYOUTS") for mod in contracts.values())


# -- the probes against the reference -------------------------------------------

def _probe_items(n):
    return [(hydrate_input({"prompt": f"mesh task {i}",
                            "negative_prompt": ""}, TMPL), 1000 + i)
            for i in range(n)]


@pytest.mark.parametrize("mode", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("probe", ["ShardedImageProbe", "ShardedSeqProbe"])
def test_probe_values_match_reference(probe, mode):
    from arbius_tpu.parallel import meshsolve as ref

    items = _probe_items(3)
    want = np.asarray(getattr(ref, probe)(mesh=None, mode=mode)
                      .dispatch(items))
    port = getattr(meshsolve, probe)
    layouts = [None, {"dp": 2}, {"dp": 2, "tp": 2}]
    if mode == "bf16":
        # a quantized sequence probe on sp lanes folds a quantized
        # allreduce in: another program (the next test)
        layouts.append({"dp": 2, "sp": 2})
    for layout in layouts:
        mesh = meshsolve.boot_mesh(layout)
        got = meshsolve.gather_canonical(port(mesh=mesh, mode=mode)
                                         .dispatch(items + items[:1]))
        np.testing.assert_allclose(got[:3], want, atol=1e-5, rtol=0)


def test_quantized_seq_probe_on_dp2_sp2_matches_reference():
    """The int8 sequence probe at dp2·sp2 folds its temporal mean through
    the quantized ring allreduce: within 1e-5 of the reference's jitted
    shard_map program on 4 devices."""
    from arbius_tpu.parallel import build_mesh as ref_build_mesh
    from arbius_tpu.parallel import MeshSpec as RefMeshSpec
    from arbius_tpu.parallel import meshsolve as ref

    import jax

    items = _probe_items(4)
    seeds = meshsolve.ShardedSeqProbe()._seeds(items)
    ref_mesh = ref_build_mesh(RefMeshSpec(dp=2, sp=2),
                              devices=jax.devices()[:4])
    from arbius_tpu.quant import quantize_leaf

    params = quantize_leaf(meshsolve._probe_params(), "int8")
    want = np.asarray(ref.build_seq_probe_fn(ref_mesh, 4, mode="int8")(
        params, seeds))
    got = meshsolve.gather_canonical(meshsolve.ShardedSeqProbe(
        mesh=meshsolve.boot_mesh({"dp": 2, "sp": 2}), mode="int8")
        .dispatch(items))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# -- SD-1.5 on a dp mesh ----------------------------------------------------------

def _sd15_items(n):
    return [(hydrate_input({"prompt": f"a lighthouse {i}",
                            "negative_prompt": "", "width": 128,
                            "height": 128, "num_inference_steps": 2,
                            "scheduler": "DDIM",
                            "guidance_scale": 5 + i}, TMPL), 300 + i)
            for i in range(n)]


def _model(mesh=None, canonical_batch=2, golden=None):
    cfg = MiningConfig(canonical_batch=canonical_batch, mesh=mesh,
                       compile_cache_dir=None,
                       models=(ModelConfig(id=MID, template="anythingv3",
                                           tiny=True, golden=golden),))
    return cfg, build_registry(cfg, device="cpu")


def test_tiny_sd15_dp2_equals_mesh_off_byte_for_byte():
    """The tiny SD-1.5 on a dp2 mesh: every chunk of the canonical batch
    runs whole on one lane, the lanes in turn, so five tasks (three
    chunks, the last padded) give mesh-off's CIDs; the pipeline's lanes
    give mesh-off's images."""
    items = _sd15_items(5)
    _, off = _model()
    _, dp2 = _model({"dp": 2})
    runner = dp2.get(MID).runner
    assert runner.dp == 2 and runner.pipeline.mesh.shape["dp"] == 2
    want = solve_cid_batch(off.get(MID), items, canonical_batch=2)
    got = solve_cid_batch(dp2.get(MID), items, canonical_batch=2)
    assert [c for c, _ in got] == [c for c, _ in want]
    assert len({c for c, _ in want}) == 5
    assert runner._lane == 1   # three dispatches: lanes 0, 1, 0
    kw = dict(width=128, height=128, num_inference_steps=2,
              scheduler="DDIM")
    images = [off.get(MID).runner.pipeline.generate(
        ["a", "b"], ["", ""], [1, 2], **kw)] + [
        runner.pipeline.generate(["a", "b"], ["", ""], [1, 2], lane=lane,
                                 **kw) for lane in (0, 1)]
    for img in images[1:]:
        np.testing.assert_array_equal(img, images[0])
    placed = runner.pipeline.place_params(
        runner.pipeline.init_params(seed=0))
    assert all(v.sharding.spec == () for v in placed.values())


@pytest.mark.parametrize("pipeline", [False, True])
def test_port_node_boots_dp2_and_mines(pipeline):
    """A port MinerNode with mesh {"dp": 2}: the boot self-test passes
    against a golden recorded mesh-off, the node mines six tasks on
    LocalChain through commit and reveal (serially, or through the staged
    pipeline, whose chunks take the lanes in turn too), and each on-chain
    CID equals the mesh-off solve of the same input and taskid2seed."""
    from arbius_tpu_torch.node.config import PipelineConfig
    from arbius_tpu_torch.chain import WAD, Engine, TokenLedger
    from arbius_tpu_torch.cli import record_golden
    from arbius_tpu_torch.l0 import taskid2seed
    from arbius_tpu_torch.node import LocalChain, MinerNode

    raw = {"prompt": "arbius test cat", "negative_prompt": "",
           "width": 128, "height": 128, "num_inference_steps": 2}
    _, off = _model()
    golden = record_golden(off.get(MID), raw, 1337, canonical_batch=2,
                           device="cpu")["golden"]
    miner, user = "0x" + "aa" * 20, "0x" + "01" * 20
    tok = TokenLedger()
    eng = Engine(tok, start_time=0)
    tok.mint(Engine.ADDRESS, 600_000 * WAD)
    for a in (miner, user):
        tok.mint(a, 1000 * WAD)
        tok.approve(a, Engine.ADDRESS, 10**30)
    mid_b = eng.register_model(user, user, 0, b'{"meta":{}}')
    mid = "0x" + mid_b.hex()
    chain = LocalChain(eng, miner)
    chain.validator_deposit(100 * WAD)
    cfg = MiningConfig(canonical_batch=2, mesh={"dp": 2},
                       compile_cache_dir=None,
                       pipeline=PipelineConfig(enabled=pipeline),
                       models=(ModelConfig(id=mid, template="anythingv3",
                                           tiny=True, golden=golden),))
    node = MinerNode(chain, cfg, build_registry(cfg, device="cpu"))
    node.boot()
    assert node.solve_layout == "dp2" and node.mesh.shape["dp"] == 2
    assert node.obs.registry.gauge("arbius_mesh_devices").value() == 2.0
    inputs = [h for h, _ in _sd15_items(6)]
    tids = ["0x" + eng.submit_task(
        user, 0, user, mid_b, 0, json.dumps(
            {k: v for k, v in h.items() if k != "seed"},
            sort_keys=True).encode()).hex() for h in inputs]
    while node.tick():
        pass
    assert node.db.failed_jobs() == []
    onchain = ["0x" + eng.solutions[bytes.fromhex(t[2:])].cid.hex()
               for t in tids]
    want = solve_cid_batch(off.get(MID), [
        (h, taskid2seed(t)) for h, t in zip(inputs, tids)],
        canonical_batch=2)
    assert onchain == [c for c, _ in want]
    # the self-test and three chunks: lanes 0, 1, 0, 1
    assert node.registry.get(mid).runner._lane == 0
    node.close()


# -- refusals ----------------------------------------------------------------------

@pytest.mark.parametrize("template,mesh", [
    ("anythingv3", {"dp": 2, "tp": 2}), ("anythingv3", {"pp": 2}),
    ("kandinsky2", {"dp": 2}), ("textgen", {"dp": 2}),
    ("damo", {"dp": 2, "sp": 2, "tp": 2})])
def test_unported_layouts_refused_with_item_11(template, mesh):
    cfg = MiningConfig(mesh=mesh, compile_cache_dir=None, models=(
        ModelConfig(id=MID, template=template, tiny=True),))
    with pytest.raises(ConfigError, match="ROADMAP queue 1 item 11\\)"):
        build_registry(cfg, device="cpu")


def test_boot_mesh_refuses_more_than_the_lanes_it_sees():
    """Lanes beyond the host's devices exist only where a caller set
    them: with two virtual lanes dp=4 is refused with the reference's
    sentence, and without any a dp=2 mesh on the CPU is."""
    with parallel.virtual_lanes(2, "cpu"):
        assert meshsolve.boot_mesh({"dp": 2}).devices == (
            torch.device("cpu"),) * 2
        with pytest.raises(ValueError, match="needs 4 devices but jax "
                                             "sees 2"):
            meshsolve.boot_mesh({"dp": 4})
    parallel.set_virtual_lanes(None)
    try:
        with pytest.raises(ValueError, match="needs 2 devices but jax "
                                             "sees 1"):
            meshsolve.boot_mesh({"dp": 2}, device="cpu")
    finally:
        parallel.set_virtual_lanes(8, "cpu")
