"""simnet on the port (arbius_tpu_torch/sim/, with its healthwatch, witness
and fleet) against the reference's, on the CPU.

The module-scoped `matrix` fixture runs the port's acceptance matrix once:
every scenario of TIER1_MATRIX at seeds 1 and 2 with the runtime witness
and the alert engine on, plus one run per scenario of the synchronous
default (pipeline, witness and alerts off), as tests/test_sim.py does; and
the reference's harness once per scenario at seed 1 with the same flags.
Every port run must hold SIM101-113 with zero findings, and each
scenario's `summarize` JSON at seed 1 must equal the reference's byte for
byte. Then each injected bug of a single node must fail exactly its
rule, the CLI keeps the 0/1/2 exit contract, and the harness refuses the
settings whose modules the port lacks. The fleet half (SIM111, SIM112,
the flood) is tests/test_torch_sim_fleet.py."""
from __future__ import annotations

import dataclasses
import json

import pytest

from arbius_tpu.sim import harness as ref_harness
from arbius_tpu.sim import invariants as ref_invariants
from arbius_tpu.sim import scenario as ref_scenario
from arbius_tpu_torch.sim.cli import main as sim_main
from arbius_tpu_torch.sim.harness import SimHarness, run_scenario
from arbius_tpu_torch.sim.invariants import (
    check_all,
    classify_tasks,
    summarize,
)
from arbius_tpu_torch.sim.scenario import (
    SCENARIOS,
    TIER1_MATRIX,
    get_scenario,
)

SEEDS = (1, 2)


@pytest.fixture(scope="module")
def matrix(tmp_path_factory):
    """(scenario, seed) -> (harness, result, findings) for the port's
    matrix, (scenario, "sync") for its synchronous-default runs, and
    (scenario, "reference") -> the reference's summary JSON at seed 1."""
    base = tmp_path_factory.mktemp("simnet")
    out = {}
    for name in TIER1_MATRIX:
        for seed in SEEDS:
            h = SimHarness(get_scenario(name), seed,
                           db_path=str(base / f"{name}-{seed}.sqlite"),
                           witness=True, healthwatch=True)
            result = h.run()
            out[(name, seed)] = (h, result, check_all(result))
        h = SimHarness(get_scenario(name), SEEDS[0],
                       db_path=str(base / f"{name}-sync.sqlite"),
                       pipeline=False)
        result = h.run()
        out[(name, "sync")] = (h, result, check_all(result))
        ref = ref_harness.SimHarness(
            ref_scenario.get_scenario(name), SEEDS[0],
            db_path=str(base / f"{name}-reference.sqlite"),
            witness=True, healthwatch=True).run()
        assert not ref_invariants.check_all(ref), name
        out[(name, "reference")] = json.dumps(
            ref_invariants.summarize(ref), sort_keys=True)
    return out


def _raised(result):
    return sorted({e["alert"] for e in result.journal_events
                   if e.get("kind") == "alert_transition"})


def _cids(result):
    return {"0x" + t.hex(): "0x" + s.cid.hex()
            for t, s in result.engine.solutions.items()}


# -- the acceptance matrix -------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", TIER1_MATRIX)
def test_scenario_matrix_holds_every_invariant(matrix, name, seed):
    _, result, findings = matrix[(name, seed)]
    assert not findings, (
        "invariant violations:\n  "
        + "\n  ".join(f.text() for f in findings)
        + f"\nreproduce byte-identically with: {result.repro()}")
    assert result.quiescent
    assert set(classify_tasks(result)) == set(result.tasks)


@pytest.mark.parametrize("name", TIER1_MATRIX)
def test_summary_equals_reference(matrix, name):
    """The port's run of the scenario at seed 1 (witness and alerts on)
    summarizes to the reference's JSON byte for byte: every task's
    terminal label, the fault counts, rounds, restarts and stakes."""
    _, result, _ = matrix[(name, SEEDS[0])]
    assert json.dumps(summarize(result), sort_keys=True) == \
        matrix[(name, "reference")]
    assert result.repro() == (f"python -m arbius_tpu_torch.sim --scenario "
                              f"{name} --seed {SEEDS[0]} --tasks "
                              f"{result.scenario.tasks}")


@pytest.mark.parametrize("name", TIER1_MATRIX)
def test_sync_default_path_holds_every_invariant(matrix, name):
    _, result, findings = matrix[(name, "sync")]
    assert not result.pipeline_enabled
    assert not findings, "\n  ".join(f.text() for f in findings)
    assert result.quiescent
    assert not [e for e in result.journal_events
                if e.get("kind") == "pipeline_stage"]


@pytest.mark.parametrize("name", TIER1_MATRIX)
def test_pipeline_and_sync_reach_identical_cids(matrix, name):
    """Same scenario and seed, both schedules: every accepted solution's
    CID is identical. The piped run has the witness and the alert engine
    on, the sync run neither, so both are bookkeeping only."""
    _, piped, _ = matrix[(name, SEEDS[0])]
    _, sync, _ = matrix[(name, "sync")]
    assert piped.witness_report is not None and sync.witness_report is None
    assert piped.healthwatch_enabled and not sync.healthwatch_enabled
    ours, theirs = _cids(piped), _cids(sync)
    shared = set(ours) & set(theirs)
    assert shared and all(ours[t] == theirs[t] for t in shared)
    if name == "clean":
        assert ours == theirs


def test_witness_observes_the_matrix_without_findings(matrix):
    from arbius_tpu_torch.analysis.conc.witness import order_cycle

    for name in TIER1_MATRIX:
        _, result, _ = matrix[(name, SEEDS[0])]
        rep = result.witness_report
        assert rep is not None and rep["locks"], name
        assert "NodeDB._lock" in {lk["lock"] for lk in rep["locks"]}, name
        assert order_cycle(rep) is None, (name, rep["order_edges"])
        assert rep["attr_writes"] == [], name


def test_clean_scenario_claims_everything(matrix):
    _, result, findings = matrix[("clean", 1)]
    assert not findings
    assert set(classify_tasks(result).values()) == {"claimed"}
    assert result.plane.fault_counts == {}


def test_faulty_scenarios_actually_inject(matrix):
    for name in ("rpc-flap", "pin-fail", "reorg"):
        for seed in SEEDS:
            _, result, _ = matrix[(name, seed)]
            assert sum(result.plane.fault_counts.values()) > 0, (name, seed)


def test_crash_restart_recovers_from_checkpoint(matrix):
    _, result, findings = matrix[("crash-restart", 1)]
    assert not findings
    assert result.restarts == 1 and result.plane.crash_seqs
    crash_seq = result.plane.crash_seqs[0]
    pre = [r for r in result.plane.audit[:crash_seq]
           if r.ok and r.method == "signalCommitment"
           and r.sender == result.miner_address]
    post_reveals = {("0x" + r.values[0].hex(), "0x" + r.values[1].hex())
                    for r in result.plane.audit[crash_seq:]
                    if r.ok and r.method == "submitSolution"
                    and r.sender == result.miner_address}
    crossed = [c for c in (result.plane.commitments[r.values[0]]
                           for r in pre) if (c[1], c[2]) in post_reveals]
    assert crossed, "no pre-crash commitment was revealed after restart"
    assert set(classify_tasks(result).values()) == {"claimed"}


def test_contested_scenario_slashes_the_adversary(matrix):
    from arbius_tpu_torch.chain.fixedpoint import WAD
    from arbius_tpu_torch.sim.harness import EVIL

    _, result, findings = matrix[("contested", 1)]
    assert not findings
    evil_tasks = [tid for tid, f in result.tasks.items() if f.evil]
    assert evil_tasks
    labels = classify_tasks(result)
    for tid in evil_tasks:
        assert labels[tid] == "contested_resolved"
        assert result.engine.contestations[
            bytes.fromhex(tid[2:])].finish_start_index > 0
    assert result.engine.validators[EVIL].staked < 200 * WAD


def test_reports_are_byte_identical_per_seed(matrix, tmp_path):
    _, cached, _ = matrix[("rpc-flap", 1)]
    fresh = run_scenario(get_scenario("rpc-flap"), 1,
                         db_path=str(tmp_path / "fresh.sqlite"))
    a = json.dumps(summarize(cached), sort_keys=True)
    assert a == json.dumps(summarize(fresh), sort_keys=True)
    _, other_seed, _ = matrix[("rpc-flap", 2)]
    assert a != json.dumps(summarize(other_seed), sort_keys=True)


def test_fault_plane_counts_into_ambient_obs(matrix):
    h, result, _ = matrix[("pin-fail", 1)]
    counter = h.node.obs.registry.counter(
        "arbius_sim_faults_total", labelnames=("kind",))
    assert counter.value(kind="pin_fail") == \
        result.plane.fault_counts["pin_fail"] > 0


# -- healthwatch: fault -> alert coverage (SIM113) --------------------------

def test_healthwatch_matrix_coverage_is_nondegenerate(matrix):
    assert _raised(matrix[("clean", SEEDS[0])][1]) == []
    expect = {"rpc-flap": "rpc_degraded", "pin-fail": "pin_degraded",
              "reorg": "chain_replay", "crash-restart": "crash_recovered",
              "contested": "contention", "chaos": "job_quarantine"}
    for name, alert in expect.items():
        for seed in SEEDS:
            _, result, _ = matrix[(name, seed)]
            assert result.healthwatch_enabled
            assert alert in _raised(result), (name, seed, _raised(result))


def test_healthwatch_transitions_walk_the_state_machine(matrix):
    _, result, _ = matrix[("pin-fail", SEEDS[0])]
    walks: dict[str, list] = {}
    for ev in result.journal_events:
        if ev.get("kind") == "alert_transition":
            walks.setdefault(ev["alert"], []).append(ev)
    assert walks
    for alert, evs in walks.items():
        state = "ok"
        for ev in evs:
            assert ev["prev"] == state and ev["state"] != ev["prev"], \
                (alert, ev)
            state = ev["state"]


def test_healthwatch_off_runs_skip_sim113(tmp_path):
    from arbius_tpu_torch.sim.bugs import SilentFaultMinerNode

    result = run_scenario(get_scenario("rpc-flap").with_tasks(3), 0,
                          db_path=str(tmp_path / "off.sqlite"),
                          node_cls=SilentFaultMinerNode)
    assert not result.healthwatch_enabled
    assert not [f for f in check_all(result) if f.rule == "SIM113"]


# -- injected bugs: each fails exactly its rule -----------------------------

def _double_commit(tmp_path):
    from arbius_tpu_torch.sim.bugs import DoubleCommitMinerNode

    return run_scenario(get_scenario("clean").with_tasks(4), 0,
                        db_path=str(tmp_path / "bug.sqlite"),
                        node_cls=DoubleCommitMinerNode)


def _racy_counter(tmp_path):
    from arbius_tpu_torch.sim.bugs import RacyCounterMinerNode

    return run_scenario(get_scenario("clean").with_tasks(3), 0,
                        db_path=str(tmp_path / "racy.sqlite"),
                        node_cls=RacyCounterMinerNode, witness=True)


def _silent_fault(tmp_path):
    from arbius_tpu_torch.sim.bugs import SilentFaultMinerNode

    return run_scenario(get_scenario("rpc-flap"), 0,
                        db_path=str(tmp_path / "silent.sqlite"),
                        node_cls=SilentFaultMinerNode, healthwatch=True)


@pytest.mark.parametrize("run,rule,says", [
    (_double_commit, "SIM103", "double-commit"),
    (_racy_counter, "SIM110", "NO witnessed lock"),
    (_silent_fault, "SIM113", "silent"),
], ids=["double-commit", "racy-counter", "silent-fault"])
def test_injected_bug_fails_exactly_its_rule(tmp_path, run, rule, says):
    result = run(tmp_path)
    findings = check_all(result)
    assert findings, f"{rule}: the injected bug went uncaught"
    assert {f.rule for f in findings} == {rule}, \
        "\n".join(f.text() for f in findings)
    assert says in findings[0].message


@pytest.mark.parametrize("bug,rule", [
    ("double-commit", "SIM103"), ("racy-counter", "SIM110"),
    ("silent-fault", "SIM113"),
])
def test_cli_injected_bug_exits_1(tmp_path, capsys, bug, rule):
    rc = sim_main(["--inject-bug", bug, "--tasks", "3",
                   "--workdir", str(tmp_path)])
    captured = capsys.readouterr()
    assert rc == 1
    assert rule in captured.out
    assert "python -m arbius_tpu_torch.sim --scenario" in captured.err


# -- the CLI's exit contract -----------------------------------------------

def test_cli_exit_codes_and_json(tmp_path, capsys):
    assert sim_main(["--scenario", "clean", "--tasks", "3", "--json",
                     "--healthwatch", "--workdir", str(tmp_path)]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["findings"] == [] and doc["version"] == 1
    assert doc["runs"][0]["terminal"] == {"claimed": 3}
    for argv in (["--scenario", "does-not-exist"], ["--seeds", "0"],
                 ["--inject-bug", "no-such-bug"], ["--no-such-flag"],
                 ["--flood", "0"], ["--flood", "5", "--workers", "0"],
                 ["--flood", "5", "--slo", "bogus=1"],
                 ["--flood", "5", "--slo", "chip_idle_fraction=0.2"],
                 ["--scenario", "clean", "--slo", "time_to_commit_p99=1"]):
        assert sim_main(argv) == 2, argv
        capsys.readouterr()
    assert sim_main(["--list"]) == 0
    out = capsys.readouterr().out
    for name in SCENARIOS:
        assert name in out


def test_cli_witness_out_writes_mergeable_report(tmp_path, capsys):
    wpath = tmp_path / "witness.json"
    assert sim_main(["--scenario", "clean", "--tasks", "2",
                     "--workdir", str(tmp_path),
                     "--witness-out", str(wpath)]) == 0
    capsys.readouterr()
    doc = json.loads(wpath.read_text())
    assert {lk["lock"] for lk in doc["locks"]} >= {"NodeDB._lock"}
    assert doc["attr_writes"] == []


# -- settings the port's harness refuses -----------------------------------

@pytest.mark.parametrize("kwargs,item", [
    ({"mesh": {"dp": 2}}, None), ({"mesh": {}}, None),
    ({"precision": "int8", "mesh": {}}, None), ({"perfscope": True}, 12),
], ids=["mesh", "probe", "int8", "perfscope"])
def test_harness_refuses_unported_settings(tmp_path, kwargs, item):
    """perfscope is refused until ROADMAP queue 1 item 12 ports it; the
    probe runner is ported, so a mesh (on the lanes the caller set), the
    probe without a mesh and a quantized probe (item None) run the
    scenario with no finding."""
    if item is not None:
        with pytest.raises(ValueError,
                           match=f"ROADMAP queue 1 item {item}\\)"):
            SimHarness(get_scenario("clean"), 0,
                       db_path=str(tmp_path / "x.sqlite"), **kwargs)
        return
    from arbius_tpu_torch.parallel import virtual_lanes
    from arbius_tpu_torch.sim.harness import run_scenario
    from arbius_tpu_torch.sim.invariants import check_all

    with virtual_lanes(2, "cpu"):
        r = run_scenario(get_scenario("clean"), 0,
                         db_path=str(tmp_path / "x.sqlite"), **kwargs)
    assert not check_all(r) and r.quiescent and r.engine.solutions


