"""simnet's fleet half on the port (arbius_tpu_torch/sim/fleet.py over
arbius_tpu_torch/fleet/ and obs/fleetscope.py) against the reference's,
on the CPU.

The module-scoped `fleet_matrix` fixture runs the port's fleet scenarios
once (FLEET_TIER1 at seeds 1 and 2, every worker's alert engine on) and
the reference's fleet-race at seed 1: every port run must hold SIM101-113
with zero findings, and fleet-race's `summarize` JSON must equal the
reference's byte for byte. A fleet of one matches a bare node; the
injected double lease and span gap fail exactly SIM111 and SIM112; the
flood soak runs at 1,000 tasks through 4 workers and its report must
equal the reference's; and the harness refuses the AOT cache directory
the port has no cache for."""
from __future__ import annotations

import dataclasses
import json

import pytest

from arbius_tpu.sim import fleet as ref_fleet
from arbius_tpu.sim import invariants as ref_invariants
from arbius_tpu.sim import scenario as ref_scenario
from arbius_tpu_torch.sim.cli import main as sim_main
from arbius_tpu_torch.sim.fleet import FleetFloodHarness, run_fleet_scenario
from arbius_tpu_torch.sim.harness import run_scenario
from arbius_tpu_torch.sim.invariants import (
    check_all,
    classify_tasks,
    summarize,
)
from arbius_tpu_torch.sim.scenario import FLEET_TIER1, FleetSpec, get_scenario

SEEDS = (1, 2)
FLOOD = (1000, 4)     # tasks, workers


def _raised(result):
    return sorted({e["alert"] for e in result.journal_events
                   if e.get("kind") == "alert_transition"})


def _cids(result):
    return {"0x" + t.hex(): "0x" + s.cid.hex()
            for t, s in result.engine.solutions.items()}


def _double_lease(tmp_path):
    from arbius_tpu_torch.sim.bugs import DoubleLeaseWorkerNode

    return run_fleet_scenario(get_scenario("fleet-race"), 0,
                              workdir=str(tmp_path),
                              node_cls=DoubleLeaseWorkerNode)


def _span_gap(tmp_path):
    from arbius_tpu_torch.sim.bugs import SpanGapWorkerNode

    return run_fleet_scenario(get_scenario("fleet-race"), 0,
                              workdir=str(tmp_path),
                              node_cls=SpanGapWorkerNode)


@pytest.mark.parametrize("run,rule,says", [
    (_double_lease, "SIM111", "cross-process commit dedupe failed"),
    (_span_gap, "SIM112", "never adopted"),
], ids=["double-lease", "span-gap"])
def test_injected_bug_fails_exactly_its_rule(tmp_path, run, rule, says):
    result = run(tmp_path)
    findings = check_all(result)
    assert findings, f"{rule}: the injected bug went uncaught"
    assert {f.rule for f in findings} == {rule}, \
        "\n".join(f.text() for f in findings)
    assert says in findings[0].message
    assert all(s.claimed for s in result.engine.solutions.values())


def test_cli_injected_double_lease_exits_1(tmp_path, capsys):
    # double-lease is fleet-only: the CLI swaps in fleet-race itself
    rc = sim_main(["--inject-bug", "double-lease",
                   "--workdir", str(tmp_path)])
    captured = capsys.readouterr()
    assert rc == 1
    assert "SIM111" in captured.out


def test_fleet_harness_refuses_aot_dir(tmp_path):
    with pytest.raises(ValueError, match="ROADMAP queue 1 item 12\\)"):
        run_fleet_scenario(get_scenario("fleet-race"), 0,
                           workdir=str(tmp_path),
                           aot_dir=str(tmp_path / "aot"))


# -- the fleet matrix (SIM111, SIM112) --------------------------------------

@pytest.fixture(scope="module")
def fleet_matrix(tmp_path_factory):
    """(scenario, seed) -> (result, findings) for the port's fleet
    scenarios with every worker's alert engine on, and ("fleet-race",
    "reference") -> the reference's summary JSON at seed 1."""
    base = tmp_path_factory.mktemp("fleetnet")
    out = {}
    for name in FLEET_TIER1:
        for seed in SEEDS:
            workdir = base / f"{name}-{seed}"
            workdir.mkdir()
            result = run_fleet_scenario(get_scenario(name), seed,
                                        workdir=str(workdir),
                                        healthwatch=True)
            out[(name, seed)] = (result, check_all(result))
    workdir = base / "fleet-race-reference"
    workdir.mkdir()
    ref = ref_fleet.run_fleet_scenario(
        ref_scenario.get_scenario("fleet-race"), SEEDS[0],
        workdir=str(workdir), healthwatch=True)
    assert not ref_invariants.check_all(ref)
    out[("fleet-race", "reference")] = json.dumps(
        ref_invariants.summarize(ref), sort_keys=True)
    return out


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", FLEET_TIER1)
def test_fleet_matrix_holds_every_invariant(fleet_matrix, name, seed):
    result, findings = fleet_matrix[(name, seed)]
    assert not findings, (
        "fleet invariant violations:\n  "
        + "\n  ".join(f.text() for f in findings)
        + f"\nreproduce byte-identically with: {result.repro()}")
    assert result.quiescent
    assert set(classify_tasks(result).values()) == {"claimed"}
    assert set(result.lease_counts) == {"done"}


def test_fleet_race_summary_equals_reference(fleet_matrix):
    result, _ = fleet_matrix[("fleet-race", SEEDS[0])]
    assert json.dumps(summarize(result), sort_keys=True) == \
        fleet_matrix[("fleet-race", "reference")]


def test_fleet_race_spreads_work_across_workers(fleet_matrix):
    result, _ = fleet_matrix[("fleet-race", SEEDS[0])]
    by_validator = {}
    for s in result.engine.solutions.values():
        by_validator[s.validator] = by_validator.get(s.validator, 0) + 1
    assert set(by_validator) == set(result.fleet_workers)
    assert all(n > 0 for n in by_validator.values())
    assert not [h for h in result.lease_history if h[0] == "commit_dedup"]


def test_fleet_partition_steals_expired_leases(fleet_matrix):
    result, _ = fleet_matrix[("fleet-partition", SEEDS[0])]
    steals = [h for h in result.lease_history if h[0] == "steal"]
    assert steals, "the partition never forced a steal"
    ttl = result.scenario.fleet.lease_ttl
    assert all(h[4]["lag"] <= max(ttl, 2 * result.scenario.tick_seconds)
               for h in steals)
    assert "steal_surge" in _raised(result)


def test_fleet_coordinator_crash_recovers_leases(fleet_matrix):
    result, _ = fleet_matrix[("fleet-coord-crash", SEEDS[0])]
    assert result.restarts == 1
    assert result.plane.fault_counts.get("coordinator_crash") == 1
    assert len(result.engine.solutions) == len(result.tasks)


def test_fleet_matrix_passes_sim112_trace_chains(fleet_matrix):
    from arbius_tpu_torch.obs.fleetscope import federate, render_export

    result, _ = fleet_matrix[("fleet-partition", SEEDS[0])]
    assert result.sidecar_dir
    for row in result.lease_rows:
        hops = json.loads(row["hops"])
        assert hops[0]["op"] == "deal"
        assert [h["hop"] for h in hops] == list(range(len(hops)))
    view = federate(result.sidecar_dir)
    assert {"coordinator", "worker-0"} <= set(view["members"])
    text = render_export(view["export"])
    assert "arbius_fleet_tasks_total" in text
    assert "arbius_fleet_queue_wait_seconds_count" in text
    adoptions = [e for e in view["events"] if e.get("kind") == "lease_hop"]
    granted = sum(1 for row in result.lease_rows
                  for h in json.loads(row["hops"])
                  if h["op"] in ("acquire", "steal"))
    assert len(adoptions) == granted > 0


def test_fleet_of_one_matches_bare_node_byte_for_byte(tmp_path):
    clean = get_scenario("clean")
    fleet1 = dataclasses.replace(clean, name="clean-fleet1",
                                 fleet=FleetSpec(workers=1))
    (tmp_path / "fleet").mkdir()
    rf = run_fleet_scenario(fleet1, SEEDS[0], workdir=str(tmp_path / "fleet"))
    rb = run_scenario(clean, SEEDS[0], db_path=str(tmp_path / "bare.sqlite"),
                      pipeline=False)
    assert not check_all(rf)
    assert _cids(rf) == _cids(rb) and _cids(rf)
    assert {s.validator for s in rf.engine.solutions.values()} == \
        {s.validator for s in rb.engine.solutions.values()}


# -- the flood soak, at 1,000 tasks -----------------------------------------

def test_flood_bounded_and_equal_to_reference(tmp_path):
    """1,000 task lifecycles through a 4-worker fleet: worker backlogs
    stay within their bound, every lease settles, no cross-worker double
    commit, one sqlite commit per tick, and the report (with its SLO
    percentiles) equals the reference's byte for byte."""
    from arbius_tpu_torch.sim.fleet import flood_findings

    reports = []
    for mod, d in ((None, "port"), (ref_fleet, "reference")):
        (tmp_path / d).mkdir()
        cls = FleetFloodHarness if mod is None else mod.FleetFloodHarness
        h = cls(*FLOOD, str(tmp_path / d))
        try:
            reports.append(h.run())
        finally:
            h.close()
    flood = reports[0]
    assert json.dumps(flood, sort_keys=True) == \
        json.dumps(reports[1], sort_keys=True)
    assert flood_findings(flood) == []
    assert flood["claimed"] == flood["tasks"] == FLOOD[0]
    assert flood["lease_counts"] == {"done": FLOOD[0]}
    assert flood["commit_dedup"] == 0
    bound = flood["backlog_bound"]
    assert all(0 < d <= bound for d in flood["max_backlog"].values())
    for commits in flood["db_commits"].values():
        assert commits < flood["tasks"] / 20
    assert flood["max_pending_leases"] > bound
    slo = flood["slo"]
    assert slo["ok"] and slo["breaches"] == []
    for block in ("queue_wait_seconds", "time_to_commit_seconds"):
        b = slo[block]
        assert b["count"] == FLOOD[0]
        assert 0 < b["p50"] <= b["p95"] <= b["p99"]


def test_flood_slo_breach_fails_closed(tmp_path, capsys):
    rc = sim_main(["--flood", "300", "--workers", "3",
                   "--slo", "time_to_commit_p99=0.5",
                   "--workdir", str(tmp_path)])
    captured = capsys.readouterr()
    assert rc == 1
    assert "SLO101" in captured.out
    assert "time_to_commit_seconds p99" in captured.out
