"""simnet command line — `python -m arbius_tpu_torch.sim`.

Same exit contract as the reference's detlint/graphlint: 0 = every
scenario run passed every invariant checker, 1 = findings, 2 = usage
error. The port keeps its own copy of the three codes and of the
parse→collect→render loop (`main`): the lint package is the
reference's. Any failing run prints the exact `--scenario`/`--seed`
pair that reproduces it byte-identically.

    python -m arbius_tpu_torch.sim                         # clean, seed 0
    python -m arbius_tpu_torch.sim --scenario rpc-flap --seed 7
    python -m arbius_tpu_torch.sim --scenario all --seeds 3 --json
    python -m arbius_tpu_torch.sim --scenario fleet-race   # 2-miner fleet
    python -m arbius_tpu_torch.sim --flood 10000           # 10k fleet soak
    python -m arbius_tpu_torch.sim --flood 10000 --slo time_to_commit_p99=300
    python -m arbius_tpu_torch.sim --list                  # scenario catalog
    python -m arbius_tpu_torch.sim --inject-bug double-commit   # must exit 1
"""
# detlint: enforce[DET101,DET102,DET103,DET105]
from __future__ import annotations

import argparse
import json
import sys

EXIT_CLEAN = 0
EXIT_FINDINGS = 1
EXIT_USAGE = 2


def build_arg_parser(p: argparse.ArgumentParser | None = None
                     ) -> argparse.ArgumentParser:
    if p is None:
        p = argparse.ArgumentParser(
            prog="simsoak", description=__doc__,
            formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--scenario", default="clean",
                   help="scenario name, 'all' for the full catalog, or "
                        "'tier1' for the acceptance matrix (default: clean)")
    p.add_argument("--seed", type=int, default=0,
                   help="base scenario seed (default: 0)")
    p.add_argument("--seeds", type=int, default=1,
                   help="soak mode: run seeds seed..seed+N-1 per scenario "
                        "(default: 1)")
    p.add_argument("--tasks", type=int, default=None,
                   help="override the scenario's task count")
    p.add_argument("--json", action="store_true",
                   help="machine-readable report (stable key order; "
                        "byte-identical for identical scenario+seed)")
    p.add_argument("--list", action="store_true",
                   help="list the scenario catalog and exit")
    p.add_argument("--inject-bug", default=None,
                   help="run with a deliberately broken node (checker "
                        "regression); known: double-commit, "
                        "racy-counter, double-lease, span-gap")
    p.add_argument("--flood", type=int, default=None, metavar="N",
                   help="fleet flood soak (docs/fleet.md): push N task "
                        "lifecycles through a fleet over the in-process "
                        "engine and audit bounded worker backlogs, "
                        "lease settlement, commit dedupe, and the "
                        "byte-deterministic SLO percentile report "
                        "(docs/fleetscope.md) (e.g. --flood 10000)")
    p.add_argument("--workers", type=int, default=4,
                   help="fleet size for --flood (default: 4)")
    p.add_argument("--slo", default=None, metavar="K=V[,K=V...]",
                   help="SLO thresholds for --flood (chain seconds; "
                        "docs/fleetscope.md): queue_wait_p95, "
                        "time_to_commit_p99, steal_lag_p99 — a "
                        "breached objective fails the run (SLO101), "
                        "e.g. --slo time_to_commit_p99=120")
    p.add_argument("--healthwatch", action="store_true",
                   help="run the live alert engine on every node "
                        "(docs/healthwatch.md): SIM113 audits the "
                        "fault→alert coverage — every injected fault "
                        "class must raise its mapped alert, clean "
                        "runs must raise none; implied by "
                        "--inject-bug silent-fault")
    p.add_argument("--witness", action="store_true",
                   help="instrument the node with the conclint runtime "
                        "witness (docs/concurrency.md): SIM110 audits "
                        "the observed lock-order graph and watched-attr "
                        "writes; implied by --inject-bug racy-counter")
    p.add_argument("--witness-out", default=None,
                   help="write the merged witness report (all runs) as "
                        "JSON — feed it to `conclint --witness-report` "
                        "to confirm/downgrade static CONC401 findings; "
                        "implies --witness")
    p.add_argument("--workdir", default=None,
                   help="directory for node sqlite checkpoints (default: "
                        "a temporary directory; crash-restart scenarios "
                        "need durable files either way)")
    return p


def _resolve_scenarios(name: str):
    from arbius_tpu_torch.sim.scenario import (
        FLEET_TIER1,
        SCENARIOS,
        TIER1_MATRIX,
        get_scenario,
    )

    if name == "all":
        return [SCENARIOS[k] for k in sorted(SCENARIOS)]
    if name == "tier1":
        return [SCENARIOS[k] for k in TIER1_MATRIX + FLEET_TIER1]
    return [get_scenario(name)]


def collect(ns: argparse.Namespace):
    """Run the requested (scenario × seed) grid; findings are the
    invariant violations across every run. Returns (exit_code, findings)
    with lint_main's short-circuit convention; run summaries ride on
    `ns` for render()."""
    import os
    import tempfile

    from arbius_tpu_torch.node import MinerNode
    from arbius_tpu_torch.sim.bugs import INJECTABLE_BUGS
    from arbius_tpu_torch.sim.harness import run_scenario
    from arbius_tpu_torch.sim.invariants import check_all, summarize
    from arbius_tpu_torch.sim.scenario import SCENARIOS

    ns._runs = []
    ns._flood = None
    if ns.list:
        for name in sorted(SCENARIOS):
            s = SCENARIOS[name]
            print(f"{name:15s} tasks={s.tasks:<3d} {s.description}")
        return EXIT_CLEAN, []
    if ns.slo is not None and ns.flood is None:
        # fail-closed: silently ignoring a declared objective is the
        # exact bug the SLO layer exists to prevent
        print("simsoak: --slo only applies to --flood (scenario runs "
              "are audited by the SIM1xx invariants)", file=sys.stderr)
        return EXIT_USAGE, []
    node_cls = MinerNode
    if ns.inject_bug is not None:
        node_cls = INJECTABLE_BUGS.get(ns.inject_bug)
        if node_cls is None:
            print(f"simsoak: unknown --inject-bug {ns.inject_bug!r} "
                  f"(known: {', '.join(sorted(INJECTABLE_BUGS))})",
                  file=sys.stderr)
            return EXIT_USAGE, []
    if ns.flood is not None:
        if ns.flood < 1 or ns.workers < 1:
            print("simsoak: --flood and --workers must be >= 1",
                  file=sys.stderr)
            return EXIT_USAGE, []
        from arbius_tpu_torch.node.config import ConfigError, SLOConfig
        from arbius_tpu_torch.sim.fleet import FleetFloodHarness, flood_findings

        slo = SLOConfig()
        if ns.slo is not None:
            # only the chain-time objectives the deterministic flood
            # report measures — accepting e.g. chip_idle_fraction here
            # would "validate" an objective the run can never evaluate
            flood_keys = ("queue_wait_p95", "time_to_commit_p99",
                          "steal_lag_p99")
            try:
                kwargs = {}
                for part in ns.slo.split(","):
                    key, _, value = part.partition("=")
                    key = key.strip()
                    if key not in flood_keys:
                        raise ValueError(
                            f"{key!r} is not a --flood objective "
                            f"(known: {', '.join(flood_keys)})")
                    kwargs[key] = float(value)
                slo = SLOConfig(**kwargs)
            except (TypeError, ValueError, ConfigError) as e:
                print(f"simsoak: bad --slo {ns.slo!r}: {e}",
                      file=sys.stderr)
                return EXIT_USAGE, []
        with tempfile.TemporaryDirectory(prefix="simflood-") as tmp:
            harness = FleetFloodHarness(ns.flood, ns.workers,
                                        ns.workdir or tmp, seed=ns.seed,
                                        slo=slo)
            try:
                ns._flood = harness.run()
            finally:
                harness.close()
        return None, flood_findings(ns._flood)
    try:
        scenarios = _resolve_scenarios(ns.scenario)
    except KeyError as e:
        print(f"simsoak: {e.args[0]}", file=sys.stderr)
        return EXIT_USAGE, []
    if ns.seeds < 1:
        print("simsoak: --seeds must be >= 1", file=sys.stderr)
        return EXIT_USAGE, []
    from arbius_tpu_torch.sim.bugs import FAULT_BUGS, FLEET_BUGS

    if ns.inject_bug in FLEET_BUGS and not any(
            s.fleet is not None for s in scenarios):
        # a fleet-only bug demonstrates nothing outside a fleet
        from arbius_tpu_torch.sim.scenario import get_scenario

        scenarios = [get_scenario("fleet-race")]
    if ns.inject_bug in FAULT_BUGS:
        # a monitoring blackout demonstrates nothing unless faults are
        # actually being injected for healthwatch to miss
        from arbius_tpu_torch.sim.scenario import FaultSpec, get_scenario

        if all(s.faults == FaultSpec() for s in scenarios):
            scenarios = [get_scenario("rpc-flap")]
    # silent-fault exists to be caught by SIM113 — running it without
    # the alert engine would test nothing (the racy-counter pattern)
    healthwatch = ns.healthwatch or ns.inject_bug in FAULT_BUGS

    findings = []
    # racy-counter exists to be caught by the witness's SIM110 —
    # running it uninstrumented would test nothing
    witness = ns.witness or ns.witness_out is not None \
        or ns.inject_bug == "racy-counter"
    reports = []
    with tempfile.TemporaryDirectory(prefix="simnet-") as tmp:
        workdir = ns.workdir or tmp
        for scenario in scenarios:
            scenario = scenario.with_tasks(ns.tasks)
            for seed in range(ns.seed, ns.seed + ns.seeds):
                if scenario.fleet is not None:
                    from arbius_tpu_torch.sim.fleet import run_fleet_scenario

                    fleet_dir = os.path.join(
                        workdir, f"{scenario.name}-{seed}")
                    os.makedirs(fleet_dir, exist_ok=True)
                    result = run_fleet_scenario(scenario, seed,
                                                workdir=fleet_dir,
                                                node_cls=node_cls,
                                                healthwatch=healthwatch)
                else:
                    db_path = os.path.join(
                        workdir, f"{scenario.name}-{seed}.sqlite")
                    result = run_scenario(scenario, seed,
                                          db_path=db_path,
                                          node_cls=node_cls,
                                          witness=witness,
                                          healthwatch=healthwatch)
                if result.witness_report is not None:
                    reports.append(result.witness_report)
                run_findings = check_all(result)
                findings.extend(run_findings)
                summary = summarize(result)
                summary["findings"] = len(run_findings)
                ns._runs.append(summary)
                if run_findings:
                    print(f"simsoak: {len(run_findings)} invariant "
                          f"violation(s) — reproduce with: {result.repro()}",
                          file=sys.stderr)
    if ns.witness_out is not None:
        from arbius_tpu_torch.analysis.conc.witness import merge_reports

        with open(ns.witness_out, "w", encoding="utf-8",
                  newline="\n") as fh:
            json.dump(merge_reports(reports), fh, indent=2,
                      sort_keys=True)
            fh.write("\n")
        print(f"simsoak: witness report written to {ns.witness_out}",
              file=sys.stderr)
    return None, findings


def render(ns: argparse.Namespace, findings, out) -> None:
    runs = getattr(ns, "_runs", [])
    flood = getattr(ns, "_flood", None)
    if ns.json:
        doc = {"version": 1,
               "findings": [f.to_json() for f in findings],
               "runs": runs}
        if flood is not None:
            doc["flood"] = flood
        out.write(json.dumps(doc, indent=2, sort_keys=True) + "\n")
        return
    if flood is not None:
        depths = " ".join(f"{w}={d}" for w, d
                          in sorted(flood["max_backlog"].items()))
        out.write(
            f"flood           tasks={flood['tasks']:<6d} "
            f"workers={flood['workers']} rounds={flood['rounds']:<5d} "
            f"claimed={flood['claimed']:<6d} "
            f"dedup={flood['commit_dedup']}\n"
            f"  worker backlog bound {flood['backlog_bound']}, "
            f"max depths [{depths}], peak pending leases "
            f"{flood['max_pending_leases']}\n"
            f"  sqlite commits per worker "
            f"{dict(sorted(flood['db_commits'].items()))} "
            f"(one fsync per tick, not per job)\n")
        slo = flood.get("slo")
        if slo is not None:
            def _pcts(block):
                return " ".join(
                    f"{p}={block.get(p)}" for p in ("p50", "p95", "p99"))
            out.write(
                f"  slo {'OK' if slo.get('ok') else 'BREACHED'}: "
                f"queue-wait [{_pcts(slo['queue_wait_seconds'])}] "
                f"time-to-commit "
                f"[{_pcts(slo['time_to_commit_seconds'])}] "
                f"steal-lag [{_pcts(slo['steal_lag_seconds'])}] "
                "(chain seconds, fixed-bucket estimate — "
                "docs/fleetscope.md)\n")
    for r in runs:
        terminal = " ".join(f"{k}={v}" for k, v in r["terminal"].items())
        faults = sum(r["faults_injected"].values())
        out.write(
            f"{r['scenario']:15s} seed={r['seed']:<4d} "
            f"tasks={r['tasks']:<3d} rounds={r['rounds']:<4d} "
            f"faults={faults:<4d} restarts={r['restarts']} "
            f"[{terminal}]\n")
    for f in findings:
        out.write(f.text() + "\n")
    if findings:
        out.write(f"simsoak: {len(findings)} invariant violation(s)\n")


def run(ns: argparse.Namespace, out=None) -> int:
    out = out or sys.stdout
    rc, findings = collect(ns)
    if rc is not None:
        return rc
    render(ns, findings, out)
    return EXIT_FINDINGS if findings else EXIT_CLEAN


def main(argv: list[str] | None = None) -> int:
    """Parse, collect, render, exit: argparse's own exits (2 on a usage
    error, 0 on --help) pass through as return codes."""
    try:
        ns = build_arg_parser().parse_args(argv)
    except SystemExit as e:
        return int(e.code or 0)
    return run(ns)


if __name__ == "__main__":
    sys.exit(main())
