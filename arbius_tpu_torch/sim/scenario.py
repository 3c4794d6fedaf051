"""Declarative scenarios: seed + fault schedule + workload spec.

A `Scenario` is everything a run needs besides its seed: how many task
lifecycles to drive, which fraction are adversarial (front-run with a
wrong CID → contestation path) or malformed (hydration failure →
invalid path), and the `FaultSpec` rates the fault plane draws against.
All rates are *per-opportunity* probabilities evaluated on named rng
streams, so two scenarios with one differing rate share every other
decision at the same seed.

The named catalog (`SCENARIOS`) is the tier-1 matrix: `clean` must end
with every delivered task claimed (strict mode); the fault mixes must
end with every task in exactly one accounted terminal state and every
SIM1xx invariant intact. Reproduce any run byte-identically with
`python -m arbius_tpu_torch.sim --scenario <name> --seed <n>`.
"""
# detlint: enforce[DET101,DET102,DET103,DET105]
from __future__ import annotations

from dataclasses import asdict, dataclass, field, replace


@dataclass(frozen=True)
class FaultSpec:
    """Per-opportunity fault rates for the three I/O edges + crash."""

    # -- chain RPC edge (FaultTransport) --------------------------------
    tx_error_rate: float = 0.0        # sendRawTransaction fails BEFORE landing
    tx_lost_response_rate: float = 0.0  # tx lands, response is dropped
    view_error_rate: float = 0.0      # eth_call answers 5xx
    poll_error_rate: float = 0.0      # eth_getLogs answers 5xx
    latency_max: int = 0              # virtual seconds injected per RPC, 0..max
    event_delay_rate: float = 0.0     # log held back 1-3 polls (reorders)
    event_replay_rate: float = 0.0    # log delivered again next poll
    reorg_every: int = 0              # every N polls, redeliver recent blocks
    reorg_depth: int = 4              # how many trailing blocks a reorg replays
    # -- pinner edge (SimPinner) ----------------------------------------
    pin_fail_rate: float = 0.0        # pin request 5xx
    pin_stall_seconds: int = 0        # virtual stall per pin attempt, 0..max
    pin_mismatch_rate: float = 0.0    # service answers a different root CID
    # -- runner edge (FaultyRunner) -------------------------------------
    runner_slow_seconds: int = 0      # virtual seconds per solve, 0..max
    runner_crash_rate: float = 0.0    # runner raises mid-batch
    # -- decode edge (FaultyTextRunner, docs/text-serving.md) -----------
    decode_stall_rate: float = 0.0    # text solve decodes zero bytes
    # -- process crash ---------------------------------------------------
    crash_after_commit: int | None = None  # kill node after Nth commit lands


@dataclass(frozen=True)
class FleetSpec:
    """Fleet topology + failure schedule for multi-node scenarios
    (docs/fleet.md): N workers race one coordinator-owned event stream
    through the shared lease table; pause windows model partitions
    (the member can reach neither the chain nor the lease db for those
    rounds), and the coordinator crash-restart proves lease recovery."""

    workers: int = 2
    lease_ttl: int = 30            # chain-seconds before a lease is stealable
    wallet_mode: str = "per-worker"
    max_leases: int = 2            # pulls per worker per tick
    backlog: int = 4               # worker task/solve backlog bound
    max_attempts: int = 4          # lease deliveries before failed
    # (worker_index, from_round, to_round): that worker skips its ticks
    # in [from, to) — its leases expire and MUST be stolen
    pause_worker: tuple = ()
    # (from_round, to_round): the coordinator skips its ticks — intake
    # stalls but leased work keeps mining
    pause_coordinator: tuple = ()
    # round at which the coordinator is killed and rebuilt from the
    # on-disk lease table + a from-genesis event re-poll
    crash_coordinator_round: int | None = None


@dataclass(frozen=True)
class Scenario:
    name: str
    description: str = ""
    tasks: int = 8                 # lifecycles to drive
    fee_wad: int = 1               # task fee in wad (fees exercise splits)
    evil_rate: float = 0.0         # fraction front-run with a wrong CID
    invalid_rate: float = 0.0      # fraction submitted with broken input
    strict: bool = False           # every normal task MUST end claimed
    tick_seconds: int = 5          # virtual seconds between rounds
    max_rounds: int = 600          # liveness bound (SIM108 if exceeded)
    burst: int = 1                 # tasks submitted per round (flood > 1)
    families: int = 1              # registered model families to mix
    template: str = "anythingv3"   # task template the workload speaks
    sched: bool = False            # costsched packer on (docs/scheduler.md)
    fleet: FleetSpec | None = None  # multi-node fleet run (docs/fleet.md)
    faults: FaultSpec = field(default_factory=FaultSpec)

    def to_json(self) -> dict:
        return asdict(self)

    def with_tasks(self, tasks: int | None) -> "Scenario":
        return self if tasks is None else replace(self, tasks=tasks)


SCENARIOS: dict[str, Scenario] = {s.name: s for s in (
    Scenario(
        name="clean",
        description="no faults; strict: every delivered task must be "
                    "solved, revealed, and claimed",
        strict=True),
    Scenario(
        name="rpc-flap",
        description="flaky endpoint: transport errors, lost tx "
                    "responses, 5xx views/polls, injected latency",
        faults=FaultSpec(tx_error_rate=0.12, tx_lost_response_rate=0.10,
                         view_error_rate=0.03, poll_error_rate=0.15,
                         latency_max=7)),
    Scenario(
        name="pin-fail",
        description="pinning service misbehaves: 5xx, stalls, CID "
                    "mismatches; slow solves ride along",
        faults=FaultSpec(pin_fail_rate=0.30, pin_stall_seconds=5,
                         pin_mismatch_rate=0.15, runner_slow_seconds=3)),
    Scenario(
        name="reorg",
        description="event plane chaos: delayed + replayed logs and "
                    "shallow log-replay reorgs every few polls",
        faults=FaultSpec(event_delay_rate=0.25, event_replay_rate=0.20,
                         reorg_every=3, reorg_depth=4)),
    Scenario(
        name="crash-restart",
        description="node process killed right after its 2nd commit "
                    "lands; rebooted from the sqlite checkpoint and must "
                    "reveal the SAME CID (SIM106)",
        tasks=6, strict=True,
        faults=FaultSpec(crash_after_commit=2)),
    Scenario(
        name="contested",
        description="an adversary front-runs half the tasks with a "
                    "wrong CID; the node must contest, vote, and finish "
                    "every dispute",
        tasks=6, evil_rate=0.5, strict=True),
    Scenario(
        name="sched-flood",
        description="mixed-family task flood under the costsched packer: "
                    "two model families, bursts of 4, varied shapes and "
                    "fees — the scheduler reorders buckets freely and "
                    "every SIM1xx invariant (incl. per-task CID "
                    "stability) must hold regardless",
        tasks=16, burst=4, families=2, sched=True, strict=True,
        faults=FaultSpec(latency_max=3, runner_slow_seconds=2)),
    Scenario(
        name="text-stream",
        description="text-generation flood (docs/text-serving.md): "
                    "token-progress solve times under the fault plane, "
                    "mixed decode budgets and samplers, costsched "
                    "packing sequence buckets — decode stalls must "
                    "surface through healthwatch (SIM113) and every "
                    "SIM1xx invariant must hold",
        tasks=12, burst=3, strict=True, sched=True, template="textgen",
        faults=FaultSpec(decode_stall_rate=0.35, runner_slow_seconds=2,
                         latency_max=3)),
    Scenario(
        name="fleet-race",
        description="two miners race one coordinator-owned event "
                    "stream through the shared lease table (bursts of "
                    "4, so both actually pull work): every task "
                    "claimed exactly once fleet-wide, no cross-worker "
                    "double-commit (SIM111)",
        tasks=8, burst=4, strict=True, fleet=FleetSpec(workers=2)),
    Scenario(
        name="fleet-partition",
        description="worker 1 AND the coordinator partitioned mid-run: "
                    "worker 1's leases expire and worker 0 steals them "
                    "directly (no coordinator sweep available), task "
                    "intake stalls and then catches up — no task lost "
                    "either way",
        tasks=12, burst=4, strict=True,
        fleet=FleetSpec(workers=2, lease_ttl=20,
                        pause_worker=(1, 3, 9),
                        pause_coordinator=(4, 10))),
    Scenario(
        name="fleet-coord-crash",
        description="the coordinator is killed mid-run and rebuilt "
                    "from the on-disk lease table + a from-genesis "
                    "event re-poll: every in-flight lease recovered, "
                    "every task still claimed",
        tasks=8, burst=3, strict=True,
        fleet=FleetSpec(workers=2, crash_coordinator_round=4)),
    Scenario(
        name="chaos",
        description="everything at once, at moderated rates — the soak "
                    "mix for tools/simsoak.py",
        tasks=10, evil_rate=0.2, invalid_rate=0.2,
        faults=FaultSpec(tx_error_rate=0.08, tx_lost_response_rate=0.05,
                         poll_error_rate=0.10, latency_max=5,
                         event_delay_rate=0.15, event_replay_rate=0.10,
                         reorg_every=5, reorg_depth=3,
                         pin_fail_rate=0.15, pin_stall_seconds=3,
                         pin_mismatch_rate=0.05, runner_slow_seconds=3,
                         runner_crash_rate=0.08)),
)}

# the acceptance matrix every PR must keep green (tests/test_sim.py) —
# the FULL catalog since the staged solve executor landed: chaos (every
# fault at once) is exactly the mix that would expose a pipeline
# ordering bug, so it gates tier-1 too
TIER1_MATRIX = ("clean", "rpc-flap", "pin-fail", "reorg",
                "crash-restart", "contested", "chaos")

# the fleet half of the matrix (docs/fleet.md): multi-node scenarios
# driven by sim/fleet.py's harness and audited by SIM111 on top of the
# applicable SIM1xx set; `--scenario tier1` runs both halves
FLEET_TIER1 = ("fleet-race", "fleet-partition", "fleet-coord-crash")


def get_scenario(name: str) -> Scenario:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r} — known: "
            f"{', '.join(sorted(SCENARIOS))}") from None
