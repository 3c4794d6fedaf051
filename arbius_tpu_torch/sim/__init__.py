"""simnet — deterministic fault-injection simulation of the miner lifecycle.

FoundationDB-style deterministic simulation testing for the node: a real
`MinerNode` mines over the full signed-tx JSON-RPC stack (wallet →
EIP-1559 RLP → `DevnetNode` → EngineV1 state machine) while a **fault
plane** wraps its three I/O edges —

  chain RPC   injected latency, transport timeouts/5xx, lost-response
              txs, delayed/replayed/reorged event logs
  pinners     failures, stalls, CID-mismatch responses
  runners     slow solves, crashes mid-batch

— plus whole-process crash-restarts (the node is torn down mid-flight
and rebooted from its sqlite checkpoint, `node/db.py`). Everything is
derived from one scenario seed through a counter-mode SHA-256 PRNG and
a virtual clock over the engine's chain time: no wall clock, no host
RNG, no filesystem-order dependence — the whole subsystem carries
`detlint: enforce` and a failing run is reproduced byte-identically by
its `--seed`/`--scenario` pair.

After a scenario drains to quiescence, **invariant checkers** (SIM1xx,
`sim/invariants.py`) audit the recorded tx trace, the obs journal, and
the devnet's terminal state: task conservation, commit-strictly-before-
reveal, no duplicate commitment per (validator, taskid), stake never
negative, expretry-bounded retries, CID stability across crash-restart,
and token conservation.

Front doors: `python -m arbius_tpu_torch.sim` and `tools/simsoak.py` (both on
the detlint/graphlint 0/1/2 exit contract via `tools/_common.py`
`lint_main`). Docs: docs/fault-injection.md.
"""
# detlint: enforce[DET101,DET102,DET103,DET105]
from arbius_tpu_torch.sim.clock import VirtualClock
from arbius_tpu_torch.sim.faults import FaultPlane, SimCrash
from arbius_tpu_torch.sim.harness import SimHarness, run_scenario
from arbius_tpu_torch.sim.invariants import SimFinding, check_all
from arbius_tpu_torch.sim.rng import SimRng
from arbius_tpu_torch.sim.scenario import SCENARIOS, FaultSpec, Scenario

__all__ = [
    "SCENARIOS", "FaultPlane", "FaultSpec", "Scenario", "SimCrash",
    "SimFinding", "SimHarness", "SimRng", "VirtualClock", "check_all",
    "run_scenario",
]
