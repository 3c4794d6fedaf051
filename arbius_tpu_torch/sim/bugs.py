"""Deliberately broken nodes — regression ammunition for the checkers.

A checker that has never caught anything is a checker you can't trust.
Each class here injects one protocol violation into an otherwise-real
`MinerNode`; the tier-1 regression (tests/test_sim.py) and the CLI's
`--inject-bug` flag run a scenario with the buggy node and require the
matching SIM1xx finding to fire with a readable diff. These nodes must
NEVER be reachable from production wiring — only the sim harness's
`node_cls` seam constructs them.
"""
# detlint: enforce[DET101,DET102,DET103,DET105]
from __future__ import annotations

import threading

from arbius_tpu_torch.chain.devnet import DevnetError
from arbius_tpu_torch.node import MinerNode
from arbius_tpu_torch.node.chain_client import EngineError


class DoubleCommitMinerNode(MinerNode):
    """Signals a SECOND commitment — for a corrupted CID — next to every
    real one: the double-commit a slashing-grade bug would produce.
    The chain happily accepts both (they are different hashes), so only
    the SIM103 checker can see the violation."""

    @staticmethod
    def _corrupt(cid: str) -> str:
        flipped = format(int(cid[-1], 16) ^ 0x1, "x")
        return cid[:-1] + flipped

    def _commit_reveal(self, taskid: str, cid: str, t_start: int,
                       **kwargs) -> None:
        if self.chain.get_solution(taskid) is None:
            wrong = self._corrupt(cid)
            second = self.chain.generate_commitment(taskid, wrong)
            try:
                self.chain.signal_commitment(second)
            except (EngineError, DevnetError):  # pragma: no cover
                pass
        super()._commit_reveal(taskid, cid, t_start, **kwargs)


class RacyCounterMinerNode(MinerNode):
    """Bumps an UNLOCKED counter from the tick thread and from its own
    spawned daemon — one injected bug, two gates that must both fail
    closed (docs/concurrency.md): conclint's static CONC401 (the
    regression test strips the waivers below and requires the finding),
    and SIM110 at runtime (the witness watches `racy_counter` via
    WITNESS_WATCH_ATTRS and must record lock-free writes from two
    roots). The counter feeds nothing — CIDs stay byte-identical."""

    WITNESS_WATCH_ATTRS = ("racy_counter",)

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.racy_counter = 0
        self._racy_stop = threading.Event()
        self._racy_thread = threading.Thread(
            target=self._racy_run, daemon=True, name="racy-counter")
        self._racy_thread.start()

    def _racy_run(self) -> None:
        while not self._racy_stop.wait(0.0005):
            # detlint: allow[CONC301,CONC401] deliberate injected race —
            # regression ammunition; tests strip this waiver and require
            # the static finding, and the simnet witness must see it
            self.racy_counter += 1

    def tick(self) -> int:
        # detlint: allow[CONC301,CONC401] deliberate injected race (the
        # other side — see _racy_run above)
        self.racy_counter += 1
        return super().tick()

    def close(self) -> None:
        self._racy_stop.set()
        self._racy_thread.join(timeout=2.0)
        super().close()


class DoubleLeaseWorkerNode(MinerNode):
    """A fleet worker that violates the lease plane's exclusivity: each
    tick it scans the shared commit-rights table and signals its OWN
    commitment for every task another worker already committed — acting
    as if it held the lease itself (the double-lease a broken lease
    claim would produce). The chain accepts the commitments (different
    validators hash differently), so only SIM111's cross-worker dedupe
    audit can see the violation; it must fail closed. Only meaningful
    under a fleet scenario (the CLI forces one)."""

    def tick(self) -> int:
        feed = getattr(self, "task_feed", None)
        if feed is not None:
            seen = getattr(self, "_double_leased", None)
            if seen is None:
                seen = self._double_leased = set()
            for row in feed.leases.commit_rows():
                tid = row["taskid"]
                if row["worker"] == feed.worker_id or tid in seen:
                    continue
                seen.add(tid)
                try:
                    second = self.chain.generate_commitment(
                        tid, row["cid"])
                    self.chain.signal_commitment(second)
                except (EngineError, DevnetError):  # pragma: no cover
                    pass
        return super().tick()


class SpanGapWorkerNode(MinerNode):
    """A fleet worker whose obs drops the `lease_hop` adoption events —
    the worker-side half of the cross-process trace chain
    (docs/fleetscope.md). Work still flows: leases are acquired, tasks
    solve, CIDs land byte-identically, SIM101-111 all hold — but every
    acquire/steal hop the shared lease table granted this worker is now
    missing its journal adoption, so the task's span chain has a gap
    only SIM112's trace-completeness audit can see. It must fail
    closed, and fail ALONE."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        real_event = self.obs.event

        def dropping(kind: str, **fields) -> None:
            if kind == "lease_hop":
                return  # the injected trace gap
            real_event(kind, **fields)

        self.obs.event = dropping


class SilentFaultMinerNode(MinerNode):
    """A miner whose health monitoring went dark: the healthwatch
    engine still evaluates (gauges keep moving), but every
    `alert_transition` journal event is swallowed — the flight
    recorder shows a node that never raised an alert while the fault
    plane was actively injecting failures. Work still flows, retries
    still journal, CIDs land byte-identically, SIM101-112 all hold —
    the fault is SILENT, which is exactly the condition SIM113's
    coverage invariant exists to catch: a fault class that raised no
    mapped alert must fail the run, and fail it ALONE. (The CLI forces
    a fault-injecting scenario + healthwatch, sim/cli.py.)"""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        real_event = self.obs.event

        def muting(kind: str, **fields) -> None:
            if kind == "alert_transition":
                return  # the injected monitoring blackout
            real_event(kind, **fields)

        self.obs.event = muting


INJECTABLE_BUGS = {
    "double-commit": DoubleCommitMinerNode,
    "racy-counter": RacyCounterMinerNode,
    "double-lease": DoubleLeaseWorkerNode,
    "span-gap": SpanGapWorkerNode,
    "silent-fault": SilentFaultMinerNode,
}

# bugs that only make sense inside a fleet (the CLI swaps the scenario
# to a fleet one when needed)
FLEET_BUGS = ("double-lease", "span-gap")

# bugs that only demonstrate anything under an actively fault-injecting
# scenario with the healthwatch engine on (the CLI swaps a fault-free
# scenario for rpc-flap and implies --healthwatch)
FAULT_BUGS = ("silent-fault",)
