"""Fleet worker mode — the external task feed a MinerNode runs under.

A fleet worker is a full `MinerNode` with two seams rewired
(docs/fleet.md):

  * `task_feed` — tasks arrive from the lease table, not from the
    node's own TaskSubmitted subscription: `LeaseFeed.pump()` runs at
    the top of every tick (the lease heartbeat woven into the tick)
    and (1) settles leases for tasks that reached a terminal state,
    (2) heartbeats the rest, (3) pulls new leases only while the
    worker's task/solve backlog is below its bound — worker memory
    stays bounded and the lease table is the durable overflow buffer;
  * `commit_guard` — before signalling a commitment the node asks the
    lease table for exclusive commit rights, so two workers never
    double-commit one `(validator, taskid)` even across a lease
    reclaim race.

Downstream of the feed the lifecycle is untouched: `store_task` +
`queue_job("task")` is exactly what the event handler does, so a fleet
of one worker produces byte-identical CIDs to a bare MinerNode on the
same event stream (tests/test_sim.py pins it).
"""
# detlint: enforce[DET101,DET102,DET103,DET105]
from __future__ import annotations

import logging

from arbius_tpu_torch.fleet.lease import LeaseTable
from arbius_tpu_torch.node.config import FleetConfig

log = logging.getLogger("arbius.fleet")

# job methods that count against the worker's backlog bound: the work
# actually in flight, not time-gated bookkeeping (claims, heartbeats)
_BACKLOG_METHODS = ("task", "solve", "pinTaskInput")


class LeaseFeed:
    """The worker half of the lease protocol. `attach(node)` wires it
    into a MinerNode as `task_feed` + `commit_guard`; the node then
    calls `pump(node)` once per tick."""

    def __init__(self, leases: LeaseTable, worker_id: str,
                 config: FleetConfig):
        self.leases = leases
        self.worker_id = worker_id
        self.config = config
        self._node = None
        # fleetscope sidecar (docs/fleetscope.md), wired by
        # attach_sidecar: the worker's registry snapshot + journal
        # segments persist every `sidecar_flush_every` pumps so the
        # coordinator's federated view (and tools/fleetscope.py) can
        # merge this process's obs without talking to it
        self._sidecar = None
        self._flush_every = 1
        self._pumps = 0
        # healthwatch lease_starvation signal (docs/healthwatch.md):
        # True when the last pump had backlog room but acquired
        # nothing while the table held pending leases — computed only
        # when the node runs an alert engine (the pending-count query
        # must cost the flood soak nothing)
        self.starved = False

    def attach(self, node) -> "LeaseFeed":
        """Wire this feed into `node` (before boot): the node stops
        self-queuing TaskSubmitted work and consults the commit guard
        before every signalCommitment."""
        self._node = node
        node.task_feed = self
        node.commit_guard = self.commit_guard
        return self

    def attach_sidecar(self, sidecar, every: int = 1) -> "LeaseFeed":
        """Flush `sidecar` every `every` pumps (plus on flush_sidecar —
        harness/launcher teardown calls it for the final segment)."""
        self._sidecar = sidecar
        self._flush_every = max(1, int(every))
        return self

    def flush_sidecar(self, now: int = 0) -> None:
        if self._sidecar is not None:
            self._sidecar.flush(now)

    # -- the per-tick pump ------------------------------------------------
    def pump(self, node) -> int:
        """Settle, heartbeat, then pull. Returns new leases queued."""
        now = node.chain.now
        cfg = self.config
        self._settle(node, now)
        self.leases.heartbeat(self.worker_id, now, cfg.lease_ttl)
        backlog = node.db.count_jobs(_BACKLOG_METHODS)
        room = min(cfg.max_leases, cfg.backlog - backlog)
        if room <= 0:
            self.starved = False   # no room ≠ starved: we are FULL
            return 0
        # pending is read BEFORE acquire: a lease dealt in the gap is
        # then simply acquired (grants non-empty → not starved); read
        # after, it would mark a pump starved for work it never had a
        # chance at. Only computed when an alert engine is watching —
        # the count query must cost the flood soak nothing.
        pending = self.leases.counts().get("pending", 0) \
            if getattr(node, "healthwatch", None) is not None else 0
        queued = 0
        grants = list(self.leases.acquire(self.worker_id, now,
                                          cfg.lease_ttl, room))
        for grant in grants:
            queued += self._ingest(node, grant, now)
        self.starved = not grants and pending > 0
        self._pumps += 1
        if self._sidecar is not None and \
                self._pumps % self._flush_every == 0:
            self.flush_sidecar(now)
        return queued

    def _settle(self, node, now: int) -> None:
        """Terminal-state detection for every lease this worker holds:
        solved on chain (by anyone) → done; proven invalid → invalid;
        quarantined here → released for another worker (failed past the
        attempt bound)."""
        failed = {data.get("taskid")
                  for _, data in node.db.failed_jobs()}
        for tid in self.leases.held(self.worker_id):
            if node.chain.get_solution(tid) is not None:
                self.leases.complete(tid, self.worker_id, now)
            elif node.db.is_invalid_task(tid):
                self.leases.complete(tid, self.worker_id, now,
                                     state="invalid")
            elif tid in failed:
                state = self.leases.release(tid, self.worker_id, now,
                                            self.config.max_attempts)
                log.info("lease %s released after local failure -> %s",
                         tid, state)

    def _ingest(self, node, grant, now: int) -> int:
        """One leased task into the node's queue — the event handler's
        exact store+queue pair, so everything downstream (filter, gate,
        hydration, solve, commit) is the single-node code path.

        The FIRST thing every grant does — before any early return — is
        journal its trace-hop adoption (`lease_hop`): the worker-side
        half of the cross-process span chain the lease table's `hops`
        column carries (docs/fleetscope.md). SIM112 cross-checks every
        acquire/steal hop in the shared table against exactly this
        event; sim/bugs.py's span-gap worker drops it and must fail
        SIM112 alone."""
        tid = grant.taskid
        node.obs.event("lease_hop", taskid=tid, worker=self.worker_id,
                       hop=grant.hop,
                       op="steal" if grant.stolen else "acquire")
        if node.chain.get_solution(tid) is not None:
            # raced: solved while pending (front-run or another fleet's
            # worker) — settle, never burn a solve on it
            self.leases.complete(tid, self.worker_id, now)
            return 0
        task = node.chain.get_task(tid)
        if task is None:
            # the coordinator's endpoint saw the event before ours
            # serves the state — give it back, retry next deal
            self.leases.release(tid, self.worker_id, now,
                                self.config.max_attempts)
            return 0
        node._inc("tasks_seen")
        node.db.store_task(tid, grant.model, task.fee, task.owner,
                           task.blocktime, 0, "")
        node.db.queue_job("task", {"taskid": tid}, concurrent=True)
        node.obs.event("lease_granted", taskid=tid,
                       worker=self.worker_id,
                       attempts=grant.attempts,
                       stolen=grant.stolen)
        return 1

    # -- cross-process commit dedupe --------------------------------------
    def commit_guard(self, taskid: str, cid: str) -> bool:
        node = self._node
        now = node.chain.now if node is not None else 0
        validator = node.chain.address if node is not None else ""
        ok = self.leases.claim_commit(taskid, validator, self.worker_id,
                                      cid, now)
        if not ok and node is not None:
            node.obs.registry.counter(
                "arbius_fleet_commit_dedup_total",
                "Commitments skipped because another fleet worker holds "
                "the task's commit rights (docs/fleet.md)").inc()
        return ok


def make_worker_id(index: int) -> str:
    return f"worker-{index}"
