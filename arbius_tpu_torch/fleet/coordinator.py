"""FleetCoordinator — owns the event stream, feeds the lease plane.

The coordinator is the fleet's only subscriber to TaskSubmitted: it
converts chain task events into `pending` lease rows (filtered to the
fleet's registered models) and sweeps expired leases back to pending so
a dead worker's tasks are re-dealt within the TTL. It holds no solve
state — everything it knows lives in the chain and the lease table, so
a coordinator crash loses nothing: the replacement re-polls the event
stream from its start block and `INSERT OR IGNORE` absorbs the replay
while the lease table on disk still holds every in-flight lease
(simnet's coordinator-crash scenario pins this).

Workers never talk to the coordinator directly — the lease table IS
the interface (work-stealing `acquire`, heartbeats, settlement), which
is what makes the fleet multi-process: there is no RPC between fleet
members, only sqlite file locking on one shared database.
"""
# detlint: enforce[DET101,DET102,DET103,DET105]
from __future__ import annotations

import logging

from arbius_tpu_torch.fleet.lease import LeaseTable
from arbius_tpu_torch.node.config import FleetConfig
from arbius_tpu_torch.obs import use_obs

log = logging.getLogger("arbius.fleet")


class FleetCoordinator:
    def __init__(self, chain, leases: LeaseTable, model_ids,
                 config: FleetConfig, obs=None, sidecar=None):
        self.chain = chain
        self.leases = leases
        self.model_ids = set(model_ids)
        self.config = config
        # fleetscope sidecar (docs/fleetscope.md): the coordinator's
        # own registry/journal persist alongside the workers' so the
        # federated view covers the deal side of every trace chain
        self.sidecar = sidecar
        self._ticks = 0
        if obs is None:
            from arbius_tpu_torch.obs import Obs

            obs = Obs(now_fn=lambda: self.chain.now)
        self.obs = obs
        reg = self.obs.registry
        self._c_tasks = reg.counter(
            "arbius_fleet_tasks_total",
            "Tasks entered into the fleet lease plane (docs/fleet.md)")
        # labeled callback gauge: the lease table is the source of
        # truth, scraped at collect time per state
        reg.gauge("arbius_fleet_leases",
                  "Lease rows by state (scraped from the shared lease "
                  "table; docs/fleet.md)", labelnames=("state",),
                  fn=self.leases.counts)
        self.chain.subscribe(self._on_event)

    # -- event intake -----------------------------------------------------
    def _on_event(self, ev) -> None:
        if ev.name != "TaskSubmitted":
            return
        with use_obs(self.obs):
            taskid = "0x" + ev.args["id"].hex()
            model = "0x" + ev.args["model"].hex()
            if model not in self.model_ids:
                return
            if self.leases.add_task(taskid, model, ev.args["fee"],
                                    self.chain.now, self.chain.now):
                self._c_tasks.inc()

    # -- the coordinator's loop body --------------------------------------
    def tick(self) -> int:
        """One coordinator pass: pull the event stream (pull backends),
        then sweep expired leases. Returns the number reclaimed."""
        with use_obs(self.obs):
            poll = getattr(self.chain, "poll_events", None)
            if poll is not None:
                try:
                    poll()
                except Exception as e:  # noqa: BLE001 — endpoint flake
                    log.warning("fleet event poll failed (will retry): "
                                "%r", e)
            reclaimed = self.leases.reclaim(self.chain.now,
                                            self.config.max_attempts)
            for taskid, dead, lag in reclaimed:
                log.info("lease %s reclaimed from %s (%ds past its "
                         "heartbeat)", taskid, dead, lag)
            self._ticks += 1
            if self.sidecar is not None and \
                    self._ticks % self.config.sidecar_flush_every == 0:
                self.sidecar.flush(self.chain.now)
            return len(reclaimed)

    def run(self, *, stop=None) -> None:
        """Production loop (one process): poll + sweep at the same
        cadence a node ticks. `stop()` → True ends it."""
        import time as _time

        while not (stop and stop()):
            self.tick()
            _time.sleep(self.config.lease_ttl / 4.0)
