"""Fleet simnet — multi-node scenarios and the task-flood soak.

Two harnesses share this module:

`FleetSimHarness` extends the single-node `SimHarness` world with a
real fleet over the signed-tx stack: a coordinator (RpcChain polling
through the fault plane) feeding the shared lease table, and N worker
`MinerNode`s — each with its own wallet, its own sqlite checkpoint,
and its own `FaultTransport` into the one devnet — racing the same
event stream. Scenario `FleetSpec`s add the fleet failure modes:
worker partitions (a paused worker's leases expire and MUST be stolen
within the TTL), coordinator partitions (intake stalls, mining
continues), and a coordinator crash-restart that rebuilds from the
on-disk lease table plus a from-genesis event re-poll. SIM111 audits
the fleet invariants on top of the applicable SIM1xx set.

`FleetFloodHarness` is the load half (`tools/simsoak.py --flood N`):
10k+ tasks through a fleet over the in-process engine facade
(`LocalChain` — no signing, the protocol-fidelity-under-faults job
belongs to the signed-stack scenarios above). It exists to prove the
operational bounds at load: worker task/solve backlogs never exceed
their configured bound (the CONC302 story at fleet scale — the lease
table, not worker memory, absorbs the flood), every lease settles,
commit dedupe holds, and NodeDB's one-fsync-per-tick batching keeps
the sqlite commit count sub-linear in tasks. Reports are
byte-identical per (tasks, workers, seed).

Copy of arbius_tpu/sim/fleet.py for the port. The reference's `aot_dir`
(a shared AOT executable cache under meshsolve's probe runner) needs the
AOT cache, which the port does not have yet: `FleetSimHarness` refuses it
with `ValueError` naming ROADMAP queue 1 item 12, and every worker mines
with the hash-fake `FaultyRunner`.
"""
# detlint: enforce[DET101,DET102,DET103,DET105]
from __future__ import annotations

import os

from arbius_tpu_torch.chain.rpc_client import EngineRpcClient
from arbius_tpu_torch.chain.wallet import Wallet
from arbius_tpu_torch.fleet import (
    FleetCoordinator,
    LeaseFeed,
    LeaseTable,
    make_worker_id,
)
from arbius_tpu_torch.node import (
    MinerNode,
    MiningConfig,
    ModelConfig,
    ModelRegistry,
    NodeDB,
    RegisteredModel,
)
from arbius_tpu_torch.node.config import FleetConfig, PipelineConfig, SLOConfig
from arbius_tpu_torch.node.rpc_chain import RpcChain
from arbius_tpu_torch.obs import use_obs
from arbius_tpu_torch.obs.fleetscope import (
    ObsSidecar,
    evaluate_slo,
    latency_summary,
    sidecar_path,
)
from arbius_tpu_torch.sim.faults import (
    AuditedRpcChain,
    FaultTransport,
    FaultyRunner,
    SimPinner,
)
from arbius_tpu_torch.sim.harness import (
    CHAIN_ID,
    KEY_MINER,
    _HEARTBEATS,
    SimHarness,
    SimResult,
)
from arbius_tpu_torch.node.db import Job
from arbius_tpu_torch.sim.scenario import Scenario
from arbius_tpu_torch.templates.engine import load_template

# coordinator wallet: polls logs, never transacts — needs no funding
KEY_COORD = "0x" + "c0" * 32


def worker_key(index: int) -> str:
    """Worker 0 IS the base harness miner (KEY_MINER), so the plane's
    crash trigger and the single-node checkers keep their anchor;
    workers 1.. vary the last byte."""
    if index == 0:
        return KEY_MINER
    return "0x" + "a1" * 31 + f"{0xb0 + index:02x}"


def _in_window(r: int, window: tuple) -> bool:
    return bool(window) and window[0] <= r < window[1]


class FleetSimHarness(SimHarness):
    """SimHarness world + a fleet instead of one node. The scenario
    MUST carry a FleetSpec. Workers run with the staged pipeline OFF
    (the fleet layer is schedule-transparent; pipeline×fault coverage
    is the single-node matrix's job). `aot_dir` is refused (the module
    docstring)."""

    def __init__(self, scenario: Scenario, seed: int, workdir: str,
                 node_cls: type[MinerNode] = MinerNode,
                 aot_dir: str | None = None,
                 healthwatch: bool = False):
        if scenario.fleet is None:
            raise ValueError(f"scenario {scenario.name!r} has no fleet "
                             "spec — use SimHarness")
        if aot_dir is not None:
            raise ValueError(
                f"aot_dir {aot_dir!r}: the AOT cache is not ported yet "
                "(ROADMAP queue 1 item 12)")
        self.workdir = workdir
        self.workers: list[MinerNode] = []
        self.feeds: list[LeaseFeed] = []
        self.sidecars: list[ObsSidecar] = []
        self.leases: LeaseTable | None = None
        self.coordinator: FleetCoordinator | None = None
        self._ticks = 0
        super().__init__(scenario, seed,
                         db_path=os.path.join(workdir, "worker-0.sqlite"),
                         node_cls=node_cls, pipeline=False,
                         witness=False, healthwatch=healthwatch)

    # -- fleet construction ----------------------------------------------
    def _spawn_node(self) -> None:
        """Called once from the base __init__: build the lease plane,
        the coordinator, and every worker. (The base _restart_node path
        is unused — fleet failure modes are pause windows and the
        coordinator crash, driven from _tick.)"""
        spec = self.scenario.fleet
        self.fleet_cfg = FleetConfig(
            enabled=True, workers=spec.workers,
            lease_ttl=spec.lease_ttl, wallet_mode=spec.wallet_mode,
            lease_db=os.path.join(self.workdir, "leases.sqlite"),
            max_leases=spec.max_leases, backlog=spec.backlog,
            max_attempts=spec.max_attempts)
        self.leases = LeaseTable(self.fleet_cfg.lease_db,
                                 self.fleet_cfg.busy_timeout_ms)
        self.coord_wallet = Wallet.from_hex(KEY_COORD)
        self.coordinator = self._build_coordinator()
        from arbius_tpu_torch.chain.fixedpoint import WAD

        for i in range(spec.workers):
            wallet = Wallet.from_hex(worker_key(i))
            if i > 0:
                # extra workers join genesis: funded and staked exactly
                # like the base miner (worker 0 rides the base genesis)
                self.token.mint(wallet.address, 1_000 * WAD)
                self.token.approve(wallet.address.lower(),
                                   self.engine.ADDRESS, 10**30)
                self.engine.validator_deposit(wallet.address,
                                              wallet.address, 400 * WAD)
            self.workers.append(self._build_worker(i, wallet))
        self.node = self.workers[0]
        self.result.db = self.node.db
        self.result.fleet_workers = [w.chain.address
                                     for w in self.workers]

    def _build_coordinator(self) -> FleetCoordinator:
        transport = FaultTransport(self.dev, self.plane)
        client = EngineRpcClient(transport, self.dev.engine_address,
                                 self.coord_wallet, chain_id=CHAIN_ID)
        chain = RpcChain(client, self.dev.token_address)
        coord = FleetCoordinator(chain, self.leases, self.model_ids,
                                 self.fleet_cfg)
        # a restarted coordinator is a NEW obs stream (its journal seqs
        # restart at 1), so each incarnation gets its own sidecar member
        # name — federation sees the restart honestly instead of
        # colliding seqs in one file (docs/fleetscope.md)
        member = "coordinator" if self.result.restarts == 0 \
            else f"coordinator-r{self.result.restarts}"
        coord.sidecar = ObsSidecar(sidecar_path(self.workdir, member),
                                   member, coord.obs)
        self.sidecars.append(coord.sidecar)
        return coord

    def _build_worker(self, index: int, wallet: Wallet) -> MinerNode:
        transport = FaultTransport(self.dev, self.plane)
        tx_guard = None
        if self.fleet_cfg.wallet_mode == "shared":
            wid = make_worker_id(index)
            tx_guard = lambda: self.leases.wallet_guard(  # noqa: E731
                wallet.address, wid)
        client = EngineRpcClient(transport, self.dev.engine_address,
                                 wallet, chain_id=CHAIN_ID,
                                 tx_guard=tx_guard)
        chain = AuditedRpcChain(client, self.dev.token_address,
                                self.plane)
        from arbius_tpu_torch.node.config import AlertsConfig

        cfg = MiningConfig(
            db_path=":memory:",  # unused: db object injected below
            models=tuple(ModelConfig(id=mid, template="anythingv3")
                         for mid in self.model_ids),
            compile_cache_dir=None,
            obs_journal_capacity=16384,
            retry_max_delay=self.result.retry_max_delay,
            pipeline=PipelineConfig(),
            # per-member healthwatch (docs/healthwatch.md): every
            # worker runs its own alert engine; its state gauges ride
            # the sidecar export, so federate() merges fleet health
            alerts=AlertsConfig(enabled=True)
            if self.healthwatch else AlertsConfig(),
            canonical_batch=1)
        runner = FaultyRunner(self.plane)
        registry = ModelRegistry()
        for mid in self.model_ids:
            registry.register(RegisteredModel(
                id=mid, template=load_template("anythingv3"),
                runner=runner))
        db = NodeDB(os.path.join(self.workdir,
                                 f"worker-{index}.sqlite"))
        node = self.node_cls(chain, cfg, registry, db=db, store=None,
                             pinner=SimPinner(self.plane))
        node._retry_sleep = self.clock.sleep
        wid = make_worker_id(index)
        feed = LeaseFeed(self.leases, wid, self.fleet_cfg).attach(node)
        sidecar = ObsSidecar(sidecar_path(self.workdir, wid), wid,
                             node.obs)
        feed.attach_sidecar(sidecar, every=4)
        self.feeds.append(feed)
        self.sidecars.append(sidecar)
        node.boot(skip_self_test=True)
        return node

    def _crash_coordinator(self) -> None:
        """Kill + replace the coordinator: the replacement opens the
        same on-disk lease table and re-polls events from genesis (the
        db's INSERT OR IGNORE absorbs the replay) — nothing but the
        poll cursor is lost, which is the lease-recovery claim."""
        self.plane.count("coordinator_crash")
        self.result.restarts += 1
        self.coordinator = self._build_coordinator()

    # -- driving -----------------------------------------------------------
    def _tick(self) -> int:
        spec = self.scenario.fleet
        self._ticks += 1
        r = self._ticks
        if spec.crash_coordinator_round is not None \
                and r == spec.crash_coordinator_round:
            self._crash_coordinator()
        if not _in_window(r, spec.pause_coordinator):
            self.coordinator.tick()
        done = 0
        for i, worker in enumerate(self.workers):
            if spec.pause_worker and spec.pause_worker[0] == i \
                    and _in_window(r, spec.pause_worker[1:]):
                continue
            done += worker.tick()
        return done

    def _pending_jobs(self) -> list:
        jobs = []
        for worker in self.workers:
            jobs.extend(j for j in worker.db.get_jobs(2**60, limit=1000)
                        if j.method not in _HEARTBEATS)
        counts = self.leases.counts()
        if counts.get("pending", 0) + counts.get("leased", 0) > 0:
            # unsettled leases are pending fleet work even when no
            # worker has pulled them yet — keep the drain loop alive
            # (due now: the next tick's pumps can act immediately)
            jobs.append(Job(id=-1, priority=0, waituntil=self.clock.now,
                            concurrent=False, method="fleet-lease",
                            data={}))
        return jobs

    def run(self) -> SimResult:
        result = super().run()
        for worker in self.workers[1:]:
            result.journal_events.extend(worker.obs.journal.events())
        result.journal_dropped = sum(w.obs.journal.dropped
                                     for w in self.workers)
        result.worker_dbs = [w.db for w in self.workers]
        result.lease_rows = [dict(r) for r in self.leases.rows()]
        result.lease_history = list(self.leases.history)
        result.lease_counts = self.leases.counts()
        result.commit_rows = [dict(r) for r in self.leases.commit_rows()]
        # final fleetscope flush: every member's last journal segment
        # lands before federation reads the sidecars (the files stay on
        # disk for post-mortems — result.sidecar_dir points at them)
        now = self.clock.now
        for feed in self.feeds:
            feed.flush_sidecar(now)
        if self.coordinator is not None and \
                self.coordinator.sidecar is not None:
            self.coordinator.sidecar.flush(now)
        for sidecar in self.sidecars:
            sidecar.close()
        result.sidecar_dir = self.workdir
        return result


def run_fleet_scenario(scenario: Scenario, seed: int, *, workdir: str,
                       node_cls: type[MinerNode] = MinerNode,
                       aot_dir: str | None = None,
                       healthwatch: bool = False) -> SimResult:
    """One-call front door for fleet scenarios (the fleet analogue of
    harness.run_scenario); `node_cls` injects buggy WORKERS
    (sim/bugs.py double-lease), `aot_dir` is refused, `healthwatch`
    runs the per-member alert engine and puts the run under SIM113's
    fault→alert coverage audit (docs/healthwatch.md)."""
    return FleetSimHarness(scenario, seed, workdir,
                           node_cls=node_cls, aot_dir=aot_dir,
                           healthwatch=healthwatch).run()


# ---------------------------------------------------------------------------
# the flood soak
# ---------------------------------------------------------------------------

class _FloodRunner:
    """FaultyRunner's pure-hash solve without the fault plane: flood
    bytes must be deterministic and instant."""

    def __call__(self, hydrated: dict, seed: int) -> dict:
        import hashlib
        import json

        canon = json.dumps(
            {k: v for k, v in hydrated.items() if k != "seed"},
            sort_keys=True).encode()
        blob = hashlib.sha256(canon + seed.to_bytes(8, "big")).digest()
        return {"out-1.png": b"\x89PNG" + blob}


class FleetFloodHarness:
    """`tasks` lifecycles through a `workers`-node fleet over the
    in-process engine. See the module docstring for what this proves
    (bounds at load) and what it deliberately skips (signing)."""

    def __init__(self, tasks: int, workers: int, workdir: str, *,
                 seed: int = 0, burst: int = 200, backlog: int = 64,
                 max_leases: int = 32, canonical_batch: int = 4,
                 slo: SLOConfig | None = None):
        import json

        from arbius_tpu_torch.chain import Engine
        from arbius_tpu_torch.chain.fixedpoint import WAD
        from arbius_tpu_torch.chain.token import TokenLedger
        from arbius_tpu_torch.node import LocalChain

        self.tasks = tasks
        self.n_workers = workers
        self.seed = seed
        self.burst = burst
        self.slo = slo if slo is not None else SLOConfig()
        self.workdir = workdir
        self._json = json
        self.token = TokenLedger()
        self.engine = Engine(self.token, start_time=100_000)
        self.token.mint(Engine.ADDRESS, 600_000 * WAD)
        self.user = "0x" + "b2" * 20
        addrs = ["0x" + "a1" * 19 + f"{0xa0 + i:02x}"
                 for i in range(workers)]
        for a in [self.user] + addrs:
            self.token.mint(a, 1_000_000 * WAD)
            self.token.approve(a, Engine.ADDRESS, 10**40)
        self.token.transfer(Engine.ADDRESS, "0x" + "99" * 20,
                            100_000 * WAD)
        for a in addrs:
            self.engine.validator_deposit(a, a, 400 * WAD)
        mid_b = self.engine.register_model(
            self.user, self.user, 0, b'{"meta":{"title":"flood"}}')
        self.model_id = "0x" + mid_b.hex()
        self.fleet_cfg = FleetConfig(
            enabled=True, workers=workers, lease_ttl=600,
            lease_db=os.path.join(workdir, "flood-leases.sqlite"),
            max_leases=max_leases, backlog=backlog,
            max_attempts=4)
        self.leases = LeaseTable(self.fleet_cfg.lease_db,
                                 self.fleet_cfg.busy_timeout_ms)
        self.coordinator = FleetCoordinator(
            LocalChain(self.engine, "0x" + "c0" * 20), self.leases,
            [self.model_id], self.fleet_cfg)
        runner = _FloodRunner()
        self.workers: list[MinerNode] = []
        self._feeds: list[LeaseFeed] = []
        for i, a in enumerate(addrs):
            registry = ModelRegistry()
            registry.register(RegisteredModel(
                id=self.model_id, template=load_template("anythingv3"),
                runner=runner))
            cfg = MiningConfig(
                models=(ModelConfig(id=self.model_id,
                                    template="anythingv3"),),
                compile_cache_dir=None,
                canonical_batch=canonical_batch)
            node = MinerNode(
                LocalChain(self.engine, a), cfg, registry,
                db=NodeDB(os.path.join(workdir, f"flood-{i}.sqlite")),
                store=None, pinner=None)
            wid = make_worker_id(i)
            feed = LeaseFeed(self.leases, wid, self.fleet_cfg
                             ).attach(node)
            # flood sidecars flush ONLY at close (flood wall time is a
            # pinned tier-1 budget — the final segment is all the bench
            # flood stage needs to federate)
            self._feeds.append(feed.attach_sidecar(
                ObsSidecar(sidecar_path(workdir, wid), wid, node.obs),
                every=10**9))
            node.boot(skip_self_test=True)
            self.workers.append(node)
        self.user_chain = LocalChain(self.engine, self.user)

    def _submit(self, i: int) -> None:
        from arbius_tpu_torch.chain.fixedpoint import WAD

        self.user_chain.submit_task(
            0, self.user, self.model_id, 1 * WAD,
            self._json.dumps({"prompt": f"flood {self.seed} {i}",
                              "negative_prompt": ""},
                             sort_keys=True).encode())

    def run(self) -> dict:
        """Drive to quiescence; returns the deterministic report."""
        backlog_methods = ("task", "solve", "pinTaskInput")
        max_backlog = [0] * self.n_workers
        max_pending = 0
        submitted = 0
        rounds = 0
        max_rounds = self.tasks // max(1, self.burst) \
            + self.tasks // 50 + 400
        from contextlib import ExitStack, contextmanager

        @contextmanager
        def _batched(w):
            # the window's exit-commit must run under the worker's own
            # obs so arbius_db_commits_total attributes per worker
            with use_obs(w.obs):
                with w.db.batch():
                    yield

        while rounds < max_rounds:
            rounds += 1
            # a round-wide batch window on EVERY worker db: in-process
            # LocalChain pushes hit other workers' dbs synchronously
            # (an artifact of the whole fleet sharing one process —
            # a real fleet worker only receives events via its own
            # poll, inside its own tick's window), so without this the
            # flood measures a fsync schedule no production fleet has
            with ExitStack() as stack:
                for w in self.workers:
                    stack.enter_context(_batched(w))
                while submitted < self.tasks \
                        and submitted < rounds * self.burst:
                    self._submit(submitted)
                    submitted += 1
                self.coordinator.tick()
                open_jobs = []
                for i, w in enumerate(self.workers):
                    with use_obs(w.obs):
                        w.tick()
                    depth = w.db.count_jobs(backlog_methods)
                    if depth > max_backlog[i]:
                        max_backlog[i] = depth
                    open_jobs.extend(
                        j for j in w.db.get_jobs(2**60, limit=100000)
                        if j.method not in _HEARTBEATS)
            counts = self.leases.counts()
            pending = counts.get("pending", 0)
            if pending > max_pending:
                max_pending = pending
            open_leases = pending + counts.get("leased", 0)
            if submitted >= self.tasks and not open_jobs \
                    and open_leases == 0:
                break
            if submitted >= self.tasks and open_jobs:
                due = [j for j in open_jobs
                       if j.waituntil <= self.engine.now]
                if not due and open_leases == 0:
                    nxt = min(j.waituntil for j in open_jobs)
                    if nxt > self.engine.now:
                        self.engine.advance_time(nxt - self.engine.now,
                                                 blocks=0)
            self.engine.advance_time(5, blocks=0)
            self.engine.mine_block()
        claimed = sum(1 for s in self.engine.solutions.values()
                      if s.claimed)
        per_worker: dict[str, int] = {}
        for s in self.engine.solutions.values():
            per_worker[s.validator] = per_worker.get(s.validator, 0) + 1
        db_commits = {
            make_worker_id(i): int(w.obs.registry.counter(
                "arbius_db_commits_total").value())
            for i, w in enumerate(self.workers)}
        dedup = sum(1 for h in self.leases.history
                    if h[0] == "commit_dedup")
        return {
            "tasks": self.tasks,
            "workers": self.n_workers,
            "seed": self.seed,
            "rounds": rounds,
            "claimed": claimed,
            "per_worker_solutions": dict(sorted(per_worker.items())),
            "backlog_bound": self.fleet_cfg.backlog,
            "max_backlog": {make_worker_id(i): d
                            for i, d in enumerate(max_backlog)},
            "max_pending_leases": max_pending,
            "lease_counts": dict(sorted(self.leases.counts().items())),
            "commit_dedup": dedup,
            "db_commits": db_commits,
            "slo": self._slo_report(),
        }

    def _slo_report(self) -> dict:
        """Byte-deterministic SLO block (docs/fleetscope.md): every
        latency is CHAIN time — queue wait from the lease table's trace
        hops (deal → first acquire), time-to-commit from the engine's
        exact task/solution blocktimes, steal lag from the hop chain's
        recorded lags — estimated through the centralized fixed-bucket
        edges (p50/p95/p99). Wall-clock quantities (chip-idle fraction)
        are deliberately excluded here: they belong to bench/live
        scrapes, never to a byte-identical report."""
        import json as _json

        queue_waits: list[int] = []
        steal_lags: list[int] = []
        for row in self.leases.rows():
            hops = _json.loads(row["hops"] or "[]")
            for h in hops:
                if h.get("op") in ("acquire", "steal"):
                    queue_waits.append(int(h["now"])
                                       - int(row["blocktime"]))
                    break
            steal_lags.extend(int(h["lag"]) for h in hops
                              if "lag" in h)
        commits = [int(s.blocktime - self.engine.tasks[t].blocktime)
                   for t, s in self.engine.solutions.items()
                   if t in self.engine.tasks]
        report = {
            "queue_wait_seconds": latency_summary(sorted(queue_waits)),
            "time_to_commit_seconds": latency_summary(sorted(commits)),
            "steal_lag_seconds": latency_summary(sorted(steal_lags)),
            "thresholds": {
                "queue_wait_p95": self.slo.queue_wait_p95,
                "time_to_commit_p99": self.slo.time_to_commit_p99,
                "steal_lag_p99": self.slo.steal_lag_p99,
            },
        }
        report["breaches"] = evaluate_slo(self.slo, report)
        report["ok"] = not report["breaches"]
        return report

    def close(self) -> None:
        now = self.engine.now
        for feed in self._feeds:
            feed.flush_sidecar(now)
            if feed._sidecar is not None:
                feed._sidecar.close()
        for w in self.workers:
            w.close()
        self.leases.close()


def flood_findings(report: dict):
    """Audit a flood report: the bounds the soak exists to prove.
    Returns SimFindings (rule SIM111) so the CLI's exit contract and
    rendering are the scenario machinery's."""
    from arbius_tpu_torch.sim.invariants import SimFinding

    out = []

    def find(msg):
        out.append(SimFinding(rule="SIM111", message=msg,
                              scenario="flood", seed=report["seed"]))

    if report["claimed"] != report["tasks"]:
        find(f"flood lost tasks: {report['claimed']}/{report['tasks']} "
             "claimed")
    bound = report["backlog_bound"]
    for wid, depth in sorted(report["max_backlog"].items()):
        if depth > bound:
            find(f"worker {wid} task/solve backlog hit {depth} > "
                 f"configured bound {bound} — the lease pull gate "
                 "failed to exert backpressure (CONC302 at load)")
    for state, n in sorted(report["lease_counts"].items()):
        if state not in ("done", "invalid", "failed"):
            find(f"{n} lease(s) stuck non-terminal in state {state!r} "
                 "after drain")
    # the SLO layer (docs/fleetscope.md): a declared objective that the
    # measured chain-time percentiles breach fails the soak — SLO101,
    # the acceptance gate the million-task nightly will stand on
    for breach in (report.get("slo") or {}).get("breaches", ()):
        out.append(SimFinding(rule="SLO101", message=breach,
                              scenario="flood", seed=report["seed"]))
    return out
