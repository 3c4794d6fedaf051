"""MinerNode — the event loop, job processors, and solver pipeline (L3').

Mirror of `miner/src/index.ts` restructured for in-process TPU inference:
chain events enqueue jobs in sqlite; `tick()` drains due jobs in the
reference's two-phase order (concurrent batch, then serial); the solve
path replaces the cog-HTTP hop with registry runners and — the TPU win —
groups compatible solve jobs into one dp-batched XLA dispatch.

Reference call-stack parity (SURVEY.md §3):
  boot self-test golden CID        index.ts:984-1001 → boot()
  event → task job                 index.ts:191-201  → _on_task_submitted
  processTask (filter+hydrate)     index.ts:506-564  → _process_task
  processSolve (cid→commit→reveal) index.ts:566-672  → _process_solve_batch
  contest-on-mismatch              index.ts:651-670  → same
  processClaim                     index.ts:728-750  → _process_claim
  stake auto-top-up                index.ts:397-472  → _process_validator_stake
  automine                         index.ts:474-503  → _process_automine
  vote-if-invalid                  index.ts:268-306  → _on_contestation

Time/blocks come from the chain facade — no wall clock — so tests drive
the node deterministically.

Copy of arbius_tpu/node/node.py for the port. What reaches JAX or an
unported module changes:
  - `MinerNode` refuses, with `BootError` naming the ROADMAP item that
    ports it, every setting that needs a module the port lacks: a mesh
    layout a configured family does not run on the port yet (anythingv3
    runs dp; the factory's `mesh_refusal`), `aot_cache.enabled`,
    `compile_cache_dir` and `perfscope.enabled` (`_refuse_unported`).
    The mesh is the port's mesh of lanes (parallel/mesh.py): boot builds
    and validates it (a shape larger than the lanes the host has is
    refused with the reference's sentence), sets `solve_layout`, audits
    the contract and gates intake, as the reference does. The AOT cache
    and the perfscope cards are gone from the body; no bucket is
    disk-warm (`bucket_disk_warm`, `_disk_warm_tags` stays empty).
    `_observe_infer` feeds the
    cost-tagged infer sample only (no perfscope card to bind). The
    staged pipeline (`pipeline.enabled`, node/pipeline.py), the alert
    engine (`alerts.enabled`, obs/healthwatch.py: its `perf_drift` and
    `aot_reject_storm` rules stay ok, as the reference's do with
    perfscope and the AOT cache off) and the fleet worker hooks
    (`fleet.enabled`, fleet/) are the reference's.
  - The reference's attention-impl check has no counterpart: the port's
    ops/flash.py picks its route by a fixed rule and has no override.
  - The boot self-test solves the golden at the canonical batch
    (`solve_cid_batch`, padded), the determinism class the node mines
    in: cuBLAS and cuDNN pick kernels by batch size. It runs through the
    model's runner, which the factory built in the model's precision
    mode, so an int8 or fp8 golden is solved in its own mode.
  - `profile_dir`/`profile_every` write a `torch.profiler` Chrome trace
    of every Nth solve dispatch.
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
import time

from arbius_tpu_torch.l0.commitment import taskid2seed
from arbius_tpu_torch.node.chain_client import EngineError, LocalChain
from arbius_tpu_torch.node.config import MiningConfig
from arbius_tpu_torch.node.db import Job, NodeDB
from arbius_tpu_torch.node.retry import RetriesExhausted, expretry
from arbius_tpu_torch.node.solver import ModelRegistry, solve_cid_batch
from arbius_tpu_torch.obs import Obs, span, use_obs
from arbius_tpu_torch.templates.engine import (
    HydrationError,
    MiningFilter,
    check_model_filter,
    hydrate_input,
)

log = logging.getLogger("arbius.node")

MINER_VERSION = 0  # versionCheck: chain version must be <= ours

# lifecycle counters, exposed as arbius_<name>_total on GET /metrics and
# as attributes of the NodeMetrics back-compat view
_COUNTERS = {
    "solutions_submitted": "Solutions revealed on-chain",
    "solutions_claimed": "Solution rewards claimed",
    "contestations_submitted": "Contestations this node initiated",
    "votes_cast": "Contestation votes cast",
    "vote_finishes": "contestationVoteFinish calls that paid out",
    "tasks_seen": "TaskSubmitted events observed",
    "tasks_invalid": "Tasks marked invalid (bad version or input)",
}


class NodeMetrics:
    """Back-compat view over the obs registry (docs/observability.md).

    Pre-obs this was a dataclass of ints and rolling deques; the registry
    is now the single source of truth and this view derives the same
    attribute surface from it: counter attributes read the
    `arbius_*_total` counters, `solve_latency` / `stage_seconds` read the
    histograms' bounded recent-sample windows.
    """

    def __init__(self, obs: Obs):
        self._obs = obs

    def __getattr__(self, name: str):
        if name == "tasks_unprofitable":
            # per-model labeled since the costsched PR (a mispriced
            # family must be visible) — the back-compat attribute is
            # the sum over every model child
            c = self._obs.registry.counter(
                "arbius_tasks_unprofitable_total", labelnames=("model",))
            return int(sum(c.summary().values()))
        if name in _COUNTERS:
            return int(self._obs.registry.counter(
                f"arbius_{name}_total").value())
        raise AttributeError(name)

    @property
    def solve_latency(self) -> list:
        """Recent (taskid, chain-seconds) pairs, newest last."""
        return self._obs.registry.histogram(
            "arbius_solve_latency_chain_seconds").recent()

    @property
    def stage_seconds(self) -> dict:
        """Recent wall-clock seconds per solve stage: infer = model +
        encode + CID for a bucket dispatch; commit = chain txs for the
        bucket (SURVEY.md §5 tracing)."""
        h = self._obs.registry.histogram("arbius_stage_seconds",
                                         labelnames=("stage",))
        return {"infer": h.values(stage="infer"),
                "commit": h.values(stage="commit")}


class BootError(RuntimeError):
    pass


@contextlib.contextmanager
def _chrome_trace(directory: str, name: str):
    """Profile the block on the host and, where there is one, the CUDA
    device; write a Chrome trace to `directory`/`name`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(directory, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(directory, name))


def _refuse_unported(config: MiningConfig) -> None:
    """BootError for every setting whose module the port does not have
    yet, naming the ROADMAP.md queue 1 item that ports it."""
    from arbius_tpu_torch.node.factory import mesh_refusal

    why = mesh_refusal(None, config.mesh)
    if why:
        raise BootError(why)
    for m in config.models:
        why = mesh_refusal(m.template, config.mesh) if m.enabled else None
        if why:
            raise BootError(f"model {m.id}: {why}")
    refused = (
        (config.aot_cache.enabled, "aot_cache.enabled", 12),
        (bool(config.compile_cache_dir), "compile_cache_dir", 12),
        (config.perfscope.enabled, "perfscope.enabled", 12),
    )
    for on, name, item in refused:
        if on:
            raise BootError(f"{name}: not ported yet (ROADMAP queue 1 "
                            f"item {item})")


class MinerNode:
    def __init__(self, chain: LocalChain, config: MiningConfig,
                 registry: ModelRegistry, db: NodeDB | None = None,
                 store=None, pinner=None):
        _refuse_unported(config)
        self.chain = chain
        self.config = config
        self.registry = registry
        self.mesh = None          # built + validated at boot (cfg.mesh)
        self.db = db or NodeDB(config.db_path)
        if store is None and config.store_dir:
            from arbius_tpu_torch.node.store import ContentStore

            store = ContentStore(config.store_dir)
        self.store = store
        if pinner is None:
            from arbius_tpu_torch.node.pinners import build_pinner

            pinner = build_pinner(config.ipfs, store)
        self.pinner = pinner
        self.obs = Obs(journal_capacity=config.obs_journal_capacity,
                       now_fn=lambda: self.chain.now,
                       enabled=config.obs_enabled)
        reg = self.obs.registry
        for name, help_text in _COUNTERS.items():
            reg.counter(f"arbius_{name}_total", help_text)
        self._c_unprofitable = reg.counter(
            "arbius_tasks_unprofitable_total",
            "Tasks skipped by the profitability gate, by model — a "
            "mispriced family shows up as its own series "
            "(docs/scheduler.md)", labelnames=("model",))
        self._h_stage = reg.histogram(
            "arbius_stage_seconds",
            "Wall-clock seconds per solve stage (infer=model+encode+CID "
            "per bucket dispatch, commit=chain txs per bucket)",
            labelnames=("stage",))
        self._h_latency = reg.histogram(
            "arbius_solve_latency_chain_seconds",
            "Chain-time seconds from solve dispatch to accepted solution")
        self._c_jobs_failed = reg.counter(
            "arbius_jobs_failed_total",
            "Jobs quarantined to failed_jobs, by method",
            labelnames=("method",))
        reg.gauge("arbius_queue_depth",
                  "Jobs currently in the queue (due or waiting)",
                  fn=self.db.job_count)
        self._c_idle = reg.counter(
            "arbius_chip_idle_seconds_total",
            "Seconds the solve path spent with nothing dispatched on the "
            "device (the host+network tail the pipeline exists to hide)")
        self.metrics = NodeMetrics(self.obs)
        self._retry_sleep = lambda s: None  # injectable; chain time is fake
        # fleet worker mode (docs/fleet.md), wired by LeaseFeed.attach:
        # `task_feed` replaces the TaskSubmitted subscription as the
        # task source (its pump() runs at the top of every tick — the
        # lease heartbeat woven into the tick), and `commit_guard` is
        # consulted before every signalCommitment so two fleet workers
        # never double-commit one (validator, taskid). Both None = the
        # bare single-node miner, bit-for-bit.
        self.task_feed = None
        self.commit_guard = None
        # live alert engine (docs/healthwatch.md): installed at
        # construction so the reference is
        # published before any RPC request thread can exist (the
        # /debug/alerts view reads it). Unclean-shutdown evidence is
        # read from the checkpoint HERE, before boot clears heartbeats
        # or any tick queues fresh work: a fresh db holds no jobs, a
        # checkpoint with in-flight work means the previous life died
        # mid-mine (the crash_recovered rule). None = no evaluation,
        # the pre-healthwatch node bit-for-bit.
        self.healthwatch = None
        if config.alerts.enabled:
            from arbius_tpu_torch.obs.healthwatch import HealthWatch

            self.healthwatch = HealthWatch(
                self.obs, config.alerts, slo=config.slo,
                recovered=any(
                    j.method not in ("validatorStake", "automine")
                    for j in self.db.get_jobs(2**60, limit=50)))
        # the AOT cache is not ported (refused at boot): no bucket is
        # disk-warm. The control RPC's /debug/costmodel reads it.
        self._disk_warm_tags: frozenset = frozenset()
        # mesh-layout tag of the solve programs (part of every cost-model
        # key: a tp2 bucket and a single-device bucket are different
        # programs with different chip-seconds); refined at boot once
        # the mesh is up
        self.solve_layout = "single"
        # per-model precision modes (docs/quantization.md): fixed at
        # config load — part of every bucket key and cost tag, so an
        # int8 bucket never shares a dispatch, a cost row, or a warm
        # signal with its bf16 twin
        self.solve_modes = {m.id.lower(): config.precision.mode_for(m.template)
                            for m in config.models}
        # learned chip-seconds table (docs/scheduler.md): always
        # constructed — the gate consults it whenever rows have accrued,
        # and with an empty table every prediction is None, so the gate
        # is bit-for-bit the static path (test-pinned)
        from arbius_tpu_torch.node.costmodel import CostModel

        # guards the scheduler-state surface shared with the ControlRPC
        # request threads (docs/concurrency.md): the learned cost table,
        # the packer's warm set + last pack order, and the boot-refined
        # solve_layout — everything GET /debug/costmodel snapshots while
        # the tick thread mutates it. Lock order is state_lock → db lock
        # (the tick's refit persists while holding it); nothing takes
        # them in reverse (conclint CONC402 audits the claim).
        self.state_lock = threading.Lock()
        self.costmodel = CostModel(min_samples=config.sched.min_samples)
        # no other thread exists yet, so this lock excludes nobody —
        # it is held so that EVERY call site of costmodel.load() holds
        # it, which is what proves (to conclint's interprocedural
        # held-set and to any future mid-life reload caller) that the
        # rows table is mutated only under the state lock
        with self.state_lock:
            self.costmodel.load(self.db)
        from arbius_tpu_torch.node.sched import CostSched, FifoSched

        self._sched = CostSched(self, config.sched) \
            if config.sched.enabled else FifoSched()
        self._pipeline = None
        if config.pipeline.enabled:
            from arbius_tpu_torch.node.pipeline import SolvePipeline

            self._pipeline = SolvePipeline(self, config.pipeline)

    def close(self) -> None:
        """Release owned resources: encode pool threads, then the sqlite
        handle. Safe to call more than once."""
        if self._pipeline is not None:
            self._pipeline.shutdown()
        self.db.close()

    # -- boot (start.ts:11-52 + index.ts:971-1020) -----------------------
    def boot(self, *, skip_self_test: bool = False) -> None:
        # solve mesh (docs/multichip.md): built and validated here — a
        # shape that does not fit the lanes the host has dies at boot
        # with one clear sentence. Also publishes arbius_mesh_devices and
        # audits the layout against each family's contract.
        # (build_registry builds its own mesh for the runners from the
        # same config, so the two always agree.)
        from arbius_tpu_torch.parallel import meshsolve

        self.mesh = meshsolve.boot_mesh(self.config.mesh,
                                        registry=self.obs.registry)
        # fleet-composition surface (docs/quantization.md): how many
        # enabled models this node serves at each precision mode — the
        # signal a mixed-precision fleet's pricing/packing reads
        modes_gauge = self.obs.registry.gauge(
            "arbius_precision_models",
            "Enabled models served at each precision mode (bf16 = the "
            "historic full-width programs; docs/quantization.md)",
            labelnames=("mode",))
        for mode in sorted({"bf16"} | set(self.solve_modes.values())):
            modes_gauge.set(float(sum(
                1 for m in self.config.models if m.enabled
                and self.solve_modes.get(m.id.lower()) == mode)),
                mode=mode)
        if self.mesh is not None:
            from arbius_tpu_torch.parallel.mesh import mesh_tag

            # cost-model rows are keyed per layout (under the state lock:
            # an early-started ControlRPC debug view must never read the
            # tag mid-publication)
            with self.state_lock:
                self.solve_layout = mesh_tag(self.mesh)
        from arbius_tpu_torch.node.factory import mesh_contracts

        meshsolve.check_mesh_contract(self.mesh,
                                      mesh_contracts(self.config),
                                      self.config.canonical_batch)
        self.db.clear_jobs_by_method("validatorStake")
        self.db.clear_jobs_by_method("automine")
        if self.chain.version() > MINER_VERSION:
            raise BootError(
                f"chain version {self.chain.version()} > miner {MINER_VERSION}"
                " — update the node (index.ts:960-969)")
        if not skip_self_test:
            self._boot_self_test()
        delegated = getattr(self.chain, "validator_address", self.chain.address)
        if delegated != self.chain.address:
            # the reference's seam exactly (blockchain.ts:44-67, disabled
            # there too): stake management redirects, but submitSolution
            # credits/validates msg.sender — so the SIGNER must hold its
            # own stake to mine until a delegation contract exists.
            # EngineV1.sol:398-404 gate.
            log.warning(
                "delegated_validator %s: stake reads/top-ups target the "
                "delegated address, but solutions are still submitted (and "
                "gated on-chain) as the node wallet %s — the wallet itself "
                "must hold validator stake to mine; delegated SOLVING needs "
                "the (unshipped) reference solver contract",
                delegated, self.chain.address)
        self.db.queue_job("validatorStake", {}, priority=100)
        if self.config.automine.enabled:
            self.db.queue_job("automine", {}, priority=10)
        self.chain.subscribe(self._on_event)
        log.info("node booted: %d models, address %s",
                 len(self.registry.ids()), self.chain.address)

    def _boot_self_test(self) -> None:
        """Golden-CID reproducibility check before mining anything
        (index.ts:984-1001): nondeterministic hardware must fail loudly
        at boot, not via slashing. The golden is solved at the canonical
        batch, padded, as the node mines."""
        for mid in self.registry.ids():
            m = self.registry.get(mid)
            if m.golden is None:
                continue
            inp, seed, expected = m.golden
            hydrated = hydrate_input(dict(inp), m.template)
            [(got, _)] = solve_cid_batch(
                m, [(hydrated, seed)],
                canonical_batch=self.config.canonical_batch)
            if got.lower() != expected.lower():
                raise BootError(
                    f"boot self-test failed for {mid}: got {got}, "
                    f"expected {expected} — nondeterministic build/hardware")

    def _inc(self, name: str, **labels) -> None:
        self.obs.registry.counter(f"arbius_{name}_total").inc(**labels)

    # -- event handlers ---------------------------------------------------
    def _on_event(self, ev) -> None:
        # events can arrive outside tick() (the local engine pushes
        # synchronously from any tx, including RPC-thread submits), so
        # the handler activates this node's obs itself
        with use_obs(self.obs):
            self._dispatch_event(ev)

    def _dispatch_event(self, ev) -> None:
        name = ev.name
        if name == "TaskSubmitted":
            self._on_task_submitted(ev.args)
        elif name == "SolutionSubmitted":
            self._on_solution_submitted(ev.args)
        elif name == "ContestationSubmitted":
            self._on_contestation(ev.args)
        elif name == "SolutionClaimed":
            # engine flips claimed before emitting, so the generic sync
            # stores claimed=True
            self._sync_solution("0x" + ev.args["task"].hex())
        elif name == "ContestationVote":
            self.db.store_vote("0x" + ev.args["task"].hex(),
                               ev.args["addr"], ev.args["yea"])
        elif name == "VersionChanged":
            if ev.args["version"] > MINER_VERSION:
                log.error("chain version now %d > miner %d — stop mining",
                          ev.args["version"], MINER_VERSION)

    def _on_task_submitted(self, args: dict) -> None:
        if self.task_feed is not None:
            # fleet worker mode: the coordinator owns the task stream —
            # work arrives only as leases (docs/fleet.md); the node
            # stays subscribed for solution/contestation vigilance
            return
        taskid = "0x" + args["id"].hex()
        model = "0x" + args["model"].hex()
        self._inc("tasks_seen")
        if self.registry.get(model) is None:
            return
        with span("task.event", taskid=taskid, model=model):
            self.db.store_task(taskid, model, args["fee"], args["sender"],
                               self.chain.now, 0, "")
            self.db.queue_job("task", {"taskid": taskid}, concurrent=True)

    def _sync_solution(self, taskid: str) -> None:
        sol = self.chain.get_solution(taskid)
        if sol is not None:
            self.db.store_solution(taskid, sol.validator, sol.blocktime,
                                   sol.claimed, "0x" + sol.cid.hex())

    def _on_solution_submitted(self, args: dict) -> None:
        taskid = "0x" + args["task"].hex()
        self._sync_solution(taskid)
        # solution for a task we proved invalid → contest (index.ts:236-266)
        if args["addr"] != self.chain.address and \
                self.db.is_invalid_task(taskid):
            self.db.queue_job("contest", {"taskid": taskid}, priority=50)

    def _on_contestation(self, args: dict) -> None:
        taskid = "0x" + args["task"].hex()
        self.db.store_contestation(taskid, args["addr"], self.chain.now)
        # if we are the accused solver the engine auto-nay-voted for us
        # (EngineV1.sol:922-934) — our escrow is locked until the vote
        # finishes, so schedule the finish ourselves
        sol = self.chain.get_solution(taskid)
        if sol is not None and sol.validator == self.chain.address:
            self._queue_vote_finish(taskid)
        if args["addr"] == self.chain.address:
            return
        if self.db.is_invalid_task(taskid):
            self.db.queue_job("vote", {"taskid": taskid, "yea": True},
                              priority=50)

    # -- job processing (two-phase, index.ts:879-958) ---------------------
    def run(self, *, stop: "callable | None" = None) -> None:
        """Production loop: poll the queue at poll_interval_ms
        (index.ts:1078-1101). `stop()` → True ends the loop (tests/SIGTERM
        handlers); chain time drives job due-ness, wall time drives cadence."""
        import time as _time

        while not (stop and stop()):
            self.tick()
            _time.sleep(self.config.poll_interval_ms / 1000.0)

    def tick(self) -> int:
        """One poll: run due concurrent jobs, then one serial pass.
        Returns number of jobs processed."""
        with use_obs(self.obs):
            return self._tick()

    def _tick(self) -> int:
        # one tick = one sqlite commit (docs/pipeline.md, db.batch()):
        # the window covers the event poll and the fleet lease pump
        # too, not just the job cycle — a poll delivering a burst of
        # events used to fsync per event-handler write (the 10k fleet
        # flood surfaced it). Losing the window to a crash is safe on
        # every path it now covers: a re-poll replays the event range
        # (RpcChain's cursor is in-memory; handlers dedupe via INSERT
        # OR IGNORE) and an expired lease whose local jobs vanished is
        # simply re-dealt (the lease table is the durable record).
        with self.db.batch():
            return self._tick_inner()

    def _tick_inner(self) -> int:
        # pull-based backends (RpcChain) deliver events here; the local
        # engine pushes synchronously and has no poll_events. A transport
        # blip must not kill the run() loop — the next tick re-polls the
        # same range (handlers dedupe replayed events).
        poll = getattr(self.chain, "poll_events", None)
        if poll is not None:
            try:
                poll()
            except Exception as e:  # noqa: BLE001 — endpoint flake
                # counted, not just logged: the healthwatch rpc_degraded
                # rule watches this — a flapping endpoint must be a
                # first-class signal, not log archaeology
                # (docs/healthwatch.md)
                self.obs.registry.counter(
                    "arbius_event_poll_failures_total",
                    "Event polls that failed (retried next tick) — a "
                    "flaky endpoint's first-class signal "
                    "(docs/healthwatch.md)").inc()
                log.warning("event poll failed (will retry): %r", e)
        if self.task_feed is not None:
            # fleet worker mode: settle/heartbeat/pull leases before the
            # queue drains, so freshly leased tasks run this very tick —
            # the same tick alignment the event path gives a bare node
            # (docs/fleet.md determinism argument). A lease-db hiccup
            # must not kill the run loop; the next tick re-pumps.
            try:
                self.task_feed.pump(self)
            except Exception as e:  # noqa: BLE001 — lease-db flake
                self.obs.registry.counter(
                    "arbius_lease_pump_failures_total",
                    "Lease pumps that failed (re-pumped next tick) — "
                    "the fleet worker's lease-plane health signal "
                    "(docs/healthwatch.md)").inc()
                log.warning("lease pump failed (will retry): %r", e)
        done = self._drain_jobs()
        if self.healthwatch is not None:
            # one evaluation per tick, AFTER the job cycle so this
            # tick's counters are judged exactly once; degrades to a
            # journaled skip internally — never why a tick fails
            self.healthwatch.evaluate(self, done)
        return done

    def _drain_jobs(self) -> int:
        jobs = self.db.get_jobs(self.chain.now)
        if not jobs:
            return 0
        done = 0
        concurrent = [j for j in jobs if j.concurrent]
        serial = [j for j in jobs if not j.concurrent]
        for job in concurrent:
            done += self._run_job(job)
        # dp batching: group due solve jobs into one XLA dispatch
        solves = [j for j in serial if j.method == "solve"]
        others = [j for j in serial if j.method != "solve"]
        if solves:
            done += self._process_solve_batch(solves)
        for job in others:
            done += self._run_job(job)
        return done

    def _run_job(self, job: Job) -> int:
        try:
            handler = {
                "task": self._process_task,
                "claim": self._process_claim,
                "contest": self._process_contest,
                "vote": self._process_vote,
                "validatorStake": self._process_validator_stake,
                "automine": self._process_automine,
                "pinTaskInput": self._process_pin_task_input,
                "voteFinish": self._process_vote_finish,
            }.get(job.method)
            if handler is None:
                log.error("unknown job method %s", job.method)
                self._fail_job(job, ValueError("unknown job method"))
                return 0
            with span("job." + job.method,
                      taskid=job.data.get("taskid"), job_id=job.id):
                handler(job.data)
            self.db.delete_job(job.id)
            return 1
        except Exception as e:  # noqa: BLE001 — failed_jobs quarantine
            log.warning("job %s failed: %r", job.method, e)
            self._fail_job(job, e)
            return 0

    def _fail_job(self, job: Job, e: Exception) -> None:
        """failed_jobs quarantine + the obs failure record (counter +
        journal) — retry/failure visibility the reference lacks."""
        self._c_jobs_failed.inc(method=job.method)
        self.obs.event("job_failed", method=job.method,
                       taskid=job.data.get("taskid"),
                       error=f"{type(e).__name__}: {e}")
        self.db.fail_job(job)

    # -- processors -------------------------------------------------------
    def _process_task(self, data: dict) -> None:
        """Validate + hydrate + queue solve (index.ts:506-564)."""
        taskid = data["taskid"]
        task = self.chain.get_task(taskid)
        if task is None:
            raise ValueError(f"task {taskid} not on chain")
        if task.version != 0:
            self.db.mark_invalid_task(taskid)
            self._inc("tasks_invalid")
            return
        model_id = "0x" + task.model.hex()
        m = self.registry.get(model_id)
        if m is None:
            return
        filters = [MiningFilter(minfee=m.min_fee, owner=o)
                   for o in m.allowed_owners] or \
                  [MiningFilter(minfee=m.min_fee)]
        result = check_model_filter(
            {model_id: (m.template, filters)}, model=model_id,
            now=self.chain.now, fee=task.fee, blocktime=task.blocktime,
            owner=task.owner)
        if not result.filter_passed:
            return
        # conservative pre-hydration floor — the gate's pre-costsched
        # placement: a task priced below EVERY cost the hydrated gate
        # could predict is rejected before its input is even fetched,
        # so a spam flood never costs chain RPCs or hydration
        if not self._fee_covers_cost(task.fee, model_id=model_id,
                                     taskid=taskid):
            self._c_unprofitable.inc(model=model_id)
            log.info("task %s fee %d below cost floor — skipping",
                     taskid, task.fee)
            return
        raw = self.chain.get_task_input_bytes(taskid)
        if raw is None:
            raise ValueError(f"no input bytes for {taskid}")
        try:
            with span("task.hydrate", taskid=taskid, model=model_id):
                obj = json.loads(raw.decode("utf-8"))
                hydrated = hydrate_input(obj, m.template)
        except (ValueError, HydrationError) as e:
            # invalid input: remember, so any solution gets contested
            log.info("task %s invalid input: %r", taskid, e)
            self.db.mark_invalid_task(taskid)
            self._inc("tasks_invalid")
            self.obs.event("task_invalid", taskid=taskid,
                           error=f"{type(e).__name__}: {e}")
            return
        hydrated["seed"] = taskid2seed(taskid)
        # runner intake hook: a family may stamp derived bucket fields
        # onto the hydrated input (textgen's _prompt_bucket/
        # _decode_bucket — docs/text-serving.md) so the precise gate,
        # store_task_input, and the solve-batch bucket_key all see one
        # consistent shape. Pure in (input, fleet config): every honest
        # node derives the same fields.
        prep = getattr(m.runner, "prepare_hydrated", None)
        if prep is not None:
            hydrated = prep(hydrated)
        # precise per-bucket gate, costsched only: the learned model
        # prices per bucket SHAPE, and the shape only exists once the
        # template's defaults are folded in — so this second pass can
        # only SHARPEN the pre-floor above, never relax it. Without
        # costsched the static pre-floor already decided, and a second
        # identical check would just double-journal.
        if self.config.sched.enabled and not self._fee_covers_cost(
                task.fee, model_id=model_id, taskid=taskid,
                hydrated=hydrated):
            self._c_unprofitable.inc(model=model_id)
            log.info("task %s fee %d below cost floor — skipping",
                     taskid, task.fee)
            return
        if self.mesh is not None:
            # mesh-shape intake gate (docs/multichip.md): a video task
            # whose num_frames does not divide sp cannot run on this
            # layout — skip it before queuing. Not marked invalid: the
            # task is protocol-valid and other layouts can mine it.
            sp = self.mesh.shape.get("sp", 1)
            frames = hydrated.get("num_frames")
            if sp > 1 and frames is not None and int(frames) % sp:
                log.info("task %s num_frames=%s not divisible by mesh "
                         "sp=%d — not mineable under this layout, "
                         "skipping", taskid, frames, sp)
                self.obs.registry.counter(
                    "arbius_tasks_unmineable_total",
                    "Tasks skipped because their shape cannot run on "
                    "the configured mesh layout").inc()
                return
        self.db.store_task_input(taskid, "", hydrated)
        if self.store is not None or self.pinner is not None:
            # pin the raw input so contestation evidence stays
            # retrievable (index.ts:175-186 pinTaskInput)
            self.db.queue_job("pinTaskInput", {"taskid": taskid},
                              concurrent=True)
        self.db.queue_job("solve", {"taskid": taskid, "model": model_id},
                          concurrent=False)

    def _static_solve_seconds(self) -> float:
        """The pre-costsched cost estimate, unchanged: observed infer
        p50 across everything, or the configured prior before any
        samples. The gate AND the packer degrade to this exact number
        whenever the learned model has no row (docs/scheduler.md pins
        that an empty `cost_model` table reproduces it bit-for-bit)."""
        samples = self._h_stage.values(stage="infer")
        if samples:
            return sorted(samples)[len(samples) // 2]
        return self.config.assumed_solve_seconds

    def _fee_covers_cost(self, fee: int, *, model_id: str | None = None,
                         taskid: str | None = None,
                         hydrated: dict | None = None) -> bool:
        """Profitability gate (beyond the reference's static fee filter):
        predicted chip-seconds × operator rate must not exceed the fee.
        Disabled at rate 0. Learned pricing is opt-in via
        `sched.enabled` — disabled, the gate is the static path the node
        always had (estimate = infer p50, else the configured prior).

        Two placements share this method (docs/scheduler.md):

          * `hydrated=None` — the pre-hydration floor, at the gate's
            pre-costsched position: the estimate is the CHEAPEST cost
            any hydrated prediction could give (min of the static
            estimate and every predict-eligible learned row of this
            model+layout), so it rejects only tasks the precise gate
            would reject too — spam never costs an input fetch or a
            hydration. Source `"floor"` when a learned row set it.
          * `hydrated` given — the precise per-bucket gate (costsched
            only): the learned row for the task's exact (model, bucket,
            layout), else the static estimate.

        The FINAL decision is journaled (`gate_decision`: fee,
        predicted cost, provenance, verdict) exactly once per task —
        pre-floor accepts under costsched are re-decided (and then
        journaled) by the precise gate."""
        rate = self.config.min_fee_per_second
        if rate <= 0:
            return True
        from arbius_tpu_torch.node.costmodel import bucket_str
        from arbius_tpu_torch.node.solver import bucket_key

        sched_on = self.config.sched.enabled
        est = None
        source = "static"
        if sched_on and model_id is not None:
            mode = self.solve_mode(model_id)
            if hydrated is not None:
                key = bucket_key(model_id, hydrated, mode)
                est = self.costmodel.predict(model_id, bucket_str(key),
                                             self.solve_layout, mode)
                if est is not None:
                    source = "cost_model"
            else:
                learned = [
                    r.chip_seconds for r in self.costmodel.rows.values()
                    if r.model == model_id and r.layout == self.solve_layout
                    and r.mode == mode
                    and r.samples >= self.costmodel.min_samples]
                if learned:
                    static = self._static_solve_seconds()
                    est = min(min(learned), static)
                    if est < static:
                        source = "floor"
        if est is None:
            est = self._static_solve_seconds()
        floor = int(est * rate)
        ok = fee >= floor
        prefloor_accept = hydrated is None and sched_on and ok
        if not prefloor_accept:
            self.obs.event("gate_decision", taskid=taskid, model=model_id,
                           fee=str(fee), predicted_seconds=round(est, 6),
                           cost_floor=str(floor), source=source,
                           verdict="accept" if ok else "reject")
        return ok

    def solve_mode(self, model_id: str) -> str:
        """The precision mode this node serves a model at
        (docs/quantization.md) — bf16 for anything unconfigured."""
        return self.solve_modes.get(model_id.lower(), "bf16")

    def bucket_disk_warm(self, key: tuple, entries: list) -> bool:
        """Cross-life warm signal for the packer: the port has no AOT
        cache, so no bucket is warm before this life compiled it."""
        return False

    def _bucket_fees(self, entries: list) -> int:
        """Summed task fees of one bucket (the packer's reward side):
        from the task cache the event handler filled; a missing row
        prices as 0 — the packer only deprioritizes it."""
        total = 0
        for job, _ in entries:
            row = self.db.get_task(job.data["taskid"])
            if row is not None:
                total += int(row["fee"])
        return total

    def _ingest_costs(self) -> None:
        """Fold the tick's tagged stage=infer observations into the
        cost model, refit, and persist the fitted rows (inside the
        tick's batch window — no extra fsync). Holds the state lock:
        a /debug/costmodel snapshot mid-refit would iterate the rows
        dict while it grows."""
        with self.state_lock:
            if self.costmodel.ingest(self._h_stage):
                self.costmodel.refit(self.chain.now)
                self.costmodel.persist(self.db, self.chain.now)

    def _process_solve_batch(self, jobs: list[Job]) -> int:
        """Group solve jobs by shape bucket, pack the buckets (FIFO by
        default; predicted fee/chip-second under costsched —
        docs/scheduler.md), and run each bucket as ONE batched dispatch
        (solve_cid_batch → the runner's dp batch path). Commit/reveal
        stays per-task (chain semantics). Packing permutes whole
        buckets only; entries inside a bucket keep arrival order, so
        chunking — and therefore bytes — is packing-invariant."""
        from arbius_tpu_torch.node.solver import bucket_key

        by_bucket: dict[tuple, list[tuple[Job, dict]]] = {}
        for job in jobs:
            hydrated = self.db.get_task_input(job.data["taskid"])
            if hydrated is None:
                self._fail_job(job, ValueError("no stored task input"))
                continue
            by_bucket.setdefault(
                bucket_key(job.data["model"], hydrated,
                           self.solve_mode(job.data["model"])), []).append(
                (job, hydrated))
        # fee SELECTs stay OUTSIDE the state lock (per-task sqlite I/O
        # must not stall the RPC debug views or the device stage's
        # mark_warm); only the pack itself reads/writes packer state
        scored = [(key, entries,
                   self._bucket_fees(entries) if self._sched.wants_fees
                   else 0)
                  for key, entries in by_bucket.items()]
        with self.state_lock:
            packed = self._sched.pack(scored)
        try:
            if self._pipeline is not None and not self.config.evilmode:
                # staged executor (docs/pipeline.md): same buckets, same
                # chunking, same bytes — a pipelined schedule in packed
                # order (the device stage feeds in pack order). evilmode
                # (a contestation drill that fabricates CIDs without
                # solving) stays on the reference-shaped path below.
                buckets = [(self.registry.get(b.key[0]), b.entries, b.key)
                           for b in packed]
                with span("solve.pipeline",
                          n=sum(len(e) for _, e, _ in buckets)):
                    return self._pipeline.run(buckets)
            done = 0
            for b in packed:
                m = self.registry.get(b.key[0])
                taskids = [job.data["taskid"] for job, _ in b.entries]
                with span("solve.batch", model=b.key[0], n=len(b.entries),
                          taskids=taskids):
                    done += self._solve_bucket(m, b.entries, b.key)
            return done
        finally:
            self._ingest_costs()

    def _cost_tag(self, key: tuple, n: int) -> str:
        from arbius_tpu_torch.node.costmodel import bucket_str, make_cost_tag
        from arbius_tpu_torch.node.solver import bucket_mode

        return make_cost_tag(key[0], bucket_str(key), self.solve_layout, n,
                             mode=bucket_mode(key))

    def _observe_infer(self, key: tuple, n: int, seconds: float,
                       hydrated: dict | None = None) -> None:
        """ONE bucket dispatch's infer observation, shared by both solve
        schedules: the cost-tagged `arbius_stage_seconds{infer}` sample
        (the learned model's input). `hydrated` is the reference's
        perfscope join key; the port has no perfscope cards."""
        self._h_stage.observe(seconds, stage="infer",
                              tag=self._cost_tag(key, n))

    def _solve_bucket(self, m, entries: list[tuple[Job, dict]],
                      key: tuple) -> int:
        t_start = self.chain.now
        # detlint: allow[DET101] obs stage timing; never reaches solve bytes
        w_start = time.perf_counter()
        try:
            with self._maybe_profile():
                results = solve_cid_batch(
                    m, [(h, h["seed"]) for _, h in entries],
                    evilmode=self.config.evilmode,
                    canonical_batch=self.config.canonical_batch)
        except Exception as e:  # noqa: BLE001 — whole bucket failed
            log.warning("bucket solve failed: %r", e)
            for job, _ in entries:
                self._fail_job(job, e)
            return 0
        # this bucket's executable is compiled now — the packer's
        # warm-preference signal (docs/scheduler.md)
        with self.state_lock:
            self._sched.mark_warm(key)
        # tagged with the cost key so the learned model can attribute
        # the bucket's wall seconds to (model, bucket, layout, n)
        # detlint: allow[DET101] obs stage timing; never reaches solve bytes
        self._observe_infer(key, len(entries),
                            time.perf_counter() - w_start)
        done = 0
        # detlint: allow[DET101] obs stage timing; never reaches solve bytes
        w_commit = time.perf_counter()
        for (job, _), (cid, files) in zip(entries, results):
            try:
                with span("solve.task", taskid=job.data["taskid"], cid=cid):
                    # pin BEFORE revealing: a revealed CID whose bytes are
                    # nowhere fetchable is exactly what contestation
                    # slashes
                    self._store_solution(job.data["taskid"], cid, files)
                    self._commit_reveal(job.data["taskid"], cid, t_start)
                self.db.delete_job(job.id)
                done += 1
            except Exception as e:  # noqa: BLE001
                log.warning("solve commit failed: %r", e)
                self._fail_job(job, e)
        # detlint: allow[DET101] obs stage timing; never reaches solve bytes
        commit_seconds = time.perf_counter() - w_commit
        self._h_stage.observe(commit_seconds, stage="commit")
        # on the synchronous path the whole pin/commit tail runs with
        # nothing dispatched on the device — that window IS chip idle
        # (the pipeline's A/B comparison baseline, docs/pipeline.md)
        self._c_idle.inc(commit_seconds)
        return done

    def _store_solution(self, taskid: str, cid: str, files: dict) -> None:
        """Pin solution bytes under their CID (data availability: the
        committed CID must be fetchable — ipfs.ts:28-76 equivalent) via the
        configured strategy, with the reference's expretry envelope.

        Remote strategies additionally mirror into the local store (the
        node's own gateway keeps serving). If pinning exhausts its retries
        AND no local mirror holds the bytes, this RAISES — the caller must
        not reveal a CID nobody can fetch."""
        if not files:
            return
        from arbius_tpu_torch.l0.cid import cid_hex
        from arbius_tpu_torch.node.pinners import LocalPinner
        from arbius_tpu_torch.node.retry import expretry

        with span("solve.pin", taskid=taskid, n=len(files)):
            mirrored = False
            if self.store is not None and \
                    not isinstance(self.pinner, LocalPinner):
                stored = cid_hex(self.store.put_files(files))
                if stored != cid:
                    # the mirror may end up the only copy (remote pin can
                    # fail below) — never let a silently-corrupt sole copy
                    # back a reveal
                    log.error("mirror/commit CID mismatch: %s != %s",
                              stored, cid)
                mirrored = stored == cid
            if self.pinner is None:
                return
            try:
                pinned = cid_hex(expretry(
                    lambda: self.pinner.pin_files(files, taskid=taskid),
                    max_delay=self.config.retry_max_delay,
                    sleep=self._retry_sleep, op="pin_files"))
            except Exception as e:  # noqa: BLE001 — availability decision
                if not mirrored:
                    raise  # no copy exists anywhere: block the reveal
                log.error("pinning %s failed (serving from local mirror): "
                          "%r", taskid, e)
                return
            if pinned != cid:
                # same pure function on the same bytes; a mismatch means
                # disk corruption or a codec bug — keep mining but say so
                # loudly
                log.error("pin/commit CID mismatch: %s != %s", pinned, cid)

    def _process_pin_task_input(self, data: dict) -> None:
        """Pin the raw task input through the configured strategy (the
        reference's pinTaskInput goes through the same pinFileToIPFS
        switch, index.ts:175-186) and mirror it into the local store."""
        raw = self.chain.get_task_input_bytes(data["taskid"])
        if raw is None:
            raise ValueError(f"no input bytes for {data['taskid']}")
        if self.store is not None:
            self.store.put_blob(raw)
        from arbius_tpu_torch.node.pinners import LocalPinner
        from arbius_tpu_torch.node.retry import expretry

        if self.pinner is not None and not isinstance(self.pinner, LocalPinner):
            # same expretry envelope the reference's pinTaskInput runs in
            # (index.ts:175-186) — one transient HTTP error must not
            # quarantine the job and lose contestation evidence
            expretry(lambda: self.pinner.pin_blob(raw,
                                                  filename=data["taskid"]),
                     max_delay=self.config.retry_max_delay,
                     sleep=self._retry_sleep, op="pin_blob")

    def _maybe_profile(self):
        """torch.profiler trace of every Nth solve dispatch when the
        operator sets profile_dir: one Chrome trace per traced dispatch,
        `solve-<N>.json` (SURVEY.md §5: the reference has no miner-side
        tracing at all)."""
        cfg = self.config
        if not cfg.profile_dir or cfg.profile_every <= 0:
            return contextlib.nullcontext()
        self._profile_counter = getattr(self, "_profile_counter", 0) + 1
        if self._profile_counter % cfg.profile_every:
            return contextlib.nullcontext()
        return _chrome_trace(cfg.profile_dir,
                             f"solve-{self._profile_counter}.json")

    def _commit_reveal(self, taskid: str, cid: str, t_start: int, *,
                       progress=None, skip_commit: bool = False) -> None:
        """index.ts:566-672: skip if solved (contest on CID mismatch —
        the reference merely bails, index.ts:568-579; contesting here is
        strictly more vigilant), else commit → reveal → queue claim.

        `progress(stage, resumed=...)` is the pipeline's checkpoint hook,
        called AFTER each chain write is known to have landed (commit,
        then reveal) — never before, so a recorded stage is always true.
        `skip_commit` resumes past a commitment the sqlite checkpoint
        proves landed in a previous life (same CID; re-signalling would
        only round-trip into the engine's already-signalled revert)."""
        if progress is None:
            progress = lambda stage, resumed=False: None  # noqa: E731
        existing = self.chain.get_solution(taskid)
        if existing is not None:
            if "0x" + existing.cid.hex() != cid:
                if existing.validator != self.chain.address:
                    self.db.mark_invalid_task(taskid)
                    self.db.queue_job("contest", {"taskid": taskid},
                                      priority=50)
                return
            if existing.validator == self.chain.address:
                # our own reveal from a previous life (crash after the
                # reveal landed but before the claim was scheduled) —
                # finish the bookkeeping instead of stranding the reward
                progress("reveal", resumed=True)
                if not existing.claimed and \
                        not self.db.has_job("claim", {"taskid": taskid}):
                    self.db.queue_job(
                        "claim", {"taskid": taskid},
                        waituntil=self.chain.now
                        + self.chain.min_claim_solution_time()
                        + self.config.claim_delay_buffer)
            return
        if skip_commit:
            progress("commit", resumed=True)
        else:
            if self.commit_guard is not None and \
                    not self.commit_guard(taskid, cid):
                # another fleet worker holds this task's commit rights
                # and its lease is live (docs/fleet.md cross-process
                # dedupe): signalling here would double-commit the
                # fleet's work — skip; the lease pump settles the lease
                # when their reveal lands
                self.obs.event("commit_deduped", taskid=taskid, cid=cid)
                return
            with span("solve.commit", taskid=taskid):
                commitment = self.chain.generate_commitment(taskid, cid)
                try:
                    self.chain.signal_commitment(commitment)
                except EngineError:
                    pass  # already signalled (e.g. replay); reveal decides
            progress("commit")
        try:
            with span("solve.reveal", taskid=taskid):
                expretry(lambda: self.chain.submit_solution(taskid, cid),
                         tries=3, max_delay=self.config.retry_max_delay,
                         sleep=self._retry_sleep, op="submit_solution")
        except RetriesExhausted:
            sol = self.chain.get_solution(taskid)
            if sol is None:
                # the reveal never landed at all — re-raise so the job
                # quarantines visibly instead of silently dropping the
                # task (simnet SIM101 task-conservation: every task must
                # reach an accounted terminal state)
                raise
            if "0x" + sol.cid.hex() != cid:
                # lost the race to a wrong answer → contest
                self.db.mark_invalid_task(taskid)
                self.db.queue_job("contest", {"taskid": taskid}, priority=50)
                return
            if sol.validator != self.chain.address:
                return  # honest race lost: same bytes, their reward
            # our reveal LANDED but the response was lost (the retries
            # saw "solution already submitted" for our own solution) —
            # fall through to the success bookkeeping, or the claim
            # would never be scheduled (found by simnet rpc-flap)
        progress("reveal")
        self._inc("solutions_submitted")
        self._h_latency.observe(self.chain.now - t_start, tag=taskid)
        self.db.queue_job(
            "claim", {"taskid": taskid},
            waituntil=self.chain.now
            + self.chain.min_claim_solution_time()
            + self.config.claim_delay_buffer)

    def _process_claim(self, data: dict) -> None:
        """index.ts:728-750."""
        taskid = data["taskid"]
        if self.chain.get_contestation(taskid) is not None:
            return  # resolved via contestationVoteFinish instead
        try:
            expretry(lambda: self.chain.claim_solution(taskid),
                     tries=3, max_delay=self.config.retry_max_delay,
                     sleep=self._retry_sleep, op="claim_solution")
        except RetriesExhausted:
            sol = self.chain.get_solution(taskid)
            if sol is None or not sol.claimed:
                raise  # genuinely unclaimed — quarantine visibly
            # the claim LANDED but the response was lost (the retries saw
            # "already claimed") — count it (found by simnet rpc-flap)
        self._inc("solutions_claimed")

    def _process_contest(self, data: dict) -> None:
        """index.ts:674-707: contest, or pile onto an existing one."""
        taskid = data["taskid"]
        try:
            self.chain.submit_contestation(taskid)
            self._inc("contestations_submitted")
            self._queue_vote_finish(taskid)
        except EngineError:
            if not self.chain.contestation_voted(taskid) and \
                    self.chain.validator_can_vote(taskid) == 0:
                self.chain.vote_on_contestation(taskid, True)
                self._inc("votes_cast")
                self._queue_vote_finish(taskid)

    def _process_vote(self, data: dict) -> None:
        """index.ts:709-726."""
        taskid = data["taskid"]
        if self.chain.contestation_voted(taskid):
            return
        if self.chain.validator_can_vote(taskid) != 0:
            return
        self.chain.vote_on_contestation(taskid, data["yea"])
        self._inc("votes_cast")
        self._queue_vote_finish(taskid)

    def _queue_vote_finish(self, taskid: str) -> None:
        """Schedule contestationVoteFinish after the vote window for a
        contestation we have a stake in. The reference leaves this as a
        stub (index.ts:392-395 'not implemented yet'), which strands every
        participant's escrowed slash until some human calls finish."""
        c = self.chain.get_contestation(taskid)
        if c is None:
            return
        data = {"taskid": taskid}
        if self.db.has_job("voteFinish", data):
            return
        due = c.blocktime + self.chain.min_contestation_vote_period() \
            + self.config.vote_finish_delay_buffer
        self.db.queue_job("voteFinish", data, waituntil=due)

    def _process_vote_finish(self, data: dict) -> None:
        """Finish the contestation vote (EngineV1.sol:1026-1106), paying
        out escrows pageful-by-pageful. Racing other finishers is fine —
        the pagination index advances on-chain."""
        taskid = data["taskid"]
        c = self.chain.get_contestation(taskid)
        if c is None:
            return
        period = self.chain.min_contestation_vote_period()
        if self.chain.now < c.blocktime + period:
            # clock skew between scheduling and chain time — push it back
            self.db.queue_job(
                "voteFinish", data,
                waituntil=c.blocktime + period
                + self.config.vote_finish_delay_buffer)
            return
        try:
            self.chain.contestation_vote_finish(taskid, 64)
            self._inc("vote_finishes")
        except EngineError as e:
            log.info("voteFinish %s: %r (already finished?)", taskid, e)

    def _process_validator_stake(self, data: dict) -> None:
        """Auto top-up (index.ts:397-472) with the 1%/20% buffers, then
        re-queue self at +interval — in a finally: a transient RPC fault
        must not kill the heartbeat forever (a quarantined stake job
        would never re-queue itself; found by simnet rpc-flap)."""
        try:
            minimum = self.chain.get_validator_minimum()
            staked = self.chain.validator_staked() - \
                self.chain.validator_withdraw_pending()
            floor = minimum + int(minimum * self.config.stake.buffer_min_percent)
            if staked < floor:
                target = minimum + int(minimum * self.config.stake.buffer_percent)
                need = target - staked
                if need > 0:
                    if self.chain.token_balance() < need:
                        log.error("stake top-up needs %d but balance is %d",
                                  need, self.chain.token_balance())
                    else:
                        self.chain.validator_deposit(need)
        finally:
            self.db.queue_job("validatorStake", {}, priority=100,
                              waituntil=self.chain.now
                              + self.config.stake.check_interval)

    def _process_automine(self, data: dict) -> None:
        """Self-submitted work (index.ts:474-503)."""
        a = self.config.automine
        try:
            self.chain.submit_task(
                a.version, self.chain.address, a.model, a.fee,
                json.dumps(a.input, sort_keys=True).encode())
        finally:
            self.db.queue_job("automine", {}, priority=10,
                              waituntil=self.chain.now + a.delay)
