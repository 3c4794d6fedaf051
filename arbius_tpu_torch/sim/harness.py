"""SimHarness — one scenario run: world, workload, crash-restart, drain.

The system under test is the REAL production stack end to end: a
`MinerNode` whose chain facade is `RpcChain` over signed EIP-1559
transactions into the in-process `DevnetNode`, with the fault plane's
`FaultTransport` as the only wire between them. The workload submitter
(user wallet) rides a clean transport — the user is not under test —
while an adversarial validator and a juror act directly on the engine
(their behavior is scripted, not simulated).

Run shape:

  setup   genesis mint/approve/stake, emit 100k wad from the engine so
          the validator-minimum and slashing thresholds actually bite,
          register the model, boot the node (plane disarmed — a dead
          endpoint at boot is a boot failure, not a scenario)
  rounds  one task submitted per round until the workload is exhausted
          (some flagged invalid-input or front-run by the adversary,
          per seeded draws), node.tick(), juror votes on open
          contestations, stakes sampled, virtual clock advanced
  drain   keep ticking; when nothing is due, jump the clock to the
          earliest pending job (claim windows, vote-finish windows);
          quiescent when only heartbeat jobs and no in-flight fault-
          plane events remain
  crash   a `SimCrash` out of tick() tears the node down (db connection
          closed, obs journal snapshotted) and a fresh node boots from
          the same sqlite file — re-polling the chain from block 0 and
          recovering its queue from the checkpoint

The result bundle (`SimResult`) is everything the invariant checkers
audit; `run_scenario()` is the one-call front door the CLI and tests
share.

Copy of arbius_tpu/sim/harness.py for the port. The probe runner is
meshsolve's `ShardedImageProbe` on the port's mesh of lanes
(parallel/mesh.py): `mesh` and a precision other than bf16 run as the
reference's do, on the lanes the caller set (`set_virtual_lanes` for
the CPU). `perfscope=True` is refused with `ValueError` naming ROADMAP
queue 1 item 12.
"""
# detlint: enforce[DET101,DET102,DET103,DET105]
from __future__ import annotations

from dataclasses import dataclass, field

from arbius_tpu_torch.chain.devnet import DevnetError, DevnetNode
from arbius_tpu_torch.chain.engine import Engine
from arbius_tpu_torch.chain.fixedpoint import WAD
from arbius_tpu_torch.chain.rpc_client import EngineRpcClient, RpcError
from arbius_tpu_torch.chain.token import TokenLedger
from arbius_tpu_torch.chain.wallet import Wallet
from arbius_tpu_torch.node import (
    LocalChain,
    MinerNode,
    MiningConfig,
    ModelConfig,
    ModelRegistry,
    NodeDB,
    RegisteredModel,
)
from arbius_tpu_torch.node.config import (
    AlertsConfig,
    PipelineConfig,
    PrecisionConfig,
    SchedConfig,
)
from arbius_tpu_torch.node.solver import EVIL_CID
from arbius_tpu_torch.obs import use_obs
from arbius_tpu_torch.sim.clock import VirtualClock
from arbius_tpu_torch.sim.faults import (
    AuditedRpcChain,
    FaultPlane,
    FaultTransport,
    FaultyRunner,
    FaultyTextRunner,
    SimCrash,
    SimPinner,
)
from arbius_tpu_torch.sim.scenario import Scenario
from arbius_tpu_torch.templates.engine import load_template

CHAIN_ID = 31337
KEY_MINER = "0x" + "a1" * 32
KEY_USER = "0x" + "b2" * 32
EVIL = "0x" + "ee" * 20
JUROR = "0x" + "dc" * 20
START_TIME = 100_000
EMITTED_WAD = 100_000        # pseudo-supply so minimum/slash are nonzero
_HEARTBEATS = ("automine", "validatorStake")


class _CleanTransport:
    """Faultless DevnetNode transport for actors not under test."""

    def __init__(self, dev: DevnetNode):
        self.dev = dev

    def request(self, method: str, params: list):
        try:
            return self.dev.request(method, params)
        except DevnetError as e:
            raise RpcError(str(e)) from None


@dataclass
class TaskFlags:
    index: int
    invalid: bool = False
    evil: bool = False


@dataclass
class SimResult:
    """Everything a checker can audit, plus the run's summary numbers."""
    scenario: Scenario
    seed: int
    plane: FaultPlane
    engine: Engine
    db: NodeDB
    tasks: dict[str, TaskFlags] = field(default_factory=dict)
    journal_events: list[dict] = field(default_factory=list)
    min_stake_seen: int = 0
    quiescent: bool = True
    rounds: int = 0
    restarts: int = 0
    retry_max_delay: float = 30.0
    miner_address: str = ""
    # the matrix runs the staged solve executor (docs/pipeline.md);
    # SIM109 audits its journaled stage order only when it actually ran
    pipeline_enabled: bool = False
    # conclint runtime-witness record (docs/concurrency.md): observed
    # lock-order graph + watched-attr writes; None when the run was not
    # instrumented — SIM110 audits it only when present
    witness_report: dict | None = None
    # fleet runs (sim/fleet.py, docs/fleet.md): worker validator
    # addresses in worker-index order, every worker's NodeDB (task
    # conservation must see ALL local verdicts), and the lease table's
    # terminal rows + transition history — SIM111 audits these; empty
    # on single-node runs
    fleet_workers: list = field(default_factory=list)
    worker_dbs: list = field(default_factory=list)
    lease_rows: list = field(default_factory=list)
    lease_history: list = field(default_factory=list)
    lease_counts: dict = field(default_factory=dict)
    commit_rows: list = field(default_factory=list)
    # fleetscope sidecar directory (docs/fleetscope.md): one
    # `<member>.obs.sqlite` per fleet member, flushed at drain —
    # federation tests read these; empty on single-node runs
    sidecar_dir: str = ""
    # events evicted from any fleet worker's journal ring: when > 0,
    # SIM112 cannot assert adoption COMPLETENESS (a missing lease_hop
    # may simply have fallen off the ring) and downgrades to its
    # structural checks
    journal_dropped: int = 0
    # healthwatch alert engine (docs/healthwatch.md) ran on every node
    # this result audits — SIM113's fault→alert coverage invariant
    # applies only when True (the engine defaults off, like perfscope)
    healthwatch_enabled: bool = False

    def repro(self) -> str:
        return (f"python -m arbius_tpu_torch.sim --scenario "
                f"{self.scenario.name} --seed {self.seed} "
                f"--tasks {self.scenario.tasks}")


class SimHarness:
    def __init__(self, scenario: Scenario, seed: int,
                 db_path: str = ":memory:",
                 node_cls: type[MinerNode] = MinerNode,
                 pipeline: bool = True,
                 mesh: dict | None = None,
                 witness: bool = False,
                 precision: str = "bf16",
                 perfscope: bool = False,
                 healthwatch: bool = False):
        if scenario.faults.crash_after_commit is not None \
                and db_path == ":memory:":
            # a restart from :memory: builds an EMPTY NodeDB — the run
            # would "test" recovery from a checkpoint that never existed
            # and report violations whose repro line (which always uses a
            # real file) passes
            raise ValueError(
                f"scenario {scenario.name!r} crash-restarts the node: "
                "pass a real sqlite db_path so the reboot actually "
                "recovers from the checkpoint")
        self.scenario = scenario
        self.seed = seed
        self.db_path = db_path
        self.node_cls = node_cls
        self.pipeline = pipeline
        if perfscope:
            raise ValueError("perfscope: not ported yet (ROADMAP queue 1 "
                             "item 12)")
        # healthwatch alert engine (docs/healthwatch.md): bookkeeping-
        # only — CIDs must match a healthwatch-off run byte for byte,
        # and SIM113 audits the fault→alert coverage of every run that
        # enables it (the matrix fixture does)
        self.healthwatch = healthwatch
        # conclint runtime witness (docs/concurrency.md): instrumented
        # lock wrappers + watched-attr sampling on every node this
        # harness spawns. Bookkeeping-only — CIDs must stay
        # byte-identical to a witness-off run (test-pinned).
        self.witness = None
        if witness:
            from arbius_tpu_torch.analysis.conc.witness import ConcWitness

            self.witness = ConcWitness()
            self.witness.register_root("tick")
        # mesh scenarios (docs/multichip.md): a `mesh` config swaps the
        # hash-fake FaultyRunner for meshsolve's ShardedImageProbe — a
        # real sharded program over the mesh's lanes (the virtual lanes
        # the caller set, on the CPU in tests), fault-gated per dispatch
        # exactly where FaultyRunner gates. The
        # probe's bytes are layout-invariant by construction, so a run
        # at mesh={"dp":2} must produce the same CIDs as mesh=None
        # (tests/test_meshsolve.py pins it); SIM101-109 audit unchanged.
        # mesh={} means "probe runner, no mesh" — the equality baseline.
        self.mesh_cfg = mesh
        self.mesh = None
        if mesh is not None and mesh:
            from arbius_tpu_torch.parallel import meshsolve

            self.mesh = meshsolve.boot_mesh(dict(mesh))
        # precision mode (docs/quantization.md): a non-bf16 mode needs
        # the probe runner (the hash-fake FaultyRunner has no program
        # to quantize), quantizes the probe weights, and rides
        # every bucket key / cost tag through the node — SIM101-112
        # must hold at int8 exactly as at bf16
        from arbius_tpu_torch.quant import validate_mode

        self.precision = validate_mode(precision)
        if self.precision != "bf16" and mesh is None:
            raise ValueError(
                f"precision {precision!r} needs the probe runner — pass "
                "mesh={} (probe, no mesh) or a real mesh config")

        self.token = TokenLedger()
        self.engine = Engine(self.token, start_time=START_TIME)
        self.token.mint(Engine.ADDRESS, 600_000 * WAD)
        self.dev = DevnetNode(self.engine, chain_id=CHAIN_ID)
        self.clock = VirtualClock(self.engine)

        self.miner_wallet = Wallet.from_hex(KEY_MINER)
        self.user_wallet = Wallet.from_hex(KEY_USER)
        self.plane = FaultPlane(scenario, seed, self.clock, self.engine,
                                self.miner_wallet.address)
        self._rng_work = self.plane._rng_rpc.stream("workload")

        # genesis: emitted supply + funded actors + adversary/juror stakes
        self.token.transfer(Engine.ADDRESS, "0x" + "99" * 20,
                            EMITTED_WAD * WAD)
        for addr in (self.miner_wallet.address, self.user_wallet.address,
                     EVIL, JUROR):
            self.token.mint(addr, 1_000 * WAD)
            self.token.approve(addr.lower(), Engine.ADDRESS, 10**30)
        self.evil_chain = LocalChain(self.engine, EVIL)
        self.juror_chain = LocalChain(self.engine, JUROR)
        self.evil_chain.validator_deposit(200 * WAD)
        self.juror_chain.validator_deposit(200 * WAD)
        # pre-stake the miner well above the minimum: per-contest slash
        # escrows subtract from usable stake mid-run, and a node wedged
        # below the minimum between stake-heartbeat runs would turn every
        # scenario into a stake test
        self.engine.validator_deposit(self.miner_wallet.address,
                                      self.miner_wallet.address, 400 * WAD)
        # age the stakes past the anti-vote-buying gate (EngineV1.sol:976)
        self.engine.advance_time(
            self.engine.max_contestation_validator_stake_since + 100,
            blocks=0)

        mid_b = self.engine.register_model(
            self.user_wallet.address, self.user_wallet.address, 0,
            b'{"meta":{"title":"simnet"}}')
        self.model_id = "0x" + mid_b.hex()
        # mixed-family scenarios (sched-flood, docs/scheduler.md):
        # additional registered models share the template but form their
        # own buckets, so the packer has real cross-family choices
        self.model_ids = [self.model_id]
        for f in range(1, scenario.families):
            mb = self.engine.register_model(
                self.user_wallet.address, self.user_wallet.address, 0,
                f'{{"meta":{{"title":"simnet-f{f}"}}}}'.encode())
            self.model_ids.append("0x" + mb.hex())
        self.user_client = EngineRpcClient(
            _CleanTransport(self.dev), self.dev.engine_address,
            self.user_wallet, chain_id=CHAIN_ID)

        self._submitted_ids: list[str] = []
        self.engine.subscribe(self._record_task_event)

        self.result = SimResult(scenario=scenario, seed=seed,
                                plane=self.plane, engine=self.engine,
                                db=None, miner_address=self.miner_wallet
                                .address.lower())
        self.node: MinerNode | None = None
        self._spawn_node()

    # -- world ------------------------------------------------------------
    def _record_task_event(self, ev) -> None:
        if ev.name == "TaskSubmitted":
            self._submitted_ids.append("0x" + ev.args["id"].hex())

    def _spawn_node(self) -> None:
        transport = FaultTransport(self.dev, self.plane)
        client = EngineRpcClient(transport, self.dev.engine_address,
                                 self.miner_wallet, chain_id=CHAIN_ID)
        chain = AuditedRpcChain(client, self.dev.token_address, self.plane)
        cfg = MiningConfig(
            db_path=":memory:",  # unused: db object injected below
            models=tuple(ModelConfig(id=mid,
                                     template=self.scenario.template)
                         for mid in self.model_ids),
            # costsched packer (docs/scheduler.md) when the scenario
            # says so: bucket order becomes the scheduler's choice and
            # every SIM1xx invariant must hold regardless
            sched=SchedConfig(enabled=True) if self.scenario.sched
            else SchedConfig(),
            compile_cache_dir=None,
            obs_journal_capacity=16384,
            retry_max_delay=self.result.retry_max_delay,
            # the staged executor runs under EVERY scenario's fault mix
            # by default (docs/pipeline.md): real encode worker threads,
            # a 2-deep device window, a bounded network backlog —
            # SIM101-108 must hold unchanged and SIM109 audits the stage
            # order. pipeline=False drives the shipped synchronous
            # default through the same fault plane (tests/test_sim.py
            # runs both so neither schedule's path rots uncovered).
            pipeline=PipelineConfig(enabled=True, depth=2,
                                    encode_workers=2, max_inflight_pins=2)
            if self.pipeline else PipelineConfig(),
            # canonical_batch 2 so a dp2 mesh actually shards the
            # dispatch (batch 1 degrades to replicated — still correct,
            # but then the scenario would not exercise the dp path);
            # the mesh-off probe baseline runs the same batch so the
            # chunking is identical and only the layout differs
            mesh=dict(self.mesh_cfg) if self.mesh_cfg else None,
            canonical_batch=2 if self.mesh_cfg is not None else 1,
            precision=PrecisionConfig(default=self.precision),
            alerts=AlertsConfig(enabled=True)
            if self.healthwatch else AlertsConfig())
        self.result.pipeline_enabled = self.pipeline
        self.result.healthwatch_enabled = self.healthwatch
        if self.mesh_cfg is not None:
            from arbius_tpu_torch.parallel.meshsolve import ShardedImageProbe

            runner = ShardedImageProbe(mesh=self.mesh,
                                       gate=self.plane.runner_gate,
                                       mode=self.precision)
        elif self.scenario.template == "textgen":
            # text-family scenarios (docs/text-serving.md): the
            # token-progress hash-fake with the decode-stall edge
            runner = FaultyTextRunner(self.plane)
        else:
            runner = FaultyRunner(self.plane)
        registry = ModelRegistry()
        for mid in self.model_ids:
            registry.register(RegisteredModel(
                id=mid, template=load_template(self.scenario.template),
                runner=runner))
        db = NodeDB(self.db_path)
        node = self.node_cls(chain, cfg, registry, db=db, store=None,
                             pinner=SimPinner(self.plane))
        node._retry_sleep = self.clock.sleep
        if self.witness is not None:
            from arbius_tpu_torch.analysis.conc.witness import instrument_node

            # before boot/tick: no thread can be inside a wrapped lock
            # during the swap (the encode pool is parked on its queue)
            instrument_node(node, self.witness)
        node.boot(skip_self_test=True)
        self.node = node
        self.result.db = db

    def _restart_node(self) -> None:
        """Crash recovery: snapshot the dead node's flight recorder,
        close its db handle, boot a replacement from the same sqlite
        checkpoint (fresh RpcChain — it re-polls from block 0 and the
        db's INSERT OR IGNORE absorbs the replayed history)."""
        self.result.journal_events.extend(self.node.obs.journal.events())
        self.result.journal_dropped += self.node.obs.journal.dropped
        self.result.restarts += 1
        self.node.close()   # encode pool + sqlite handle
        armed = self.plane.armed
        self.plane.armed = False     # boot is not under fault injection
        try:
            self._spawn_node()
        finally:
            self.plane.armed = armed

    # -- workload ----------------------------------------------------------
    def _task_input(self, i: int, invalid: bool) -> bytes:
        import json

        if invalid:
            # undecodable JSON: hydration must fail and the node must
            # remember the task as invalid (contestation evidence)
            return b'{"prompt": broken'
        if self.scenario.template == "textgen":
            # text workload (docs/text-serving.md): mixed decode
            # budgets land in different decode buckets, alternating
            # samplers split the greedy/top_k determinism classes
            obj = {"prompt": f"simnet text {i} {self._rng_work.u64():x}",
                   "max_new_tokens": (8, 16, 24)[i % 3],
                   "sampler": "top_k" if i % 2 else "greedy"}
            return json.dumps(obj, sort_keys=True).encode()
        obj = {"prompt": f"simnet task {i} {self._rng_work.u64():x}",
               "negative_prompt": ""}
        if i % self.scenario.families:
            # the mixed-family flood also mixes SHAPES, so the packer
            # reorders across genuinely different buckets (width is part
            # of the bucket key; the template enum admits 256)
            obj["width"] = 256
            obj["height"] = 256
        return json.dumps(obj, sort_keys=True).encode()

    def _submit_task(self, i: int) -> None:
        invalid = self._rng_work.chance(self.scenario.invalid_rate)
        evil = (not invalid) and self._rng_work.chance(self.scenario.evil_rate)
        family = i % self.scenario.families
        # fees differ per family so costsched's fee/chip-second ranking
        # has a real gradient to act on
        fee = self.scenario.fee_wad * WAD * (1 + family)
        self.user_client.send("submitTask", [
            0, self.user_wallet.address, self.model_ids[family], fee,
            self._task_input(i, invalid)])
        tid = self._submitted_ids[-1]
        self.result.tasks[tid] = TaskFlags(index=i, invalid=invalid,
                                           evil=evil)
        if evil:
            # adversary front-runs with a deliberately wrong CID before
            # the node can even see the task (commit tx mines a block, so
            # the reveal is immediately valid)
            c = self.evil_chain.generate_commitment(tid, EVIL_CID)
            self.evil_chain.signal_commitment(c)
            self.evil_chain.submit_solution(tid, EVIL_CID)

    def _juror_pass(self) -> None:
        """Scripted third validator: votes yea on every open contestation
        (the node's yea + juror's yea out-vote the accused's auto-nay, so
        a contested wrong answer actually loses)."""
        for tid, flags in self.result.tasks.items():
            if not flags.evil:
                continue
            tb = bytes.fromhex(tid[2:])
            if tb not in self.engine.contestations:
                continue
            if self.juror_chain.contestation_voted(tid):
                continue
            if self.juror_chain.validator_can_vote(tid) != 0:
                continue
            self.juror_chain.vote_on_contestation(tid, True)

    # -- driving -----------------------------------------------------------
    def _tick(self) -> int:
        try:
            return self.node.tick()
        except SimCrash:
            self._restart_node()
            return 0

    def _sample_stakes(self) -> None:
        for v in self.engine.validators.values():
            if v.staked < self.result.min_stake_seen:
                self.result.min_stake_seen = v.staked

    def _pending_jobs(self) -> list:
        jobs = self.node.db.get_jobs(2**60, limit=1000)
        return [j for j in jobs if j.method not in _HEARTBEATS]

    def run(self) -> SimResult:
        try:
            return self._run()
        finally:
            # even when a scenario bug/interrupt escapes mid-run: the
            # class-level __setattr__ watch hook must come off (a stale
            # hook would double-count the next witness's records) and
            # whatever was observed rides the result for post-mortems
            if self.witness is not None:
                self.result.witness_report = self.witness.report()
                self.witness.unwatch_all()

    def _run(self) -> SimResult:
        scenario, result = self.scenario, self.result
        with use_obs(self.node.obs):
            self._tick()             # settle the boot-queued stake job
        self.plane.armed = True
        submitted = 0
        rounds = 0
        while rounds < scenario.max_rounds:
            rounds += 1
            # a restart swaps self.node — re-enter the obs context each
            # round so sim counters land in the live node's registry
            with use_obs(self.node.obs):
                # flood scenarios submit bursts so the queue actually
                # holds multiple buckets when the packer runs
                for _ in range(max(1, scenario.burst)):
                    if submitted >= scenario.tasks:
                        break
                    self._submit_task(submitted)
                    submitted += 1
                self._tick()
                self._juror_pass()
                self._sample_stakes()
                if submitted >= scenario.tasks:
                    pending = self._pending_jobs()
                    if not pending and self.plane.pending_events() == 0:
                        break
                    if pending:
                        due = [j for j in pending
                               if j.waituntil <= self.clock.now]
                        if not due:
                            # nothing actionable now: jump to the next
                            # deadline (claim / vote-finish windows)
                            nxt = min(j.waituntil for j in pending)
                            if nxt > self.clock.now:
                                self.clock.advance(nxt - self.clock.now)
                self.clock.advance(scenario.tick_seconds)
                # a real chain produces blocks whether or not we
                # transact; an empty block per round keeps the poll
                # range moving so delayed/replayed logs actually flush
                # (poll_events short-circuits when latest < next_block)
                self.engine.mine_block()
        else:
            result.quiescent = False
        result.rounds = rounds
        result.journal_events.extend(self.node.obs.journal.events())
        result.journal_dropped += self.node.obs.journal.dropped
        if self.node._pipeline is not None:
            # stop the encode pool; the db handle stays open — the
            # invariant checkers still audit it through the result
            self.node._pipeline.shutdown()
        self.plane.armed = False
        return result


def run_scenario(scenario: Scenario, seed: int, *,
                 db_path: str = ":memory:",
                 node_cls: type[MinerNode] = MinerNode,
                 pipeline: bool = True,
                 mesh: dict | None = None,
                 witness: bool = False,
                 precision: str = "bf16",
                 perfscope: bool = False,
                 healthwatch: bool = False) -> SimResult:
    """Build a world, drive the scenario to quiescence, return the
    auditable result. `node_cls` lets regression tests inject a
    deliberately buggy node (tests/test_sim.py double-commit);
    `pipeline=False` runs the shipped synchronous solve path instead of
    the staged executor. `mesh` (e.g. ``{"dp": 2}``) runs the solves as
    real sharded programs on the mesh's lanes via the
    meshsolve image probe; ``{}`` selects the probe with no mesh (the
    CID-equality baseline for a meshed run). `witness=True` instruments
    the node with the conclint runtime witness and attaches its report
    to the result for SIM110 (docs/concurrency.md). `precision` runs
    the solves at a quantized mode through the probe runner
    (docs/quantization.md) — every SIM invariant must hold unchanged.
    `perfscope=True` is refused (item 12). `healthwatch=True` enables
    the live
    alert engine (docs/healthwatch.md) on every node the harness
    spawns — SIM113 then audits the fault→alert coverage (every
    injected fault class raised its mapped alert, clean runs raised
    none) and CIDs stay byte-identical on vs off."""
    return SimHarness(scenario, seed, db_path=db_path,
                      node_cls=node_cls, pipeline=pipeline,
                      mesh=mesh, witness=witness,
                      precision=precision, perfscope=perfscope,
                      healthwatch=healthwatch).run()
