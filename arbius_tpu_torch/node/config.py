"""Two-tier node configuration (SURVEY.md §5 config system).

Tier 1 (deployment constants): chain addresses and model ids — the
reference bakes these into `miner/src/config.json:1-24`.
Tier 2 (operator config): what the reference's `MiningConfig.json`
holds (`miner/src/types.ts:3-54`) — enabled models with filters,
stake buffers, automine, RPC port, db path. Parsed + schema-validated
up front (the reference only JSON-parses, start.ts:12-18; we reject
unknown keys and wrong types at boot instead of failing mid-mine).

Copy of arbius_tpu/node/config.py. Its body differs in one place:
`MiningConfig.compile_cache_dir` defaults to None: the port has no
compile cache, and `MinerNode` refuses a node that names one.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field


class ConfigError(ValueError):
    pass


@dataclass(frozen=True)
class ModelConfig:
    id: str                       # 0x model hash
    template: str                 # template name (e.g. "anythingv3")
    enabled: bool = True
    min_fee: int = 0              # wad; checkModelFilter mirror
    allowed_owners: tuple[str, ...] = ()
    # convert-checkpoint's file (None: random init)
    checkpoint: str | None = None
    tiny: bool = False             # reduced topology (dev/CI hosts)
    # prompt tokenizer: "byte" (deterministic default) or "clip_bpe"
    # (vocab/merges files required — pairs with converted CLIP weights)
    tokenizer: str = "byte"
    vocab_path: str | None = None
    merges_path: str | None = None
    # weights dtype on-device: bfloat16 halves HBM weight traffic (the
    # reference's fp16-container trade); goldens are dtype-specific
    weights_dtype: str = "float32"
    # boot self-test golden vector: {"input": {...}, "seed": int,
    # "cid": "0x1220..."} — the TPU fleet's analogue of the reference's
    # pinned kandinsky CID (miner/src/index.ts:989-999)
    golden: dict | None = None
    # sequence-parallel comm strategy for video templates on an sp>1
    # mesh: "ring" (K/V rotation) or "ulysses" (all_to_all head
    # re-shard; needs heads % sp == 0). Ignored by image templates.
    sp_strategy: str = "ring"

    def __post_init__(self):
        if self.weights_dtype not in ("float32", "bfloat16"):
            raise ConfigError(f"model {self.id}: unknown weights_dtype "
                              f"{self.weights_dtype!r}")
        if self.sp_strategy not in ("ring", "ulysses"):
            raise ConfigError(f"model {self.id}: unknown sp_strategy "
                              f"{self.sp_strategy!r}")
        if self.tokenizer not in ("byte", "clip_bpe"):
            raise ConfigError(f"model {self.id}: unknown tokenizer "
                              f"{self.tokenizer!r}")
        if self.tokenizer == "clip_bpe" and not (
                self.vocab_path and self.merges_path):
            raise ConfigError(f"model {self.id}: clip_bpe tokenizer needs "
                              "vocab_path and merges_path")
        if self.golden is not None and not (
                isinstance(self.golden, dict)
                and {"input", "seed", "cid"} <= set(self.golden)):
            raise ConfigError(f"model {self.id}: golden needs "
                              "input/seed/cid keys")


@dataclass(frozen=True)
class AutomineConfig:
    enabled: bool = False
    version: int = 0
    model: str = ""
    fee: int = 0
    input: dict = field(default_factory=dict)
    delay: int = 60               # seconds between self-submitted tasks


@dataclass(frozen=True)
class StakeConfig:
    """Auto top-up thresholds (index.ts:411-472): keep staked above
    minimum*(1+buffer_min); when topping up, target minimum*(1+buffer)."""
    check_interval: int = 600
    buffer_min_percent: float = 0.01
    buffer_percent: float = 0.20


@dataclass(frozen=True)
class PipelineConfig:
    """Staged solve executor (docs/pipeline.md): decouples device
    compute, host encode+CID, and network pin/commit so the chip never
    waits for the host+network tail of the previous bucket.

    Disabled by default — `enabled: false` IS the reference-equivalent
    synchronous path (one bucket at a time, commit before the next
    dispatch). The knobs only change the *schedule*, never the bytes:
    solution CIDs are identical pipeline-on vs pipeline-off
    (tests/test_pipeline.py pins this per runner family)."""
    enabled: bool = False
    # how many canonical_batch chunks may be dispatched to the device
    # ahead of the encode stage (generalizes the old one-deep overlap)
    depth: int = 2
    # host worker threads for encode+CID; 0 = encode inline on the tick
    # thread (still pipelined against the chip via async dispatch)
    encode_workers: int = 0
    # backpressure bound on tasks queued for the network stage
    # (pin + commit/reveal) before the tick thread drains them
    max_inflight_pins: int = 4

    def __post_init__(self):
        if self.depth < 1:
            raise ConfigError("pipeline.depth must be >= 1")
        if self.encode_workers < 0:
            raise ConfigError("pipeline.encode_workers must be >= 0")
        if self.max_inflight_pins < 1:
            raise ConfigError("pipeline.max_inflight_pins must be >= 1")


@dataclass(frozen=True)
class SchedConfig:
    """Profit-aware continuous batching (docs/scheduler.md): pack the
    pending solve queue across families, bucket shapes, and warm
    executables by predicted fee/chip-second from the learned cost
    model (node/costmodel.py, sqlite `cost_model` table).

    Disabled by default — `enabled: false` IS the FIFO arrival-order
    path the node always had. The packer only permutes whole buckets,
    never the entries inside one, so bytes and CIDs are identical under
    either policy (tests/test_sched.py pins it)."""
    enabled: bool = False
    # per-(model, bucket, layout) samples the cost model must accrue
    # before its prediction replaces the static estimate (the gate and
    # the packer both degrade to the exact pre-costsched behavior
    # until then)
    min_samples: int = 8
    # packing-score multiplier for buckets whose executable is already
    # compiled this life (warm-executable preference; 1.0 disables)
    warm_boost: float = 1.5

    def __post_init__(self):
        if self.min_samples < 1:
            raise ConfigError("sched.min_samples must be >= 1")
        if self.warm_boost < 1.0:
            raise ConfigError("sched.warm_boost must be >= 1.0 "
                              "(1.0 disables the warm preference)")


@dataclass(frozen=True)
class PrecisionConfig:
    """Per-template precision modes (docs/quantization.md): `default`
    applies to every enabled template, `templates` overrides per
    template name. A mode is a DETERMINISM CLASS — `bf16` is the zoo's
    byte-identical historic program; `int8`/`fp8` quantize checkpoint
    weights at load (f32 dequant scales as explicit params) and run
    mode-specific XLA programs with their own graphlint goldens, AOT
    cache keys, and cost-model rows. A fleet mines ONE mode per
    template, exactly like one mesh layout and one canonical batch —
    miners advertise the mode, and the CID contract is per-mode, never
    silently mixed."""
    default: str = "bf16"
    templates: dict = field(default_factory=dict)

    def __post_init__(self):
        from arbius_tpu_torch.quant.modes import validate_mode

        try:
            validate_mode(self.default, where="precision.default")
        except ValueError as e:
            raise ConfigError(str(e)) from None
        if not isinstance(self.templates, dict):
            raise ConfigError(
                "precision.templates must be a {template: mode} object "
                '(e.g. {"anythingv3": "int8"})')
        for tmpl, mode in self.templates.items():
            try:
                validate_mode(mode,
                              where=f"precision.templates[{tmpl!r}]")
            except ValueError as e:
                raise ConfigError(str(e)) from None

    def mode_for(self, template: str) -> str:
        """The precision mode a template serves at."""
        return self.templates.get(template, self.default)


@dataclass(frozen=True)
class AotCacheConfig:
    """Fleet-wide AOT executable cache (docs/compile-cache.md): persist
    compiled bucket executables on disk, keyed by the graphlint
    canonical program fingerprint + environment signature, so a warm
    boot deserializes instead of re-compiling (the cold-boot compile
    storm `arbius_compile_seconds` meters). The directory may be SHARED
    by every fleet worker on a host — writes are atomic tmp+rename.

    Disabled by default — `enabled: false` IS the memory-only
    executable caching the node always had, bit-for-bit. Enabling only
    changes WHERE an executable comes from, never its program: a
    drifted program hashes to a different key and misses to a fresh
    compile (tests/test_aotcache.py pins CID byte-equality on vs off)."""
    enabled: bool = False
    # shared cache directory (created on first write)
    dir: str = "aot-cache"
    # LRU size budget in bytes; 0 = unbounded. Enforced after each
    # write (oldest-mtime entries evicted first; the just-written entry
    # is always retained, so the budget is a soft ceiling of one entry)
    max_bytes: int = 0

    def __post_init__(self):
        if self.enabled and not self.dir:
            raise ConfigError("aot_cache.dir must be a directory path "
                              "when aot_cache.enabled is true")
        if self.dir == ":memory:":
            raise ConfigError("aot_cache.dir must be a directory path — "
                              "the cache is shared across lives (and "
                              "fleet workers)")
        if self.max_bytes < 0:
            raise ConfigError("aot_cache.max_bytes must be >= 0 "
                              "(0 = unbounded)")


@dataclass(frozen=True)
class PerfscopeConfig:
    """Per-bucket XLA cost/memory attribution + drift detection
    (docs/perfscope.md): capture a PerfCard (flops, bytes accessed, HBM
    sizes, padding waste, wire bytes, compile amortization) for every
    bucket executable at the compile seam, persist cards to the sqlite
    `perf_cards` table, and publish
    `arbius_perf_drift_ratio{model,bucket,layout,mode}` = observed
    infer p50 ÷ the card's static roofline estimate.

    Disabled by default — `enabled: false` IS the pre-perfscope node
    bit-for-bit (no capture, no eager compile at the lookup). Enabling
    never changes a program or its bytes: CIDs are pinned identical on
    vs off (tests/test_perfscope.py)."""
    enabled: bool = False
    # roofline peaks the static estimate divides by — set them to the
    # deployed accelerator (defaults are a v4-ish order of magnitude;
    # on CPU the ratio is only meaningful relative to itself)
    peak_flops: float = 1e12
    peak_bytes_per_second: float = 8e11
    # drift band: a ratio outside [drift_min, drift_max] journals a
    # `perf_drift` event (on the crossing) and is what PERF601 audits
    # offline. drift_max 0 disables live banding — the gauge and cards
    # still publish.
    drift_min: float = 0.0
    drift_max: float = 0.0

    def __post_init__(self):
        if self.peak_flops < 0 or self.peak_bytes_per_second < 0:
            raise ConfigError("perfscope peaks must be >= 0 "
                              "(0 disables that roofline term)")
        if self.drift_min < 0:
            raise ConfigError("perfscope.drift_min must be >= 0")
        if self.drift_max > 0 and self.drift_max < self.drift_min:
            raise ConfigError("perfscope.drift_max must be >= drift_min "
                              "(or 0 to disable live banding)")


@dataclass(frozen=True)
class AlertsConfig:
    """Live alert engine (docs/healthwatch.md): a catalog of named
    alert rules — each an ok → pending → firing → resolved state
    machine with hysteresis — evaluated once per node tick over the
    obs registry, the queue, and the `slo`/`perfscope` config.
    Chain/virtual time only, so the transition history is
    deterministic for a given tick history.

    Disabled by default — `enabled: false` IS the pre-healthwatch node
    bit-for-bit (no evaluation, no gauges). Enabling never perturbs a
    solve: the engine is bookkeeping-only and CIDs are pinned
    identical on vs off (tests/test_healthwatch.py)."""
    enabled: bool = False
    # consecutive active evaluations before a sustained-signal rule
    # fires (the pending window); instantaneous rules use 1
    for_ticks: int = 3
    # quiet evaluations a resolved alert holds before returning to ok
    resolve_ticks: int = 1
    # chain seconds of due-job starvation before stuck_tick activates
    stuck_after_seconds: int = 600
    # evaluations the crash_recovered condition holds after an
    # unclean-boot detection
    crash_hold_ticks: int = 3
    # consecutive gate-reject ticks before unprofitable_streak fires
    unprofitable_streak: int = 8
    # pipeline stage stalls per tick before pipeline_stall activates —
    # bounded-queue backpressure stalls a producer a few times per
    # tick by DESIGN (docs/pipeline.md); the alert is for a storm
    stall_burst: int = 8
    # per-rule for_ticks overrides, e.g. {"rpc_degraded": 5}
    per_rule: dict = field(default_factory=dict)

    def __post_init__(self):
        from arbius_tpu_torch.obs.healthwatch import RULE_NAMES

        for name, bound in (("for_ticks", self.for_ticks),
                            ("resolve_ticks", self.resolve_ticks),
                            ("stuck_after_seconds",
                             self.stuck_after_seconds),
                            ("crash_hold_ticks", self.crash_hold_ticks),
                            ("stall_burst", self.stall_burst),
                            ("unprofitable_streak",
                             self.unprofitable_streak)):
            if not isinstance(bound, int) or bound < 1:
                raise ConfigError(f"alerts.{name} must be an integer "
                                  ">= 1")
        if not isinstance(self.per_rule, dict):
            raise ConfigError(
                'alerts.per_rule must be a {rule: for_ticks} object '
                '(e.g. {"rpc_degraded": 5})')
        for rule, ticks in self.per_rule.items():
            if rule not in RULE_NAMES:
                raise ConfigError(
                    f"alerts.per_rule names unknown rule {rule!r} — "
                    f"the catalog is: {', '.join(RULE_NAMES)}")
            if not isinstance(ticks, int) or ticks < 1:
                raise ConfigError(f"alerts.per_rule[{rule!r}] must be "
                                  "an integer >= 1")


@dataclass(frozen=True)
class TextgenConfig:
    """Sequence-bucket policy for the textgen family
    (docs/text-serving.md): a task's prompt pads to the smallest
    `prompt_buckets` edge that fits it and its requested budget rounds
    up to the smallest `decode_buckets` edge — each (prompt, decode,
    sampler, batch) combination is ONE jitted XLA program, so these
    edges bound the compile count AND define the family's determinism
    classes. Like canonical_batch and the mesh layout, bucket edges are
    fleet-wide per model class: the prompt edge changes the positions
    tokens sit at and therefore the output bytes."""
    prompt_buckets: tuple = (32, 64)
    decode_buckets: tuple = (16, 32)
    # hydration-level cap on a task's requested token budget; must be
    # servable by some decode bucket or the task could never solve
    max_new_tokens: int = 32
    # the k of seeded top-k sampling — part of the compiled program,
    # fleet-wide like the bucket edges
    top_k: int = 8

    def __post_init__(self):
        for name, edges in (("prompt_buckets", self.prompt_buckets),
                            ("decode_buckets", self.decode_buckets)):
            if not isinstance(edges, (tuple, list)) or not edges:
                raise ConfigError(f"textgen.{name} must be a non-empty "
                                  "ascending list of positive integers")
            prev = 0
            for e in edges:
                if not isinstance(e, int) or isinstance(e, bool) \
                        or e <= prev:
                    raise ConfigError(
                        f"textgen.{name} must be a non-empty ascending "
                        "list of positive integers")
                prev = e
        if self.prompt_buckets[0] < 3:
            raise ConfigError("textgen.prompt_buckets edges must be >= 3 "
                              "(bos + at least one byte + eos)")
        if not isinstance(self.max_new_tokens, int) \
                or isinstance(self.max_new_tokens, bool) \
                or self.max_new_tokens < 1:
            raise ConfigError("textgen.max_new_tokens must be an integer "
                              ">= 1")
        if self.max_new_tokens > max(self.decode_buckets):
            raise ConfigError("textgen.max_new_tokens must not exceed the "
                              "largest decode bucket edge — a budget no "
                              "bucket can serve would be unmineable")
        if not isinstance(self.top_k, int) or isinstance(self.top_k, bool) \
                or self.top_k < 1:
            raise ConfigError("textgen.top_k must be an integer >= 1")


@dataclass(frozen=True)
class SLOConfig:
    """First-class service-level objectives over the fleet's chain-time
    latency corpus (docs/fleetscope.md): each threshold declares an
    objective on a fixed-bucket percentile the SLO layer estimates
    (`obs.registry.estimate_percentile`); `null` declares none. The
    report always carries the percentiles — thresholds only decide
    whether a soak/scrape FAILS on them (`simsoak --flood` exits 1 on
    breach, SLO101)."""
    # chain-seconds from the coordinator's deal to the first worker
    # acquire, p95
    queue_wait_p95: float | None = None
    # chain-seconds from the task's entry into the fleet to its
    # accepted solution, p99. Anchor detail (docs/fleetscope.md): the
    # live histogram anchors on the coordinator's deal (the lease
    # row's intake time — coordinator poll lag is excluded); the
    # byte-deterministic flood report anchors on the exact on-chain
    # submission blocktime. On a healthy coordinator the two agree to
    # within one poll interval.
    time_to_commit_p99: float | None = None
    # chain-seconds an expired lease lingered past its heartbeat before
    # being stolen/reclaimed, p99
    steal_lag_p99: float | None = None
    # ceiling on chip-idle wall seconds / total solve-path wall seconds
    # (bench/live scrapes only — wall time never enters deterministic
    # flood reports)
    chip_idle_fraction: float | None = None

    def __post_init__(self):
        for name in ("queue_wait_p95", "time_to_commit_p99",
                     "steal_lag_p99"):
            v = getattr(self, name)
            if v is not None and v < 0:
                raise ConfigError(f"slo.{name} must be >= 0 seconds "
                                  "(or null for no objective)")
        f = self.chip_idle_fraction
        if f is not None and not 0.0 <= f <= 1.0:
            raise ConfigError("slo.chip_idle_fraction must be within "
                              "[0, 1] (or null for no objective)")


@dataclass(frozen=True)
class FleetConfig:
    """Multi-process fleet mining (docs/fleet.md): a coordinator owns
    the chain event stream and leases tasks across N worker processes
    through a shared sqlite lease table (WAL + busy_timeout); workers
    are full MinerNodes in worker mode (external task feed, lease
    heartbeat in the tick, cross-process commit dedupe).

    Disabled by default — `enabled: false` IS the single-node path.
    A fleet of one worker produces byte-identical CIDs to a bare
    MinerNode on the same event stream (tests/test_sim.py pins it)."""
    enabled: bool = False
    # worker processes the coordinator leases tasks across
    workers: int = 2
    # chain-time seconds a lease stays exclusive without a heartbeat;
    # a dead worker's tasks are stealable after this
    lease_ttl: int = 60
    # "per-worker": each worker signs with its own wallet (its own
    # validator stake). "shared": one wallet, tx signing serialized
    # through the lease db's wallet guard (nonce-safe, one validator)
    wallet_mode: str = "per-worker"
    # shared lease database path (every fleet process opens this file)
    lease_db: str = "fleet-leases.sqlite"
    # leases a worker may pull per tick, and the task/solve backlog
    # bound above which it stops pulling (the CONC302 story at fleet
    # scale: worker memory stays bounded, the lease table is the
    # durable overflow buffer)
    max_leases: int = 4
    backlog: int = 8
    # lease (re)deliveries before a task is marked failed fleet-wide
    # (a poison task must not ping-pong between workers forever)
    max_attempts: int = 4
    # sqlite busy_timeout for lease-db handles (milliseconds)
    busy_timeout_ms: int = 5000
    # fleetscope sidecar directory (docs/fleetscope.md): every fleet
    # member persists registry snapshots + journal segments to its own
    # `<member>.obs.sqlite` under this path, and the coordinator's
    # federated GET /metrics merges them. Empty = fleetscope sidecars
    # off (per-process obs only).
    sidecar_dir: str = ""
    # ticks between sidecar flushes (1 = every tick)
    sidecar_flush_every: int = 8

    def __post_init__(self):
        if self.sidecar_dir == ":memory:":
            raise ConfigError("fleet.sidecar_dir must be a directory "
                              "path — sidecars are merged across "
                              "processes (empty string disables)")
        if self.sidecar_flush_every < 1:
            raise ConfigError("fleet.sidecar_flush_every must be >= 1")
        if self.workers < 1:
            raise ConfigError("fleet.workers must be >= 1")
        if self.lease_ttl < 1:
            raise ConfigError("fleet.lease_ttl must be >= 1 second")
        if self.wallet_mode not in ("per-worker", "shared"):
            raise ConfigError(f"unknown fleet.wallet_mode "
                              f"{self.wallet_mode!r} (per-worker|shared)")
        if not self.lease_db or self.lease_db == ":memory:":
            raise ConfigError("fleet.lease_db must be a file path — the "
                              "lease table is shared across processes")
        if self.max_leases < 1:
            raise ConfigError("fleet.max_leases must be >= 1")
        if self.backlog < self.max_leases:
            raise ConfigError("fleet.backlog must be >= fleet.max_leases "
                              "(a pull may never overshoot the bound)")
        if self.max_attempts < 1:
            raise ConfigError("fleet.max_attempts must be >= 1")
        if self.busy_timeout_ms < 0:
            raise ConfigError("fleet.busy_timeout_ms must be >= 0")


@dataclass(frozen=True)
class IpfsConfig:
    """Pinning strategy selection (reference `types.ts:3-54` ipfs section):
    local = the node's own ContentStore + gateway (needs store_dir);
    http_daemon = kubo /api/v0/add; pinata = Pinata's pinning API."""
    strategy: str = "local"
    daemon_url: str = ""
    pinata_jwt: str = ""
    # per-pinner HTTP timeout in seconds — reaches every remote pin
    # request (build_pinner threads it through); 60 matches the old
    # hard-coded constant
    timeout: float = 60.0

    def __post_init__(self):
        if self.strategy not in ("local", "http_daemon", "pinata"):
            raise ConfigError(f"unknown ipfs strategy {self.strategy!r}")
        if self.timeout <= 0:
            raise ConfigError("ipfs.timeout must be positive seconds")
        if self.strategy == "http_daemon" and not self.daemon_url:
            raise ConfigError("ipfs strategy http_daemon needs daemon_url")
        if self.strategy == "pinata" and not self.pinata_jwt:
            raise ConfigError("ipfs strategy pinata needs pinata_jwt")


@dataclass(frozen=True)
class MiningConfig:
    db_path: str = ":memory:"
    # sqlite busy_timeout for the node db (milliseconds): ControlRPC
    # request threads and the tick thread contend on one file
    db_busy_timeout_ms: int = 5000
    log_path: str | None = None
    evilmode: bool = False        # fault injection: commit wrong CIDs
    models: tuple[ModelConfig, ...] = ()
    automine: AutomineConfig = AutomineConfig()
    stake: StakeConfig = StakeConfig()
    claim_delay_buffer: int = 120  # claim at solution+minClaimTime+this
    vote_finish_delay_buffer: int = 120  # finish at contest+votePeriod+this
    # profitability gate: skip tasks whose fee < estimated_solve_seconds *
    # this rate (wad/second). 0 disables (reference behavior: fee filters
    # only, no cost model)
    min_fee_per_second: int = 0
    assumed_solve_seconds: float = 10.0  # cost estimate before any samples
    poll_interval_ms: int = 100    # main-loop cadence (index.ts:1082-1096)
    # dp batch per solve dispatch; MUST be fleet-wide per model class
    # (batch size is part of the XLA program = the determinism class)
    canonical_batch: int = 1
    # device-mesh layout for the solve path (docs/multichip.md), e.g.
    # {"dp": 4, "tp": 2} or {"dp": 2, "sp": 2, "tp": 2}; null/absent =
    # the exact single-device path. dp shards the bucket batch
    # (bit-identical to mesh-off — test-pinned); tp/sp layouts are each
    # their OWN determinism class, pinned per (family, layout) by the
    # graphlint goldens, so a fleet mines one layout per model — the
    # same fleet-wide rule as canonical_batch. Axis names/values are
    # validated here; the device-count fit is checked at boot where jax
    # is up (parallel/meshsolve.boot_mesh).
    mesh: dict | None = None
    profile_dir: str | None = None   # jax.profiler trace output dir
    profile_every: int = 0           # trace every Nth solve dispatch
    # obs subsystem (docs/observability.md): span tracing + event journal.
    # obs_enabled=False stops span/journal recording (counters and the
    # /metrics registry stay live — the JSON metrics view depends on them);
    # obs_journal_capacity bounds the flight-recorder ring buffer.
    obs_enabled: bool = True
    obs_journal_capacity: int = 4096
    # bound on expretry's base**attempt backoff curve (seconds); None
    # preserves the reference's uncapped curve (utils.ts:21-39)
    retry_max_delay: float | None = 30.0
    compile_cache_dir: str | None = None  # persistent compile cache
    store_dir: str | None = None     # content store root (None: don't pin)
    rpc_port: int | None = None      # control RPC + explorer + /ipfs gateway
    ipfs: IpfsConfig = IpfsConfig()  # pinning strategy
    # staged solve executor (docs/pipeline.md); default OFF = the
    # synchronous reference-equivalent path behind a single switch
    pipeline: PipelineConfig = PipelineConfig()
    # profit-aware continuous batching (docs/scheduler.md); default OFF
    # = FIFO arrival-order bucket packing, static-cost gate only
    sched: SchedConfig = SchedConfig()
    # multi-process fleet mining (docs/fleet.md); default OFF = this
    # process is a bare single-node miner
    fleet: FleetConfig = FleetConfig()
    # service-level objectives over the chain-time latency corpus
    # (docs/fleetscope.md); all-null = report percentiles, fail nothing
    slo: SLOConfig = SLOConfig()
    # fleet-wide AOT executable cache (docs/compile-cache.md); default
    # OFF = memory-only bucket caching, compile on every boot
    aot_cache: AotCacheConfig = AotCacheConfig()
    # per-template precision modes (docs/quantization.md); the default
    # "bf16" everywhere IS the pre-quant node byte-for-byte — int8/fp8
    # are opt-in per-template determinism classes
    precision: PrecisionConfig = PrecisionConfig()
    # per-bucket cost/memory attribution + drift detection
    # (docs/perfscope.md); default OFF = no capture, the pre-perfscope
    # compile seam bit-for-bit
    perfscope: PerfscopeConfig = PerfscopeConfig()
    # live alert engine (docs/healthwatch.md); default OFF = no
    # evaluation, no alert gauges — the pre-healthwatch node
    alerts: AlertsConfig = AlertsConfig()
    # sequence-bucket policy for the textgen family
    # (docs/text-serving.md); fleet-wide determinism-class config like
    # canonical_batch — inert unless a textgen-template model is enabled
    textgen: TextgenConfig = TextgenConfig()
    # delegated-validator seam (blockchain.ts:44-67 keeps the same seam,
    # disabled): stake reads and deposits target this address instead of
    # the node's wallet — validatorDeposit(validator, amount) is already
    # anyone-may-top-up on-chain (EngineV1.sol:581-604). CAVEAT (boot
    # warns): submitSolution is still gated on msg.sender's OWN stake
    # (EngineV1.sol:398-404), so the signing wallet must also be staked
    # to mine; full delegated SOLVING needs the reference's never-shipped
    # solver contract. This field redirects stake management only,
    # exactly as the commented reference code does.
    delegated_validator: str | None = None

    def __post_init__(self):
        import re as _re

        if self.mesh is not None:
            from arbius_tpu_torch.parallel.mesh import validate_axes

            if not isinstance(self.mesh, dict) or not self.mesh:
                raise ConfigError(
                    "mesh must be a non-empty {axis: size} object "
                    '(e.g. {"dp": 4, "tp": 2}) or null')
            try:
                validate_axes(dict(self.mesh), None, where="mesh config")
            except ValueError as e:
                raise ConfigError(str(e)) from None
        if self.delegated_validator is not None and not _re.fullmatch(
                r"0x[0-9a-fA-F]{40}", self.delegated_validator):
            raise ConfigError(
                f"delegated_validator {self.delegated_validator!r} is not "
                "a 0x address")
        if self.obs_journal_capacity < 1:
            raise ConfigError("obs_journal_capacity must be >= 1")
        if self.db_busy_timeout_ms < 0:
            raise ConfigError("db_busy_timeout_ms must be >= 0")
        if self.retry_max_delay is not None and self.retry_max_delay <= 0:
            raise ConfigError("retry_max_delay must be positive (or null "
                              "for the uncapped reference curve)")


@dataclass(frozen=True)
class DeploymentConfig:
    """Tier-1 deployment constants (the reference's `src/config.json:1-24`):
    where the chain lives and which contracts to talk to. Operator config
    (MiningConfig) says how to mine; this says where."""
    rpc_url: str
    engine_address: str
    token_address: str
    chain_id: int
    start_block: int = 0          # poll_events starts here
    governor_address: str = ""    # optional: governance verbs' target


def load_deployment(raw: str | dict) -> DeploymentConfig:
    obj = json.loads(raw) if isinstance(raw, str) else dict(raw)
    known = set(DeploymentConfig.__dataclass_fields__)
    unknown = set(obj) - known
    if unknown:
        raise ConfigError(f"unknown deployment keys: {sorted(unknown)}")
    missing = {"rpc_url", "engine_address", "token_address",
               "chain_id"} - set(obj)
    if missing:
        raise ConfigError(f"deployment config missing: {sorted(missing)}")
    return DeploymentConfig(**obj)


_KNOWN = {f for f in MiningConfig.__dataclass_fields__}


def load_config(raw: str | dict) -> MiningConfig:
    obj = json.loads(raw) if isinstance(raw, str) else dict(raw)
    unknown = set(obj) - _KNOWN
    if unknown:
        raise ConfigError(f"unknown config keys: {sorted(unknown)}")
    def build(cls, kwargs, where):
        try:
            return cls(**kwargs)
        except TypeError as e:
            raise ConfigError(f"{where}: {e}") from None

    models = []
    for m in obj.pop("models", []):
        m = dict(m)
        if "id" not in m or "template" not in m:
            raise ConfigError("model entry needs id and template")
        owners = tuple(a.lower() for a in m.pop("allowed_owners", []))
        models.append(build(ModelConfig,
                            dict(allowed_owners=owners, **m), "models"))
    automine = build(AutomineConfig, obj.pop("automine", {}), "automine")
    stake = build(StakeConfig, obj.pop("stake", {}), "stake")
    ipfs = build(IpfsConfig, obj.pop("ipfs", {}), "ipfs")
    pipeline = build(PipelineConfig, obj.pop("pipeline", {}), "pipeline")
    sched = build(SchedConfig, obj.pop("sched", {}), "sched")
    fleet = build(FleetConfig, obj.pop("fleet", {}), "fleet")
    slo = build(SLOConfig, obj.pop("slo", {}), "slo")
    aot_cache = build(AotCacheConfig, obj.pop("aot_cache", {}),
                      "aot_cache")
    precision = build(PrecisionConfig, obj.pop("precision", {}),
                      "precision")
    perfscope = build(PerfscopeConfig, obj.pop("perfscope", {}),
                      "perfscope")
    alerts = build(AlertsConfig, obj.pop("alerts", {}), "alerts")
    tg_raw = dict(obj.pop("textgen", {}))
    for k in ("prompt_buckets", "decode_buckets"):
        if isinstance(tg_raw.get(k), list):
            tg_raw[k] = tuple(tg_raw[k])
    textgen = build(TextgenConfig, tg_raw, "textgen")
    return build(MiningConfig,
                 dict(models=tuple(models), automine=automine, stake=stake,
                      ipfs=ipfs, pipeline=pipeline, sched=sched,
                      fleet=fleet, slo=slo, aot_cache=aot_cache,
                      precision=precision, perfscope=perfscope,
                      alerts=alerts, textgen=textgen, **obj),
                 "config")
