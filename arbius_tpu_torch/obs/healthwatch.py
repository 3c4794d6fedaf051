"""healthwatch — the live alert engine (docs/healthwatch.md).

The obs stack can say what happened (spans, percentiles, SLOs) and
what it should have cost (perfscope rooflines), but nothing *watches
the node live*: SLO breaches only fail closed inside `simsoak`, and
perf drift only journals band crossings. healthwatch closes that gap
with a small catalog of named alert rules evaluated ONCE per node tick
over the ambient registry, the node's queue, and the existing
`slo`/`perfscope` configuration.

Each rule is a state machine with hysteresis:

    ok ──condition──▶ pending ──for_ticks──▶ firing
    ▲                    │                      │
    └──resolve_ticks── resolved ◀──condition──┘
                         clears

A condition that clears at streak `for_ticks - 1` never fires (the
pending → ok edge); a firing alert whose condition clears moves to
resolved and, after `resolve_ticks` quiet evaluations, back to ok.
EVERY state change — and only state changes — journals ONE
`alert_transition` event (the perf_drift once-per-crossing contract,
generalized to the whole catalog).

Exported surfaces:

  * `arbius_alert_state{alert}` — every catalog rule's numeric state
    (0 ok / 1 pending / 2 firing / 3 resolved), a labeled callback
    gauge, so the full catalog is enumerable from one scrape;
  * `ALERTS{alertname, alertstate}` — the Prometheus alerting
    convention: one `1` series per pending/firing alert, absent
    otherwise — dashboards built against a real Alertmanager read this
    block unchanged;
  * `arbius_alert_transitions_total{alert}` — how often each rule has
    changed state (a flapping rule is itself a signal);
  * `GET /debug/alerts` — the engine's full snapshot (node/rpc.py);
  * fleet: the two gauges ride each member's fleetscope sidecar
    export like every other metric, so `federate()` merges them and
    the coordinator's `/metrics` shows fleet health — `ALERTS` sums
    into "members with this alert in this state", the fleet-level
    reading (docs/healthwatch.md).

Determinism: every input is chain/virtual time, a counter value, or a
queue depth — no wall clock anywhere (the module is detlint-enforced),
so the same tick history produces the same transition history, which
is what makes SIM113's fault→alert coverage invariant decidable: every
fault-injecting simnet scenario must raise its mapped alert class and
clean scenarios must raise none (sim/invariants.py, the coverage map
in docs/healthwatch.md). The engine is bookkeeping-only: it never
touches a dispatch, so CIDs are byte-identical healthwatch on vs off
(test-pinned), and `evaluate()` degrades to a journaled skip on any
internal error — the watcher can never be why a tick fails.
"""
# detlint: enforce[DET101,DET102,DET103,DET105]
from __future__ import annotations

import threading
from dataclasses import dataclass

# numeric state codes for arbius_alert_state (docs/healthwatch.md)
STATE_CODES = {"ok": 0, "pending": 1, "firing": 2, "resolved": 3}

_STATE_HELP = ("Every healthwatch alert rule's current state "
               "(0 ok / 1 pending / 2 firing / 3 resolved) — the full "
               "catalog is enumerable from one scrape "
               "(docs/healthwatch.md)")
_TRANSITIONS_HELP = ("Alert state changes per rule — each also journals "
                     "ONE alert_transition event (a flapping rule is "
                     "itself a signal, docs/healthwatch.md)")

# retry ops that belong to the pinning edge, not the chain edge — the
# split behind rpc_degraded vs pin_degraded (node/node.py op= labels)
_PIN_OPS = ("pin_files", "pin_blob")


@dataclass(frozen=True)
class AlertRule:
    """One catalog entry: a named condition plus its hysteresis. The
    signal key selects the per-evaluation condition computed in
    `HealthWatch._signals` — rules carry data, not closures, so the
    catalog is enumerable (tools/healthwatch.py --rules) and OBS501's
    alert direction can hold every literal name to a doc row."""

    name: str
    summary: str
    signal: str
    for_ticks: int = 1


class AlertStateMachine:
    """ok → pending → firing → resolved hysteresis for one rule.
    `step(active)` returns the (old, new) pair on a state change, None
    otherwise — the caller journals exactly the changes."""

    def __init__(self, rule: AlertRule, *, resolve_ticks: int = 1):
        self.rule = rule
        self.resolve_ticks = max(1, int(resolve_ticks))
        self.state = "ok"
        self.streak = 0          # consecutive active evaluations
        self.quiet = 0           # consecutive inactive evals in resolved
        self.since = 0           # chain time of the last transition
        self.detail = ""
        self.transitions = 0

    def step(self, active: bool, now: int,
             detail: str = "") -> tuple[str, str] | None:
        old = self.state
        if active:
            self.streak += 1
            self.quiet = 0
            self.detail = detail
            if self.streak >= self.rule.for_ticks:
                self.state = "firing"
            elif old in ("ok", "resolved"):
                self.state = "pending"
        else:
            self.streak = 0
            if old in ("pending",):
                self.state = "ok"
            elif old == "firing":
                self.quiet = 1
                self.state = "resolved"
            elif old == "resolved":
                self.quiet += 1
                if self.quiet > self.resolve_ticks:
                    self.state = "ok"
                    self.detail = ""
        if self.state != old:
            self.since = int(now)
            self.transitions += 1
            return old, self.state
        return None


def default_catalog(cfg) -> tuple[AlertRule, ...]:
    """The shipped rule catalog, hysteresis resolved against the
    validated `alerts` config block (node/config.py AlertsConfig).
    Every name here must have an `alert="<name>"` row in
    docs/observability.md — OBS501's alert direction enforces both
    directions (docs/healthwatch.md carries the full catalog table and
    the fault→alert coverage map)."""
    def ft(name: str, default: int) -> int:
        return int(cfg.per_rule.get(name, default))

    return (
        AlertRule(name="stuck_tick", signal="stuck",
                  summary="due jobs sat unprocessed past "
                          "alerts.stuck_after_seconds of chain time — "
                          "the tick loop is wedged or starved",
                  for_ticks=ft("stuck_tick", 1)),
        AlertRule(name="rpc_degraded", signal="rpc",
                  summary="chain-edge failures this tick: expretry "
                          "attempts on non-pin ops, event-poll "
                          "failures, or lease-pump failures",
                  for_ticks=ft("rpc_degraded", cfg.for_ticks)),
        AlertRule(name="pin_degraded", signal="pin",
                  summary="pinning-edge failures this tick (expretry "
                          "attempts on pin_files/pin_blob)",
                  for_ticks=ft("pin_degraded", cfg.for_ticks)),
        AlertRule(name="job_quarantine", signal="quarantine",
                  summary="jobs quarantined to failed_jobs this tick "
                          "(any method) — work is being lost to "
                          "exhausted retries or hard errors",
                  for_ticks=ft("job_quarantine", 1)),
        AlertRule(name="chain_replay", signal="replay",
                  summary="stale chain events observed (delivered at "
                          "or below the poll window floor, or "
                          "duplicated in-window) — a reorg or replaying "
                          "endpoint",
                  for_ticks=ft("chain_replay", 1)),
        AlertRule(name="crash_recovered", signal="recovered",
                  summary="this life booted over a checkpoint holding "
                          "in-flight work — the previous life died "
                          "unclean; recovery is underway",
                  for_ticks=ft("crash_recovered", 1)),
        AlertRule(name="contention", signal="contention",
                  summary="this node submitted a contestation or cast "
                          "a dispute vote this tick — an adversary (or "
                          "a wrong answer) is live on our tasks",
                  for_ticks=ft("contention", 1)),
        AlertRule(name="invalid_inputs", signal="invalid",
                  summary="tasks marked invalid this tick (undecodable "
                          "or unhydratable input) — possible spam or a "
                          "broken submitter",
                  for_ticks=ft("invalid_inputs", 1)),
        AlertRule(name="pipeline_stall", signal="stall",
                  summary="a pipeline stage stalled its producer at "
                          "least alerts.stall_burst times in one tick "
                          "— a backpressure storm, not the routine "
                          "bounded-queue waits (docs/pipeline.md)",
                  for_ticks=ft("pipeline_stall", cfg.for_ticks)),
        AlertRule(name="unprofitable_streak", signal="unprofitable",
                  summary="the profitability gate rejected tasks for "
                          "alerts.unprofitable_streak consecutive "
                          "ticks — the fee market moved past the "
                          "configured rate (docs/scheduler.md)",
                  for_ticks=ft("unprofitable_streak",
                               cfg.unprofitable_streak)),
        AlertRule(name="aot_reject_storm", signal="aot_rejects",
                  summary="AOT cache entries rejected at load this "
                          "tick — a corrupt or wrong-environment cache "
                          "dir is costing a compile per bucket "
                          "(docs/compile-cache.md)",
                  for_ticks=ft("aot_reject_storm", 1)),
        AlertRule(name="perf_drift", signal="drift",
                  summary="a bucket's observed/roofline drift ratio is "
                          "outside the configured perfscope band — the "
                          "price model and the program disagree "
                          "(docs/perfscope.md)",
                  for_ticks=ft("perf_drift", 1)),
        AlertRule(name="steal_surge", signal="steals",
                  summary="this worker stole expired leases this tick "
                          "— some other fleet member stopped "
                          "heartbeating (docs/fleet.md)",
                  for_ticks=ft("steal_surge", 1)),
        AlertRule(name="lease_starvation", signal="starved",
                  summary="the lease pump had backlog room and the "
                          "table held pending leases, but acquired "
                          "none — model mismatch or lease-plane "
                          "contention (docs/fleet.md)",
                  for_ticks=ft("lease_starvation", cfg.for_ticks)),
        AlertRule(name="slo_queue_wait", signal="slo_queue_wait",
                  summary="fleet queue-wait p95 (bucket-estimated) "
                          "exceeds the declared slo.queue_wait_p95 "
                          "(docs/fleetscope.md)",
                  for_ticks=ft("slo_queue_wait", cfg.for_ticks)),
        AlertRule(name="slo_time_to_commit", signal="slo_ttc",
                  summary="fleet time-to-commit p99 (bucket-estimated) "
                          "exceeds the declared slo.time_to_commit_p99 "
                          "(docs/fleetscope.md)",
                  for_ticks=ft("slo_time_to_commit", cfg.for_ticks)),
        AlertRule(name="decode_stall", signal="decode_stall",
                  summary="text solves this tick whose decode loop "
                          "produced zero output bytes (eos at step 0) "
                          "— a degenerate prompt flood or broken "
                          "weights (docs/text-serving.md)",
                  for_ticks=ft("decode_stall", 1)),
    )


# the catalog's names as data (no config import — node/config.py
# validates `alerts.per_rule` keys against this, and a cycle through
# AlertsConfig here would deadlock that validation); the one-to-one
# match with default_catalog is test-pinned (tests/test_healthwatch.py)
RULE_NAMES = (
    "stuck_tick", "rpc_degraded", "pin_degraded", "job_quarantine",
    "chain_replay", "crash_recovered", "contention", "invalid_inputs",
    "pipeline_stall", "unprofitable_streak", "aot_reject_storm",
    "perf_drift", "steal_surge", "lease_starvation", "slo_queue_wait",
    "slo_time_to_commit", "decode_stall",
)


class HealthWatch:
    """One node's alert engine. Installed by `MinerNode.boot` when
    `alerts.enabled`; `evaluate(node, processed)` runs at the end of
    every tick under the node's ambient obs. Lock discipline
    (docs/concurrency.md): `_lock` is a LEAF guarding exactly the
    state scrape/request threads read — the machine table and the
    tick counter; signal computation (db reads, registry metric
    reads, perfscope reads — each with its own lock) runs OUTSIDE it,
    and the delta/progress bookkeeping (`_prev`, `_last_progress`) is
    tick-thread-private (evaluate is only ever called from the tick
    loop)."""

    def __init__(self, obs, cfg, *, slo=None, recovered: bool = False):
        self.obs = obs
        self.cfg = cfg
        self.slo = slo
        self.recovered = recovered
        self._lock = threading.Lock()
        self._machines = {
            rule.name: AlertStateMachine(
                rule, resolve_ticks=cfg.resolve_ticks)
            for rule in default_catalog(cfg)}
        self._prev: dict[str, float] = {}   # cumulative counter reads
        self._ticks = 0
        self._last_progress: int | None = None
        reg = obs.registry
        reg.gauge("arbius_alert_state", _STATE_HELP,
                  labelnames=("alert",), fn=self._state_values)
        # the Prometheus ALERTS convention: 1-valued series for
        # pending/firing alerts only (name deliberately outside the
        # arbius_* namespace — it matches what a Prometheus server
        # derives from alerting rules, so existing dashboards read it)
        reg.gauge("ALERTS",
                  "Active healthwatch alerts in the Prometheus ALERTS "
                  "convention (docs/healthwatch.md)",
                  labelnames=("alertname", "alertstate"),
                  fn=self._active_alerts)
        self._c_transitions = reg.counter(
            "arbius_alert_transitions_total", _TRANSITIONS_HELP,
            labelnames=("alert",))

    # -- collect-time gauge sources --------------------------------------
    def _state_values(self) -> dict:
        with self._lock:
            return {name: float(STATE_CODES[m.state])
                    for name, m in self._machines.items()}

    def _active_alerts(self) -> dict:
        with self._lock:
            return {(name, m.state): 1.0
                    for name, m in self._machines.items()
                    if m.state in ("pending", "firing")}

    # -- signal plumbing --------------------------------------------------
    def _sum(self, name: str, *, only=None, exclude=None) -> float:
        """Sum of a counter's series (0.0 when never registered);
        `only`/`exclude` filter single-label series by label value."""
        m = self.obs.registry.get(name)
        if m is None:
            return 0.0
        total = 0.0
        for key, value in m.export().get("series", ()):
            label = key[0] if key else None
            if only is not None and label not in only:
                continue
            if exclude is not None and label in exclude:
                continue
            total += value
        return total

    def _delta(self, key: str, value: float) -> float:
        prev = self._prev.get(key, 0.0)
        self._prev[key] = value
        return value - prev

    def _hist_count(self, name: str) -> float:
        m = self.obs.registry.get(name)
        if m is None:
            return 0.0
        total = 0.0
        for series in m.export().get("series", ()):
            total += series[3]   # [key, counts, sum, count]
        return total

    def _hist_pct(self, name: str, q: float) -> float | None:
        m = self.obs.registry.get(name)
        if m is None:
            return None
        try:
            return m.estimate_percentile(q)
        except TypeError:   # labeled histogram: not an SLO substrate
            return None

    def _signals(self, node, processed: int, now: int,
                 tick: int) -> dict:
        """Every rule condition for this evaluation: (active, detail)
        keyed by AlertRule.signal. Counter-delta conditions compare
        against the previous evaluation, so each tick's events are
        judged once."""
        out: dict[str, tuple[bool, str]] = {}
        d = self._delta

        due = len(node.db.get_jobs(now, limit=1))
        if processed > 0 or due == 0 or self._last_progress is None:
            self._last_progress = now
        lag = now - self._last_progress
        out["stuck"] = (lag > self.cfg.stuck_after_seconds,
                        f"no progress for {lag}s of chain time with "
                        "due jobs queued")

        rpc = (d("retry_chain", self._sum("arbius_retry_attempts_total",
                                          exclude=_PIN_OPS))
               + d("exhausted_chain",
                   self._sum("arbius_retry_exhausted_total",
                             exclude=_PIN_OPS))
               + d("poll_failures",
                   self._sum("arbius_event_poll_failures_total"))
               + d("pump_failures",
                   self._sum("arbius_lease_pump_failures_total")))
        out["rpc"] = (rpc > 0, f"{int(rpc)} chain-edge failure(s)")

        pin = (d("retry_pin", self._sum("arbius_retry_attempts_total",
                                        only=_PIN_OPS))
               + d("exhausted_pin",
                   self._sum("arbius_retry_exhausted_total",
                             only=_PIN_OPS)))
        out["pin"] = (pin > 0, f"{int(pin)} pin-edge failure(s)")

        q = d("quarantined", self._sum("arbius_jobs_failed_total"))
        out["quarantine"] = (q > 0, f"{int(q)} job(s) quarantined")

        replay = d("stale_events",
                   self._sum("arbius_chain_events_stale_total"))
        out["replay"] = (replay > 0, f"{int(replay)} stale event(s)")

        out["recovered"] = (
            self.recovered and tick <= self.cfg.crash_hold_ticks,
            "booted over a checkpoint with in-flight work")

        cont = (d("contestations",
                  self._sum("arbius_contestations_submitted_total"))
                + d("votes", self._sum("arbius_votes_cast_total")))
        out["contention"] = (cont > 0,
                             f"{int(cont)} contestation action(s)")

        inv = d("invalid", self._sum("arbius_tasks_invalid_total"))
        out["invalid"] = (inv > 0, f"{int(inv)} invalid task(s)")

        # backpressure stalls a producer a few times per tick by
        # design (bounded queues, docs/pipeline.md) — only a per-tick
        # STORM of stalls is alertable
        stalls = d("stalls", self._sum("arbius_pipeline_stalls_total"))
        out["stall"] = (stalls >= self.cfg.stall_burst,
                        f"{int(stalls)} stage stall(s) this tick "
                        f"(storm threshold {self.cfg.stall_burst})")

        unprof = d("unprofitable",
                   self._sum("arbius_tasks_unprofitable_total"))
        out["unprofitable"] = (unprof > 0,
                               f"{int(unprof)} task(s) gated this tick")

        rejects = d("aot_rejects",
                    self._sum("arbius_aot_cache_rejects_total"))
        out["aot_rejects"] = (rejects > 0,
                              f"{int(rejects)} AOT entry reject(s)")

        scope = getattr(self.obs, "perfscope", None)
        breached = scope.breached_tags() if scope is not None else ()
        out["drift"] = (len(breached) > 0,
                        "buckets outside the drift band: "
                        + ", ".join(breached[:4]))

        steals = d("steals",
                   self._hist_count("arbius_fleet_steal_lag_seconds"))
        out["steals"] = (steals > 0, f"{int(steals)} lease steal(s)")

        feed = getattr(node, "task_feed", None)
        out["starved"] = (bool(getattr(feed, "starved", False)),
                          "pull had room but acquired nothing while "
                          "leases were pending")

        stalled = d("decode_stalls",
                    self._sum("arbius_decode_stalls_total"))
        out["decode_stall"] = (stalled > 0,
                               f"{int(stalled)} zero-byte decode(s)")

        slo = self.slo
        qw = self._hist_pct("arbius_fleet_queue_wait_seconds", 0.95)
        bound = getattr(slo, "queue_wait_p95", None)
        out["slo_queue_wait"] = (
            bound is not None and qw is not None and qw > bound,
            f"queue-wait p95 {qw} > declared {bound}s")
        ttc = self._hist_pct("arbius_fleet_time_to_commit_seconds", 0.99)
        bound = getattr(slo, "time_to_commit_p99", None)
        out["slo_ttc"] = (
            bound is not None and ttc is not None and ttc > bound,
            f"time-to-commit p99 {ttc} > declared {bound}s")
        return out

    # -- the per-tick evaluation -----------------------------------------
    def evaluate(self, node, processed: int = 0) -> None:
        """One evaluation pass: compute every rule's condition, step
        the state machines, journal each transition ONCE, bump the
        transition counters. Never raises — an internal error journals
        `healthwatch_skip` and the tick continues (the watcher can
        never be why a tick fails)."""
        try:
            now = int(node.chain.now)
            # signals OUTSIDE the lock: they take the db/registry/
            # perfscope locks and touch only tick-thread-private state.
            # _ticks is written by this (tick) thread alone — compute
            # the new index first so the recovered-hold signal counts
            # this evaluation, publish it under the lock below.
            tick = self._ticks + 1
            signals = self._signals(node, processed, now, tick)
            changes = []
            with self._lock:
                self._ticks = tick
                for name, machine in self._machines.items():
                    active, detail = signals.get(
                        machine.rule.signal, (False, ""))
                    change = machine.step(bool(active), now,
                                          detail if active else "")
                    if change is not None:
                        changes.append((name, change, machine))
            for name, (old, new), machine in changes:
                self._c_transitions.inc(alert=name)
                self.obs.event("alert_transition", alert=name,
                               prev=old, state=new, tick=tick,
                               streak=machine.streak,
                               detail=machine.detail)
        except Exception as e:  # noqa: BLE001 — degrade, never fail the tick
            try:
                self.obs.event("healthwatch_skip",
                               error=f"{type(e).__name__}: {e}")
            except Exception:  # noqa: BLE001 — even the skip is advisory
                pass

    # -- views ------------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-able view for GET /debug/alerts (serialized under the
        lock — request threads call this while the tick evaluates)."""
        with self._lock:
            alerts = [{
                "alert": name,
                "state": m.state,
                "streak": m.streak,
                "for_ticks": m.rule.for_ticks,
                "since_chain": m.since,
                "transitions": m.transitions,
                "detail": m.detail,
                "summary": m.rule.summary,
            } for name, m in sorted(self._machines.items())]
            return {"enabled": True, "ticks": self._ticks,
                    "alerts": alerts}

    def states(self) -> dict[str, str]:
        with self._lock:
            return {name: m.state
                    for name, m in sorted(self._machines.items())}


__all__ = [
    "STATE_CODES", "AlertRule", "AlertStateMachine", "HealthWatch",
    "RULE_NAMES", "default_catalog",
]
