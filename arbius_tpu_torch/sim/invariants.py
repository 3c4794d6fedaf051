"""SIM1xx invariant checkers — the audit that makes a scenario a test.

Every checker consumes the `SimResult` bundle (decoded tx audit trace,
commitment plaintext registry, obs journal, node db, engine terminal
state) and returns findings. A clean run returns none; any finding is a
protocol-invariant violation and the run's `--seed`/`--scenario` pair
reproduces it byte-identically.

  SIM101  task conservation    every delivered task ends in exactly one
                               accounted terminal state (claimed /
                               contested-resolved / invalid /
                               quarantined); strict scenarios narrow the
                               allowed set per task class
  SIM102  commit before reveal every revealed solution's commitment
                               landed in a strictly earlier block
  SIM103  no duplicate commit  one (validator, taskid) never signals
                               commitments for two different CIDs
  SIM104  stake never negative no validator stake ever sampled below 0
  SIM105  retries bounded      every journaled retry obeys expretry's
                               tries bound and exact capped backoff curve
  SIM106  CID crash-stability  a commitment signalled before a crash is
                               revealed with the SAME CID after reboot
  SIM107  token conservation   ledger sums to total supply; the engine
                               stays solvent for stakes+escrow+fees
  SIM108  liveness             the scenario drained inside its round
                               bound
  SIM109  stage monotonicity   per task, the staged solve executor's
                               journaled pipeline_stage ranks never
                               regress inside one node life (solve →
                               encode → pin → commit → reveal); a crash
                               boundary may reset them (the reboot
                               re-executes from the checkpoint), and a
                               pipeline-enabled run that solved tasks
                               but journaled NO stage events is itself
                               a finding (the executor went unexercised)
  SIM110  witness discipline   when the conclint runtime witness
                               instrumented the run (docs/concurrency.md)
                               its observed lock-order graph holds no
                               cycle, and no watched (CONC401-flagged)
                               attribute was written lock-free from two
                               concurrently-live thread roots — the
                               injected-race regression in sim/bugs.py
                               must trip exactly this
  SIM111  fleet discipline     fleet runs only (docs/fleet.md): the
                               per-validator generalization of
                               SIM102/103 over every worker, no task
                               committed by two fleet workers (the
                               cross-process commit dedupe), every
                               lease terminal at quiescence, expired
                               leases stolen/reclaimed within the TTL,
                               and no reveal without granted commit
                               rights — sim/bugs.py's double-lease
                               node must trip exactly this
  SIM113  fault→alert coverage healthwatch runs only
                               (docs/healthwatch.md): the live alert
                               engine's journaled `alert_transition`
                               record must COVER the run's faults —
                               every injected fault class raised its
                               mapped alert (a fault the monitoring
                               never surfaced is a silent fault), AND
                               every raised alert is explained by some
                               injected fault or node-visible evidence
                               (a clean run raises none; fail closed
                               in BOTH directions) — sim/bugs.py's
                               silent-fault node (drops the alert
                               journal) must trip exactly this
  SIM112  trace completeness   fleet runs only (docs/fleetscope.md):
                               every task's cross-process span chain is
                               gap-free and hop-consistent — the lease
                               table's hop indices are contiguous and
                               start at the coordinator's deal, every
                               worker-journaled `lease_hop` adoption
                               matches a hop the table actually
                               granted, every acquire/steal hop WAS
                               adopted in that worker's journal, and no
                               fleet reveal happened without a hop —
                               sim/bugs.py's span-gap worker (drops the
                               adoption events) must trip exactly this

The checkers are deliberately redundant with the engine's own reverts
(defense in depth): their job is to catch a *node* that violates the
protocol in ways the chain happens to accept — the injected
double-commit regression in tests/test_sim.py proves SIM103 does.
"""
# detlint: enforce[DET101,DET102,DET103,DET105]
from __future__ import annotations

from dataclasses import dataclass

from arbius_tpu_torch.l0.commitment import generate_commitment
from arbius_tpu_torch.node.retry import BASE as RETRY_BASE


@dataclass
class SimFinding:
    """One invariant violation. Shaped for the shared lint plumbing:
    `.rule` feeds the stderr triage table, `.text()` the report lines,
    `.to_json()` the stable JSON document (analysis.cli.render_json)."""
    rule: str
    message: str
    taskid: str | None = None
    scenario: str = ""
    seed: int = 0

    def text(self) -> str:
        where = f" task={self.taskid}" if self.taskid else ""
        return (f"{self.rule} [scenario={self.scenario} seed={self.seed}"
                f"{where}] {self.message}")

    def to_json(self) -> dict:
        return {"rule": self.rule, "message": self.message,
                "taskid": self.taskid, "scenario": self.scenario,
                "seed": self.seed}


def _node_dbs(result) -> list:
    """Every node-local database a verdict can live in: one for a
    single-node run, one per worker for a fleet run (a task proven
    invalid or quarantined on worker 2 is accounted, docs/fleet.md)."""
    dbs = list(getattr(result, "worker_dbs", ()) or ())
    return dbs if dbs else [result.db]


def _failed_methods_by_task(result) -> dict[str, list[str]]:
    out: dict[str, list[str]] = {}
    for db in _node_dbs(result):
        for method, data in db.failed_jobs():
            tid = data.get("taskid")
            if tid:
                out.setdefault(tid, []).append(method)
    return out


def classify_tasks(result) -> dict[str, str]:
    """One terminal label per submitted task (precedence order: dispute
    outcome > chain solution state > node-local verdicts)."""
    labels: dict[str, str] = {}
    failed = _failed_methods_by_task(result)
    dbs = _node_dbs(result)
    for tid in result.tasks:
        tb = bytes.fromhex(tid[2:])
        sol = result.engine.solutions.get(tb)
        con = result.engine.contestations.get(tb)
        if tid not in result.plane.delivered_taskids:
            labels[tid] = "undelivered"
            continue
        if con is not None:
            if con.finish_start_index > 0:
                labels[tid] = "contested_resolved"
            elif "voteFinish" in failed.get(tid, ()):
                labels[tid] = "quarantined"
            else:
                labels[tid] = "contested_unresolved"
        elif sol is not None:
            if sol.claimed:
                labels[tid] = "claimed"
            elif failed.get(tid):
                labels[tid] = "quarantined"
            else:
                labels[tid] = "unclaimed"
        elif any(db.is_invalid_task(tid) for db in dbs):
            labels[tid] = "invalid"
        elif failed.get(tid):
            labels[tid] = "quarantined"
        else:
            labels[tid] = "lost"
    return labels


# terminal states that account for a task (anything else is a leak)
_ALWAYS_BAD = ("contested_unresolved", "unclaimed", "lost", "undelivered")


def _allowed_labels(flags, strict: bool) -> tuple[str, ...]:
    if flags.invalid:
        return ("invalid",) if strict else ("invalid", "quarantined")
    if flags.evil:
        return ("contested_resolved",) if strict else (
            "contested_resolved", "quarantined")
    return ("claimed",) if strict else (
        "claimed", "quarantined", "contested_resolved")


def check_task_conservation(result, find) -> None:
    labels = classify_tasks(result)
    for tid, flags in result.tasks.items():
        label = labels[tid]
        allowed = _allowed_labels(flags, result.scenario.strict)
        if label in _ALWAYS_BAD or label not in allowed:
            tb = bytes.fromhex(tid[2:])
            sol = result.engine.solutions.get(tb)
            con = result.engine.contestations.get(tb)
            detail = (f"solution="
                      f"{('cid 0x' + sol.cid.hex() + ' by ' + sol.validator + (' claimed' if sol.claimed else ' UNCLAIMED')) if sol else 'none'}"
                      f", contestation="
                      f"{('finish_start_index ' + str(con.finish_start_index)) if con else 'none'}")
            find("SIM101", tid,
                 f"task leaked: terminal state {label!r} not in allowed "
                 f"{list(allowed)} (class: "
                 f"{'invalid-input' if flags.invalid else 'front-run' if flags.evil else 'normal'}"
                 f"; {detail})")


def _sender_writes(result, method: str, sender: str):
    return [r for r in result.plane.audit
            if r.ok and r.method == method and r.sender == sender]


def _miner_writes(result, method: str):
    return _sender_writes(result, method, result.miner_address)


def _check_commit_before_reveal_for(result, find, sender: str,
                                    rule: str = "SIM102") -> None:
    commits = {r.values[0]: r
               for r in _sender_writes(result, "signalCommitment",
                                       sender)}
    for rev in _sender_writes(result, "submitSolution", sender):
        taskid, cid = rev.values
        tid = "0x" + taskid.hex()
        expected = generate_commitment(sender, taskid, cid)
        commit = commits.get(expected)
        if commit is None:
            find(rule, tid,
                 f"solution 0x{cid.hex()} revealed at block {rev.block} "
                 f"by {sender} with NO matching signalCommitment in the "
                 "audit trace")
        elif commit.block >= rev.block:
            find(rule, tid,
                 f"commit landed at block {commit.block} but the reveal "
                 f"landed at block {rev.block} — commit must be strictly "
                 "earlier")


def check_commit_before_reveal(result, find) -> None:
    _check_commit_before_reveal_for(result, find, result.miner_address)


def _check_no_duplicate_commitment_for(result, find, sender: str,
                                       rule: str = "SIM103") -> None:
    landed_blocks = {r.values[0]: r.block
                     for r in _sender_writes(result, "signalCommitment",
                                             sender)}
    per_task: dict[tuple[str, str], dict[str, int]] = {}
    for chash, (csender, tid, cid) in result.plane.commitments.items():
        if chash not in landed_blocks or csender != sender:
            continue
        per_task.setdefault((csender, tid), {})[cid] = landed_blocks[chash]
    for (csender, tid), cids in per_task.items():
        if len(cids) > 1:
            listing = ", ".join(f"{cid} @ block {blk}"
                                for cid, blk in sorted(cids.items()))
            find(rule, tid,
                 f"validator {csender} signalled {len(cids)} different "
                 f"commitments for one task — a double-commit: {listing}")


def check_no_duplicate_commitment(result, find) -> None:
    _check_no_duplicate_commitment_for(result, find,
                                       result.miner_address)


def check_stake_never_negative(result, find) -> None:
    if result.min_stake_seen < 0:
        find("SIM104", None,
             f"validator stake sampled below zero mid-run: "
             f"{result.min_stake_seen}")
    for addr, v in result.engine.validators.items():
        if v.staked < 0:
            find("SIM104", None,
                 f"terminal stake negative for {addr}: {v.staked}")


def check_retries_bounded(result, find) -> None:
    cap = result.retry_max_delay
    for ev in result.journal_events:
        if ev.get("kind") != "retry":
            continue
        attempt, tries = ev.get("attempt", 0), ev.get("tries", 0)
        if attempt > tries:
            find("SIM105", ev.get("taskid"),
                 f"retry op={ev.get('op')} attempt {attempt} exceeds its "
                 f"tries bound {tries}")
            continue
        expected = 0.0 if attempt >= tries else round(
            min(RETRY_BASE ** (attempt - 1), cap), 6)
        got = ev.get("delay", 0.0)
        if got != expected:
            find("SIM105", ev.get("taskid"),
                 f"retry op={ev.get('op')} attempt {attempt}/{tries} slept "
                 f"{got}s, expretry policy says {expected}s "
                 f"(base {RETRY_BASE}, max_delay {cap})")


def check_cid_stability(result, find) -> None:
    """Crash-restart determinism: a commitment that landed before a
    crash binds the CID the rebooted node must reveal."""
    if result.scenario.faults.crash_after_commit is None:
        return
    if not result.plane.crash_seqs:
        find("SIM106", None,
             "scenario configured crash_after_commit="
             f"{result.scenario.faults.crash_after_commit} but the node "
             "never crashed — the schedule degenerated")
        return
    crash_seq = result.plane.crash_seqs[0]
    pre_commits = {r.values[0] for r in result.plane.audit[:crash_seq]
                   if r.ok and r.method == "signalCommitment"
                   and r.sender == result.miner_address}
    committed_cid = {}   # tid -> cid committed before the crash
    for chash in pre_commits:
        reg = result.plane.commitments.get(chash)
        if reg is not None:
            committed_cid[reg[1]] = reg[2]
    crossed = 0
    for rev in result.plane.audit[crash_seq:]:
        if not (rev.ok and rev.method == "submitSolution"
                and rev.sender == result.miner_address):
            continue
        tid = "0x" + rev.values[0].hex()
        if tid not in committed_cid:
            continue
        crossed += 1
        revealed = "0x" + rev.values[1].hex()
        if revealed != committed_cid[tid]:
            find("SIM106", tid,
                 f"pre-crash commitment bound CID {committed_cid[tid]} "
                 f"but the rebooted node revealed {revealed} — the "
                 "sqlite checkpoint did not reproduce the solve")
    if crossed == 0:
        find("SIM106", None,
             "node crashed but no pre-crash commitment was revealed "
             "after the restart — the recovery path went unexercised")


def check_token_conservation(result, find) -> None:
    tok = result.engine.token
    total = sum(tok.balances.values())
    if total != tok.total_supply:
        find("SIM107", None,
             f"ledger out of balance: Σbalances {total} != total supply "
             f"{tok.total_supply}")
    eng = result.engine
    obligations = (eng.accrued_fees
                   + sum(v.staked for v in eng.validators.values())
                   + sum(eng.withdraw_pending.values()))
    held = tok.balance_of(eng.ADDRESS)
    if held < obligations:
        find("SIM107", None,
             f"engine insolvent: holds {held} but owes {obligations} "
             "(accrued fees + stakes + pending withdraws)")


def check_liveness(result, find) -> None:
    if not result.quiescent:
        find("SIM108", None,
             f"scenario did not drain within {result.scenario.max_rounds} "
             f"rounds ({len(result.plane.audit)} writes audited, "
             f"{result.plane.pending_events()} events still in flight)")


def check_stage_order(result, find) -> None:
    """SIM109: the staged executor's per-task lifecycle must advance
    monotonically through solve → encode → pin → commit → reveal inside
    one node life. A `sim_crash` journal event marks a reboot — the
    recovered node legitimately re-executes earlier stages, so the
    per-task high-water marks reset there."""
    if not getattr(result, "pipeline_enabled", False):
        return
    from arbius_tpu_torch.node.pipeline import STAGE_RANK

    # keyed per (task, solve-job attempt): replayed chain events
    # legitimately queue duplicate solve jobs for an already-solved
    # task, and each attempt re-walks the stages from the top — within
    # one attempt the ranks must never regress
    last: dict[tuple, tuple[int, str]] = {}
    saw_any = False
    for ev in result.journal_events:
        kind = ev.get("kind")
        if kind == "sim_crash":
            last.clear()
            continue
        if kind != "pipeline_stage":
            continue
        saw_any = True
        tid, stage = ev.get("taskid"), ev.get("stage")
        rank = STAGE_RANK.get(stage)
        if rank is None:
            find("SIM109", tid,
                 f"unknown pipeline stage {stage!r} in the journal")
            continue
        key = (tid, ev.get("jobid"))
        prev = last.get(key)
        if prev is not None and rank < prev[0]:
            find("SIM109", tid,
                 f"stage order regressed within solve attempt "
                 f"{ev.get('jobid')}: {stage!r} (rank {rank}) journaled "
                 f"after {prev[1]!r} (rank {prev[0]}) with no crash "
                 "boundary between them")
            continue
        last[key] = (rank, stage)
    if not saw_any and any(
            r.ok and r.method == "signalCommitment"
            and r.sender == result.miner_address
            for r in result.plane.audit):
        find("SIM109", None,
             "pipeline enabled and the node committed solutions, but the "
             "journal holds no pipeline_stage events — the staged "
             "executor went unexercised")


def check_witness(result, find) -> None:
    """SIM110: audit the conclint runtime-witness record (present only
    on instrumented runs — harness `witness=True`)."""
    report = getattr(result, "witness_report", None)
    if report is None:
        return
    from arbius_tpu_torch.analysis.conc.witness import (
        contested_attrs,
        order_cycle,
    )

    cycle = order_cycle(report)
    if cycle is not None:
        find("SIM110", None,
             "runtime lock-order cycle observed: "
             + " → ".join(cycle)
             + " — two threads interleaving these acquisitions deadlock")
    for (cls, attr), entry in sorted(contested_attrs(report).items()):
        if len(entry["roots"]) >= 2 and entry["lock_free_roots"]:
            find("SIM110", None,
                 f"watched attribute `{cls}.{attr}` written with NO "
                 f"witnessed lock from root(s) "
                 f"{sorted(entry['lock_free_roots'])} while root(s) "
                 f"{sorted(entry['roots'])} were writing it — the "
                 "CONC401 race is live at runtime, not just static")


def check_fleet(result, find) -> None:
    """SIM111 (fleet runs only, docs/fleet.md): the per-validator
    generalization of the single-node invariants plus the lease-plane
    contract.

      (a) SIM102/SIM103 per worker: every fleet validator's reveals
          have a strictly-earlier matching commit, and no validator
          double-commits one task;
      (b) cross-process commit dedupe: no task is committed by two
          DIFFERENT fleet workers — the wasted-work race the lease
          table's claim_commit exists to prevent (the shipped
          scenarios never cross a reclaim-after-commit boundary, so
          one committer per task is exact there; sim/bugs.py's
          double-lease node must trip this);
      (c) every lease terminal after drain (a pending/leased row at
          quiescence is a lost or stuck task);
      (d) expired leases reclaimed/stolen within the TTL: the steal/
          reclaim lag recorded in the lease history never exceeds
          max(lease_ttl, 2 × tick_seconds) — a dead worker's tasks
          become someone else's work, promptly;
      (e) commit-rights rows match what actually landed on chain: the
          registered CID of each fleet reveal equals the rights-holder
          row's CID (the dedupe table cannot drift from the chain)."""
    workers = getattr(result, "fleet_workers", ())
    if not workers:
        return
    for addr in workers:
        _check_commit_before_reveal_for(result, find, addr,
                                        rule="SIM111")
        _check_no_duplicate_commitment_for(result, find, addr,
                                           rule="SIM111")
    committers: dict[str, set] = {}
    for addr in workers:
        for r in _sender_writes(result, "signalCommitment", addr):
            reg = result.plane.commitments.get(r.values[0])
            if reg is not None:
                committers.setdefault(reg[1], set()).add(addr)
    for tid, who in sorted(committers.items()):
        if len(who) > 1:
            find("SIM111", tid,
                 f"{len(who)} fleet workers {sorted(who)} each "
                 "signalled a commitment for one task — the "
                 "cross-process commit dedupe failed (double-lease)")
    for row in getattr(result, "lease_rows", ()):
        if row["state"] not in ("done", "invalid", "failed"):
            find("SIM111", row["taskid"],
                 f"lease stuck non-terminal after drain: state "
                 f"{row['state']!r} held by {row['worker']!r} "
                 f"(attempts {row['attempts']}, steals {row['steals']})")
    spec = result.scenario.fleet
    if spec is not None:
        lag_bound = max(spec.lease_ttl, 2 * result.scenario.tick_seconds)
        for op, tid, worker, now, extra in getattr(
                result, "lease_history", ()):
            if op in ("steal", "reclaim") and \
                    extra.get("lag", 0) > lag_bound:
                find("SIM111", tid,
                     f"expired lease lingered {extra['lag']}s past its "
                     f"heartbeat before {op} (bound {lag_bound}s) — "
                     "reclaim is not keeping up with the TTL")
    worker_of_addr = {addr: f"worker-{i}"
                      for i, addr in enumerate(workers)}
    claims = {}
    for op, tid, worker, now, extra in getattr(result,
                                               "lease_history", ()):
        if op == "commit_claim":
            claims.setdefault(tid, []).append(worker)
    rights = {row["taskid"]: row
              for row in getattr(result, "commit_rows", ())}
    for addr in workers:
        for r in _sender_writes(result, "submitSolution", addr):
            tid = "0x" + r.values[0].hex()
            cid = "0x" + r.values[1].hex()
            holders = claims.get(tid, [])
            if holders and worker_of_addr[addr] not in holders:
                find("SIM111", tid,
                     f"{worker_of_addr[addr]} ({addr}) revealed a "
                     "solution without ever being granted the task's "
                     f"commit rights (granted to {sorted(set(holders))})"
                     " — the commit guard was bypassed")
            row = rights.get(tid)
            if row is not None and row["cid"] != cid:
                find("SIM111", tid,
                     f"commit-rights table records CID {row['cid']} "
                     f"(holder {row['worker']}) but {addr} revealed "
                     f"{cid} on chain — the dedupe table drifted from "
                     "the chain")


_HOP_OPS = ("deal", "acquire", "steal", "reclaim")


def check_trace_chain(result, find) -> None:
    """SIM112 (fleet runs only, docs/fleetscope.md): cross-process
    trace completeness. The lease table's `hops` column is the shared
    truth of every task's deal/acquire/steal/reclaim chain; each
    worker's `lease_hop` journal events are its local adoption record.
    A settled task is traceable iff (a) the chain parses, is
    index-contiguous, and starts at the coordinator's deal, (b) every
    journaled adoption matches a hop the table granted to that worker,
    (c) every granted acquire/steal hop was adopted in that worker's
    journal (the gap the span-gap bug injects), and (d) no fleet
    reveal landed without the revealer holding a hop."""
    import json as _json

    workers = getattr(result, "fleet_workers", ())
    if not workers:
        return
    hops_by_task: dict[str, list[dict]] = {}
    for row in getattr(result, "lease_rows", ()):
        tid = row["taskid"]
        try:
            hops = _json.loads(row.get("hops") or "[]")
        except ValueError:
            find("SIM112", tid, "lease hop chain is not valid JSON: "
                 f"{row.get('hops')!r}")
            continue
        hops_by_task[tid] = hops
        if [h.get("hop") for h in hops] != list(range(len(hops))):
            find("SIM112", tid,
                 "hop chain has gaps or reordered indices: "
                 + str([h.get("hop") for h in hops]))
        if not hops or hops[0].get("op") != "deal":
            find("SIM112", tid,
                 "hop chain does not start at the coordinator's deal: "
                 f"{hops[:1]}")
        for h in hops:
            if h.get("op") not in _HOP_OPS:
                find("SIM112", tid,
                     f"unknown hop op {h.get('op')!r} at index "
                     f"{h.get('hop')}")
    adopted: dict[tuple, list[str]] = {}
    for ev in result.journal_events:
        if ev.get("kind") != "lease_hop":
            continue
        adopted.setdefault((ev.get("taskid"), ev.get("hop")),
                           []).append(ev.get("worker"))
    for (tid, hop), who in sorted(adopted.items()):
        hops = hops_by_task.get(tid)
        h = hops[hop] if hops is not None and isinstance(hop, int) \
            and 0 <= hop < len(hops) else None
        if h is None:
            find("SIM112", tid,
                 f"worker(s) {sorted(who)} journaled adoption of hop "
                 f"{hop} the lease table never granted")
            continue
        for w in who:
            if h.get("op") not in ("acquire", "steal") \
                    or h.get("worker") != w:
                find("SIM112", tid,
                     f"hop {hop} adopted by {w} but the lease table "
                     f"records op={h.get('op')!r} "
                     f"worker={h.get('worker')!r} — the chain is "
                     "hop-inconsistent across processes")
    if getattr(result, "journal_dropped", 0) == 0:
        # adoption COMPLETENESS is only decidable when no worker's
        # journal ring evicted events — a missing lease_hop behind a
        # nonzero dropped count may simply have fallen off the ring,
        # and a false "gap" here would poison the one checker whose
        # contract is that span-gap fails it ALONE
        for tid, hops in sorted(hops_by_task.items()):
            for h in hops:
                if h.get("op") in ("acquire", "steal") and \
                        h.get("worker") not in adopted.get(
                            (tid, h.get("hop")), []):
                    find("SIM112", tid,
                         f"span chain gap: hop {h.get('hop')} "
                         f"({h.get('op')} by {h.get('worker')}) was "
                         "never adopted in that worker's journal — "
                         "the cross-process trace is broken")
    held = {tid: {h.get("worker") for h in hops
                  if h.get("op") in ("acquire", "steal")}
            for tid, hops in hops_by_task.items()}
    worker_of_addr = {addr: f"worker-{i}"
                      for i, addr in enumerate(workers)}
    for addr in workers:
        for r in _sender_writes(result, "submitSolution", addr):
            tid = "0x" + r.values[0].hex()
            if worker_of_addr[addr] not in held.get(tid, ()):
                find("SIM112", tid,
                     f"{worker_of_addr[addr]} ({addr}) revealed a "
                     "solution without ever holding a hop in the "
                     "task's trace chain")


# -- SIM113: fault→alert coverage (docs/healthwatch.md) ---------------------
#
# The coverage map: which healthwatch alert class each injected fault
# kind must raise. A fault kind maps to a TUPLE of acceptable alerts —
# the invariant is "at least one of the class was raised" (reaching
# pending counts: the class left ok, which is what an operator's pager
# keys on). Timing-only faults (latency, runner_slow, pin_stall) have
# no required alert: they are observable only as latency, and mapping
# them would make the invariant lie. docs/healthwatch.md renders this
# table; keep the two in sync.
FAULT_ALERTS: dict[str, tuple[str, ...]] = {
    "tx_error": ("rpc_degraded", "job_quarantine"),
    "tx_lost_response": ("rpc_degraded", "job_quarantine"),
    "view_error": ("rpc_degraded", "job_quarantine"),
    "poll_error": ("rpc_degraded",),
    "pin_fail": ("pin_degraded", "job_quarantine"),
    "pin_mismatch": ("pin_degraded", "job_quarantine"),
    "runner_crash": ("job_quarantine",),
    "event_delay": ("chain_replay",),
    "event_replay": ("chain_replay",),
    "reorg": ("chain_replay",),
    # a view error can raise out of an event SUBSCRIBER mid-dispatch,
    # making the node re-poll (and honestly re-observe) the range —
    # so chain faults may legitimately surface as observed replays
    "crash": ("crash_recovered",),
    # a simulated zero-byte decode bumps the SAME production counter
    # the real TextGenRunner.finalize does (docs/text-serving.md), so
    # the decode_stall rule must see it
    "decode_stall": ("decode_stall",),
    # latency / runner_slow / pin_stall / coordinator_crash: timing or
    # out-of-scope — no required alert (documented, not forgotten)
}


def _raised_alerts(result) -> set[str]:
    return {ev.get("alert") for ev in result.journal_events
            if ev.get("kind") == "alert_transition"}


def check_alert_coverage(result, find) -> None:
    """SIM113 (healthwatch-enabled runs only): the journaled
    alert_transition record covers the run's faults in BOTH directions.

      (a) required: every injected fault kind with a row in
          FAULT_ALERTS saw at least one alert of its class raised
          (leave ok at least once) somewhere in the run — across
          crash-restarts and every fleet worker (journals are
          unioned). Downgraded when any journal ring evicted events
          (the SIM112 honesty bound: a missing transition behind a
          nonzero dropped count may simply have fallen off the ring).
          Evidence-derived requirements ride along: a task the node
          drove to contested_resolved must have raised `contention`, a
          task marked invalid must have raised `invalid_inputs`, and a
          fleet run with lease steals must have raised `steal_surge`.
      (b) allowed: every raised alert is explained by an injected
          fault or by node-visible evidence — a clean run raises
          NOTHING, so a trigger-happy rule (or a stale coverage map)
          fails closed instead of normalizing alert noise."""
    if not getattr(result, "healthwatch_enabled", False):
        return
    raised = _raised_alerts(result)
    labels = classify_tasks(result)
    faults = result.plane.fault_counts
    # STEALS only — a coordinator RECLAIM's lag is observed under the
    # coordinator's obs, and the coordinator runs no healthwatch, so
    # no engine can ever raise steal_surge for it (a reclaimed lease
    # reaches workers as an ordinary re-deal); requiring it would fail
    # healthy reclaim-heavy runs
    steals = any(h[0] == "steal"
                 for h in getattr(result, "lease_history", ()))

    # (a) required coverage
    if getattr(result, "journal_dropped", 0) == 0:
        required: dict[str, tuple[str, ...]] = {}
        for kind, n in sorted(faults.items()):
            if n > 0 and kind in FAULT_ALERTS:
                required[f"fault {kind!r} (injected {n}x)"] = \
                    FAULT_ALERTS[kind]
        if any(lbl == "contested_resolved" for lbl in labels.values()):
            required["a contestation this node drove to resolution"] = \
                ("contention",)
        if any(lbl == "invalid" for lbl in labels.values()):
            required["a task marked invalid"] = ("invalid_inputs",)
        if steals:
            required["lease steals in the fleet history"] = \
                ("steal_surge",)
        for what, alerts in required.items():
            if not (set(alerts) & raised):
                find("SIM113", None,
                     f"{what} raised NO alert of its mapped class "
                     f"{list(alerts)} — the fault was silent: live "
                     "monitoring never surfaced what the fault plane "
                     "injected (docs/healthwatch.md coverage map)")

    # (b) no unexplained alerts
    allowed: set[str] = set()
    for kind, n in faults.items():
        if n > 0:
            allowed.update(FAULT_ALERTS.get(kind, ()))
    if faults.get("view_error", 0) > 0:
        # a view error raising out of an event subscriber makes the
        # node re-poll the range — an honestly OBSERVED replay
        allowed.add("chain_replay")
    if sum(faults.values()) > 0:
        # any fault — including the timing-only kinds — may back up
        # the staged executor; a stall alert under faults is signal,
        # under a clean run it is noise
        allowed.add("pipeline_stall")
    if any(f.evil for f in result.tasks.values()) \
            or result.engine.contestations:
        allowed.add("contention")
    if any(lbl == "invalid" for lbl in labels.values()):
        allowed.add("invalid_inputs")
    if any(db.failed_jobs() for db in _node_dbs(result)):
        allowed.add("job_quarantine")
    if result.restarts > 0:
        allowed.add("crash_recovered")
    if steals:
        allowed.add("steal_surge")
    for ev in result.journal_events:
        if ev.get("kind") in ("retry", "retry_exhausted"):
            allowed.add("pin_degraded" if str(ev.get("op", ""))
                        .startswith("pin_") else "rpc_degraded")
    for alert in sorted(raised - allowed):
        find("SIM113", None,
             f"alert {alert!r} was raised with no injected fault or "
             "node-visible evidence mapping to it — either the rule is "
             "trigger-happy or the FAULT_ALERTS coverage map is stale "
             "(docs/healthwatch.md)")


CHECKERS = (
    check_task_conservation,
    check_commit_before_reveal,
    check_no_duplicate_commitment,
    check_stake_never_negative,
    check_retries_bounded,
    check_cid_stability,
    check_token_conservation,
    check_liveness,
    check_stage_order,
    check_witness,
    check_fleet,
    check_trace_chain,
    check_alert_coverage,
)


def check_all(result) -> list[SimFinding]:
    findings: list[SimFinding] = []
    for checker in CHECKERS:
        def find(rule: str, taskid: str | None, message: str) -> None:
            findings.append(SimFinding(
                rule=rule, message=message, taskid=taskid,
                scenario=result.scenario.name, seed=result.seed))
        checker(result, find)
    return findings


def summarize(result) -> dict:
    """Deterministic per-run summary for reports (no wall-clock, no
    object addresses — byte-identical for identical (scenario, seed))."""
    labels = classify_tasks(result)
    terminal: dict[str, int] = {}
    for label in labels.values():
        terminal[label] = terminal.get(label, 0) + 1
    doc = {
        "scenario": result.scenario.name,
        "seed": result.seed,
        "tasks": len(result.tasks),
        "terminal": dict(sorted(terminal.items())),
        "per_task": {tid: {"index": f.index, "invalid": f.invalid,
                           "evil": f.evil, "state": labels[tid]}
                     for tid, f in sorted(result.tasks.items())},
        "faults_injected": dict(sorted(result.plane.fault_counts.items())),
        "writes_audited": len(result.plane.audit),
        "restarts": result.restarts,
        "rounds": result.rounds,
        "virtual_seconds": result.engine.now
        - result.engine.start_block_time,
        "quiescent": result.quiescent,
    }
    if getattr(result, "fleet_workers", ()):
        # fleet runs only — single-node summaries stay byte-identical
        # to their pre-fleet shape (test-pinned)
        per_worker: dict[str, int] = {}
        for s in result.engine.solutions.values():
            if s.validator in result.fleet_workers:
                per_worker[s.validator] = per_worker.get(
                    s.validator, 0) + 1
        doc["fleet"] = {
            "workers": len(result.fleet_workers),
            "per_worker_solutions": dict(sorted(per_worker.items())),
            "lease_counts": dict(sorted(result.lease_counts.items())),
            "steals": sum(1 for h in result.lease_history
                          if h[0] == "steal"),
            "reclaims": sum(1 for h in result.lease_history
                            if h[0] == "reclaim"),
            "commit_dedups": sum(1 for h in result.lease_history
                                 if h[0] == "commit_dedup"),
        }
    return doc
