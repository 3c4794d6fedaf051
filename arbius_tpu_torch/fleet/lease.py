"""Fleet lease table — the shared sqlite coordination plane.

One file, opened by the coordinator and by every worker process, holds
the fleet's entire shared state: the task lease queue, the
cross-process commit-rights registry, and the shared-wallet guard row.
All cross-process mutual exclusion is sqlite's own file locking under
WAL + busy_timeout — `connect_fleet_db` is THE one constructor for
handles on this file (conclint CONC406 audits the discipline), and
every mutation runs inside a `BEGIN IMMEDIATE` transaction so a
SELECT-then-UPDATE claim is atomic against every other process.

Lease state machine (docs/fleet.md):

    pending ──acquire──▶ leased ──complete──▶ done | invalid
       ▲                   │
       └──release/reclaim──┘        attempts ≥ max_attempts ──▶ failed

  - `acquire` is work-stealing: it claims `pending` rows AND `leased`
    rows whose heartbeat expired (a dead or partitioned worker's tasks
    become someone else's work within the TTL);
  - `complete` is holder-agnostic: a task observed solved on chain
    settles its lease no matter who holds it;
  - `failed` is the poison-task bound: a task that burned
    `max_attempts` lease deliveries stops ping-ponging.

Commit dedupe: `claim_commit` grants exclusive commit rights per task.
The first worker to reach the commit step wins; a loser skips its
`signalCommitment` entirely (the node's `commit_guard` seam), so two
workers never double-commit one `(validator, taskid)` — and a holder
whose lease was reclaimed loses its rights to the reclaimer (the
crashed-after-commit worker's task must still be finishable).

Trace propagation (docs/fleetscope.md): every lease row carries a
`hops` JSON chain — the coordinator's `deal` plus every `acquire` /
`steal` / `reclaim` hop, stamped with the acting worker, chain time,
and a contiguous hop index assigned inside the same transaction that
performs the transition. Workers adopt their hop into their own obs
journal (`lease_hop`, worker.py), so one task's lifecycle is a single
gap-free span chain across processes even through a steal — SIM112
audits exactly this, and `arbius_fleet_queue_wait_seconds` /
`arbius_fleet_time_to_commit_seconds` (fixed chain-second buckets, the
SLO substrate) are observed at the same transitions.

Everything is keyed on chain time (`now` is always passed in) and
insertion rowids — no wall clock, no host randomness — so a fleet run
is deterministic for a fixed event stream.
"""
# detlint: enforce[DET101,DET102,DET103,DET105]
from __future__ import annotations

import json
import sqlite3
import threading
from contextlib import contextmanager
from dataclasses import dataclass

from arbius_tpu_torch.obs import current_obs
from arbius_tpu_torch.obs.registry import CHAIN_SECONDS_BUCKETS

_SCHEMA = """
CREATE TABLE IF NOT EXISTS leases (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    taskid TEXT UNIQUE, model TEXT, fee TEXT, blocktime INT,
    state TEXT, worker TEXT DEFAULT '', expires INT DEFAULT 0,
    acquired INT DEFAULT 0, attempts INT DEFAULT 0,
    steals INT DEFAULT 0, hops TEXT DEFAULT '[]');
CREATE TABLE IF NOT EXISTS fleet_commits (
    taskid TEXT PRIMARY KEY, validator TEXT, worker TEXT, cid TEXT);
CREATE TABLE IF NOT EXISTS fleet_wallet (
    address TEXT PRIMARY KEY, holder TEXT);
CREATE INDEX IF NOT EXISTS leases_state ON leases(state, id);
"""

LEASE_STATES = ("pending", "leased", "done", "invalid", "failed")
TERMINAL_STATES = ("done", "invalid", "failed")


def connect_fleet_db(path: str, busy_timeout_ms: int = 5000
                     ) -> sqlite3.Connection:
    """THE one constructor for handles on the shared fleet database.

    WAL lets readers in other processes proceed under a writer's
    transaction, and busy_timeout turns writer-writer contention into a
    bounded wait instead of an instant "database is locked" — the
    cross-process lock discipline conclint's CONC406 enforces on this
    package. isolation_level=None puts the handle in autocommit so the
    explicit `BEGIN IMMEDIATE` spans below own their transactions."""
    conn = sqlite3.connect(path, check_same_thread=False,
                           isolation_level=None)
    conn.row_factory = sqlite3.Row
    conn.execute(f"PRAGMA busy_timeout={int(busy_timeout_ms)}")
    conn.execute("PRAGMA journal_mode=WAL")
    # WAL + NORMAL: commits are durable against process crash but not
    # against power loss — correct for the lease table, whose entire
    # contents re-derive from the chain's event stream (and the 10k
    # flood would otherwise spend most of its wall time in fsync)
    conn.execute("PRAGMA synchronous=NORMAL")
    return conn


@dataclass(frozen=True)
class LeaseGrant:
    """One task handed to a worker by `acquire`."""
    taskid: str
    model: str
    fee: int
    blocktime: int
    attempts: int
    stolen: bool          # reclaimed from another worker's expired lease
    # this grant's index in the task's cross-process trace-hop chain
    # (assigned in the claim transaction; the worker journals its
    # adoption as a `lease_hop` event — docs/fleetscope.md)
    hop: int = 0


def _hop(hops_json: str, op: str, worker: str, now: int,
         **extra) -> tuple[str, int]:
    """Append one hop to a row's JSON chain; returns (new chain JSON,
    the appended hop's index). The index is the prior chain length, so
    indices stay contiguous by construction."""
    hops = json.loads(hops_json or "[]")
    index = len(hops)
    hops.append(dict({"hop": index, "op": op, "worker": worker,
                      "now": now}, **extra))
    return json.dumps(hops, sort_keys=True), index


class LeaseTable:
    """One process's handle on the shared lease plane.

    Thread-safe within the process (`_lock` guards the sqlite handle —
    the NodeDB discipline, CONC404) and atomic across processes (every
    mutator is one IMMEDIATE transaction). `history` is an in-process
    transition log for simnet audits and /debug views; it is NOT shared
    state — each process sees only the transitions it performed."""

    def __init__(self, path: str, busy_timeout_ms: int = 5000):
        self._path = path
        self._conn = connect_fleet_db(path, busy_timeout_ms)
        self._busy_timeout_ms = busy_timeout_ms
        self._lock = threading.Lock()
        self._wallet_conn = None     # lazy: shared-wallet mode only
        self._wallet_lock = threading.Lock()
        self.history: list[tuple] = []   # (op, taskid, worker, now, extra)
        with self._lock:
            # executescript manages its own transaction (and would
            # auto-commit an explicit BEGIN around it)
            self._conn.executescript(_SCHEMA)
            # pre-fleetscope lease files lack the trace-hop column; the
            # table re-derives from the chain either way, so migrating
            # in place is strictly additive
            cols = {r["name"] for r in self._conn.execute(
                "PRAGMA table_info(leases)")}
            if "hops" not in cols:
                self._conn.execute("ALTER TABLE leases ADD COLUMN"
                                   " hops TEXT DEFAULT '[]'")

    def close(self) -> None:
        # detlint: allow[CONC404] teardown-only, mirrors NodeDB.close:
        # taking _lock here could deadlock a dying tick mid-transaction
        self._conn.close()
        if self._wallet_conn is not None:
            self._wallet_conn.close()

    @contextmanager
    def _txn(self):
        """One atomic read-modify-write against every other process:
        BEGIN IMMEDIATE takes the file's write lock up front (waiting
        out busy_timeout), so a SELECT inside the span cannot be
        invalidated by a concurrent writer before the UPDATE lands."""
        with self._lock:
            self._conn.execute("BEGIN IMMEDIATE")
            try:
                yield self._conn
            except BaseException:
                self._conn.execute("ROLLBACK")
                raise
            self._conn.execute("COMMIT")

    def _note(self, op: str, taskid: str, worker: str, now: int,
              **extra) -> None:
        self.history.append((op, taskid, worker, now, extra))
        obs = current_obs()
        if obs is not None:
            obs.registry.counter(
                "arbius_fleet_leases_total",
                "Lease-table transitions by resulting state/op "
                "(docs/fleet.md)", labelnames=("state",)).inc(state=op)

    # -- task intake (coordinator) ---------------------------------------
    def add_task(self, taskid: str, model: str, fee: int,
                 blocktime: int, now: int) -> bool:
        """Enter a task into the lease plane (INSERT OR IGNORE — the
        coordinator's event stream may replay). True when new."""
        with self._txn() as conn:
            cur = conn.execute(
                "INSERT OR IGNORE INTO leases (taskid, model, fee,"
                " blocktime, state, hops) VALUES (?,?,?,?,'pending',?)",
                (taskid, model, str(fee), blocktime,
                 _hop("[]", "deal", "", now)[0]))
            fresh = cur.rowcount > 0
        if fresh:
            self._note("pending", taskid, "", now)
        return fresh

    # -- work-stealing claim (workers) -----------------------------------
    def acquire(self, worker: str, now: int, ttl: int,
                limit: int) -> list[LeaseGrant]:
        """Claim up to `limit` tasks for `worker`: pending rows first,
        then expired leases of other workers (the steal), in insertion
        order — the same arrival order a single node would process, so
        a fleet of one is schedule-identical to a bare MinerNode."""
        if limit <= 0:
            return []
        grants: list[LeaseGrant] = []
        queue_waits: list[tuple[str, int]] = []
        steal_lags: list[tuple[str, int]] = []
        with self._txn() as conn:
            rows = conn.execute(
                "SELECT id, taskid, model, fee, blocktime, state, worker,"
                " expires, attempts, hops FROM leases"
                " WHERE state = 'pending'"
                " OR (state = 'leased' AND expires < ?)"
                " ORDER BY id LIMIT ?", (now, limit)).fetchall()
            for r in rows:
                stolen = r["state"] == "leased" and r["worker"] != worker
                extra = {"lag": now - int(r["expires"])} if stolen else {}
                hops, hop_index = _hop(
                    r["hops"], "steal" if stolen else "acquire",
                    worker, now, **extra)
                conn.execute(
                    "UPDATE leases SET state='leased', worker=?,"
                    " expires=?, acquired=?, attempts=attempts+1,"
                    " steals=steals+?, hops=? WHERE id=?",
                    (worker, now + ttl, now, int(stolen), hops, r["id"]))
                grants.append(LeaseGrant(
                    taskid=r["taskid"], model=r["model"],
                    fee=int(r["fee"]), blocktime=int(r["blocktime"]),
                    attempts=int(r["attempts"]) + 1, stolen=stolen,
                    hop=hop_index))
                if int(r["attempts"]) == 0 and r["state"] == "pending":
                    # first delivery: deal → acquire is the task's
                    # queue wait (the SLO corpus, docs/fleetscope.md)
                    queue_waits.append((r["taskid"],
                                        now - int(r["blocktime"])))
                if stolen:
                    # lag from heartbeat expiry to the steal — SIM111's
                    # reclaimed-within-ttl audit reads this
                    lag = now - int(r["expires"])
                    steal_lags.append((r["taskid"], lag))
                    self.history.append((
                        "steal", r["taskid"], worker, now,
                        {"from": r["worker"], "lag": lag}))
        for g in grants:
            self._note("leased", g.taskid, worker, now)
        obs = current_obs()
        if obs is not None:
            for tid, wait in queue_waits:
                obs.registry.histogram(
                    "arbius_fleet_queue_wait_seconds",
                    "Chain-seconds from the coordinator's deal to the "
                    "first worker acquire (fixed chain-second buckets "
                    "— the SLO substrate, docs/fleetscope.md)",
                    buckets=CHAIN_SECONDS_BUCKETS).observe(wait, tag=tid)
            for tid, lag in steal_lags:
                self._observe_steal_lag(obs, tid, lag)
        return grants

    @staticmethod
    def _observe_steal_lag(obs, tid: str, lag: int) -> None:
        """Steal/reclaim lag into the SLO corpus: chain-seconds an
        expired lease lingered past its heartbeat before someone took
        it back — the `slo.steal_lag_p99` objective's histogram."""
        obs.registry.histogram(
            "arbius_fleet_steal_lag_seconds",
            "Chain-seconds an expired lease lingered past its "
            "heartbeat before being stolen/reclaimed (fixed "
            "chain-second buckets — the SLO substrate, "
            "docs/fleetscope.md)",
            buckets=CHAIN_SECONDS_BUCKETS).observe(lag, tag=tid)

    def heartbeat(self, worker: str, now: int, ttl: int) -> int:
        """Extend every lease `worker` still holds. Returns how many."""
        with self._txn() as conn:
            cur = conn.execute(
                "UPDATE leases SET expires=? WHERE worker=?"
                " AND state='leased'", (now + ttl, worker))
            return cur.rowcount

    def held(self, worker: str) -> list[str]:
        """Taskids currently leased to `worker`, insertion order."""
        with self._lock:
            rows = self._conn.execute(
                "SELECT taskid FROM leases WHERE worker=?"
                " AND state='leased' ORDER BY id", (worker,))
            return [r["taskid"] for r in rows]

    # -- settlement -------------------------------------------------------
    def complete(self, taskid: str, worker: str, now: int,
                 state: str = "done") -> float | None:
        """Settle a lease into a terminal state. Holder-agnostic: a
        task observed solved on chain is done no matter whose lease it
        rides. Returns the lease age in chain-seconds (acquired →
        settled) for the obs histogram, None when already terminal."""
        if state not in TERMINAL_STATES:
            raise ValueError(f"not a terminal lease state: {state!r}")
        with self._txn() as conn:
            row = conn.execute(
                "SELECT acquired, state, blocktime FROM leases"
                " WHERE taskid=?", (taskid,)).fetchone()
            if row is None or row["state"] in TERMINAL_STATES:
                return None
            conn.execute(
                "UPDATE leases SET state=?, worker=? WHERE taskid=?",
                (state, worker, taskid))
            age = float(now - int(row["acquired"])) \
                if row["acquired"] else 0.0
        self._note(state, taskid, worker, now)
        obs = current_obs()
        if obs is not None:
            obs.registry.histogram(
                "arbius_fleet_lease_age_seconds",
                "Chain-seconds from lease acquisition to settlement "
                "(docs/fleet.md)").observe(age, tag=taskid)
            if state == "done":
                # deal → solved-on-chain, as observed at settlement:
                # the fleet's time-to-commit corpus (docs/fleetscope.md;
                # the flood report derives the exact solution-blocktime
                # version from the engine — this is the live-scrape one)
                obs.registry.histogram(
                    "arbius_fleet_time_to_commit_seconds",
                    "Chain-seconds from the coordinator's deal to the "
                    "task's solution being observed settled (fixed "
                    "chain-second buckets — the SLO substrate, "
                    "docs/fleetscope.md)",
                    buckets=CHAIN_SECONDS_BUCKETS).observe(
                    now - int(row["blocktime"]), tag=taskid)
        return age

    def release(self, taskid: str, worker: str, now: int,
                max_attempts: int) -> str:
        """Give a lease back (transient failure on this worker):
        pending again, unless its attempts already hit the poison-task
        bound — then it settles `failed`. Returns the resulting state.

        Holder-CHECKED, unlike complete(): a release is a statement
        about the caller's own failure, so a stale worker whose expired
        lease was already stolen must not flip the thief's live lease
        back to pending (duplicate solve) or to failed (a task someone
        is actively finishing recorded dead)."""
        with self._txn() as conn:
            row = conn.execute(
                "SELECT attempts, state, worker FROM leases"
                " WHERE taskid=?", (taskid,)).fetchone()
            if row is None or row["state"] != "leased":
                return row["state"] if row else "missing"
            if row["worker"] != worker:
                return "stolen"
            state = "failed" if int(row["attempts"]) >= max_attempts \
                else "pending"
            conn.execute(
                "UPDATE leases SET state=?, worker=? WHERE taskid=?"
                " AND state='leased' AND worker=?",
                (state, worker if state == "failed" else "", taskid,
                 worker))
        self._note("released" if state == "pending" else state,
                   taskid, worker, now)
        return state

    def reclaim(self, now: int, max_attempts: int) -> list[tuple]:
        """Coordinator sweep: flip expired leases back to pending (or
        failed past the attempt bound) so they are visible as available
        work even before any worker's acquire would steal them.
        Returns [(taskid, dead_worker, lag_seconds)]."""
        out: list[tuple] = []
        with self._txn() as conn:
            rows = conn.execute(
                "SELECT taskid, worker, expires, attempts, hops"
                " FROM leases"
                " WHERE state='leased' AND expires < ? ORDER BY id",
                (now,)).fetchall()
            for r in rows:
                state = "failed" if int(r["attempts"]) >= max_attempts \
                    else "pending"
                lag = now - int(r["expires"])
                conn.execute(
                    "UPDATE leases SET state=?, worker=?,"
                    " steals=steals+1, hops=? WHERE taskid=?",
                    (state, "" if state == "pending" else r["worker"],
                     _hop(r["hops"], "reclaim", "", now,
                          source=r["worker"], lag=lag)[0],
                     r["taskid"]))
                out.append((r["taskid"], r["worker"], lag))
        for taskid, dead, lag in out:
            self.history.append(("reclaim", taskid, dead, now,
                                 {"lag": lag}))
            obs = current_obs()
            if obs is not None:
                obs.registry.counter(
                    "arbius_fleet_reclaims_total",
                    "Expired leases swept back to pending by the "
                    "coordinator (docs/fleet.md)").inc()
                self._observe_steal_lag(obs, taskid, lag)
        return out

    # -- cross-process commit dedupe -------------------------------------
    def claim_commit(self, taskid: str, validator: str, worker: str,
                     cid: str, now: int) -> bool:
        """Grant exclusive commit rights for `taskid`. True = commit;
        False = another worker holds the rights AND its lease is still
        live — skip the commitment entirely. A holder whose lease was
        reclaimed (crash after commit) loses its rights to the caller,
        so the task stays finishable."""
        with self._txn() as conn:
            row = conn.execute(
                "SELECT validator, worker, cid FROM fleet_commits"
                " WHERE taskid=?", (taskid,)).fetchone()
            if row is None:
                conn.execute(
                    "INSERT INTO fleet_commits (taskid, validator,"
                    " worker, cid) VALUES (?,?,?,?)",
                    (taskid, validator, worker, cid))
                granted = True
            elif row["worker"] == worker:
                granted = True       # idempotent resume (crash-restart)
            else:
                lease = conn.execute(
                    "SELECT worker, state, expires FROM leases"
                    " WHERE taskid=?", (taskid,)).fetchone()
                live = (lease is not None
                        and lease["state"] == "leased"
                        and lease["worker"] == row["worker"]
                        and int(lease["expires"]) >= now)
                if live:
                    granted = False
                else:
                    conn.execute(
                        "UPDATE fleet_commits SET validator=?, worker=?,"
                        " cid=? WHERE taskid=?",
                        (validator, worker, cid, taskid))
                    granted = True
        self._note("commit_claim" if granted else "commit_dedup",
                   taskid, worker, now)
        return granted

    def commit_rows(self) -> list[sqlite3.Row]:
        with self._lock:
            return self._conn.execute(
                "SELECT taskid, validator, worker, cid FROM fleet_commits"
                " ORDER BY taskid").fetchall()

    # -- shared-wallet tx guard ------------------------------------------
    @contextmanager
    def wallet_guard(self, address: str, holder: str):
        """Cross-process mutex for shared-wallet tx signing: BEGIN
        IMMEDIATE on a dedicated handle holds the lease file's write
        lock for the duration of nonce-read → sign → send, so two
        workers sharing one wallet serialize their nonces through the
        coordinator's database (docs/fleet.md wallet modes). The holder
        row makes the lock observable for debugging.

        Deliberate tradeoff: the lock spans the HTTP round trip, so a
        hung endpoint stalls every other member's lease WRITES for up
        to the tx timeout (reads proceed under WAL; stalled writers
        wait out busy_timeout and retry next tick). That serialization
        IS the nonce-safety mechanism — there is no burned-nonce
        recovery protocol to run instead — which is why "shared" is
        the small-fleet mode and "per-worker" wallets are the default
        (docs/fleet.md)."""
        with self._wallet_lock:
            if self._wallet_conn is None:
                self._wallet_conn = connect_fleet_db(
                    self._path, self._busy_timeout_ms)
            conn = self._wallet_conn
            conn.execute("BEGIN IMMEDIATE")
            try:
                conn.execute(
                    "INSERT OR REPLACE INTO fleet_wallet (address, holder)"
                    " VALUES (?,?)", (address.lower(), holder))
                yield
            except BaseException:
                conn.execute("ROLLBACK")
                raise
            conn.execute("COMMIT")

    # -- introspection ----------------------------------------------------
    def counts(self) -> dict[str, int]:
        """state -> row count (the lease-state gauge's callback)."""
        with self._lock:
            rows = self._conn.execute(
                "SELECT state, COUNT(*) c FROM leases GROUP BY state")
            return {r["state"]: r["c"] for r in rows}

    def rows(self) -> list[sqlite3.Row]:
        """Full lease dump in insertion order (simnet audits)."""
        with self._lock:
            return self._conn.execute(
                "SELECT * FROM leases ORDER BY id").fetchall()
