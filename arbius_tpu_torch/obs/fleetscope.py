"""fleetscope — fleet-wide tracing, metrics federation, and SLOs.

The miner's fleet (fleet/) runs one member per process, and the
observability layer (obs/) is strictly per-process. This module is the
fleet-level half (docs/fleetscope.md):

  * **Sidecar persistence** — every fleet member (coordinator and each
    worker) periodically flushes its registry snapshot and new journal
    segments into its own sqlite sidecar (`<member>.obs.sqlite`, one
    writer per file — no cross-process contention on the obs plane).
  * **Federation** — `federate(dir)` reads every sidecar, merges the
    registry exports deterministically (counters/gauges sum, histogram
    bucket counts merge elementwise — mismatched edges are an error,
    obs.registry.merge_bucket_counts), and merges the journal segments
    into ONE chain-time-ordered fleet timeline. Same sidecar set in any
    filesystem order → byte-identical exposition (members sort by
    name, metrics by name, series by label key).
  * **Cross-process task timelines** — `task_timeline(events, taskid)`
    filters the merged journal to one task's lifecycle across every
    process: the coordinator's deal, each worker's hop adoption
    (`lease_hop`), and the solve spans — the per-task view SIM112
    audits and `tools/fleetscope.py timeline` renders.
  * **SLO layer** — `evaluate_slo` applies the validated
    `MiningConfig.slo` thresholds (queue-wait p95, time-to-commit p99,
    steal-lag p99, chip-idle fraction) to a percentile report built
    from fixed-bucket histograms (`latency_summary`), the substrate
    `simsoak --flood` fails closed on and the million-task nightly
    soak will stand on.
  * **Federated scrape** — `FleetMetricsServer` gives the coordinator
    a `GET /metrics` that renders the merged fleet exposition (its own
    registry plus every sidecar) in the exact byte format a single
    node's scrape uses.

Everything here is bookkeeping over chain time and already-recorded
events: enabling fleetscope never perturbs the solve path (fleet-of-1
CIDs and all goldens stay byte-identical — test-pinned).
"""
# detlint: enforce[DET101,DET102,DET103,DET105]
from __future__ import annotations

import json
import os
import sqlite3
import threading

from arbius_tpu_torch.node.config import SLOConfig
from arbius_tpu_torch.obs.registry import (
    CHAIN_SECONDS_BUCKETS,
    estimate_percentile,
    merge_bucket_counts,
    render_export,
)

SIDECAR_SUFFIX = ".obs.sqlite"

_SCHEMA = """
CREATE TABLE IF NOT EXISTS meta (key TEXT PRIMARY KEY, value TEXT);
CREATE TABLE IF NOT EXISTS snapshots (
    id INTEGER PRIMARY KEY CHECK (id = 1),
    chain_now INT, export TEXT);
CREATE TABLE IF NOT EXISTS journal (
    seq INT PRIMARY KEY, chain INT, event TEXT);
"""

_FLUSH_HELP = ("Obs sidecar flushes (registry snapshot + journal "
               "segment persisted for federation, docs/fleetscope.md)")


def sidecar_path(dirpath: str, member: str) -> str:
    return os.path.join(dirpath, member + SIDECAR_SUFFIX)


class ObsSidecar:
    """One fleet member's obs persistence: the member is the only
    writer of its file (no cross-process locking on the obs plane —
    readers merge under WAL). The snapshot table holds only the LATEST
    registry export (row id pinned to 1), and the journal table keeps
    at most `journal_retention` events (older segments are pruned at
    flush — the same flight-recorder semantics as the in-memory ring,
    one level bigger), so the sidecar stays bounded on a long-running
    member. Journal rows are INSERT OR IGNOREd by the journal's own
    monotonic seq, so a re-flush after a missed window is idempotent.
    Thread-safe within the process (the NodeDB handle discipline:
    every use of the connection holds `_lock`)."""

    def __init__(self, path: str, member: str, obs, *,
                 journal_retention: int = 65536):
        self.path = path
        self.member = member
        self.obs = obs
        self.journal_retention = max(1, int(journal_retention))
        self._lock = threading.Lock()
        self._last_seq = 0
        conn = sqlite3.connect(path, check_same_thread=False,
                               isolation_level=None)
        conn.row_factory = sqlite3.Row
        conn.execute("PRAGMA busy_timeout=5000")
        conn.execute("PRAGMA journal_mode=WAL")
        conn.execute("PRAGMA synchronous=NORMAL")
        with self._lock:
            self._conn = conn
            self._conn.executescript(_SCHEMA)
            self._conn.execute(
                "INSERT OR REPLACE INTO meta (key, value)"
                " VALUES ('member', ?)", (member,))
            # a sidecar OPEN marks a new obs stream (one writer per
            # file): any persisted journal rows belong to a previous
            # process life whose seq numbering is unrelated to this
            # journal's, and INSERT OR IGNORE against them would
            # silently freeze or interleave the two lives — clear
            # unconditionally (the snapshot is replaced at first flush
            # anyway; flight-recorder semantics)
            self._conn.execute("DELETE FROM journal")

    def flush(self, now: int = 0) -> int:
        """Persist the current registry snapshot and every journal
        event newer than the last flush. Returns new events written."""
        export = self.obs.registry.export()
        events = [e for e in self.obs.journal.events()
                  if e.get("seq", 0) > self._last_seq]
        with self._lock:
            self._conn.execute("BEGIN IMMEDIATE")
            try:
                self._conn.execute(
                    "INSERT OR REPLACE INTO snapshots (id, chain_now,"
                    " export) VALUES (1, ?, ?)",
                    (int(now), json.dumps(export, sort_keys=True)))
                for ev in events:
                    self._conn.execute(
                        "INSERT OR IGNORE INTO journal (seq, chain,"
                        " event) VALUES (?,?,?)",
                        (int(ev["seq"]), int(ev.get("chain", 0)),
                         json.dumps(ev, sort_keys=True, default=str)))
                if events:
                    # retention bound: the sidecar is a flight
                    # recorder, not an archive — old segments fall off
                    self._conn.execute(
                        "DELETE FROM journal WHERE seq <= ?",
                        (max(e["seq"] for e in events)
                         - self.journal_retention,))
            except BaseException:
                self._conn.execute("ROLLBACK")
                raise
            self._conn.execute("COMMIT")
        if events:
            self._last_seq = max(e["seq"] for e in events)
        self.obs.registry.counter(
            "arbius_obs_sidecar_flushes_total", _FLUSH_HELP).inc()
        return len(events)

    def close(self) -> None:
        # teardown-only, mirrors NodeDB.close: no lock — a dying tick
        # mid-flush must not deadlock the close
        self._conn.close()


# ---------------------------------------------------------------------------
# readers + federation
# ---------------------------------------------------------------------------

def read_sidecar(path: str, *, with_events: bool = True
                 ) -> tuple[str, dict, list[dict]]:
    """(member, latest registry export, journal events) from one
    sidecar file. Opens read-only per call — the reader never holds a
    handle across scrapes; `with_events=False` skips the journal table
    entirely (a metrics scrape needs only the one snapshot row, not a
    retention-sized event load). A corrupt/truncated file (a member
    killed mid-creation) raises ValueError naming the file, the error
    class every federation consumer already handles — never a raw
    sqlite3.DatabaseError traceback."""
    conn = sqlite3.connect(path, check_same_thread=False)
    conn.row_factory = sqlite3.Row
    try:
        conn.execute("PRAGMA busy_timeout=5000")
        row = conn.execute(
            "SELECT value FROM meta WHERE key='member'").fetchone()
        member = row["value"] if row else os.path.basename(path)
        snap = conn.execute(
            "SELECT export FROM snapshots WHERE id=1").fetchone()
        export = json.loads(snap["export"]) if snap else {"metrics": {}}
        events = [] if not with_events else \
            [json.loads(r["event"]) for r in conn.execute(
                "SELECT event FROM journal ORDER BY seq")]
        return member, export, events
    except (sqlite3.Error, json.JSONDecodeError) as e:
        raise ValueError(f"unreadable obs sidecar {path}: {e}") from e
    finally:
        conn.close()


def read_sidecars(dirpath: str, *, with_events: bool = True
                  ) -> list[tuple[str, dict, list[dict]]]:
    """Every sidecar under `dirpath`, sorted by MEMBER name — the merge
    key, so filesystem enumeration order never reaches the output."""
    out = []
    for fname in sorted(os.listdir(dirpath)):
        if fname.endswith(SIDECAR_SUFFIX):
            out.append(read_sidecar(os.path.join(dirpath, fname),
                                    with_events=with_events))
    out.sort(key=lambda t: t[0])
    return out


def merge_exports(exports: list[tuple[str, dict]]) -> dict:
    """Deterministically merge per-member registry exports into one
    fleet-level export: counters and gauges sum (a NaN contribution —
    a dead gauge source — propagates, it is never masked), histograms
    merge bucket counts elementwise and REJECT mismatched edge sets
    (obs.registry.merge_bucket_counts), and a labeled callback gauge
    whose source died in ANY member marks the merged series dead.
    Contributions fold in member-name order, so the same member set in
    any input order produces a byte-identical merge."""
    merged: dict = {"version": 1, "metrics": {}}
    out = merged["metrics"]
    for member, export in sorted(exports, key=lambda t: t[0]):
        for name, m in sorted(export.get("metrics", {}).items()):
            cur = out.get(name)
            if cur is None:
                cur = out[name] = {
                    "kind": m.get("kind", "untyped"),
                    "help": m.get("help", ""),
                    "labelnames": list(m.get("labelnames") or ()),
                    "series": [],
                }
                if m.get("kind") == "histogram":
                    cur["buckets"] = list(m.get("buckets") or ())
            else:
                if cur["kind"] != m.get("kind") or \
                        cur["labelnames"] != list(m.get("labelnames")
                                                  or ()):
                    raise ValueError(
                        f"metric {name}: member {member} exports kind="
                        f"{m.get('kind')}/{m.get('labelnames')} but an "
                        f"earlier member exported {cur['kind']}/"
                        f"{cur['labelnames']} — two call sites are "
                        "feeding different shapes into one name")
                if not cur["help"] and m.get("help"):
                    cur["help"] = m["help"]
                if m.get("kind") == "histogram":
                    # edge compatibility is checked per METRIC, not per
                    # overlapping series — a member contributing only
                    # new label series must not smuggle drifted edges
                    # past the per-series merge below
                    n = len(cur["buckets"]) + 1
                    merge_bucket_counts(cur["buckets"], [0] * n,
                                        m.get("buckets") or (), [0] * n)
            if m.get("dead"):
                cur["dead"] = True
            series = {tuple(k): rest for k, *rest
                      in (s for s in cur["series"])}
            if m.get("kind") == "histogram":
                for key, counts, total, count in m.get("series") or ():
                    key = tuple(key)
                    prev = series.get(key)
                    if prev is None:
                        series[key] = [list(counts), total, count]
                    else:
                        prev[0] = merge_bucket_counts(
                            cur["buckets"], prev[0],
                            m.get("buckets") or (), counts)
                        prev[1] += total
                        prev[2] += count
            else:
                for key, value in m.get("series") or ():
                    key = tuple(key)
                    prev = series.get(key)
                    if prev is None:
                        series[key] = [value]
                    else:
                        prev[0] += value
            cur["series"] = [[list(k), *rest]
                             for k, rest in sorted(series.items())]
    return merged


def merge_journals(members: list[tuple[str, list[dict]]]) -> list[dict]:
    """One fleet timeline from per-member journal segments: every event
    annotated with its `member`, ordered by (chain time, member, seq) —
    a deterministic total order (wall stamps never order anything)."""
    out = []
    for member, events in sorted(members, key=lambda t: t[0]):
        for ev in events:
            e = dict(ev)
            e["member"] = member
            out.append(e)
    out.sort(key=lambda e: (e.get("chain", 0), e["member"],
                            e.get("seq", 0)))
    return out


def task_timeline(events: list[dict], taskid: str) -> list[dict]:
    """One task's cross-process lifecycle from a merged fleet timeline
    (same taskid/taskids matching the journal uses)."""
    return [e for e in events
            if e.get("taskid") == taskid
            or taskid in (e.get("taskids") or ())]


def federate(dirpath: str, extra: list[tuple[str, object]] = (), *,
             with_events: bool = True) -> dict:
    """Read every sidecar under `dirpath` (plus `extra` live
    (member, Obs) pairs — the coordinator's own registry) and return
    the fleet view: members, merged export, merged timeline. A sidecar
    whose member name matches a live `extra` member is SKIPPED — the
    live registry supersedes its own stale snapshot (the coordinator
    flushes a sidecar into the same directory it scrapes; counting
    both would double every one of its series). `with_events=False`
    skips the journal load/merge entirely (`events` comes back empty)
    — the metrics-scrape path, which must not pay a retention-sized
    timeline merge per scrape."""
    live = {member for member, _ in extra}
    sidecars = [(m, e, ev) for m, e, ev
                in read_sidecars(dirpath, with_events=with_events)
                if m not in live]
    exports = [(m, e) for m, e, _ in sidecars]
    journals = [(m, ev) for m, _, ev in sidecars]
    for member, obs in extra:
        exports.append((member, obs.registry.export()))
        journals.append((member,
                         obs.journal.events() if with_events else []))
    return {
        "members": sorted(m for m, _ in exports),
        "export": merge_exports(exports),
        "events": merge_journals(journals) if with_events else [],
    }


def fleet_exposition(dirpath: str, extra: list[tuple[str, object]] = ()
                     ) -> str:
    """The federated Prometheus text exposition — byte-format-identical
    to a single node's `GET /metrics`. Export-only: the journal tables
    are never read on this path."""
    return render_export(
        federate(dirpath, extra, with_events=False)["export"])


# ---------------------------------------------------------------------------
# the SLO layer
# ---------------------------------------------------------------------------

def latency_summary(values, edges=CHAIN_SECONDS_BUCKETS) -> dict:
    """p50/p95/p99 + count over `values` through a fixed-bucket
    histogram with the named `edges` set — the SAME estimator
    (`obs.registry.estimate_percentile`) the federated path runs over
    merged bucket counts, so a flood report and a live fleet scrape
    answer percentile questions from one substrate. Byte-deterministic
    for integer chain-second inputs."""
    from bisect import bisect_left

    edges = tuple(float(e) for e in edges)
    counts = [0] * (len(edges) + 1)
    for v in values:
        counts[bisect_left(edges, float(v))] += 1
    out = {"count": sum(counts)}
    for q, name in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
        p = estimate_percentile(edges, counts, q)
        out[name] = None if p is None else round(p, 6)
    return out


def summarize_histogram_export(m: dict) -> dict:
    """latency_summary's shape from a (merged) histogram export entry,
    summing every label series."""
    edges = tuple(m.get("buckets") or ())
    counts = [0] * (len(edges) + 1)
    for _, series_counts, _, _ in m.get("series") or ():
        counts = merge_bucket_counts(edges, counts, edges, series_counts)
    out = {"count": sum(counts)}
    for q, name in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
        p = estimate_percentile(edges, counts, q)
        out[name] = None if p is None else round(p, 6)
    return out


def evaluate_slo(cfg: SLOConfig, report: dict) -> list[str]:
    """Apply the validated `slo` config block to a percentile report
    (`queue_wait_seconds` / `time_to_commit_seconds` /
    `steal_lag_seconds` latency_summary blocks + optional
    `chip_idle_fraction`). Returns sorted breach strings; empty = every
    declared objective held. A None threshold declares no objective; a
    missing/empty percentile never breaches (no traffic is not a
    breach — liveness is SIM108's job)."""
    breaches = []

    def check(block_name: str, pct: str, bound) -> None:
        if bound is None:
            return
        block = report.get(block_name) or {}
        got = block.get(pct)
        if got is not None and got > bound:
            breaches.append(
                f"{block_name} {pct} {got}s exceeds the declared SLO "
                f"{bound}s (over {block.get('count', 0)} samples)")

    check("queue_wait_seconds", "p95", cfg.queue_wait_p95)
    check("time_to_commit_seconds", "p99", cfg.time_to_commit_p99)
    check("steal_lag_seconds", "p99", cfg.steal_lag_p99)
    if cfg.chip_idle_fraction is not None:
        frac = report.get("chip_idle_fraction")
        if frac is not None and frac > cfg.chip_idle_fraction:
            breaches.append(
                f"chip_idle_fraction {frac} exceeds the declared SLO "
                f"{cfg.chip_idle_fraction}")
    return sorted(breaches)


# ---------------------------------------------------------------------------
# the coordinator's federated scrape
# ---------------------------------------------------------------------------

class FleetMetricsServer:
    """`GET /metrics` for the whole fleet, served by the coordinator:
    merges every sidecar under `sidecar_dir` with the coordinator's own
    live registry and renders one exposition. Same operator-only,
    localhost-bound posture as the node's ControlRPC."""

    def __init__(self, sidecar_dir: str, obs=None, *,
                 member: str = "coordinator",
                 host: str = "127.0.0.1", port: int = 0):
        import http.server

        self.sidecar_dir = sidecar_dir
        self._extra = [(member, obs)] if obs is not None else []
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet, like ControlRPC
                pass

            def do_GET(self):
                # `outer` and its fields are boot-time constants; the
                # sidecar reads open their own per-call handles
                try:
                    if self.path != "/metrics":
                        body = b'{"error": "not found"}'
                        self.send_response(404)
                        ctype = "application/json"
                    else:
                        try:
                            body = fleet_exposition(
                                outer.sidecar_dir,
                                outer._extra).encode()
                            self.send_response(200)
                            ctype = ("text/plain; version=0.0.4; "
                                     "charset=utf-8")
                        except Exception as e:  # noqa: BLE001 — one
                            # corrupt sidecar / drifted member must
                            # answer a diagnosable 500, not reset the
                            # scraper's connection (the ControlRPC
                            # view-error contract)
                            body = json.dumps(
                                {"error": f"{type(e).__name__}: {e}"},
                                sort_keys=True).encode()
                            self.send_response(500)
                            ctype = "application/json"
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                except (BrokenPipeError, ConnectionError):
                    pass

        self.server = http.server.ThreadingHTTPServer((host, port),
                                                      Handler)
        self.port = self.server.server_address[1]
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self.server.serve_forever, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self.server.shutdown()
        self.server.server_close()
