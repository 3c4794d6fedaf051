"""conclint runtime witness — the dynamic half of the race audit.

The static pass (rules.py) proves properties of the *program text*; the
witness observes one *execution* and cross-checks. Under the simnet
scenario matrix (sim/harness.py grows a `witness=` seam) it records:

  - **lock acquisitions** through `WitnessLock`/`WitnessCondition`
    wrappers around the node's real locks (NodeDB._lock, the solvepipe
    condition, the journal lock), tagged with the acquiring thread's
    root label;
  - the **observed lock-order graph**: an edge A→B every time B is
    acquired while A is held on the same thread — SIM110 requires this
    graph to stay acyclic at runtime, the dynamic counterpart of
    CONC402;
  - **sampled shared-attribute writes** to a watch list of
    CONC401-flagged attributes, via a class-level `__setattr__` hook
    that records (root, lockset held) per write — SIM110 fails any
    watched attribute written lock-free from concurrently-live roots
    (the injected-race regression in sim/bugs.py must trip exactly
    this).

`crosscheck()` folds a witness report back onto static CONC401
findings: an attribute the witness saw contested from two roots is
**confirmed**; one it never saw touched from more than one root is
**unwitnessed** (the finding stands — absence of a schedule is not
absence of a race — but reviewers triage confirmed ones first).
`annotate_findings()` applies those labels to a findings list for
`conclint --witness-report`.

Instrumentation is bookkeeping-only — counters, tuples, dict bumps —
and never reads wall time or perturbs anything on the solve path, so a
witness-on simnet run must produce byte-identical CIDs to witness-off
(test-pinned). The wrappers add two dict operations per acquire; the
witness is a sim/debug tool, not production default.
"""
from __future__ import annotations

import threading


class WitnessLock:
    """Context-manager/acquire-release wrapper over a real lock that
    reports to the witness. Exposes the inner lock's interface."""

    def __init__(self, witness: "ConcWitness", inner, name: str):
        self._witness = witness
        self._inner = inner
        self.name = name

    def acquire(self, *a, **kw):
        got = self._inner.acquire(*a, **kw)
        if got:
            self._witness._on_acquire(self.name)
        return got

    def release(self):
        self._witness._on_release(self.name)
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._inner.locked()


class WitnessCondition(WitnessLock):
    """Condition wrapper: `wait()` releases the underlying lock, so the
    held-stack drops the name for the duration (a thread parked in
    wait() is NOT holding the cv — recording it held would fabricate
    lock-order edges)."""

    def wait(self, timeout=None):
        self._witness._on_release(self.name)
        try:
            return self._inner.wait(timeout)
        finally:
            self._witness._on_acquire(self.name)

    def wait_for(self, predicate, timeout=None):
        self._witness._on_release(self.name)
        try:
            return self._inner.wait_for(predicate, timeout)
        finally:
            self._witness._on_acquire(self.name)

    def notify(self, n=1):
        self._inner.notify(n)

    def notify_all(self):
        self._inner.notify_all()


class ConcWitness:
    """One run's observation record. Thread-safe; root labels come from
    explicit registration (`register_root`) or thread-name prefixes
    (`solvepipe-encode-3` → `encode`)."""

    PREFIX_ROOTS = (
        ("solvepipe-encode", "encode"),
        ("racy-counter", "racy-counter"),
    )

    def __init__(self, registry=None):
        self._lock = threading.Lock()      # guards the record stores
        self._tls = threading.local()
        self._roots: dict[int, str] = {}
        self.acquires: dict[tuple, int] = {}     # (lock, root) -> n
        self.order_edges: dict[tuple, int] = {}  # (src, dst) -> n
        self.attr_writes: dict[tuple, int] = {}  # (cls, attr, root,
        #                                          locks tuple) -> n
        self._watched: list[tuple] = []          # (cls, original setattr)
        self._registry = registry

    # -- roots ------------------------------------------------------------
    def register_root(self, label: str) -> None:
        with self._lock:
            self._roots[threading.get_ident()] = label

    def current_root(self) -> str:
        ident = threading.get_ident()
        with self._lock:
            label = self._roots.get(ident)
        if label is not None:
            return label
        name = threading.current_thread().name
        for prefix, label in self.PREFIX_ROOTS:
            if name.startswith(prefix):
                return label
        return name

    # -- held-lock tracking ----------------------------------------------
    def _held(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _on_acquire(self, name: str) -> None:
        stack = self._held()
        root = self.current_root()
        with self._lock:
            self.acquires[(name, root)] = \
                self.acquires.get((name, root), 0) + 1
            for outer in stack:
                if outer != name:
                    self.order_edges[(outer, name)] = \
                        self.order_edges.get((outer, name), 0) + 1
        stack.append(name)
        if self._registry is not None:
            self._registry.counter(
                "arbius_conc_witness_lock_acquires_total",
                "Instrumented lock acquisitions observed by the conc "
                "witness, by lock and thread root "
                "(docs/concurrency.md)",
                labelnames=("lock", "root")).inc(lock=name, root=root)

    def _on_release(self, name: str) -> None:
        stack = self._held()
        # remove the most recent matching hold (re-entrant safe)
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == name:
                del stack[i]
                break

    # -- lock wrapping ----------------------------------------------------
    def wrap_lock(self, inner, name: str) -> WitnessLock:
        if isinstance(inner, (WitnessLock, WitnessCondition)):
            return inner
        if hasattr(inner, "wait") and hasattr(inner, "notify_all"):
            return WitnessCondition(self, inner, name)
        return WitnessLock(self, inner, name)

    # -- shared-attribute sampling ----------------------------------------
    def watch_attrs(self, cls: type, attrs) -> None:
        """Install a class-level __setattr__ hook recording every write
        to `attrs` with the writer's root and currently-held witnessed
        locks. `unwatch_all()` restores the original."""
        attrs = frozenset(attrs)
        if not attrs or any(c is cls for c, _ in self._watched):
            return  # idempotent: a crash-restart re-instruments the
            #         same node class; stacking hooks would double-count
        witness = self
        original = cls.__setattr__

        def recording_setattr(obj, name, value):
            if name in attrs:
                root = witness.current_root()
                locks = tuple(sorted(set(witness._held())))
                key = (cls.__name__, name, root, locks)
                with witness._lock:
                    witness.attr_writes[key] = \
                        witness.attr_writes.get(key, 0) + 1
                if witness._registry is not None:
                    witness._registry.counter(
                        "arbius_conc_witness_attr_writes_total",
                        "Watched shared-attribute writes observed by "
                        "the conc witness, by attr/root/locked "
                        "(docs/concurrency.md)",
                        labelnames=("attr", "root", "locked")).inc(
                        attr=f"{cls.__name__}.{name}", root=root,
                        locked="yes" if locks else "no")
            original(obj, name, value)

        cls.__setattr__ = recording_setattr
        self._watched.append((cls, original))

    def unwatch_all(self) -> None:
        while self._watched:
            cls, original = self._watched.pop()
            cls.__setattr__ = original

    # -- reporting ---------------------------------------------------------
    def report(self) -> dict:
        """JSON-able record, deterministically ordered (counts are
        schedule-dependent; the keys are not). One renderer serves both
        this and merge_reports — the schema cannot drift."""
        with self._lock:
            return _render_report(dict(self.acquires),
                                  dict(self.order_edges),
                                  dict(self.attr_writes))


def _render_report(acq: dict, edges: dict, writes: dict) -> dict:
    """THE report shape: (lock, root)→n acquisitions, (src, dst)→n
    order edges, (cls, attr, root, locks)→n sampled writes."""
    return {
        "locks": [{"lock": lk, "root": rt, "acquires": n}
                  for (lk, rt), n in sorted(acq.items())],
        "order_edges": [{"src": a, "dst": b, "count": n}
                        for (a, b), n in sorted(edges.items())],
        "attr_writes": [{"cls": c, "attr": a, "root": r,
                         "locks": list(locks), "count": n}
                        for (c, a, r, locks), n in sorted(writes.items())],
    }


def merge_reports(reports: list) -> dict:
    """Fold several runs' witness reports into one (counts summed,
    keys unioned, deterministic order) — what `python -m arbius_tpu_torch.sim
    --witness-out` writes for `conclint --witness-report` to consume."""
    acq: dict[tuple, int] = {}
    edges: dict[tuple, int] = {}
    writes: dict[tuple, int] = {}
    for rep in reports:
        for e in rep.get("locks", ()):
            k = (e["lock"], e["root"])
            acq[k] = acq.get(k, 0) + e["acquires"]
        for e in rep.get("order_edges", ()):
            k = (e["src"], e["dst"])
            edges[k] = edges.get(k, 0) + e["count"]
        for e in rep.get("attr_writes", ()):
            k = (e["cls"], e["attr"], e["root"], tuple(e["locks"]))
            writes[k] = writes.get(k, 0) + e["count"]
    return _render_report(acq, edges, writes)


def order_cycle(report: dict) -> list | None:
    """A lock cycle in the observed order graph ([l0, l1, ..., l0]),
    or None. Deterministic: neighbors visited sorted."""
    graph: dict[str, list] = {}
    for e in report.get("order_edges", ()):
        graph.setdefault(e["src"], []).append(e["dst"])
        graph.setdefault(e["dst"], [])
    color: dict[str, int] = {}
    parent: dict[str, str] = {}

    for start in sorted(graph):
        if color.get(start):
            continue
        stack = [(start, iter(sorted(graph[start])))]
        color[start] = 1
        while stack:
            node, it = stack[-1]
            advanced = False
            for nxt in it:
                if color.get(nxt) == 1:
                    cycle = [nxt, node]
                    cur = node
                    while cur != nxt:
                        cur = parent[cur]
                        cycle.append(cur)
                    cycle.reverse()
                    return cycle
                if not color.get(nxt):
                    color[nxt] = 1
                    parent[nxt] = node
                    stack.append((nxt, iter(sorted(graph[nxt]))))
                    advanced = True
                    break
            if not advanced:
                color[node] = 2
                stack.pop()
    return None


def contested_attrs(report: dict) -> dict:
    """(cls, attr) -> {"roots": set, "lock_free_roots": set} from the
    witness's write records."""
    out: dict[tuple, dict] = {}
    for rec in report.get("attr_writes", ()):
        key = (rec["cls"], rec["attr"])
        entry = out.setdefault(key, {"roots": set(),
                                     "lock_free_roots": set()})
        entry["roots"].add(rec["root"])
        if not rec["locks"]:
            entry["lock_free_roots"].add(rec["root"])
    return out


def crosscheck(flagged: list, report: dict) -> dict:
    """`flagged` is [(cls name, attr), ...] from static CONC401
    findings; returns each key mapped to 'confirmed' (the witness saw
    ≥2 roots write/contend it, at least one lock-free) or 'unwitnessed'
    (this run's schedule never exhibited the race)."""
    contested = contested_attrs(report)
    out = {}
    for key in flagged:
        entry = contested.get(tuple(key))
        if entry is not None and len(entry["roots"]) >= 2 and \
                entry["lock_free_roots"]:
            out[tuple(key)] = "confirmed"
        else:
            out[tuple(key)] = "unwitnessed"
    return out


_FLAG_RE = None


def flagged_from_findings(findings) -> list:
    """Parse (cls, attr) out of CONC401 finding messages (they open
    with the backticked `Cls.attr`)."""
    global _FLAG_RE
    if _FLAG_RE is None:
        import re

        _FLAG_RE = re.compile(r"^`([A-Za-z_][A-Za-z_0-9]*)\."
                              r"([A-Za-z_][A-Za-z_0-9]*)`")
    out = []
    for f in findings:
        if f.rule != "CONC401":
            continue
        m = _FLAG_RE.match(f.message)
        if m:
            out.append((m.group(1), m.group(2)))
    return out


def annotate_findings(findings, report: dict):
    """Suffix CONC401 findings with the witness verdict — the message
    changes, the (path, rule, snippet) baseline key does not."""
    from dataclasses import replace

    verdicts = crosscheck(flagged_from_findings(findings), report)
    out = []
    for f in findings:
        if f.rule == "CONC401":
            m = _FLAG_RE.match(f.message)
            if m:
                verdict = verdicts.get((m.group(1), m.group(2)))
                if verdict:
                    out.append(replace(
                        f, message=f"{f.message} [witness: {verdict}]"))
                    continue
        out.append(f)
    return out


def instrument_node(node, witness: ConcWitness) -> None:
    """Wrap one MinerNode's shared locks with witness wrappers and
    install watch hooks the node class advertises
    (`WITNESS_WATCH_ATTRS` — sim/bugs.py's injected-race node). Called
    by the sim harness right after construction, before any tick, so
    no thread can be inside a wrapped lock during the swap."""
    witness._registry = node.obs.registry
    node.db._lock = witness.wrap_lock(node.db._lock, "NodeDB._lock")
    node.state_lock = witness.wrap_lock(node.state_lock,
                                        "MinerNode.state_lock")
    node.obs.journal._lock = witness.wrap_lock(
        node.obs.journal._lock, "EventJournal._lock")
    if node._pipeline is not None:
        node._pipeline._cv = witness.wrap_lock(
            node._pipeline._cv, "SolvePipeline._cv")
    watch = getattr(type(node), "WITNESS_WATCH_ATTRS", ())
    if watch:
        witness.watch_attrs(type(node), watch)
