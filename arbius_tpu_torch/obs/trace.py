"""Trace spans — per-task lifecycle timing with parent/child nesting.

`Tracer.span(name, **attrs)` is a context manager: on exit it records a
completed-span event into the journal (wall-clock start + duration,
chain-time start/end when the tracer has a chain clock, error status if
an exception passed through) and observes the duration into the
registry's `arbius_span_seconds{name=...}` histogram. Nesting is a
per-thread stack, so a span opened inside another becomes its child —
the solve path produces e.g.

    solve.batch → solve.infer → solve.encode
                → solve.cid
                → solve.task → solve.pin → pin.files
                             → solve.commit → chain.signal_commitment
                             → solve.reveal → chain.submit_solution

`task_trace(events, taskid)` reassembles the journal's flat span events
into trees for one task: spans that carry the taskid (or list it in a
batch-level `taskids` attr), all their descendants, and the ancestor
path up to each root.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager


class Span:
    __slots__ = ("name", "span_id", "parent_id", "attrs")

    def __init__(self, name: str, span_id: int, parent_id: int | None,
                 attrs: dict):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.attrs = attrs  # mutable: callers may annotate mid-span


class Tracer:
    def __init__(self, journal, registry=None, now_fn=None,
                 enabled: bool = True):
        self.journal = journal
        self.registry = registry
        self.now_fn = now_fn
        self.enabled = enabled
        self._tls = threading.local()
        self._id_lock = threading.Lock()
        self._next_id = 0
        if registry is not None:
            self._h_span = registry.histogram(
                "arbius_span_seconds",
                "Wall-clock seconds per completed trace span",
                labelnames=("name",))
            self._c_err = registry.counter(
                "arbius_span_errors_total",
                "Trace spans that exited with an exception",
                labelnames=("name",))

    def _new_id(self) -> int:
        with self._id_lock:
            self._next_id += 1
            return self._next_id

    def _stack(self) -> list:
        s = getattr(self._tls, "stack", None)
        if s is None:
            s = self._tls.stack = []
        return s

    @contextmanager
    def span(self, name: str, **attrs):
        if not self.enabled:
            yield None
            return
        stack = self._stack()
        parent = stack[-1] if stack else None
        sp = Span(name, self._new_id(),
                  parent.span_id if parent else None, attrs)
        wall_start = time.time()
        p0 = time.perf_counter()
        chain_start = None
        if self.now_fn is not None:
            try:
                chain_start = self.now_fn()
            except Exception:  # noqa: BLE001 — tracing never breaks work
                pass
        stack.append(sp)
        error = None
        try:
            yield sp
        except BaseException as e:
            error = f"{type(e).__name__}: {e}"
            raise
        finally:
            stack.pop()
            dur = time.perf_counter() - p0
            self._finish(sp, wall_start, dur, chain_start, error)

    def _finish(self, sp: Span, wall_start: float, dur: float,
                chain_start, error) -> None:
        a = dict(sp.attrs)
        ev = {
            "name": sp.name,
            "span_id": sp.span_id,
            "parent_id": sp.parent_id,
            "wall_start": wall_start,
            "wall_s": round(dur, 6),
            "status": "error" if error else "ok",
        }
        if chain_start is not None:
            ev["chain_start"] = chain_start
            if self.now_fn is not None:
                try:
                    ev["chain_end"] = self.now_fn()
                except Exception:  # noqa: BLE001
                    pass
        if error:
            ev["error"] = error
        # taskid/taskids are hoisted so the journal can filter on them
        tid = a.pop("taskid", None)
        if tid is not None:
            ev["taskid"] = tid
        tids = a.pop("taskids", None)
        if tids:
            ev["taskids"] = list(tids)
        if a:
            ev["attrs"] = a
        self.journal.record("span", **ev)
        if self.registry is not None:
            self._h_span.observe(dur, name=sp.name)
            if error:
                self._c_err.inc(name=sp.name)


def task_trace(events: list[dict], taskid: str) -> list[dict]:
    """Span trees for one task from flat journal events.

    Includes every span that names the taskid (directly or via a
    batch-level `taskids` list), all descendants of those spans, and the
    ancestor path to each root — so a `solve.infer` span that only knows
    its bucket still appears under the `job.solve_batch` that knows the
    task. Roots (and children) sort by wall start time.
    """
    spans = [e for e in events if e.get("kind") == "span"
             and "span_id" in e]
    by_id = {e["span_id"]: e for e in spans}

    def matches(e: dict) -> bool:
        return (e.get("taskid") == taskid
                or taskid in (e.get("taskids") or ()))

    include: set[int] = set()
    for e in spans:
        path: list[int] = []
        cur = e
        while cur is not None and cur["span_id"] not in path:
            path.append(cur["span_id"])
            if cur["span_id"] in include or matches(cur):
                include.update(path)
                break
            cur = by_id.get(cur.get("parent_id"))
    # ancestor paths of everything included (context for the tree roots)
    for sid in list(include):
        cur = by_id.get(by_id[sid].get("parent_id"))
        while cur is not None and cur["span_id"] not in include:
            include.add(cur["span_id"])
            cur = by_id.get(cur.get("parent_id"))

    nodes = {sid: dict(by_id[sid], children=[]) for sid in include}
    roots = []
    for sid in sorted(nodes):
        n = nodes[sid]
        parent = nodes.get(n.get("parent_id"))
        if parent is not None:
            parent["children"].append(n)
        else:
            roots.append(n)
    key = lambda n: (n.get("wall_start", 0.0), n["span_id"])  # noqa: E731
    for n in nodes.values():
        n["children"].sort(key=key)
    roots.sort(key=key)
    return roots
