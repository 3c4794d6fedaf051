"""Bounded event journal — the node's flight recorder.

A thread-safe ring buffer (capacity set by `MiningConfig.
obs_journal_capacity`) of small dict events: completed trace spans,
retry attempts, quarantined jobs, chain events. Old events fall off the
back — memory stays bounded on a long-running miner, and the `dropped`
counter says how much history the capacity has cost. `GET /debug/trace`
and `tools/obs_dump.py` read it through `events()`.
"""
from __future__ import annotations

import threading
import time
from collections import deque


class EventJournal:
    def __init__(self, capacity: int = 4096, now_fn=None):
        self.capacity = max(1, int(capacity))
        self._now_fn = now_fn
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=self.capacity)
        self._seq = 0
        self._dropped = 0

    def record(self, kind: str, **fields) -> dict:
        ev = {"kind": kind, "wall": time.time(), **fields}
        if self._now_fn is not None and "chain" not in ev:
            try:
                ev["chain"] = self._now_fn()
            except Exception:  # noqa: BLE001 — a dead chain facade must
                pass           # not take the flight recorder down with it
        with self._lock:
            self._seq += 1
            ev["seq"] = self._seq
            if len(self._events) == self.capacity:
                self._dropped += 1
            self._events.append(ev)
        return ev

    def events(self, *, kind: str | None = None, taskid: str | None = None,
               limit: int | None = None) -> list[dict]:
        """Snapshot, oldest first. `taskid` matches an event's `taskid`
        field or membership in its `taskids` list (batch-level spans)."""
        with self._lock:
            evs = list(self._events)
        if kind is not None:
            evs = [e for e in evs if e.get("kind") == kind]
        if taskid is not None:
            evs = [e for e in evs
                   if e.get("taskid") == taskid
                   or taskid in (e.get("taskids") or ())]
        if limit is not None:
            # explicit: limit<=0 means "no events", not "all of them"
            # (evs[-0:] would slice the whole list)
            evs = evs[-limit:] if limit > 0 else []
        return evs

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
