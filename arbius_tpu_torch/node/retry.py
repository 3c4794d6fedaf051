"""Exponential-backoff retry — the node's universal failure wrapper.

Mirror of `miner/src/utils.ts:21-39` expretry: every chain/IPFS/inference
call in the reference is wrapped in it (SURVEY.md §5 failure detection).
Deterministic (no jitter) so tests can assert retry counts; sleep is
injectable for the same reason.

Two obs additions over the reference:
  - `max_delay` caps the per-attempt backoff (the raw `base**attempt`
    curve injects 1.5^9 ≈ 38 s of sleep by attempt 10 at the defaults;
    a live miner would rather poll a flaky endpoint at a bounded cadence
    than stall a solve bucket for half a minute). `None` — the default —
    preserves the reference curve exactly.
  - every failed attempt and every exhaustion is counted into the
    ambient obs registry and journaled (`arbius_retry_attempts_total{op}`
    / `arbius_retry_exhausted_total{op}`, journal kinds `retry` /
    `retry_exhausted`), so `GET /debug/journal` shows which call site is
    burning attempts and how much backoff it injected.

The retry envelope wraps every solve-path chain/pin call, so the
determinism rules below are enforced — a wall-clock read or host RNG
added here (e.g. jitter) would skew every node differently and can
never be pragma'd or baselined away (docs/static-analysis.md).
"""
# detlint: enforce[DET101,DET102,DET105]
from __future__ import annotations

import time
from typing import Callable, TypeVar

from arbius_tpu_torch.obs import current_obs

T = TypeVar("T")


# the reference's backoff base (utils.ts:21-39). Exported because the
# simnet SIM105 checker re-derives the exact expected curve from it —
# tuning the policy here must move the checker with it.
BASE = 1.5


class RetriesExhausted(Exception):
    def __init__(self, attempts: int, last: Exception):
        super().__init__(f"failed after {attempts} attempts: {last!r}")
        self.attempts = attempts
        self.last = last


def expretry(fn: Callable[[], T], *, tries: int = 10, base: float = BASE,
             max_delay: float | None = None,
             sleep: Callable[[float], None] = time.sleep,
             op: str = "") -> T:
    """Run fn, retrying with delays base^attempt (utils.ts default 10/1.5),
    each delay capped at `max_delay` when set. `op` names the call site in
    obs output (metrics labels + journal events)."""
    last: Exception | None = None
    for attempt in range(tries):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — mirror reference: retry all
            last = e
            delay = 0.0
            if attempt + 1 < tries:
                delay = base ** attempt
                if max_delay is not None:
                    delay = min(delay, max_delay)
            obs = current_obs()
            if obs is not None:
                # counters stay live even with tracing disabled (the
                # obs_enabled contract: /metrics keeps counting; only
                # span/journal recording stops — obs.event gates itself)
                label = op or "unnamed"
                obs.registry.counter(
                    "arbius_retry_attempts_total",
                    "Failed attempts inside expretry, by call site",
                    labelnames=("op",)).inc(op=label)
                obs.event("retry", op=label, attempt=attempt + 1,
                          tries=tries, delay=round(delay, 6),
                          error=f"{type(e).__name__}: {e}")
            if attempt + 1 < tries:
                sleep(delay)
    obs = current_obs()
    if obs is not None:
        label = op or "unnamed"
        obs.registry.counter(
            "arbius_retry_exhausted_total",
            "expretry envelopes that ran out of attempts, by call site",
            labelnames=("op",)).inc(op=label)
        obs.event("retry_exhausted", op=label, tries=tries,
                  error=f"{type(last).__name__}: {last}")
    raise RetriesExhausted(tries, last)
