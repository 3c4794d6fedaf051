"""Virtual clock — the sim's single time authority.

All time in a scenario is the engine's chain time: the node already
reads `chain.now` for job due-ness, and its retry sleeps are injectable
(`MinerNode._retry_sleep`), so pointing both at this clock removes the
wall clock entirely. Injected RPC latency, pinner stalls, slow solves,
and expretry backoff all `advance()` the same engine — a scenario's
entire timeline is a pure function of the seed.

`sleep()` (the `expretry` hook) records each requested delay so tests
can assert the exact backoff curve a retry envelope injected
(tests/test_sim_retry.py — the reference's `base**attempt` sequence and
the `max_delay` cap).
"""
# detlint: enforce[DET101,DET102,DET103,DET105]
from __future__ import annotations


class VirtualClock:
    def __init__(self, engine):
        self.engine = engine
        self.slept = 0.0          # total seconds requested via sleep()
        self.advanced = 0         # total whole seconds applied to engine
        self.sleeps: list[float] = []   # each sleep() request, in order

    @property
    def now(self) -> int:
        return self.engine.now

    def advance(self, seconds: float) -> int:
        """Advance chain time by ceil(seconds) without mining a block
        (blocks advance via txs — devnet automine). Returns the applied
        whole-second amount."""
        whole = int(seconds)
        if whole < seconds:
            whole += 1
        if whole > 0:
            self.engine.advance_time(whole, blocks=0)
            self.advanced += whole
        return whole

    def sleep(self, seconds: float) -> None:
        """Drop-in for `time.sleep` in retry envelopes: records the
        request and advances chain time instead of blocking."""
        self.sleeps.append(round(float(seconds), 6))
        self.slept += seconds
        self.advance(seconds)
