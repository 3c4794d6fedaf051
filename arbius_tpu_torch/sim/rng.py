"""Seeded, stream-split PRNG for the simulation harness.

Counter-mode SHA-256: every draw is `sha256(prefix || counter)` — pure,
platform-independent, and free of the host RNG the determinism rules ban
(`random`, `os.urandom` are DET102 findings; this module is the one
sanctioned randomness source in the sim). Streams are derived by name
(`rng.stream("pin")`), so adding draws to one fault site never shifts
the sequence another site sees — the FoundationDB trick that keeps a
seed reproducing the same schedule across harness refactors.
"""
# detlint: enforce[DET101,DET102,DET103,DET105]
from __future__ import annotations

import hashlib


class SimRng:
    """Deterministic stream of draws from (seed, stream-name)."""

    def __init__(self, seed: int, stream: str = "root"):
        self.seed = int(seed)
        self.name = stream
        self._prefix = hashlib.sha256(
            f"simnet/{self.seed}/{stream}".encode()).digest()
        self._n = 0

    def stream(self, name: str) -> "SimRng":
        """Derive an independent named sub-stream (same seed)."""
        return SimRng(self.seed, f"{self.name}/{name}")

    def u64(self) -> int:
        digest = hashlib.sha256(
            self._prefix + self._n.to_bytes(8, "big")).digest()
        self._n += 1
        return int.from_bytes(digest[:8], "big")

    def uniform(self) -> float:
        """Uniform float in [0, 1)."""
        return self.u64() / 2**64

    def chance(self, p: float) -> bool:
        """True with probability `p` (p <= 0 never draws: a zero-rate
        fault consumes no counter, so disabling one fault can't shift
        another's schedule)."""
        if p <= 0.0:
            return False
        return self.uniform() < p

    def randint(self, lo: int, hi: int) -> int:
        """Uniform int in [lo, hi] inclusive."""
        if hi < lo:
            raise ValueError(f"randint: empty range [{lo}, {hi}]")
        return lo + self.u64() % (hi - lo + 1)

    def choice(self, seq):
        if not seq:
            raise ValueError("choice: empty sequence")
        return seq[self.u64() % len(seq)]
