"""costsched cost model — learned chip-seconds per (model, bucket, layout).

The profitability gate and the continuous packer (node/sched.py) both
need one number: how many chip-seconds one task of a given shape costs
on THIS node. Before this module that number was a static config knob
(`assumed_solve_seconds`) refined only by a global p50 over every
family at once — a mispriced family was invisible inside the mixture.

`CostModel` learns it from the node's own telemetry, the approach of
"A Learned Performance Model for Tensor Processing Units" (PAPERS.md)
applied at serving granularity: the features that dominate chip cost
are exactly the bucket key (shape, steps, scheduler, frames) plus the
mesh layout, so the model is a per-(model, bucket, layout) table fitted
from the `arbius_stage_seconds{stage="infer"}` histogram — each bucket
dispatch is observed there tagged with its cost key and real task
count, and `ingest()` turns those tagged samples into per-task seconds.

Fit policy (docs/scheduler.md):

  * deterministic seeded fit: per key, the bounded recent-sample window
    is (when oversized) subsampled by a counter-hash stream seeded with
    `FIT_SEED`, sorted, and reduced to its median — the same snapshot
    always fits to the same bytes (golden-pinned by tests and the
    `tools/costmodel.py --fit` fixture). A median, not a mean: one
    straggler dispatch (GC pause, pool hiccup) must not reprice a
    family.
  * persistence: fitted rows live in the sqlite `cost_model` table
    (NodeDB), written inside the tick's batch window, so a restarted
    node prices tasks from its previous life immediately.
  * graceful degradation: `predict()` answers None until a row has
    accrued `min_samples` — the gate then falls back to the exact
    static-config behavior (global infer p50, else
    `assumed_solve_seconds`), so an empty table reproduces the pre-
    costsched node bit-for-bit (test-pinned).
"""
from __future__ import annotations

import hashlib
from collections import deque
from dataclasses import dataclass

# seed of the deterministic subsample stream the fit draws when a key's
# sample window exceeds FIT_CAP — fixed, so a fit is a pure function of
# the sample snapshot (docs/scheduler.md)
FIT_SEED = 0xC057
SAMPLE_WINDOW = 128   # per-key recent-sample bound (matches the obs
                      # histograms' bounded-window philosophy)
FIT_CAP = 64          # samples the median is taken over, post-subsample


def bucket_str(key: tuple) -> str:
    """Canonical bucket-shape string for a node bucket key
    `(model, width, height, steps, scheduler, num_frames[, mode])` —
    the shape part only (model, layout, and precision mode ride
    separately in the cost tag). Text-family 9-tuples
    (docs/text-serving.md) append their sequence edges as
    `.p<prompt>.t<decode>`; legacy keys render the historic string
    byte for byte."""
    w, h, steps, sched, frames = key[1:6]

    def s(v):
        return "-" if v is None else str(v)

    base = f"{s(w)}x{s(h)}.s{s(steps)}.{s(sched)}.f{s(frames)}"
    if len(key) > 7:
        base += f".p{s(key[7])}.t{s(key[8])}"
    return base


def make_cost_tag(model: str, bucket: str, layout: str, n: int,
                  mode: str = "bf16") -> str:
    """Tag attached to each `arbius_stage_seconds{infer}` observation:
    everything `ingest()` needs to turn the bucket's wall seconds into
    per-task seconds under the right key — including the precision
    mode (docs/quantization.md): an int8 bucket and its bf16 twin are
    different programs with different chip-seconds, and their samples
    must never blend into one row. '|'-separated; none of the fields
    can contain '|' (model ids are hex, bucket/layout/mode are
    dot-joined alphanumerics)."""
    return f"{model}|{bucket}|{layout}|{mode}|n{n}"


def parse_cost_tag(tag) -> tuple[str, str, str, str, int] | None:
    """Inverse of make_cost_tag → (model, bucket, layout, mode, n);
    None for untagged/foreign samples. Pre-quant 4-field tags (no mode
    — old snapshots, mixed-version fleets) parse as bf16: that is the
    program they metered."""
    from arbius_tpu_torch.quant.modes import PRECISION_MODES

    if not isinstance(tag, str):
        return None
    parts = tag.split("|")
    if len(parts) == 4:
        parts = parts[:3] + ["bf16", parts[3]]
    if len(parts) != 5 or not parts[4].startswith("n"):
        return None
    if parts[3] not in PRECISION_MODES:
        # foreign 5-field tag — never let an arbitrary string become a
        # persisted cost-row mode key
        return None
    try:
        n = int(parts[4][1:])
    except ValueError:
        return None
    if n <= 0:
        return None
    return parts[0], parts[1], parts[2], parts[3], n


def seeded_fit(values: list[float], key: tuple) -> float:
    """The deterministic seeded fit: subsample to FIT_CAP by the
    counter-hash stream, then the median (lower-middle averaged with
    upper-middle for even counts). Pure in (values, key)."""
    vals = list(values)
    if len(vals) > FIT_CAP:
        # score every index with a seeded hash; keep the FIT_CAP
        # smallest scores — a deterministic "random" subsample
        def score(j: int) -> bytes:
            return hashlib.sha256(
                f"{FIT_SEED}|{'|'.join(str(k) for k in key)}|{j}"
                .encode()).digest()

        keep = sorted(range(len(vals)), key=score)[:FIT_CAP]
        vals = [vals[j] for j in sorted(keep)]
    vals.sort()
    mid = len(vals) // 2
    if len(vals) % 2:
        return float(vals[mid])
    return float((vals[mid - 1] + vals[mid]) / 2.0)


@dataclass(frozen=True)
class CostRow:
    """One fitted table entry: predicted chip-seconds per task for a
    (model, bucket, layout, mode) quadruple, and how many samples back
    it. `mode` is the precision mode (docs/quantization.md): rows for
    the same shape at different modes NEVER merge — they price
    different XLA programs."""
    model: str
    bucket: str
    layout: str
    chip_seconds: float
    samples: int
    updated: int           # chain time of the last persist
    mode: str = "bf16"

    def to_json(self) -> dict:
        return {"model": self.model, "bucket": self.bucket,
                "layout": self.layout, "mode": self.mode,
                "chip_seconds": round(self.chip_seconds, 6),
                "samples": self.samples, "updated": self.updated}


class CostModel:
    """The learned per-(model, bucket, layout) chip-seconds table.

    Feed it with `ingest(histogram)` (reads new tagged stage=infer
    samples) or `ingest_samples([(tag, seconds), ...])` (the CLI's
    snapshot path), then `refit(now)`; `predict()` answers per-task
    seconds once a key has accrued `min_samples`, else None (static
    fallback — the caller's job, so the fallback stays byte-identical
    to the pre-costsched gate)."""

    def __init__(self, min_samples: int = 8):
        self.min_samples = int(min_samples)
        self.rows: dict[tuple, CostRow] = {}
        self._samples: dict[tuple, deque] = {}
        self._counts: dict[tuple, int] = {}    # observed this life
        self._prior: dict[tuple, tuple] = {}   # key -> (chip_s, samples)
        self._ingested = 0                     # histogram count consumed

    # -- feeding ---------------------------------------------------------
    def observe(self, model: str, bucket: str, layout: str,
                seconds_per_task: float, mode: str = "bf16") -> None:
        key = (model, bucket, layout, mode)
        dq = self._samples.get(key)
        if dq is None:
            dq = self._samples[key] = deque(maxlen=SAMPLE_WINDOW)
        dq.append(float(seconds_per_task))
        self._counts[key] = self._counts.get(key, 0) + 1

    def ingest_samples(self, samples: list) -> int:
        """Consume (tag, bucket_wall_seconds) pairs — the stage=infer
        histogram's recent-window format. Returns how many parsed."""
        n = 0
        for tag, value in samples:
            parsed = parse_cost_tag(tag)
            if parsed is None:
                continue
            model, bucket, layout, mode, tasks = parsed
            self.observe(model, bucket, layout, float(value) / tasks,
                         mode=mode)
            n += 1
        return n

    def ingest(self, hist) -> int:
        """Pull the stage=infer samples recorded since the last ingest
        out of the obs histogram (the single source both solve
        schedules feed — docs/pipeline.md)."""
        total = hist.count(stage="infer")
        new = total - self._ingested
        if new <= 0:
            return 0
        self._ingested = total
        recent = hist.recent(stage="infer")
        # the recent window is bounded; if more landed than it holds,
        # the evicted ones are simply lost to the fit (same contract as
        # every other recent-window consumer)
        return self.ingest_samples(recent[-new:] if new < len(recent)
                                   else recent)

    # -- fitting ---------------------------------------------------------
    def refit(self, now: int = 0) -> None:
        """Deterministic refit of every key with fresh samples: the
        seeded-median estimate of this life's window, blended with the
        persisted prior by (window-capped) sample weight so a restart
        neither forgets the previous life nor lets a stale prior
        outvote fresh evidence forever."""
        for key in sorted(self._samples):
            count = self._counts.get(key, 0)
            if count <= 0:
                continue
            est = seeded_fit(list(self._samples[key]), key)
            prior = self._prior.get(key)
            samples = count
            if prior is not None:
                p_est, p_n = prior
                w_new = min(count, SAMPLE_WINDOW)
                w_old = min(p_n, SAMPLE_WINDOW)
                est = (p_est * w_old + est * w_new) / (w_old + w_new)
                samples = p_n + count
            self.rows[key] = CostRow(
                model=key[0], bucket=key[1], layout=key[2], mode=key[3],
                chip_seconds=est, samples=samples, updated=int(now))

    # -- queries ---------------------------------------------------------
    def predict(self, model: str, bucket: str, layout: str,
                mode: str = "bf16") -> float | None:
        """Per-task chip-seconds, or None until `min_samples` accrued
        (caller falls back to the static config path). Keyed per
        precision mode: an int8 row never answers for bf16."""
        row = self.rows.get((model, bucket, layout, mode))
        if row is None or row.samples < self.min_samples:
            return None
        return row.chip_seconds

    def sorted_rows(self) -> list[CostRow]:
        return [self.rows[k] for k in sorted(self.rows)]

    def snapshot(self) -> dict:
        """JSON-able view for GET /debug/costmodel and the CLI."""
        return {"min_samples": self.min_samples,
                "rows": [r.to_json() for r in self.sorted_rows()]}

    # -- persistence (sqlite cost_model table, NodeDB) -------------------
    def load(self, db) -> int:
        """Adopt the previous life's fitted rows: they predict
        immediately, and refits blend them with fresh evidence."""
        n = 0
        for model, bucket, layout, mode, chip_s, samples, updated in \
                db.load_cost_rows():
            key = (model, bucket, layout, mode)
            self.rows[key] = CostRow(model=model, bucket=bucket,
                                     layout=layout, mode=mode,
                                     chip_seconds=chip_s,
                                     samples=samples, updated=updated)
            self._prior[key] = (chip_s, samples)
            n += 1
        return n

    def persist(self, db, now: int) -> None:
        rows = self.sorted_rows()
        if rows:
            db.upsert_cost_rows(
                [(r.model, r.bucket, r.layout, r.mode, r.chip_seconds,
                  r.samples, int(now)) for r in rows])
