"""Sliding-window metrics core: trailing rates and windowed quantiles.

The cumulative families in :mod:`obs.metrics` answer "how much since
boot" — useless for *is this server degrading right now*: a week-old p99
barely moves when the last minute goes bad.  This module adds the
time-aware half the SLO/fleet layer consumes:

- :class:`WindowedCounter` — an epoch-ring counter: events land in the
  bucket for their ~1s epoch, and ``rate(window_s)`` sums the trailing
  buckets.  Old epochs are overwritten lazily on the next write/read, so
  there is no aggregator thread and an idle counter costs nothing.
- :class:`WindowedHistogram` — the same epoch ring over a FIXED bucket
  layout (log-spaced bounds).  Windowed p50/p99 come from merging the
  trailing epochs' bucket counts and interpolating inside the containing
  bucket — no 8k-sample sort per scrape, and counts are mergeable across
  hosts (the fleet beacons ship raw bucket counts).  A cumulative
  counts array rides alongside for Prometheus ``_bucket{le=...}``
  exposition, whose counters must be monotone across scrapes.
- :class:`WindowedHistogramFamily` — labelled histograms (per-phase
  windowed twins of ``ServeMetrics.phase``).

Every read/write accepts an optional ``now`` (seconds, same clock as the
constructor's ``clock``) so tests drive synthetic traces deterministically;
production call sites omit it and get ``time.monotonic()``.

Accuracy contract: a window of ``W`` seconds at resolution ``R`` actually
covers between ``W - R`` and ``W`` seconds of events (the current epoch is
partial), so rates read up to ``R/W`` low; quantiles are exact to the
containing bucket and interpolated within it.  Thresholds that matter
(an SLO latency bound) should be passed as an explicit bucket bound —
:func:`bounds_with` — which makes attainment at that threshold exact.
"""

from __future__ import annotations

import bisect
import math
import threading
import time
from collections.abc import Sequence

# Default latency bucket bounds (seconds): log-spaced 0.5ms .. 60s, the
# serving range.  Values above the last bound land in the +Inf overflow
# bucket.  ~2x growth keeps windowed-quantile error under ~35% of the
# value, and 21 buckets * 301 epochs is ~50KB per histogram.
DEFAULT_LATENCY_BOUNDS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

# Step-time bounds for the train-side timeline (seconds): training steps
# run 1ms (smoke models) to minutes (full pods).
DEFAULT_STEP_BOUNDS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
)

DEFAULT_WINDOWS_S = (10.0, 60.0, 300.0)


def bounds_with(threshold: float, base: tuple = DEFAULT_LATENCY_BOUNDS) -> tuple:
    """``base`` bounds with ``threshold`` inserted (sorted, deduplicated).

    Building a histogram with its SLO threshold as an explicit bucket
    boundary makes ``attainment(threshold)`` exact instead of
    interpolated — the serve_bench ``--quick`` SLO-math gate relies on it.
    """
    if threshold <= 0:
        return tuple(base)
    return tuple(sorted(set(base) | {float(threshold)}))


class WindowedCounter:
    """Thread-safe trailing-rate counter over an epoch ring.

    ``max_window_s / resolution_s`` buckets plus one for the current
    partial epoch; ``add`` is O(1) amortized (lazy zeroing of skipped
    epochs), ``sum``/``rate`` are O(window / resolution).
    """

    def __init__(
        self,
        max_window_s: float = 300.0,
        resolution_s: float = 1.0,
        clock=time.monotonic,
    ):
        self._lock = threading.Lock()
        self._res = float(resolution_s)
        self._n = int(math.ceil(max_window_s / resolution_s)) + 1
        self._buckets = [0.0] * self._n
        self._epoch: int | None = None  # absolute epoch of the newest bucket
        self._clock = clock
        self.total = 0.0

    def _advance(self, now: float) -> int:
        """Move the ring to ``now``'s epoch, zeroing skipped buckets.
        Caller holds the lock."""
        e = int(now / self._res)
        if self._epoch is None:
            self._epoch = e
        elif e > self._epoch:
            if e - self._epoch >= self._n:
                for i in range(self._n):
                    self._buckets[i] = 0.0
            else:
                for k in range(self._epoch + 1, e + 1):
                    self._buckets[k % self._n] = 0.0
            self._epoch = e
        return self._epoch

    def add(self, n: float = 1.0, now: float | None = None) -> None:
        now = self._clock() if now is None else now
        with self._lock:
            e = self._advance(now)
            self._buckets[e % self._n] += n
            self.total += n

    def sum(self, window_s: float, now: float | None = None) -> float:
        """Events in the trailing ``window_s`` (including the current
        partial epoch)."""
        now = self._clock() if now is None else now
        k = max(1, min(int(round(window_s / self._res)), self._n - 1))
        with self._lock:
            if self._epoch is None:
                return 0.0
            e = self._advance(now)
            return sum(self._buckets[(e - i) % self._n] for i in range(k))

    def rate(self, window_s: float, now: float | None = None) -> float:
        """Events/second over the trailing window."""
        return self.sum(window_s, now) / window_s if window_s > 0 else 0.0

    def reset(self) -> None:
        with self._lock:
            for i in range(self._n):
                self._buckets[i] = 0.0
            self._epoch = None
            self.total = 0.0


def merge_counts(*counts: list[int] | tuple[int, ...]) -> list[int]:
    """Elementwise sum of bucket-count arrays (same bounds assumed) — the
    cross-host merge the fleet beacons use."""
    if not counts:
        return []
    out = [0] * len(counts[0])
    for c in counts:
        if len(c) != len(out):
            raise ValueError(
                f"cannot merge counts of lengths {len(out)} and {len(c)}: "
                "bucket bounds differ"
            )
        for i, v in enumerate(c):
            out[i] += v
    return out


def quantile_from_counts(
    bounds: tuple, counts: list[int], p: float
) -> float:
    """p in [0,100] from bucket counts (len(bounds)+1, last = overflow),
    linearly interpolated inside the containing bucket.  Overflow-bucket
    quantiles clamp to the last finite bound."""
    total = sum(counts)
    if total == 0:
        return 0.0
    rank = p / 100.0 * total
    acc = 0.0
    for i, c in enumerate(counts):
        if c and acc + c >= rank:
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = bounds[i] if i < len(bounds) else bounds[-1]
            if hi <= lo:
                return hi
            return lo + (rank - acc) / c * (hi - lo)
        acc += c
    return bounds[-1]


def attainment_from_counts(
    bounds: tuple, counts: list[int], threshold: float
) -> float:
    """Fraction of samples <= threshold (1.0 when empty).  Exact when the
    threshold is a bucket bound; interpolated within the containing bucket
    otherwise (overflow-bucket mass counts as above any finite threshold)."""
    total = sum(counts)
    if total == 0:
        return 1.0
    acc = 0.0
    for i, c in enumerate(counts):
        lo = bounds[i - 1] if i > 0 else 0.0
        hi = bounds[i] if i < len(bounds) else float("inf")
        if threshold >= hi:
            acc += c
        elif threshold > lo and math.isfinite(hi):
            acc += c * (threshold - lo) / (hi - lo)
    return acc / total


class WindowedHistogram:
    """Thread-safe bucketed histogram over an epoch ring.

    Bucket ``i`` counts samples in ``(bounds[i-1], bounds[i]]`` (bucket 0:
    ``<= bounds[0]``; the last bucket is the ``> bounds[-1]`` overflow), so
    cumulative-bucket exposition matches the Prometheus ``le`` convention.
    Cumulative (since boot/reset) counts, sum, count, and max are kept
    alongside the windowed ring.
    """

    def __init__(
        self,
        bounds: tuple = DEFAULT_LATENCY_BOUNDS,
        max_window_s: float = 300.0,
        resolution_s: float = 1.0,
        clock=time.monotonic,
    ):
        if list(bounds) != sorted(set(bounds)):
            raise ValueError("bounds must be strictly increasing")
        self._lock = threading.Lock()
        self.bounds = tuple(float(b) for b in bounds)
        self._nb = len(self.bounds) + 1  # + overflow
        self._res = float(resolution_s)
        self._n = int(math.ceil(max_window_s / resolution_s)) + 1
        self._ring = [[0] * self._nb for _ in range(self._n)]
        self._ring_sum = [0.0] * self._n
        self._epoch: int | None = None
        self._clock = clock
        self._cum = [0] * self._nb
        self.count = 0
        self.sum = 0.0
        self.max = 0.0

    def _advance(self, now: float) -> int:
        e = int(now / self._res)
        if self._epoch is None:
            self._epoch = e
        elif e > self._epoch:
            if e - self._epoch >= self._n:
                todo = range(self._n)
            else:
                todo = (k % self._n for k in range(self._epoch + 1, e + 1))
            for i in todo:
                row = self._ring[i]
                for j in range(self._nb):
                    row[j] = 0
                self._ring_sum[i] = 0.0
            self._epoch = e
        return self._epoch

    def observe(self, v: float, now: float | None = None) -> None:
        v = float(v)
        now = self._clock() if now is None else now
        i = bisect.bisect_left(self.bounds, v)  # v == bound -> that bucket
        with self._lock:
            e = self._advance(now)
            self._ring[e % self._n][i] += 1
            self._ring_sum[e % self._n] += v
            self._cum[i] += 1
            self.count += 1
            self.sum += v
            if v > self.max:
                self.max = v

    def observe_many(
        self, values: Sequence[float], now: float | None = None
    ) -> None:
        """Bulk ``observe`` under ONE lock acquisition — the batcher's
        delivery path records a whole batch's latencies/phases at once, so
        per-sample locking would multiply hot-path lock traffic (and the
        race sanitizer's per-acquisition cost) by the batch size."""
        if not values:
            return
        now = self._clock() if now is None else now
        with self._lock:
            e = self._advance(now)
            row = self._ring[e % self._n]
            for v in values:
                v = float(v)
                i = bisect.bisect_left(self.bounds, v)
                row[i] += 1
                self._ring_sum[e % self._n] += v
                self._cum[i] += 1
                self.count += 1
                self.sum += v
                if v > self.max:
                    self.max = v

    def _window_rows(self, window_s: float, e: int) -> range:
        k = max(1, min(int(round(window_s / self._res)), self._n - 1))
        return range(k)

    def window_counts(
        self, window_s: float | None = None, now: float | None = None
    ) -> list[int]:
        """Merged bucket counts over the trailing window (``None`` =
        cumulative since boot/reset)."""
        if window_s is None:
            with self._lock:
                return list(self._cum)
        now = self._clock() if now is None else now
        with self._lock:
            if self._epoch is None:
                return [0] * self._nb
            e = self._advance(now)
            out = [0] * self._nb
            for i in self._window_rows(window_s, e):
                row = self._ring[(e - i) % self._n]
                for j in range(self._nb):
                    out[j] += row[j]
            return out

    def window_count(
        self, window_s: float | None = None, now: float | None = None
    ) -> int:
        return sum(self.window_counts(window_s, now))

    def quantile(
        self, p: float, window_s: float | None = None,
        now: float | None = None,
    ) -> float:
        return quantile_from_counts(
            self.bounds, self.window_counts(window_s, now), p
        )

    def attainment(
        self, threshold: float, window_s: float | None = None,
        now: float | None = None,
    ) -> float:
        """Fraction of samples <= threshold in the window (1.0 if empty)."""
        return attainment_from_counts(
            self.bounds, self.window_counts(window_s, now), threshold
        )

    def cumulative(self) -> dict:
        """One consistent snapshot of the since-boot families — the
        Prometheus histogram exposition source (monotone across scrapes)."""
        with self._lock:
            return {
                "bounds": self.bounds,
                "counts": list(self._cum),
                "sum": self.sum,
                "count": self.count,
                "max": self.max,
            }

    def window_summary(
        self, window_s: float, now: float | None = None
    ) -> dict:
        counts = self.window_counts(window_s, now)
        n = sum(counts)
        return {
            "count": n,
            "rate": n / window_s if window_s > 0 else 0.0,
            "p50": quantile_from_counts(self.bounds, counts, 50),
            "p90": quantile_from_counts(self.bounds, counts, 90),
            "p99": quantile_from_counts(self.bounds, counts, 99),
        }

    def reset(self) -> None:
        with self._lock:
            for i in range(self._n):
                row = self._ring[i]
                for j in range(self._nb):
                    row[j] = 0
                self._ring_sum[i] = 0.0
            self._epoch = None
            self._cum = [0] * self._nb
            self.count = 0
            self.sum = 0.0
            self.max = 0.0


class WindowedHistogramFamily:
    """Thread-safe labelled family of :class:`WindowedHistogram` (the
    windowed twin of ``LabelledHistogram`` — per-phase serving series)."""

    def __init__(
        self,
        bounds: tuple = DEFAULT_LATENCY_BOUNDS,
        max_window_s: float = 300.0,
        resolution_s: float = 1.0,
        clock=time.monotonic,
    ):
        self._lock = threading.Lock()
        self._args = (bounds, max_window_s, resolution_s, clock)
        self._hists: dict = {}

    def observe(self, label, v: float, now: float | None = None) -> None:
        self._series(label).observe(v, now)

    def observe_many(
        self, label, values: Sequence[float], now: float | None = None
    ) -> None:
        """Bulk per-label observe (one series lock for the whole batch)."""
        self._series(label).observe_many(values, now)

    def _series(self, label) -> WindowedHistogram:
        with self._lock:
            h = self._hists.get(label)
            if h is None:
                h = self._hists[label] = WindowedHistogram(*self._args)
        return h

    def labels(self) -> list:
        with self._lock:
            return sorted(self._hists)

    def get(self, label) -> WindowedHistogram | None:
        with self._lock:
            return self._hists.get(label)

    def snapshot(
        self, window_s: float, now: float | None = None
    ) -> dict:
        with self._lock:
            hists = dict(self._hists)
        return {
            str(k): h.window_summary(window_s, now)
            for k, h in sorted(hists.items())
        }

    def reset(self) -> None:
        with self._lock:
            self._hists.clear()
