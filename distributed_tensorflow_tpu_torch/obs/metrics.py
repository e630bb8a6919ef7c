"""Metric writers and serving instruments.

Training side: TensorBoard scalars and append-only JSONL. Only rank 0
writes; other ranks get no-op hooks, so call sites stay branch-free.

Feed side: :class:`FeedMetrics`, the training loop's host-wait and the
prefetch stage's assembly instruments.

Serving side (serve/): thread-safe :class:`Counter` / :class:`Gauge` /
:class:`Histogram` primitives and the :class:`ServeMetrics` bundle — the
per-request latency histogram (p50/p99), queue-depth and batch-occupancy
gauges the inference engine exposes at ``GET /metrics``.
"""

from __future__ import annotations

import json
import threading
import time
from collections.abc import Sequence
from pathlib import Path

from distributed_tensorflow_tpu_torch.obs.timeseries import (
    DEFAULT_LATENCY_BOUNDS,
    DEFAULT_WINDOWS_S,
    WindowedCounter,
    WindowedHistogram,
    WindowedHistogramFamily,
)


class JsonlWriter:
    """One JSON object per log event: ``{"step": n, "wall": t, ...metrics}``."""

    def __init__(self, path: str | Path):
        self._path = Path(path)
        self._path.parent.mkdir(parents=True, exist_ok=True)
        self._f = self._path.open("a")

    def write(self, step: int, metrics: dict) -> None:
        rec = {"step": step, "wall": time.time(), **metrics}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class TensorBoardWriter:
    """Scalar writer over ``torch.utils.tensorboard``."""

    def __init__(self, logdir: str | Path):
        from torch.utils.tensorboard import SummaryWriter

        self._sw = SummaryWriter(str(logdir))

    def write(self, step: int, metrics: dict) -> None:
        for k, v in metrics.items():
            self._sw.add_scalar(k, v, step)
        self._sw.flush()

    def close(self) -> None:
        self._sw.close()


class Counter:
    """Thread-safe monotonically-increasing counter."""

    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._n += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._n


class Gauge:
    """Thread-safe last-value gauge (queue depth, in-flight batch size)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._v = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._v = float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._v


class Histogram:
    """Thread-safe value histogram with percentile summaries.

    Keeps exact count/sum/max over the full stream plus a bounded ring of
    recent samples for the percentile estimates — serving runs are
    unbounded, so the sample buffer must not grow with traffic.
    """

    def __init__(self, max_samples: int = 8192):
        self._lock = threading.Lock()
        self._buf: list[float] = []
        self._max_samples = max_samples
        self._i = 0
        self.count = 0
        self.total = 0.0
        self.max = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            self.max = max(self.max, v)
            if len(self._buf) < self._max_samples:
                self._buf.append(v)
            else:
                self._buf[self._i] = v
                self._i = (self._i + 1) % self._max_samples

    def reset(self) -> None:
        """Zero the stream (per-measurement-window use, e.g. serve_bench)."""
        with self._lock:
            self._buf.clear()
            self._i = 0
            self.count = 0
            self.total = 0.0
            self.max = 0.0

    @staticmethod
    def _pct(s: list[float], p: float) -> float:
        """p in [0, 100] over an already-sorted sample list."""
        if not s:
            return 0.0
        k = min(len(s) - 1, max(0, int(round(p / 100.0 * (len(s) - 1)))))
        return s[k]

    def percentile(self, p: float) -> float:
        """p in [0, 100] over the retained sample window (0.0 when empty)."""
        with self._lock:
            s = sorted(self._buf)
        return self._pct(s, p)

    def summary(self) -> dict:
        # ONE lock acquisition and ONE sort: count/percentiles come from
        # the same instant, so a /metrics scrape never mixes a newer count
        # with older percentiles (and doesn't sort the buffer three times).
        with self._lock:
            count, total, mx = self.count, self.total, self.max
            s = sorted(self._buf)
        return {
            "count": count,
            "mean": total / count if count else 0.0,
            "p50": self._pct(s, 50),
            "p90": self._pct(s, 90),
            "p99": self._pct(s, 99),
            "max": mx,
        }


class LabelledGauge:
    """Thread-safe gauge family keyed by label (per-dtype KV bytes per
    token). Labels are created on first ``set``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._vals: dict = {}

    def set(self, label, v: float) -> None:
        with self._lock:
            self._vals[label] = float(v)

    def snapshot(self) -> dict:
        with self._lock:
            return {str(k): v for k, v in sorted(self._vals.items())}

    def reset(self) -> None:
        with self._lock:
            self._vals.clear()


class LabelledCounter:
    """Thread-safe counter family keyed by label (per-tier / per-bucket
    hit counts). Labels are created on first ``inc``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._vals: dict = {}

    def inc(self, label, n: int = 1) -> None:
        with self._lock:
            self._vals[label] = self._vals.get(label, 0) + n

    def snapshot(self) -> dict:
        with self._lock:
            return {str(k): v for k, v in sorted(self._vals.items())}

    def reset(self) -> None:
        with self._lock:
            self._vals.clear()


class LabelledHistogram:
    """Thread-safe histogram family keyed by label (per-tier occupancy)."""

    def __init__(self, max_samples: int = 2048):
        self._lock = threading.Lock()
        self._max_samples = max_samples
        self._hists: dict = {}

    def observe(self, label, v: float) -> None:
        with self._lock:
            h = self._hists.get(label)
            if h is None:
                h = self._hists[label] = Histogram(self._max_samples)
        h.observe(v)

    def snapshot(self) -> dict:
        with self._lock:
            hists = dict(self._hists)
        return {str(k): h.summary() for k, h in sorted(hists.items())}

    def reset(self) -> None:
        with self._lock:
            self._hists.clear()


class FeedMetrics:
    """Feed-path observability bundle (``data/prefetch.py`` wires the
    feeder side; ``train.fit`` wires the consumer side and surfaces a
    summary at its log cadence).

    - **feeder** (the prefetch thread, or the inline path when prefetch is
      off): ``assembly`` histogram (seconds per batch of host assembly +
      host-to-device copy), ``batches_assembled`` counter, ``queue_depth``
      gauge.
    - **consumer** (the training loop): ``observe_wait`` with the seconds it
      blocked waiting for a batch. With prefetch on, host wait ~ 0 in steady
      state; host wait ~ assembly means the run is feed-bound.

    ``window()`` pops the per-log-window summary (mean host wait since the
    last call + current queue depth).
    """

    def __init__(self):
        self.host_wait = Histogram()       # s/step the consumer blocked on feed
        self.assembly = Histogram()        # s/batch of assembly + device copy
        self.queue_depth = Gauge()         # prefetch queue occupancy
        self.batches_assembled = Counter()
        self.host_wait_w = WindowedHistogram()
        self._lock = threading.Lock()
        self._win_wait = 0.0
        self._win_steps = 0

    def observe_wait(self, seconds: float) -> None:
        """Consumer-side: record one blocking wait for a batch."""
        self.host_wait.observe(seconds)
        self.host_wait_w.observe(seconds)
        with self._lock:
            self._win_wait += float(seconds)
            self._win_steps += 1

    def window(self) -> dict:
        """Pop the log-cadence summary (resets the window accumulators)."""
        with self._lock:
            wait, steps = self._win_wait, self._win_steps
            self._win_wait, self._win_steps = 0.0, 0
        return {
            "host_wait_ms": (1e3 * wait / steps) if steps else 0.0,
            "feed_queue_depth": self.queue_depth.value,
        }

    def snapshot(self) -> dict:
        """Full-stream summary."""
        return {
            "host_wait_ms": {
                k: (v * 1e3 if k != "count" else v)
                for k, v in self.host_wait.summary().items()
            },
            "assembly_ms": {
                k: (v * 1e3 if k != "count" else v)
                for k, v in self.assembly.summary().items()
            },
            "queue_depth": self.queue_depth.value,
            "batches_assembled": self.batches_assembled.value,
        }


class ServeMetrics:
    """The serving subsystem's observability bundle (serve/batcher.py wires
    it; serve/server.py exposes it as JSON at ``GET /metrics`` and as
    Prometheus text at ``GET /metrics?format=prom`` via obs/export.py).

    Two generations of families live side by side:

    - **cumulative** (since boot): the original Counter/Gauge/Histogram
      instruments — stable JSON keys, Prometheus counter/histogram
      exposition;
    - **windowed** (obs/timeseries.py): trailing-rate counters and
      bucketed windowed histograms feeding the SLO burn-rate math and the
      readiness probe.  ``windowed=False`` skips them (one bool check on
      the hot path) — the A/B knob for the overhead measurement in
      docs/PERF.md.

    ``latency_bounds`` overrides the windowed latency bucket layout; pass
    ``obs.timeseries.bounds_with(slo_threshold_s)`` so SLO attainment at
    the threshold is exact (cli/serve.py and serve_bench do).
    """

    #: trailing windows surfaced in snapshots (short, mid, long)
    WINDOWS_S = DEFAULT_WINDOWS_S

    def __init__(self, windowed: bool = True, latency_bounds: tuple | None = None):
        self.windowed = windowed
        self.latency = Histogram()          # seconds, submit -> reply
        self.batch_occupancy = Histogram()  # rows per flushed batch
        self.queue_depth = Gauge()
        self.in_flight = Gauge()            # dispatched-not-yet-fetched batches
        self.requests = Counter()
        self.rejected = Counter()           # backpressure rejections
        self.batches = Counter()
        self.errors = Counter()             # batches that raised
        self.padded_rows = Counter()        # wasted executable rows (tier - occupancy)
        self.tier_hits = LabelledCounter()      # dispatches per batch tier
        self.bucket_hits = LabelledCounter()    # dispatches per sequence bucket
        self.tier_occupancy = LabelledHistogram()  # rows per dispatch, by tier
        # Layout-labelled twins of the dispatch instruments, keyed
        # "<layout>/<tier|bucket>" (layout = parallel.mesh.layout_label, e.g.
        # "dp2-tp4") — ADDITIVE alongside the unlabelled ones so single-mesh
        # deployments keep their stable /metrics keys while multi-layout
        # fleets can attribute hits per mesh layout.
        self.layout_tier_hits = LabelledCounter()
        self.layout_bucket_hits = LabelledCounter()
        # Per-request phase breakdown (seconds), keyed by phase name
        # (queue_wait/batch_assemble/dispatch/device/fetch on the pipelined
        # path) — the histogram form of the per-request `Future.phases`
        # dict, so serve_bench p99 is attributable to a pipeline stage.
        self.phase = LabelledHistogram()
        # Per-layout phase histograms, keyed "<layout>/<phase>" — written by
        # observe_phase alongside the plain phase family, so mesh layouts'
        # device-time distributions are separable (a TP engine's "device"
        # phase includes its psums; the DP engine's does not).
        self.layout_phase = LabelledHistogram()
        # Requests that never produced a result, by cause: "backpressure"
        # (queue full), "validation" (RequestError at submit),
        # "engine_failure" (batch raised mid-flight), "closed".
        self.rejected_by_cause = LabelledCounter()
        # ------------------------------------------------- decode families
        # Per-token observability for the continuous-batching decode path
        # (serve/batcher.ContinuousBatcher). Per-token latency itself rides
        # the phase family as "decode_step" (one sample per fetched token);
        # these are the aggregates that family can't carry.
        self.tokens = Counter()        # generated tokens delivered
        self.decode_steps = Counter()  # decode-step executions (all slots)
        self.slots_active = Gauge()    # occupied KV-cache slots
        self.ttft = Histogram()        # seconds, submit -> first token
        self.itl = Histogram()         # seconds between consecutive tokens
        # Prefix-cache (serve/kvpool.py) families: admissions that
        # consulted the trie, the subset that matched a cached head, the
        # prompt tokens those matches skipped (suffix-only prefill), and
        # the bytes of KV pages the pool currently holds.
        self.prefix_lookups = Counter()
        self.prefix_hits = Counter()
        self.prefix_tokens_saved = Counter()
        self.kv_pool_bytes = Gauge()
        # Quantized serving (models/quant.py): slot-cache bytes one cached
        # token occupies, keyed by the engine's KV storage dtype — the
        # capacity story behind int8 KV ("serve_kv_bytes_per_token" in
        # prom; DEPLOY.md's sizing math divides the HBM budget by this).
        self.kv_bytes_per_token = LabelledGauge()
        # Speculative-decoding (serve/spec.py) families: drafted candidate
        # tokens, the subset the verify step accepted, and verify steps
        # that rejected at least one draft. acceptance = accepted/drafted;
        # the windowed twins below carry the trailing-rate form.
        self.draft_tokens = Counter()
        self.accepted_tokens = Counter()
        self.spec_rejects = Counter()
        # Disaggregated-serving (serve/disagg.py) families, keyed by role
        # ("prefill"/"decode" — the side that sourced/adopted the chain):
        # KV-page bytes moved between engine pools and the wall-clock
        # seconds each transfer took (export + transport + adoption).
        self.kv_transfer_bytes = LabelledCounter()
        self.kv_transfer_seconds = LabelledHistogram()
        # Live stream migration (serve/disagg.py StreamReceiver +
        # migrate_streams), keyed by outcome: "adopted"/"rejected" on the
        # receiving replica, "migrated"/"readopted" on the exporting one.
        self.stream_migrations = LabelledCounter()
        # Priority-preemptive scheduling (serve/batcher.py), keyed by how
        # the park went: "paged" (KV lanes published into parked pool
        # pages), "pageless" (resume_tokens replay only), or the abort
        # reasons "park_full"/"bucket_overflow" (victim kept its slot and
        # finished). serve_preemptions_total in prom.
        self.preemptions = LabelledCounter()
        # Queued requests per priority class (label = class number as a
        # string; 0 is the most urgent). serve_sched_queue_depth in prom.
        self.sched_queue_depth = LabelledGauge()
        # ------------------------------------------------ windowed families
        # (obs/timeseries.py) — the SLO/health layer's inputs.  bad_w
        # counts requests that burned availability budget (backpressure +
        # engine failure + closed; NOT validation — that's the client's
        # error); ok_w counts delivered results.  rejected_w is the
        # backpressure-only series the saturation probe reads.
        bounds = latency_bounds or DEFAULT_LATENCY_BOUNDS
        self.latency_w = WindowedHistogram(bounds=bounds)
        self.phase_w = WindowedHistogramFamily(bounds=bounds)
        self.requests_w = WindowedCounter()   # accepted submissions
        self.ok_w = WindowedCounter()         # delivered results
        self.bad_w = WindowedCounter()        # budget-burning failures
        self.rejected_w = WindowedCounter()   # backpressure sheds only
        self.tokens_w = WindowedCounter()     # generated tokens (tokens/s)
        self.drafted_w = WindowedCounter()    # speculative drafts proposed
        self.accepted_w = WindowedCounter()   # speculative drafts accepted

    def observe_phase(self, name: str, seconds: float, layout: str = "") -> None:
        """Record one per-request phase sample, double-keyed by the engine's
        mesh layout when one is known (serve/batcher.py passes it through)."""
        self.phase.observe(name, seconds)
        if self.windowed:
            self.phase_w.observe(name, seconds)
        if layout:
            self.layout_phase.observe(f"{layout}/{name}", seconds)

    def observe_phase_batch(
        self,
        name: str,
        values: Sequence[float],
        layout: str = "",
        now: float | None = None,
    ) -> None:
        """One flush's worth of samples for a single phase. The windowed
        twin takes its lock ONCE for the whole batch (``observe_many``) —
        per-sample locking would scale hot-path lock traffic with the
        batch size (and trip the racetrace-overhead bound in tests)."""
        for v in values:
            self.phase.observe(name, v)
            if layout:
                self.layout_phase.observe(f"{layout}/{name}", v)
        if self.windowed:
            self.phase_w.observe_many(name, values, now)

    def windowed_snapshot(self) -> dict:
        """Per-window trailing rates + latency quantiles (ms), keyed
        "10s"/"60s"/"300s" — the time-aware section of ``snapshot()``."""
        out = {}
        for w in self.WINDOWS_S:
            lat = self.latency_w.window_summary(w)
            drafted = self.drafted_w.sum(w)
            out[f"{w:g}s"] = {
                "request_rate": self.requests_w.rate(w),
                "ok_rate": self.ok_w.rate(w),
                "rejected_rate": self.rejected_w.rate(w),
                "failure_rate": self.bad_w.rate(w),
                "token_rate": self.tokens_w.rate(w),
                # Trailing draft-acceptance rate (accepted/drafted over the
                # window); 0.0 when speculation is off or idle.
                "spec_acceptance": (
                    self.accepted_w.sum(w) / drafted if drafted else 0.0
                ),
                "latency_ms": {
                    "count": lat["count"],
                    "p50": lat["p50"] * 1e3,
                    "p90": lat["p90"] * 1e3,
                    "p99": lat["p99"] * 1e3,
                },
            }
        return out

    def snapshot(self) -> dict:
        lat = self.latency.summary()
        return {
            "requests": self.requests.value,
            "rejected": self.rejected.value,
            "batches": self.batches.value,
            "errors": self.errors.value,
            "queue_depth": self.queue_depth.value,
            "in_flight": self.in_flight.value,
            "padded_rows": self.padded_rows.value,
            "latency_ms": {
                k: (v * 1e3 if k != "count" else v) for k, v in lat.items()
            },
            "batch_occupancy": self.batch_occupancy.summary(),
            "tier_hits": self.tier_hits.snapshot(),
            "bucket_hits": self.bucket_hits.snapshot(),
            "tier_occupancy": self.tier_occupancy.snapshot(),
            "layout_tier_hits": self.layout_tier_hits.snapshot(),
            "layout_bucket_hits": self.layout_bucket_hits.snapshot(),
            "rejected_by_cause": self.rejected_by_cause.snapshot(),
            "tokens": self.tokens.value,
            "decode_steps": self.decode_steps.value,
            "slots_active": self.slots_active.value,
            "prefix_lookups": self.prefix_lookups.value,
            "prefix_hits": self.prefix_hits.value,
            "prefix_tokens_saved": self.prefix_tokens_saved.value,
            "kv_pool_bytes": self.kv_pool_bytes.value,
            "kv_bytes_per_token": self.kv_bytes_per_token.snapshot(),
            "draft_tokens": self.draft_tokens.value,
            "accepted_tokens": self.accepted_tokens.value,
            "spec_rejects": self.spec_rejects.value,
            "kv_transfer_bytes": self.kv_transfer_bytes.snapshot(),
            "kv_transfer_seconds": self.kv_transfer_seconds.snapshot(),
            "stream_migrations": self.stream_migrations.snapshot(),
            "preemptions": self.preemptions.snapshot(),
            "sched_queue_depth": self.sched_queue_depth.snapshot(),
            "ttft_ms": {
                k: (v * 1e3 if k != "count" else v)
                for k, v in self.ttft.summary().items()
            },
            "itl_ms": {
                k: (v * 1e3 if k != "count" else v)
                for k, v in self.itl.summary().items()
            },
            "phase_ms": {
                phase: {
                    k: (v * 1e3 if k != "count" else v)
                    for k, v in summ.items()
                }
                for phase, summ in self.phase.snapshot().items()
            },
            "layout_phase_ms": {
                key: {
                    k: (v * 1e3 if k != "count" else v)
                    for k, v in summ.items()
                }
                for key, summ in self.layout_phase.snapshot().items()
            },
            **(
                {"windowed": self.windowed_snapshot()} if self.windowed else {}
            ),
        }


def make_metric_hook(
    logdir: str | Path | None = None,
    jsonl: str | Path | None = None,
):
    """Build a ``fit()`` hook writing to TensorBoard and/or JSONL.

    Rank 0 only (:func:`..parallel.mesh.process_index`, 0 without a
    process group); returns a no-op hook elsewhere. The hook signature is
    the loop's: ``hook(step, state, metrics)``. Empty strings count as
    unset — a default-constructed CLI arg must never create an event file
    in the current directory.
    """
    logdir = logdir or None
    jsonl = jsonl or None
    from distributed_tensorflow_tpu_torch.parallel.mesh import process_index

    if process_index() != 0 or (logdir is None and jsonl is None):
        return lambda step, state, metrics: None
    writers = []
    if logdir is not None:
        writers.append(TensorBoardWriter(logdir))
    if jsonl is not None:
        writers.append(JsonlWriter(jsonl))

    def hook(step: int, state, metrics: dict) -> None:
        del state
        for w in writers:
            w.write(step, metrics)

    hook.writers = writers  # exposed so callers/tests can close them
    return hook
