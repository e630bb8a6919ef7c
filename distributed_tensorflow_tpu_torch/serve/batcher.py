"""Dynamic micro-batcher: the queue between user requests and the engine.

Semantics (the classic serving recipe, e.g. TF-Serving's BatchingSession —
the piece the reference's train-only harness never had):

- Requests enqueue with a ``Future``; a flusher thread groups them.
- A batch flushes when it reaches ``max_batch`` rows OR when the OLDEST
  queued request has waited ``max_delay_ms`` — latency is bounded by the
  deadline, throughput by the batch size, and the tradeoff is two knobs.
- The queue is BOUNDED: past ``max_queue`` pending requests, ``submit``
  raises :class:`Backpressure` with a retry-after hint. Overload degrades
  to explicit rejection the client can retry, never to an unbounded queue
  marching toward OOM.
- Optional BUCKET-AWARE queues (``bucket_for``): requests group per
  engine bucket so short requests flush together instead of riding a
  long batchmate's padded bucket. Deadline semantics stay global (the
  flusher always waits on the globally-oldest request, then flushes its
  bucket) and the ``max_queue`` bound counts ALL buckets together.
- Optional OVERLAPPED dispatch (``dispatch``/``fetch``): when the engine
  splits its hot path, the flusher thread only assembles and launches —
  a separate completion thread blocks on ``fetch`` — so up to
  ``max_in_flight`` batches pipeline host assembly against device
  compute. Results deliver in dispatch order (FIFO completion queue).

The batcher is engine-agnostic: ``run_batch(payloads) -> results`` is any
callable (serve/engine.py provides the real ones; tests pass stubs), and
the overlap/bucket hooks are optional keyword callables.

Port of the JAX package's ``serve/batcher.py`` up to the flush batcher;
the continuous (decode-slot) batcher comes with the decode slice.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import queue
import threading
import time
from collections import deque
from collections.abc import Callable, Sequence
from concurrent.futures import Future

from distributed_tensorflow_tpu_torch.obs.flightrec import NULL_RECORDER
from distributed_tensorflow_tpu_torch.obs.metrics import ServeMetrics
from distributed_tensorflow_tpu_torch.obs.trace import NULL_TRACER

logger = logging.getLogger(__name__)


class Backpressure(RuntimeError):
    """Queue full — reject now, retry after ``retry_after_s``."""

    def __init__(self, retry_after_s: float):
        super().__init__(
            f"request queue full; retry after {retry_after_s * 1e3:.0f} ms"
        )
        self.retry_after_s = retry_after_s


def drain_retry_after_s(
    queued_units: float,
    unit_rate: float,
    floor_s: float,
    cap_s: float = 30.0,
) -> float:
    """Retry-After for an admission shed, from actual drain arithmetic.

    ``queued_units / unit_rate`` is how long the work already queued takes
    to drain at the recently observed service rate (units and rate must
    agree: tokens owed over tokens/s for the continuous batcher, requests
    over requests/s for the flush batcher). Floored at ``floor_s`` (one
    flush window — the old fixed hint — so an idle or just-started server
    never hands out a zero), capped at ``cap_s`` so a momentary stall
    can't tell clients to go away for minutes. A non-positive rate means
    nothing has drained inside the measurement window; the floor is the
    only honest answer then.
    """
    if unit_rate <= 0.0 or queued_units <= 0.0:
        return floor_s
    return min(max(queued_units / unit_rate, floor_s), cap_s)


VALID_SCHED = ("fifo", "edf")


@dataclasses.dataclass(frozen=True)
class BatcherConfig:
    max_batch: int = 8          # flush when this many requests are queued
    max_delay_ms: float = 8.0   # ...or when the oldest has waited this long
    max_queue: int = 64         # bounded depth; beyond -> Backpressure
    max_in_flight: int = 2      # dispatched-not-fetched batches (needs an
                                # engine with dispatch/fetch; else 1)
    bucket_queues: bool = False  # per-bucket queues (needs bucket_for)
    sched: str = "fifo"         # admission order: "fifo" | "edf"
                                # (earliest-deadline-first within priority
                                # class; continuous batcher only)
    preempt: bool = False       # evict a lower-priority slot when a queued
                                # higher-priority request would miss its
                                # deadline (needs sched="edf")
    preempt_margin_ms: float = 20.0  # preempt when now + margin crosses the
                                # waiter's deadline (headroom for the park/
                                # re-prefill round trip)
    default_priority: int = 1   # class for requests that don't send one
                                # (0 is the most urgent; larger = later)

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.max_delay_ms < 0:
            raise ValueError("max_delay_ms must be >= 0")
        if self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")
        if self.max_in_flight < 1:
            raise ValueError(
                f"max_in_flight must be >= 1, got {self.max_in_flight}"
            )
        if self.sched not in VALID_SCHED:
            raise ValueError(
                f"sched must be one of {VALID_SCHED}, got {self.sched!r}"
            )
        if self.preempt and self.sched != "edf":
            raise ValueError(
                "preempt=True requires sched='edf' — preemption exists to "
                "rescue deadline-bearing waiters, which FIFO cannot order"
            )
        if self.preempt_margin_ms < 0:
            raise ValueError("preempt_margin_ms must be >= 0")
        if self.default_priority < 0:
            raise ValueError(
                f"default_priority must be >= 0, got {self.default_priority}"
            )


class _Pending:
    __slots__ = (
        "payload", "future", "t_enqueue", "t_taken", "request_id",
        "priority", "deadline_abs", "preempted",
    )

    def __init__(self, payload, request_id=None, default_priority=0):
        self.payload = payload
        self.future: Future = Future()
        self.t_enqueue = time.monotonic()
        self.t_taken = 0.0          # stamped when the flusher takes the batch
        self.request_id = request_id
        # DynamicBatcher accepts arbitrary payloads (any object run_batch
        # understands); only mapping payloads can carry scheduling fields.
        fields = payload if isinstance(payload, dict) else {}
        self.priority = int(fields.get("priority", default_priority))
        # Absolute TTFT deadline (monotonic clock); None = best-effort.
        ddl = fields.get("deadline_ms")
        self.deadline_abs = (
            self.t_enqueue + float(ddl) / 1e3 if ddl is not None else None
        )
        self.preempted = 0          # park/resume round trips survived


class DynamicBatcher:
    """Thread-safe request queue with size/deadline flushing.

    Without ``dispatch``/``fetch``, ``run_batch`` runs on the flusher
    thread — one batch in flight at a time, the right shape for an engine
    that blocks anyway. With them, the flusher assembles+launches and a
    completion thread fetches, bounded by ``config.max_in_flight``.
    """

    # Shared mutable state watched by obs.sanitizer.sanitize_races in the
    # pipelining tests; every access must be ordered by self._cv.
    # _served is deliberately NOT watched: it is ordered by _cv like the
    # rest, but instrumenting a per-flush hot-path write would eat into
    # the racetrace overhead budget for zero extra race coverage.
    _RACETRACE_ATTRS = ("_queues", "_count", "_closed", "_n_inflight")

    def __init__(
        self,
        run_batch: Callable[[list], Sequence],
        config: BatcherConfig | None = None,
        metrics: ServeMetrics | None = None,
        *,
        dispatch: Callable | None = None,
        fetch: Callable | None = None,
        bucket_for: Callable | None = None,
        tracer=None,
        recorder=None,
        layout: str = "",
    ):
        self.config = config or BatcherConfig()
        if self.config.sched != "fifo":
            raise ValueError(
                "DynamicBatcher flushes whole batches and holds no slots to "
                "reorder or preempt; sched policies need the continuous "
                f"batcher (got sched={self.config.sched!r})"
            )
        self.metrics = metrics or ServeMetrics()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.recorder = recorder if recorder is not None else NULL_RECORDER
        # The engine's mesh-layout label; keys the per-layout phase
        # histograms (ServeMetrics.layout_phase). Empty = unlabelled.
        self._layout = layout
        self._req_ids = itertools.count()
        self._run_batch = run_batch
        self._dispatch = dispatch
        self._fetch = fetch
        self._pipelined = dispatch is not None and fetch is not None
        self._bucket_for = bucket_for if self.config.bucket_queues else None
        self._cv = threading.Condition()
        self._queues: dict = {}      # bucket key -> deque[_Pending]
        self._count = 0              # total pending across buckets
        self._served = 0             # lifetime completed requests
        self._closed = False
        self._inflight_sem = threading.BoundedSemaphore(
            self.config.max_in_flight
        )
        self._n_inflight = 0
        self._completion: queue.Queue = queue.Queue()
        self._fetch_thread = None
        if self._pipelined:
            self._fetch_thread = threading.Thread(
                target=self._completion_loop,
                name="serve-batcher-fetch",
                daemon=True,
            )
            self._fetch_thread.start()
        self._thread = threading.Thread(
            target=self._loop, name="serve-batcher", daemon=True
        )
        self._thread.start()

    def submit(self, payload, request_id: str | None = None) -> Future:
        """Enqueue one request; returns its Future (result = engine output).

        ``request_id`` is the trace correlation key: callers (the HTTP
        front end) pass theirs through; otherwise one is minted here, and
        either way it rides the request end to end — on the returned
        Future (``.request_id``, plus ``.phases`` once resolved), in every
        span the request produces, and in rejection/failure accounting.

        Raises :class:`Backpressure` when the queue is at ``max_queue`` —
        the retry-after hint is one max-delay window, the time one flush
        takes to drain ``max_batch`` slots. The rejection carries the
        ``request_id`` so shed load stays attributable in logs.
        """
        key = self._bucket_for(payload) if self._bucket_for else None
        if request_id is None:
            request_id = f"r-{next(self._req_ids):08d}"
        metrics = self.metrics  # local: instruments carry their own locks
        with self._cv:
            if self._closed:
                metrics.rejected_by_cause.inc("closed")
                if metrics.windowed:
                    metrics.bad_w.add(1.0)
                self.recorder.record(
                    "request_reject", request_id, cause="closed"
                )
                raise RuntimeError("batcher is closed")
            if self._count >= self.config.max_queue:
                metrics.rejected.inc()
                metrics.rejected_by_cause.inc("backpressure")
                if metrics.windowed:
                    metrics.rejected_w.add(1.0)
                    metrics.bad_w.add(1.0)
                self.tracer.instant(
                    "rejected", "serve", request_id=request_id,
                    cause="backpressure", queue_depth=self._count,
                )
                self.recorder.record(
                    "request_reject", request_id, cause="backpressure",
                    queue_depth=self._count,
                )
                # Drain-time hint: queued requests over the recent
                # completion rate, floored at one flush window (1 ms min
                # so a zero-delay config still hands out a non-zero hint).
                exc = Backpressure(drain_retry_after_s(
                    float(self._count),
                    self.metrics.ok_w.rate(10.0),
                    max(self.config.max_delay_ms / 1e3, 1e-3),
                ))
                exc.request_id = request_id
                raise exc
            pending = _Pending(payload, request_id)
            pending.future.request_id = request_id
            self._queues.setdefault(key, deque()).append(pending)
            self._count += 1
            metrics.requests.inc()
            metrics.queue_depth.set(self._count)
            self._cv.notify_all()
        if metrics.windowed:
            metrics.requests_w.add(1.0)
        self.recorder.record("request_admit", request_id)
        return pending.future

    def status(self) -> dict:
        """Live stack view for the health tracker / probe body: one
        consistent read of the state the flusher mutates under ``_cv``."""
        with self._cv:
            return {
                "closed": self._closed,
                "mode": "flush",
                "served": self._served,
                "queue_depth": self._count,
                "max_queue": self.config.max_queue,
                "in_flight": self._n_inflight,
                "max_in_flight": self.config.max_in_flight,
            }

    # ------------------------------------------------------------- flusher

    def _full_bucket(self):
        """(found, key) for a bucket at max_batch, oldest head first
        (fairness). A plain key can't signal absence: the single-queue
        mode's bucket key IS None."""
        found, best = False, None
        for key, q in self._queues.items():
            if len(q) >= self.config.max_batch and (
                not found
                or q[0].t_enqueue < self._queues[best][0].t_enqueue
            ):
                found, best = True, key
        return found, best

    def _oldest_bucket(self):
        return min(
            self._queues, key=lambda k: self._queues[k][0].t_enqueue
        )

    def _take_batch(self) -> list[_Pending] | None:
        """Block until a batch is due (size or deadline) or close drains.

        The deadline is GLOBAL: the wait tracks the oldest request across
        all buckets, so a lone request in a cold bucket still flushes
        within ``max_delay_ms`` of arrival.
        """
        max_delay = self.config.max_delay_ms / 1e3
        with self._cv:
            while True:
                if self._count:
                    full, key = self._full_bucket()
                    if full or self._closed:
                        if not full:
                            key = self._oldest_bucket()
                        break
                    key = self._oldest_bucket()
                    remaining = (
                        self._queues[key][0].t_enqueue
                        + max_delay
                        - time.monotonic()
                    )
                    if remaining <= 0:
                        break
                    self._cv.wait(remaining)
                elif self._closed:
                    return None
                else:
                    self._cv.wait()
            q = self._queues[key]
            batch = [
                q.popleft()
                for _ in range(min(len(q), self.config.max_batch))
            ]
            if not q:
                del self._queues[key]
            self._count -= len(batch)
            self.metrics.queue_depth.set(self._count)
            now = time.monotonic()
            for p in batch:
                p.t_taken = now  # queue_wait phase ends here
            return batch

    def _fail(self, batch: list[_Pending], exc: BaseException) -> None:
        metrics = self.metrics  # local: instruments carry their own locks
        metrics.errors.inc()
        metrics.rejected_by_cause.inc("engine_failure", len(batch))
        if metrics.windowed:
            metrics.bad_w.add(float(len(batch)))
        for p in batch:
            self.tracer.instant(
                "engine_failure", "serve", request_id=p.request_id,
                error=type(exc).__name__,
            )
            self.recorder.record(
                "engine_failure", p.request_id, error=type(exc).__name__,
            )
            if not p.future.cancelled():
                p.future.set_exception(exc)
        logger.warning(
            "batch of %d failed (%s): request_ids=%s",
            len(batch), type(exc).__name__, [p.request_id for p in batch],
        )
        self.recorder.trigger("engine_failure")

    def _deliver(self, batch: list[_Pending], results,
                 marks: list[tuple[str, float]] = (), final_phase="fetch",
                 layout: str | None = None):
        """Resolve futures + record the per-request phase breakdown.

        ``marks`` are the batch-level phase boundaries measured by the
        flusher/completion threads, as ``(phase_name, t_end)`` in dispatch
        order; each request's first phase is its own ``queue_wait``
        (enqueue -> taken) and its last (``final_phase``) ends at the
        delivery timestamp. Boundaries are CONTIGUOUS, so the phase sum
        equals the measured enqueue->reply latency by construction — the
        serve_bench tripwire fails loudly if instrumentation ever drifts
        ``layout`` labels the per-layout phase twins (defaults to the
        batcher's engine layout; an in-flight handle that knows better —
        e.g. a mesh-sharded dispatch — overrides per batch).
        """
        if layout is None:
            layout = self._layout
        if len(results) != len(batch):
            # An engine that answers short would leave the excess futures
            # pending FOREVER under a bare zip — fail the whole batch
            # loudly instead (the satellite fix for the silent drop).
            self._fail(
                batch,
                RuntimeError(
                    f"engine returned {len(results)} results for a batch "
                    f"of {len(batch)} requests"
                ),
            )
            return
        now = time.monotonic()
        tracer, metrics = self.tracer, self.metrics
        t_taken = batch[0].t_taken  # one flush: all rows taken together
        if tracer.enabled:
            t = t_taken
            for name, t_end in marks:
                tracer.record(name, t, t_end, cat="serve",
                              args={"rows": len(batch)})
                t = t_end
            tracer.record(final_phase, t, now, cat="serve",
                          args={"rows": len(batch)})
        windowed = metrics.windowed
        latencies: list[float] = []
        phase_values: dict[str, list[float]] = {}
        per_request: list[dict] = []
        for p in batch:
            latency = now - p.t_enqueue
            metrics.latency.observe(latency)
            latencies.append(latency)
            # Exact per-request latency for the serve_bench SLO-math gate
            # (windowed-histogram attainment vs the exact log).
            p.future.latency_s = latency
            phases = {"queue_wait": p.t_taken - p.t_enqueue}
            t = p.t_taken
            for name, t_end in marks:
                phases[name] = t_end - t
                t = t_end
            phases[final_phase] = now - t
            for name, dt in phases.items():
                phase_values.setdefault(name, []).append(dt)
            per_request.append(phases)
            tracer.record("request", p.t_enqueue, now, cat="serve",
                          request_id=p.request_id)
            tracer.record("queue_wait", p.t_enqueue, p.t_taken, cat="serve",
                          request_id=p.request_id)
        # Whole-batch metric recording BEFORE resolving futures (a reader
        # joining on a future must see its batch's samples), with the
        # windowed series taking each lock once per flush, not per request.
        for name, vals in phase_values.items():
            metrics.observe_phase_batch(name, vals, layout, now)
        if windowed:
            metrics.latency_w.observe_many(latencies, now)
            metrics.ok_w.add(float(len(batch)), now)
        for p, r, phases in zip(batch, results, per_request):
            if not p.future.cancelled():
                p.future.phases = phases
                p.future.set_result(r)
        with self._cv:
            self._served += len(batch)
        if self.recorder.enabled:
            for p in batch:
                self.recorder.record(
                    "request_complete", p.request_id,
                    latency_ms=round((now - p.t_enqueue) * 1e3, 3),
                )

    def _loop(self):
        while True:
            batch = self._take_batch()
            if batch is None:
                if self._pipelined:
                    self._completion.put(None)  # unblock the fetch thread
                return
            self.metrics.batches.inc()
            self.metrics.batch_occupancy.observe(len(batch))
            if not self._pipelined:
                # The serial path runs its batch ON this thread, so without
                # in-flight accounting a request could be inside the engine
                # while both queue_depth and in_flight read 0 — drain
                # probes (router hot-swap) had to demand two consecutive
                # zero-work reads to close that blind spot. Count the
                # running batch like the pipelined path does and the
                # blind spot is gone.
                with self._cv:
                    self._n_inflight += 1
                    self.metrics.in_flight.set(self._n_inflight)
                try:
                    try:
                        results = self._run_batch(
                            [p.payload for p in batch]
                        )
                    except Exception as e:  # noqa: BLE001 — fail the batch, not the server
                        self._fail(batch, e)
                        continue
                    # Serial path: run_batch blocks through assemble +
                    # device + fetch, so the breakdown collapses to
                    # queue_wait -> run.
                    self._deliver(batch, results, final_phase="run")
                finally:
                    # Not decremented until futures resolve: a drain probe
                    # reading zero must mean NOTHING is owed to a caller.
                    with self._cv:
                        self._n_inflight -= 1
                        self.metrics.in_flight.set(self._n_inflight)
                continue
            # Overlapped path: launch, hand off to the completion thread,
            # and immediately assemble the next batch. The semaphore
            # bounds dispatched-but-unfetched batches to max_in_flight.
            self._inflight_sem.acquire()
            try:
                handle = self._dispatch([p.payload for p in batch])
            except Exception as e:  # noqa: BLE001
                self._inflight_sem.release()
                self._fail(batch, e)
                continue
            t_disp = time.monotonic()
            with self._cv:
                self._n_inflight += 1
                self.metrics.in_flight.set(self._n_inflight)
            self._completion.put((batch, handle, t_disp))

    def _completion_loop(self):
        while True:
            item = self._completion.get()
            if item is None:
                return
            batch, handle, t_disp = item
            try:
                results = self._fetch(handle)
            except Exception as e:  # noqa: BLE001
                self._fail(batch, e)
            else:
                # Phase boundaries: real engines stamp t_assembled (host
                # buffers filled) on dispatch and t_got (device_get
                # returned) on fetch; handles without them degrade to
                # coarser-but-still-contiguous boundaries.
                t_got = getattr(handle, "t_got", None) or time.monotonic()
                t_asm = getattr(handle, "t_assembled", None) or t_disp
                self._deliver(
                    batch,
                    results,
                    marks=[
                        ("batch_assemble", t_asm),
                        ("dispatch", t_disp),
                        ("device", t_got),
                    ],
                    layout=getattr(handle, "layout", "") or self._layout,
                )
            finally:
                with self._cv:
                    self._n_inflight -= 1
                    self.metrics.in_flight.set(self._n_inflight)
                self._inflight_sem.release()

    def close(self, drain: bool = True, join_timeout_s: float = 30.0) -> None:
        """Stop the flusher. ``drain=True`` serves what's queued first;
        otherwise pending futures fail with a RuntimeError.

        Raises ``RuntimeError`` if the worker threads are still alive after
        ``join_timeout_s`` — a wedged engine must be VISIBLE, not a
        silently leaked daemon thread.
        """
        with self._cv:
            if self._closed:
                return
            self._closed = True
            if not drain:
                while self._queues:
                    _, q = self._queues.popitem()
                    while q:
                        p = q.popleft()
                        p.future.set_exception(RuntimeError("batcher closed"))
                self._count = 0
            self._cv.notify_all()
        self._thread.join(timeout=join_timeout_s)
        if self._fetch_thread is not None:
            self._fetch_thread.join(timeout=join_timeout_s)
        stuck = [
            t.name
            for t in (self._thread, self._fetch_thread)
            if t is not None and t.is_alive()
        ]
        if stuck:
            msg = (
                f"batcher thread(s) {stuck} still running after "
                f"{join_timeout_s:.0f}s close timeout — engine likely wedged"
            )
            logger.error(msg)
            raise RuntimeError(msg)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

