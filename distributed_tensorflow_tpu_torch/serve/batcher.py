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

:class:`ContinuousBatcher` is the decode engines' scheduler: a slot table
with admission between decode steps (or flush admission, the static
baseline), the prefix-cache trie, chunked prefill, n-gram speculation,
EDF admission and slot preemption, and the fleet hooks of
:mod:`~distributed_tensorflow_tpu_torch.serve.disagg`: KV-chain adoption
(``adopt_chain``) and live stream export and adoption (``export_streams``,
``adopt_stream``), all serviced on the decode-loop thread between steps.

Port of the JAX package's ``serve/batcher.py``, with the serving fault
injector's decode-step hook (``ContinuousBatcher.fault_injector``, a
:class:`~distributed_tensorflow_tpu_torch.serve.faultinject.FaultInjector`).
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
from distributed_tensorflow_tpu_torch.serve.spec import SlotSpec

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


class _Slot:
    """Host bookkeeping for one KV-cache slot's occupant. Every field is
    owned by ``ContinuousBatcher._cv``; ``gen`` disambiguates a reused slot
    from the occupant an in-flight step was dispatched for."""

    __slots__ = (
        "pending", "gen", "prompt_len", "length", "max_new", "eos_id",
        "temperature", "seed", "tokens", "n_dispatched", "t_first",
        "t_last_tok", "prefilling", "chunk_pos", "cached_len", "chain",
        "slot_id", "spec", "prompt_ids", "draft", "verifying",
        "resume", "full_prompt", "admit_len", "preempting",
        "preempt_exempt",
    )

    def __init__(self, pending: _Pending, gen: int, payload: dict,
                 default_max_new: int):
        self.pending = pending
        self.gen = gen
        self.prompt_len = len(payload["input_ids"])
        # Preemption and migration replay (serve/disagg.py stream wire):
        # already-delivered generated tokens ride as ``resume_tokens`` —
        # the prefill treats them as prompt suffix (so the next sample
        # lands at the SAME absolute position the uninterrupted stream
        # would use), while ``prompt_len`` and the result's token list
        # keep the client's original view (tokens accumulate across
        # park/resume and migration hops).
        self.resume = [int(t) for t in payload.get("resume_tokens", ())]
        self.full_prompt = (
            [int(t) for t in payload["input_ids"]] + self.resume
        )
        self.admit_len = len(self.full_prompt)
        self.length = self.admit_len    # cache pages written (advances at
        self.n_dispatched = 0           # DISPATCH, so steps pipeline)
        self.max_new = int(payload.get("max_new_tokens", default_max_new))
        eos = payload.get("eos_id")
        self.eos_id = None if eos is None else int(eos)
        self.temperature = float(payload.get("temperature", 0.0))
        self.seed = int(payload.get("seed", 0))
        self.tokens: list[int] = list(self.resume)
        self.t_first = 0.0
        self.t_last_tok = 0.0
        # Chunked-prefill bookkeeping (chunked engines only): prompt
        # tokens already in cache pages (cached prefix + dispatched
        # chunks), the pinned prefix-cache match, and whether chunk
        # dispatches remain before the slot may join decode steps.
        self.prefilling = False
        self.chunk_pos = 0
        self.cached_len = 0
        self.chain = None
        self.slot_id = -1  # table index, stamped at admission (flight rec)
        # Speculative-decoding bookkeeping (spec-enabled engines only):
        # the per-occupancy SlotSpec state machine, the prompt as a plain
        # int list (drafting history = prompt_ids + tokens), the draft
        # awaiting its verify verdict, and whether a verify step is in
        # flight — a verifying slot never re-dispatches until the verdict
        # fetches (spec-mode slots advance at FETCH, not dispatch).
        self.spec: SlotSpec | None = None
        self.prompt_ids: list[int] = []
        self.draft: list[int] | None = None
        self.verifying = False
        # Priority-preemption bookkeeping: a marked victim stops taking
        # new decode/verify/chunk dispatches and parks once its in-flight
        # steps settle; an exempt slot was chosen once but could not park
        # (pool full, un-bucketable resume) and runs to completion.
        self.preempting = False
        self.preempt_exempt = False


@dataclasses.dataclass
class StreamState:
    """The host half of a live generation's checkpoint (serve/disagg.py
    ships it next to the slot's KV pages): everything a peer replica needs
    to resume the stream bit-identically — prompt, every token generated
    so far (client-visible, accumulated across hops), the sampling key
    material, and ``length`` = the cache positions the exported pages
    cover (``len(input_ids) + len(tokens) - 1``: the newest token's KV is
    written by the NEXT decode step, exactly as on the source)."""

    request_id: str
    input_ids: list
    tokens: list
    seed: int = 0
    temperature: float = 0.0
    eos_id: int | None = None
    max_new_tokens: int = 32
    length: int = 0

    def to_dict(self) -> dict:
        return {
            "request_id": str(self.request_id),
            "input_ids": [int(t) for t in self.input_ids],
            "tokens": [int(t) for t in self.tokens],
            "seed": int(self.seed),
            "temperature": float(self.temperature),
            "eos_id": None if self.eos_id is None else int(self.eos_id),
            "max_new_tokens": int(self.max_new_tokens),
            "length": int(self.length),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "StreamState":
        eos = d.get("eos_id")
        return cls(
            request_id=str(d["request_id"]),
            input_ids=[int(t) for t in d["input_ids"]],
            tokens=[int(t) for t in d["tokens"]],
            seed=int(d.get("seed", 0)),
            temperature=float(d.get("temperature", 0.0)),
            eos_id=None if eos is None else int(eos),
            max_new_tokens=int(d["max_new_tokens"]),
            length=int(d.get("length", 0)),
        )

    def replay_payload(self) -> dict:
        """The ``/v1/generate`` payload that resumes this stream WITHOUT
        pages: the generated tokens ride as ``resume_tokens`` and the
        target re-prefills prompt+prefix at absolute positions — the
        failover path when the stream's pages died with its replica."""
        out = {
            "input_ids": list(self.input_ids),
            "max_new_tokens": int(self.max_new_tokens),
            "temperature": float(self.temperature),
            "seed": int(self.seed),
        }
        if self.tokens:
            out["resume_tokens"] = list(self.tokens)
        if self.eos_id is not None:
            out["eos_id"] = int(self.eos_id)
        return out


@dataclasses.dataclass
class ExportedStream:
    """One live stream lifted out of a batcher: its :class:`StreamState`,
    the slot's KV pages when the engine could export them (device tensors
    ``[nl, cache_len, heads, head_dim]``, every head; ``None`` for queued /
    still-prefilling streams, which replay page-less), and the victim-held
    client future the migrator resolves once the stream lands elsewhere
    (or re-adopts locally on push failure)."""

    state: StreamState
    pages_k: object | None = None
    pages_v: object | None = None
    future: Future | None = None


class _ExportRequest:
    """Cross-thread handshake for ``export_streams``: the HTTP thread
    parks on ``event`` while the decode-loop thread quiesces in-flight
    steps, captures every live stream, and posts the results."""

    __slots__ = ("event", "results")

    def __init__(self):
        self.event = threading.Event()
        self.results: list[ExportedStream] = []


class ContinuousBatcher:
    """Slot-table scheduler over a decode engine: continuous batching.

    Where :class:`DynamicBatcher` flushes a batch and waits for it, this
    batcher owns a fixed table of ``engine.slots`` KV-cache slots and runs
    an endless decode loop over whichever slots are live: new requests are
    admitted into FREE slots between decode steps (a prefill dispatch
    joins them to the in-flight batch), and a finished sequence frees its
    slot immediately — the next queued request takes it on the very next
    iteration, so occupancy never collapses to the slowest member the way
    a static batch does. ``admission="flush"`` keeps the same machinery
    but only admits when the table is EMPTY — the static-batching baseline
    the decode A/B measures against.

    Threading mirrors the pipelined DynamicBatcher: the decode-loop thread
    is the only engine dispatcher (the engine's device-state swap is
    single-writer by that contract), a completion thread fetches each
    step's sampled tokens, and ``max_in_flight`` bounds
    dispatched-but-unfetched steps — host lengths advance at DISPATCH
    time, so step k+1 launches against step k's still-un-fetched device
    state and the token fetch overlaps the next step's compute. Slot reuse
    while stale steps are in flight is safe on both sides: host-side a
    per-slot generation tag drops stale tokens, device-side every cache
    page is re-written (by the new occupant's prefill or decode) before
    anything reads it, and dispatch order means stale writes land first.

    Per-request results resolve on the submit Future as ``{"tokens",
    "n_tokens", "prompt_len", "bucket"}`` with contiguous phases
    ``queue_wait -> prefill -> decode`` summing to wall latency by
    construction; per-token observability rides the ``decode_step`` phase
    family (inter-token latencies), the ``ttft`` histogram, and the
    ``tokens`` / ``tokens_w`` counters.

    On a CHUNKED engine (``prefill_chunks`` + ``prefill_chunk_size``)
    admission consults the engine's prefix-cache trie — a hit pins the
    matched page chain and shortens the prompt to its un-cached suffix —
    and prefill becomes a sequence of bounded chunk dispatches, at most
    one chunk batch per loop iteration interleaved with the decode step,
    so in-flight slots' ITL stays bounded by one chunk's compute during
    long-prompt admission. The final chunk samples the first token
    (``t_first``/``ttft`` semantics unchanged) and publishes the finished
    prefix pages back to the pool; chunk dispatches ride a batch-level
    ``prefill_chunk`` phase/span while per-request phases keep the same
    contiguous taxonomy (the ``prefill`` phase simply covers every chunk).

    On a SPECULATIVE engine (``spec_tokens > 0``, exposing ``verify`` and
    a ``spec`` config — serve/spec.py) each occupied slot carries a
    :class:`~distributed_tensorflow_tpu_torch.serve.spec.SlotSpec`: the loop
    drafts from the slot's own prompt+generated history, dispatches ONE
    fixed-shape ``[slots, k+1]`` verify step for every speculating slot,
    and at fetch emits the accepted prefix plus the verified model token —
    1..k+1 tokens per step, bit-identical to the plain stream (exact-match
    acceptance against deterministic per-(seed, position) sampling).
    Spec-mode slots advance ``length`` at FETCH and never overlap their
    own steps (the verdict decides the next position); backed-off slots
    (low acceptance EMA) ride the plain pipelined decode path unchanged,
    re-probing periodically once their outstanding steps drain. The ITL
    histogram stays PER TOKEN: a verify step that emits m+1 tokens
    contributes m+1 samples splitting the step's wall interval.
    """

    # Watched by obs.sanitizer.sanitize_races in the soaks of
    # tests/test_torch_serve_decode.py, tests/test_torch_serve_spec.py and
    # tests/test_torch_sched.py; every access must be ordered by self._cv.
    _RACETRACE_ATTRS = (
        "_queue", "_count", "_closed", "_slots", "_n_active", "_n_inflight",
        "_steps", "_tokens_emitted", "_spec_drafted", "_spec_accepted",
        "_spec_rejects", "_adoptions", "_stream_adopts", "_export_req",
        "_class_queued", "_preempt_parked", "_preempt_resumed",
        "_preempt_aborted",
    )

    def __init__(
        self,
        engine,
        config: BatcherConfig | None = None,
        metrics: ServeMetrics | None = None,
        *,
        admission: str = "continuous",
        tracer=None,
        recorder=None,
        layout: str = "",
    ):
        if admission not in ("continuous", "flush"):
            raise ValueError(
                f"admission must be 'continuous' or 'flush', got {admission!r}"
            )
        self.config = config or BatcherConfig()
        if self.config.preempt and admission != "continuous":
            raise ValueError(
                "preempt=True requires admission='continuous' — flush "
                "admission only ever fills an empty table, so there is "
                "never an occupied slot to preempt for a waiter"
            )
        self.metrics = metrics or ServeMetrics()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.recorder = recorder if recorder is not None else NULL_RECORDER
        self._layout = layout or getattr(engine, "layout", "")
        self._engine = engine
        self._admission = admission
        self._admit_cap = min(self.config.max_batch, engine.max_batch)
        self._default_max_new = getattr(engine, "max_new_tokens", 32)
        # Chunked-prefill engines expose prefill_chunks + a chunk size;
        # admission then consults the prefix trie and dispatches bounded
        # chunks interleaved with decode steps instead of one monolithic
        # prefill. Legacy engines (and stubs) keep the original path.
        self._chunked = (
            callable(getattr(engine, "prefill_chunks", None))
            and getattr(engine, "prefill_chunk_size", 0) > 0
        )
        self._chunk_size = getattr(engine, "prefill_chunk_size", 0)
        self._pool = (
            getattr(engine, "prefix_cache", None) if self._chunked else None
        )
        if self._pool is not None and self.recorder.enabled:
            # Evictions happen inside the pool's allocator; hand it the
            # recorder so prefix_evict events land in the same ring.
            self._pool.recorder = self.recorder
        # Speculative decoding: engines built with spec_tokens > 0 expose
        # a verify dispatch + a SpecConfig (engine.spec); per-slot SlotSpec
        # state is built at admission. Stubs and spec-off engines keep the
        # plain decode path untouched.
        self._spec_cfg = (
            getattr(engine, "spec", None)
            if callable(getattr(engine, "verify", None)) else None
        )
        self._spec_k = (
            self._spec_cfg.spec_tokens if self._spec_cfg is not None else 0
        )
        # Draft-length cache-headroom guard; engines without a fixed
        # cache_len (stubs) are unconstrained.
        self._cache_len = getattr(engine, "cache_len", 1 << 30)
        # Quantized-serving capacity gauge: engines that know their KV
        # storage dtype publish bytes/token once at attach (static for the
        # engine's lifetime; the dtype label keeps mixed fleets legible).
        if callable(getattr(engine, "kv_bytes_per_token", None)):
            self.metrics.kv_bytes_per_token.set(
                getattr(engine, "kv_dtype", "float32"),
                engine.kv_bytes_per_token(),
            )
        # tokens_per_step numerator/denominator for status(): emitted
        # tokens over decode+verify step completions — the speculation
        # win at a glance. Spec accounting totals live here too.
        self._steps = 0
        self._tokens_emitted = 0
        self._spec_drafted = 0
        self._spec_accepted = 0
        self._spec_rejects = 0
        # Backoff flips detected at PLAN time (empty-draft EMA decay);
        # only the decode-loop thread touches this list (_take_work fills,
        # _loop drains to the flight recorder outside _cv).
        self._plan_events: list[tuple[str, int, str, float]] = []
        self._req_ids = itertools.count()
        self._gens = itertools.count(1)
        self._cv = threading.Condition()
        self._queue: deque[_Pending] = deque()
        # Pending KV-chain adoptions (serve/disagg.py): processed on the
        # decode-loop thread BETWEEN steps, because importing a chain
        # writes the engine's pool in place — same single-dispatcher rule
        # as every other engine touch.
        self._adoptions: deque = deque()
        # Live-stream migration (serve/disagg.py stream wire): pending
        # mid-generation adoptions awaiting a free slot, and the at-most-
        # one outstanding export request the decode loop services once
        # in-flight steps quiesce. Same single-dispatcher rule: the slot
        # import / export cells only ever run from the loop thread.
        self._stream_adopts: deque = deque()
        self._export_req: _ExportRequest | None = None
        # Serving-side fault injection (serve/faultinject.py): hooks fire
        # on the decode-step dispatch clock. None = no chaos.
        self.fault_injector = None
        self._dispatched_steps = 0
        # Priority scheduling state (all under _cv): per-class queued
        # counts backing the serve_sched_queue_depth gauge, plus lifetime
        # park / resume / aborted-park totals for status()["sched"].
        self._class_queued: dict[int, int] = {}
        self._preempt_parked = 0
        self._preempt_resumed = 0
        self._preempt_aborted = 0
        self._count = 0
        self._served = 0             # lifetime completed requests
        self._closed = False
        self._slots: list[_Slot | None] = [None] * engine.slots
        self._n_active = 0
        self._n_inflight = 0
        self._inflight_sem = threading.BoundedSemaphore(
            self.config.max_in_flight
        )
        self._completion: queue.Queue = queue.Queue()
        self._fetch_thread = threading.Thread(
            target=self._completion_loop, name="serve-decode-fetch",
            daemon=True,
        )
        self._fetch_thread.start()
        self._thread = threading.Thread(
            target=self._loop, name="serve-decode", daemon=True
        )
        self._thread.start()

    def submit(self, payload, request_id: str | None = None) -> Future:
        """Enqueue one generation request (same Future/Backpressure contract
        as :meth:`DynamicBatcher.submit`); it joins the slot table at the
        next admission point — between decode steps, not behind a flush."""
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
                # Drain-time hint: tokens the queue still owes over the
                # recent token rate — a queue of heavy generations backs
                # clients off longer than the same depth of light ones.
                exc = Backpressure(drain_retry_after_s(
                    float(sum(
                        max(
                            1,
                            int(q.payload.get(
                                "max_new_tokens", self._default_max_new
                            )) - len(q.payload.get("resume_tokens", ())
                                     or ()),
                        )
                        for q in self._queue
                    )),
                    self.metrics.tokens_w.rate(10.0),
                    max(self.config.max_delay_ms / 1e3, 1e-3),
                ))
                exc.request_id = request_id
                raise exc
            pending = _Pending(payload, request_id,
                               self.config.default_priority)
            pending.future.request_id = request_id
            self._queue.append(pending)
            self._count += 1
            self._class_delta(pending.priority, +1)
            metrics.requests.inc()
            metrics.queue_depth.set(self._count)
            self._cv.notify_all()
        if metrics.windowed:
            metrics.requests_w.add(1.0)
        self.recorder.record("request_admit", request_id)
        return pending.future

    def adopt_chain(self, token_ids, pages_k=None, pages_v=None) -> Future:
        """Adopt a transferred KV-page chain into this batcher's prefix
        pool (serve/disagg.py decode role). Indexes ``token_ids``'s full
        blocks in the pool and — when ``pages_*`` stages are given
        (``[nl, max_chain, block_tokens, heads, head_dim]``, chain order,
        every head) — writes the received pages into the newly allocated
        blocks through the engine's import cell. ``pages_* = None`` is the
        pool-only form for engines whose prefill is position-independent
        (stub engines; tests).

        Runs on the decode-loop thread BETWEEN steps (the import writes
        the engine's pool in place, and the decode cell is never touched —
        no per-token dispatch joins the hot path); this call only enqueues
        and returns a Future resolving to the number of newly imported
        blocks (0 = chain already fully cached)."""
        fut: Future = Future()
        with self._cv:
            if self._closed:
                raise RuntimeError("batcher is closed")
            if self._pool is None:
                raise RuntimeError(
                    "engine has no prefix cache to adopt a chain into"
                )
            self._adoptions.append((token_ids, pages_k, pages_v, fut))
            self._cv.notify_all()
        return fut

    def adopt_stream(self, state: StreamState, pages_k=None,
                     pages_v=None) -> Future:
        """Resume a migrated live stream here (serve/disagg.py receiver).

        With ``pages_*`` (``[nl, cache_len, heads, head_dim]`` stages —
        host tensors from the wire, device tensors from a local re-adopt)
        the stream enters a KV slot MID-GENERATION: the decode loop claims
        a free slot between steps, writes the pages through the engine's
        slot-import cell, and the very next decode step continues the
        generation — no prefill, no re-computed tokens. Without pages it
        degrades to a page-less replay: the state's generated prefix
        re-enqueues as ``resume_tokens`` and the target re-prefills at
        absolute positions. Both paths are bit-identical to the
        uninterrupted stream by the (seed, position) sampling contract.

        Returns a Future resolving to the standard generate result with
        the FULL accumulated token list (resumed + newly generated)."""
        if pages_k is not None:
            if not getattr(self._engine, "stream_migrate", False):
                raise RuntimeError(
                    "engine built without stream_migrate=True (no "
                    "slot-import cell); retry page-less"
                )
            need = len(state.input_ids) + int(state.max_new_tokens)
            if need > self._cache_len:
                raise ValueError(
                    f"stream of {need} prompt+max_new tokens exceeds the "
                    f"{self._cache_len}-token cache pages here"
                )
            if state.length != len(state.input_ids) + len(state.tokens) - 1:
                raise ValueError(
                    f"stream length {state.length} inconsistent with "
                    f"{len(state.input_ids)} prompt + {len(state.tokens)} "
                    "generated tokens"
                )
            fut: Future = Future()
            fut.request_id = state.request_id
            with self._cv:
                if self._closed:
                    raise RuntimeError("batcher is closed")
                self._stream_adopts.append((state, pages_k, pages_v, fut))
                self._cv.notify_all()
            self.recorder.record(
                "stream_adopt", state.request_id,
                n_tokens=len(state.tokens), pages=True,
            )
            return fut
        fut = self.submit(state.replay_payload(),
                          request_id=state.request_id)
        self.recorder.record(
            "stream_adopt", state.request_id,
            n_tokens=len(state.tokens), pages=False,
        )
        return fut

    def export_streams(self, timeout_s: float = 30.0) -> list[ExportedStream]:
        """Checkpoint and REMOVE every live stream (occupied slots, queued
        requests, pending stream adoptions) for migration to a peer
        replica. Blocks while the decode loop stops dispatching, lets
        in-flight steps land (so every slot is settled — no in-place
        write racing the copy, no half-fetched tokens), then gathers each
        decoding slot's KV lane through the engine's slot-export cell.
        Streams that have no exportable pages (still prefilling, never
        admitted, or a pages-less engine) come back as page-less states
        that replay via ``resume_tokens``. The freed slots re-enter
        service immediately — callers own pushing the exports somewhere
        (serve/server.py ``/migratez``) and resolving each stream's
        victim-held future."""
        req = _ExportRequest()
        with self._cv:
            if self._closed:
                raise RuntimeError("batcher is closed")
            if self._export_req is not None:
                raise RuntimeError("stream export already in progress")
            self._export_req = req
            self._cv.notify_all()
        if not req.event.wait(timeout_s):
            with self._cv:
                if self._export_req is req:
                    # Never picked up (loop wedged): withdraw the request.
                    self._export_req = None
                    raise TimeoutError(
                        f"stream export not serviced within {timeout_s:.0f}s"
                    )
            # Lost the race — the loop is mid-capture; give it a beat.
            if not req.event.wait(timeout_s):
                raise TimeoutError(
                    f"stream export not serviced within {2 * timeout_s:.0f}s"
                )
        return req.results

    def status(self) -> dict:
        metrics = self.metrics
        with self._cv:
            out = {
                "closed": self._closed,
                "mode": self._admission,
                "served": self._served,
                "queue_depth": self._count,
                "max_queue": self.config.max_queue,
                "in_flight": self._n_inflight,
                "max_in_flight": self.config.max_in_flight,
                "slots": len(self._slots),
                "slots_active": self._n_active,
                # Device bytes the active occupants' slot-table pages pin
                # (slots_active x the engine's per-slot share) — the same
                # number /memz accounts under kv_slot_cache, scaled to
                # live occupancy so the two surfaces agree.
                "kv_active_bytes": self._n_active * getattr(
                    self._engine, "slot_page_bytes", 0
                ),
                # Emitted tokens per decode/verify step completion: 1.0 on
                # a plain engine, >1 when speculation is winning.
                "tokens_per_step": (
                    self._tokens_emitted / self._steps
                    if self._steps else 0.0
                ),
                # Drain-progress estimate (/drainz, /statusz): tokens the
                # live occupants + queue still owe at worst case (every
                # stream runs to max_new). Operators and the router read
                # this to see why a drain is slow — and when to migrate
                # instead of waiting.
                "tokens_remaining": sum(
                    max(0, s.max_new - len(s.tokens))
                    for s in self._slots if s is not None
                ) + sum(
                    max(
                        1,
                        int(p.payload.get(
                            "max_new_tokens", self._default_max_new
                        )) - len(p.payload.get("resume_tokens", ()) or ()),
                    )
                    for p in self._queue
                ),
            }
            if self._pool is not None:
                # KV-pressure digest for /statusz + the fleet view: pool
                # occupancy and lifetime hit rate (lock order _cv -> pool,
                # same as admission's trie match).
                st = self._pool.stats()
                lookups = metrics.prefix_lookups.value
                out["prefix_cache"] = {
                    "blocks": st["blocks"],
                    "blocks_used": st["blocks_used"],
                    "bytes_used": st["bytes_used"],
                    "capacity_bytes": st["capacity_bytes"],
                    "evictions": st["evictions"],
                    "lookups": lookups,
                    "hits": metrics.prefix_hits.value,
                    "hit_rate": (
                        metrics.prefix_hits.value / lookups
                        if lookups else 0.0
                    ),
                    "tokens_saved": metrics.prefix_tokens_saved.value,
                }
            if self._spec_k:
                # Speculation digest for /statusz: per-mode verify width,
                # live acceptance EMA across occupants, lifetime totals.
                digests = [
                    s.spec.digest() for s in self._slots
                    if s is not None and s.spec is not None
                ]
                backed = sum(1 for d in digests if d["backed_off"])
                emas = [d["acceptance_ema"] for d in digests]
                out["speculation"] = {
                    "spec_tokens": self._spec_k,
                    "min_match": self._spec_cfg.min_match,
                    # Verify width by slot mode: full speculation drafts
                    # k tokens, a backed-off slot runs plain decode (k=0).
                    "mode_k": {"speculating": self._spec_k, "backed_off": 0},
                    "slots_speculating": len(digests) - backed,
                    "slots_backed_off": backed,
                    "acceptance_ema": (
                        sum(emas) / len(emas) if emas else 1.0
                    ),
                    "draft_tokens": self._spec_drafted,
                    "accepted_tokens": self._spec_accepted,
                    "rejects": self._spec_rejects,
                    "acceptance_rate": (
                        self._spec_accepted / self._spec_drafted
                        if self._spec_drafted else 0.0
                    ),
                }
            # Priority-scheduling digest for /statusz + the fleet view:
            # policy knobs, per-class queue depth and slot occupancy, and
            # lifetime park / resume / aborted-park totals.
            classes: dict[int, dict] = {}
            for pri, n in self._class_queued.items():
                classes.setdefault(pri, {"queued": 0, "active": 0})
                classes[pri]["queued"] = n
            preempting_now = 0
            for s in self._slots:
                if s is None:
                    continue
                pri = s.pending.priority
                classes.setdefault(pri, {"queued": 0, "active": 0})
                classes[pri]["active"] += 1
                if s.preempting:
                    preempting_now += 1
            out["sched"] = {
                "policy": self.config.sched,
                "preempt": self.config.preempt,
                "preempt_margin_ms": self.config.preempt_margin_ms,
                "classes": {str(k): v for k, v in sorted(classes.items())},
                "preempting_now": preempting_now,
                "parked_waiting": sum(1 for q in self._queue if q.preempted),
                "preempt_parked": self._preempt_parked,
                "preempt_resumed": self._preempt_resumed,
                "preempt_aborted": self._preempt_aborted,
            }
            return out

    # --------------------------------------------------------- decode loop

    def _class_delta(self, priority: int, d: int) -> None:
        """Queue-change bookkeeping for one priority class (under ``_cv``):
        keeps the per-class counts and the ``serve_sched_queue_depth``
        gauge in lockstep with the queue itself."""
        n = self._class_queued.get(priority, 0) + d
        if n <= 0:
            self._class_queued.pop(priority, None)
            n = 0
        else:
            self._class_queued[priority] = n
        self.metrics.sched_queue_depth.set(str(priority), n)

    def _clear_queue_classes(self) -> None:
        """Zero every per-class gauge after a bulk queue strip (stream
        export, non-drain close)."""
        for pri in list(self._class_queued):
            self.metrics.sched_queue_depth.set(str(pri), 0)
        self._class_queued.clear()

    def _pop_next_locked(self) -> _Pending:
        """Take the next admission from the queue under the configured
        policy. FIFO pops the head; EDF scans for the most urgent entry —
        lowest priority class first, earliest deadline within the class
        (deadline-less entries sort behind every deadline holder), FIFO
        order as the final tie-break. O(queue) per admission, bounded by
        ``max_queue``."""
        if self.config.sched == "fifo" or len(self._queue) == 1:
            p = self._queue.popleft()
        else:
            best_ix, best_key = 0, None
            for ix, q in enumerate(self._queue):
                key = (
                    q.priority,
                    q.deadline_abs if q.deadline_abs is not None
                    else float("inf"),
                    q.t_enqueue,
                )
                if best_key is None or key < best_key:
                    best_key, best_ix = key, ix
            p = self._queue[best_ix]
            del self._queue[best_ix]
        self._class_delta(p.priority, -1)
        return p

    def _steppable(self, s: _Slot | None) -> bool:
        """Include the slot in the next decode step? Occupied, fully
        prefilled, and not every requested token already dispatched (a
        slot whose last tokens are still in flight rides along inactive
        until they fetch). A slot with a verify step in flight is parked
        until the verdict lands, and a preemption victim stops taking new
        steps so its in-flight work can settle and park."""
        return (
            s is not None
            and not s.prefilling
            and not s.verifying
            and not s.preempting
            and s.n_dispatched < s.max_new
        )

    def _take_work(self):
        """Block until there is something to dispatch; returns ``("work",
        admissions, chunk_rows, step, verify, adopts, stream_rows,
        park_rows)`` — any may be empty/None — or ``("export", ...)`` when
        a stream export quiesced, or None when closed and fully drained.
        All bookkeeping (slot assignment, trie match, chunk/length
        advance, draft assembly, preemption mark/park) happens HERE under
        ``_cv``; the caller just dispatches.

        On a chunked engine an admission does NOT dispatch a prefill:
        the slot enters ``prefilling`` (its prompt possibly shortened by a
        pinned prefix-cache match) and each loop iteration plans at most
        ONE chunk batch — up to ``admit_cap`` rows, one ``chunk_size``
        slice each — followed by a decode step over the fully-prefilled
        slots. That interleaving is what bounds decode ITL during
        long-prompt admission to one chunk's compute.

        On a speculative engine each iteration additionally plans at most
        ONE verify batch covering every speculating slot that has a
        non-empty draft and no outstanding steps (spec-mode slots advance
        at fetch, so in-order slots always satisfy ``n_dispatched ==
        len(tokens)``; a slot with a draft in hand waits for its
        pipelined plain steps to drain first). Empty-draft and backed-off
        slots keep riding the plain pipelined decode step — speculation
        only ever trades pipelining for verify width when the drafter
        actually has a proposal."""
        metrics = self.metrics
        with self._cv:
            while True:
                if (
                    self._closed
                    and not self._queue
                    and not self._stream_adopts
                    and self._n_active == 0
                ):
                    while self._adoptions:
                        *_, fut = self._adoptions.popleft()
                        if not fut.cancelled():
                            fut.set_exception(
                                RuntimeError("batcher closed")
                            )
                    if self._export_req is not None:
                        # Nothing left to export — unblock the waiter.
                        req = self._export_req
                        self._export_req = None
                        req.event.set()
                    return None
                if self._export_req is not None:
                    # Stream export pending: stop dispatching and let the
                    # in-flight steps land, so every slot is SETTLED
                    # (tokens fetched, lengths final, no write in flight)
                    # when the capture runs.
                    if self._n_inflight:
                        self._cv.wait()
                        continue
                    req = self._export_req
                    self._export_req = None
                    exported = []
                    for i, s in enumerate(self._slots):
                        if s is None:
                            continue
                        self._slots[i] = None
                        self._n_active -= 1
                        if self._pool is not None and s.chain is not None:
                            self._pool.release(s.chain)  # idempotent unpin
                        exported.append((i, s))
                    queued = list(self._queue)
                    self._queue.clear()
                    self._clear_queue_classes()
                    adopts_q = list(self._stream_adopts)
                    self._stream_adopts.clear()
                    self._count = 0
                    metrics.queue_depth.set(0)
                    metrics.slots_active.set(self._n_active)
                    return ("export", req, exported, queued, adopts_q)
                # Chain adoptions drain first — a popped adoption's pool
                # insert + page import runs before the NEXT pass's trie
                # matches, so admissions planned after this pass can hit
                # the transferred chain.
                adopts = []
                while self._adoptions:
                    adopts.append(self._adoptions.popleft())
                # Migrated streams claim free slots BEFORE fresh
                # admissions — they are the oldest work in the house, and
                # their slot-import dispatch precedes everything else this
                # pass plans, so the decode step planned below can already
                # include them.
                stream_rows = []
                while self._stream_adopts:
                    free_ix = next(
                        (i for i, s in enumerate(self._slots)
                         if s is None),
                        None,
                    )
                    if free_ix is None:
                        break
                    state, pk, pv, fut = self._stream_adopts.popleft()
                    now = time.monotonic()
                    pend = _Pending(state.replay_payload(),
                                    state.request_id)
                    pend.future = fut
                    pend.t_taken = now
                    slot = _Slot(pend, next(self._gens), pend.payload,
                                 self._default_max_new)
                    # Mid-generation occupant: its pages land via the
                    # slot-import cell (no prefill), so the next decode
                    # step continues at the stream's absolute position.
                    slot.length = state.length
                    slot.n_dispatched = len(slot.tokens)
                    slot.t_first = now
                    slot.t_last_tok = now
                    if self._spec_k:
                        # Fresh SlotSpec: spec state resets cleanly on
                        # migration (drafting history is rebuilt from
                        # prompt + accumulated tokens, EMA starts over).
                        slot.spec = SlotSpec(self._spec_cfg)
                        slot.prompt_ids = [
                            int(t) for t in state.input_ids
                        ]
                    slot.slot_id = free_ix
                    self._slots[free_ix] = slot
                    self._n_active += 1
                    stream_rows.append((free_ix, slot, pk, pv))
                if stream_rows:
                    metrics.slots_active.set(self._n_active)
                # -------------------------------------- priority preemption
                # MARK: when a queued deadline holder would miss its
                # deadline waiting for a natural slot free, pick a strictly
                # lower-priority occupant per uncovered urgent waiter and
                # flag it. A marked victim takes no further chunk/verify/
                # decode dispatches (see _steppable); it PARKS below once
                # its in-flight steps settle. Already-marked and exempt
                # slots count as arriving capacity, so one waiter never
                # marks the whole table.
                if self.config.preempt and self._queue:
                    free_n = sum(1 for s in self._slots if s is None)
                    marked_n = sum(
                        1 for s in self._slots
                        if s is not None and s.preempting
                    )
                    now = time.monotonic()
                    margin = self.config.preempt_margin_ms / 1e3
                    urgent = sorted(
                        (q for q in self._queue
                         if q.deadline_abs is not None
                         and now + margin >= q.deadline_abs),
                        key=lambda q: (q.priority, q.deadline_abs,
                                       q.t_enqueue),
                    )
                    need = len(urgent) - free_n - marked_n
                    for w in urgent:
                        if need <= 0:
                            break
                        victim = None
                        for s in self._slots:
                            if (
                                s is None
                                or s.preempting
                                or s.preempt_exempt
                                or s.pending.priority <= w.priority
                            ):
                                continue
                            # Lowest-urgency class first; within it, the
                            # occupant with the least generated progress
                            # (cheapest park + re-prefill round trip).
                            if victim is None or (
                                s.pending.priority,
                                -len(s.tokens),
                            ) > (
                                victim.pending.priority,
                                -len(victim.tokens),
                            ):
                                victim = s
                        if victim is None:
                            continue
                        victim.preempting = True
                        need -= 1
                # PARK: settle-and-evict every marked victim whose steps
                # have landed. The victim's client future survives — its
                # _Pending re-enqueues with the generated tokens as
                # resume_tokens (the replay contract: bit-identical
                # by (seed, absolute position) sampling) — and, when the
                # prefix pool can hold the full settled sequence, the
                # slot's KV lane publishes into parked pool pages first so
                # the resume's re-prefill is a near-pure cache hit. A pool
                # too full to cover the whole parked sequence ABORTS the
                # preemption instead (the victim finishes; it is never
                # lost) — re-prefilling against garbage or half-parked
                # pages is how bit-parity dies.
                park_rows = []
                if self.config.preempt:
                    for i, s in enumerate(self._slots):
                        if s is None or not s.preempting:
                            continue
                        if s.prefilling:
                            # Mid-prefill victims park page-less NOW: any
                            # in-flight chunk's completion drops on the
                            # gen tag, nothing generated is lost (tokens
                            # == the resume prefix it arrived with), and
                            # the pinned prefix match unpins below.
                            settled = True
                        else:
                            settled = (
                                not s.verifying
                                and s.n_dispatched == len(s.tokens)
                            )
                        if not settled:
                            continue
                        p = s.pending
                        reason, new_blocks = "pageless", []
                        if (
                            not s.prefilling
                            and s.tokens
                            and self._pool is not None
                            and callable(getattr(
                                self._engine, "insert_prefix", None
                            ))
                        ):
                            # Settled lane covers positions 0..length-1
                            # (the newest token's KV is written by the
                            # step that was never dispatched).
                            key = (
                                s.full_prompt + s.tokens[len(s.resume):]
                            )[: s.length]
                            cap = getattr(self._engine, "_max_chain", None)
                            if cap is not None:
                                key = key[: cap * self._pool.block_tokens]
                            want = len(key) // self._pool.block_tokens
                            if want > 0:
                                # Lock order _cv -> pool, same as the
                                # admission trie match.
                                new_blocks, covered = self._pool.index(key)
                                if covered >= want:
                                    reason = "paged"
                                else:
                                    # Park-pool-full: whatever prefix DID
                                    # index still gets its page copy below
                                    # (it is valid data the pool now
                                    # advertises), but the victim keeps
                                    # its slot and finishes. Exempt, so
                                    # the next pass marks someone else.
                                    s.preempting = False
                                    s.preempt_exempt = True
                                    self._preempt_aborted += 1
                                    park_rows.append(
                                        ("abort", i, s, "park_full",
                                         new_blocks)
                                    )
                                    continue
                        if reason == "pageless" and not self._chunked:
                            # Monolithic prefill buckets the resumed
                            # prompt (original + every generated token);
                            # an un-bucketable resume cannot replay here.
                            try:
                                self._engine.bucket_for(
                                    s.prompt_len + len(s.tokens)
                                )
                            except Exception:  # noqa: BLE001
                                s.preempting = False
                                s.preempt_exempt = True
                                self._preempt_aborted += 1
                                park_rows.append(
                                    ("abort", i, s, "bucket_overflow", [])
                                )
                                continue
                        pl = dict(p.payload)
                        if s.tokens:
                            pl["resume_tokens"] = [int(t) for t in s.tokens]
                        p.payload = pl
                        p.preempted += 1
                        self._slots[i] = None
                        self._n_active -= 1
                        if self._pool is not None and s.chain is not None:
                            self._pool.release(s.chain)  # idempotent unpin
                        self._queue.append(p)
                        self._count += 1
                        self._class_delta(p.priority, +1)
                        self._preempt_parked += 1
                        park_rows.append(("park", i, s, reason, new_blocks))
                    if park_rows:
                        metrics.queue_depth.set(self._count)
                        metrics.slots_active.set(self._n_active)
                admissions = []
                free = [
                    i for i, s in enumerate(self._slots) if s is None
                ]
                may_admit = self._queue and free and (
                    self._admission == "continuous" or self._n_active == 0
                )
                if may_admit:
                    now = time.monotonic()
                    for slot_id in free[: min(len(self._queue),
                                              self._admit_cap)]:
                        p = self._pop_next_locked()
                        self._count -= 1
                        if p.preempted:
                            self._preempt_resumed += 1
                        p.t_taken = now  # queue_wait phase ends here
                        slot = _Slot(
                            p, next(self._gens), p.payload,
                            self._default_max_new,
                        )
                        if self._chunked:
                            slot.prefilling = True
                            if self._pool is not None:
                                # Lock order _cv -> pool (never reversed);
                                # the match pins its chain until the
                                # gather chunk dispatches. A resumed
                                # stream matches on its FULL effective
                                # prompt (original + resume tokens).
                                m = self._pool.match(slot.full_prompt)
                                slot.chain = m
                                slot.cached_len = m.cached_len
                                metrics.prefix_lookups.inc()
                                if m.cached_len:
                                    metrics.prefix_hits.inc()
                                    metrics.prefix_tokens_saved.inc(
                                        m.cached_len
                                    )
                            slot.chunk_pos = slot.cached_len
                        else:
                            # Prefill's first sampled token (resumed
                            # tokens are pre-seeded, not dispatched).
                            slot.n_dispatched = len(slot.tokens) + 1
                        if self._spec_k:
                            slot.spec = SlotSpec(self._spec_cfg)
                            slot.prompt_ids = [
                                int(t) for t in p.payload["input_ids"]
                            ]
                        slot.slot_id = slot_id
                        self._slots[slot_id] = slot
                        self._n_active += 1
                        admissions.append((slot_id, slot))
                    metrics.queue_depth.set(self._count)
                    metrics.slots_active.set(self._n_active)
                chunk_rows = None
                if self._chunked:
                    planned = []
                    for i, s in enumerate(self._slots):
                        if s is None or not s.prefilling:
                            continue
                        if len(planned) >= self._admit_cap:
                            break
                        start = s.chunk_pos
                        n = min(self._chunk_size, s.admit_len - start)
                        s.chunk_pos = start + n
                        final = s.chunk_pos >= s.admit_len
                        first = start == s.cached_len
                        if final:
                            s.prefilling = False
                            # First token rides the final chunk (resumed
                            # tokens are pre-seeded, not dispatched).
                            s.n_dispatched = len(s.tokens) + 1
                        planned.append(
                            (i, s, start, n, first, final)
                        )
                    if planned:
                        chunk_rows = planned
                verify = None
                spec_plain: set[int] = set()
                if self._spec_k:
                    # One verify batch over every speculating slot.
                    # Drafting happens here under _cv (the drafter is a
                    # pure function of slot state). A slot whose draft
                    # comes up EMPTY takes a plain (pipelined) decode row
                    # this step instead — a k=0 verify would just be a
                    # non-overlapped decode step — and the missed
                    # opportunity feeds the acceptance EMA so undraftable
                    # streams back off entirely WITHOUT ever paying the
                    # drain stall: only a slot with a draft actually
                    # worth verifying waits for its in-flight plain
                    # steps to land (and re-drafts against the full
                    # history once they have).
                    vrows = []
                    for i, s in enumerate(self._slots):
                        if (
                            not self._steppable(s)
                            or s.spec is None
                            or not s.spec.speculating
                            # Prefill token still in flight: drafts anchor
                            # on the GENERATED history (the match that
                            # matters most appears right after the first
                            # token), so don't burn the step on a
                            # prompt-only draft — wait the one fetch.
                            or not s.tokens
                        ):
                            continue
                        # Never draft past the generation budget (the
                        # verified token always emits, so at most
                        # max_new - emitted - 1 drafts can matter) or
                        # the cache (positions length..length+d must
                        # stay writable).
                        cap = min(
                            s.max_new - len(s.tokens) - 1,
                            self._cache_len - 1 - s.length,
                        )
                        d = s.spec.propose(s.prompt_ids + s.tokens, cap)
                        if not d:
                            flip = s.spec.record(0, 0)
                            if flip is not None:
                                self._plan_events.append((
                                    s.pending.request_id, i, flip,
                                    s.spec.ema,
                                ))
                            spec_plain.add(i)
                            continue
                        if s.n_dispatched != len(s.tokens):
                            # Draft in hand but plain steps still in
                            # flight: stall one pass to drain (history
                            # is missing the in-flight tokens, so the
                            # draft re-proposes once they land).
                            continue
                        vrows.append((i, s, d))
                    if vrows:
                        n = len(self._slots)
                        drafts = [[0] * self._spec_k for _ in range(n)]
                        vlengths = [0] * n
                        n_input = [0] * n
                        vtemps = [0.0] * n
                        vseeds = [0] * n
                        vtags = []
                        for i, s, d in vrows:
                            drafts[i][: len(d)] = [int(t) for t in d]
                            vlengths[i] = s.length
                            n_input[i] = len(d) + 1
                            vtemps[i] = s.temperature
                            vseeds[i] = s.seed
                            s.draft = d
                            s.verifying = True  # length advances at FETCH
                            vtags.append((i, s.gen))
                        verify = (
                            drafts, vlengths, n_input, vtemps, vseeds, vtags
                        )
                step = None
                rows = [
                    (i, s) for i, s in enumerate(self._slots)
                    if self._steppable(s)
                    # Spec-mode slots route through verify (a probe-due
                    # backed-off slot drains here too) unless this step's
                    # draft came up empty; backed-off and empty-draft
                    # slots ride the pipelined plain path.
                    and (
                        s.spec is None
                        or not s.spec.speculating
                        or i in spec_plain
                    )
                ]
                if rows:
                    n = len(self._slots)
                    lengths = [0] * n
                    active = [False] * n
                    temps = [0.0] * n
                    seeds = [0] * n
                    tags = []
                    for i, s in rows:
                        lengths[i] = s.length
                        active[i] = True
                        temps[i] = s.temperature
                        seeds[i] = s.seed
                        s.length += 1         # advances at dispatch: steps
                        s.n_dispatched += 1   # pipeline without the fetch
                        tags.append((i, s.gen))
                        if s.spec is not None:
                            s.spec.note_plain_step()  # probe clock
                    step = (lengths, active, temps, seeds, tags)
                if (admissions or chunk_rows or step or verify or adopts
                        or stream_rows or park_rows):
                    return ("work", admissions, chunk_rows, step, verify,
                            adopts, stream_rows, park_rows)
                self._cv.wait()

    def _fail_slots(self, tagged: list[tuple[int, int]],
                    exc: BaseException) -> None:
        """Fail + free the (slot, gen) occupants (engine dispatch/fetch
        blew up under them)."""
        metrics = self.metrics  # local: instruments carry their own locks
        victims = []
        with self._cv:
            for slot_id, gen in tagged:
                s = self._slots[slot_id]
                if s is None or s.gen != gen:
                    continue
                self._slots[slot_id] = None
                self._n_active -= 1
                if self._pool is not None and s.chain is not None:
                    self._pool.release(s.chain)  # idempotent unpin
                victims.append((slot_id, s.pending))
            metrics.slots_active.set(self._n_active)
            self._cv.notify_all()
        if not victims:
            return
        metrics.errors.inc()
        metrics.rejected_by_cause.inc("engine_failure", len(victims))
        if metrics.windowed:
            metrics.bad_w.add(float(len(victims)))
        for slot_id, p in victims:
            self.tracer.instant(
                "engine_failure", "serve", request_id=p.request_id,
                error=type(exc).__name__,
            )
            self.recorder.record(
                "engine_failure", p.request_id, slot=slot_id,
                error=type(exc).__name__,
            )
            self.recorder.record("slot_free", p.request_id, slot=slot_id,
                                 cause="engine_failure")
            if not p.future.cancelled():
                p.future.set_exception(exc)
        logger.warning(
            "decode dispatch failed (%s): request_ids=%s",
            type(exc).__name__, [p.request_id for _, p in victims],
        )
        self.recorder.trigger("engine_failure")

    def _loop(self):
        engine = self._engine
        while True:
            work = self._take_work()
            if work is None:
                self._completion.put(None)  # unblock the fetch thread
                return
            if work[0] == "export":
                _, req, exported, queued, adopts_q = work
                self._service_export(req, exported, queued, adopts_q)
                continue
            (_, admissions, chunk_rows, step, verify, adopts, stream_rows,
             park_rows) = work
            if stream_rows:
                # Slot-page import dispatches FIRST: the adopted slots may
                # already ride this pass's verify/decode step, and stream
                # order guarantees their lanes hold the migrated KV before
                # anything reads them.
                for slot_id, s, pk, pv in stream_rows:
                    try:
                        engine.import_slot_pages(
                            slot_id, pk, pv, int(s.tokens[-1])
                        )
                    except Exception as e:  # noqa: BLE001 — fail the stream, not the loop
                        self._fail_slots([(slot_id, s.gen)], e)
                        continue
                    self.recorder.record(
                        "slot_alloc", s.pending.request_id, slot=slot_id,
                        prompt_len=s.prompt_len, migrated=True,
                    )
            if adopts:
                # Between-steps adoption (serve/disagg.py): index the
                # chain in the pool, then write received pages into the
                # freshly allocated blocks BEFORE anything else this pass
                # dispatches — the import is in the stream ahead of any
                # later chunk that could gather those blocks, so the
                # kvpool publish-before-match contract holds.
                for token_ids, pages_k, pages_v, fut in adopts:
                    try:
                        new = self._pool.insert(token_ids)
                        if new and pages_k is not None:
                            engine.import_prefix_pages(new, pages_k, pages_v)
                        self.metrics.kv_pool_bytes.set(
                            self._pool.stats()["bytes_used"]
                        )
                    except Exception as e:  # noqa: BLE001 — fail the adoption, not the loop
                        if not fut.cancelled():
                            fut.set_exception(e)
                    else:
                        if not fut.cancelled():
                            fut.set_result(len(new))
            if park_rows:
                # Park-publish dispatches BEFORE any admission prefill or
                # chunk gather this pass: insert_prefix copies the parked
                # victim's lane pages into its freshly indexed pool blocks,
                # and stream order guarantees the copy reads the lane (and
                # fills the blocks a same-pass re-admission may already
                # have matched) before anything overwrites or gathers
                # them. Bookkeeping already happened under _cv.
                for what, slot_id, s, reason, new_blocks in park_rows:
                    if new_blocks:
                        try:
                            engine.insert_prefix(slot_id, new_blocks)
                        except Exception:  # noqa: BLE001 — pool keeps the
                            # blocks; their bytes are stale, so drop them
                            # from the trie rather than serve garbage.
                            logger.exception(
                                "park-publish of slot %d failed; evicting "
                                "the parked chain", slot_id,
                            )
                            self._pool.forget(
                                (s.full_prompt + s.tokens[len(s.resume):])
                                [: s.length]
                            )
                        else:
                            self.metrics.kv_pool_bytes.set(
                                self._pool.stats()["bytes_used"]
                            )
                    if what == "park":
                        self.metrics.preemptions.inc(reason)
                        self.recorder.record(
                            "slot_preempt", s.pending.request_id,
                            slot=slot_id, reason=reason,
                            n_tokens=len(s.tokens),
                            parked_blocks=len(new_blocks),
                        )
                    else:
                        self.metrics.preemptions.inc(reason)
                        self.recorder.record(
                            "slot_preempt", s.pending.request_id,
                            slot=slot_id, reason=reason, aborted=True,
                            n_tokens=len(s.tokens),
                        )
            if self._plan_events:
                # Backoff flips noted while planning (same thread, so no
                # lock needed); recorded here, outside _cv.
                for req_id, slot_id, flip, ema in self._plan_events:
                    self.recorder.record(
                        "spec_backoff", req_id, slot=slot_id,
                        engaged=(flip == "engage"),
                        acceptance=round(ema, 4),
                    )
                self._plan_events.clear()
            if admissions:
                self.metrics.batches.inc()
                self.metrics.batch_occupancy.observe(len(admissions))
                if self.recorder.enabled:
                    # Outside _cv: _take_work already published the slots.
                    for i, s in admissions:
                        self.recorder.record(
                            "slot_alloc", s.pending.request_id,
                            slot=i, prompt_len=s.prompt_len,
                        )
                        if s.pending.preempted:
                            self.recorder.record(
                                "slot_resume", s.pending.request_id,
                                slot=i, rounds=s.pending.preempted,
                                resume_tokens=len(s.resume),
                                cached_tokens=s.cached_len,
                            )
                        if s.cached_len:
                            self.recorder.record(
                                "prefix_hit", s.pending.request_id,
                                slot=i, cached_tokens=s.cached_len,
                            )
            if admissions and not self._chunked:
                self._inflight_sem.acquire()
                tags = [(i, s.gen) for i, s in admissions]
                try:
                    handle = engine.prefill([
                        {
                            "slot": i,
                            "input_ids": s.full_prompt,
                            "temperature": s.temperature,
                            "seed": s.seed,
                        }
                        for i, s in admissions
                    ])
                except Exception as e:  # noqa: BLE001 — fail the rows, not the server
                    # Fail ONLY the admitted rows; the step planned below
                    # still dispatches (its bookkeeping already advanced,
                    # and the failed slots' lanes are dead via the gen tag).
                    self._inflight_sem.release()
                    self._fail_slots(tags, e)
                else:
                    with self._cv:
                        self._n_inflight += 1
                        self.metrics.in_flight.set(self._n_inflight)
                    self._completion.put(
                        ("prefill", tags, handle, time.monotonic())
                    )
            if chunk_rows:
                self._inflight_sem.acquire()
                tags = [(i, s.gen) for i, s, *_ in chunk_rows]
                try:
                    handle = engine.prefill_chunks([
                        {
                            "slot": i,
                            "input_ids": s.full_prompt,
                            "start": start,
                            "n_tokens": n,
                            "length": s.admit_len,
                            "chain": (
                                s.chain.blocks
                                if first and s.chain is not None else ()
                            ),
                            "temperature": s.temperature,
                            "seed": s.seed,
                        }
                        for i, s, start, n, first, final in chunk_rows
                    ])
                except Exception as e:  # noqa: BLE001
                    self._inflight_sem.release()
                    self._fail_slots(tags, e)
                else:
                    with self._cv:
                        self._n_inflight += 1
                        self.metrics.in_flight.set(self._n_inflight)
                    # Prefix bookkeeping AFTER the dispatch is enqueued:
                    # the gather is in the stream, so pins drop (a later
                    # insert may evict + rewrite those pages — stream
                    # order keeps the gather reading the old bytes), and
                    # a final chunk's completed pages publish to the pool
                    # BEFORE the chunk's completion is queued: once its
                    # future resolves the chain's pages are written (or in
                    # the stream ahead of anything issued later), so a
                    # transfer that exports the chain right after the
                    # prefill (serve/disagg.py) never reads a block the
                    # trie indexed but the publish had not filled yet.
                    if self._pool is not None:
                        touched = False
                        for i, s, start, n, first, final in chunk_rows:
                            if first and s.chain is not None:
                                self._pool.release(s.chain)
                            if final:
                                # A resumed stream's effective prompt
                                # (prompt + resume_tokens) can run past
                                # the engine's publishable chain; publish
                                # the longest prefix the insert cell
                                # carries rather than raise on the loop
                                # thread.
                                key = s.full_prompt
                                cap = getattr(engine, "_max_chain", None)
                                if cap is not None:
                                    key = key[
                                        : cap * self._pool.block_tokens
                                    ]
                                new = self._pool.insert(key)
                                if new:
                                    engine.insert_prefix(i, new)
                                touched = True
                        if touched:
                            self.metrics.kv_pool_bytes.set(
                                self._pool.stats()["bytes_used"]
                            )
                    self._completion.put(
                        (
                            "chunk",
                            [
                                (i, s.gen, final)
                                for i, s, _, _, _, final in chunk_rows
                            ],
                            handle,
                            time.monotonic(),
                        )
                    )
            if verify:
                # Dispatched BEFORE the decode step: the planned verify
                # rows are parked (verifying=True) and would wedge if a
                # decode failure's `continue` skipped their dispatch.
                drafts, vlengths, n_input, vtemps, vseeds, vtags = verify
                self._inflight_sem.acquire()
                try:
                    handle = engine.verify(
                        drafts, vlengths, n_input, vtemps, vseeds
                    )
                except Exception as e:  # noqa: BLE001
                    self._inflight_sem.release()
                    self._fail_slots(vtags, e)
                else:
                    with self._cv:
                        self._n_inflight += 1
                        self.metrics.in_flight.set(self._n_inflight)
                    self._completion.put(
                        ("verify", vtags, handle, time.monotonic())
                    )
            if step:
                lengths, active, temps, seeds, tags = step
                inj = self.fault_injector
                if inj is not None:
                    # Chaos hooks fire on the decode-step DISPATCH clock:
                    # slow_decode_step sleeps here, replica_kill dumps and
                    # SIGKILLs, dispatch_error raises and exactly this
                    # step's slots fail like a real engine blow-up.
                    self._dispatched_steps += 1
                    try:
                        inj.on_decode_step(self._dispatched_steps)
                    except Exception as e:  # noqa: BLE001 — injected: fail the step's slots
                        self._fail_slots(tags, e)
                        continue
                self._inflight_sem.acquire()
                try:
                    handle = engine.decode(lengths, active, temps, seeds)
                except Exception as e:  # noqa: BLE001
                    self._inflight_sem.release()
                    self._fail_slots(tags, e)
                    continue
                with self._cv:
                    self._n_inflight += 1
                    self.metrics.in_flight.set(self._n_inflight)
                self._completion.put(
                    ("decode", tags, handle, time.monotonic())
                )

    def _service_export(self, req: _ExportRequest, exported, queued,
                        adopts_q) -> None:
        """Decode-loop thread: turn the quiesced occupants into
        :class:`ExportedStream` records — gathering each settled decoding
        slot's KV lane through the engine's slot-export cell — then wake
        the ``export_streams`` caller. Streams without exportable pages
        (still prefilling, queued, or a migration-less engine) export as
        page-less states that replay via ``resume_tokens``."""
        engine = self._engine
        can_pages = getattr(engine, "stream_migrate", False)
        out: list[ExportedStream] = []
        for slot_id, s in exported:
            p = s.pending
            state = StreamState(
                request_id=p.request_id,
                input_ids=[int(t) for t in p.payload["input_ids"]],
                tokens=list(s.tokens),
                seed=s.seed,
                temperature=s.temperature,
                eos_id=s.eos_id,
                max_new_tokens=s.max_new,
                length=s.length,
            )
            pk = pv = None
            if can_pages and not s.prefilling and s.tokens:
                try:
                    pk, pv = engine.export_slot_pages(slot_id)
                except Exception:  # noqa: BLE001 — degrade to page-less replay
                    logger.exception(
                        "slot %d page export failed; stream %s migrates "
                        "page-less", slot_id, p.request_id,
                    )
                    pk = pv = None
            if pk is None:
                state.length = 0  # page-less: the replay re-prefills
            out.append(ExportedStream(state, pk, pv, p.future))
            self.recorder.record(
                "stream_export", p.request_id, slot=slot_id,
                n_tokens=len(s.tokens), pages=pk is not None,
            )
        for p in queued:
            pl = p.payload
            eos = pl.get("eos_id")
            state = StreamState(
                request_id=p.request_id,
                input_ids=[int(t) for t in pl["input_ids"]],
                tokens=[int(t) for t in pl.get("resume_tokens", ())],
                seed=int(pl.get("seed", 0)),
                temperature=float(pl.get("temperature", 0.0)),
                eos_id=None if eos is None else int(eos),
                max_new_tokens=int(
                    pl.get("max_new_tokens", self._default_max_new)
                ),
            )
            out.append(ExportedStream(state, None, None, p.future))
            self.recorder.record(
                "stream_export", p.request_id, queued=True, pages=False,
            )
        for state, pk, pv, fut in adopts_q:
            # A migrated-in stream caught mid-handoff migrates onward
            # with the pages it arrived with.
            out.append(ExportedStream(state, pk, pv, fut))
            self.recorder.record(
                "stream_export", state.request_id, queued=True,
                pages=pk is not None,
            )
        req.results = out
        req.event.set()

    # ---------------------------------------------------------- completion

    def _append_token(self, slot_id: int, s: _Slot, token: int,
                      t_got: float, finished: list) -> None:
        """Record one fetched token; on eos/max_new, resolve the future and
        free the slot IMMEDIATELY (in-flight steps for the old occupant are
        dropped by the gen tag; their cache writes are dead stores)."""
        s.tokens.append(token)
        s.t_last_tok = t_got
        done = (
            len(s.tokens) >= s.max_new
            or (s.eos_id is not None and token == s.eos_id)
        )
        if done:
            self._slots[slot_id] = None
            self._n_active -= 1
            if self._pool is not None and s.chain is not None:
                self._pool.release(s.chain)  # idempotent: normally
            finished.append(s)               # already unpinned at dispatch

    def _resolve(self, finished: list[_Slot], now: float) -> None:
        """Resolve finished occupants' futures outside ``_cv`` with the
        DynamicBatcher delivery contract: contiguous phases, exact
        ``latency_s``, batch-held metric locks, metrics before futures."""
        metrics, tracer = self.metrics, self.tracer
        latencies = []
        phase_values: dict[str, list[float]] = {}
        for s in finished:
            p = s.pending
            latency = now - p.t_enqueue
            metrics.latency.observe(latency)
            latencies.append(latency)
            p.future.latency_s = latency
            phases = {
                "queue_wait": p.t_taken - p.t_enqueue,
                "prefill": s.t_first - p.t_taken,
                "decode": now - s.t_first,
            }
            for name, dt in phases.items():
                phase_values.setdefault(name, []).append(dt)
            p.future.phases = phases
            tracer.record("request", p.t_enqueue, now, cat="serve",
                          request_id=p.request_id)
            tracer.record("queue_wait", p.t_enqueue, p.t_taken, cat="serve",
                          request_id=p.request_id)
            tracer.record("prefill", p.t_taken, s.t_first, cat="serve",
                          request_id=p.request_id)
            tracer.record("decode", s.t_first, now, cat="serve",
                          request_id=p.request_id)
        for name, vals in phase_values.items():
            metrics.observe_phase_batch(name, vals, self._layout, now)
        if metrics.windowed:
            metrics.latency_w.observe_many(latencies, now)
            metrics.ok_w.add(float(len(finished)), now)
        for s in finished:
            p = s.pending
            if not p.future.cancelled():
                p.future.set_result({
                    "tokens": list(s.tokens),
                    "n_tokens": len(s.tokens),
                    "prompt_len": s.prompt_len,
                    "bucket": self._engine.bucket_for(s.prompt_len),
                })
        with self._cv:
            self._served += len(finished)
        if self.recorder.enabled:
            for s in finished:
                self.recorder.record("slot_free", s.pending.request_id,
                                     slot=s.slot_id)
                self.recorder.record(
                    "request_complete", s.pending.request_id,
                    slot=s.slot_id, n_tokens=len(s.tokens),
                    latency_ms=round((now - s.pending.t_enqueue) * 1e3, 3),
                )

    def _completion_loop(self):
        engine, metrics = self._engine, self.metrics
        while True:
            item = self._completion.get()
            if item is None:
                return
            kind, tags, handle, t_disp = item
            try:
                tok = engine.fetch_step(handle)
            except Exception as e:  # noqa: BLE001
                self._fail_slots(
                    [(t[0], t[1]) for t in tags] if kind == "chunk"
                    else tags, e,
                )
                with self._cv:
                    self._n_inflight -= 1
                    metrics.in_flight.set(self._n_inflight)
                self._inflight_sem.release()
                continue
            t_got = getattr(handle, "t_got", 0.0) or time.monotonic()
            finished: list[_Slot] = []
            itls: list[float] = []
            ttfts: list[float] = []
            n_tokens = 0
            slot_steps = 0
            drafted = accepted = v_rejects = 0
            spec_events: list[tuple[str, int, str, float]] = []
            with self._cv:
                if kind == "prefill":
                    for r, (slot_id, gen) in enumerate(tags):
                        s = self._slots[slot_id]
                        if s is None or s.gen != gen:
                            continue
                        s.t_first = t_got
                        ttfts.append(t_got - s.pending.t_enqueue)
                        n_tokens += 1
                        self._append_token(
                            slot_id, s, int(tok[r]), t_got, finished
                        )
                elif kind == "chunk":
                    # Only rows whose chunk completed the prompt carry a
                    # sampled first token; mid-prompt rows' lanes are
                    # garbage by design and nothing reads them.
                    for r, (slot_id, gen, final) in enumerate(tags):
                        if not final:
                            continue
                        s = self._slots[slot_id]
                        if s is None or s.gen != gen:
                            continue
                        s.t_first = t_got
                        ttfts.append(t_got - s.pending.t_enqueue)
                        n_tokens += 1
                        self._append_token(
                            slot_id, s, int(tok[r]), t_got, finished
                        )
                elif kind == "verify":
                    # tok is the [slots, k+1] verified-token matrix. The
                    # acceptance rule (longest exact-match prefix) is
                    # recomputed host-side from the slot's own draft; it
                    # agrees with the device's cumprod-match by
                    # construction, so the device last_token stays
                    # coherent without a round-trip.
                    for slot_id, gen in tags:
                        s = self._slots[slot_id]
                        if s is None or s.gen != gen:
                            continue
                        slot_steps += 1
                        s.verifying = False
                        d = s.draft or []
                        s.draft = None
                        m = 0
                        for t in d:
                            if int(tok[slot_id, m]) == int(t):
                                m += 1
                            else:
                                break
                        drafted += len(d)
                        accepted += m
                        if m < len(d):
                            v_rejects += 1
                        flip = s.spec.record(len(d), m)
                        if flip is not None:
                            spec_events.append((
                                s.pending.request_id, slot_id, flip,
                                s.spec.ema,
                            ))
                        # Rollback is free: host length advances only past
                        # the accepted run; the k-m rejected K/V entries
                        # sit beyond `length`, masked dead, and the slot's
                        # next real tokens overwrite them.
                        s.length += m + 1
                        # ITL stays per TOKEN: the emitted run splits the
                        # step's wall interval into m+1 equal samples.
                        dt = (t_got - s.t_last_tok) / (m + 1)
                        for j in range(m + 1):
                            itls.append(dt)
                            n_tokens += 1
                            self._append_token(
                                slot_id, s, int(tok[slot_id, j]), t_got,
                                finished,
                            )
                            if self._slots[slot_id] is not s:
                                break  # eos/max_new mid-run: surplus drops
                        if self._slots[slot_id] is s:
                            s.n_dispatched = len(s.tokens)
                else:
                    for slot_id, gen in tags:
                        s = self._slots[slot_id]
                        if s is None or s.gen != gen:
                            continue
                        slot_steps += 1
                        itls.append(t_got - s.t_last_tok)
                        n_tokens += 1
                        self._append_token(
                            slot_id, s, int(tok[slot_id]), t_got, finished
                        )
                if kind in ("decode", "verify"):
                    # tokens_per_step is per SLOT-step (a decode/verify
                    # execution of one live slot lane), so a plain engine
                    # reads exactly 1.0 and the ratio isolates the
                    # speculation win from batch occupancy.
                    self._steps += slot_steps
                    self._tokens_emitted += n_tokens
                    if kind == "verify":
                        self._spec_drafted += drafted
                        self._spec_accepted += accepted
                        self._spec_rejects += v_rejects
                self._n_inflight -= 1
                metrics.in_flight.set(self._n_inflight)
                metrics.slots_active.set(self._n_active)
                self._cv.notify_all()
            self._inflight_sem.release()
            # Metric recording outside _cv (instruments self-lock), before
            # futures resolve so a joiner sees its own samples.
            if kind == "decode":
                metrics.decode_steps.inc()
                if self.tracer.enabled:
                    self.tracer.record(
                        "decode_step", t_disp, t_got, cat="serve",
                        args={"rows": len(itls)},
                    )
                if itls:
                    metrics.observe_phase_batch(
                        "decode_step", itls, self._layout, t_got
                    )
                    for dt in itls:
                        metrics.itl.observe(dt)
            elif kind == "verify":
                # Same per-token taxonomy as decode_step: the itls list
                # already carries one sample per EMITTED token (each an
                # equal split of its slot's step interval), so phase-sum
                # == wall still holds and ITL percentiles show the
                # speculation win directly.
                if self.tracer.enabled:
                    self.tracer.record(
                        "verify_step", t_disp, t_got, cat="serve",
                        args={"rows": len(tags), "drafted": drafted,
                              "accepted": accepted},
                    )
                if itls:
                    metrics.observe_phase_batch(
                        "verify_step", itls, self._layout, t_got
                    )
                    for dt in itls:
                        metrics.itl.observe(dt)
                if drafted:
                    metrics.draft_tokens.inc(drafted)
                    metrics.accepted_tokens.inc(accepted)
                    if metrics.windowed:
                        metrics.drafted_w.add(float(drafted), t_got)
                        metrics.accepted_w.add(float(accepted), t_got)
                if v_rejects:
                    metrics.spec_rejects.inc(v_rejects)
                for req_id, slot_id, flip, ema in spec_events:
                    self.recorder.record(
                        "spec_backoff", req_id, slot=slot_id,
                        engaged=(flip == "engage"),
                        acceptance=round(ema, 4),
                    )
            elif kind == "chunk":
                # Batch-level span/phase twin of decode_step: one sample
                # per chunk dispatch. Per-request phases stay the
                # contiguous queue_wait -> prefill -> decode (a request's
                # prefill span covers all its chunks), so phase-sum ==
                # wall latency still holds by construction.
                metrics.observe_phase_batch(
                    "prefill_chunk", [t_got - t_disp], self._layout, t_got
                )
                if self.tracer.enabled:
                    self.tracer.record(
                        "prefill_chunk", t_disp, t_got, cat="serve",
                        args={"rows": len(tags)},
                    )
            for dt in ttfts:
                metrics.ttft.observe(dt)
            if n_tokens:
                metrics.tokens.inc(n_tokens)
                if metrics.windowed:
                    metrics.tokens_w.add(float(n_tokens), t_got)
            if finished:
                self._resolve(finished, t_got)

    def close(self, drain: bool = True, join_timeout_s: float = 30.0) -> None:
        """Stop the decode loop. ``drain=True`` admits + finishes what's
        queued first; otherwise queued futures fail (in-flight sequences
        still run to completion — their slots empty the table, which is
        what lets the loop exit)."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            if not drain:
                while self._queue:
                    p = self._queue.popleft()
                    p.future.set_exception(RuntimeError("batcher closed"))
                self._clear_queue_classes()
                while self._stream_adopts:
                    *_, fut = self._stream_adopts.popleft()
                    if not fut.cancelled():
                        fut.set_exception(RuntimeError("batcher closed"))
                self._count = 0
                self.metrics.queue_depth.set(0)
            self._cv.notify_all()
        self._thread.join(timeout=join_timeout_s)
        self._fetch_thread.join(timeout=join_timeout_s)
        stuck = [
            t.name
            for t in (self._thread, self._fetch_thread)
            if t.is_alive()
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
