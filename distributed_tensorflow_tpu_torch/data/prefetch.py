"""Asynchronous feed stage: bounded background-thread prefetch.

Port of the JAX package's ``data/prefetch.py`` (which is JAX-free): the
same module, reading the port's :class:`FeedMetrics`. Here the wrapped
producer's device placement is a ``tensor.to(device)`` copy, run on the
feeder thread like the rest of the assembly.

The reference fed each worker's ``sess.run`` from queue runners — input
assembly ran on background threads and the step never waited on the host in
steady state (SURVEY.md §3b). The rebuild's explicit SPMD loaders lost that
overlap: every producer in this package does numpy assembly *and* the
host→device transfer inline in ``next()``. This module restores the overlap
as a composable stage: :func:`prefetch` wraps any batch iterator
(``device_batches``, the text/BERT producers, the native C++ pipeline
stream) with a feeder thread that runs the wrapped producer ``depth``
batches ahead, so stages (1) host assembly, (2) host→device transfer, and
(3) device compute pipeline instead of serializing — the tf.data
``prefetch(AUTOTUNE)`` discipline applied to our loaders.

Determinism contract: the wrapped producer is consumed **in order by
exactly one feeder thread**, and batches cross a FIFO queue, so batch ``k``
is still a pure function of ``(seed, k)`` — ``prefetch(it, 0)`` and
``prefetch(it, N)`` yield bit-identical streams, and checkpoint resume via
the producers' ``start_step`` composes unchanged (the wrapper never skips
or reorders).

Error handling: a feeder-thread exception is re-raised by the consumer's
very next ``__next__`` after the buffered good batches drain — the loop
fails loudly, never hangs. ``close()`` stops the thread and closes the
wrapped producer (releasing e.g. the native pipeline's C++ worker pool).
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from collections.abc import Iterable, Iterator

from distributed_tensorflow_tpu_torch.obs.metrics import FeedMetrics

logger = logging.getLogger(__name__)

_ITEM, _END, _ERROR = 0, 1, 2


class PrefetchIterator:
    """Iterator running ``source`` on a feeder thread, ``depth`` batches ahead.

    The feeder does everything the wrapped producer does inline — numpy
    assembly and device placement — off the consumer's critical
    path, bounded by a ``depth``-slot FIFO queue (bounded, so a stalled
    consumer exerts backpressure instead of buffering the whole epoch in
    host RAM). Feeder-side metrics (assembly time, queue depth, batches
    assembled) land in ``self.metrics``; the *consumer* owns the host-wait
    measurement (``metrics.observe_wait``), because only the consumption
    point knows how long the step stream actually stalled.

    Single-consumer: ``__next__`` may be called from one thread at a time
    (the training loop's pull-ahead structure satisfies this by
    construction).
    """

    def __init__(
        self,
        source: Iterable,
        depth: int = 2,
        *,
        metrics: FeedMetrics | None = None,
        name: str = "feed-prefetch",
    ):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.metrics = metrics if metrics is not None else FeedMetrics()
        self.depth = depth
        self._source = source
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._done = False
        # _close_lock makes close() idempotent under concurrent callers:
        # only the winner of the closed check runs the drain/join sequence.
        # The drain itself stays OUTSIDE the lock — holding it across
        # Thread.join would reintroduce the blocking-under-lock hazard.
        self._close_lock = threading.Lock()
        self._closed = False
        self._thread = threading.Thread(target=self._feed, name=name, daemon=True)
        self._thread.start()

    # ---- feeder side -----------------------------------------------------

    def _feed(self) -> None:
        m = self.metrics
        try:
            it = iter(self._source)
            while not self._stop.is_set():
                t0 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    self._enqueue((_END, None))
                    return
                m.assembly.observe(time.perf_counter() - t0)
                m.batches_assembled.inc()
                if not self._enqueue((_ITEM, item)):
                    return
        except BaseException as e:  # noqa: BLE001 — must reach the consumer
            self._enqueue((_ERROR, e))

    def _enqueue(self, msg) -> bool:
        """Bounded put that aborts (returns False) once close() is called."""
        while not self._stop.is_set():
            try:
                self._q.put(msg, timeout=0.05)
            except queue.Full:
                continue
            self.metrics.queue_depth.set(self._q.qsize())
            return True
        return False

    # ---- consumer side ---------------------------------------------------

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if self._closed:
            raise RuntimeError("prefetch iterator is closed")
        if self._done:
            raise StopIteration
        while True:
            try:
                tag, val = self._q.get(timeout=1.0)
                break
            except queue.Empty:
                # The feeder always enqueues _END/_ERROR before exiting; an
                # empty queue with a dead thread means it was killed hard —
                # fail loudly rather than block forever.
                if not self._thread.is_alive():
                    raise RuntimeError(
                        "prefetch feeder thread died without reporting"
                    ) from None
        self.metrics.queue_depth.set(self._q.qsize())
        if tag == _END:
            self._done = True
            raise StopIteration
        if tag == _ERROR:
            self._done = True
            raise val
        return val

    def close(self, join_timeout_s: float = 5.0) -> None:
        """Stop the feeder and close the wrapped producer (idempotent)."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        self._stop.set()
        # Drain buffered batches so a feeder blocked in put() wakes promptly
        # (its 50 ms poll would also catch the stop flag) and device/host
        # buffers are released.
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(join_timeout_s)
        close = getattr(self._source, "close", None)
        if close is None:
            return
        if self._thread.is_alive():
            # Feeder wedged inside the producer: closing a generator that is
            # mid-next() raises ValueError — try anyway (non-generator
            # sources like NativePipeline unblock their own next()).
            logger.warning("prefetch feeder did not stop in %.1fs", join_timeout_s)
            try:
                close()
            except ValueError:
                pass
        else:
            close()


class _SyncFeed:
    """The prefetch-disabled path with the same observability surface.

    ``next()`` runs the producer inline — assembly time is recorded (so the
    ``batches_assembled`` counter and ``assembly`` histogram stay
    meaningful for A/B runs) but nothing is hidden: the consumer's measured
    host wait will equal the full assembly cost. ``prefetch 0`` therefore
    answers "how feed-bound is this run?" with the same metrics the async
    path reports.
    """

    def __init__(
        self,
        source: Iterable,
        *,
        metrics: FeedMetrics | None = None,
    ):
        self.metrics = metrics if metrics is not None else FeedMetrics()
        self.depth = 0
        self._source = source
        self._it = iter(source)

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        t0 = time.perf_counter()
        item = next(self._it)
        self.metrics.assembly.observe(time.perf_counter() - t0)
        self.metrics.batches_assembled.inc()
        return item

    def close(self) -> None:
        close = getattr(self._source, "close", None)
        if close is not None:
            close()


def prefetch(
    source: Iterable,
    depth: int = 2,
    *,
    metrics: FeedMetrics | None = None,
) -> PrefetchIterator | _SyncFeed:
    """Wrap a batch producer with ``depth`` batches of background prefetch.

    ``depth >= 1`` returns a :class:`PrefetchIterator` (feeder thread +
    bounded queue); ``depth <= 0`` returns the synchronous passthrough with
    identical metrics/close surface, so call sites and A/B comparisons
    need no branching. Default depth 2: one batch in host→device flight
    while the next assembles — deeper queues only buy slack against
    assembly-time jitter, at ``depth`` batches of extra host RAM.
    """
    if depth <= 0:
        return _SyncFeed(source, metrics=metrics)
    return PrefetchIterator(source, depth, metrics=metrics)
