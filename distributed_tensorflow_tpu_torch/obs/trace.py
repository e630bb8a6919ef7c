"""Span/event tracing: the rebuild of the reference's per-``sess.run``
Chrome timeline (``RunOptions(trace_level=FULL_TRACE)``), host side.

A device profiler (``torch.profiler``) covers the device half offline; this
module covers the HOST half live: where a request or a training step
spends its wall time between the counters. Three pieces:

- :class:`Tracer` — thread-safe, ring-buffered span recording. Spans are
  either scoped (``with tracer.span("assemble"):``, nesting tracked per
  thread so children know their parent and inherit its correlation keys)
  or recorded after the fact from explicit timestamps
  (``tracer.record("device", t0, t1, request_id=...)`` — the shape the
  serving pipeline needs, where one request's phases are measured on
  three different threads).
- **Correlation keys**: every span may carry a ``request_id`` (serving)
  and/or a ``step`` (training), so a drained trace decomposes per
  request/step, not just per thread.
- **Chrome trace-event export** (:meth:`Tracer.chrome_events` /
  :meth:`Tracer.export`): the JSON the ``chrome://tracing`` / Perfetto UI
  loads — ``ph: "X"`` complete events with microsecond ``ts``/``dur``,
  ``ph: "i"`` instants, real ``pid``/``tid``.

Overhead contract (the "always-on-capable" requirement): a DISABLED
tracer is a branch and a return at every call site — ``span()`` hands
back a shared no-op context manager, ``record``/``instant`` return on
the first line, nothing allocates. An ENABLED tracer costs one small
object + one deque append per span; the buffer is bounded
(``buffer_size``), so a serving process tracing forever holds a fixed
window of recent spans, never an unbounded log.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from pathlib import Path


class Span:
    """One completed (or open) span. ``t0``/``t1`` are ``time.monotonic``
    seconds; the exporter rebases them onto the tracer's origin."""

    __slots__ = (
        "name", "cat", "t0", "t1", "tid", "span_id", "parent_id",
        "request_id", "step", "args", "ph",
    )

    def __init__(self, name, cat, t0, t1, tid, span_id, parent_id,
                 request_id, step, args, ph="X"):
        self.name = name
        self.cat = cat
        self.t0 = t0
        self.t1 = t1
        self.tid = tid
        self.span_id = span_id
        self.parent_id = parent_id
        self.request_id = request_id
        self.step = step
        self.args = args
        self.ph = ph

    @property
    def duration_s(self) -> float:
        return (self.t1 or self.t0) - self.t0


class _NullSpan:
    """Shared no-op context manager: what a disabled tracer's ``span()``
    returns. One instance for the whole process — entering it allocates
    nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args) -> None:
        pass


NULL_SPAN = _NullSpan()


class _ScopedSpan:
    """Context manager for an open span; pops the thread-local stack and
    commits to the ring buffer on exit."""

    __slots__ = ("_tracer", "_span")

    def __init__(self, tracer, span):
        self._tracer = tracer
        self._span = span

    def set(self, **args) -> None:
        """Attach args to the open span (e.g. the chosen tier, row count)."""
        if self._span.args is None:
            self._span.args = {}
        self._span.args.update(args)

    def __enter__(self):
        self._tracer._stack().append(self._span)
        return self

    def __exit__(self, *exc):
        span = self._span
        span.t1 = time.monotonic()
        stack = self._tracer._stack()
        if stack and stack[-1] is span:
            stack.pop()
        self._tracer._commit(span)
        return False


class Tracer:
    """Thread-safe ring-buffered span recorder with Chrome JSON export.

    ``enabled=False`` (or ``buffer_size=0``) builds a no-op tracer: every
    method returns immediately, ``span()`` returns the shared
    :data:`NULL_SPAN`. Call sites therefore never need their own
    ``if tracing:`` branches.
    """

    def __init__(self, buffer_size: int = 4096, enabled: bool = True):
        self.enabled = bool(enabled) and buffer_size > 0
        self.buffer_size = int(buffer_size)
        self._lock = threading.Lock()
        self._buf: list[Span] = []
        self._head = 0  # ring write position once the buffer is full
        self._dropped = 0
        self._ids = itertools.count(1)
        self._tls = threading.local()
        # Export origin: monotonic epoch paired with wall clock so two
        # traces from one process line up in the viewer.
        self._t_origin = time.monotonic()
        self._wall_origin = time.time()

    # ------------------------------------------------------------ recording

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _commit(self, span: Span) -> None:
        with self._lock:
            if len(self._buf) < self.buffer_size:
                self._buf.append(span)
            else:
                self._buf[self._head] = span
                self._head = (self._head + 1) % self.buffer_size
                self._dropped += 1

    def span(self, name: str, cat: str = "", *, request_id=None,
             step=None, **args):
        """Open a scoped span (``with tracer.span(...)``). Nested spans
        record their parent and inherit its ``request_id``/``step`` unless
        given their own."""
        if not self.enabled:
            return NULL_SPAN
        stack = self._stack()
        parent = stack[-1] if stack else None
        if parent is not None:
            if request_id is None:
                request_id = parent.request_id
            if step is None:
                step = parent.step
        return _ScopedSpan(self, Span(
            name, cat, time.monotonic(), None, threading.get_ident(),
            next(self._ids), parent.span_id if parent else None,
            request_id, step, args or None,
        ))

    def record(self, name: str, t0: float, t1: float, *, cat: str = "",
               request_id=None, step=None, tid=None, args=None) -> None:
        """Commit a span from explicit ``time.monotonic`` timestamps —
        for phases measured across threads (the serving pipeline), where a
        ``with`` block can't scope the interval."""
        if not self.enabled:
            return
        self._commit(Span(
            name, cat, t0, t1, tid or threading.get_ident(),
            next(self._ids), None, request_id, step, args,
        ))

    def instant(self, name: str, cat: str = "", *, request_id=None,
                step=None, **args) -> None:
        """Record a point event (``ph: "i"``) — checkpoint writes, errors."""
        if not self.enabled:
            return
        now = time.monotonic()
        self._commit(Span(
            name, cat, now, now, threading.get_ident(), next(self._ids),
            None, request_id, step, args or None, ph="i",
        ))

    # ------------------------------------------------------------- reading

    def _snapshot_buf(self) -> list[Span]:
        with self._lock:
            # Oldest-first: the ring's tail is at _head once it wrapped.
            return self._buf[self._head:] + self._buf[:self._head]

    def drain(self, max_spans: int | None = None) -> list[Span]:
        """Pop spans (oldest first). ``max_spans`` keeps only the NEWEST N
        — a bounded ``/tracez`` pull wants the recent window, and the rest
        is discarded either way."""
        with self._lock:
            spans = self._buf[self._head:] + self._buf[:self._head]
            self._buf = []
            self._head = 0
        if max_spans is not None and max_spans >= 0:
            spans = spans[len(spans) - min(len(spans), max_spans):]
        return spans

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    def summary(self) -> dict:
        """Per-span-name aggregate over the CURRENT buffer (no drain):
        ``{name: {count, mean_ms, max_ms}}`` — the /statusz digest."""
        agg: dict[str, list] = {}
        for s in self._snapshot_buf():
            a = agg.setdefault(s.name, [0, 0.0, 0.0])
            d = s.duration_s
            a[0] += 1
            a[1] += d
            a[2] = max(a[2], d)
        return {
            name: {
                "count": n,
                "mean_ms": 1e3 * total / n,
                "max_ms": 1e3 * mx,
            }
            for name, (n, total, mx) in sorted(agg.items())
        }

    def status(self) -> dict:
        with self._lock:
            buffered, dropped = len(self._buf), self._dropped
        return {
            "enabled": self.enabled,
            "buffer_size": self.buffer_size,
            "buffered_spans": buffered,
            "dropped_spans": dropped,
        }

    # ------------------------------------------------------------- export

    def chrome_events(self, spans: list[Span] | None = None) -> list[dict]:
        """Spans -> Chrome trace-event dicts (``ts``/``dur`` in µs since
        the tracer's origin). ``spans=None`` exports a copy of the current
        buffer without draining it."""
        if spans is None:
            spans = self._snapshot_buf()
        pid = os.getpid()
        events = []
        for s in spans:
            args = dict(s.args) if s.args else {}
            if s.request_id is not None:
                args["request_id"] = s.request_id
            if s.step is not None:
                args["step"] = s.step
            ev = {
                "name": s.name,
                "cat": s.cat or "host",
                "ph": s.ph,
                "ts": (s.t0 - self._t_origin) * 1e6,
                "pid": pid,
                "tid": s.tid,
                "args": args,
            }
            if s.ph == "X":
                ev["dur"] = max(0.0, ((s.t1 or s.t0) - s.t0) * 1e6)
            else:
                ev["s"] = "t"  # thread-scoped instant
            events.append(ev)
        return events

    def chrome_json(self, spans: list[Span] | None = None) -> dict:
        return {
            "traceEvents": self.chrome_events(spans),
            "displayTimeUnit": "ms",
            "otherData": {"wall_origin": self._wall_origin},
        }

    def export(self, path: str | Path, *, drain: bool = False) -> Path:
        """Write the buffer as Chrome trace-event JSON (Perfetto /
        ``chrome://tracing`` loadable). ``drain`` empties the buffer."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        spans = self.drain() if drain else None
        with path.open("w") as fh:
            json.dump(self.chrome_json(spans), fh)
        return path


#: Process-wide disabled tracer: the default for every instrumented call
#: site, so ``tracer or NULL_TRACER`` makes tracing opt-in with zero
#: conditional clutter (and near-zero cost) when it is off.
NULL_TRACER = Tracer(buffer_size=0, enabled=False)
