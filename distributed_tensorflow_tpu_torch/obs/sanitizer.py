"""locktrace + racetrace: opt-in runtime concurrency sanitizers.

``sanitize_locks()`` monkeypatches ``threading.Lock`` and
``threading.Condition`` so every lock created inside the context is a
``TrackedLock`` that records, per acquisition, which locks the acquiring
thread already held. Those (held → acquired) edges form a directed
acquisition-order graph; a cycle in it means two threads can take the same
locks in opposite orders — a potential deadlock, reported even if the
interleaving never actually deadlocked during the test run.

Nodes are *creation sites* (``file:lineno`` of the ``Lock()`` call), not
instances, so the pattern generalizes across pool/queue instances created
from the same line. Self-edges (site → same site) are ignored: nested
acquisition of two instances from one constructor line (e.g. two queues)
is ordered by the caller, not by this graph.

Only locks constructed *while the patch is installed* are tracked —
pre-existing module locks and stdlib internals (logging, importlib) keep
their native types, so the sanitizer cannot perturb code outside the
system under test. ``queue.Queue`` and ``threading.Event`` objects built
inside the window *are* tracked (their internal mutex/Condition route
through the patched constructors), which is exactly what the batcher /
prefetch soak tests want.

``sanitize_races()`` layers a happens-before race detector on top of the
same machinery: per-thread vector clocks advanced by tracked-lock
release→acquire edges (plus ``Thread.start``/``join`` edges), and
``__setattr__``/``__getattribute__`` instrumentation on a declared
attribute set (a class's ``_RACETRACE_ATTRS`` tuple, or an explicit
``watch=`` mapping). Two accesses to the same attribute from different
threads with neither ordered before the other — and at least one a write —
is a data race, reported with both stacks and the creation sites of the
locks that *would* have ordered them. See :class:`RaceSanitizer`.
"""

from __future__ import annotations

import dataclasses
import sys
import threading
import traceback
from contextlib import contextmanager

__all__ = [
    "LockOrderSanitizer",
    "RaceSanitizer",
    "sanitize_locks",
    "sanitize_races",
]

_REAL_LOCK = threading.Lock
_REAL_CONDITION = threading.Condition


def _creation_site(skip_prefixes: tuple[str, ...]) -> str:
    """file:lineno of the frame that called Lock()/Condition()."""
    for frame in reversed(traceback.extract_stack(limit=12)[:-2]):
        fname = frame.filename
        if any(p in fname for p in skip_prefixes):
            continue
        return f"{fname.rsplit('/', 1)[-1]}:{frame.lineno}"
    return "<unknown>"


class LockOrderSanitizer:
    """Acquisition graph + cycle detection over tracked locks."""

    def __init__(self) -> None:
        self._graph_lock = _REAL_LOCK()
        # site -> set of sites acquired while holding it, with one example
        # stack edge label for the report.
        self._edges: dict[str, set[str]] = {}
        self._held = threading.local()
        self.acquisitions = 0

    # -- called by TrackedLock ------------------------------------------

    def _stack(self) -> list[str]:
        if not hasattr(self._held, "stack"):
            self._held.stack = []
        return self._held.stack

    def note_acquired(self, site: str, lock=None) -> None:
        stack = self._stack()
        if stack:
            holder = stack[-1]
            if holder != site:
                with self._graph_lock:
                    self._edges.setdefault(holder, set()).add(site)
        with self._graph_lock:
            self.acquisitions += 1
        stack.append(site)

    def note_released(self, site: str, lock=None) -> None:
        stack = self._stack()
        # Locks may be released out of LIFO order (Condition.wait releases
        # the underlying lock mid-stack); remove the most recent entry.
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == site:
                del stack[i]
                return

    # -- reporting ------------------------------------------------------

    def edges(self) -> dict[str, set[str]]:
        with self._graph_lock:
            return {k: set(v) for k, v in self._edges.items()}

    def cycles(self) -> list[list[str]]:
        """All elementary acquisition-order cycles (DFS, deduplicated)."""
        graph = self.edges()
        cycles: list[list[str]] = []
        seen: set[tuple[str, ...]] = set()

        def dfs(node: str, path: list[str], on_path: set[str]) -> None:
            for nxt in sorted(graph.get(node, ())):
                if nxt in on_path:
                    cyc = path[path.index(nxt):] + [nxt]
                    # Canonicalize rotation so each cycle reports once.
                    core = cyc[:-1]
                    k = core.index(min(core))
                    canon = tuple(core[k:] + core[:k])
                    if canon not in seen:
                        seen.add(canon)
                        cycles.append(list(canon) + [canon[0]])
                elif nxt not in path:
                    dfs(nxt, path + [nxt], on_path | {nxt})

        for start in sorted(graph):
            dfs(start, [start], {start})
        return cycles

    def report(self) -> str:
        lines = [f"lock-order sanitizer: {self.acquisitions} acquisitions"]
        for src in sorted(self._edges):
            for dst in sorted(self._edges[src]):
                lines.append(f"  {src} -> {dst}")
        cycles = self.cycles()
        if cycles:
            lines.append("POTENTIAL DEADLOCK CYCLES:")
            for cyc in cycles:
                lines.append("  " + " -> ".join(cyc))
        else:
            lines.append("no acquisition-order cycles")
        return "\n".join(lines)

    def assert_no_cycles(self) -> None:
        cycles = self.cycles()
        if cycles:
            raise AssertionError(
                "lock acquisition-order cycle(s) detected:\n" + self.report()
            )


class TrackedLock:
    """Drop-in ``threading.Lock`` recording acquisition order."""

    def __init__(self, sanitizer: LockOrderSanitizer, site: str) -> None:
        self._lock = _REAL_LOCK()
        self._san = sanitizer
        self._site = site

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._lock.acquire(blocking, timeout)
        if got:
            self._san.note_acquired(self._site, self)
        return got

    def release(self) -> None:
        # The release edge is published BEFORE the real release: once
        # another thread can win the lock, its acquire edge must already
        # see everything this thread did while holding it.
        self._san.note_released(self._site, self)
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<TrackedLock {self._site} {self._lock!r}>"


# ------------------------------------------------------------- racetrace


def _access_stack(limit: int = 16) -> tuple[tuple, ...]:
    """Raw caller stack, newest frame first.

    This runs on every watched attribute access, so it must be cheap: a
    bare frame walk collecting ``(code_object, lineno)`` pairs — no
    ``traceback`` FrameSummary objects, no linecache source lookups, not
    even the ``co_filename``/``co_name`` attribute fetches (code objects
    outlive their frames, so those resolve lazily in ``_format_stack``
    when a race is actually rendered).
    """
    frame = sys._getframe(1)
    out = []
    while frame is not None and len(out) < limit:
        out.append((frame.f_code, frame.f_lineno))
        frame = frame.f_back
    return tuple(out)


def _format_stack(raw: tuple[tuple, ...]) -> list[str]:
    """Render a raw stack oldest-first, sanitizer/threading frames elided."""
    kept = []
    for code, lineno in raw:  # newest first
        base = code.co_filename.rsplit("/", 1)[-1]
        if base in ("sanitizer.py", "threading.py"):
            continue
        kept.append(f"{base}:{lineno} in {code.co_name}")
    kept = kept[:10]
    kept.reverse()
    return kept


class _MemAccess:
    """One recorded access to a watched attribute.

    A plain __slots__ class, not a dataclass: one is built per watched
    access and frozen-dataclass ``__init__`` (object.__setattr__ per
    field) is measurable on that path.
    """

    __slots__ = ("tid", "thread_name", "clock", "op", "stack", "held")

    def __init__(self, tid, thread_name, clock, op, stack, held):
        self.tid = tid
        self.thread_name = thread_name
        self.clock = clock  # accessor's own vector-clock component
        self.op = op  # "read" | "write"
        self.stack = stack  # raw (code, lineno) frames, newest first
        self.held = held  # tracked-lock creation sites held at access


@dataclasses.dataclass(frozen=True)
class Race:
    """A pair of conflicting accesses with no happens-before edge."""

    cls: str
    attr: str
    first: _MemAccess
    second: _MemAccess
    candidate_locks: tuple[str, ...]  # lock sites seen guarding this attr

    def render(self) -> str:
        lines = [f"data race on {self.cls}.{self.attr} "
                 f"({self.first.op}/{self.second.op}):"]
        for acc in (self.first, self.second):
            held = f"holding [{', '.join(acc.held)}]" if acc.held else "holding no tracked lock"
            lines.append(
                f"  {acc.op} by thread '{acc.thread_name}' (ident {acc.tid}), {held}:"
            )
            for frame in _format_stack(acc.stack):
                lines.append(f"    {frame}")
        if self.candidate_locks:
            lines.append(
                "  lock(s) that would have ordered them (created at): "
                + ", ".join(self.candidate_locks)
            )
        else:
            lines.append(
                "  no tracked lock has ever guarded this attribute"
            )
        return "\n".join(lines)


class _AttrState:
    """Last write + last read-per-thread for one (object, attribute)."""

    __slots__ = ("cls", "write", "reads")

    def __init__(self, cls: str) -> None:
        self.cls = cls
        self.write: _MemAccess | None = None
        self.reads: dict[int, _MemAccess] = {}


class RaceSanitizer(LockOrderSanitizer):
    """Happens-before (vector clock) data-race detector.

    Extends the lock-order sanitizer: tracked-lock release→acquire pairs,
    ``Thread.start`` and completed ``Thread.join`` are the happens-before
    edges. Accesses to watched attributes are checked against the last
    write (and, for writes, the last read of every other thread); a
    conflicting pair with neither side ordered before the other is a race.

    Limitations (by design, documented in docs/ANALYSIS.md): only locks
    *created inside the window* carry edges — construct the system under
    test inside ``sanitize_races``; ``Thread`` subclasses overriding
    ``run()`` don't get start-edge bootstrapping (use ``target=``); thread
    idents may be reused by the OS after a join (fresh clocks are issued
    on every patched ``run()``, so this only affects unpatched threads).
    """

    def __init__(self) -> None:
        super().__init__()
        self._vc_mu = _REAL_LOCK()
        self._vcs: dict[int, dict[int, int]] = {}  # tid -> vector clock
        self._lock_vcs: dict[int, dict[int, int]] = {}  # id(lock) -> clock
        self._start_snaps: dict[int, dict[int, int]] = {}  # id(thread)
        self._final_vcs: dict[int, dict[int, int]] = {}  # id(thread)
        self._attrs: dict[tuple[int, str], _AttrState] = {}
        self._tid_names: dict[int, str] = {}  # current_thread() is hot
        self._guards: dict[tuple[str, str], set[str]] = {}  # (cls, attr)
        self._race_keys: set[tuple] = set()
        self.races: list[Race] = []
        self.accesses = 0

    # -- vector clocks (all helpers expect self._vc_mu held) -------------

    def _vc(self, tid: int) -> dict[int, int]:
        vc = self._vcs.get(tid)
        if vc is None:
            # A thread first seen mid-flight: its own component starts at
            # 1 so it is never confused with the "never observed" epoch 0.
            vc = self._vcs[tid] = {tid: 1}
        return vc

    @staticmethod
    def _join_into(dst: dict[int, int], src: dict[int, int] | None) -> None:
        if src:
            for tid, clock in src.items():
                if clock > dst.get(tid, 0):
                    dst[tid] = clock

    # -- happens-before edges -------------------------------------------

    def note_acquired(self, site: str, lock=None) -> None:
        super().note_acquired(site, lock)
        if lock is not None:
            tid = threading.get_ident()
            with self._vc_mu:
                self._join_into(self._vc(tid), self._lock_vcs.get(id(lock)))

    def note_released(self, site: str, lock=None) -> None:
        super().note_released(site, lock)
        if lock is not None:
            tid = threading.get_ident()
            with self._vc_mu:
                vc = self._vc(tid)
                self._lock_vcs[id(lock)] = dict(vc)
                vc[tid] = vc.get(tid, 1) + 1

    def note_thread_start(self, thread: threading.Thread) -> None:
        tid = threading.get_ident()
        with self._vc_mu:
            vc = self._vc(tid)
            self._start_snaps[id(thread)] = dict(vc)
            vc[tid] = vc.get(tid, 1) + 1

    def note_thread_run(self, thread: threading.Thread) -> None:
        tid = threading.get_ident()
        with self._vc_mu:
            vc = {tid: 1}
            self._join_into(vc, self._start_snaps.pop(id(thread), None))
            self._vcs[tid] = vc

    def note_thread_done(self, thread: threading.Thread) -> None:
        tid = threading.get_ident()
        with self._vc_mu:
            self._final_vcs[id(thread)] = dict(self._vc(tid))

    def note_thread_joined(self, thread: threading.Thread) -> None:
        tid = threading.get_ident()
        with self._vc_mu:
            self._join_into(self._vc(tid), self._final_vcs.get(id(thread)))

    # -- access checking -------------------------------------------------

    def on_access(self, obj, attr: str, op: str) -> None:
        tid = threading.get_ident()
        stack = _access_stack()
        held = tuple(self._stack())
        cls = type(obj).__name__
        name = self._tid_names.get(tid)
        if name is None:
            name = self._tid_names[tid] = threading.current_thread().name
        with self._vc_mu:
            self.accesses += 1
            vc = self._vc(tid)
            me = _MemAccess(tid, name, vc.get(tid, 1), op, stack, held)
            state = self._attrs.get((id(obj), attr))
            if state is None:
                state = self._attrs[(id(obj), attr)] = _AttrState(cls)
            guards = self._guards.setdefault((cls, attr), set())
            if held:
                guards.update(held)

            # prev is ordered before me iff my clock has absorbed it.
            conflicts = []
            w = state.write
            if w is not None and w.tid != tid and w.clock > vc.get(w.tid, 0):
                conflicts.append(w)
            if op == "write" and state.reads:
                for r in state.reads.values():
                    if r.tid != tid and r.clock > vc.get(r.tid, 0):
                        conflicts.append(r)
            for prev in conflicts:
                key = (cls, attr, prev.op, op, prev.stack, me.stack)
                if key not in self._race_keys:
                    self._race_keys.add(key)
                    self.races.append(
                        Race(
                            cls=cls,
                            attr=attr,
                            first=prev,
                            second=me,
                            candidate_locks=tuple(sorted(guards)),
                        )
                    )
            if op == "write":
                state.write = me
                state.reads = {}
            else:
                state.reads[tid] = me

    # -- reporting -------------------------------------------------------

    def race_report(self) -> str:
        lines = [
            f"race sanitizer: {self.accesses} watched accesses, "
            f"{len(self.races)} race(s)"
        ]
        for race in self.races:
            lines.append(race.render())
        return "\n".join(lines)

    def assert_race_free(self) -> None:
        if self.races:
            raise AssertionError(
                "data race(s) detected:\n" + self.race_report()
            )

    def assert_clean(self) -> None:
        self.assert_no_cycles()
        self.assert_race_free()


def _instrument_class(cls: type, attrs: frozenset, san: RaceSanitizer):
    """Wrap a class's attribute access for the watched set; returns undo."""
    own_set = cls.__dict__.get("__setattr__")
    own_get = cls.__dict__.get("__getattribute__")
    base_set = cls.__setattr__
    base_get = cls.__getattribute__

    def __setattr__(self, name, value):
        if name in attrs:
            san.on_access(self, name, "write")
        base_set(self, name, value)

    def __getattribute__(self, name):
        if name in attrs:
            san.on_access(self, name, "read")
        return base_get(self, name)

    cls.__setattr__ = __setattr__  # type: ignore[method-assign]
    cls.__getattribute__ = __getattribute__  # type: ignore[method-assign]

    def undo():
        if own_set is None:
            del cls.__setattr__
        else:
            cls.__setattr__ = own_set  # type: ignore[method-assign]
        if own_get is None:
            del cls.__getattribute__
        else:
            cls.__getattribute__ = own_get  # type: ignore[method-assign]

    return undo


@contextmanager
def sanitize_races(
    modules=(),
    watch: dict | None = None,
    skip_prefixes: tuple[str, ...] = ("threading.py", "sanitizer.py", "queue.py"),
):
    """Track lock order AND data races; yields a :class:`RaceSanitizer`.

    ``modules``: iterable of modules — every class in them declaring a
    ``_RACETRACE_ATTRS`` tuple gets its declared attributes instrumented.
    ``watch``: explicit ``{cls: (attr, ...)}`` additions (tests, ad-hoc).

    As with ``sanitize_locks``, only locks created inside the window carry
    happens-before edges — build the system under test inside the context,
    or unguarded accesses ordered by a pre-existing (untracked) lock will
    be reported as races.
    """
    san = RaceSanitizer()

    targets: dict[type, frozenset] = {}
    for mod in modules:
        for obj in vars(mod).values():
            if isinstance(obj, type):
                declared = obj.__dict__.get("_RACETRACE_ATTRS")
                if declared:
                    targets[obj] = frozenset(declared)
    for cls, attrs in (watch or {}).items():
        targets[cls] = targets.get(cls, frozenset()) | frozenset(attrs)

    def make_lock() -> TrackedLock:
        return TrackedLock(san, _creation_site(skip_prefixes))

    def make_condition(lock=None):
        if lock is None:
            lock = make_lock()
        return _REAL_CONDITION(lock)

    real_start = threading.Thread.start
    real_run = threading.Thread.run
    real_join = threading.Thread.join

    def start(thread):
        san.note_thread_start(thread)
        return real_start(thread)

    def run(thread):
        san.note_thread_run(thread)
        try:
            real_run(thread)
        finally:
            san.note_thread_done(thread)

    def join(thread, timeout=None):
        real_join(thread, timeout)
        if not thread.is_alive():
            san.note_thread_joined(thread)

    undos = [_instrument_class(cls, attrs, san) for cls, attrs in targets.items()]
    threading.Lock = make_lock  # type: ignore[assignment]
    threading.Condition = make_condition  # type: ignore[assignment]
    threading.Thread.start = start  # type: ignore[method-assign]
    threading.Thread.run = run  # type: ignore[method-assign]
    threading.Thread.join = join  # type: ignore[method-assign]
    try:
        yield san
    finally:
        threading.Lock = _REAL_LOCK  # type: ignore[assignment]
        threading.Condition = _REAL_CONDITION  # type: ignore[assignment]
        threading.Thread.start = real_start  # type: ignore[method-assign]
        threading.Thread.run = real_run  # type: ignore[method-assign]
        threading.Thread.join = real_join  # type: ignore[method-assign]
        for undo in undos:
            undo()


@contextmanager
def sanitize_locks(
    skip_prefixes: tuple[str, ...] = ("threading.py", "sanitizer.py", "queue.py")
):
    """Context manager: track all locks created inside; yields the sanitizer.

    ``threading.Condition`` keeps its stdlib implementation but, created
    with no argument, now wraps a ``TrackedLock`` — the stdlib Condition
    handles foreign locks via its documented ``acquire(0)``/default
    ``_release_save`` fallbacks, so ``with cv:`` and ``cv.wait()`` record
    acquire/release events like any other tracked lock. Waiter locks are
    ``_thread.allocate_lock`` internals and stay untracked.
    """
    san = LockOrderSanitizer()

    def make_lock() -> TrackedLock:
        return TrackedLock(san, _creation_site(skip_prefixes))

    def make_condition(lock=None):
        if lock is None:
            lock = make_lock()
        return _REAL_CONDITION(lock)

    threading.Lock = make_lock  # type: ignore[assignment]
    threading.Condition = make_condition  # type: ignore[assignment]
    try:
        yield san
    finally:
        threading.Lock = _REAL_LOCK  # type: ignore[assignment]
        threading.Condition = _REAL_CONDITION  # type: ignore[assignment]
