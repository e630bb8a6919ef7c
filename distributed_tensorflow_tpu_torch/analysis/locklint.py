"""locklint: static concurrency rules for the threaded serve/data/obs stack.

Rules
-----
LL001  ``threading.Lock``/``Condition`` acquired outside a ``with`` block
       (bare ``.acquire()``). Semaphores are exempt — acquire/release
       across method boundaries is their whole point (in-flight gating).
LL002  Blocking call while holding a lock: queue ``get``/``put``,
       ``Thread.join``, ``time.sleep``, ``Event.wait``, or a blocking
       device transfer inside a ``with <lock>`` body. ``Condition.wait``
       on the *held* condition is exempt (wait releases the lock).
LL003  ``threading.Thread`` spawned neither daemon nor joined with a
       timeout on some close path — a wedged worker then hangs shutdown.

Attribute classification is per-module: any ``self.X = threading.Lock()``
(or Condition/Thread/Event/Semaphore, or ``queue.Queue``) assignment —
plain or annotated — marks ``self.X`` for every method of that module.
This is what keeps dict ``.get()`` under a lock (obs/metrics.py) from
being mistaken for a blocking queue get.

Port of the JAX package's ``analysis/locklint.py``, check for check and
message for message. The blocking device transfers it knows are JAX's
(``jax.device_get``, ``.block_until_ready()``) and the port's
(``torch.cuda.synchronize()``, a stream's or event's ``.synchronize()``).
"""

from __future__ import annotations

import ast
import re
from typing import Iterable

from .findings import Finding, ScopeIndex, SourceFile, dotted_name

__all__ = ["run", "CHECKS"]

CHECKS = ("LL001", "LL002", "LL003")

_LOCK_CTORS = {"threading.Lock", "threading.RLock", "threading.Condition"}
_SEM_CTORS = {"threading.Semaphore", "threading.BoundedSemaphore"}
_QUEUE_CTORS = {"queue.Queue", "queue.SimpleQueue", "queue.LifoQueue", "queue.PriorityQueue"}
_THREAD_CTORS = {"threading.Thread"}
_EVENT_CTORS = {"threading.Event"}

_LOCKISH_NAME = re.compile(r"lock|mutex|_cv\b|cond", re.IGNORECASE)


class _AttrKinds:
    """Kinds of ``self.X`` / module-level names, scanned per module."""

    def __init__(self, tree: ast.Module) -> None:
        self.locks: set[str] = set()  # "self._cv", "_PROFILER_LOCK"
        self.sems: set[str] = set()
        self.queues: set[str] = set()
        self.threads: set[str] = set()
        self.events: set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign):
                targets = node.targets
                value = node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets = [node.target]
                value = node.value
            else:
                continue
            if not isinstance(value, ast.Call):
                continue
            ctor = dotted_name(value.func) or ""
            bucket = None
            if ctor in _LOCK_CTORS:
                bucket = self.locks
            elif ctor in _SEM_CTORS:
                bucket = self.sems
            elif ctor in _QUEUE_CTORS:
                bucket = self.queues
            elif ctor in _THREAD_CTORS:
                bucket = self.threads
            elif ctor in _EVENT_CTORS:
                bucket = self.events
            if bucket is None:
                continue
            for tgt in targets:
                name = dotted_name(tgt)
                if name:
                    bucket.add(name)

    def is_lock(self, name: str | None) -> bool:
        if name is None:
            return False
        if name in self.locks:
            return True
        # Unclassified but lock-named (and not a known semaphore): treat as
        # a lock so cross-module handles still get checked.
        return name not in self.sems and bool(_LOCKISH_NAME.search(name))


def run(sources: Iterable[SourceFile]) -> list[Finding]:
    findings: list[Finding] = []
    for src in sources:
        scopes = ScopeIndex(src.tree)
        kinds = _AttrKinds(src.tree)
        findings.extend(_check_bare_acquire(src, scopes, kinds))
        findings.extend(_check_blocking_under_lock(src, scopes, kinds))
        findings.extend(_check_thread_lifecycle(src, scopes))
    return findings


# ---------------------------------------------------------------- LL001


def _check_bare_acquire(
    src: SourceFile, scopes: ScopeIndex, kinds: _AttrKinds
) -> list[Finding]:
    findings: list[Finding] = []
    for node in ast.walk(src.tree):
        if not (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in {"acquire", "release"}
        ):
            continue
        target = dotted_name(node.func.value)
        if target in kinds.sems:
            continue
        if kinds.is_lock(target):
            findings.append(
                Finding(
                    check="LL001",
                    path=src.rel,
                    line=node.lineno,
                    scope=scopes.lookup(node.lineno),
                    message=(
                        f"bare '{target}.{node.func.attr}()'; locks must be held "
                        "via 'with' so exceptions cannot leak them"
                    ),
                )
            )
    return findings


# ---------------------------------------------------------------- LL002

_BLOCKING_FREE_CALLS = {
    "time.sleep",
    "jax.device_get",
    "jax.block_until_ready",
    "torch.cuda.synchronize",
}


class _LockHeldVisitor(ast.NodeVisitor):
    def __init__(self, src: SourceFile, scopes: ScopeIndex, kinds: _AttrKinds) -> None:
        self.src = src
        self.scopes = scopes
        self.kinds = kinds
        self.held: list[str] = []
        self.findings: list[Finding] = []

    def visit_With(self, node: ast.With) -> None:
        held_here: list[str] = []
        for item in node.items:
            expr = item.context_expr
            name = dotted_name(expr)
            if name is None and isinstance(expr, ast.Call):
                name = dotted_name(expr.func)
            if name and self.kinds.is_lock(name):
                held_here.append(name)
        self.held.extend(held_here)
        for stmt in node.body:
            self.visit(stmt)
        for _ in held_here:
            self.held.pop()

    # Don't descend into nested defs — they run later, not under the lock.
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        pass

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]
    visit_Lambda = visit_FunctionDef  # type: ignore[assignment]

    def visit_Call(self, node: ast.Call) -> None:
        if self.held:
            self._check_call(node)
        self.generic_visit(node)

    def _check_call(self, node: ast.Call) -> None:
        callee = dotted_name(node.func) or ""
        blocked = None
        if callee in _BLOCKING_FREE_CALLS:
            blocked = f"{callee}()"
        elif isinstance(node.func, ast.Attribute):
            base = dotted_name(node.func.value)
            attr = node.func.attr
            if base in self.kinds.queues and attr in {"get", "put", "join"}:
                blocked = f"queue op '{base}.{attr}()'"
            elif base in self.kinds.threads and attr == "join":
                blocked = f"thread '{base}.join()'"
            elif base in self.kinds.events and attr == "wait":
                blocked = f"event '{base}.wait()'"
            elif attr in {"block_until_ready", "synchronize"}:
                blocked = f"'{base}.{attr}()'"
            elif attr == "wait" and self.kinds.is_lock(base) and base not in self.held:
                # waiting on a DIFFERENT condition than the one(s) held
                blocked = f"'{base}.wait()' while holding {self.held[-1]}"
        if blocked:
            self.findings.append(
                Finding(
                    check="LL002",
                    path=self.src.rel,
                    line=node.lineno,
                    scope=self.scopes.lookup(node.lineno),
                    message=(
                        f"blocking {blocked} while holding lock "
                        f"'{self.held[-1]}'"
                    ),
                )
            )


def _check_blocking_under_lock(
    src: SourceFile, scopes: ScopeIndex, kinds: _AttrKinds
) -> list[Finding]:
    findings: list[Finding] = []
    for fn in (
        n
        for n in ast.walk(src.tree)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    ):
        visitor = _LockHeldVisitor(src, scopes, kinds)
        for stmt in fn.body:
            visitor.visit(stmt)
        findings.extend(visitor.findings)
    return findings


# ---------------------------------------------------------------- LL003


def _check_thread_lifecycle(src: SourceFile, scopes: ScopeIndex) -> list[Finding]:
    findings: list[Finding] = []
    module_src = src.text

    for node in ast.walk(src.tree):
        if not (
            isinstance(node, ast.Call)
            and (dotted_name(node.func) or "") in _THREAD_CTORS
        ):
            continue
        daemon = any(
            kw.arg == "daemon"
            and isinstance(kw.value, ast.Constant)
            and kw.value.value is True
            for kw in node.keywords
        )
        if daemon:
            continue
        # Non-daemon: require a timeout join (or daemon attr set) somewhere
        # in the module on a plausible handle for this thread.
        if _has_timeout_join_or_daemon_attr(src.tree, node):
            continue
        findings.append(
            Finding(
                check="LL003",
                path=src.rel,
                line=node.lineno,
                scope=scopes.lookup(node.lineno),
                message=(
                    "Thread is neither daemon=True nor joined-with-timeout on a "
                    "close path; a wedged worker would hang shutdown"
                ),
            )
        )
    _ = module_src
    return findings


def _has_timeout_join_or_daemon_attr(tree: ast.Module, ctor: ast.Call) -> bool:
    # Find the name the Thread was bound to (self.X = Thread(...) or X = ...).
    # A comprehension binding — self._ts = [Thread(...) for _ in ...] — makes
    # the target a handle *collection* rather than a handle.
    handles: set[str] = set()
    colls: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and node.value is ctor:
            for tgt in node.targets:
                name = dotted_name(tgt)
                if name:
                    handles.add(name)
        elif isinstance(node, ast.AnnAssign) and node.value is ctor:
            name = dotted_name(node.target)
            if name:
                handles.add(name)
        elif (
            isinstance(node, ast.Assign)
            and isinstance(node.value, (ast.ListComp, ast.SetComp, ast.GeneratorExp))
            and node.value.elt is ctor
        ):
            for tgt in node.targets:
                name = dotted_name(tgt)
                if name:
                    colls.add(name)
    if not handles and not colls:
        return False
    _propagate_handles(tree, handles, colls)
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "join"
            and dotted_name(node.func.value) in handles
            and (node.args or any(kw.arg == "timeout" for kw in node.keywords))
        ):
            return True
        if (
            isinstance(node, ast.Assign)
            and any(
                dotted_name(t) in {f"{h}.daemon" for h in handles}
                for t in node.targets
            )
            and isinstance(node.value, ast.Constant)
            and node.value.value is True
        ):
            return True
    return False


def _propagate_handles(
    tree: ast.Module, handles: set[str], colls: set[str] | None = None
) -> None:
    """Grow ``handles`` with indirect bindings of the same thread objects.

    The direct rule only sees ``self._t = Thread(...)`` ... ``self._t.join(
    timeout)``. Real shutdown paths are often indirect: workers collected
    into a list joined by a ``close()``/``shutdown()`` helper (itself called
    from ``finally``/``__exit__``), or handles returned from a spawn helper.
    Fixpoint over three propagation steps:

    * alias/return: ``x = h`` and ``y = self._spawn()`` where ``_spawn``
      returns a handle make ``x``/``y`` handles;
    * collection: ``self._workers.append(h)`` / ``ws = [h1, h2]`` mark the
      container;
    * iteration: ``for w in self._workers:`` makes the loop variable a
      handle, so ``w.join(timeout=...)`` counts.
    """
    colls = set() if colls is None else colls
    while True:
        changed = False

        def note(bucket: set[str], name: str | None) -> None:
            nonlocal changed
            if name and name not in bucket:
                bucket.add(name)
                changed = True

        returners = {
            fn.name
            for fn in ast.walk(tree)
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
            and any(
                isinstance(sub, ast.Return)
                and sub.value is not None
                and dotted_name(sub.value) in handles
                for sub in ast.walk(fn)
            )
        }
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign):
                val = node.value
                tgt_names = [dotted_name(t) for t in node.targets]
                callee = (
                    (dotted_name(val.func) or "").split(".")[-1]
                    if isinstance(val, ast.Call)
                    else ""
                )
                if dotted_name(val) in handles or callee in returners:
                    for name in tgt_names:
                        note(handles, name)
                elif isinstance(val, (ast.List, ast.Tuple, ast.Set)) and any(
                    dotted_name(e) in handles for e in val.elts
                ):
                    for name in tgt_names:
                        note(colls, name)
            elif (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in {"append", "add", "insert"}
                and any(dotted_name(a) in handles for a in node.args)
            ):
                note(colls, dotted_name(node.func.value))
            elif isinstance(node, ast.For) and dotted_name(node.iter) in colls:
                note(handles, dotted_name(node.target))
        if not changed:
            return
