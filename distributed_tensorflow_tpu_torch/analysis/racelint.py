"""racelint: cross-thread shared-state rules for the threaded stack.

Where locklint asks "are locks used *correctly*", racelint asks the prior
question: "is shared state guarded *at all*". It builds a thread-entry map
from ``threading.Thread(target=self.X)`` sites, walks every method
reachable from each entry (and from the public caller surface)
interprocedurally while tracking the ``with self._lock:`` blocks in
effect, and compares the per-thread-context read/write sets that fall out.

Rules
-----
RC001  Attribute written in >= 2 thread contexts with no lock common to
       all of those writes. ``__init__`` writes are exempt — construction
       happens-before ``Thread.start()`` (RC003 polices the exception).
RC002  Check-then-act on shared state outside the guarding lock:
       ``if self._closed: ... ; self._closed = True`` where no lock is
       held across both the test and the write. Also applied to module
       globals mutated under a ``global`` declaration (lazy-init caches).
RC003  Publication hazards: a mutable default argument on a threaded
       class's method, or a ``self.X`` assigned in ``__init__`` *after*
       the worker thread started when that worker touches ``X`` — the
       thread can observe a partially-constructed object.

Guard inference is deliberately syntactic: an attribute counts as guarded
by exactly the set of lock-kind names (per locklint's ``_AttrKinds``
classification) held via ``with`` at the access, carried through
``self.method()`` calls. Sync primitives themselves (locks, semaphores,
queues, events, thread handles) are exempt from the data rules — their
whole job is cross-thread access.

Port of the JAX package's ``analysis/racelint.py``, check for check and
message for message.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Iterable

from .findings import Finding, ScopeIndex, SourceFile, dotted_name
from .locklint import _AttrKinds, _THREAD_CTORS

__all__ = ["run", "CHECKS"]

CHECKS = ("RC001", "RC002", "RC003")

CALLER_CTX = "<caller>"
INIT_CTX = "<init>"

# Method names that mutate their receiver in place: a call
# ``self.X.append(...)`` counts as a *write* to ``self.X``.
_MUTATOR_METHODS = {
    "append", "appendleft", "extend", "add", "insert", "setdefault",
    "pop", "popleft", "popitem", "remove", "discard", "clear", "update",
}

_MUTABLE_DEFAULTS = (ast.List, ast.Dict, ast.Set)
_MUTABLE_DEFAULT_CTORS = {"list", "dict", "set", "collections.deque", "deque"}


@dataclasses.dataclass(frozen=True)
class _Access:
    attr: str
    write: bool
    ctx: str  # entry method name, CALLER_CTX, or INIT_CTX
    method: str  # method the access physically lives in
    locks: frozenset[str]
    line: int


def _self_attr(node: ast.AST) -> str | None:
    """``self.X`` -> ``X`` for a direct attribute node, else None."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _self_root(node: ast.AST) -> str | None:
    """Peel ``.attr`` / ``[...]`` / ``(...)`` layers down to a ``self.X``."""
    while True:
        name = _self_attr(node)
        if name is not None:
            return name
        if isinstance(node, ast.Attribute):
            node = node.value
        elif isinstance(node, ast.Subscript):
            node = node.value
        elif isinstance(node, ast.Call):
            node = node.func
        else:
            return None


class _MethodWalker(ast.NodeVisitor):
    """Record self-attribute accesses in one thread context.

    Follows ``self.method()`` calls into sibling methods, carrying the
    currently-held ``with``-lock set; the visited set is keyed on
    (method, held-locks) so differently-guarded call paths each count.
    """

    def __init__(self, methods: dict[str, ast.FunctionDef], kinds: _AttrKinds, ctx: str):
        self.methods = methods
        self.kinds = kinds
        self.sync = _sync_names(kinds)
        self.ctx = ctx
        self.held: list[str] = []
        self.accesses: list[_Access] = []
        self._visited: set[tuple[str, frozenset[str]]] = set()
        self._current = ""

    # -- entry ----------------------------------------------------------

    def walk(self, method: str) -> None:
        key = (method, frozenset(self.held))
        if key in self._visited:
            return
        self._visited.add(key)
        prev = self._current
        self._current = method
        for stmt in self.methods[method].body:
            self.visit(stmt)
        self._current = prev

    # -- recording ------------------------------------------------------

    def _record(self, attr: str, write: bool, line: int) -> None:
        if attr in self.sync:
            return
        self.accesses.append(
            _Access(
                attr=attr,
                write=write,
                ctx=self.ctx,
                method=self._current,
                locks=frozenset(self.held),
                line=line,
            )
        )

    def _record_target(self, tgt: ast.AST) -> None:
        root = _self_root(tgt)
        if root is not None:
            self._record(root, True, tgt.lineno)
        # Subscript/attribute targets still *read* their index expressions.
        if isinstance(tgt, ast.Subscript):
            self.visit(tgt.slice)
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            for elt in tgt.elts:
                self._record_target(elt)

    # -- structure ------------------------------------------------------

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

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        # Nested defs run later (possibly on another thread); don't fold
        # their accesses into this context.
        pass

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]
    visit_Lambda = visit_FunctionDef  # type: ignore[assignment]

    def visit_Assign(self, node: ast.Assign) -> None:
        for tgt in node.targets:
            self._record_target(tgt)
        self.visit(node.value)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._record_target(node.target)
        # ``self.n += 1`` reads n too.
        root = _self_root(node.target)
        if root is not None:
            self._record(root, False, node.lineno)
        self.visit(node.value)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._record_target(node.target)
            self.visit(node.value)

    def visit_Delete(self, node: ast.Delete) -> None:
        for tgt in node.targets:
            self._record_target(tgt)

    def visit_Call(self, node: ast.Call) -> None:
        # self.method() -> descend into the sibling method, locks carried.
        callee = _self_attr(node.func)
        if callee is not None and callee in self.methods:
            self.walk(callee)
        elif isinstance(node.func, ast.Attribute) and node.func.attr in _MUTATOR_METHODS:
            root = _self_root(node.func.value)
            if root is not None:
                self._record(root, True, node.lineno)
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        name = _self_attr(node)
        if name is not None and isinstance(node.ctx, ast.Load):
            self._record(name, False, node.lineno)
        self.generic_visit(node)


def _sync_names(kinds: _AttrKinds) -> set[str]:
    out: set[str] = set()
    for bucket in (kinds.locks, kinds.sems, kinds.queues, kinds.threads, kinds.events):
        for dotted in bucket:
            out.add(dotted.split(".")[-1])
    return out


class _ClassReport:
    """Thread-context access sets for one threaded class."""

    def __init__(self, cls: ast.ClassDef, kinds: _AttrKinds) -> None:
        self.cls = cls
        self.kinds = kinds
        self.methods: dict[str, ast.FunctionDef] = {
            n.name: n
            for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        self.entries = self._thread_entries()
        self.accesses: list[_Access] = []
        if not self.entries:
            return
        reachable = self._reachable_from(self.entries)
        for entry in sorted(self.entries):
            w = _MethodWalker(self.methods, kinds, ctx=entry)
            w.walk(entry)
            self.accesses.extend(w.accesses)
        caller_roots = [
            name
            for name in self.methods
            if name not in reachable and name not in self.entries and name != "__init__"
        ]
        w = _MethodWalker(self.methods, kinds, ctx=CALLER_CTX)
        for root in sorted(caller_roots):
            w.walk(root)
        self.accesses.extend(w.accesses)
        if "__init__" in self.methods:
            w = _MethodWalker(self.methods, kinds, ctx=INIT_CTX)
            w.walk("__init__")
            self.accesses.extend(w.accesses)

    def _thread_entries(self) -> set[str]:
        entries: set[str] = set()
        for node in ast.walk(self.cls):
            if not (
                isinstance(node, ast.Call)
                and (dotted_name(node.func) or "") in _THREAD_CTORS
            ):
                continue
            for kw in node.keywords:
                if kw.arg != "target":
                    continue
                target = _self_attr(kw.value)
                if target and target in self.methods:
                    entries.add(target)
        return entries

    def _reachable_from(self, roots: set[str]) -> set[str]:
        calls: dict[str, set[str]] = {}
        for name, fn in self.methods.items():
            out: set[str] = set()
            for node in ast.walk(fn):
                if isinstance(node, ast.Call):
                    callee = _self_attr(node.func)
                    if callee and callee in self.methods:
                        out.add(callee)
            calls[name] = out
        seen = set(roots)
        frontier = list(roots)
        while frontier:
            for nxt in calls.get(frontier.pop(), ()):
                if nxt not in seen:
                    seen.add(nxt)
                    frontier.append(nxt)
        return seen


# ---------------------------------------------------------------- RC001


def _check_multi_context_writes(
    src: SourceFile, scopes: ScopeIndex, report: _ClassReport
) -> list[Finding]:
    findings: list[Finding] = []
    by_attr: dict[str, list[_Access]] = {}
    for acc in report.accesses:
        if acc.write and acc.ctx != INIT_CTX:
            by_attr.setdefault(acc.attr, []).append(acc)
    for attr, writes in sorted(by_attr.items()):
        ctxs = sorted({w.ctx for w in writes})
        if len(ctxs) < 2:
            continue
        common = frozenset.intersection(*(w.locks for w in writes))
        if common:
            continue
        first = min(writes, key=lambda w: w.line)
        findings.append(
            Finding(
                check="RC001",
                path=src.rel,
                line=first.line,
                scope=scopes.lookup(first.line),
                message=(
                    f"attribute 'self.{attr}' written in thread contexts "
                    f"{', '.join(repr(c) for c in ctxs)} with no common "
                    "guarding lock"
                ),
            )
        )
    return findings


# ---------------------------------------------------------------- RC002


class _CheckActVisitor(ast.NodeVisitor):
    """If-tests and writes per attribute, with held locks, inside one fn."""

    def __init__(self, kinds: _AttrKinds, names: set[str] | None) -> None:
        # names=None: track self.X attrs; else track these bare globals.
        self.kinds = kinds
        self.sync = _sync_names(kinds)
        self.names = names
        self.held: list[str] = []
        self.tests: dict[str, list[tuple[frozenset[str], int]]] = {}
        self.writes: dict[str, list[tuple[frozenset[str], int]]] = {}

    def _tracked(self, node: ast.AST) -> str | None:
        if self.names is None:
            name = _self_attr(node)
            if name is not None and name not in self.sync:
                return name
            return None
        if isinstance(node, ast.Name) and node.id in self.names:
            return node.id
        return None

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

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        pass

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]
    visit_Lambda = visit_FunctionDef  # type: ignore[assignment]

    def visit_If(self, node: ast.If) -> None:
        held = frozenset(self.held)
        for sub in ast.walk(node.test):
            name = self._tracked(sub)
            if name is not None:
                self.tests.setdefault(name, []).append((held, node.lineno))
        for stmt in node.body + node.orelse:
            self.visit(stmt)

    def _note_write(self, tgt: ast.AST, line: int) -> None:
        name = self._tracked(tgt)
        if name is not None:
            self.writes.setdefault(name, []).append((frozenset(self.held), line))

    def visit_Assign(self, node: ast.Assign) -> None:
        for tgt in node.targets:
            self._note_write(tgt, node.lineno)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._note_write(node.target, node.lineno)
        self.generic_visit(node)


def _check_then_act_findings(
    visitor: _CheckActVisitor,
    src: SourceFile,
    scopes: ScopeIndex,
    subject: str,
    eligible: set[str] | None = None,
) -> list[Finding]:
    findings: list[Finding] = []
    for attr, writes in sorted(visitor.writes.items()):
        if eligible is not None and attr not in eligible:
            continue
        for test_locks, test_line in visitor.tests.get(attr, ()):
            acted = [
                (w_locks, w_line)
                for w_locks, w_line in writes
                if w_line > test_line and not (test_locks & w_locks)
            ]
            if not acted:
                continue
            w_line = min(line for _, line in acted)
            findings.append(
                Finding(
                    check="RC002",
                    path=src.rel,
                    line=w_line,
                    scope=scopes.lookup(w_line),
                    message=(
                        f"check-then-act on {subject} '{attr}': tested at "
                        f"line {test_line} and written at line {w_line} "
                        "with no lock held across both"
                    ),
                )
            )
            break  # one finding per attribute per function
    return findings


def _check_check_then_act(
    src: SourceFile, scopes: ScopeIndex, report: _ClassReport
) -> list[Finding]:
    # Shared = touched in >= 2 distinct non-__init__ methods of a class
    # that runs threads; single-method attrs are thread-confined enough
    # for this rule (RC001 still sees true multi-context writes).
    touched_in: dict[str, set[str]] = {}
    for acc in report.accesses:
        if acc.method != "__init__":
            touched_in.setdefault(acc.attr, set()).add(acc.method)
    shared = {attr for attr, methods in touched_in.items() if len(methods) >= 2}
    findings: list[Finding] = []
    for name, fn in sorted(report.methods.items()):
        if name == "__init__":
            continue
        v = _CheckActVisitor(report.kinds, names=None)
        for stmt in fn.body:
            v.visit(stmt)
        findings.extend(
            _check_then_act_findings(
                v, src, scopes, "shared attribute", eligible=shared
            )
        )
    return findings


def _check_global_check_then_act(
    src: SourceFile, scopes: ScopeIndex, kinds: _AttrKinds
) -> list[Finding]:
    findings: list[Finding] = []
    for fn in (
        n
        for n in ast.walk(src.tree)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    ):
        declared: set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Global):
                declared.update(node.names)
        if not declared:
            continue
        v = _CheckActVisitor(kinds, names=declared)
        for stmt in fn.body:
            v.visit(stmt)
        findings.extend(
            _check_then_act_findings(v, src, scopes, "module global")
        )
    return findings


# ---------------------------------------------------------------- RC003


def _check_publication(
    src: SourceFile, scopes: ScopeIndex, report: _ClassReport
) -> list[Finding]:
    findings: list[Finding] = []
    sync = _sync_names(report.kinds)

    # (a) mutable default arguments on a threaded class's methods: one
    # shared object across every instance AND every thread.
    for name, fn in sorted(report.methods.items()):
        args = fn.args
        defaults = list(args.defaults) + [d for d in args.kw_defaults if d is not None]
        for d in defaults:
            mutable = isinstance(d, _MUTABLE_DEFAULTS) or (
                isinstance(d, ast.Call)
                and (dotted_name(d.func) or "") in _MUTABLE_DEFAULT_CTORS
            )
            if mutable:
                findings.append(
                    Finding(
                        check="RC003",
                        path=src.rel,
                        line=d.lineno,
                        scope=scopes.lookup(d.lineno),
                        message=(
                            f"mutable default argument on '{name}' of a "
                            "thread-running class: one object is shared by "
                            "every instance and every thread"
                        ),
                    )
                )

    # (b) attributes assigned in __init__ AFTER the worker thread started:
    # the worker can observe a partially-constructed object.
    init = report.methods.get("__init__")
    if init is None:
        return findings
    start_line = None
    for node in ast.walk(init):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "start"
        ):
            root = dotted_name(node.func.value)
            if root in report.kinds.threads:
                start_line = node.lineno if start_line is None else min(start_line, node.lineno)
    if start_line is None:
        return findings
    entry_attrs = {
        acc.attr for acc in report.accesses if acc.ctx in report.entries
    }
    for node in ast.walk(init):
        if not isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            continue
        targets = node.targets if isinstance(node, ast.Assign) else [node.target]
        for tgt in targets:
            attr = _self_attr(tgt)
            if (
                attr
                and node.lineno > start_line
                and attr in entry_attrs
                and attr not in sync
            ):
                findings.append(
                    Finding(
                        check="RC003",
                        path=src.rel,
                        line=node.lineno,
                        scope=scopes.lookup(node.lineno),
                        message=(
                            f"'self.{attr}' assigned after the worker thread "
                            f"started (line {start_line}) but read by the "
                            "worker: publication races construction"
                        ),
                    )
                )
    return findings


# ---------------------------------------------------------------- runner


def run(sources: Iterable[SourceFile]) -> list[Finding]:
    findings: list[Finding] = []
    for src in sources:
        scopes = ScopeIndex(src.tree)
        kinds = _AttrKinds(src.tree)
        findings.extend(_check_global_check_then_act(src, scopes, kinds))
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            report = _ClassReport(node, kinds)
            if not report.entries:
                continue
            findings.extend(_check_multi_context_writes(src, scopes, report))
            findings.extend(_check_check_then_act(src, scopes, report))
            findings.extend(_check_publication(src, scopes, report))
    return findings
