"""Shared finding model for the port's static-analysis suite.

Every checker (locklint, racelint, shardcheck) reports ``Finding`` records.
A finding is identified by ``check:path:scope`` — deliberately *not* by line
number, so baseline suppressions survive unrelated edits to the same file.

The baseline file (``analysis/baseline.json``) lists intentional findings
with a one-line justification each; ``apply_baseline`` splits a run's
findings into active (fail CI) and suppressed, and reports stale baseline
entries (suppressions that no longer match anything) so the baseline cannot
silently rot.

Port of the JAX package's ``analysis/findings.py``: the same model, ids
and baseline format; :func:`iter_sources` defaults to the port's package.
"""

from __future__ import annotations

import ast
import dataclasses
import json
from pathlib import Path
from typing import Iterable, Sequence

__all__ = [
    "Finding",
    "SourceFile",
    "ScopeIndex",
    "Baseline",
    "BaselineResult",
    "iter_sources",
    "load_baseline",
    "apply_baseline",
    "dotted_name",
]


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic from one checker."""

    check: str  # rule id, e.g. "JL001"
    path: str  # repo-relative posix path
    line: int
    scope: str  # enclosing def/class qualname, or "<module>"
    message: str

    @property
    def suppress_id(self) -> str:
        return f"{self.check}:{self.path}:{self.scope}"

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.check} [{self.scope}] {self.message}"


@dataclasses.dataclass(frozen=True)
class SourceFile:
    """A parsed module handed to every AST checker (parsed once, shared)."""

    path: Path  # absolute
    rel: str  # repo-relative posix path, used in findings
    text: str
    tree: ast.Module


class ScopeIndex:
    """Maps line numbers to the innermost enclosing def/class qualname."""

    def __init__(self, tree: ast.Module) -> None:
        self._spans: list[tuple[int, int, str]] = []

        def visit(node: ast.AST, prefix: str) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(
                    child,
                    (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef),
                ):
                    qual = f"{prefix}.{child.name}" if prefix else child.name
                    end = getattr(child, "end_lineno", child.lineno) or child.lineno
                    self._spans.append((child.lineno, end, qual))
                    visit(child, qual)
                else:
                    visit(child, prefix)

        visit(tree, "")
        # Innermost scope wins: sort by span width descending so later
        # (narrower) entries override earlier ones during lookup.
        self._spans.sort(key=lambda s: -(s[1] - s[0]))

    def lookup(self, line: int) -> str:
        best = "<module>"
        for start, end, qual in self._spans:
            if start <= line <= end:
                best = qual  # spans sorted widest-first; keep narrowing
        return best


def dotted_name(node: ast.AST) -> str | None:
    """Render ``a.b.c`` for Name/Attribute chains, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


_SKIP_DIRS = {"__pycache__", ".git"}


def iter_sources(
    root: Path, package: str = "distributed_tensorflow_tpu_torch"
) -> list[SourceFile]:
    """Parse every ``.py`` under ``root/package`` once, in stable order."""
    base = root / package
    out: list[SourceFile] = []
    for path in sorted(base.rglob("*.py")):
        if any(part in _SKIP_DIRS for part in path.parts):
            continue
        text = path.read_text(encoding="utf-8")
        try:
            tree = ast.parse(text, filename=str(path))
        except SyntaxError as exc:  # report, don't crash the suite
            rel = path.relative_to(root).as_posix()
            out.append(
                SourceFile(
                    path=path,
                    rel=rel,
                    text=text,
                    tree=ast.Module(body=[], type_ignores=[]),
                )
            )
            continue
        out.append(SourceFile(path=path, rel=path.relative_to(root).as_posix(), text=text, tree=tree))
    return out


@dataclasses.dataclass(frozen=True)
class Baseline:
    """Parsed baseline.json: suppression id -> one-line justification."""

    entries: dict[str, str]


@dataclasses.dataclass
class BaselineResult:
    active: list[Finding]
    suppressed: list[Finding]
    stale: list[str]  # baseline ids that matched nothing among checks run


def load_baseline(path: Path | None) -> Baseline:
    if path is None or not path.exists():
        return Baseline(entries={})
    raw = json.loads(path.read_text(encoding="utf-8"))
    entries: dict[str, str] = {}
    for item in raw.get("suppressions", []):
        entries[item["id"]] = item.get("reason", "")
    return Baseline(entries=entries)


def apply_baseline(
    findings: Sequence[Finding],
    baseline: Baseline,
    checks_run: Iterable[str],
) -> BaselineResult:
    """Split findings into active/suppressed and detect stale suppressions.

    Staleness is only judged for suppression ids whose check prefix is in
    ``checks_run`` — a ``--quick`` run that skips a checker must not flag
    that checker's baseline entries as stale.
    """
    run = set(checks_run)
    matched: set[str] = set()
    active: list[Finding] = []
    suppressed: list[Finding] = []
    for f in findings:
        if f.suppress_id in baseline.entries:
            matched.add(f.suppress_id)
            suppressed.append(f)
        else:
            active.append(f)
    stale = [
        sid
        for sid in baseline.entries
        if sid not in matched and sid.split(":", 1)[0] in run
    ]
    return BaselineResult(active=active, suppressed=suppressed, stale=sorted(stale))
