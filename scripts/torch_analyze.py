#!/usr/bin/env python
"""Run the port's static-analysis suite over the port's package.

Usage::

    python scripts/torch_analyze.py [--root DIR] [--format text|json]
                                    [--quick] [--baseline FILE] [--no-baseline]
                                    [--diff [GIT_REF]] [--update-baseline]
                                    [--package NAME]

Exit status is nonzero when any non-baselined finding is active, or when a
baseline suppression has gone stale (matches nothing) for a checker that
ran. ``--quick`` skips the SC002 serving-config sweep (the only stage that
imports the package); the AST checkers (locklint, racelint, SC001) always
run over every module.

``--diff [REF]`` restricts the AST checkers to package files changed vs
the git ref (default ``HEAD~1``), plus untracked files — the pre-commit
shape. Diff mode never judges baseline staleness (a partial view can't
tell stale from unseen) and skips SC002 (whole-package semantics).

``--update-baseline`` rewrites the baseline file from the current run:
existing justifications are preserved, new entries are stamped
``TODO-justify`` (edit before committing), and entries whose finding has
disappeared are dropped (entries for checkers that did not run are kept).

Port of ``scripts/analyze.py`` (the same flags, exit codes and JSON
report) over ``distributed_tensorflow_tpu_torch``, without its jaxlint
pass.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO_ROOT))


def _changed_files(root: Path, ref: str) -> set[str]:
    """Repo-relative .py paths changed vs ``ref``, plus untracked files."""
    changed: set[str] = set()
    diff = subprocess.run(
        ["git", "diff", "--name-only", ref, "--"],
        cwd=root, capture_output=True, text=True, check=True,
    )
    untracked = subprocess.run(
        ["git", "ls-files", "--others", "--exclude-standard"],
        cwd=root, capture_output=True, text=True, check=True,
    )
    for out in (diff.stdout, untracked.stdout):
        for line in out.splitlines():
            line = line.strip()
            if line.endswith(".py"):
                changed.add(line)
    return changed


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument(
        "--root", type=Path, default=REPO_ROOT,
        help="repo root containing the package to analyze",
    )
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument(
        "--quick", action="store_true",
        help="skip the SC002 config sweep (no package import needed)",
    )
    ap.add_argument(
        "--baseline", type=Path, default=None,
        help="baseline file (default: <root>/<package>/analysis/baseline.json)",
    )
    ap.add_argument(
        "--no-baseline", action="store_true",
        help="ignore the baseline file (report every finding as active)",
    )
    ap.add_argument(
        "--diff", nargs="?", const="HEAD~1", default=None, metavar="GIT_REF",
        help="only analyze package files changed vs GIT_REF (default HEAD~1)",
    )
    ap.add_argument(
        "--update-baseline", action="store_true",
        help="rewrite the baseline from current findings (keeps existing "
             "justifications, stamps new entries TODO-justify)",
    )
    ap.add_argument(
        "--package", default="distributed_tensorflow_tpu_torch",
        help="package directory name under --root",
    )
    args = ap.parse_args(argv)

    if args.update_baseline and args.diff is not None:
        ap.error("--update-baseline needs the full view; drop --diff")
    if args.update_baseline and args.no_baseline:
        ap.error("--update-baseline and --no-baseline are contradictory")

    from distributed_tensorflow_tpu_torch.analysis import findings as fmod
    from distributed_tensorflow_tpu_torch.analysis import (
        locklint,
        racelint,
        shardcheck,
    )

    t0 = time.monotonic()
    sources = fmod.iter_sources(args.root, package=args.package)
    if args.diff is not None:
        changed = _changed_files(args.root, args.diff)
        sources = [s for s in sources if s.rel in changed]

    all_findings: list[fmod.Finding] = []
    checks_run: list[str] = []

    all_findings.extend(locklint.run(sources))
    checks_run.extend(locklint.CHECKS)
    all_findings.extend(racelint.run(sources))
    checks_run.extend(racelint.CHECKS)
    all_findings.extend(shardcheck.run(sources))
    checks_run.append("SC001")

    matrix: list[dict] = []
    if not args.quick and args.diff is None:
        sweep_findings, matrix = shardcheck.run_config_sweep()
        all_findings.extend(sweep_findings)
        checks_run.append("SC002")

    baseline_path = args.baseline
    if baseline_path is None:
        baseline_path = args.root / args.package / "analysis" / "baseline.json"
    baseline = (
        fmod.Baseline(entries={})
        if args.no_baseline
        else fmod.load_baseline(baseline_path)
    )
    # Diff mode sees a file subset: a suppression matching nothing there
    # may still match in the full view, so staleness is not judged.
    stale_scope = [] if args.diff is not None else checks_run
    result = fmod.apply_baseline(all_findings, baseline, stale_scope)

    if args.update_baseline:
        return _rewrite_baseline(
            baseline_path, baseline, all_findings, checks_run
        )

    elapsed = time.monotonic() - t0
    ok = not result.active and not result.stale
    if args.format == "json":
        print(
            json.dumps(
                {
                    "ok": ok,
                    "elapsed_s": round(elapsed, 2),
                    "files": len(sources),
                    "diff_ref": args.diff,
                    "checks_run": checks_run,
                    "active": [vars(f) for f in result.active],
                    "suppressed": [
                        {**vars(f), "reason": baseline.entries.get(f.suppress_id, "")}
                        for f in result.suppressed
                    ],
                    "stale_baseline": result.stale,
                    "layout_matrix": matrix,
                },
                indent=2,
            )
        )
    else:
        for f in result.active:
            print(f.render())
        for f in result.suppressed:
            reason = baseline.entries.get(f.suppress_id, "")
            print(f"baselined: {f.render()}  # {reason}")
        for sid in result.stale:
            print(f"STALE baseline entry (matches nothing): {sid}")
        if matrix:
            outcomes = {}
            for cell in matrix:
                outcomes[cell["outcome"]] = outcomes.get(cell["outcome"], 0) + 1
            print(
                "layout sweep: "
                + ", ".join(f"{k}={v}" for k, v in sorted(outcomes.items()))
            )
        scope = f" (diff vs {args.diff})" if args.diff is not None else ""
        print(
            f"torch_analyze{scope}: {len(sources)} files, {len(result.active)} active, "
            f"{len(result.suppressed)} baselined, {len(result.stale)} stale "
            f"({elapsed:.1f}s) -> {'OK' if ok else 'FAIL'}"
        )
    return 0 if ok else 1


def _rewrite_baseline(path, baseline, findings, checks_run) -> int:
    """Regenerate baseline.json from this run's findings.

    Justifications for ids that still match are carried over verbatim; new
    ids get ``TODO-justify``; entries for checkers that did not run (e.g.
    SC002 under --quick) are retained untouched.
    """
    run_prefixes = set(checks_run)
    entries: dict[str, str] = {}
    for f in findings:
        sid = f.suppress_id
        entries.setdefault(sid, baseline.entries.get(sid, "TODO-justify"))
    kept_unseen = 0
    for sid, reason in baseline.entries.items():
        if sid.split(":", 1)[0] not in run_prefixes and sid not in entries:
            entries[sid] = reason
            kept_unseen += 1
    payload = {
        "suppressions": [
            {"id": sid, "reason": entries[sid]} for sid in sorted(entries)
        ]
    }
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(payload, indent=2) + "\n", encoding="utf-8")
    new = [s for s, r in entries.items() if r == "TODO-justify"]
    dropped = [
        s for s in baseline.entries
        if s not in entries
    ]
    print(
        f"baseline rewritten: {len(entries)} entries "
        f"({len(new)} new TODO-justify, {len(dropped)} dropped, "
        f"{kept_unseen} kept for checkers not run) -> {path}"
    )
    for sid in sorted(new):
        print(f"  TODO-justify: {sid}")
    for sid in sorted(dropped):
        print(f"  dropped: {sid}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
