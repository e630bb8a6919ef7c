"""The port's static-analysis suite (analysis/, scripts/torch_analyze.py)
and its lock-order sanitizer, held against the JAX package's.

* every rule's seeded snippet (the JAX package's ``tests/test_analysis.py``
  fixtures, its jaxlint ones aside) goes through the JAX checker and the
  port's from the same text: both give the same findings — check id,
  path, line, scope and message — and the port's meet JAX's assertions;
* the port's own additions: the port's collective call forms in SC001 and
  ``torch.cuda.synchronize`` in LL002;
* SC002: the port's ``run_config_sweep`` matrix equals the JAX package's
  cell by cell;
* the runner over the port: clean against its baseline in quick mode
  within the 30 s budget, a seeded violation exits nonzero, ``--diff`` and
  ``--update-baseline`` as in JAX; every baseline entry has a reason and a
  JAX counterpart;
* the repairs the lints found in the port (the profiler session gate, the
  checkpoint writer's error handoff), with their behaviour.
"""

from __future__ import annotations

import ast
import json
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import pytest

from distributed_tensorflow_tpu.analysis import locklint as jax_locklint
from distributed_tensorflow_tpu.analysis import shardcheck as jax_shardcheck
from distributed_tensorflow_tpu_torch.analysis import (
    Baseline,
    SourceFile,
    apply_baseline,
    iter_sources,
    load_baseline,
)
from distributed_tensorflow_tpu_torch.analysis import locklint, racelint, shardcheck
from distributed_tensorflow_tpu_torch.obs.sanitizer import sanitize_locks

pytestmark = pytest.mark.analysis

REPO_ROOT = Path(__file__).resolve().parent.parent
PORT = "distributed_tensorflow_tpu_torch"
JAX_CHECKERS = {locklint: jax_locklint, shardcheck: jax_shardcheck}


def _src(rel: str, code: str) -> SourceFile:
    code = textwrap.dedent(code)
    return SourceFile(
        path=Path("/fixture") / rel, rel=rel, text=code, tree=ast.parse(code)
    )


def _checks(findings, check):
    return [f for f in findings if f.check == check]


def _run(checker, *sources):
    """The port checker's findings over ``sources``, after asserting the
    JAX checker gives the same ones from the same text."""
    port = checker.run(list(sources))
    jax = JAX_CHECKERS[checker].run(list(sources))
    key = lambda f: (f.check, f.path, f.line, f.scope, f.message)  # noqa: E731
    assert sorted(map(key, port)) == sorted(map(key, jax))
    return port


# ----------------------------------------------------------------- locklint


def test_ll001_flags_bare_acquire_and_passes_with():
    bad = _src(
        "pkg/mod.py",
        """
        import threading

        _LOCK = threading.Lock()

        def f():
            _LOCK.acquire()
            try:
                pass
            finally:
                _LOCK.release()
        """,
    )
    good = _src(
        "pkg/mod.py",
        """
        import threading

        _LOCK = threading.Lock()

        def f():
            with _LOCK:
                pass
        """,
    )
    assert len(_checks(_run(locklint, bad), "LL001")) == 2
    assert not _run(locklint, good)


def test_ll001_semaphores_are_exempt():
    good = _src(
        "pkg/mod.py",
        """
        import threading

        class Gate:
            def __init__(self):
                self._sem = threading.BoundedSemaphore(2)

            def enter(self):
                self._sem.acquire()

            def leave(self):
                self._sem.release()
        """,
    )
    assert not _checks(_run(locklint, good), "LL001")


def test_ll002_flags_blocking_under_lock():
    bad = _src(
        "pkg/mod.py",
        """
        import queue
        import threading
        import time

        class B:
            def __init__(self):
                self._lock = threading.Lock()
                self._q = queue.Queue()

            def bad_get(self):
                with self._lock:
                    return self._q.get(timeout=1)

            def bad_sleep(self):
                with self._lock:
                    time.sleep(0.1)
        """,
    )
    found = _checks(_run(locklint, bad), "LL002")
    assert len(found) == 2
    assert {f.scope for f in found} == {"B.bad_get", "B.bad_sleep"}


def test_ll002_passes_condition_self_wait_and_dict_get():
    good = _src(
        "pkg/mod.py",
        """
        import threading

        class C:
            def __init__(self):
                self._cv = threading.Condition()
                self._lock = threading.Lock()
                self._cache = {}

            def waiter(self):
                with self._cv:
                    self._cv.wait(timeout=0.1)

            def lookup(self, k):
                with self._lock:
                    return self._cache.get(k)
        """,
    )
    assert not _checks(_run(locklint, good), "LL002")


def test_ll003_thread_lifecycle():
    bad = _src(
        "pkg/mod.py",
        """
        import threading

        class W:
            def start(self):
                self._t = threading.Thread(target=self._run)
                self._t.start()
        """,
    )
    good_daemon = _src(
        "pkg/mod.py",
        """
        import threading

        class W:
            def start(self):
                self._t = threading.Thread(target=self._run, daemon=True)
                self._t.start()
        """,
    )
    good_joined = _src(
        "pkg/mod.py",
        """
        import threading

        class W:
            def start(self):
                self._t = threading.Thread(target=self._run)
                self._t.start()

            def close(self):
                self._t.join(timeout=5.0)
        """,
    )
    assert _checks(_run(locklint, bad), "LL003")
    assert not _checks(_run(locklint, good_daemon), "LL003")
    assert not _checks(_run(locklint, good_joined), "LL003")


def test_ll003_indirect_join_via_close_helper():
    """Threads joined indirectly — spawn helper returns the handle, handles
    collected in a list, the list iterated and joined inside close() /
    shutdown() — must not be flagged; a leaked one must."""
    good_pool = _src(
        "pkg/pool.py",
        """
        import threading

        class Pool:
            def __init__(self, n):
                self._workers = []
                for _ in range(n):
                    t = self._spawn()
                    self._workers.append(t)

            def _spawn(self):
                t = threading.Thread(target=self._run)
                t.start()
                return t

            def close(self):
                for t in self._workers:
                    t.join(timeout=5.0)

            def __exit__(self, *exc):
                self.close()
        """,
    )
    good_collected = _src(
        "pkg/spawner.py",
        """
        import threading

        class Spawner:
            def start(self):
                self._threads = [
                    threading.Thread(target=self._run) for _ in range(2)
                ]
                for t in self._threads:
                    t.start()

            def shutdown(self):
                for t in self._threads:
                    t.join(timeout=2.0)
        """,
    )
    bad_leaked = _src(
        "pkg/leaky.py",
        """
        import threading

        class Leaky:
            def start(self):
                self._workers = []
                t = threading.Thread(target=self._run)
                t.start()
                self._workers.append(t)

            def close(self):
                self._workers.clear()
        """,
    )
    assert not _checks(_run(locklint, good_pool), "LL003")
    assert not _checks(_run(locklint, good_collected), "LL003")
    assert _checks(_run(locklint, bad_leaked), "LL003")


def test_ll002_sees_the_ports_device_synchronisation():
    """The port's blocking device waits count as LL002's blocking
    transfers (JAX's checker knows only JAX's), and ``Condition.wait``
    on the held condition stays exempt."""
    bad = _src(
        "pkg/mod.py",
        """
        import threading
        import torch

        _LOCK = threading.Lock()

        def f(stream):
            with _LOCK:
                torch.cuda.synchronize()
                stream.synchronize()
        """,
    )
    found = _checks(locklint.run([bad]), "LL002")
    assert [f.message for f in found] == [
        "blocking torch.cuda.synchronize() while holding lock '_LOCK'",
        "blocking 'stream.synchronize()' while holding lock '_LOCK'",
    ]
    assert not jax_locklint.run([bad])


# --------------------------------------------------------------- shardcheck

_MESH_FIXTURE = """
    AXIS_ORDER = ("replica", "data", "pipeline", "expert", "seq", "model")
"""


def test_sc001_flags_undeclared_axis_and_passes_declared():
    mesh = _src("pkg/parallel/mesh.py", _MESH_FIXTURE)
    bad = _src(
        "pkg/mod.py",
        """
        from jax.sharding import PartitionSpec as P
        from jax import lax

        spec = P("model", "bogus")

        def f(x):
            return lax.psum(x, "tensor")
        """,
    )
    good = _src(
        "pkg/mod.py",
        """
        from jax.sharding import PartitionSpec as P
        from jax import lax

        spec = P("data", ("expert", "model"))

        def f(x, mesh):
            n = mesh.shape.get("model", 1)
            return lax.psum(x, "seq") + n
        """,
    )
    found = _checks(_run(shardcheck, mesh, bad), "SC001")
    assert {m for f in found for m in [f.message] if "'bogus'" in m}
    assert any("'tensor'" in f.message for f in found)
    assert len(found) == 2
    assert not _run(shardcheck, mesh, good)


def test_sc001_sees_the_ports_collectives():
    """The port's ``parallel/collectives.py`` forms (bare, ``coll.`` and
    ``collectives.``; the axis where each takes it) are checked too."""
    mesh = _src("pkg/parallel/mesh.py", _MESH_FIXTURE)
    bad = _src(
        "pkg/mod.py",
        """
        from pkg.parallel import collectives as coll
        from pkg.parallel.collectives import ppermute

        def f(x):
            y = coll.psum(x, "tensor") + ppermute(x, axis="ring")
            i = coll.axis_index("stage") + collectives.axis_size(axis_name="data")
            return coll.all_gather(y, ("seq", "bogus"), 0), i
        """,
    )
    found = shardcheck.run([mesh, bad])
    assert sorted(f.message.split("'")[1] for f in found) == ["bogus", "ring", "stage", "tensor"]
    assert not jax_shardcheck.run([mesh, bad])


def test_sc001_real_package_axes_all_declared():
    sources = iter_sources(REPO_ROOT)
    assert sources and all(s.rel.startswith(PORT + "/") for s in sources)
    axes = shardcheck.declared_axes(sources)
    assert axes == {"replica", "data", "pipeline", "expert", "seq", "model"}
    assert not shardcheck.run(sources)


@pytest.fixture(scope="module")
def sweeps():
    return shardcheck.run_config_sweep(), jax_shardcheck.run_config_sweep()


def test_sc002_layout_sweep_proves_fallback_not_crash(sweeps):
    (findings, matrix), _ = sweeps
    assert not findings
    by_layout = {
        (c["tp"], c["pp"], c["ep"]): c["outcome"]
        for c in matrix if "tp" in c
    }
    # CLI defaults and the parity layouts serve.
    assert by_layout[(1, 1, 1)] == "serves"
    assert by_layout[(2, 1, 1)] == "serves"
    assert by_layout[(4, 1, 1)] == "serves"
    # Oversized / non-dividing meshes warn and fall back.
    assert by_layout[(16, 1, 1)] == "falls_back"
    assert by_layout[(3, 1, 1)] == "falls_back"
    # Infeasible model/layout combos die in a clean ValueError.
    assert by_layout[(1, 1, 4)] == "rejects"
    sched = next(c for c in matrix if c.get("sweep") == "sched")
    rows = {
        (r["sched"], r["preempt"], r["preempt_margin_ms"],
         r["default_priority"]): r
        for r in sched["variants"]
    }
    assert len(rows) == len(shardcheck.SCHED_VARIANTS)
    assert rows[("edf", True, 20.0, 1)]["plans"]
    assert rows[("edf", True, 20.0, 1)]["flush_rejects"]
    assert rows[("edf", False, 20.0, 0)]["dynamic_rejects"]
    for bad in (
        ("fifo", True, 20.0, 1),
        ("lifo", False, 20.0, 1),
        ("edf", True, -5.0, 1),
        ("edf", False, 20.0, -1),
    ):
        assert "rejects" in rows[bad]


def test_sc002_matrix_equals_jax_cell_by_cell(sweeps):
    """Preset by layout by variant, the port's planners (``PRESETS``,
    ``plan_serve_mesh``, ``plan_disagg_mesh``, the engines' plans and the
    batchers' refusals) reach JAX's outcome, plan and message."""
    (port_findings, port_matrix), (jax_findings, jax_matrix) = sweeps
    assert port_findings == jax_findings == []
    assert len(port_matrix) == len(jax_matrix) == 17
    for got, want in zip(port_matrix, jax_matrix):
        assert got == want
    assert (shardcheck.DEFAULT_LAYOUTS, shardcheck.SCHED_VARIANTS) == (
        jax_shardcheck.DEFAULT_LAYOUTS, jax_shardcheck.SCHED_VARIANTS)


# ---------------------------------------------------------------- sanitizer


def test_sanitizer_seeded_cycle_detected():
    with sanitize_locks() as san:
        a = threading.Lock()
        b = threading.Lock()
        with a:
            with b:
                pass
        with b:
            with a:
                pass
        cycles = san.cycles()
        assert cycles, san.report()
        with pytest.raises(AssertionError):
            san.assert_no_cycles()
    # Patch restored on exit: locks are stdlib _thread.lock again.
    assert type(threading.Lock()).__name__ in ("lock", "LockType")


def test_sanitizer_consistent_order_is_clean():
    with sanitize_locks() as san:
        a = threading.Lock()
        b = threading.Lock()
        for _ in range(5):
            with a:
                with b:
                    pass
        assert san.acquisitions == 10
        assert not san.cycles()
        san.assert_no_cycles()


def test_sanitizer_tracks_stdlib_queue_condition_event():
    import queue

    with sanitize_locks() as san:
        q = queue.Queue(maxsize=2)
        cv = threading.Condition()
        done = threading.Event()

        def worker():
            for i in range(20):
                q.put(i)
            with cv:
                cv.notify_all()
            done.set()

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        got = [q.get() for _ in range(20)]
        with cv:
            cv.wait(timeout=0.2)
        assert done.wait(timeout=5)
        t.join(timeout=5)
        assert got == list(range(20))
        assert san.acquisitions > 0
        san.assert_no_cycles()


# ------------------------------------------------------------------- runner


def _run_analyze(*args: str) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, str(REPO_ROOT / "scripts" / "torch_analyze.py"), *args],
        capture_output=True,
        text=True,
        cwd=REPO_ROOT,
        timeout=120,
    )


def test_analyze_quick_is_clean_and_fast():
    t0 = time.monotonic()
    proc = _run_analyze("--quick", "--format", "json")
    elapsed = time.monotonic() - t0
    assert proc.returncode == 0, proc.stdout + proc.stderr
    report = json.loads(proc.stdout)
    assert report["ok"]
    assert report["active"] == []
    assert report["stale_baseline"] == []
    assert report["checks_run"] == ["LL001", "LL002", "LL003", "RC001", "RC002", "RC003",
                                    "SC001"]
    assert report["files"] == len(iter_sources(REPO_ROOT))
    # Suppressions exist and carry reasons.
    assert report["suppressed"]
    assert all(s["reason"] for s in report["suppressed"])
    assert elapsed < 30.0, f"quick mode took {elapsed:.1f}s (budget 30s)"


def test_analyze_seeded_violation_exits_nonzero(tmp_path):
    pkg = tmp_path / "seeded_pkg"
    pkg.mkdir()
    (pkg / "bad.py").write_text(
        textwrap.dedent(
            """
            import threading

            _LOCK = threading.Lock()

            def leak():
                _LOCK.acquire()
                return 1
            """
        )
    )
    proc = _run_analyze(
        "--root", str(tmp_path),
        "--package", "seeded_pkg",
        "--quick", "--no-baseline", "--format", "json",
    )
    assert proc.returncode == 1, proc.stdout + proc.stderr
    report = json.loads(proc.stdout)
    assert any(f["check"] == "LL001" for f in report["active"])


def _seed_git_repo(root: Path) -> None:
    env_flags = [
        "-c", "user.email=ci@example.invalid",
        "-c", "user.name=ci",
        "-c", "commit.gpgsign=false",
    ]

    def git(*args: str) -> None:
        subprocess.run(
            ["git", *env_flags, *args],
            cwd=root, check=True, capture_output=True, text=True, timeout=60,
        )
    git("init", "-q")
    git("add", "-A")
    git("commit", "-q", "-m", "seed")


def test_analyze_diff_mode_scopes_to_changed_files(tmp_path):
    """--diff analyzes only files changed vs the ref (plus untracked):
    a violation committed before the ref is invisible; the same violation
    in a fresh untracked file is reported."""
    pkg = tmp_path / "seeded_pkg"
    pkg.mkdir()
    violation = textwrap.dedent(
        """
        import threading

        _LOCK = threading.Lock()

        def leak():
            _LOCK.acquire()
            return 1
        """
    )
    (pkg / "old_bad.py").write_text(violation)
    _seed_git_repo(tmp_path)

    base = [
        "--root", str(tmp_path), "--package", "seeded_pkg",
        "--no-baseline", "--format", "json",
    ]
    proc = _run_analyze(*base, "--diff", "HEAD")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    report = json.loads(proc.stdout)
    assert report["diff_ref"] == "HEAD"
    assert report["files"] == 0 and report["active"] == []

    # New untracked file with the same bug IS in scope.
    (pkg / "new_bad.py").write_text(violation)
    proc = _run_analyze(*base, "--diff", "HEAD")
    assert proc.returncode == 1, proc.stdout + proc.stderr
    report = json.loads(proc.stdout)
    assert report["files"] == 1
    assert {f["path"] for f in report["active"]} == {"seeded_pkg/new_bad.py"}


def test_analyze_update_baseline_stamps_and_preserves(tmp_path):
    """--update-baseline regenerates the file: new findings get
    TODO-justify, hand-written reasons for findings that still match are
    carried over verbatim, and the rewritten baseline makes a rerun pass."""
    pkg = tmp_path / "seeded_pkg"
    (pkg / "analysis").mkdir(parents=True)
    (pkg / "bad.py").write_text(
        textwrap.dedent(
            """
            import threading

            _LOCK = threading.Lock()

            def leak():
                _LOCK.acquire()
                return 1

            def leak2():
                _LOCK.acquire()
                return 2
            """
        )
    )
    baseline_path = pkg / "analysis" / "baseline.json"
    baseline_path.write_text(
        json.dumps(
            {
                "suppressions": [
                    {
                        "id": "LL001:seeded_pkg/bad.py:leak",
                        "reason": "handwritten: leak() hands the lock to a C callback",
                    }
                ]
            }
        )
    )
    base = ["--root", str(tmp_path), "--package", "seeded_pkg", "--quick"]
    proc = _run_analyze(*base, "--update-baseline")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "TODO-justify: LL001:seeded_pkg/bad.py:leak2" in proc.stdout

    rewritten = json.loads(baseline_path.read_text())
    reasons = {e["id"]: e["reason"] for e in rewritten["suppressions"]}
    assert reasons["LL001:seeded_pkg/bad.py:leak"].startswith("handwritten:")
    assert reasons["LL001:seeded_pkg/bad.py:leak2"] == "TODO-justify"

    proc = _run_analyze(*base, "--format", "json")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert json.loads(proc.stdout)["active"] == []

    # Contradictory flag combinations are rejected up front.
    proc = _run_analyze(*base, "--update-baseline", "--diff", "HEAD")
    assert proc.returncode == 2
    proc = _run_analyze(*base, "--update-baseline", "--no-baseline")
    assert proc.returncode == 2


def test_stale_baseline_entries_fail_only_for_checks_run():
    baseline = Baseline(
        entries={
            "LL001:pkg/gone.py:f": "obsolete",
            "SC002:pkg/other.py:g": "config-stage suppression",
        }
    )
    result = apply_baseline([], baseline, checks_run=["LL001"])
    # LL001 ran and its entry matched nothing -> stale; SC002 did not run
    # (quick mode) so its entry must NOT be reported stale.
    assert result.stale == ["LL001:pkg/gone.py:f"]


def test_analyze_full_run_reports_the_sweep():
    """Without --quick the sweep runs (SC002 among the checks) and the
    report's keys are the JAX runner's."""
    proc = _run_analyze("--format", "json")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    report = json.loads(proc.stdout)
    assert set(report) == {"ok", "elapsed_s", "files", "diff_ref", "checks_run", "active",
                           "suppressed", "stale_baseline", "layout_matrix"}
    assert "SC002" in report["checks_run"] and len(report["layout_matrix"]) == 17


# ------------------------------------------------- the baseline and repairs


def test_every_baseline_entry_has_a_reason_and_a_jax_counterpart():
    """The port's suppressions: each names a reason, and the JAX
    baseline holds the same check on the same function (its path in the
    JAX package) with the same reason. (No Queue C entry is baselined:
    the lints' port-only findings were fixed.)"""
    port = load_baseline(REPO_ROOT / PORT / "analysis" / "baseline.json").entries
    jax = load_baseline(REPO_ROOT / "distributed_tensorflow_tpu" / "analysis"
                        / "baseline.json").entries
    assert port
    for sid, reason in port.items():
        check, path, scope = sid.split(":")
        assert reason, sid
        assert path.startswith(PORT + "/")
        twin = f"{check}:distributed_tensorflow_tpu/{path[len(PORT) + 1:]}:{scope}"
        assert jax.get(twin) == reason, sid
        assert not check.startswith("JL")


def test_port_findings_are_only_the_baselined_ones():
    """Every LL/RC/SC001 finding over the port is one of the baseline's:
    the profiler (LL001, LL002 in ``trace_steps`` and ``profile_window``)
    and the checkpoint writer (RC001 on ``_error``) no longer flag."""
    sources = iter_sources(REPO_ROOT)
    found = {f.suppress_id for f in locklint.run(sources) + racelint.run(sources)
             + shardcheck.run(sources)}
    assert found == set(load_baseline(REPO_ROOT / PORT / "analysis" / "baseline.json").entries)
    assert not [sid for sid in found if "obs/profile.py" in sid or "ckpt/" in sid]


def test_profiler_sessions_queue_without_holding_a_lock(tmp_path):
    """Two ``profile_window`` captures from two threads run one after
    the other (the session gate), and a third caller waiting for the gate
    waits on its condition, not on a held lock."""
    from distributed_tensorflow_tpu_torch.obs import profile

    spans = []

    def capture(i):
        out = profile.profile_window(tmp_path / str(i), 150.0, device="cpu")
        end = time.monotonic()
        spans.append((end - out["wall_ms"] / 1e3, end))  # the window, start to end

    ts = [threading.Thread(target=capture, args=(i,)) for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert len(spans) == 2
    (s0, e0), (s1, e1) = sorted(spans)
    assert e0 <= s1 + 0.05, spans  # the second window started after the first ended
    assert not profile._session_busy
    # An armed window owns the session until its Nth step; profile_window
    # waits for it.
    with profile.trace_steps(tmp_path / "armed", num_steps=1, device="cpu") as win:
        win.before_step()
        assert profile._session_busy
        done = threading.Event()
        t = threading.Thread(target=lambda: (profile.profile_window(
            tmp_path / "late", 1.0, device="cpu"), done.set()))
        t.start()
        assert not done.wait(0.3)
        win.after_step()
        assert done.wait(30)
        t.join(timeout=30)
    assert not profile._session_busy


def test_checkpoint_write_failure_reaches_wait(tmp_path, monkeypatch):
    """The writer thread's failure, handed over under the checkpointer's
    lock, is raised once by the caller's ``wait``."""
    from distributed_tensorflow_tpu_torch.ckpt import checkpoint

    ck = checkpoint.Checkpointer(tmp_path)

    def boom(directory, step, blob):
        raise OSError("disk full")

    monkeypatch.setattr(checkpoint, "_write", boom)
    t = threading.Thread(target=ck._write_and_prune, args=(1, {}))
    ck._thread = t
    t.start()
    with pytest.raises(OSError, match="disk full"):
        ck.wait()
    ck.wait()  # raised once, then cleared
