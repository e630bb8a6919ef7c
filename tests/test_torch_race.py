"""The port's racecheck: racelint fixtures + the racetrace runtime
sanitizer (analysis/racelint.py, obs/sanitizer.py).

Every test of the JAX package's ``tests/test_race.py`` over the port:

* racelint (RC001–RC003) — each seeded snippet goes through the JAX
  checker and the port's from the same text, both giving the same findings
  (check id, path, line, scope and message), and the port's meeting JAX's
  assertions;
* racetrace — in-process happens-before semantics (lock, thread
  start/join, and queue edges must order accesses; their absence must
  not), clean teardown, and module discovery through declared
  ``_RACETRACE_ATTRS`` (the port's batcher and its prefetch iterator);
* the seeded-race subprocess test — a barrier-forced interleaving that
  the port's racetrace must report deterministically with both stacks,
  and a lock-guarded twin that must report nothing.
"""

from __future__ import annotations

import ast
import queue
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import pytest

from distributed_tensorflow_tpu.analysis import racelint as jax_racelint
from distributed_tensorflow_tpu_torch.analysis import SourceFile
from distributed_tensorflow_tpu_torch.analysis import racelint as port_racelint
from distributed_tensorflow_tpu_torch.analysis.findings import iter_sources
from distributed_tensorflow_tpu_torch.obs.sanitizer import RaceSanitizer, sanitize_races

pytestmark = pytest.mark.analysis

REPO_ROOT = Path(__file__).resolve().parent.parent


def _src(rel: str, code: str) -> SourceFile:
    code = textwrap.dedent(code)
    return SourceFile(
        path=Path("/fixture") / rel, rel=rel, text=code, tree=ast.parse(code)
    )


def _checks(findings, check):
    return [f for f in findings if f.check == check]


class racelint:  # noqa: N801 — the JAX tests' call sites, unchanged
    """``racelint.run`` over the port, after asserting the JAX checker
    gives the same findings from the same text."""

    @staticmethod
    def run(sources):
        port = port_racelint.run(list(sources))
        jax = jax_racelint.run(list(sources))
        key = lambda f: (f.check, f.path, f.line, f.scope, f.message)  # noqa: E731
        assert sorted(map(key, port)) == sorted(map(key, jax))
        return port


# ------------------------------------------------------------------ RC001


def test_rc001_flags_unguarded_multi_context_writes():
    bad = _src(
        "pkg/mod.py",
        """
        import threading

        class C:
            def __init__(self):
                self.n = 0
                self._t = threading.Thread(target=self._work, daemon=True)
                self._t.start()

            def _work(self):
                self.n += 1

            def bump(self):
                self.n += 1
        """,
    )
    found = _checks(racelint.run([bad]), "RC001")
    assert len(found) == 1
    assert "'self.n'" in found[0].message
    assert "'_work'" in found[0].message and "'<caller>'" in found[0].message


def test_rc001_passes_common_lock_including_through_helper_calls():
    good = _src(
        "pkg/mod.py",
        """
        import threading

        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self.n = 0
                self._t = threading.Thread(target=self._work, daemon=True)
                self._t.start()

            def _work(self):
                with self._lock:
                    self._incr()

            def _incr(self):
                self.n += 1

            def bump(self):
                with self._lock:
                    self._incr()
        """,
    )
    assert not racelint.run([good])


def test_rc001_init_writes_are_exempt():
    # Construction happens-before Thread.start: writing in __init__ and in
    # exactly one thread context afterwards is not a multi-context write.
    good = _src(
        "pkg/mod.py",
        """
        import threading

        class C:
            def __init__(self):
                self.n = 0
                self._t = threading.Thread(target=self._work, daemon=True)
                self._t.start()

            def _work(self):
                self.n += 1
        """,
    )
    assert not _checks(racelint.run([good]), "RC001")


def test_rc001_sync_primitives_are_exempt():
    # Both contexts put into the same queue: that's the queue's job.
    good = _src(
        "pkg/mod.py",
        """
        import threading
        import queue

        class C:
            def __init__(self):
                self._q = queue.Queue()
                self._t = threading.Thread(target=self._work, daemon=True)
                self._t.start()

            def _work(self):
                self._q.put(1)

            def feed(self):
                self._q.put(2)
        """,
    )
    assert not racelint.run([good])


# ------------------------------------------------------------------ RC002


def test_rc002_flags_unguarded_check_then_act():
    bad = _src(
        "pkg/mod.py",
        """
        import threading

        class C:
            def __init__(self):
                self._closed = False
                self._t = threading.Thread(target=self._loop, daemon=True)
                self._t.start()

            def _loop(self):
                while not self._closed:
                    pass

            def close(self):
                if self._closed:
                    return
                self._closed = True
        """,
    )
    found = _checks(racelint.run([bad]), "RC002")
    assert len(found) == 1
    assert found[0].scope == "C.close"
    assert "'_closed'" in found[0].message


def test_rc002_passes_cv_guarded_check_then_act():
    # The DynamicBatcher.close idiom: test and act under the same lock.
    good = _src(
        "pkg/mod.py",
        """
        import threading

        class C:
            def __init__(self):
                self._cv = threading.Condition()
                self._closed = False
                self._t = threading.Thread(target=self._loop, daemon=True)
                self._t.start()

            def _loop(self):
                with self._cv:
                    if self._closed:
                        return

            def close(self):
                with self._cv:
                    if self._closed:
                        return
                    self._closed = True
        """,
    )
    assert not racelint.run([good])


def test_rc002_single_method_attrs_are_exempt():
    # Thread-confined consumer state (PrefetchIterator._done): tested and
    # written, but only ever touched by one method -> not shared.
    good = _src(
        "pkg/mod.py",
        """
        import threading

        class C:
            def __init__(self):
                self._done = False
                self._t = threading.Thread(target=self._loop, daemon=True)
                self._t.start()

            def _loop(self):
                pass

            def step(self):
                if self._done:
                    raise StopIteration
                self._done = True
        """,
    )
    assert not _checks(racelint.run([good]), "RC002")


def test_rc002_global_flags_unguarded_lazy_init_and_passes_locked():
    bad = _src(
        "pkg/mod.py",
        """
        _CACHE = None

        def get():
            global _CACHE
            if _CACHE is None:
                _CACHE = object()
            return _CACHE
        """,
    )
    good = _src(
        "pkg/mod.py",
        """
        import threading

        _CACHE = None
        _CACHE_LOCK = threading.Lock()

        def get():
            global _CACHE
            with _CACHE_LOCK:
                if _CACHE is None:
                    _CACHE = object()
                return _CACHE
        """,
    )
    found = _checks(racelint.run([bad]), "RC002")
    assert len(found) == 1 and found[0].scope == "get"
    assert "module global '_CACHE'" in found[0].message
    assert not racelint.run([good])


# ------------------------------------------------------------------ RC003


def test_rc003_flags_mutable_default_and_passes_none():
    bad = _src(
        "pkg/mod.py",
        """
        import threading

        class C:
            def __init__(self):
                self._t = threading.Thread(target=self._run, daemon=True)
                self._t.start()

            def _run(self):
                pass

            def submit(self, items=[]):
                items.append(1)
        """,
    )
    good = _src(
        "pkg/mod.py",
        """
        import threading

        class C:
            def __init__(self):
                self._t = threading.Thread(target=self._run, daemon=True)
                self._t.start()

            def _run(self):
                pass

            def submit(self, items=None):
                items = items or []
                items.append(1)
        """,
    )
    found = _checks(racelint.run([bad]), "RC003")
    assert len(found) == 1 and "mutable default" in found[0].message
    assert not racelint.run([good])


def test_rc003_flags_publication_after_thread_start():
    bad = _src(
        "pkg/mod.py",
        """
        import threading

        class C:
            def __init__(self):
                self._t = threading.Thread(target=self._run, daemon=True)
                self._t.start()
                self.results = []

            def _run(self):
                self.results.append(1)
        """,
    )
    good = _src(
        "pkg/mod.py",
        """
        import threading

        class C:
            def __init__(self):
                self.results = []
                self._t = threading.Thread(target=self._run, daemon=True)
                self._t.start()

            def _run(self):
                self.results.append(1)
        """,
    )
    found = _checks(racelint.run([bad]), "RC003")
    assert len(found) == 1 and "'self.results'" in found[0].message
    assert not racelint.run([good])


# ------------------------------------------------- racelint over the repo


def test_racelint_real_package_triage_holds():
    """The port over its own sources: no RC finding at all. The JAX
    package's two baselined lazy-init globals have no counterpart here (the
    port's ``initialize_runtime`` and ``_words`` hold no check-then-act),
    and the modules whose JAX twins carried genuine bugs (native build,
    prefetch close, batcher) stay clean, as do the router and the
    checkpoint writer."""
    found = {f.suppress_id for f in port_racelint.run(iter_sources(REPO_ROOT))}
    assert found == set(), found


# ------------------------------------------------------- racetrace (unit)


class _Shared:
    def __init__(self):
        self.counter = 0


def test_racetrace_detects_unordered_writes():
    barrier = threading.Barrier(2)  # pre-window: untracked, no HB edges
    with sanitize_races(watch={_Shared: ("counter",)}) as san:
        obj = _Shared()

        def bump():
            barrier.wait()
            for _ in range(50):
                obj.counter += 1

        ts = [threading.Thread(target=bump) for _ in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=10)
    assert san.races
    with pytest.raises(AssertionError, match="data race"):
        san.assert_race_free()


def test_racetrace_lock_edges_order_accesses():
    barrier = threading.Barrier(2)
    with sanitize_races(watch={_Shared: ("counter",)}) as san:
        obj = _Shared()
        lock = threading.Lock()  # created in-window -> tracked

        def bump():
            barrier.wait()
            for _ in range(50):
                with lock:
                    obj.counter += 1

        ts = [threading.Thread(target=bump) for _ in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=10)
    assert san.accesses >= 200
    san.assert_clean()


def test_racetrace_start_and_join_edges():
    with sanitize_races(watch={_Shared: ("counter",)}) as san:
        obj = _Shared()
        obj.counter = 5  # before start: ordered by the start edge

        def work():
            assert obj.counter == 5
            obj.counter = 7

        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=10)
        assert obj.counter == 7  # after join: ordered by the join edge
    san.assert_race_free()


def test_racetrace_queue_handoff_orders_accesses():
    with sanitize_races(watch={_Shared: ("counter",)}) as san:
        obj = _Shared()
        q = queue.Queue()  # in-window queue: internals are tracked locks

        def producer():
            obj.counter = 42
            q.put("ready")

        t = threading.Thread(target=producer)
        t.start()
        assert q.get(timeout=5) == "ready"
        assert obj.counter == 42
        t.join(timeout=10)
    san.assert_race_free()


def test_racetrace_reports_candidate_locks():
    # One thread accesses under a tracked lock, the other bare: the race
    # report must name the lock that would have ordered them.
    barrier = threading.Barrier(2)
    with sanitize_races(watch={_Shared: ("counter",)}) as san:
        obj = _Shared()
        lock = threading.Lock()

        def guarded():
            barrier.wait()
            for _ in range(20):
                with lock:
                    obj.counter += 1

        def bare():
            barrier.wait()
            for _ in range(20):
                obj.counter += 1

        ts = [threading.Thread(target=guarded), threading.Thread(target=bare)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=10)
    assert san.races
    assert any(r.candidate_locks for r in san.races)
    assert "would have ordered them" in san.race_report()


def test_racetrace_instrumentation_is_removed_on_exit():
    with sanitize_races(watch={_Shared: ("counter",)}):
        assert "__setattr__" in _Shared.__dict__
        assert "__getattribute__" in _Shared.__dict__
    assert "__setattr__" not in _Shared.__dict__
    assert "__getattribute__" not in _Shared.__dict__
    assert threading.Thread.start.__qualname__ == "Thread.start"
    assert threading.Thread.join.__qualname__ == "Thread.join"
    obj = _Shared()
    obj.counter = 1  # plain attribute semantics restored
    assert obj.counter == 1


def test_racetrace_inherits_lock_order_sanitizer():
    with sanitize_races() as san:
        assert isinstance(san, RaceSanitizer)
        san.assert_no_cycles()  # locktrace surface still available


@pytest.mark.parametrize("module, cls_name, attrs", [
    ("serve.batcher", "DynamicBatcher", ("_queues", "_count", "_closed", "_n_inflight")),
    ("data.prefetch", "PrefetchIterator", ("_done", "_closed")),
])
def test_racetrace_modules_discovery_uses_declared_attrs(module, cls_name, attrs):
    """Module discovery instruments every class that declares
    ``_RACETRACE_ATTRS`` (the JAX test's batcher, and the port's prefetch
    iterator, whose declaration is the JAX class's), and removes it on
    exit."""
    import importlib

    mod = importlib.import_module(f"distributed_tensorflow_tpu_torch.{module}")
    cls = getattr(mod, cls_name)
    assert cls._RACETRACE_ATTRS == attrs
    with sanitize_races(modules=[mod]):
        assert "__setattr__" in cls.__dict__
    assert "__setattr__" not in cls.__dict__


def test_prefetch_close_under_racetrace_is_clean():
    """The port's prefetch iterator run to its end and closed under the
    race sanitizer, its declared flags watched: no race."""
    import importlib

    # (``data.prefetch`` the attribute is the package's prefetch function.)
    prefetch = importlib.import_module("distributed_tensorflow_tpu_torch.data.prefetch")
    with sanitize_races(modules=[prefetch]) as san:
        it = prefetch.PrefetchIterator(iter(range(20)), depth=2)
        assert list(it) == list(range(20))
        it.close()
    assert san.accesses > 0
    san.assert_clean()


# -------------------------------------------------- seeded race (process)

_SEED_SCRIPT = """
import sys
import threading

sys.path.insert(0, {root!r})
from distributed_tensorflow_tpu_torch.obs.sanitizer import sanitize_races

GUARDED = "--guarded" in sys.argv


class Shared:
    def __init__(self):
        self.counter = 0


# Created BEFORE the window: the barrier forces both threads to race the
# same attribute at the same moment, but being untracked it contributes
# no happens-before edge that could mask the race.
barrier = threading.Barrier(2)

with sanitize_races(watch={{Shared: ("counter",)}}) as san:
    obj = Shared()
    lock = threading.Lock()

    def bump():
        barrier.wait()
        for _ in range(50):
            if GUARDED:
                with lock:
                    obj.counter += 1
            else:
                obj.counter += 1

    threads = [threading.Thread(target=bump, name=f"bump-{{i}}") for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)

print(san.race_report())
sys.exit(1 if san.races else 0)
"""


def _run_seeded(tmp_path: Path, *args: str) -> subprocess.CompletedProcess:
    script = tmp_path / "seeded_race.py"
    script.write_text(_SEED_SCRIPT.format(root=str(REPO_ROOT)))
    return subprocess.run(
        [sys.executable, str(script), *args],
        capture_output=True,
        text=True,
        timeout=60,
    )


def test_seeded_race_is_caught_deterministically_with_both_stacks(tmp_path):
    for _ in range(2):  # every run, not just a lucky interleaving
        proc = _run_seeded(tmp_path)
        assert proc.returncode == 1, proc.stdout + proc.stderr
        assert "data race on Shared.counter" in proc.stdout
        # Both access stacks point into the racing function.
        assert proc.stdout.count("in bump") >= 2
        assert "no tracked lock has ever guarded" in proc.stdout


def test_seeded_race_conforming_twin_is_clean(tmp_path):
    proc = _run_seeded(tmp_path, "--guarded")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 race(s)" in proc.stdout
