"""Profiling: ``torch.profiler`` windows around training steps or a live
server (port of ``obs/profile.py``).

Each window records CPU activity, and the card's kernels and copies when
the device is CUDA (CUPTI), and writes one Chrome trace
(``<host>_<pid>.<ns>.pt.trace.json``) under ``logdir``: open it in Perfetto
or ``chrome://tracing``, or read its ``"kernel"`` events.

Only process 0 traces (the metric writers' gate: one profile a job); other
processes get a no-op window, so call sites stay branch-free. Three
capture shapes:

- ``trace_steps(logdir)``: everything run inside the ``with`` block
  (``cli/train.py --profile-dir``).
- ``trace_steps(logdir, num_steps=N)``: an ARMED window — the profiler
  starts at the first step and stops after exactly N, synchronising on the
  Nth step's outputs first so the device tail lands in the trace
  (``cli/train.py --profile-steps``). The yielded window's
  ``before_step()``/``after_step(out)`` bracket each step.
- :func:`profile_window`: a bounded wall-clock capture for a RUNNING
  process — what ``POST /profilez?ms=N`` serves.

The profiler is process-global: one session at a time, every window
queueing for it (:func:`_enter_session`). Unlike the JAX package's module
lock held across the window, the gate's condition guards only its busy
flag, so a window's steps, sleep and device synchronisation run with no
lock held.
"""

from __future__ import annotations

import contextlib
import os
import socket
import threading
import time
from pathlib import Path

import torch

# One profiler session a process: concurrent /profilez calls (a thread per
# request) or a profilez during a --profile-steps window must queue. The
# condition guards the busy flag only; sessions wait on it.
_SESSION = threading.Condition()
_session_busy = False


def _enter_session() -> None:
    """Wait until no profiler session runs, then own the profiler."""
    global _session_busy
    with _SESSION:
        while _session_busy:
            _SESSION.wait()
        _session_busy = True


def _exit_session() -> None:
    global _session_busy
    with _SESSION:
        _session_busy = False
        _SESSION.notify_all()


def _device(device) -> torch.device:
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    return torch.device(device)


def _start(device: torch.device) -> torch.profiler.profile:
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def _stop(prof: torch.profiler.profile, logdir: Path) -> Path:
    prof.stop()
    path = logdir / f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}.pt.trace.json"
    prof.export_chrome_trace(str(path))
    return path


class _NullWindow:
    """No-op window: non-chief processes and the whole-block mode."""

    trace_path = None

    def before_step(self) -> None:
        pass

    def after_step(self, out=None) -> None:
        pass


class _StepWindow:
    """Armed N-step window: the first ``before_step`` starts the profiler,
    the Nth ``after_step`` synchronises the device and stops it."""

    def __init__(self, logdir: Path, num_steps: int, device: torch.device):
        if num_steps < 1:
            raise ValueError(f"num_steps must be >= 1, got {num_steps}")
        self._logdir = logdir
        self._num_steps = num_steps
        self._device = device
        self._seen = 0
        self._prof = None
        self._done = False
        self.trace_path: Path | None = None

    def before_step(self) -> None:
        if self._done or self._prof is not None:
            return
        _enter_session()
        try:
            self._prof = _start(self._device)
        except BaseException:
            # A failed start must not leave the session owned forever.
            _exit_session()
            raise

    def after_step(self, out=None) -> None:
        if self._prof is None:
            return
        self._seen += 1
        if self._seen >= self._num_steps:
            # The step's outputs are on the device's stream: wait for them
            # so the window holds the Nth step's kernels.
            if self._device.type == "cuda":
                torch.cuda.synchronize(self._device)
            self.close()

    def close(self) -> None:
        if self._prof is None:
            return
        try:
            self.trace_path = _stop(self._prof, self._logdir)
        finally:
            # Even if the export fails the window is over: end the session
            # so later windows and /profilez still run.
            self._prof = None
            self._done = True
            _exit_session()


@contextlib.contextmanager
def trace_steps(logdir: str | Path, num_steps: int | None = None, *, device=None):
    """Context manager: profile the steps run inside it, process 0 only.

    ``device`` (default: the card when there is one) decides whether CUDA
    activity is recorded. Usage (armed N-step window)::

        with trace_steps("/tmp/prof", num_steps=3, device="cuda") as win:
            for _ in range(100):
                win.before_step()
                state, m = train_step(state, next(batches), rng)
                win.after_step((state, m))   # steps 1..3 land in the trace
    """
    from distributed_tensorflow_tpu_torch.parallel.mesh import process_index

    if process_index() != 0:
        yield _NullWindow()
        return
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    dev = _device(device)
    if num_steps is None:
        _enter_session()
        try:
            prof = _start(dev)
            try:
                yield _NullWindow()
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            finally:
                _stop(prof, logdir)
        finally:
            _exit_session()
        return
    win = _StepWindow(logdir, num_steps, dev)
    try:
        yield win
    finally:
        win.close()  # a run shorter than N steps: stop cleanly anyway


def profile_window(logdir: str | Path, ms: float, *, device=None) -> dict:
    """Capture a bounded ``ms``-long profiler window NOW (live process).

    Blocks the calling thread for the window (the /profilez handler thread,
    not the serving hot path), clamped to [1 ms, 60 s]. Returns the capture
    summary the endpoint replies with: ``trace_dir``, ``requested_ms``,
    ``wall_ms`` (and the trace file's ``path``).
    """
    ms = min(max(float(ms), 1.0), 60_000.0)
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    dev = _device(device)
    _enter_session()
    try:
        t0 = time.perf_counter()
        prof = _start(dev)
        try:
            time.sleep(ms / 1e3)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        finally:
            path = _stop(prof, logdir)
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        _exit_session()
    return {"trace_dir": str(logdir), "requested_ms": ms, "wall_ms": wall_ms,
            "path": str(path)}
