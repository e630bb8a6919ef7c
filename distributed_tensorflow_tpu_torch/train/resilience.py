"""Preemption-safe supervised training: the reaction half of fleet health.

:mod:`..obs.fleet` is the *detection* substrate (StragglerDetector,
HostBeacons, ``fleet_summary``); this module is what a host actually DOES
about failure — the modern image of the reference's MonitoredTrainingSession
+ Supervisor recovery loop (SURVEY.md §5), minus the chief:

- :func:`run_resilient` wraps :func:`~..train.loop.fit` in a restart
  loop. Transient failures (feeder errors, checkpoint-storage IO —
  anything a retry can fix) restore from ``Checkpointer.restore_latest``
  and re-enter the loop with capped exponential backoff; the data stream
  is rebuilt through the producers' ``start_step`` resume contract
  (data/prefetch.py), so a restarted run consumes batches N.. exactly as
  an uninterrupted one would. Fatal failures (non-finite loss, shape
  errors — a restart would replay the divergence) dump the flight
  recorder and re-raise.
- :class:`PreemptionHandler` turns SIGTERM/SIGINT into a clean stop: the
  loop exits at the next step boundary, a final SYNCHRONOUS checkpoint is
  written (with the run's generator), and the run returns with
  ``preempted=True``. The stop is this process's own: under several ranks
  nothing agrees on it across the ranks, as in the JAX package.
- :class:`ResilientCheckpointer` makes periodic saves non-fatal: one
  immediate retry, then the failure is absorbed (flight-recorder
  ``ckpt_save_error`` event + ``ckpt_save_errors_total`` counter) and
  training continues on the still-good step stream — aborting only after
  ``max_consecutive`` failed save CADENCES, when the restart-loss bound
  the operator configured via ``ckpt_every`` no longer holds.

The restart budget is progress-aware: a restart that resumes from a
NEWER checkpoint than the previous failure resets the consecutive-failure
count (the job is limping forward); only restarts that make no progress
burn the budget, so a persistent fault cannot flap forever.

Port of the JAX package's ``train/resilience.py``. One difference follows
from the port's state: the train step updates the parameters IN PLACE, so
a restart restores in place too — ``restore_latest`` copies the newest
checkpoint into the live state (and its generator state into the run's
generator), which is therefore its own template. The JAX package's
``abstract_like`` (a buffer-free skeleton kept because its compiled step
donates the live buffers) has no job here and is not ported. Without a
checkpoint to restore, a restart needs ``make_state()``: the live
parameters have already moved, so restarting from them would hide the
loss, and the failure is re-raised instead.

Elastic re-mesh composes from the outside: when the
:class:`~..obs.fleet.FleetSupervisor` decides ``re_mesh``, the relaunch
plans the survivors' layout with ``parallel.mesh.plan_elastic_mesh`` (the
same global batch, ``grad_accum`` making up the lost ranks), builds a fresh
state and ``restore_latest`` reads the replicated checkpoint into it.
"""

from __future__ import annotations

import dataclasses
import logging
import signal
import threading
import time
from collections.abc import Callable, Iterable
from typing import Any

from distributed_tensorflow_tpu_torch.obs.flightrec import NULL_RECORDER
from distributed_tensorflow_tpu_torch.obs.metrics import Counter
from distributed_tensorflow_tpu_torch.train.loop import NonFiniteLossError, fit

logger = logging.getLogger(__name__)

__all__ = [
    "CheckpointSaveError",
    "PreemptionHandler",
    "ResilienceConfig",
    "ResilienceReport",
    "ResilientCheckpointer",
    "RestartBudgetExhausted",
    "classify_failure",
    "run_resilient",
    "train_restarts_total",
    "ckpt_save_errors_total",
]

#: process-wide resilience counters.
train_restarts_total = Counter()
ckpt_save_errors_total = Counter()


class CheckpointSaveError(RuntimeError):
    """Too many consecutive periodic-save failures — the operator's
    configured restart-loss bound (``ckpt_every``) no longer holds, so
    continuing would be silent risk accumulation. Fatal by design."""


class RestartBudgetExhausted(RuntimeError):
    """The consecutive no-progress restart budget ran out."""


def classify_failure(exc: BaseException) -> str:
    """``"transient"`` (retry from the last checkpoint) or ``"fatal"``.

    Transient: storage/feed IO — :class:`OSError` (which covers
    ``InjectedFault``, ``ConnectionError``, ``TimeoutError``) and the
    prefetch wrapper's feeder-death RuntimeError. Fatal: everything a
    replay would reproduce — non-finite loss, shape/dtype errors
    (TypeError/ValueError), exhausted save budget, and anything unknown
    (when in doubt, stop loudly rather than loop).
    """
    if isinstance(exc, (NonFiniteLossError, CheckpointSaveError)):
        return "fatal"
    if isinstance(exc, OSError):
        return "transient"
    if isinstance(exc, RuntimeError) and "feeder" in str(exc):
        return "transient"
    return "fatal"


@dataclasses.dataclass
class ResilienceConfig:
    """Knobs for :func:`run_resilient` (CLI: ``--max-restarts``)."""

    max_restarts: int = 3            # consecutive no-progress restarts
    backoff_base_s: float = 0.5      # first retry delay
    backoff_factor: float = 2.0      # exponential growth per retry
    backoff_max_s: float = 30.0      # cap
    max_consecutive_ckpt_failures: int = 3
    preemption_signals: tuple[int, ...] = (signal.SIGTERM, signal.SIGINT)
    sleep: Callable[[float], None] = time.sleep  # injectable for tests

    def backoff_s(self, consecutive: int) -> float:
        return min(
            self.backoff_base_s * self.backoff_factor ** max(consecutive - 1, 0),
            self.backoff_max_s,
        )


class PreemptionHandler:
    """SIGTERM/SIGINT → a stop flag the training loop polls.

    The handler body only sets a :class:`threading.Event` and remembers
    the signal — no locks, no I/O (a signal can interrupt the main thread
    while it holds e.g. the flight-recorder lock; anything lock-taking
    here could deadlock). The interesting work (final checkpoint, the
    ``preempt_exit`` event) happens in :func:`run_resilient` after the
    loop exits. Installs only from the main thread (``signal.signal``'s
    own rule); elsewhere it degrades to a manual flag.
    """

    def __init__(self, signals: tuple[int, ...] = (signal.SIGTERM, signal.SIGINT)):
        self._signals = signals
        self._flag = threading.Event()
        self._prev: dict[int, Any] = {}
        self.signum: int | None = None

    def install(self) -> "PreemptionHandler":
        for s in self._signals:
            try:
                self._prev[s] = signal.signal(s, self._handle)
            except ValueError:
                # Not the main thread: no OS hook, the flag still works.
                logger.warning(
                    "cannot install preemption handler outside the main thread"
                )
                break
        return self

    def _handle(self, signum, frame) -> None:
        self.signum = signum
        self._flag.set()

    def should_stop(self) -> bool:
        return self._flag.is_set()

    @property
    def triggered(self) -> bool:
        return self._flag.is_set()

    def restore(self) -> None:
        """Reinstall the previous handlers (idempotent)."""
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()


class ResilientCheckpointer:
    """``Checkpointer`` wrapper making periodic saves non-fatal.

    ``save`` retries once immediately; a cadence where both attempts fail
    is absorbed (event + counter + warning) until ``max_consecutive``
    cadences fail in a row — then :class:`CheckpointSaveError` (fatal).
    Any successful save resets the run. ``restore_latest`` first drains
    in-flight async saves (a restore racing its own pending write would
    read a half-finalized step).
    """

    def __init__(self, inner, *, max_consecutive: int = 3, recorder=None):
        self._inner = inner
        self.max_consecutive = max_consecutive
        self.recorder = recorder if recorder is not None else NULL_RECORDER
        self.consecutive_failures = 0

    def save(self, step: int, state: Any, *, generator=None) -> None:
        err = None
        for attempt in (1, 2):
            try:
                self._inner.save(step, state, generator=generator)
                self.consecutive_failures = 0
                return
            except Exception as e:  # noqa: BLE001 — absorbing is the point
                err = e
                ckpt_save_errors_total.inc()
                self.recorder.record(
                    "ckpt_save_error", step=step, attempt=attempt,
                    error=type(e).__name__,
                )
                logger.warning(
                    "checkpoint save at step %d failed (attempt %d): %s",
                    step, attempt, e,
                )
        self.consecutive_failures += 1
        if self.consecutive_failures >= self.max_consecutive:
            raise CheckpointSaveError(
                f"{self.consecutive_failures} consecutive checkpoint-save "
                f"cadences failed (last at step {step}); the configured "
                "restart-loss bound no longer holds"
            ) from err
        logger.warning(
            "continuing without checkpoint at step %d (%d/%d consecutive "
            "save failures)",
            step, self.consecutive_failures, self.max_consecutive,
        )

    def wait_quiet(self) -> None:
        """Drain async writes; a failed in-flight write counts as a save
        error instead of propagating (the restore falls back to the last
        durable step either way)."""
        try:
            self._inner.wait()
        except Exception as e:  # noqa: BLE001
            ckpt_save_errors_total.inc()
            self.recorder.record(
                "ckpt_save_error", step=-1, attempt=0, error=type(e).__name__
            )
            logger.warning("async checkpoint flush failed: %s", e)

    def latest_step(self):
        # The port's Checkpointer.latest_step waits for the write in flight
        # and re-raises its failure; drain it quietly first, so a failed
        # background write costs a save, not the restart that asks.
        self.wait_quiet()
        return self._inner.latest_step()

    def restore_latest(self, state: Any, *, generator=None):
        self.wait_quiet()
        return self._inner.restore_latest(state, generator=generator)

    def wait(self) -> None:
        self._inner.wait()

    def close(self) -> None:
        self._inner.close()


@dataclasses.dataclass
class ResilienceReport:
    """What :func:`run_resilient` hands back."""

    state: Any
    metrics: dict | None
    final_step: int
    completed: bool            # reached num_steps
    preempted: bool            # stopped on SIGTERM/SIGINT
    restarts: int              # transient-failure restarts performed
    failures: list[dict]       # [{step, error, kind}] per caught failure


def run_resilient(
    state,
    train_step,
    make_batches: Callable[[int], Iterable],
    *,
    num_steps: int,
    checkpointer=None,
    ckpt_every: int = 0,
    config: ResilienceConfig | None = None,
    recorder=None,
    fault_injector=None,
    make_state: Callable[[], Any] | None = None,
    **fit_kwargs,
) -> ResilienceReport:
    """Supervised :func:`fit`: restarts on transient failure, stops
    cleanly on preemption.

    ``make_batches(start_step)`` builds a fresh batch stream positioned
    at ``start_step`` — the producers' resume contract; each segment's
    stream is closed when the segment ends. ``make_state()`` (optional)
    rebuilds a fresh initial state for a restart that finds NO checkpoint
    to restore (without it, such a failure is re-raised: the step has
    already moved the live parameters, and restarting from them silently
    would hide real data loss). A restart restores the newest checkpoint
    into ``state`` in place, with its generator state into
    ``fit_kwargs["rng"]``; the final preemption save carries that
    generator too.

    Returns a :class:`ResilienceReport`; transient restarts are invisible
    to the caller beyond its counters. See the module docstring for the
    classification and budget rules.
    """
    config = config or ResilienceConfig()
    recorder = recorder if recorder is not None else NULL_RECORDER
    rckpt = None
    if checkpointer is not None:
        rckpt = ResilientCheckpointer(
            checkpointer,
            max_consecutive=config.max_consecutive_ckpt_failures,
            recorder=recorder,
        )
    rng = fit_kwargs.get("rng")
    handler = PreemptionHandler(config.preemption_signals).install()
    failures: list[dict] = []
    restarts = 0
    consecutive = 0
    last_resume_step = int(state.step)
    try:
        while True:
            start = int(state.step)
            batches = make_batches(start)
            try:
                state, metrics = fit(
                    state,
                    train_step,
                    batches,
                    num_steps=num_steps,
                    checkpointer=rckpt,
                    ckpt_every=ckpt_every,
                    recorder=recorder,
                    fault_injector=fault_injector,
                    should_stop=handler.should_stop,
                    **fit_kwargs,
                )
            except Exception as e:  # noqa: BLE001 — classified below
                _close(batches)
                kind = classify_failure(e)
                failures.append(
                    {"step": start, "error": type(e).__name__, "kind": kind}
                )
                if kind != "transient":
                    recorder.record(
                        "train_fatal", error=type(e).__name__, start_step=start
                    )
                    recorder.dump("train_fatal", force=True)
                    raise
                resume_step = rckpt.latest_step() if rckpt is not None else None
                progress = resume_step is not None and resume_step > last_resume_step
                consecutive = 1 if progress else consecutive + 1
                if consecutive > config.max_restarts:
                    recorder.record(
                        "train_fatal", error="RestartBudgetExhausted",
                        start_step=start,
                    )
                    recorder.dump("train_fatal", force=True)
                    raise RestartBudgetExhausted(
                        f"{consecutive - 1} consecutive restarts made no "
                        f"progress past step {last_resume_step} "
                        f"(budget {config.max_restarts}); last failure: "
                        f"{type(e).__name__}: {e}"
                    ) from e
                restarts += 1
                train_restarts_total.inc()
                delay = config.backoff_s(consecutive)
                recorder.record(
                    "train_restart", restart=restarts, error=type(e).__name__,
                    resume_step=resume_step if resume_step is not None else -1,
                    backoff_s=delay,
                )
                logger.warning(
                    "transient failure (%s: %s); restart %d in %.1fs",
                    type(e).__name__, e, restarts, delay,
                )
                config.sleep(delay)
                state = _restore(rckpt, state, rng, make_state, e)
                last_resume_step = int(state.step)
                continue
            _close(batches)
            step_now = int(state.step)
            if handler.triggered:
                if rckpt is not None and rckpt.latest_step() != step_now:
                    # The preemption contract: a SYNCHRONOUS save — queue
                    # it, then block until durable before exiting.
                    rckpt.save(step_now, state, generator=rng)
                    rckpt.wait_quiet()
                recorder.record(
                    "preempt_exit", step=step_now,
                    signum=handler.signum if handler.signum is not None else -1,
                )
                logger.warning(
                    "preempted (signal %s): checkpointed at step %d, "
                    "exiting cleanly", handler.signum, step_now,
                )
                return ResilienceReport(
                    state=state, metrics=metrics, final_step=step_now,
                    completed=False, preempted=True, restarts=restarts,
                    failures=failures,
                )
            return ResilienceReport(
                state=state, metrics=metrics, final_step=step_now,
                completed=True, preempted=False, restarts=restarts,
                failures=failures,
            )
    finally:
        handler.restore()


def _restore(rckpt, state, rng, make_state, cause: BaseException):
    """The state for a restart: the newest checkpoint copied into the live
    state (and its generator state into ``rng``) when one exists,
    ``make_state()`` when the run never checkpointed, else give up."""
    if rckpt is not None and rckpt.latest_step() is not None:
        state, step = rckpt.restore_latest(state, generator=rng)
        logger.info("restarting from checkpoint at step %d", step)
        return state
    if make_state is not None:
        logger.info("no checkpoint to restore; restarting from a fresh state")
        return make_state()
    raise RuntimeError(
        "transient failure before any checkpoint existed and no make_state "
        "factory was provided; cannot restart (the step has already updated "
        "the live parameters in place)"
    ) from cause


def _close(batches) -> None:
    close = getattr(batches, "close", None)
    if close is not None:
        try:
            close()
        except Exception as e:  # noqa: BLE001 — teardown must not mask the run
            logger.warning("batch-stream close failed: %s", e)
