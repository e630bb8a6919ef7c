"""The training loop (port of ``train/loop.py``).

Plain Python around the train step; hooks are plain callables, and only
rank 0 (:func:`..parallel.mesh.process_index`) logs. Under several
processes ``fit`` ends at a barrier once rank 0's last checkpoint is
durable, so no rank returns before it is whole.

As in the JAX package:

- the loop reads device values only at the log cadence: metrics stay 0-d
  device tensors and are fetched every ``log_every`` steps in one copy, so
  the card's stream of steps is never drained in between;
- the feed is pull-ahead: step ``i`` is enqueued before batch ``i+1`` is
  fetched, so host batch assembly overlaps device work, and every blocking
  ``next(it)`` is timed into ``feed_metrics`` (``host_wait_ms`` at the log
  cadence);
- logged throughput is steady-state: the clock restarts after the first
  step, so warm-up (kernel builds, allocator growth) never dilutes
  ``steps_per_sec``.
"""

from __future__ import annotations

import logging
import math
import time
from collections.abc import Callable, Iterable, Iterator
from typing import Any

import torch

from distributed_tensorflow_tpu_torch.obs.flightrec import NULL_RECORDER
from distributed_tensorflow_tpu_torch.obs.memory import default_registry
from distributed_tensorflow_tpu_torch.obs.metrics import FeedMetrics
from distributed_tensorflow_tpu_torch.obs.trace import NULL_TRACER, Tracer
from distributed_tensorflow_tpu_torch.parallel.mesh import barrier, process_index

logger = logging.getLogger(__name__)

# hook(step: int, state, metrics: dict[str, float]) -> None, called at log cadence
Hook = Callable[[int, Any, dict], None]


class NonFiniteLossError(RuntimeError):
    """The step loss went NaN/Inf: the training state is garbage from here.

    Raised by the loop's non-finite guard (``fit(nonfinite="abort")``, the
    default); restarting from the last checkpoint would replay the same
    divergence, so it is not a transient failure.
    """

    def __init__(self, step: int, loss: float):
        super().__init__(
            f"non-finite loss {loss!r} at step {step}; aborting (use "
            "nonfinite='skip' to tolerate)"
        )
        self.step = step
        self.loss = loss


def fit(
    state,
    train_step,
    data: Iterable,
    *,
    num_steps: int,
    rng: torch.Generator | None = None,
    log_every: int = 100,
    hooks: tuple[Hook, ...] = (),
    checkpointer=None,
    ckpt_every: int = 0,
    evaluate: Callable[[Any], dict] | None = None,
    eval_every: int = 0,
    feed_metrics: FeedMetrics | None = None,
    tracer: Tracer | None = None,
    timeline=None,
    memory=None,
    recorder=None,
    fault_injector=None,
    nonfinite: str = "abort",
    should_stop: Callable[[], bool] | None = None,
):
    """Run the training loop; returns ``(state, last_metrics)``.

    ``data`` yields batches already on the step's device
    (:func:`~..data.text.mlm_device_batches`). ``rng`` is the run's
    ``torch.Generator`` (default: seed 0 on the parameters' device); the
    step folds the step number into it. ``checkpointer``/``ckpt_every``
    save every ``ckpt_every`` steps (the generator state with the train
    state); ``evaluate(state) -> dict`` runs every ``eval_every`` steps and
    at the end, its metrics reaching the hooks prefixed ``eval_``.

    ``tracer`` (:mod:`..obs.trace`) records ``host_wait`` and ``dispatch``
    spans every step, ``device``/``metrics_fetch`` at the log cadence and
    ``checkpoint_save``/``eval`` spans, each with its ``step``. ``memory``
    (default the process-wide registry) receives the ``params`` and
    ``grad_ring`` byte counts at loop entry and ``opt_state`` after the
    first step (torch's optimizers create their slots at the first update).
    ``recorder`` receives the loop's failure-path events
    (``nonfinite_loss``); ``fault_injector`` (:mod:`.faultinject`) is
    consulted once per step before dispatch: a ``slow_step`` sleeps there,
    a ``host_drop`` dumps the recorder and kills the process, and a
    ``nonfinite_loss`` poisons the FETCHED loss at the next log cadence
    (the state is untouched), so the guard below runs on the real signal
    path.

    ``timeline`` (:class:`~..obs.fleet.StepTimeline`) records every step's
    whole-iteration wall time (eval and checkpoint saves included), its
    pull-ahead ``next(it)`` wait and its dispatch time, and runs the
    in-line straggler detector: the per-host view the fleet beacons
    publish. ``None`` records nothing; ``scripts/torch_timeline_cost.py``
    measures what a timeline costs a training step.

    ``nonfinite`` is the NaN/Inf-loss policy, checked at the log cadence
    (no extra device syncs; up to ``log_every - 1`` poisoned steps can run
    before detection): ``"abort"`` raises :class:`NonFiniteLossError`,
    ``"skip"`` records the event and trains on. ``should_stop`` is polled
    once per step; True ends the loop cleanly with the current state (the
    preemption path: :mod:`.resilience` wires its SIGTERM/SIGINT flag here).
    """
    if tracer is None:
        tracer = NULL_TRACER
    if recorder is None:
        recorder = NULL_RECORDER
    if nonfinite not in ("abort", "skip"):
        raise ValueError(f"nonfinite must be 'abort' or 'skip', got {nonfinite!r}")
    if rng is None:
        device = next(iter(state.params.values())).device
        rng = torch.Generator(device).manual_seed(0)
    if memory is None:
        memory = default_registry()
    memory.register_tree("params", state.params)
    if state.grad_buffer is not None:
        memory.register_tree("grad_ring", state.grad_buffer)
    it: Iterator = iter(data)
    if feed_metrics is None:
        feed_metrics = getattr(data, "metrics", None) or FeedMetrics()
    rank0 = process_index() == 0
    pending_metrics = None
    start_step = int(state.step)
    if start_step >= num_steps:
        return state, None  # restored at (or past) the final step
    poison_step = None  # injected nonfinite_loss pending detection
    t0 = time.perf_counter()  # run origin (only used if the run is 1 step)
    t_steady = None           # reset after the first step: excludes warm-up
    t_fetch = time.perf_counter()
    with tracer.span("host_wait", "train", step=start_step):
        batch = next(it)
    feed_metrics.observe_wait(time.perf_counter() - t_fetch)
    for step in range(start_step, num_steps):
        if should_stop is not None and should_stop():
            logger.info("stop requested before step %d; leaving the loop", step)
            break
        poison = fault_injector.on_step(step) if fault_injector is not None else False
        t_iter = time.perf_counter()
        wait_s = 0.0
        with tracer.span("dispatch", "train", step=step):
            state, metrics = train_step(state, batch, rng)
        if poison and poison_step is None:
            # Injected nonfinite_loss: the FETCHED loss is poisoned at the
            # next log cadence, where the guard runs; the state is not.
            poison_step = step + 1
        dispatch_s = time.perf_counter() - t_iter
        if t_steady is None:
            t_steady = time.perf_counter()
            memory.register_tree("opt_state", state.opt_state.slots())
        if step + 1 < num_steps:
            # Pull-ahead: fetch batch i+1 while the card runs step i.
            t_fetch = time.perf_counter()
            with tracer.span("host_wait", "train", step=step + 1):
                batch = next(it)
            wait_s = time.perf_counter() - t_fetch
            feed_metrics.observe_wait(wait_s)
        if log_every and ((step + 1) % log_every == 0 or step + 1 == num_steps):
            # The one point the loop waits for the card: a single copy of
            # every metric.
            keys = list(metrics)
            with tracer.span("device", "train", step=step + 1):
                host = torch.stack([metrics[k].float().reshape(()) for k in keys]).cpu()
            with tracer.span("metrics_fetch", "train", step=step + 1):
                fetched = dict(zip(keys, host.tolist()))
            if poison_step is not None and "loss" in fetched:
                fetched["loss"] = float("nan")
                poison_step = None
            loss = fetched.get("loss")
            if loss is not None and not math.isfinite(loss):
                recorder.record(
                    "nonfinite_loss", step=step + 1, loss=str(loss), action=nonfinite,
                )
                if nonfinite == "abort":
                    raise NonFiniteLossError(step + 1, loss)
                logger.warning(
                    "non-finite loss %r at step %d (nonfinite=skip: training on)",
                    loss, step + 1,
                )
            now = time.perf_counter()
            steps_done = step - start_step  # steady-state steps completed
            if steps_done > 0:
                dt = now - t_steady
            else:
                dt, steps_done = now - t0, 1
            fetched["steps_per_sec"] = steps_done / dt if dt > 0 else 0.0
            fetched.update(feed_metrics.window())
            if rank0:
                logger.info(
                    "step %d: %s", step + 1,
                    " ".join(f"{k}={v:.5g}" for k, v in sorted(fetched.items())),
                )
            for hook in hooks:
                hook(step + 1, state, fetched)
            pending_metrics = fetched
        if evaluate is not None and eval_every and (
            (step + 1) % eval_every == 0 or step + 1 == num_steps
        ):
            with tracer.span("eval", "train", step=step + 1):
                ev = {f"eval_{k}": float(v) for k, v in evaluate(state).items()}
            if rank0:
                logger.info(
                    "step %d eval: %s", step + 1,
                    " ".join(f"{k}={v:.5g}" for k, v in sorted(ev.items())),
                )
            for hook in hooks:
                hook(step + 1, state, ev)
            pending_metrics = {**(pending_metrics or {}), **ev}
        if checkpointer is not None and ckpt_every and (step + 1) % ckpt_every == 0:
            with tracer.span("checkpoint_save", "train", step=step + 1):
                checkpointer.save(step + 1, state, generator=rng)
        if timeline is not None:
            # Whole-iteration wall time: a step slowed by eval or a save IS
            # slow to the fleet; the detector's trailing median keeps such
            # periodic spikes out of the baseline.
            timeline.record_step(step + 1, time.perf_counter() - t_iter,
                                 host_wait_s=wait_s, dispatch_s=dispatch_s)
    if checkpointer is not None:
        checkpointer.wait()
    barrier()
    return state, pending_metrics
