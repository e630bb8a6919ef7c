"""Deterministic fault injection: seeded failure schedules for chaos runs.

The reference cluster's failure modes (SURVEY.md §5: preempted workers,
wedged input readers, corrupt saver writes) are *hypothesized* in most
rebuilds — here every one of them is a first-class, reproducible event. A
:class:`FaultPlan` is a seeded schedule of fault events; a
:class:`FaultInjector` carries that schedule into the three hook points
that cover the failure surface:

- ``train/loop.py::fit`` — ``slow_step`` (a seeded sleep before dispatch,
  exactly what the straggler detector must flag), ``nonfinite_loss`` (the
  step's loss metric is poisoned to NaN so the non-finite guard trips on
  the real signal path), ``host_drop`` (SIGKILL of this very process —
  the preemption that never says goodbye);
- ``data/prefetch.py`` — ``feeder_error`` raised inside the feeder so it
  reaches the consumer through the real ``_ERROR`` queue channel;
- ``ckpt/checkpoint.py`` — ``ckpt_write_error`` raised from
  ``Checkpointer.save`` (the transient-storage failure class).

Every fired event is recorded to the flight recorder (kind
``fault_injected``) and counted for the host beacon, so detection and
reaction are exercised against the same signal path production would see.
Events are one-shot: a plan with ``feeder_error`` at batch 5 fires once;
after a resilient restart replays that position the stream proceeds —
which is precisely the transient-fault shape ``run_resilient`` exists
for. Schedule duplicates (two events, same kind, same step) fire once
each.

Reproduction workflow: a failure seen with ``--fault-plan seed=7,...`` is
re-run bit-identically with the same spec — the schedule is a pure
function of the spec string.

Port of the JAX package's ``train/faultinject.py``, which is pure Python:
the same schedule (``random.Random(seed)``, kinds in sorted order,
``rng.sample`` over ``range(min_step, num_steps)``), so a plan written for
either package replays identically in the other. The port keeps its own
copy and reads the port's flight recorder.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import random
import signal
import threading
import time
from collections.abc import Mapping
from pathlib import Path

logger = logging.getLogger(__name__)

__all__ = [
    "FAULT_KINDS",
    "FaultEvent",
    "FaultPlan",
    "FaultInjector",
    "InjectedFault",
]

#: the failure surface this module can schedule, one per hook point class.
FAULT_KINDS = (
    "slow_step",         # seeded sleep before dispatching a train step
    "feeder_error",      # exception raised inside the feed producer
    "nonfinite_loss",    # step loss metric poisoned to NaN
    "ckpt_write_error",  # Checkpointer.save raises (transient storage IO)
    "host_drop",         # SIGKILL this process (unannounced preemption)
)


class InjectedFault(OSError):
    """A scheduled fault firing as an exception.

    Subclasses :class:`OSError` deliberately: injected feeder/ckpt-IO
    faults must travel the same classification path as real storage and
    pipe errors (``train/resilience.py`` treats ``OSError`` as transient).
    """

    def __init__(self, kind: str, step: int):
        super().__init__(f"injected fault {kind!r} at step {step}")
        self.kind = kind
        self.step = step


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault. ``step`` is the train-step index for
    step-scoped kinds, the feed-stream batch index for ``feeder_error``,
    and the checkpoint step for ``ckpt_write_error``."""

    kind: str
    step: int
    duration_s: float = 0.0  # slow_step only: how long the sleep is

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; expected one of {FAULT_KINDS}"
            )
        if self.step < 0:
            raise ValueError(f"fault step must be >= 0, got {self.step}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An ordered, seeded schedule of :class:`FaultEvent`.

    Build one three ways: explicitly (tests pinning exact steps),
    :meth:`generate` (seeded random placement — the chaos-suite form), or
    :meth:`parse` (the ``--fault-plan`` CLI surface: either a
    ``key=value,...`` spec or a path to a JSON file)."""

    events: tuple[FaultEvent, ...]
    seed: int | None = None

    @classmethod
    def generate(
        cls,
        seed: int,
        num_steps: int,
        counts: Mapping[str, int],
        *,
        slow_step_s: float = 0.05,
        min_step: int = 1,
    ) -> "FaultPlan":
        """Seeded schedule: ``counts[kind]`` events per kind, placed on
        distinct steps drawn uniformly from ``[min_step, num_steps)``.
        Pure function of the arguments — same seed, same schedule."""
        if num_steps <= min_step:
            raise ValueError(f"num_steps {num_steps} must exceed min_step {min_step}")
        rng = random.Random(seed)
        events = []
        for kind in sorted(counts):
            n = counts[kind]
            if kind not in FAULT_KINDS:
                raise ValueError(f"unknown fault kind {kind!r}")
            if n <= 0:
                continue
            span = range(min_step, num_steps)
            steps = rng.sample(span, min(n, len(span)))
            for s in sorted(steps):
                events.append(
                    FaultEvent(
                        kind,
                        s,
                        duration_s=slow_step_s if kind == "slow_step" else 0.0,
                    )
                )
        events.sort(key=lambda e: (e.step, e.kind))
        return cls(tuple(events), seed=seed)

    @classmethod
    def parse(cls, spec: str, *, num_steps: int = 0) -> "FaultPlan":
        """The ``--fault-plan`` surface.

        A path to a ``.json`` file loads an explicit plan
        (``{"seed": .., "events": [{"kind": .., "step": ..}, ..]}``).
        Otherwise a comma spec drives :meth:`generate`::

            seed=7,feeder_error=2,ckpt_write_error=1,slow_step=1,slow_step_s=0.1

        ``num_steps`` bounds the random placement (required for specs,
        supplied by the CLI from the workload config).
        """
        spec = spec.strip()
        if spec.endswith(".json") or os.path.sep in spec:
            return cls.from_file(spec)
        seed, counts, slow_s, min_step = 0, {}, 0.05, 1
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"bad --fault-plan entry {part!r}: expected key=value")
            key, _, val = part.partition("=")
            key = key.strip()
            if key == "seed":
                seed = int(val)
            elif key == "slow_step_s":
                slow_s = float(val)
            elif key == "min_step":
                min_step = int(val)
            elif key in FAULT_KINDS:
                counts[key] = int(val)
            else:
                raise ValueError(
                    f"unknown --fault-plan key {key!r}; expected seed/"
                    f"slow_step_s/min_step or one of {FAULT_KINDS}"
                )
        if not num_steps:
            raise ValueError("a --fault-plan spec needs num_steps to place events")
        return cls.generate(
            seed, num_steps, counts, slow_step_s=slow_s, min_step=min_step
        )

    @classmethod
    def from_file(cls, path: str | Path) -> "FaultPlan":
        doc = json.loads(Path(path).read_text())
        events = tuple(
            FaultEvent(
                e["kind"], int(e["step"]), duration_s=float(e.get("duration_s", 0.0))
            )
            for e in doc.get("events", ())
        )
        return cls(events, seed=doc.get("seed"))

    def to_json(self) -> str:
        return json.dumps(
            {
                "seed": self.seed,
                "events": [dataclasses.asdict(e) for e in self.events],
            }
        )


class FaultInjector:
    """Runtime carrier of a :class:`FaultPlan` across the hook points.

    One injector serves one training process; the feed hook runs on the
    prefetch feeder thread while the step/ckpt hooks run on the loop
    thread, so the fired-event ledger is lock-protected. ``recorder`` is
    any :class:`~distributed_tensorflow_tpu_torch.obs.flightrec.FlightRecorder`
    (the NULL recorder when absent).
    """

    def __init__(self, plan: FaultPlan, *, recorder=None, sleep=time.sleep):
        from distributed_tensorflow_tpu_torch.obs.flightrec import NULL_RECORDER

        self.plan = plan
        self.recorder = recorder if recorder is not None else NULL_RECORDER
        self._sleep = sleep
        self._lock = threading.Lock()
        # Multiset of pending events per kind: {kind: {step: [events]}} —
        # one-shot semantics with support for stacked duplicates.
        self._pending: dict[str, dict[int, list[FaultEvent]]] = {
            k: {} for k in FAULT_KINDS
        }
        for ev in plan.events:
            self._pending[ev.kind].setdefault(ev.step, []).append(ev)
        self.fired: list[dict] = []

    def _take(self, kind: str, step: int) -> FaultEvent | None:
        """Pop one pending event of ``kind`` at ``step`` and ledger it."""
        with self._lock:
            stack = self._pending[kind].get(step)
            if not stack:
                return None
            ev = stack.pop()
            if not stack:
                del self._pending[kind][step]
            self.fired.append({"kind": kind, "step": step})
        # detail key is "fault", not "kind" — record()'s own first
        # parameter is named kind.
        self.recorder.record("fault_injected", fault=kind, step=step)
        logger.warning("fault injection: %s at step %d", kind, step)
        return ev

    # ---- hook points -----------------------------------------------------

    def on_step(self, step: int) -> bool:
        """Called by ``fit`` before dispatching ``step``. Applies
        ``slow_step``/``host_drop``; returns True when this step's loss
        metric should be poisoned (``nonfinite_loss``)."""
        ev = self._take("slow_step", step)
        if ev is not None:
            self._sleep(ev.duration_s)
        if self._take("host_drop", step) is not None:
            # The unannounced preemption: flush the flight recorder so the
            # event survives the process (there is no atexit after SIGKILL),
            # then die the way a preempted host dies.
            self.recorder.dump("host_drop", force=True)
            os.kill(os.getpid(), signal.SIGKILL)
        return self._take("nonfinite_loss", step) is not None

    def check_feeder(self, index: int) -> None:
        """Called by the feed stage before producing batch ``index``."""
        if self._take("feeder_error", index) is not None:
            raise InjectedFault("feeder_error", index)

    def check_ckpt_save(self, step: int) -> None:
        """Called by ``Checkpointer.save`` before queueing the write."""
        if self._take("ckpt_write_error", step) is not None:
            raise InjectedFault("ckpt_write_error", step)

    # ---- observability ---------------------------------------------------

    def summary(self) -> dict:
        """Beacon payload: fired-event counts + the recent ledger tail."""
        with self._lock:
            counts: dict[str, int] = {}
            for f in self.fired:
                counts[f["kind"]] = counts.get(f["kind"], 0) + 1
            return {
                "injected_faults": counts,
                "recent_injected": list(self.fired)[-8:],
            }
