"""Deterministic serving-side fault injection: seeded chaos for the fleet.

The training half of the failure surface got first-class, reproducible
faults in ``train/faultinject.py``; this module is its serving sibling.
A :class:`FaultPlan` is the same seeded schedule shape (pure function of
its spec string), carried by a :class:`FaultInjector` into the hook
points that cover the *serving* failure surface:

- ``serve/batcher.py::_loop`` — ``slow_decode_step`` (a seeded sleep
  before dispatching a decode step, exactly the straggler shape the SLO
  tracker must absorb) and ``dispatch_error`` (an exception raised on
  the decode-loop thread so the in-flight slot-failure path is
  exercised, not hypothesized); ``replica_kill`` (SIGKILL of this very
  replica — the preemption the router's failover exists for);
- ``serve/disagg.py`` senders — ``wire_corrupt`` (one byte of a
  serialized KV/stream payload flipped post-CRC, so the receiver's
  fail-closed refusal is the thing under test);
- ``serve/router.py`` probes — ``probe_timeout`` (a health probe
  swallowed, driving the ban/failover machinery from the real signal
  path).

Every fired event is recorded to the flight recorder (kind
``fault_injected``) and surfaces in :meth:`FaultInjector.summary`, so
chaos drills and their reactions share one timeline. Events are
one-shot; duplicates (same kind, same step) fire once each. The step
domain differs per kind: decode-step index for ``slow_decode_step`` /
``dispatch_error`` / ``replica_kill``, the per-process wire-send ordinal
for ``wire_corrupt``, and the per-replica probe ordinal for
``probe_timeout``.

Reproduction workflow: a failure seen with ``--fault-plan seed=7,...``
re-runs bit-identically with the same spec.

Port of the JAX package's ``serve/faultinject.py`` (pure Python; the same
schedule event for event). In the port the decode-step hook sits in
:class:`~distributed_tensorflow_tpu_torch.serve.batcher.ContinuousBatcher`,
``check_wire`` in :func:`~distributed_tensorflow_tpu_torch.serve.disagg.migrate_streams`
(its outbound stream buffers) and ``check_probe`` in
:meth:`~distributed_tensorflow_tpu_torch.serve.router.Router._probe` (the
router's health probes; ``cli.router --fault-plan`` arms it).
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

#: the serving failure surface this module can schedule.
FAULT_KINDS = (
    "dispatch_error",    # exception raised on the decode-loop thread
    "slow_decode_step",  # seeded sleep before dispatching a decode step
    "wire_corrupt",      # flip one byte of a serialized wire payload
    "probe_timeout",     # swallow a router health probe
    "replica_kill",      # SIGKILL this replica (unannounced preemption)
)


class InjectedFault(OSError):
    """A scheduled fault firing as an exception.

    Subclasses :class:`OSError` deliberately: an injected dispatch error
    must travel the same slot-failure classification path a real device
    or runtime error would.
    """

    def __init__(self, kind: str, step: int):
        super().__init__(f"injected fault {kind!r} at step {step}")
        self.kind = kind
        self.step = step


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault. ``step`` is the decode-step index for
    step-scoped kinds, the wire-send ordinal for ``wire_corrupt``, and
    the probe ordinal for ``probe_timeout``."""

    kind: str
    step: int
    duration_s: float = 0.0  # slow_decode_step only: how long the sleep is

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
                        duration_s=slow_step_s if kind == "slow_decode_step" else 0.0,
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

            seed=7,replica_kill=1,slow_decode_step=2,slow_step_s=0.1

        ``num_steps`` bounds the random placement (required for specs,
        supplied by the harness from the workload size).
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
    """Runtime carrier of a :class:`FaultPlan` across the serving hooks.

    One injector serves one replica process; the decode hook runs on the
    batcher's loop thread while wire/probe hooks may run on HTTP or
    router threads, so the fired-event ledger is lock-protected.
    ``recorder`` is any
    :class:`~distributed_tensorflow_tpu_torch.obs.flightrec.FlightRecorder`
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

    def on_decode_step(self, step: int) -> None:
        """Called by the batcher loop before dispatching decode ``step``.

        ``slow_decode_step`` sleeps in place (the straggler shape);
        ``replica_kill`` flushes the flight recorder and SIGKILLs the
        process (there is no atexit after SIGKILL — the dump is the only
        trace that survives); ``dispatch_error`` raises
        :class:`InjectedFault` so the caller's slot-failure path runs.
        """
        ev = self._take("slow_decode_step", step)
        if ev is not None:
            self._sleep(ev.duration_s)
        if self._take("replica_kill", step) is not None:
            self.recorder.dump("replica_kill", force=True)
            os.kill(os.getpid(), signal.SIGKILL)
        if self._take("dispatch_error", step) is not None:
            raise InjectedFault("dispatch_error", step)

    def check_wire(self, index: int) -> bool:
        """Called by wire senders before shipping payload ``index``.
        True means: flip one byte of this payload (corrupt in flight)."""
        return self._take("wire_corrupt", index) is not None

    def check_probe(self, index: int) -> bool:
        """Called by the router before health probe ``index``. True
        means: swallow this probe (simulate a timeout)."""
        return self._take("probe_timeout", index) is not None

    # ---- observability ---------------------------------------------------

    def summary(self) -> dict:
        """Beacon/statusz payload: fired counts + the recent ledger tail."""
        with self._lock:
            counts: dict[str, int] = {}
            for f in self.fired:
                counts[f["kind"]] = counts.get(f["kind"], 0) + 1
            return {
                "injected_faults": counts,
                "recent_injected": list(self.fired)[-8:],
            }
