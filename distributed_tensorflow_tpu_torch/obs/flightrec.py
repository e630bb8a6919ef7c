"""Black-box flight recorder: the last N structured events, dumped on
trigger.

The SLO layer answers "are we burning budget" and the tracer answers
"where did THIS request spend its time" — neither answers the postmortem
question "what happened in the seconds before the page / the engine
failure / the 500". This module does: a preallocated bounded ring of
tiny structured events (request admit/complete/reject, slot alloc/free,
prefix-cache hit/eviction, health transitions, SLO verdict changes,
engine dispatch failures, checkpoint restores — the taxonomy in
docs/OBS.md), fed from the batcher/engine/kvpool/health/slo hot paths,
plus a ``dump()`` that atomically snapshots the ring together with the
metrics snapshot, the tracer span summary, and the memz/compilez digests
into one timestamped JSON file under ``--dump-dir``.

Overhead contract (mirrors :class:`~..obs.trace.Tracer`): a DISABLED
recorder is one attribute check and a return at every call site —
:data:`NULL_RECORDER` is the process-wide default, so instrumented code
never needs its own ``if recording:`` branches. An ENABLED recorder
costs one tuple build and one ring write under a small dedicated lock;
the ring is PREALLOCATED (``capacity`` slots, filled with ``None``) so
steady-state recording allocates nothing but the event tuples, and
overflow overwrites the oldest event while counting the drop — the
serve_bench ``--quick`` gate pins the whole thing at <=2%% throughput
overhead.

Dump triggers are RATE-LIMITED (``min_dump_interval_s``) so a flapping
SLO verdict cannot fill the disk: automatic triggers inside the window
count as ``dumps_suppressed``; a manual ``POST /debugz/dump`` passes
``force=True`` and always writes. Writes are atomic (tmp + rename) so a
reader never sees a torn file.
"""

from __future__ import annotations

import json
import os
import threading
import time
from pathlib import Path

__all__ = ["FlightEvent", "FlightRecorder", "NULL_RECORDER"]

#: canonical event kinds (docs/OBS.md "Flight-recorder event taxonomy");
#: ``record`` accepts any string — this tuple is the documented contract,
#: not a validation gate (a new call site must not crash an old binary).
EVENT_KINDS = (
    "request_admit",
    "request_complete",
    "request_reject",
    "slot_alloc",
    "slot_free",
    "prefix_hit",
    "prefix_evict",
    "spec_backoff",     # speculation backoff engaged/disengaged for a slot
    "health_transition",
    "slo_verdict",
    "engine_failure",
    "server_error",
    "ckpt_restore",
    # -- training resilience (train/faultinject.py, train/resilience.py,
    #    train/loop.py non-finite guard, obs/fleet.py FleetSupervisor) --
    "fault_injected",    # a scheduled FaultPlan event fired (kind, step)
    "nonfinite_loss",    # NaN/Inf step loss seen by the loop guard
    "ckpt_save_error",   # periodic save attempt failed (absorbed)
    "train_restart",     # transient failure -> restore + re-enter loop
    "train_fatal",       # fatal classification: dumping and re-raising
    "preempt_exit",      # SIGTERM/SIGINT -> final sync checkpoint + exit
    "host_lost",         # FleetSupervisor: a host's beacon went stale
    # -- serving fleet (serve/router.py, obs/fleet.py ReplicaSupervisor) --
    "router_spawn",      # router spawned/adopted a replica process
    "replica_lost",      # health-poll timeout / refusal / process exit
    "replica_restart",   # ReplicaSupervisor verdict -> replica relaunched
    "hot_swap",          # rolling checkpoint swap step (drain/restart/done)
    # -- disaggregated serving (serve/disagg.py KV-page transfer) --
    "kv_transfer_start",   # page-chain transfer admitted (role, bytes)
    "kv_transfer_done",    # chain adopted by the decode role (bytes, s)
    "kv_transfer_reject",  # budget shed / wire refusal (cause)
    # -- live stream migration (serve/batcher.py, serve/disagg.py) --
    "stream_export",        # live stream checkpointed off its slot/queue
    "stream_adopt",         # migrated stream resumed here (pages yes/no)
    "stream_migrate_reject",  # wire/geometry/state/budget refusal (cause)
    # -- priority-preemptive scheduling (serve/batcher.py) --
    "slot_preempt",         # victim parked (reason paged/pageless) or the
                            # park aborted (aborted=True: pool full /
                            # un-bucketable resume; victim finishes)
    "slot_resume",          # parked victim re-admitted (resume_tokens
                            # replay; rounds = parks survived)
    "dump",
)


class FlightEvent:
    """One ring entry: wall-clock stamp, kind, optional request id, and a
    small detail dict. ``__slots__`` keeps the steady-state footprint at
    one small object per event."""

    __slots__ = ("t", "kind", "request_id", "detail")

    def __init__(self, t, kind, request_id, detail):
        self.t = t
        self.kind = kind
        self.request_id = request_id
        self.detail = detail

    def as_dict(self) -> dict:
        out = {"t": self.t, "kind": self.kind}
        if self.request_id is not None:
            out["request_id"] = self.request_id
        if self.detail:
            out.update(self.detail)
        return out


class FlightRecorder:
    """Lock-light bounded event ring with triggered JSON dumps.

    ``capacity=0`` or ``enabled=False`` builds a no-op recorder: every
    method returns on its first line (:data:`NULL_RECORDER` is the shared
    instance call sites default to). ``dump_dir=None`` keeps the ring and
    the snapshot machinery but skips the file write — ``dump()`` still
    returns the payload, which is what the in-process tests and the
    serve_bench round-trip gate consume.

    ``attach`` wires the dump's sidecar sections: zero-arg callables for
    the metrics snapshot, the ``/memz`` digest, the ``/compilez`` digest,
    and the tracer span summary. Missing sections dump as ``None`` — a
    partial wiring still produces a valid file with all four keys.
    """

    # Shared mutable ring state; every access is ordered by self._lock.
    _RACETRACE_ATTRS = ("_buf", "_head", "_n", "_dropped")

    def __init__(
        self,
        capacity: int = 2048,
        *,
        enabled: bool = True,
        dump_dir: str | Path | None = None,
        min_dump_interval_s: float = 30.0,
        clock=time.time,
    ):
        self.enabled = bool(enabled) and capacity > 0
        self.capacity = int(capacity)
        self.dump_dir = Path(dump_dir) if dump_dir else None
        self.min_dump_interval_s = float(min_dump_interval_s)
        self._clock = clock
        self._lock = threading.Lock()
        # Preallocated ring: _head is the next write slot once full.
        self._buf: list[FlightEvent | None] = [None] * self.capacity
        self._head = 0
        self._n = 0
        self._dropped = 0
        self._dump_lock = threading.Lock()
        self._last_dump_t: float | None = None
        self._dumps_written = 0
        self._dumps_suppressed = 0
        self._dump_seq = 0
        self._metrics_fn = None
        self._memz_fn = None
        self._compilez_fn = None
        self._tracer_fn = None

    # ---------------------------------------------------------- recording

    def record(self, kind: str, request_id=None, **detail) -> None:
        """Append one event (cheap no-op when disabled). ``detail`` values
        must be JSON-serializable — call sites pass ints/floats/strings."""
        if not self.enabled:
            return
        ev = FlightEvent(self._clock(), kind, request_id, detail or None)
        with self._lock:
            if self._n < self.capacity:
                self._buf[self._n] = ev
                self._n += 1
            else:
                self._buf[self._head] = ev
                self._head = (self._head + 1) % self.capacity
                self._dropped += 1

    def events(self) -> list[dict]:
        """Snapshot the ring oldest-first (no drain — a dump must not blind
        the next one)."""
        with self._lock:
            if self._n < self.capacity:
                evs = self._buf[: self._n]
            else:
                evs = self._buf[self._head:] + self._buf[: self._head]
            evs = list(evs)
        return [e.as_dict() for e in evs if e is not None]

    def status(self) -> dict:
        with self._lock:
            buffered, dropped = self._n, self._dropped
        with self._dump_lock:
            written = self._dumps_written
            suppressed = self._dumps_suppressed
            last = self._last_dump_t
        return {
            "enabled": self.enabled,
            "capacity": self.capacity,
            "buffered_events": buffered,
            "dropped_events": dropped,
            "dumps_written": written,
            "dumps_suppressed": suppressed,
            "last_dump_t": last,
            "dump_dir": str(self.dump_dir) if self.dump_dir else None,
        }

    # ------------------------------------------------------------ dumping

    def attach(
        self,
        *,
        metrics_fn=None,
        memz_fn=None,
        compilez_fn=None,
        tracer_fn=None,
    ) -> None:
        """Wire the dump's sidecar sections (Client does this once)."""
        if metrics_fn is not None:
            self._metrics_fn = metrics_fn
        if memz_fn is not None:
            self._memz_fn = memz_fn
        if compilez_fn is not None:
            self._compilez_fn = compilez_fn
        if tracer_fn is not None:
            self._tracer_fn = tracer_fn

    @staticmethod
    def _section(fn):
        if fn is None:
            return None
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — a broken section must not
            return {"error": f"{type(e).__name__}: {e}"}  # lose the dump

    def snapshot_payload(self, reason: str) -> dict:
        """The dump body: ring events + the four sidecar sections. Always
        carries every key so a reader's parser never branches on wiring."""
        return {
            "reason": reason,
            "wall_time": self._clock(),
            "recorder": self.status(),
            "events": self.events(),
            "metrics": self._section(self._metrics_fn),
            "memz": self._section(self._memz_fn),
            "compilez": self._section(self._compilez_fn),
            "tracer": self._section(self._tracer_fn),
        }

    def dump(self, reason: str, *, force: bool = False):
        """Write one dump (rate-limited unless ``force``). Returns the
        written :class:`~pathlib.Path`, the payload dict when no
        ``dump_dir`` is configured, or ``None`` when suppressed/disabled.
        """
        if not self.enabled:
            return None
        now = self._clock()
        with self._dump_lock:
            if not force and self._last_dump_t is not None and (
                now - self._last_dump_t < self.min_dump_interval_s
            ):
                self._dumps_suppressed += 1
                return None
            self._last_dump_t = now
            self._dumps_written += 1
            self._dump_seq += 1
            seq = self._dump_seq
        self.record("dump", reason=reason)
        payload = self.snapshot_payload(reason)
        if self.dump_dir is None:
            return payload
        self.dump_dir.mkdir(parents=True, exist_ok=True)
        stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime(now))
        path = self.dump_dir / f"flightrec-{stamp}-{seq:04d}-{reason}.json"
        tmp = path.with_suffix(".json.tmp")
        with tmp.open("w") as fh:
            json.dump(payload, fh, default=str)
        os.replace(tmp, path)  # atomic: readers never see a torn file
        return path

    def trigger(self, reason: str):
        """Automatic-trigger entry point (SLO page, engine failure,
        unhandled 500): a rate-limited ``dump``."""
        return self.dump(reason, force=False)


#: Process-wide disabled recorder: the default for every instrumented
#: call site, so ``recorder or NULL_RECORDER`` keeps recording opt-in
#: with near-zero cost when it is off.
NULL_RECORDER = FlightRecorder(capacity=0, enabled=False)
