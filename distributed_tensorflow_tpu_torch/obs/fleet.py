"""Fleet health: per-step timelines, straggler detection, host beacons.

The paper's premise is a cluster that keeps making progress while
individual roles degrade — this module is how a modern SPMD job *sees*
that degradation:

- :class:`StepTimeline` — the train-loop recorder (``fit(timeline=...)``
  feeds it): per-step wall/host-wait/dispatch durations into windowed
  series (obs/timeseries.py) plus a bounded recent-step ring, with an
  in-line :class:`StragglerDetector` flagging anomalies as they happen.
- :class:`StragglerDetector` — self-relative anomaly detection: a step
  is *slow* when it exceeds ``ratio`` x the trailing median of the
  host's own recent steps; a *host-wait regression* is the analogous
  test on the feed-wait series (with an absolute floor so microsecond
  jitter on an idle feed never flags).  Trailing-median, not mean: one
  checkpoint save must not shift the baseline.
- :class:`HostBeacon` — the per-host health summary, written as one JSON
  file per host (atomic rename) into a shared directory.  Processes
  never talk to each other: the aggregation side —
  :func:`read_beacons` / :func:`fleet_summary` /
  :func:`detect_fleet_stragglers` — runs wherever the files are visible
  (the chief, a monitor, the test harness).  A host is a *fleet*
  straggler when its median step time exceeds ``ratio`` x the median of
  the OTHER hosts' medians — cross-host-relative, so a uniformly slow
  fleet (bigger model) flags nobody while one 5x host flags alone.

No threads anywhere: recording is done by the train loop's own thread,
beacon writes happen at the loop's log cadence, aggregation is pull.

Port of the JAX package's ``obs/fleet.py`` (pure Python): the same
detector, timeline, beacon format and supervisors, over the port's
:mod:`~distributed_tensorflow_tpu_torch.obs.timeseries`. A beacon's host id
is the rank, ``parallel.mesh.process_index()``.
"""

from __future__ import annotations

import json
import os
import statistics
import threading
import time
from collections import deque
from pathlib import Path

from distributed_tensorflow_tpu_torch.obs.timeseries import (
    DEFAULT_STEP_BOUNDS,
    WindowedHistogram,
)


class StragglerDetector:
    """Self-relative slow-step / feed-regression detector.

    ``observe`` compares each step against the trailing median of the
    PRIOR ``window`` steps (the current step never dilutes its own
    baseline) and returns an anomaly record or ``None``.  Anomalies are
    also kept in a bounded ring (``anomalies``) for the beacon.
    """

    def __init__(
        self,
        window: int = 64,
        min_history: int = 8,
        step_ratio: float = 3.0,
        host_wait_ratio: float = 4.0,
        min_host_wait_s: float = 0.005,
        max_anomalies: int = 128,
    ):
        if window < min_history:
            raise ValueError("window must be >= min_history")
        self._lock = threading.Lock()
        self.window = window
        self.min_history = min_history
        self.step_ratio = step_ratio
        self.host_wait_ratio = host_wait_ratio
        self.min_host_wait_s = min_host_wait_s
        self._steps: deque[float] = deque(maxlen=window)
        self._waits: deque[float] = deque(maxlen=window)
        self.anomalies: deque[dict] = deque(maxlen=max_anomalies)

    def observe(
        self, step: int, step_s: float, host_wait_s: float = 0.0
    ) -> dict | None:
        with self._lock:
            anomaly = None
            if len(self._steps) >= self.min_history:
                med = statistics.median(self._steps)
                if med > 0 and step_s > self.step_ratio * med:
                    anomaly = {
                        "kind": "slow_step",
                        "step": step,
                        "step_s": step_s,
                        "trailing_median_s": med,
                        "ratio": step_s / med,
                    }
                elif (
                    host_wait_s > self.min_host_wait_s
                    and host_wait_s
                    > self.host_wait_ratio
                    * max(statistics.median(self._waits), self.min_host_wait_s)
                ):
                    anomaly = {
                        "kind": "host_wait_regression",
                        "step": step,
                        "host_wait_s": host_wait_s,
                        "trailing_median_s": statistics.median(self._waits),
                    }
            self._steps.append(step_s)
            self._waits.append(host_wait_s)
            if anomaly is not None:
                self.anomalies.append(anomaly)
            return anomaly

    def summary(self) -> dict:
        with self._lock:
            kinds: dict[str, int] = {}
            for a in self.anomalies:
                kinds[a["kind"]] = kinds.get(a["kind"], 0) + 1
            return {
                "anomaly_counts": kinds,
                "recent_anomalies": list(self.anomalies)[-8:],
            }


class StepTimeline:
    """Per-step phase recorder feeding windowed series + the detector.

    ``record_step`` is the single entry point the train loop calls once
    per step with the durations it already measures (host_wait) plus the
    step wall and dispatch times.  Reads (``summary``) are safe from any
    thread — the beacon writer and the recording loop may interleave.
    """

    def __init__(
        self,
        detector: StragglerDetector | None = None,
        history: int = 512,
        max_window_s: float = 300.0,
        clock=time.monotonic,
    ):
        self._lock = threading.Lock()
        self._clock = clock
        self.step_time = WindowedHistogram(
            bounds=DEFAULT_STEP_BOUNDS, max_window_s=max_window_s, clock=clock
        )
        self.host_wait = WindowedHistogram(
            bounds=DEFAULT_STEP_BOUNDS, max_window_s=max_window_s, clock=clock
        )
        self.dispatch = WindowedHistogram(
            bounds=DEFAULT_STEP_BOUNDS, max_window_s=max_window_s, clock=clock
        )
        self.detector = detector or StragglerDetector()
        self._recent: deque[tuple] = deque(maxlen=history)
        self._last_step = -1

    def record_step(
        self,
        step: int,
        step_s: float,
        host_wait_s: float = 0.0,
        dispatch_s: float = 0.0,
        now: float | None = None,
    ) -> dict | None:
        """Record one step; returns the detector's anomaly (if any)."""
        now = self._clock() if now is None else now
        self.step_time.observe(step_s, now)
        self.host_wait.observe(host_wait_s, now)
        self.dispatch.observe(dispatch_s, now)
        with self._lock:
            self._recent.append((step, step_s, host_wait_s, dispatch_s))
            self._last_step = max(self._last_step, step)
        return self.detector.observe(step, step_s, host_wait_s)

    @property
    def last_step(self) -> int:
        with self._lock:
            return self._last_step

    def summary(self, window_s: float = 60.0, now: float | None = None) -> dict:
        """The beacon body: windowed step/wait distributions + anomalies."""
        now = self._clock() if now is None else now
        step_w = self.step_time.window_summary(window_s, now)
        wait_w = self.host_wait.window_summary(window_s, now)
        return {
            "last_step": self.last_step,
            "window_s": window_s,
            "steps_per_sec": step_w["rate"],
            "step_s": {k: step_w[k] for k in ("count", "p50", "p90", "p99")},
            "host_wait_s": {
                k: wait_w[k] for k in ("count", "p50", "p90", "p99")
            },
            # Raw mergeable counts so the aggregator can compute fleet
            # quantiles without re-observing anything.
            "step_counts": self.step_time.window_counts(window_s, now),
            "step_bounds": list(self.step_time.bounds),
            **self.detector.summary(),
        }


class HostBeacon:
    """One host's health file in the shared beacon directory.

    ``write()`` snapshots the timeline summary and atomically replaces
    ``<dir>/host_<id>.json`` — readers never see a torn file.  Call it
    from a fit hook at the log cadence (cli/train.py --beacon-dir wires
    exactly that).
    """

    def __init__(
        self,
        beacon_dir: str | Path,
        host_id: int,
        timeline: StepTimeline,
        window_s: float = 60.0,
        extras=None,
    ):
        self.dir = Path(beacon_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.host_id = int(host_id)
        self.timeline = timeline
        self.window_s = window_s
        # extras() -> dict, merged into every summary — e.g. a
        # FaultInjector's fired-event ledger (train/faultinject.py), so a
        # chaos run's injections travel the same signal path real
        # degradation would.
        self.extras = extras
        self.path = self.dir / f"host_{self.host_id}.json"

    def summary(self) -> dict:
        out = {
            "host": self.host_id,
            "wall_time": time.time(),
            **self.timeline.summary(self.window_s),
        }
        if self.extras is not None:
            out.update(self.extras())
        return out

    def write(self) -> Path:
        tmp = self.path.with_suffix(".json.tmp")
        tmp.write_text(json.dumps(self.summary()))
        os.replace(tmp, self.path)  # atomic on POSIX
        return self.path


def read_beacons(beacon_dir: str | Path) -> list[dict]:
    """All parseable host beacons in the directory, sorted by host id."""
    out = []
    for p in sorted(Path(beacon_dir).glob("host_*.json")):
        try:
            out.append(json.loads(p.read_text()))
        except (OSError, json.JSONDecodeError):
            continue  # mid-replace or vanished: next poll sees it
    return out


def detect_fleet_stragglers(
    beacons: list[dict], ratio: float = 2.0
) -> list[int]:
    """Host ids whose median step time exceeds ``ratio`` x the median of
    the OTHER hosts' medians.

    Cross-host-relative on purpose: a uniformly slow fleet (bigger model,
    colder cache) flags nobody; one seeded-5x host flags alone even in a
    2-host fleet (where a global median would be dragged halfway up by
    the straggler itself).
    """
    meds = {
        int(b["host"]): b["step_s"]["p50"]
        for b in beacons
        if b.get("step_s", {}).get("count", 0) > 0
    }
    if len(meds) < 2:
        return []
    flagged = []
    for host, med in meds.items():
        others = [m for h, m in meds.items() if h != host]
        baseline = statistics.median(others)
        if baseline > 0 and med > ratio * baseline:
            flagged.append(host)
    return sorted(flagged)


def fleet_summary(beacons: list[dict], ratio: float = 2.0) -> dict:
    """The aggregated fleet view: per-host digests + straggler verdict."""
    stragglers = detect_fleet_stragglers(beacons, ratio)
    hosts = []
    for b in sorted(beacons, key=lambda x: x.get("host", -1)):
        host = int(b.get("host", -1))
        hosts.append({
            "host": host,
            "last_step": b.get("last_step"),
            "median_step_s": b.get("step_s", {}).get("p50"),
            "p99_step_s": b.get("step_s", {}).get("p99"),
            "steps_per_sec": b.get("steps_per_sec"),
            "anomaly_counts": b.get("anomaly_counts", {}),
            "straggler": host in stragglers,
        })
    return {
        "n_hosts": len(hosts),
        "stragglers": stragglers,
        "straggler_ratio": ratio,
        "hosts": hosts,
    }


class FleetSupervisor:
    """Beacon consumer deciding restart-vs-re-mesh (the reaction half).

    Poll-based and threadless like everything else here: call
    :meth:`poll` from wherever the beacon files are visible (a monitor, a
    relaunch wrapper, the chaos test harness). Per poll, each expected
    host is classified by its beacon's ``wall_time`` freshness:

    - a host with no beacon, or one older than ``heartbeat_timeout_s``,
      is **lost** → ``action: "re_mesh"`` — the survivors should replan
      onto the remaining devices
      (``parallel.mesh.plan_elastic_mesh(surviving)``) and resume via
      ``train.resilience.run_resilient``;
    - no losses but a fleet straggler (cross-host-relative, see
      :func:`detect_fleet_stragglers`) → ``action: "restart"`` — same
      topology, restart the slow host before it drags the collective;
    - otherwise ``action: "none"``.

    ``expected_hosts`` is an int (hosts 0..n-1) or an iterable of ids;
    without it, every host EVER seen is expected — a beacon that appears
    and then goes stale still counts as lost. Newly-lost hosts are
    recorded to ``recorder`` as ``host_lost`` events (once per loss, not
    per poll).
    """

    def __init__(
        self,
        beacon_dir: str | Path,
        *,
        expected_hosts=None,
        heartbeat_timeout_s: float = 30.0,
        straggler_ratio: float = 2.0,
        clock=time.time,
        recorder=None,
    ):
        self.dir = Path(beacon_dir)
        if isinstance(expected_hosts, int):
            expected_hosts = range(expected_hosts)
        self.expected: set[int] | None = (
            {int(h) for h in expected_hosts} if expected_hosts is not None else None
        )
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.straggler_ratio = straggler_ratio
        self._clock = clock
        self._recorder = recorder
        self._seen: set[int] = set()
        self._reported_lost: set[int] = set()

    def poll(self, now: float | None = None) -> dict:
        """One classification pass over the beacon directory."""
        now = self._clock() if now is None else now
        by_host = {}
        for b in read_beacons(self.dir):
            try:
                by_host[int(b["host"])] = b
            except (KeyError, TypeError, ValueError):
                continue
        self._seen |= set(by_host)
        expected = self.expected if self.expected is not None else self._seen
        alive, lost = [], []
        for h in sorted(expected):
            b = by_host.get(h)
            age = now - b.get("wall_time", 0.0) if b is not None else None
            if b is None or age > self.heartbeat_timeout_s:
                lost.append(h)
            else:
                alive.append(h)
        stragglers = detect_fleet_stragglers(
            [by_host[h] for h in alive], self.straggler_ratio
        )
        if self._recorder is not None:
            for h in lost:
                if h not in self._reported_lost:
                    self._recorder.record(
                        "host_lost", host=h,
                        last_step=by_host.get(h, {}).get("last_step", -1),
                    )
        self._reported_lost = set(lost)
        action = "re_mesh" if lost else ("restart" if stragglers else "none")
        return {
            "action": action,
            "lost_hosts": lost,
            "alive_hosts": alive,
            "stragglers": stragglers,
            "n_expected": len(expected),
            "heartbeat_timeout_s": self.heartbeat_timeout_s,
        }


class ReplicaSupervisor:
    """Per-replica poll-history verdicts for the serving router.

    The serving analogue of :class:`FleetSupervisor`, with the restart
    budget of ``train.resilience`` (which this module does not import:
    it pulls in torch, and the router stays stdlib-only).  The
    semantics are the same on purpose:

    - **progress-aware budget**: a replica that comes back *ready* after
      a restart resets its consecutive-restart count, exactly as a
      training restart that advances ``resume_step`` does — only
      back-to-back failures with no intervening ready burn the budget;
    - **exponential backoff**: restart *n* waits
      ``min(base * factor**(n-1), cap)`` seconds, matching
      ``ResilienceConfig.backoff_s``.

    Threadless and poll-based like everything else here: the router's
    poll loop feeds :meth:`record_poll` / :meth:`record_ready` /
    :meth:`record_restart` and reads :meth:`verdict`:

    - fewer than ``fail_threshold`` consecutive failed polls →
      ``"none"`` (one dropped poll on a busy box must not bounce a
      healthy replica);
    - threshold reached with restart budget remaining → ``"restart"``;
    - budget exhausted → ``"quarantine"`` — the replica is left down and
      the fleet routes around it (restarting a replica that dies
      instantly N times just feeds it traffic to drop).
    """

    def __init__(
        self,
        *,
        fail_threshold: int = 3,
        max_restarts: int = 3,
        backoff_base_s: float = 0.5,
        backoff_factor: float = 2.0,
        backoff_max_s: float = 30.0,
    ):
        if fail_threshold < 1:
            raise ValueError("fail_threshold must be >= 1")
        if max_restarts < 0:
            raise ValueError("max_restarts must be >= 0")
        self.fail_threshold = int(fail_threshold)
        self.max_restarts = int(max_restarts)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_factor = float(backoff_factor)
        self.backoff_max_s = float(backoff_max_s)
        self._consecutive_fails = 0
        self._consecutive_restarts = 0
        self._total_restarts = 0
        self._ready_since_restart = False

    def record_poll(self, ok: bool) -> None:
        """One health-poll outcome (True = got a well-formed response)."""
        self._consecutive_fails = 0 if ok else self._consecutive_fails + 1

    def record_ready(self) -> None:
        """The replica reached *ready*: progress. Resets the consecutive
        restart count so the budget only bounds back-to-back failures."""
        self._consecutive_restarts = 0
        self._ready_since_restart = True

    def record_restart(self) -> float:
        """Account one restart; returns the backoff to wait before it."""
        self._consecutive_restarts += 1
        self._total_restarts += 1
        self._consecutive_fails = 0
        self._ready_since_restart = False
        n = self._consecutive_restarts
        return min(
            self.backoff_base_s * self.backoff_factor ** max(n - 1, 0),
            self.backoff_max_s,
        )

    def verdict(self) -> str:
        """``"none"`` / ``"restart"`` / ``"quarantine"`` for this poll."""
        if self._consecutive_fails < self.fail_threshold:
            return "none"
        if self._consecutive_restarts >= self.max_restarts:
            return "quarantine"
        return "restart"

    def summary(self) -> dict:
        return {
            "consecutive_fails": self._consecutive_fails,
            "consecutive_restarts": self._consecutive_restarts,
            "total_restarts": self._total_restarts,
            "ready_since_restart": self._ready_since_restart,
            "max_restarts": self.max_restarts,
            "verdict": self.verdict(),
        }
