"""Port parity and behaviour: fleet health (``obs/fleet.py``).

Mirrors the JAX package's ``tests/test_fleet.py`` (straggler detection on
seeded traces, step timelines, beacon write/read/aggregate, ``fit``
integration), the ``FleetSupervisor`` cases of ``tests/test_resilience.py``
and the ``ReplicaSupervisor`` cases of ``tests/test_router.py``. On top, the
same seeded step and host-wait series go through the JAX package's
detector and timeline and the port's: anomalies, summaries and
``fleet_summary`` must be equal, exactly (pure Python floats on both
sides, under one fake clock).
"""

from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.obs import fleet as jfleet
from distributed_tensorflow_tpu_torch.obs import fleet as pfleet
from distributed_tensorflow_tpu_torch.obs.flightrec import FlightRecorder
from distributed_tensorflow_tpu_torch.obs.fleet import (
    FleetSupervisor,
    HostBeacon,
    ReplicaSupervisor,
    StepTimeline,
    StragglerDetector,
    detect_fleet_stragglers,
    fleet_summary,
    read_beacons,
)


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


# ---------------------------------------------------------- parity with JAX


def _series(seed: int, n: int = 200):
    """Seeded step and host-wait series with spikes, stalls and jitter."""
    rng = np.random.default_rng(seed)
    step = 0.01 * (1 + 0.1 * rng.standard_normal(n)) ** 2
    step[rng.choice(n, 8, replace=False)] *= rng.uniform(2, 8, 8)
    wait = np.abs(1e-3 * rng.standard_normal(n))
    wait[rng.choice(n, 6, replace=False)] = rng.uniform(0.01, 0.5, 6)
    return [float(x) for x in step], [float(x) for x in wait]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_detector_and_timeline_equal_jax_on_seeded_series(seed):
    steps, waits = _series(seed)
    kw = dict(window=32, min_history=8, step_ratio=3.0, host_wait_ratio=4.0)
    jclk, pclk = FakeClock(), FakeClock()
    jtl = jfleet.StepTimeline(jfleet.StragglerDetector(**kw), clock=jclk)
    ptl = StepTimeline(StragglerDetector(**kw), clock=pclk)
    flagged = 0
    for i, (s, w) in enumerate(zip(steps, waits)):
        jclk.t += s
        pclk.t += s
        want = jtl.record_step(i + 1, s, host_wait_s=w, dispatch_s=s / 4)
        assert ptl.record_step(i + 1, s, host_wait_s=w, dispatch_s=s / 4) == want
        flagged += want is not None
    assert flagged > 0
    for window in (1.0, 60.0, 300.0):
        assert ptl.summary(window) == jtl.summary(window)
    assert ptl.detector.summary() == jtl.detector.summary()
    beacons = [{"host": h, **tl.summary(60.0)}
               for h, tl in enumerate((jtl, ptl))] + [
        {"host": 2, "step_s": {"count": 9, "p50": 0.1, "p90": 0.1, "p99": 0.2}}]
    for ratio in (1.5, 2.0, 4.0):
        assert fleet_summary(beacons, ratio) == jfleet.fleet_summary(beacons, ratio)
        assert detect_fleet_stragglers(beacons, ratio) == jfleet.detect_fleet_stragglers(
            beacons, ratio)


def test_supervisors_equal_jax(tmp_path):
    clock = FakeClock(100.0)
    for host, (wall, p50) in enumerate(((99.0, 0.1), (90.0, 0.1), (99.5, 0.5), (99.8, 0.1))):
        (tmp_path / f"host_{host}.json").write_text(json.dumps(
            {"host": host, "wall_time": wall, "last_step": 10,
             "step_s": {"p50": p50, "count": 5}}))
    for expected in (None, 4, 6, [0, 2, 3]):
        kw = dict(expected_hosts=expected, heartbeat_timeout_s=5.0, clock=clock)
        assert FleetSupervisor(tmp_path, **kw).poll() == jfleet.FleetSupervisor(
            tmp_path, **kw).poll()
    ours = ReplicaSupervisor(fail_threshold=2, max_restarts=3, backoff_base_s=0.25)
    ref = jfleet.ReplicaSupervisor(fail_threshold=2, max_restarts=3, backoff_base_s=0.25)
    rng = np.random.default_rng(4)
    for op in rng.integers(0, 4, 60):
        out = []
        for sup in (ours, ref):
            if op == 0:
                out.append(sup.record_poll(True))
            elif op == 1:
                out.append(sup.record_poll(False))
            elif op == 2:
                out.append(sup.record_restart())
            else:
                out.append(sup.record_ready())
        assert out[0] == out[1]
        assert ours.summary() == ref.summary()


# -------------------------------------------------------- StragglerDetector


def test_detector_needs_history_before_flagging():
    d = StragglerDetector(window=16, min_history=8)
    for i in range(8):
        assert d.observe(i, 1.0 if i == 3 else 0.01) is None


def test_detector_flags_seeded_slow_step_only():
    d = StragglerDetector(window=16, min_history=8)
    anomalies = [a for i in range(40)
                 if (a := d.observe(i, 0.05 if i == 20 else 0.01)) is not None]
    (a,) = anomalies
    assert a["kind"] == "slow_step" and a["step"] == 20
    assert a["ratio"] == pytest.approx(5.0)
    assert a["trailing_median_s"] == pytest.approx(0.01)
    assert d.summary()["anomaly_counts"] == {"slow_step": 1}


def test_detector_median_baseline_resists_periodic_spikes():
    d = StragglerDetector(window=16, min_history=8)
    flagged = [i for i in range(64)
               if d.observe(i, 0.04 if (i % 8 == 7 and i > 8) else 0.01) is not None]
    assert flagged == [15, 23, 31, 39, 47, 55, 63]


def test_detector_host_wait_regression_and_floor():
    d = StragglerDetector(window=16, min_history=8, min_host_wait_s=0.005)
    for i in range(20):
        assert d.observe(i, 0.01, host_wait_s=2e-4 if i % 2 else 1e-6) is None
    a = d.observe(20, 0.01, host_wait_s=0.5)
    assert a is not None and a["kind"] == "host_wait_regression"
    assert a["host_wait_s"] == 0.5
    assert d.summary()["anomaly_counts"] == {"host_wait_regression": 1}


def test_detector_window_validation():
    with pytest.raises(ValueError, match="window must be >= min_history"):
        StragglerDetector(window=4, min_history=8)


# ------------------------------------------------------------- StepTimeline


def test_timeline_records_and_summarises():
    clk = FakeClock()
    tl = StepTimeline(clock=clk)
    for i in range(10):
        clk.t += 0.02
        assert tl.record_step(i + 1, 0.02, host_wait_s=0.001, dispatch_s=0.0005) is None
    assert tl.last_step == 10
    s = tl.summary(window_s=60.0)
    assert s["last_step"] == 10
    assert s["step_s"]["count"] == 10 and s["host_wait_s"]["count"] == 10
    assert 0.01 < s["step_s"]["p50"] <= 0.025
    assert s["steps_per_sec"] == pytest.approx(10 / 60.0)
    assert sum(s["step_counts"]) == 10
    assert len(s["step_bounds"]) + 1 == len(s["step_counts"])
    assert s["anomaly_counts"] == {}


def test_timeline_surfaces_detector_anomaly():
    tl = StepTimeline(StragglerDetector(window=16, min_history=4), clock=FakeClock())
    for i in range(8):
        tl.record_step(i + 1, 0.01)
    a = tl.record_step(9, 0.2)
    assert a is not None and a["kind"] == "slow_step"
    assert tl.summary()["recent_anomalies"][-1]["step"] == 9


# ------------------------------------------------------- beacons + fleet view


def _beacon(host, p50, count=50, last_step=100):
    return {"host": host, "last_step": last_step,
            "steps_per_sec": 1.0 / p50 if p50 else 0.0,
            "step_s": {"count": count, "p50": p50, "p90": p50, "p99": p50},
            "anomaly_counts": {}}


def test_fleet_straggler_flags_only_the_slow_host():
    assert detect_fleet_stragglers([_beacon(0, 0.25), _beacon(1, 0.01), _beacon(2, 0.012)],
                                   ratio=2.0) == [0]


def test_uniformly_slow_fleet_flags_nobody():
    assert detect_fleet_stragglers([_beacon(h, 0.1) for h in range(4)], ratio=2.0) == []


def test_two_host_fleet_uses_other_host_as_baseline():
    assert detect_fleet_stragglers([_beacon(0, 0.05), _beacon(1, 0.01)], ratio=2.0) == [0]


def test_fleet_straggler_edge_cases():
    assert detect_fleet_stragglers([], ratio=2.0) == []
    assert detect_fleet_stragglers([_beacon(0, 0.5)], ratio=2.0) == []
    assert detect_fleet_stragglers([_beacon(0, 0.0, count=0), _beacon(1, 0.01)],
                                   ratio=2.0) == []
    assert detect_fleet_stragglers([_beacon(0, 0.02), _beacon(1, 0.01), _beacon(2, 0.01)],
                                   ratio=2.0) == []


def test_fleet_summary_shape():
    view = fleet_summary([_beacon(0, 0.25, last_step=90), _beacon(1, 0.01)], ratio=2.0)
    assert view["n_hosts"] == 2 and view["stragglers"] == [0]
    assert {h["host"]: h["straggler"] for h in view["hosts"]} == {0: True, 1: False}
    assert view["hosts"][0]["last_step"] == 90
    assert view["hosts"][0]["median_step_s"] == 0.25


def test_beacon_write_read_roundtrip(tmp_path):
    clk = FakeClock()
    fast, slow = StepTimeline(clock=clk), StepTimeline(clock=clk)
    for i in range(20):
        clk.t += 0.01
        fast.record_step(i + 1, 0.005)
        slow.record_step(i + 1, 0.25)
    HostBeacon(tmp_path, 0, fast).write()
    HostBeacon(tmp_path, 1, slow, extras=lambda: {"injected_faults": {"slow_step": 1}}).write()
    (tmp_path / "host_zz.json").write_text("{not json")  # torn write
    beacons = read_beacons(tmp_path)
    assert [b["host"] for b in beacons] == [0, 1]
    assert all(b["last_step"] == 20 for b in beacons)
    assert beacons[1]["injected_faults"] == {"slow_step": 1}
    assert detect_fleet_stragglers(beacons, ratio=2.0) == [1]
    assert fleet_summary(beacons)["stragglers"] == [1]
    # The JAX package reads the port's beacons the same way.
    assert jfleet.fleet_summary(jfleet.read_beacons(tmp_path)) == fleet_summary(beacons)


def test_beacon_write_is_atomic_replace(tmp_path):
    tl = StepTimeline(clock=FakeClock())
    tl.record_step(1, 0.01)
    b = HostBeacon(tmp_path, 3, tl)
    p1 = b.write()
    tl.record_step(2, 0.01)
    p2 = b.write()
    assert p1 == p2 == tmp_path / "host_3.json"
    assert not list(tmp_path.glob("*.tmp"))
    assert json.loads(p1.read_text())["last_step"] == 2


# ----------------------------------------------------------- fit integration


def test_fit_records_timeline():
    """The port's loop feeds the timeline: every step lands with its
    pull-ahead wait, and a seeded slow step is flagged in line."""
    import itertools

    from distributed_tensorflow_tpu_torch.train import create_train_state, fit
    from distributed_tensorflow_tpu_torch.train.state import Transform

    tx = Transform(lambda p: torch.optim.SGD(list(p.values()), lr=0.1), lambda c: 0.1)
    state = create_train_state({"w": torch.nn.Parameter(torch.zeros(2))}, tx)
    calls = {"n": 0}

    def train_step(state, batch, rng):
        i = calls["n"]
        calls["n"] += 1
        time.sleep(0.25 if i == 10 else 0.01)
        state.step += 1
        return state, {}

    tl = StepTimeline(StragglerDetector(window=16, min_history=8))
    fit(state, train_step, itertools.repeat({"x": 1}), num_steps=12, log_every=0,
        timeline=tl, rng=torch.Generator())
    assert tl.last_step == 12
    assert tl.step_time.window_count(None) == 12
    assert tl.host_wait.window_count(None) == 12
    summary = tl.detector.summary()
    assert summary["anomaly_counts"].get("slow_step") == 1
    (anomaly,) = [a for a in summary["recent_anomalies"] if a["kind"] == "slow_step"]
    assert anomaly["step"] == 11 and anomaly["ratio"] > 3.0


# --------------------------------------- FleetSupervisor: restart vs re-mesh


def _write_beacon(d, host, wall_time, p50=0.1, last_step=10):
    (d / f"host_{host}.json").write_text(json.dumps(
        {"host": host, "wall_time": wall_time, "last_step": last_step,
         "step_s": {"p50": p50, "count": 5}}))


def test_fleet_supervisor_healthy_fleet(tmp_path):
    _write_beacon(tmp_path, 0, 99.0)
    _write_beacon(tmp_path, 1, 99.5)
    verdict = FleetSupervisor(tmp_path, expected_hosts=2, heartbeat_timeout_s=5.0,
                              clock=lambda: 100.0).poll()
    assert verdict["action"] == "none"
    assert verdict["alive_hosts"] == [0, 1] and not verdict["lost_hosts"]


def test_fleet_supervisor_stale_beacon_is_lost(tmp_path):
    rec = FlightRecorder(64)
    _write_beacon(tmp_path, 0, 90.0)  # age 10 > timeout 5
    _write_beacon(tmp_path, 1, 99.0)
    sup = FleetSupervisor(tmp_path, expected_hosts=2, heartbeat_timeout_s=5.0,
                          clock=lambda: 100.0, recorder=rec)
    verdict = sup.poll()
    assert verdict["action"] == "re_mesh"
    assert verdict["lost_hosts"] == [0] and verdict["alive_hosts"] == [1]
    sup.poll()  # second poll: same loss, no duplicate event
    assert [e["kind"] for e in rec.events()].count("host_lost") == 1


def test_fleet_supervisor_missing_beacon_is_lost(tmp_path):
    _write_beacon(tmp_path, 0, 99.0)
    verdict = FleetSupervisor(tmp_path, expected_hosts=3, heartbeat_timeout_s=5.0,
                              clock=lambda: 100.0).poll()
    assert verdict["action"] == "re_mesh"
    assert verdict["lost_hosts"] == [1, 2] and verdict["n_expected"] == 3


def test_fleet_supervisor_straggler_means_restart(tmp_path):
    _write_beacon(tmp_path, 0, 99.0, p50=0.5)
    _write_beacon(tmp_path, 1, 99.0, p50=0.1)
    verdict = FleetSupervisor(tmp_path, expected_hosts=2, heartbeat_timeout_s=5.0,
                              clock=lambda: 100.0).poll()
    assert verdict["action"] == "restart"
    assert verdict["stragglers"] == [0] and not verdict["lost_hosts"]


def test_fleet_supervisor_expects_every_seen_host(tmp_path):
    _write_beacon(tmp_path, 0, 99.0)
    _write_beacon(tmp_path, 1, 99.0)
    clock = {"t": 100.0}
    sup = FleetSupervisor(tmp_path, heartbeat_timeout_s=5.0, clock=lambda: clock["t"])
    assert sup.poll()["action"] == "none"
    (tmp_path / "host_1.json").unlink()
    clock["t"] = 101.0
    verdict = sup.poll()
    assert verdict["action"] == "re_mesh" and verdict["lost_hosts"] == [1]


# ------------------------------------------------------ ReplicaSupervisor


def test_supervisor_threshold_then_restart_verdict():
    sup = ReplicaSupervisor(fail_threshold=3, max_restarts=2)
    sup.record_poll(False)
    sup.record_poll(False)
    assert sup.verdict() == "none"
    sup.record_poll(True)
    sup.record_poll(False)
    sup.record_poll(False)
    assert sup.verdict() == "none"
    sup.record_poll(False)
    assert sup.verdict() == "restart"


def test_supervisor_budget_exhaustion_quarantines():
    sup = ReplicaSupervisor(fail_threshold=1, max_restarts=2, backoff_base_s=0.5,
                            backoff_factor=2.0, backoff_max_s=30.0)
    sup.record_poll(False)
    assert sup.verdict() == "restart"
    assert sup.record_restart() == 0.5
    sup.record_poll(False)
    assert sup.verdict() == "restart"
    assert sup.record_restart() == 1.0
    sup.record_poll(False)
    assert sup.verdict() == "quarantine"
    assert sup.summary()["total_restarts"] == 2
    with pytest.raises(ValueError, match="fail_threshold"):
        ReplicaSupervisor(fail_threshold=0)
    with pytest.raises(ValueError, match="max_restarts"):
        ReplicaSupervisor(max_restarts=-1)


def test_supervisor_progress_resets_budget():
    sup = ReplicaSupervisor(fail_threshold=1, max_restarts=2)
    for _ in range(10):
        sup.record_poll(False)
        assert sup.verdict() == "restart"
        sup.record_restart()
        sup.record_ready()
    assert sup.summary()["total_restarts"] == 10
    assert sup.summary()["consecutive_restarts"] == 0


def test_supervisor_backoff_caps():
    sup = ReplicaSupervisor(fail_threshold=1, max_restarts=10, backoff_base_s=1.0,
                            backoff_factor=10.0, backoff_max_s=5.0)
    assert [sup.record_restart() for _ in range(3)] == [1.0, 5.0, 5.0]
    assert pfleet.ReplicaSupervisor is ReplicaSupervisor
