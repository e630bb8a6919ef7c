"""Port parity and behaviour: deterministic fault injection, training and
serving (``train/faultinject.py``, ``serve/faultinject.py``).

A plan is a pure function of its spec, so the port's ``FaultPlan`` must
equal the JAX package's event for event (exact equality of kind, step and
duration) over a grid of seeds, counts, ``min_step`` and ``slow_step_s``:
from ``generate``, from ``parse`` and through a JSON round trip in either
direction. Then the injectors' semantics, as the JAX package's
``tests/test_resilience.py`` and ``tests/test_migrate.py`` pin them:
one-shot events with stacked duplicates, the scheduled sleep (through an
injected ``sleep``), bad specs, and ``host_drop`` / ``replica_kill`` as a
real SIGKILL (exit -9) of a throwaway interpreter, after the flight
recorder's dump.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from distributed_tensorflow_tpu.serve import faultinject as jserve
from distributed_tensorflow_tpu.train import faultinject as jtrain
from distributed_tensorflow_tpu_torch.obs.flightrec import FlightRecorder
from distributed_tensorflow_tpu_torch.serve import faultinject as pserve
from distributed_tensorflow_tpu_torch.train import faultinject as ptrain
from distributed_tensorflow_tpu_torch.train.resilience import classify_failure

ROOT = Path(__file__).resolve().parents[1]
SEEDS = (0, 7, 123)
GRID = [  # (num_steps, min_step, slow_step_s)
    (10, 1, 0.05), (100, 5, 0.2), (40, 0, 0.0),
]


def _events(plan) -> list[tuple]:
    return [dataclasses.astuple(e) for e in plan.events]


def _counts(kinds, seed):
    """A seeded spread of per-kind counts over ``kinds``, one kind absent."""
    counts = {k: (seed + i) % 4 for i, k in enumerate(kinds)}
    counts[kinds[seed % len(kinds)]] = 0
    return counts


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("side", ["train", "serve"])
def test_fault_plans_equal_jax_event_for_event(side, seed, tmp_path):
    jmod, pmod = (jtrain, ptrain) if side == "train" else (jserve, pserve)
    assert pmod.FAULT_KINDS == jmod.FAULT_KINDS
    for num_steps, min_step, slow_s in GRID:
        counts = _counts(pmod.FAULT_KINDS, seed)
        want = jmod.FaultPlan.generate(seed, num_steps, counts, slow_step_s=slow_s,
                                       min_step=min_step)
        got = pmod.FaultPlan.generate(seed, num_steps, counts, slow_step_s=slow_s,
                                      min_step=min_step)
        assert _events(got) == _events(want) and got.seed == want.seed == seed
        spec = ",".join([f"seed={seed}", f"slow_step_s={slow_s}", f"min_step={min_step}",
                         *(f"{k}={n}" for k, n in counts.items())])
        parsed = pmod.FaultPlan.parse(spec, num_steps=num_steps)
        assert _events(parsed) == _events(jmod.FaultPlan.parse(spec, num_steps=num_steps))
        assert parsed == got
        # JSON written by either package replays identically in the other.
        for i, (writer, reader) in enumerate(((want, pmod), (got, jmod))):
            path = tmp_path / f"{side}_{seed}_{num_steps}_{i}.json"
            path.write_text(writer.to_json())
            assert _events(reader.FaultPlan.parse(str(path))) == _events(want)
        assert json.loads(got.to_json()) == json.loads(want.to_json())


# ---- training plan and injector (tests/test_resilience.py's cases) --------


def test_fault_plan_generate_deterministic():
    counts = {"feeder_error": 2, "slow_step": 1, "ckpt_write_error": 1}
    a = ptrain.FaultPlan.generate(7, 100, counts, slow_step_s=0.2)
    assert a == ptrain.FaultPlan.generate(7, 100, counts, slow_step_s=0.2)
    assert len(a.events) == 4 and all(1 <= e.step < 100 for e in a.events)
    slow = [e for e in a.events if e.kind == "slow_step"]
    assert slow and slow[0].duration_s == 0.2
    assert ptrain.FaultPlan.generate(8, 100, counts, slow_step_s=0.2) != a


def test_fault_plan_parse_rejects_bad_specs():
    with pytest.raises(ValueError, match="unknown --fault-plan key"):
        ptrain.FaultPlan.parse("seed=1,bogus_kind=2", num_steps=10)
    with pytest.raises(ValueError, match="num_steps"):
        ptrain.FaultPlan.parse("seed=1,feeder_error=1")
    with pytest.raises(ValueError, match="key=value"):
        ptrain.FaultPlan.parse("seed", num_steps=10)
    with pytest.raises(ValueError, match="unknown fault kind"):
        ptrain.FaultEvent("bogus", 3)
    with pytest.raises(ValueError, match="step must be >= 0"):
        ptrain.FaultEvent("slow_step", -1)


def test_injector_one_shot_with_duplicates():
    """Two events, same kind, same step: fire once each, then never again."""
    plan = ptrain.FaultPlan((ptrain.FaultEvent("feeder_error", 4),
                             ptrain.FaultEvent("feeder_error", 4),
                             ptrain.FaultEvent("ckpt_write_error", 2)))
    rec = FlightRecorder(64)
    inj = ptrain.FaultInjector(plan, recorder=rec)
    for _ in range(2):
        with pytest.raises(ptrain.InjectedFault):
            inj.check_feeder(4)
    inj.check_feeder(4)  # multiset drained: no third firing
    inj.check_feeder(3)  # unscheduled index: silent
    with pytest.raises(ptrain.InjectedFault) as exc_info:
        inj.check_ckpt_save(2)
    assert isinstance(exc_info.value, OSError)  # the transient class
    assert classify_failure(exc_info.value) == "transient"
    inj.check_ckpt_save(2)
    assert [e["fault"] for e in rec.events() if e["kind"] == "fault_injected"] == [
        "feeder_error", "feeder_error", "ckpt_write_error"]
    summary = inj.summary()
    assert summary["injected_faults"] == {"feeder_error": 2, "ckpt_write_error": 1}
    assert len(summary["recent_injected"]) == 3


def test_injector_slow_step_sleeps_and_nonfinite_poisons():
    slept = []
    plan = ptrain.FaultPlan((ptrain.FaultEvent("slow_step", 3, duration_s=0.25),
                             ptrain.FaultEvent("nonfinite_loss", 3)))
    inj = ptrain.FaultInjector(plan, sleep=slept.append)
    assert inj.on_step(2) is False
    assert inj.on_step(3) is True  # slept, and this step's loss is poisoned
    assert inj.on_step(3) is False
    assert slept == [0.25]


# ---- serving plan and injector (tests/test_migrate.py's cases) ------------


def test_serving_fault_plan_generate_is_deterministic_and_capped():
    counts = {"slow_decode_step": 3, "replica_kill": 1}
    a = pserve.FaultPlan.generate(7, 100, counts)
    assert a == pserve.FaultPlan.generate(7, 100, counts)
    assert a.events != pserve.FaultPlan.generate(8, 100, counts).events
    assert [e.step for e in a.events] == sorted(e.step for e in a.events)
    # Counts cap at the step span: every step of [2, 5) at most.
    assert len(pserve.FaultPlan.generate(0, 5, {"slow_decode_step": 99}, min_step=2).events) == 3
    with pytest.raises(ValueError, match="unknown fault kind"):
        pserve.FaultPlan.generate(0, 10, {"meteor_strike": 1})
    with pytest.raises(ValueError, match="num_steps"):
        pserve.FaultPlan.generate(0, 1, {"slow_decode_step": 1})
    with pytest.raises(ValueError, match="num_steps"):
        pserve.FaultPlan.parse("seed=7,replica_kill=1")


def test_serving_injector_hooks_fire_once():
    plan = pserve.FaultPlan((pserve.FaultEvent("probe_timeout", 1),
                             pserve.FaultEvent("wire_corrupt", 2),
                             pserve.FaultEvent("slow_decode_step", 3, duration_s=0.5),
                             pserve.FaultEvent("dispatch_error", 4)))
    rec = FlightRecorder(64)
    slept = []
    inj = pserve.FaultInjector(plan, recorder=rec, sleep=slept.append)
    assert inj.check_probe(1) and not inj.check_probe(1)
    assert inj.check_wire(2) and not inj.check_wire(2)
    assert not inj.check_wire(3)
    inj.on_decode_step(3)
    inj.on_decode_step(3)
    assert slept == [0.5]
    with pytest.raises(pserve.InjectedFault, match="dispatch_error"):
        inj.on_decode_step(4)
    inj.on_decode_step(4)  # consumed: the retry sails through
    assert inj.summary()["injected_faults"] == {
        "probe_timeout": 1, "wire_corrupt": 1, "slow_decode_step": 1, "dispatch_error": 1}
    assert sorted(e["fault"] for e in rec.events() if e["kind"] == "fault_injected") == [
        "dispatch_error", "probe_timeout", "slow_decode_step", "wire_corrupt"]


# ---- the kill switches: a real SIGKILL, after the dump -------------------


@pytest.mark.parametrize("side,kind,hook", [
    ("train", "host_drop", "on_step"),
    ("serve", "replica_kill", "on_decode_step"),
])
def test_kill_events_sigkill_the_process_after_dumping(side, kind, hook, tmp_path):
    code = (
        f"from distributed_tensorflow_tpu_torch.{side}.faultinject import "
        "FaultEvent, FaultInjector, FaultPlan\n"
        "from distributed_tensorflow_tpu_torch.obs.flightrec import FlightRecorder\n"
        f"rec = FlightRecorder(dump_dir={str(tmp_path)!r})\n"
        f"inj = FaultInjector(FaultPlan((FaultEvent({kind!r}, 2),)), recorder=rec)\n"
        "for s in range(5):\n"
        f"    inj.{hook}(s)\n"
        "print('SURVIVED')\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env=env, cwd=ROOT)
    assert out.returncode == -9, (out.returncode, out.stderr[-500:])
    assert "SURVIVED" not in out.stdout
    (dump,) = tmp_path.glob("flightrec-*.json")
    payload = json.loads(dump.read_text())
    assert payload["reason"] == kind
    assert [e["fault"] for e in payload["events"] if e["kind"] == "fault_injected"] == [kind]
