"""The CLIs' chaos flags and the serving fault hook, on the CPU.

Training: ``cli.train --config mnist_lenet --device cpu`` with
``--resilient --max-restarts --fault-plan --nonfinite --beacon-dir
--dump-dir``: the run completes across its injected faults with a restart,
and its beacon carries the injected counts; an outside SIGTERM stops a
``--resilient`` run with exit 0 and a durable checkpoint at the stop step,
which a second launch resumes to its end; ``--nonfinite abort`` fails with
a flight-recorder dump; ``--resilient --device-pool`` is refused. Every
backoff and scheduled sleep goes through an injected ``sleep``.

Serving: on the port's continuous batcher over the tiny causal LM of
``tests/_torch_serve_common.py``, a ``dispatch_error`` fails exactly the
slots of its decode step while every other request finishes with the
stream of a fault-free run, and ``slow_decode_step`` sleeps its scheduled
time; ``cli.serve --fault-plan`` arms the injector (decode serving only).
"""

from __future__ import annotations

import functools
import json
import logging
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
from _torch_serve_common import port_engine, run_batcher

from distributed_tensorflow_tpu_torch.ckpt.checkpoint import latest_step
from distributed_tensorflow_tpu_torch.cli import train as cli
from distributed_tensorflow_tpu_torch.serve import BatcherConfig, ContinuousBatcher
from distributed_tensorflow_tpu_torch.serve.faultinject import (
    FaultEvent,
    FaultInjector,
    FaultPlan,
    InjectedFault,
)
from distributed_tensorflow_tpu_torch.train import NonFiniteLossError, faultinject, resilience

ROOT = Path(__file__).resolve().parents[1]
LENET = ["--config=mnist_lenet", "--device=cpu", "--global-batch=8", "--no-native-input",
         "--log-every=1"]
TERM_STEPS = 200  # bounds the run that is sent SIGTERM after its step 3


@pytest.fixture()
def slept(monkeypatch):
    """Route the CLI's backoff and injected sleeps into a list."""
    out = []
    monkeypatch.setattr(resilience, "ResilienceConfig",
                        functools.partial(resilience.ResilienceConfig, sleep=out.append))
    monkeypatch.setattr(faultinject, "FaultInjector",
                        functools.partial(faultinject.FaultInjector, sleep=out.append))
    return out


def test_train_cli_resilient_completes_across_faults(tmp_path, slept, caplog):
    spec = "seed=7,feeder_error=1,ckpt_write_error=1,slow_step=1"
    with caplog.at_level(logging.INFO):
        assert cli.main([*LENET, "--steps=8", "--resilient", "--max-restarts=2",
                         f"--fault-plan={spec}", "--ckpt-every=1",
                         f"--ckpt-dir={tmp_path / 'ck'}", f"--beacon-dir={tmp_path / 'b'}",
                         f"--dump-dir={tmp_path / 'd'}"]) == 0
    assert latest_step(tmp_path / "ck") == 8
    beacon = json.loads((tmp_path / "b" / "host_0.json").read_text())
    assert beacon["injected_faults"] == {"feeder_error": 1, "ckpt_write_error": 1,
                                         "slow_step": 1}
    assert beacon["last_step"] == 8 and beacon["host"] == 0
    assert "fault plan armed: 3 scheduled events" in caplog.text
    assert "restart 1 in 0.5s" in caplog.text
    assert "checkpoint save at step" in caplog.text  # the absorbed write fault
    assert sorted(slept) == [0.05, 0.5]  # the slow step, then the backoff
    assert not list((tmp_path / "d").glob("*.json"))  # nothing unhandled


def test_train_cli_nonfinite_abort_dumps(tmp_path, slept):
    with pytest.raises(NonFiniteLossError):
        cli.main([*LENET, "--steps=6", "--fault-plan=seed=3,nonfinite_loss=1",
                  "--nonfinite=abort", f"--dump-dir={tmp_path}"])
    (dump,) = tmp_path.glob("flightrec-*.json")
    payload = json.loads(dump.read_text())
    assert payload["reason"] == "train_failure" and payload["memz"] is not None
    kinds = [e["kind"] for e in payload["events"]]
    assert kinds[:3] == ["fault_injected", "nonfinite_loss", "engine_failure"]
    assert payload["events"][2]["error"] == "NonFiniteLossError"


def test_train_cli_nonfinite_skip_trains_on(tmp_path, slept):
    assert cli.main([*LENET, "--steps=4", "--fault-plan=seed=3,nonfinite_loss=1",
                     "--nonfinite=skip", f"--beacon-dir={tmp_path}"]) == 0
    beacon = json.loads((tmp_path / "host_0.json").read_text())
    assert beacon["injected_faults"] == {"nonfinite_loss": 1} and beacon["last_step"] == 4


def test_train_cli_resilient_refuses_device_pool(capsys):
    with pytest.raises(SystemExit) as ei:
        cli.main([*LENET, "--resilient", "--device-pool=4"])
    assert ei.value.code == 2
    assert "--resilient does not compose with --device-pool" in capsys.readouterr().err


def _signal_on_line(proc, needle: str, sig, timeout: float) -> str:
    """Send ``sig`` to ``proc`` once a line of its stderr holds ``needle``,
    then wait for its end; returns its stderr. A reader thread drains the
    pipe, so the deadline holds whatever the process prints: past
    ``timeout`` seconds in all, or at an end with no such line, the process
    is killed and the test fails."""
    lines, seen = [], threading.Event()

    def read():
        for line in proc.stderr:
            lines.append(line)
            if needle in line:
                seen.set()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    deadline = time.monotonic() + timeout
    try:
        while not seen.wait(0.05):
            if proc.poll() is not None or time.monotonic() > deadline:
                pytest.fail(f"no {needle!r} within {timeout} s (exit {proc.poll()}):\n"
                            f"{''.join(lines)[-3000:]}")
        proc.send_signal(sig)
        proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        reader.join(timeout=10)
    return "".join(lines)


def test_train_cli_sigterm_checkpoints_and_a_second_launch_resumes(tmp_path, caplog):
    ck = tmp_path / "ck"
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    # At most TERM_STEPS steps (about 10 ms each): a missed signal ends the
    # run on its own, and the test fails on the stop step.
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_tensorflow_tpu_torch.cli.train", *LENET,
         f"--steps={TERM_STEPS}", "--resilient", f"--ckpt-dir={ck}"],
        cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    err = _signal_on_line(proc, "train.loop: step 3:", signal.SIGTERM, timeout=120)
    assert proc.returncode == 0, err[-3000:]
    stop = latest_step(ck)
    assert stop is not None and 3 <= stop < TERM_STEPS
    assert f"preempted at step {stop}" in err
    with caplog.at_level(logging.INFO):
        assert cli.main([*LENET, f"--steps={stop + 2}", "--resilient", f"--ckpt-dir={ck}"]) == 0
    assert f"restored checkpoint at step {stop}" in caplog.text
    assert f"step {stop + 1}:" in caplog.text and f"step {stop + 2}:" in caplog.text
    assert latest_step(ck) == stop + 2


# ---------------------------------------------------------------- serving


def _requests(n: int = 6):
    rng = np.random.default_rng(11)
    return [{"input_ids": rng.integers(5, 64, int(rng.integers(4, 14))).tolist(),
             "max_new_tokens": 8} for _ in range(n)]


def test_dispatch_error_fails_exactly_one_steps_slots():
    reqs = _requests()
    ref, _ = run_batcher(ContinuousBatcher, port_engine(), BatcherConfig(max_batch=2), reqs)
    sleeps, failed = [], []
    b = ContinuousBatcher(port_engine(), BatcherConfig(max_batch=2))
    b.fault_injector = FaultInjector(
        FaultPlan((FaultEvent("slow_decode_step", 2, duration_s=0.3),
                   FaultEvent("dispatch_error", 4))), sleep=sleeps.append)
    fail = b._fail_slots

    def recording(tags, exc):
        failed.append((len(tags), exc))
        fail(tags, exc)

    b._fail_slots = recording
    with b:
        futs = [b.submit(dict(r)) for r in reqs]
        outcomes = []
        for f in futs:
            try:
                outcomes.append(f.result(timeout=120)["tokens"])
            except InjectedFault as e:
                outcomes.append(e)
    assert sleeps == [0.3]
    ((n_slots, exc),) = failed
    assert isinstance(exc, InjectedFault) and exc.kind == "dispatch_error" and exc.step == 4
    errors = [o for o in outcomes if isinstance(o, InjectedFault)]
    # The step's occupants fail, less any that finished on an earlier step
    # while it was planned; the batcher counts the ones it failed.
    assert 1 <= len(errors) <= n_slots and all(e is exc for e in errors)
    assert b.metrics.errors.value == 1
    assert b.metrics.rejected_by_cause.snapshot() == {"engine_failure": len(errors)}
    for got, want in zip(outcomes, ref):
        if not isinstance(got, InjectedFault):
            assert got == want
    assert b.fault_injector.summary()["injected_faults"] == {"slow_decode_step": 1,
                                                             "dispatch_error": 1}


def test_serve_cli_fault_plan_arms_the_decode_loop(tmp_path, capsys):
    from distributed_tensorflow_tpu_torch.cli.serve import (
        PRESETS,
        build_serving_client,
        main,
        make_parser,
    )

    geom = ["--bert-layers=1", "--bert-hidden=48", "--bert-vocab=64"]
    ck = tmp_path / "ck"
    assert cli.main(["--config=lm_base", "--device=cpu", *geom, "--steps=1",
                     "--global-batch=8", f"--ckpt-dir={ck}"]) == 0
    plan = tmp_path / "plan.json"
    plan.write_text(FaultPlan((FaultEvent("slow_decode_step", 1, duration_s=0.01),
                               FaultEvent("dispatch_error", 3))).to_json())
    args = make_parser().parse_args(["--config=lm_base", "--device=cpu", f"--ckpt-dir={ck}",
                                     *geom, "--slots=2", f"--fault-plan={plan}"])
    client, _ = build_serving_client(PRESETS["lm_base"], args)
    try:
        inj = client.batcher.fault_injector
        assert [e.kind for e in inj.plan.events] == ["slow_decode_step", "dispatch_error"]
        fut = client.submit({"input_ids": list(range(5, 15)), "max_new_tokens": 6})
        with pytest.raises(InjectedFault, match="dispatch_error"):
            fut.result(timeout=120)
        again = client.submit({"input_ids": list(range(5, 15)), "max_new_tokens": 6})
        assert again.result(timeout=120)["n_tokens"] == 6
        assert inj.summary()["injected_faults"] == {"slow_decode_step": 1,
                                                    "dispatch_error": 1}
    finally:
        client.close()
    spec = make_parser().parse_args(["--config=lm_base", "--device=cpu", f"--ckpt-dir={ck}",
                                     *geom, "--fault-plan=seed=5,slow_decode_step=2",
                                     "--fault-steps=40"])
    client, _ = build_serving_client(PRESETS["lm_base"], spec)
    try:
        steps = [e.step for e in client.batcher.fault_injector.plan.events]
        assert len(steps) == 2 and all(1 <= s < 40 for s in steps)
    finally:
        client.close()
    with pytest.raises(SystemExit) as ei:
        main(["--config=bert_base", f"--ckpt-dir={ck}", "--device=cpu",
              "--fault-plan=seed=1,dispatch_error=1"])
    assert ei.value.code == 2
    assert "only applies to causal-LM decode serving" in capsys.readouterr().err
