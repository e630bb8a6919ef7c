"""Port parity and behaviour: resilient training (``train/resilience.py``)
with the fault hooks in ``fit``, the feed stage and the ``Checkpointer``.

Mirrors the JAX package's ``tests/test_resilience.py`` on the port's LeNet
on the CPU: ``classify_failure``; a feeder fault restarting from the last
checkpoint; a checkpoint-write fault absorbed by the retry; a lost save
cadence that is not fatal; consecutive lost cadences that are; an
exhausted restart budget; progress that resets it; non-finite loss abort
and skip; a bad policy; SIGTERM preemption with its final synchronous
checkpoint; the handler's install and restore. Every backoff goes through
an injected ``sleep``.

Parity: the JAX package's ``run_resilient`` (a one-device mesh, orbax
checkpoints) and the port's, from the same LeNet params, with a feeder
fault at 3 and ``ckpt_every=2``: per-step losses and final params within
the LeNet tolerance of ``tests/test_torch_image_train.py`` (atol 1e-6,
rtol 1e-5: the same f32 arithmetic in another order, over six SGD-momentum
steps). The port's interrupted run against its own uninterrupted one:
bitwise (losses, params and momentum). Elastic restore: a checkpoint
written by two gloo ranks restored into one process under
``plan_elastic_mesh(1, ..., old_dp=2)`` (``grad_accum`` 2), then a finite
step.
"""

from __future__ import annotations

import os
import signal

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu_torch.ckpt import Checkpointer
from distributed_tensorflow_tpu_torch.data.loader import device_batches
from distributed_tensorflow_tpu_torch.data.prefetch import prefetch
from distributed_tensorflow_tpu_torch.data.synthetic import synthetic_image_classification
from distributed_tensorflow_tpu_torch.models import LeNet5
from distributed_tensorflow_tpu_torch.train import (
    FaultEvent,
    FaultInjector,
    FaultPlan,
    InjectedFault,
    NonFiniteLossError,
    create_train_state,
    fit,
    make_train_step,
)
from distributed_tensorflow_tpu_torch.train.objectives import make_classification_loss
from distributed_tensorflow_tpu_torch.train.resilience import (
    CheckpointSaveError,
    PreemptionHandler,
    ResilienceConfig,
    ResilientCheckpointer,
    RestartBudgetExhausted,
    ckpt_save_errors_total,
    classify_failure,
    run_resilient,
    train_restarts_total,
)
from distributed_tensorflow_tpu_torch.train.state import Transform

ATOL, RTOL = 1e-6, 1e-5
LR, MOMENTUM, ROWS = 0.05, 0.9, 32
TX = Transform(lambda p: torch.optim.SGD(list(p.values()), lr=LR, momentum=MOMENTUM),
               lambda count: LR)
DATA = synthetic_image_classification(256, (28, 28, 1), 10, seed=0)


class FakeRecorder:
    """Flight-recorder stand-in: keeps the event stream, counts dumps."""

    def __init__(self):
        self.events = []
        self.dumps = []

    def record(self, kind, request_id=None, **detail):
        self.events.append({"kind": kind, **detail})

    def dump(self, reason, *, force=False):
        self.dumps.append(reason)

    def kinds(self):
        return [e["kind"] for e in self.events]


class Lenet:
    """One LeNet and its step; ``make_state()`` puts the initial params back
    into the model IN PLACE (the step reads the model's own parameters) and
    builds a fresh optimizer over them."""

    def __init__(self, host: dict | None = None):
        self.model = LeNet5(device="cpu")
        if host is not None:
            self.model.load_state_dict(host)
        self.host = {k: v.detach().clone() for k, v in self.model.state_dict().items()}
        self.step = make_train_step(make_classification_loss(self.model), TX)

    def make_state(self):
        with torch.no_grad():
            for k, p in self.model.named_parameters():
                p.copy_(self.host[k])
        return create_train_state(dict(self.model.named_parameters()), TX)


def _make_batches(injector, rows=ROWS):
    """``run_resilient``'s ``make_batches`` over the seeded stream."""
    return lambda start: prefetch(device_batches(DATA, rows, device="cpu", seed=1,
                                                 start_step=start), 2,
                                  fault_injector=injector)


def _fast(**kw):
    kw.setdefault("sleep", lambda s: None)  # no real backoff in tests
    return ResilienceConfig(**kw)


def _run(net, inj, rec, tmp_path=None, *, num_steps, ckpt_every=0, ckpt_inj=None, **kw):
    ckpt = Checkpointer(tmp_path / "ckpt", fault_injector=ckpt_inj) if tmp_path else None
    try:
        report = run_resilient(net.make_state(), net.step, _make_batches(inj),
                               num_steps=num_steps, checkpointer=ckpt, ckpt_every=ckpt_every,
                               recorder=rec, fault_injector=inj,
                               rng=torch.Generator().manual_seed(0), **{"log_every": 0,
                                                                        "config": _fast(), **kw})
        return report, (ckpt.latest_step() if ckpt else None)
    finally:
        if ckpt is not None:
            ckpt.close()


def test_classify_failure_table():
    assert classify_failure(InjectedFault("feeder_error", 1)) == "transient"
    assert classify_failure(ConnectionError("reset")) == "transient"
    assert classify_failure(RuntimeError("prefetch feeder thread died")) == "transient"
    assert classify_failure(NonFiniteLossError(1, float("nan"))) == "fatal"
    assert classify_failure(CheckpointSaveError("budget")) == "fatal"
    assert classify_failure(ValueError("shape mismatch")) == "fatal"
    assert classify_failure(RuntimeError("CUDA error: an illegal memory access")) == "fatal"


def test_feeder_fault_restarts_and_completes(tmp_path):
    rec = FakeRecorder()
    inj = FaultInjector(FaultPlan((FaultEvent("feeder_error", 3),)), recorder=rec)
    before = train_restarts_total.value
    report, latest = _run(Lenet(), inj, rec, tmp_path, num_steps=6, ckpt_every=2)
    assert latest == 6
    assert report.completed and not report.preempted and report.final_step == 6
    assert report.restarts == 1
    assert report.failures == [{"step": 0, "error": "InjectedFault", "kind": "transient"}]
    assert train_restarts_total.value == before + 1
    assert "fault_injected" in rec.kinds()
    (restart,) = [e for e in rec.events if e["kind"] == "train_restart"]
    assert restart["resume_step"] == 2  # the feed failed fetching batch 3


def test_ckpt_write_fault_absorbed_by_retry(tmp_path):
    rec = FakeRecorder()
    inj = FaultInjector(FaultPlan((FaultEvent("ckpt_write_error", 2),)), recorder=rec)
    before = ckpt_save_errors_total.value
    report, latest = _run(Lenet(), inj, rec, tmp_path, num_steps=4, ckpt_every=2,
                          ckpt_inj=inj)
    assert latest == 4
    assert report.completed and report.restarts == 0
    assert ckpt_save_errors_total.value == before + 1
    (err,) = [e for e in rec.events if e["kind"] == "ckpt_save_error"]
    assert err["step"] == 2 and err["attempt"] == 1
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "step_00000002.pt", "step_00000004.pt"]


def test_ckpt_cadence_failure_nonfatal(tmp_path):
    rec = FakeRecorder()
    inj = FaultInjector(FaultPlan((FaultEvent("ckpt_write_error", 2),
                                   FaultEvent("ckpt_write_error", 2))), recorder=rec)
    report, latest = _run(Lenet(), inj, rec, tmp_path, num_steps=4, ckpt_every=2,
                          ckpt_inj=inj)
    assert latest == 4  # the step-2 cadence is lost, step 4 lands
    assert report.completed and report.restarts == 0
    assert len([e for e in rec.events if e["kind"] == "ckpt_save_error"]) == 2
    assert [p.name for p in (tmp_path / "ckpt").iterdir()] == ["step_00000004.pt"]


def test_consecutive_ckpt_failures_fatal():
    class BrokenCheckpointer:
        def save(self, step, state, *, generator=None):
            raise OSError("disk full")

    rec = FakeRecorder()
    rckpt = ResilientCheckpointer(BrokenCheckpointer(), max_consecutive=3, recorder=rec)
    rckpt.save(2, None)  # cadence 1: absorbed
    rckpt.save(4, None)  # cadence 2: absorbed
    with pytest.raises(CheckpointSaveError):
        rckpt.save(6, None)  # cadence 3: the budget is gone
    assert len([e for e in rec.events if e["kind"] == "ckpt_save_error"]) == 6
    assert classify_failure(CheckpointSaveError("x")) == "fatal"


def test_restart_budget_exhausted():
    rec = FakeRecorder()
    inj = FaultInjector(FaultPlan(tuple(FaultEvent("feeder_error", 0) for _ in range(5))),
                        recorder=rec)
    net = Lenet()
    with pytest.raises(RestartBudgetExhausted):
        _run(net, inj, rec, num_steps=6, config=_fast(max_restarts=2),
             make_state=net.make_state)
    kinds = rec.kinds()
    assert kinds.count("train_restart") == 2 and "train_fatal" in kinds
    assert "train_fatal" in rec.dumps


def test_restart_without_checkpoint_or_make_state_raises():
    """The port's step has moved the live params: with nothing to restore
    and no factory, the failure is not restarted from them."""
    rec = FakeRecorder()
    inj = FaultInjector(FaultPlan((FaultEvent("feeder_error", 2),)), recorder=rec)
    with pytest.raises(RuntimeError, match="no make_state") as exc_info:
        _run(Lenet(), inj, rec, num_steps=6)
    assert isinstance(exc_info.value.__cause__, InjectedFault)


def test_progress_resets_restart_budget(tmp_path):
    rec = FakeRecorder()
    # Feed indices count per stream: index 2 fires in the first segment,
    # index 4 in the one after the restart, each after new checkpoints.
    inj = FaultInjector(FaultPlan((FaultEvent("feeder_error", 2),
                                   FaultEvent("feeder_error", 4))), recorder=rec)
    report, _ = _run(Lenet(), inj, rec, tmp_path, num_steps=10, ckpt_every=1,
                     config=_fast(max_restarts=1))
    assert report.completed and report.restarts == 2  # > max_restarts: progress


@pytest.mark.parametrize("policy", ["abort", "skip"])
def test_nonfinite_loss_policy(policy):
    rec = FakeRecorder()
    inj = FaultInjector(FaultPlan((FaultEvent("nonfinite_loss", 2),)), recorder=rec)
    net = Lenet()
    batches = device_batches(DATA, ROWS, device="cpu", seed=1)
    kw = dict(num_steps=5, rng=torch.Generator().manual_seed(0), log_every=1, recorder=rec,
              fault_injector=inj, nonfinite=policy)
    if policy == "abort":
        with pytest.raises(NonFiniteLossError, match="step 3") as exc_info:
            fit(net.make_state(), net.step, batches, **kw)
        assert classify_failure(exc_info.value) == "fatal"
    else:
        state, metrics = fit(net.make_state(), net.step, batches, **kw)
        assert state.step == 5 and np.isfinite(metrics["loss"])
    (nf,) = [e for e in rec.events if e["kind"] == "nonfinite_loss"]
    assert nf["loss"] == "nan" and nf["step"] == 3 and nf["action"] == policy


def test_fit_rejects_bad_nonfinite_policy():
    net = Lenet()
    with pytest.raises(ValueError, match="nonfinite"):
        fit(net.make_state(), net.step, iter(()), num_steps=1, nonfinite="explode")


def test_preemption_sigterm_checkpoints_and_exits(tmp_path):
    rec = FakeRecorder()
    prev = signal.getsignal(signal.SIGTERM)

    def preempt_at_3(step, state, metrics):
        if step == 3:
            os.kill(os.getpid(), signal.SIGTERM)

    report, latest = _run(Lenet(), None, rec, tmp_path, num_steps=50, log_every=1,
                          hooks=(preempt_at_3,))
    assert latest == report.final_step  # the final save is the proof
    assert report.preempted and not report.completed
    assert report.final_step == 3
    (exit_event,) = [e for e in rec.events if e["kind"] == "preempt_exit"]
    assert exit_event["signum"] == signal.SIGTERM
    assert signal.getsignal(signal.SIGTERM) is prev
    blob = torch.load(tmp_path / "ckpt" / "step_00000003.pt", weights_only=True)
    assert blob["step"] == 3 and blob["generator"] is not None


def test_preemption_handler_install_restore():
    prev = signal.getsignal(signal.SIGTERM)
    h = PreemptionHandler((signal.SIGTERM,)).install()
    try:
        assert not h.should_stop()
        assert signal.getsignal(signal.SIGTERM) == h._handle
        os.kill(os.getpid(), signal.SIGTERM)
        assert h.triggered and h.signum == signal.SIGTERM
    finally:
        h.restore()
    assert signal.getsignal(signal.SIGTERM) is prev
    h.restore()  # idempotent


# ------------------------------------------------------------ parity


def _flax_lenet_params():
    import jax

    from distributed_tensorflow_tpu.models.lenet import LeNet5 as JLeNet5

    img = np.zeros((1, 28, 28, 1), np.float32)
    shapes = jax.eval_shape(lambda: JLeNet5().init(jax.random.key(0), img))["params"]
    rng = np.random.default_rng(3)
    return jax.tree.map(  # lecun-normal scale, as flax initialises LeNet
        lambda s: (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]) or 10)
                   ).astype(np.float32), shapes)


def _jax_resilient(params, tmp_path):
    import jax
    import jax.numpy as jnp
    import optax

    from distributed_tensorflow_tpu.ckpt import Checkpointer as JCheckpointer
    from distributed_tensorflow_tpu.data import loader as jloader
    from distributed_tensorflow_tpu.data.prefetch import prefetch as jprefetch
    from distributed_tensorflow_tpu.models.lenet import LeNet5 as JLeNet5
    from distributed_tensorflow_tpu.parallel.mesh import build_mesh
    from distributed_tensorflow_tpu.train import create_train_state as jcreate
    from distributed_tensorflow_tpu.train import make_train_step as jstep
    from distributed_tensorflow_tpu.train import resilience as jres
    from distributed_tensorflow_tpu.train.faultinject import FaultEvent as JEvent
    from distributed_tensorflow_tpu.train.faultinject import FaultInjector as JInjector
    from distributed_tensorflow_tpu.train.faultinject import FaultPlan as JPlan
    from distributed_tensorflow_tpu.train.objectives import make_classification_loss as jloss
    from distributed_tensorflow_tpu.train.step import place_state

    mesh = build_mesh({"data": 1}, devices=jax.devices()[:1])
    tx = optax.sgd(LR, momentum=MOMENTUM)
    state = place_state(jcreate(jax.tree.map(jnp.asarray, params), tx, {}), mesh)
    inj = JInjector(JPlan((JEvent("feeder_error", 3),)))
    losses = {}
    with JCheckpointer(tmp_path / "jax_ckpt") as ckpt:
        report = jres.run_resilient(
            state, jstep(jloss(JLeNet5()), tx, mesh),
            lambda s: jprefetch(jloader.device_batches(DATA, mesh, ROWS, seed=1, start_step=s),
                                2, fault_injector=inj),
            num_steps=6, checkpointer=ckpt, ckpt_every=2,
            config=jres.ResilienceConfig(sleep=lambda s: None), fault_injector=inj,
            rng=jax.random.key(0), log_every=1,
            hooks=(lambda s, st, m: losses.__setitem__(s, m["loss"]),))
    return report, losses


def test_run_resilient_matches_jax_and_is_bitwise_the_uninterrupted_run(tmp_path):
    import jax

    from distributed_tensorflow_tpu_torch.interop import resnet_params_from_flax

    params = _flax_lenet_params()
    host = resnet_params_from_flax(jax.tree.map(np.asarray, params))[0]
    jreport, jlosses = _jax_resilient(params, tmp_path)
    assert jreport.restarts == 1 and jreport.final_step == 6

    def run(faults: bool):
        net, losses = Lenet(host), {}
        inj = FaultInjector(FaultPlan((FaultEvent("feeder_error", 3),) if faults else ()))
        with Checkpointer(tmp_path / f"ckpt_{faults}") as ckpt:
            report = run_resilient(
                net.make_state(), net.step, _make_batches(inj), num_steps=6,
                checkpointer=ckpt, ckpt_every=2, config=_fast(), fault_injector=inj,
                rng=torch.Generator().manual_seed(0), log_every=1,
                hooks=(lambda s, st, m: losses.__setitem__(s, m["loss"]),))
        return report, losses

    report, losses = run(faults=True)
    clean, clean_losses = run(faults=False)
    assert report.restarts == 1 and clean.restarts == 0
    assert sorted(losses) == sorted(jlosses) == list(range(1, 7))
    np.testing.assert_allclose([losses[s] for s in range(1, 7)],
                               [jlosses[s] for s in range(1, 7)], atol=ATOL, rtol=RTOL)
    want = resnet_params_from_flax(jax.tree.map(np.asarray, jreport.state.params))[0]
    for name, p in report.state.params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=ATOL,
                                   rtol=RTOL, err_msg=name)
    # Against its own uninterrupted run: bit for bit.
    assert losses == clean_losses
    for name, p in report.state.params.items():
        assert torch.equal(p, clean.state.params[name]), name
    slots, clean_slots = (r.state.opt_state.optimizer.state for r in (report, clean))
    for p, q in zip(report.state.params.values(), clean.state.params.values()):
        assert torch.equal(slots[p]["momentum_buffer"], clean_slots[q]["momentum_buffer"])


def test_elastic_restore_of_a_two_rank_checkpoint_into_one_process(tmp_path):
    from _torch_mp_worker import lenet_run
    from test_torch_multiprocess import _launch

    from distributed_tensorflow_tpu_torch.parallel.mesh import plan_elastic_mesh

    ranks = _launch(tmp_path, "elastic")
    assert [r["step"] for r in ranks] == [2, 2]
    plan = plan_elastic_mesh(1, global_batch=ROWS, grad_accum=1, old_dp=2)
    assert plan.axes == {"data": 1} and (plan.dp, plan.grad_accum) == (1, 2)
    state, step, make_batches = lenet_run(global_batch=ROWS, grad_accum=plan.grad_accum)
    with Checkpointer(tmp_path / "elastic_ckpt") as ckpt:
        state, start = ckpt.restore_latest(state)
    assert start == 2 and state.step == 2
    for name, p in state.params.items():
        assert torch.equal(p.detach(), ranks[0]["params"][name]), name
    batches = make_batches(start)
    state, metrics = step(state, next(batches), torch.Generator().manual_seed(0))
    batches.close()
    assert state.step == 3 and np.isfinite(metrics["loss"].item())
    assert all(torch.isfinite(p).all() for p in state.params.values())
