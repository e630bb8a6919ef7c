"""Port parity and behaviour: multi-process data parallelism on the CPU.

Two gloo ranks, each a ``python tests/_torch_mp_worker.py`` process, the
ranks of a launch under one deadline (``TIMEOUT_S``, on a free localhost
port), against the JAX package on a ``{"data": 2}`` mesh of conftest's CPU
devices:

- the bucketed psum/pmean (one all-reduce a dtype) is bitwise the per-leaf
  reduction; ``all_gather_tree``, ``reduce_scatter_mean_tree``,
  ``ppermute_ring``, ``axis_index``/``axis_size``, ``replicate`` and
  ``shard_batch`` equal the JAX collectives exactly (data movement, and
  sums of two values, whose order does not matter);
- ``cli.train --config cifar_resnet20`` under ``--num-processes 2``, sync
  and ``--staleness 2``: the ranks end bitwise equal, and equal to the JAX
  step on the same interop-converted params and global batches (each
  rank's slice of the native augmenting feed, concatenated), BatchNorm
  statistics per shard as in JAX, within ``TOL`` (f32 convolutions and
  BatchNorm sums in another order, three SGD-momentum steps);
- rank 0 alone writes the checkpoint, both ranks restore it, and the
  resumed run equals the uninterrupted one bit for bit;
- dropout masks differ across ranks, and a restored rank redraws its own;
- a cluster that cannot form makes the CLI exit non-zero;
- the chaos proof (the JAX package's ``test_two_process_chaos_sigkill_resume``):
  two LeNet processes that share no process group, one SIGKILLed by its
  fault plan's ``host_drop``; its dump names the injected events, the
  beacons drive the ``FleetSupervisor`` to ``re_mesh``, and the resume from
  its last checkpoint (at most ``ckpt_every`` steps lost) under
  ``run_resilient`` with a further feeder fault equals an uninterrupted
  ``fit`` from the same checkpoint within 1e-6.
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from distributed_tensorflow_tpu.parallel import collectives as jcoll
from distributed_tensorflow_tpu.parallel.mesh import build_mesh as jax_build_mesh
from distributed_tensorflow_tpu_torch.cli import train as cli
from distributed_tensorflow_tpu_torch.interop import resnet_params_from_flax, resnet_params_to_flax

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).with_name("_torch_mp_worker.py")
TIMEOUT_S = 120
TOL = 1e-4
# A constant learning rate, so a 2-step run resumed to 3 steps follows the
# 3-step run's schedule.
CLI_ARGS = ["--config", "cifar_resnet20", "--image-size", "8", "--global-batch", "8",
            "--lr-schedule", "constant", "--log-every", "1"]


def _free_ports(n: int) -> list[int]:
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _env() -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = str(ROOT)
    return env


def _launch(out_dir: Path, job: str, n_groups: int = 1, argv=None, world: int = 2,
            codes: tuple[int, ...] | None = None) -> list:
    """Run ``job`` on ``world`` ranks under one deadline of ``TIMEOUT_S``
    for them all, each rank's output in files under ``out_dir`` (no pipe
    to fill). Every rank must exit 0, or ``codes[rank]`` when given.
    Returns the saved results of the ranks that exited 0 (None for the
    others)."""
    ports = ",".join(map(str, _free_ports(n_groups)))
    extra = [json.dumps(argv)] if argv is not None else []
    logs = [out_dir / f"{job}_rank{r}.log" for r in range(world)]
    procs = []
    try:
        for r, log in enumerate(logs):
            with open(log, "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, str(WORKER), job, str(r), str(world), str(out_dir), ports,
                     *extra], cwd=ROOT, env=_env(), stdout=f, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + TIMEOUT_S
        while any(p.poll() is None for p in procs):
            assert time.monotonic() < deadline, f"{job} passed {TIMEOUT_S} s"
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = codes or (0,) * world
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == codes[r], (
            f"{job} rank {r} exited {p.returncode}:\n{log.read_text()[-4000:]}")
    return [torch.load(out_dir / f"{job}_rank{r}.pt", weights_only=False)
            if codes[r] == 0 else None for r in range(world)]


def _assert_equal(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, f"{path}/{i}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    else:
        assert a == b, path


@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    return _launch(tmp_path_factory.mktemp("collectives"), "collectives")


def test_bucketed_mean_is_bitwise_the_per_leaf_mean(collectives):
    for out in collectives:
        _assert_equal(out["psum"], out["psum_per_leaf"])
        _assert_equal(out["pmean"], out["pmean_per_leaf"])
    _assert_equal(collectives[0]["pmean"], collectives[1]["pmean"])
    w = [out["tree"]["w"] for out in collectives]
    assert torch.equal(collectives[0]["pmean"]["w"], (w[0] + w[1]) / 2)


def test_collectives_match_jax_on_a_data2_mesh(collectives):
    mesh = jax_build_mesh({"data": 2}, devices=jax.devices()[:2])

    def per_device(x):
        x = x[0]
        out = {
            "gather0": jcoll.all_gather_tree(x, "data", axis=0),
            "gather1": jcoll.all_gather_tree(x, "data", axis=1),
            "stack0": jcoll.all_gather_tree(x, "data", axis=0, tiled=False),
            "scatter0": jcoll.reduce_scatter_mean_tree(x, "data", axis=0),
            "scatter1": jcoll.reduce_scatter_mean_tree(x, "data", axis=1),
            "ring": jcoll.ppermute_ring(x, "data"),
            "ring_back": jcoll.ppermute_ring(x, "data", shift=-1),
            "pmean": jcoll.pmean_tree(x, "data"),
            "psum": jcoll.psum_tree(x, "data"),
            "index": jcoll.axis_index("data"),
        }
        return {k: v[None] for k, v in out.items()}

    run = jax.jit(jax.shard_map(per_device, mesh=mesh, in_specs=P("data"),
                                out_specs=P("data"), check_vma=False))
    ref = jax.tree.map(np.asarray, run(np.stack([o["tree"]["w"].numpy() for o in collectives])))
    for r, out in enumerate(collectives):
        for key in ("gather0", "gather1", "stack0", "scatter0", "scatter1", "ring",
                    "ring_back"):
            np.testing.assert_array_equal(out[key].numpy(), ref[key][r], err_msg=key)
        np.testing.assert_array_equal(out["pmean"]["w"].numpy(), ref["pmean"][r])
        np.testing.assert_array_equal(out["psum"]["w"].numpy(), ref["psum"][r])
        assert out["index"] == int(ref["index"][r]) == r and out["size"] == 2
        _assert_equal(out["replicated"], collectives[0]["tree"])
        for k in ("image", "label"):
            assert torch.equal(out["shard"][k],
                               torch.arange(24.0).reshape(8, 3)[4 * r:4 * r + 4]
                               if k == "image" else torch.arange(8)[4 * r:4 * r + 4])


def test_dropout_masks_differ_across_ranks_and_resume_redraws(tmp_path):
    ranks = _launch(tmp_path, "dropout")
    for out in ranks:
        assert out["start"] == 1
        assert len(out["first"]) == 3 and len(out["again"]) == 3  # embeddings + 2 a layer
        _assert_equal(out["again"], out["first"])
        _assert_equal(out["resumed_params"], out["params"])
    assert all(not torch.equal(a, b) for a, b in zip(ranks[0]["first"], ranks[1]["first"]))
    _assert_equal(ranks[0]["params"], ranks[1]["params"])


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Per mode, the ranks' results: sync runs 3 steps, then 2 steps with a
    checkpoint and a resume to 3 in another directory; stale K = 2 runs 3."""
    out = {}
    for mode, extra, runs in (
        ("sync", [], [["--steps", "3", "--ckpt-dir", "{d}/whole"],
                      ["--steps", "2", "--ckpt-dir", "{d}/resumed"],
                      ["--steps", "3", "--ckpt-dir", "{d}/resumed"]]),
        ("stale2", ["--staleness", "2"], [["--steps", "3"]]),
    ):
        d = tmp_path_factory.mktemp(f"cli_{mode}")
        argv = [CLI_ARGS + extra + [a.format(d=d) for a in run] for run in runs]
        out[mode] = (d, _launch(d, "cli", n_groups=len(argv), argv=argv))
    return out


def _global_batches(pieces, world: int = 2):
    """The global batches of a ``world``-rank run: each rank's slice of the
    CLI's training feed, concatenated. The native pipeline draws a rank's
    augmentation from the start of its own slice, so one process's global
    stream is not the same batch."""
    from unittest import mock

    from distributed_tensorflow_tpu_torch.data import loader

    streams = []
    for r in range(world):
        def rows(global_batch, r=r):
            n = global_batch // world
            return r * n, (r + 1) * n

        with mock.patch.object(loader, "process_rows", rows):
            streams.append(pieces["batches"]())
    while True:
        parts = [next(it) for it in streams]
        yield {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def _jax_reference(mode: str, n_steps: int = 3):
    """The JAX package's step on a {"data": 2} mesh from the port CLI's
    initial params, over the port CLI's global batches."""
    from distributed_tensorflow_tpu.cli.train import PRESETS as JAX_PRESETS
    from distributed_tensorflow_tpu.cli.train import _make_tx as jax_make_tx
    from distributed_tensorflow_tpu.models.resnet import ResNet20 as JResNet20
    from distributed_tensorflow_tpu.train import create_train_state as j_create
    from distributed_tensorflow_tpu.train import make_train_step as j_step
    from distributed_tensorflow_tpu.train.objectives import make_classification_loss
    from distributed_tensorflow_tpu.train.step import place_state

    staleness = 2 if mode == "stale2" else 0
    over = dict(num_steps=n_steps, global_batch=8, image_size=8, lr_schedule="constant")
    pcfg = dataclasses.replace(cli.PRESETS["cifar_resnet20"], **over)
    pieces = pcfg.build(pcfg)("cpu")
    params, stats = resnet_params_to_flax(
        {k: v.detach() for k, v in pieces["params"].items()},
        pieces["model_state"]["batch_stats"])
    batches = _global_batches(pieces)
    jcfg = dataclasses.replace(JAX_PRESETS["cifar_resnet20"], num_steps=n_steps,
                               global_batch=8, lr_schedule="constant",
                               mode="stale" if staleness else "sync",
                               staleness=staleness)
    tx, _ = jax_make_tx(jcfg)
    mesh = jax_build_mesh({"data": 2}, devices=jax.devices()[:2])
    state = place_state(j_create(jax.tree.map(jnp.asarray, params), tx,
                                 {"batch_stats": jax.tree.map(jnp.asarray, stats)},
                                 staleness=staleness), mesh)
    step = j_step(make_classification_loss(JResNet20()), tx, mesh, mode=jcfg.mode,
                  staleness=staleness)
    for _ in range(n_steps):
        batch = {k: jnp.asarray(v.numpy()) for k, v in next(batches).items()}
        state, _ = step(state, batch, jax.random.key(0))
    return resnet_params_from_flax(jax.tree.map(np.asarray, state.params),
                                   jax.tree.map(np.asarray, state.model_state["batch_stats"]))


@pytest.mark.parametrize("mode", ["sync", "stale2"])
def test_cli_two_ranks_are_bitwise_equal_and_match_jax(cli_runs, mode):
    _, ranks = cli_runs[mode]
    first = [r["runs"][0] for r in ranks]
    for run in first:
        assert run["code"] == 0 and run["step"] == 3
    for key in ("params", "model_state", "grad_buffer", "buffer_index"):
        _assert_equal(first[0][key], first[1][key], key)
    if mode == "stale2":
        assert first[0]["buffer_index"] == 1 and len(first[0]["grad_buffer"]) > 0
    ref_params, ref_stats = _jax_reference(mode)
    for name, p in first[0]["params"].items():
        np.testing.assert_allclose(p.numpy(), ref_params[name].numpy(), atol=TOL, rtol=TOL,
                                   err_msg=name)
    for name, s in first[0]["model_state"]["batch_stats"].items():
        np.testing.assert_allclose(s.numpy(), ref_stats[name].numpy(), atol=TOL, rtol=TOL,
                                   err_msg=name)


def test_cli_checkpoint_is_written_by_rank0_and_resumes_on_both(cli_runs):
    d, ranks = cli_runs["sync"]
    assert [r["runs"][0]["writes"] for r in ranks] == [[3], []]
    assert [r["runs"][1]["writes"] for r in ranks] == [[2], []]
    assert [r["runs"][2]["writes"] for r in ranks] == [[3], []]
    assert sorted(p.name for p in (d / "resumed").iterdir()) == [
        "step_00000002.pt", "step_00000003.pt"]
    for r in ranks:
        whole, resumed = r["runs"][0], r["runs"][2]
        assert resumed["step"] == 3
        for key in ("params", "model_state"):
            _assert_equal(resumed[key], whole[key], key)


def test_cli_exits_nonzero_when_the_cluster_cannot_form(tmp_path):
    (port,) = _free_ports(1)
    proc = subprocess.run(
        [sys.executable, "-m", "distributed_tensorflow_tpu_torch.cli.train", *CLI_ARGS,
         "--device", "cpu", "--steps", "1", "--coordinator-address", f"127.0.0.1:{port}",
         "--num-processes", "2", "--process-id", "1", "--init-timeout", "2"],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=TIMEOUT_S)
    assert proc.returncode != 0
    assert "Traceback" in proc.stderr and "step 1:" not in proc.stderr


def test_two_process_chaos_sigkill_resume(tmp_path):
    """Rank 0's plan SIGKILLs it at step 11 (``host_drop``) after a
    ``slow_step`` at 5; rank 1 runs to 16. The victim's dump holds both
    injected events, the beacons (the dead host's stale, the survivor's
    fresh) drive the supervisor to ``re_mesh``, and the resume from the
    victim's last checkpoint (step 8: 3 steps lost, within ckpt_every=4)
    under ``run_resilient`` with a feeder fault equals an uninterrupted
    ``fit`` from the same checkpoint, step for step."""
    import shutil

    sys.path.insert(0, str(ROOT / "tests"))
    from _torch_mp_worker import CHAOS_CKPT_EVERY, CHAOS_STEPS, lenet_run

    from distributed_tensorflow_tpu_torch.ckpt import Checkpointer
    from distributed_tensorflow_tpu_torch.obs.fleet import FleetSupervisor, read_beacons
    from distributed_tensorflow_tpu_torch.obs.flightrec import FlightRecorder
    from distributed_tensorflow_tpu_torch.train import (
        FaultEvent,
        FaultInjector,
        FaultPlan,
        ResilienceConfig,
        fit,
        run_resilient,
    )

    _, survivor = _launch(tmp_path, "chaos", codes=(-9, 0))
    assert survivor == {"step": 16, "latest_ckpt": 16, "last_step": 16}
    (dump,) = (tmp_path / "dumps_0").glob("flightrec-*.json")
    payload = json.loads(dump.read_text())
    assert payload["reason"] == "host_drop"
    assert [e["fault"] for e in payload["events"] if e["kind"] == "fault_injected"] == [
        "slow_step", "host_drop"]

    beacons = {b["host"]: b for b in read_beacons(tmp_path / "beacons")}
    assert set(beacons) == {0, 1}
    assert beacons[0]["injected_faults"] == {"slow_step": 1}
    t_dead, t_alive = beacons[0]["wall_time"], beacons[1]["wall_time"]
    assert t_alive > t_dead
    now = t_alive + 1e-3
    verdict = FleetSupervisor(tmp_path / "beacons", expected_hosts=2,
                              heartbeat_timeout_s=0.5 * (now - t_dead),
                              clock=lambda: now).poll()
    assert verdict["action"] == "re_mesh"
    assert verdict["lost_hosts"] == [0] and verdict["alive_hosts"] == [1]

    # B: plain fit from the victim's last durable checkpoint, no faults.
    losses_b = {}
    state_b, step, make_batches = lenet_run()
    with Checkpointer(tmp_path / "ckpt_0") as ck:
        state_b, start = ck.restore_latest(state_b)
    assert start == 8 and 11 - start <= CHAOS_CKPT_EVERY
    batches = make_batches(start)
    state_b, _ = fit(state_b, step, batches, num_steps=CHAOS_STEPS,
                     rng=torch.Generator().manual_seed(0), log_every=1,
                     hooks=(lambda s, st, m: losses_b.__setitem__(s, m["loss"]),))
    batches.close()

    # A: run_resilient from a copy of it, with a feeder fault mid-resume.
    shutil.copytree(tmp_path / "ckpt_0", tmp_path / "ckpt_A")
    rec = FlightRecorder(dump_dir=None)
    inj = FaultInjector(FaultPlan((FaultEvent("feeder_error", 2),)), recorder=rec)
    losses_a = {}  # replayed steps overwrite
    state_a, step_a, make_batches_a = lenet_run()
    with Checkpointer(tmp_path / "ckpt_A") as ck_a:
        state_a, start_a = ck_a.restore_latest(state_a)
        assert start_a == 8
        report = run_resilient(
            state_a, step_a, lambda s: make_batches_a(s, inj), num_steps=CHAOS_STEPS,
            checkpointer=ck_a, ckpt_every=CHAOS_CKPT_EVERY,
            config=ResilienceConfig(sleep=lambda s: None), recorder=rec, fault_injector=inj,
            rng=torch.Generator().manual_seed(0), log_every=1,
            hooks=(lambda s, st, m: losses_a.__setitem__(s, m["loss"]),))
    assert report.completed and report.final_step == 16 and report.restarts == 1
    kinds = [e["kind"] for e in rec.dump("chaos_resume_end", force=True)["events"]]
    assert "fault_injected" in kinds and "train_restart" in kinds
    assert set(losses_a) == set(losses_b) == set(range(9, 17))
    np.testing.assert_allclose([losses_a[s] for s in range(9, 17)],
                               [losses_b[s] for s in range(9, 17)], atol=1e-6)
    for name, p in report.state.params.items():
        np.testing.assert_allclose(p.detach().numpy(), state_b.params[name].detach().numpy(),
                                   atol=1e-6, err_msg=name)
