"""Port parity: the mesh module's arithmetic and the runtime bootstrap.

``MeshSpec.resolve``, ``data_axes``, ``layout_label``, ``local_batch_size``,
``plan_elastic_mesh``, ``plan_disagg_mesh`` and ``plan_serve_mesh`` are
held equal to the JAX package's over grids of inputs: the same results, or
the same ``ValueError`` message. The JAX meshes are built over conftest's 8
CPU devices; a port rank holds one mesh position, so its
``local_batch_size`` is the JAX package's per-device shard of the batch.
``initialize_runtime`` runs one process without cluster arguments or
markers and raises for a declared or detected cluster that cannot form
(a 2 s timeout; no group is left behind). Launching: ``cli.train`` under
torchrun (``python -m torch.distributed.run --nproc-per-node 2``) reads
the launcher's environment; a rank's card is ``LOCAL_RANK``, else its rank
modulo the card count; ``scripts/torch_mp_train.py --backend`` takes nccl
or gloo, defaults to ``initialize_runtime``'s choice and refuses any other
name.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import itertools
import math
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from distributed_tensorflow_tpu.parallel import mesh as jmesh
from distributed_tensorflow_tpu.serve.engine import plan_serve_mesh as jax_plan_serve_mesh
from distributed_tensorflow_tpu_torch.parallel import mesh as pmesh
from distributed_tensorflow_tpu_torch.serve import plan_serve_mesh

SPECS = [{"data": -1}, {"data": 2, "model": 4}, {"replica": 2, "data": -1},
         {"data": -1, "seq": 2}, {"expert": 2, "data": -1}, {"pipeline": 2, "data": 2},
         {"model": 2, "data": -1}, {"data": 2, "seq": 2, "model": 2}, {"data": 3},
         {"seq": -1, "data": 4}, {"data": 0}, {"data": -1, "model": -1}, {"bogus": 2}]


def _outcome(fn, *args, **kwargs):
    try:
        out = fn(*args, **kwargs)
    except ValueError as e:
        return ("raises", str(e))
    return ("ok", dataclasses.asdict(out) if dataclasses.is_dataclass(out) else out)


def _meshes():
    """(port mesh, JAX mesh) for every spec that resolves on 1, 2, 4 or 8
    devices."""
    for spec, n in itertools.product(SPECS, (1, 2, 4, 8)):
        try:
            sizes = jmesh.MeshSpec(spec).resolve(n)
        except ValueError:
            continue
        yield (pmesh.build_mesh(spec, world_size=n, rank=n - 1),
               jmesh.build_mesh(spec, devices=jax.devices()[:n]), sizes)


@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_mesh_spec_resolve_matches_jax(spec):
    for n in range(0, 10):
        want = _outcome(lambda: jmesh.MeshSpec(spec).resolve(n))
        assert _outcome(lambda: pmesh.MeshSpec(spec).resolve(n)) == want, n


def test_mesh_axes_labels_and_coords_match_jax():
    count = 0
    for port, ref, sizes in _meshes():
        count += 1
        assert port.axis_names == ref.axis_names
        assert dict(port.shape) == dict(ref.shape) == sizes
        assert pmesh.data_axes(port) == jmesh.data_axes(ref)
        assert pmesh.layout_label(port) == jmesh.layout_label(ref)
        # The last rank sits where the JAX mesh put the last device.
        last = jax.devices()[port.size - 1]
        at = {a: int(i) for a, i in zip(ref.axis_names, np.argwhere(ref.devices == last)[0])}
        assert port.coords == at
    assert count >= 20


@pytest.mark.parametrize("extra_axes", [(), ("expert",), ("seq", "model")], ids=str)
def test_local_batch_size_matches_jax(extra_axes):
    for port, ref, _ in _meshes():
        axes = jmesh.data_axes(ref) + tuple(a for a in extra_axes if a in ref.axis_names)
        shards = math.prod(ref.shape[a] for a in axes)
        for global_batch in (1, 2, 6, 8, 12, 16, 24):
            want = _outcome(jmesh.local_batch_size, global_batch, ref, extra_axes)
            if want[0] == "ok":  # one JAX process holds it all; a port rank its shard
                want = ("ok", want[1] // shards)
            assert _outcome(pmesh.local_batch_size, global_batch, port, extra_axes) == want


def test_process_rows_tile_the_global_batch():
    rows = [pmesh.process_rows(12, pmesh.build_mesh({"data": 2, "model": 2}, world_size=4,
                                                    rank=r)) for r in range(4)]
    assert rows == [(0, 6), (0, 6), (6, 12), (6, 12)]
    assert pmesh.process_rows(12) == (0, 12)  # one process holds it all


def test_plan_elastic_mesh_matches_jax():
    grid = itertools.product(list(range(0, 9)) + [[object()] * 6], (0, 1, 2, 3, 4, 8),
                             (0, 6, 8, 12, 24), (1, 2, 3), (0, 2, 4, 8))
    for surviving, tp, gb, ga, old_dp in grid:
        kw = dict(tp=tp, global_batch=gb, grad_accum=ga, old_dp=old_dp)
        assert (_outcome(pmesh.plan_elastic_mesh, surviving, **kw)
                == _outcome(jmesh.plan_elastic_mesh, surviving, **kw)), (surviving, kw)


def test_plan_disagg_mesh_matches_jax():
    grid = itertools.product(range(0, 9), (-1, 0, 1, 2, 3, 7, 8), (0, 1, 2, 3, 4), (1, 2, 4))
    for n, pre, pre_tp, dec_tp in grid:
        kw = dict(prefill_devices=pre, prefill_tp=pre_tp, decode_tp=dec_tp)
        assert (_outcome(pmesh.plan_disagg_mesh, n, **kw)
                == _outcome(jmesh.plan_disagg_mesh, n, **kw)), (n, kw)


def test_plan_serve_mesh_matches_jax():
    for tp, pp, ep, n in itertools.product((0, 1, 2, 3, 4), (1, 2), (1, 2), range(1, 9)):
        assert plan_serve_mesh(tp, pp, ep, n) == jax_plan_serve_mesh(tp, pp, ep, n)
    assert plan_serve_mesh(2) == plan_serve_mesh(2, n_devices=torch.cuda.device_count())


@pytest.fixture()
def no_cluster_env(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
                "COORDINATOR_ADDRESS", "MEGASCALE_COORDINATOR_ADDRESS",
                "TPU_WORKER_HOSTNAMES", "TPU_WORKER_ID", "SLURM_JOB_NUM_NODES",
                "OMPI_COMM_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert not dist.is_initialized()
    yield monkeypatch
    assert not dist.is_initialized()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_initialize_runtime_without_a_cluster_is_one_process(no_cluster_env):
    assert pmesh.initialize_runtime(device="cpu") == torch.device("cpu")
    assert pmesh.process_count() == 1 and pmesh.process_index() == 0
    assert pmesh.build_mesh().shape == {"data": 1}
    no_cluster_env.setenv("TPU_WORKER_HOSTNAMES", "localhost")  # one host: not a cluster
    no_cluster_env.setenv("WORLD_SIZE", "1")
    assert pmesh.initialize_runtime(device="cpu") == torch.device("cpu")


@pytest.mark.parametrize("process_id", [0, 1], ids=["coordinator", "peer"])
def test_initialize_runtime_raises_for_an_explicit_cluster_that_cannot_form(
        no_cluster_env, process_id):
    with pytest.raises(RuntimeError):  # torch's DistStoreError / DistNetworkError
        pmesh.initialize_runtime(f"127.0.0.1:{_free_port()}", 2, process_id,
                                 device="cpu", timeout_s=2)
    with pytest.raises(ValueError, match="needs coordinator_address, num_processes"):
        pmesh.initialize_runtime("127.0.0.1:1", 2, device="cpu")
    with pytest.raises(ValueError, match="host:port"):
        pmesh.initialize_runtime("127.0.0.1", 2, process_id, device="cpu")


def test_initialize_runtime_raises_for_a_detected_cluster_without_a_peer(no_cluster_env):
    no_cluster_env.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="RANK"):
        pmesh.initialize_runtime(device="cpu")
    for var, value in (("RANK", "1"), ("MASTER_ADDR", "127.0.0.1"),
                       ("MASTER_PORT", str(_free_port()))):
        no_cluster_env.setenv(var, value)
    with pytest.raises(RuntimeError):
        pmesh.initialize_runtime(device="cpu", timeout_s=2)


ROOT = Path(__file__).resolve().parents[1]


def test_cli_train_under_torchrun_reads_the_launchers_environment(tmp_path):
    """``cli.train --config mnist_lenet --device cpu`` as two processes of
    torchrun: each rank's group comes from the launcher's environment (no
    cluster flags), rank 0 logs the two-rank job and both ranks train."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
         "--master-addr", "127.0.0.1", "--master-port", str(_free_port()),
         "-m", "distributed_tensorflow_tpu_torch.cli.train", "--config", "mnist_lenet",
         "--device", "cpu", "--steps", "2", "--global-batch", "8", "--log-every", "1"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    log = proc.stdout + proc.stderr
    assert proc.returncode == 0, log[-4000:]
    groups = sorted(ln.split("process group: ", 1)[1] for ln in log.splitlines()
                    if "process group: " in ln)
    assert groups == [f"backend=gloo world=2 rank={r} device=cpu" for r in range(2)]
    assert "mesh={'data': 2} layout=dp2" in log
    assert len([ln for ln in log.splitlines() if "train.loop: step" in ln]) == 2


def test_rank_device_maps_local_rank_then_rank_modulo_cards(monkeypatch):
    """``device="cuda"`` is ``cuda:<LOCAL_RANK>`` under a launcher, else
    ``cuda:<rank % device_count>``; an indexed card or the CPU is kept."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert [pmesh._rank_device("cuda", r) for r in range(6)] == [
        torch.device("cuda", r % 4) for r in range(6)]
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert pmesh._rank_device("cuda", 0) == torch.device("cuda", 3)
    assert pmesh._rank_device("cuda:2", 0) == torch.device("cuda", 2)
    assert pmesh._rank_device("cpu", 5) == torch.device("cpu")


def _mp_train():
    spec = importlib.util.spec_from_file_location(
        "torch_mp_train", ROOT / "scripts" / "torch_mp_train.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_mp_train_backend_flag_defaults_and_refuses_unknown_names(capsys):
    """``--backend`` in every mode of ``scripts/torch_mp_train.py``: absent,
    the group's backend is ``initialize_runtime``'s default (None here);
    nccl or gloo is taken out of the CLI's arguments; another name exits
    2, as it does in the layouts' own parser."""
    mp = _mp_train()
    argv = ["--config", "bert_base", "--steps", "2"]
    assert mp.backend_flag(argv) is None and argv == ["--config", "bert_base", "--steps", "2"]
    for name in mp.BACKENDS:
        argv = ["--config", "bert_base", "--backend", name, "--steps", "2"]
        assert mp.backend_flag(argv) == name
        assert argv == ["--config", "bert_base", "--steps", "2"]
    with pytest.raises(SystemExit) as e:
        mp.backend_flag(["--backend", "mpi"])
    assert e.value.code == 2
    assert "invalid choice: 'mpi'" in capsys.readouterr().err
    with pytest.raises(SystemExit) as e:
        mp.main(["--world", "1", "--rank", "0", "--port", "1", "--out", "x",
                 "--backend", "ucc"])
    assert e.value.code == 2
    assert mp.BACKENDS == ("nccl", "gloo")
