"""Port parity: the image-training path against the JAX package.

The numpy batch stream (bit-identical, resume included), the
classification loss and eval metrics, and the SGD-momentum, SGD and Adam
updates against optax; the CLI's feed (the host C++ pipeline with the
preset's augmentation, and the numpy feed under ``--no-native-input``)
against the JAX CLI's ``_image_batches``; then the image CLI on the CPU
with a checkpoint and a resume that brings the BatchNorm statistics back,
its data-dir fallback, a failed host-library build, and its refusals. f32;
losses within 1e-6 and SGD updates within 1e-6 (the same f32 arithmetic in
another order), Adam within 1e-5 (torch applies the bias corrections in
another order than optax: about one rounding of each update of size lr),
the stream exactly.
"""

from __future__ import annotations

import dataclasses
import re

import jax
import numpy as np
import optax
import pytest
import torch

from distributed_tensorflow_tpu.data import loader as jloader
from distributed_tensorflow_tpu.models.lenet import LeNet5 as JLeNet5
from distributed_tensorflow_tpu.parallel.mesh import build_mesh
from distributed_tensorflow_tpu.train import objectives as jobj
from distributed_tensorflow_tpu_torch.cli import train as cli
from distributed_tensorflow_tpu_torch.data.loader import device_batches
from distributed_tensorflow_tpu_torch.data.readers import IMAGENET_MEAN, IMAGENET_STD
from distributed_tensorflow_tpu_torch.data.synthetic import (
    SyntheticClassification,
    synthetic_image_classification,
)
from distributed_tensorflow_tpu_torch.interop import resnet_params_from_flax
from distributed_tensorflow_tpu_torch.models import LeNet5
from distributed_tensorflow_tpu_torch.train.objectives import (
    init_model,
    make_classification_loss,
    make_classification_metrics,
)


def _u8_dataset():
    rng = np.random.default_rng(5)
    return SyntheticClassification(
        images=rng.integers(0, 256, (20, 10, 10, 3), dtype=np.uint8),
        labels=rng.integers(0, 10, 20).astype(np.int32))


@pytest.mark.parametrize("kind", ["synthetic", "u8_crop_normalize"])
def test_device_batches_stream_is_bit_identical(kind):
    """Batch k of both packages' numpy feeds holds the same bytes, across
    epoch boundaries (20 examples, 8 a batch: 2 batches an epoch) and from a
    resumed ``start_step``."""
    if kind == "synthetic":
        ds = synthetic_image_classification(20, (6, 6, 3), 10, seed=3)
        kw = {}
    else:
        ds = _u8_dataset()
        kw = {"out_size": (8, 8), "mean": IMAGENET_MEAN, "stddev": IMAGENET_STD}
    mesh = build_mesh({"data": 1}, devices=jax.devices()[:1])
    ref = jloader.device_batches(ds, mesh, 8, seed=4, **kw)
    want = [{k: np.asarray(v) for k, v in next(ref).items()} for _ in range(5)]
    got = device_batches(ds, 8, device="cpu", seed=4, **kw)
    resumed = device_batches(ds, 8, device="cpu", seed=4, start_step=3, **kw)
    for i, w in enumerate(want):
        b = next(got)
        assert b["image"].dtype == torch.float32 and b["label"].dtype == torch.int32
        for k in w:
            np.testing.assert_array_equal(b[k].numpy(), w[k])
        if i >= 3:
            r = next(resumed)
            for k in w:
                np.testing.assert_array_equal(r[k].numpy(), w[k])


def test_classification_loss_and_metrics_match_jax():
    rng = np.random.default_rng(2)
    img = rng.standard_normal((6, 28, 28, 1)).astype(np.float32)
    labels = rng.integers(0, 10, 6).astype(np.int32)
    jnet = JLeNet5()
    shapes = jax.eval_shape(lambda: jnet.init(jax.random.key(0), img))
    params = jax.tree.map(  # lecun-normal scale, as flax initialises LeNet
        lambda s: (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]) or 10)
                   ).astype(np.float32), shapes)
    batch = {"image": img, "label": labels}
    smooth = 0.1
    (jloss, (_, jm)), jgrads = jax.jit(jax.value_and_grad(
        jobj.make_classification_loss(jnet, label_smoothing=smooth), has_aux=True))(
        params["params"], {}, batch, jax.random.key(0))
    jeval = jobj.make_classification_metrics(jnet)(params["params"], {}, batch)

    model = LeNet5(device="cpu")
    model.load_state_dict(resnet_params_from_flax(params["params"])[0])
    p, state = init_model(model)
    assert state == {}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, (new_state, metrics) = make_classification_loss(model, label_smoothing=smooth)(
        p, state, tbatch, None)
    grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
    assert new_state is state
    assert abs(loss.item() - float(jloss)) <= 1e-6
    assert metrics["accuracy"].item() == float(jm["accuracy"])
    ref_grads, _ = resnet_params_from_flax(jax.tree.map(np.asarray, jgrads))
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref_grads[name].numpy(), atol=1e-6, rtol=1e-5)
    ev = make_classification_metrics(model)(p, state, tbatch)
    assert abs(ev["loss"].item() - float(jeval["loss"])) <= 1e-6
    assert ev["accuracy"].item() == float(jeval["accuracy"])


@pytest.mark.parametrize("optimizer,momentum,ref_tx,tol", [
    ("sgd", 0.9, optax.sgd(0.1, momentum=0.9), 1e-6),
    ("sgd", 0.0, optax.sgd(0.1), 1e-6),
    ("adam", 0.9, optax.adam(0.1), 1e-5),
])
def test_optimizers_match_optax(optimizer, momentum, ref_tx, tol):
    """Three updates from fixed gradients: the port's optimizer leaves the
    parameters where optax does (the momentum trace from the first step)."""
    rng = np.random.default_rng(9)
    params = {"w": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal(4).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    ref, opt = dict(params), ref_tx.init(params)
    for g in grads:
        updates, opt = ref_tx.update(g, opt, ref)
        ref = optax.apply_updates(ref, updates)
    cfg = dataclasses.replace(cli.PRESETS["cifar_resnet20"], optimizer=optimizer,
                              momentum=momentum, learning_rate=0.1, lr_schedule="constant")
    tx, _ = cli._make_tx(cfg)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    state = tx.init(tparams)
    for g in grads:
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        state.apply()
    for k, p in tparams.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(ref[k]), atol=tol, rtol=tol)


def test_image_cli_trains_checkpoints_and_resumes(tmp_path, caplog):
    from distributed_tensorflow_tpu_torch.ckpt import Checkpointer

    args = ["--config=cifar_resnet20", "--device=cpu", "--image-size=8", "--global-batch=8",
            "--log-every=1", f"--ckpt-dir={tmp_path}"]
    with caplog.at_level("INFO"):
        assert cli.main(args + ["--steps=2"]) == 0
    blob = torch.load(tmp_path / "step_00000002.pt", weights_only=True)
    stats = blob["model_state"]["batch_stats"]
    assert len(stats) == 2 * 21  # stem_bn, 2 per block, 2 proj_bn: mean and var each
    assert not torch.equal(stats["stem_bn.mean"], torch.zeros(16))

    caplog.clear()
    with caplog.at_level("INFO"):
        assert cli.main(args + ["--steps=3"]) == 0
    assert "restored checkpoint at step 2" in caplog.text
    assert "step 3:" in caplog.text and "step 1:" not in caplog.text
    model = cli.PRESETS["cifar_resnet20"].build(
        dataclasses.replace(cli.PRESETS["cifar_resnet20"], image_size=8))("cpu")
    from distributed_tensorflow_tpu_torch.train import create_train_state

    tx, _ = cli._make_tx(cli.PRESETS["cifar_resnet20"])
    state = create_train_state(model["params"], tx, model["model_state"])
    state, step = Checkpointer(tmp_path).restore_latest(state)
    assert step == 3
    saved = torch.load(tmp_path / "step_00000003.pt", weights_only=True)["model_state"]
    for k, v in saved["batch_stats"].items():
        assert torch.equal(state.model_state["batch_stats"][k], v)


def test_inception_async_preset_trains_stale_on_cpu(tmp_path, caplog, monkeypatch):
    """``--config imagenet_inception_async`` at 75x75 (no aux head below
    299x299), 4 images, 2 steps on the CPU: finite losses, and the saved
    state carries the K = 4 stale ring (every leaf's gradient 4 deep, the
    next slot 2) and the BatchNorm statistics. The preset's 8192 synthetic
    images are cut to 16 here (host memory), and nothing else."""
    from distributed_tensorflow_tpu_torch.data import readers

    preset = cli.PRESETS["imagenet_inception_async"]
    assert (preset.mode, preset.staleness, preset.momentum, preset.learning_rate) == (
        "stale", 4, 0.0, 0.05)
    load = readers.load_dataset
    asked = []

    def small(*args, fallback_examples, **kwargs):
        asked.append(fallback_examples)
        return load(*args, fallback_examples=16, **kwargs)

    monkeypatch.setattr(readers, "load_dataset", small)
    args = ["--config=imagenet_inception_async", "--device=cpu", "--image-size=75",
            "--global-batch=4", "--steps=2", "--log-every=1", f"--ckpt-dir={tmp_path}"]
    # One intra-op thread: as fast alone (~5 s), and under 15 s beside five
    # other test workers, where the default threads oversubscribed the
    # cores and the bf16 convolutions took 105 s.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with caplog.at_level("INFO"):
            assert cli.main(args) == 0
    finally:
        torch.set_num_threads(threads)
    assert asked == [8192]
    losses = [float(v) for v in re.findall(r"step \d+: .*?\bloss=(\S+)", caplog.text)]
    assert len(losses) == 2 and all(np.isfinite(losses))
    blob = torch.load(tmp_path / "step_00000002.pt", weights_only=True)
    ring = blob["grad_buffer"]
    assert blob["buffer_index"] == 2
    assert "head.weight" in ring and not any(k.startswith("aux.") for k in ring)
    assert all(v.shape[0] == 4 for v in ring.values())
    assert not torch.any(ring["head.weight"][2:]).item()  # slots 2-3 not written yet
    stats = blob["model_state"]["batch_stats"]
    assert "InceptionE_1.BasicConv_8.BatchNorm_0.mean" in stats


@pytest.mark.parametrize("argv,match", [
    (["--config=imagenet_resnet50", "--profile-steps=2"], "--profile-steps requires --profile-dir"),
    (["--config=cifar_resnet20", "--rng-impl=rbg"], "dropout draws from a torch.Generator"),
])
def test_image_cli_refusals(argv, match, capsys):
    with pytest.raises(SystemExit):
        cli.main(argv + ["--device=cpu"])
    assert match in capsys.readouterr().err


def _u8_store(n, hw, seed):
    rng = np.random.default_rng(seed)
    return SyntheticClassification(
        images=rng.integers(0, 256, (n, *hw, 3), dtype=np.uint8),
        labels=rng.integers(0, 10, n).astype(np.int32))


def test_cifar_preset_first_training_batch_equals_jax(monkeypatch):
    """The cifar_resnet20 preset's feed as the CLI builds it (host C++
    pipeline, pad-crop 4 + flip) against the JAX CLI's ``_image_batches``
    on the same u8 dataset and seed: the first two batches bit for bit."""
    from distributed_tensorflow_tpu.cli import train as jcli
    from distributed_tensorflow_tpu_torch.data import readers

    ds = _u8_store(24, (32, 32), seed=8)
    monkeypatch.setattr(readers, "load_dataset", lambda *a, **k: ds)
    cfg = dataclasses.replace(cli.PRESETS["cifar_resnet20"], global_batch=8)
    assert (cfg.augment, cfg.native_input) == ("cifar", True)
    got = cfg.build(cfg)("cpu")["batches"]()
    jcfg = dataclasses.replace(jcli.PRESETS["cifar_resnet20"], global_batch=8)
    mesh = build_mesh({"data": 1}, devices=jax.devices()[:1])
    want = jcli._image_batches(jcfg, ds, mesh, (32, 32), train=True, seed=1)
    for _ in range(2):
        g, w = next(got), next(want)
        for k in ("image", "label"):
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))
    got.close()
    want.close()


def test_no_native_input_batch_equals_jax_numpy_feed(monkeypatch):
    """``--no-native-input`` on the ImageNet preset: a 20x20 u8 store center
    cropped to 16x16 and normalised by the ImageNet mean/std, as the JAX
    CLI's numpy feed makes it."""
    from distributed_tensorflow_tpu.cli import train as jcli

    ds = _u8_store(20, (20, 20), seed=9)
    over = dict(global_batch=8, native_input=False)
    cfg = dataclasses.replace(cli.PRESETS["imagenet_resnet50"], **over)
    jcfg = dataclasses.replace(jcli.PRESETS["imagenet_resnet50"], **over)
    got = cli._image_batches(cfg, ds, "cpu", (16, 16), train=True, seed=1, start_step=1)
    mesh = build_mesh({"data": 1}, devices=jax.devices()[:1])
    want = jcli._image_batches(jcfg, ds, mesh, (16, 16), train=True, seed=1, start_step=1)
    for _ in range(2):
        g, w = next(got), next(want)
        for k in ("image", "label"):
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))


def test_image_cli_missing_data_dir_falls_back_with_warning(tmp_path, caplog):
    with caplog.at_level("WARNING"):
        assert cli.main(["--config=mnist_lenet", "--device=cpu", "--global-batch=8",
                         "--steps=1", f"--data-dir={tmp_path / 'nonexistent'}"]) == 0
    assert "FALLING BACK TO SYNTHETIC DATA" in caplog.text


def test_failed_host_library_build_raises_unless_numpy_feed(tmp_path, monkeypatch):
    """No silent fallback: a compiler that fails makes the run raise with
    its output; ``--no-native-input`` trains through the numpy feed."""
    from distributed_tensorflow_tpu_torch.ops import build

    cxx = tmp_path / "broken-cxx"
    cxx.write_text("#!/bin/sh\necho 'broken-cxx: cannot compile' >&2\nexit 1\n")
    cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    monkeypatch.setattr(build, "HOST_BUILD_DIR", tmp_path / "host")
    monkeypatch.delitem(build._LIBS, "data_pipeline", raising=False)
    argv = ["--config=mnist_lenet", "--device=cpu", "--global-batch=8", "--steps=1"]
    with pytest.raises(RuntimeError, match="broken-cxx: cannot compile"):
        cli.main(argv)
    assert cli.main(argv + ["--no-native-input"]) == 0
