"""The port stands alone: no JAX-side imports, no use of the JAX package's
native directory or its library (the port builds its own host library from
``csrc/`` into ``build/``), and no silent CPU fallback."""

from __future__ import annotations

import ast
import re
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "distributed_tensorflow_tpu"}


def _port_files():
    files = sorted((ROOT / "distributed_tensorflow_tpu_torch").rglob("*.py"))
    return files + sorted((ROOT / "scripts").glob("torch_*.py")) + [ROOT / "chip_smoke.py"]


# The resilient-training slice's pure-Python modules: the port's own copies.
RESILIENCE_MODULES = ("train/faultinject.py", "train/resilience.py", "obs/fleet.py",
                      "serve/faultinject.py")
# The model-parallel slices' modules: the mesh's process groups, the
# differentiable collectives, the ring, Ulysses, mixture-of-experts
# dispatch, the GPipe schedule, the sharded BERT.
MODEL_PARALLEL_MODULES = ("parallel/mesh.py", "parallel/collectives.py",
                          "parallel/ring_attention.py", "parallel/ulysses.py",
                          "parallel/moe.py", "parallel/pipeline.py",
                          "models/bert.py", "interop.py")
# The serving-layout slice's modules: the leader/follower serving group,
# the engines over it, the causal LM's tensor parallelism.
SERVING_GROUP_MODULES = ("serve/group.py", "serve/engine.py", "models/causal_lm.py")
# The fleet-serving slice's module: the KV wire v1-v4, the transfer budget,
# the prefill/decode pair, the stream receiver and the migrator.
FLEET_MODULES = ("serve/disagg.py",)
# The router's and the analysis suite's modules: the fleet front door, its
# CLI, and the static checkers with their finding model.
ROUTER_ANALYSIS_MODULES = ("serve/router.py", "cli/router.py", "analysis/__init__.py",
                           "analysis/findings.py", "analysis/locklint.py",
                           "analysis/racelint.py", "analysis/shardcheck.py")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module.split(".")[0]
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "attr", getattr(node.func, "id", "")) == "import_module"
            and node.args
            and isinstance(node.args[0], ast.Constant)
        ):
            yield node.lineno, str(node.args[0].value).split(".")[0]


def test_port_imports_nothing_of_jax():
    files = _port_files()
    assert len(files) > 20 and all(f.exists() for f in files)
    for name in ("distributed_tensorflow_tpu_torch/models/inception.py",
                 "distributed_tensorflow_tpu_torch/models/flops.py",
                 "scripts/torch_pw_bench.py", "scripts/torch_analyze.py",
                 *(f"distributed_tensorflow_tpu_torch/{m}"
                   for m in RESILIENCE_MODULES + MODEL_PARALLEL_MODULES
                   + SERVING_GROUP_MODULES + FLEET_MODULES + ROUTER_ANALYSIS_MODULES)):
        assert ROOT / name in files
    # The multi-process worker (its chaos job included) and the router's
    # stub replica run torch and the port only.
    files = files + [ROOT / "tests" / "_torch_mp_worker.py",
                     ROOT / "tests" / "_torch_router_replica.py"]
    bad = [
        f"{f.relative_to(ROOT)}:{line} imports {root}"
        for f in files
        for line, root in _imported_roots(f)
        if root in FORBIDDEN
    ]
    assert not bad, bad


def test_port_never_touches_the_jax_native_directory():
    """No port file, ``scripts/torch_*.py`` or ``chip_smoke.py`` names the
    ``native/`` directory or ``libdata_pipeline.so``, and the host library
    builds and loads from under ``build/``."""
    pattern = re.compile(r"(?<![\w.])native/|libdata_pipeline\.so")
    files = _port_files() + sorted(
        (ROOT / "distributed_tensorflow_tpu_torch" / "csrc").glob("*.c*"))
    assert ROOT / "distributed_tensorflow_tpu_torch" / "csrc" / "data_pipeline.cpp" in files
    bad = [
        f"{f.relative_to(ROOT)}:{i}: {line.strip()}"
        for f in files
        for i, line in enumerate(f.read_text().splitlines(), 1)
        if pattern.search(line)
    ]
    assert not bad, bad
    from distributed_tensorflow_tpu_torch.data import native
    from distributed_tensorflow_tpu_torch.ops import build

    native.load_library()
    path = Path(build.BUILD_INFO["data_pipeline"]["path"]).resolve()
    assert path.parent == (ROOT / "build" / "host").resolve()
    assert path.name.startswith("libdata_pipeline-") and path.exists()


def test_serving_host_modules_import_without_jax():
    """The prefix-cache trie, the speculation state machine, the
    sanitizers, the resilience modules (fault injection, fleet health,
    ``run_resilient``) and the model-parallel ones (process groups,
    collectives, ring and Ulysses attention, MoE dispatch, the GPipe
    schedule) and the serving group's (the leader/follower protocol, the
    engines over it, the causal LM's TP), fleet serving's (the KV wire,
    disaggregation and migration), the router's and the analysis suite's
    are the port's own copies:
    importing them in a fresh interpreter leaves ``jax`` out of
    ``sys.modules``."""
    import subprocess
    import sys

    modules = ["serve/kvpool.py", "serve/spec.py", "obs/sanitizer.py", *RESILIENCE_MODULES,
               *MODEL_PARALLEL_MODULES, *SERVING_GROUP_MODULES, *FLEET_MODULES,
               *ROUTER_ANALYSIS_MODULES]
    # Measured against what the interpreter held before the imports, in
    # case a site hook loads a package at startup.
    code = ("import sys\n"
            "before = set(sys.modules)\n"
            + "".join(f"import distributed_tensorflow_tpu_torch.{m[:-3].replace('/', '.')}\n"
                      for m in modules)
            + "bad = sorted(m for m in set(sys.modules) - before if m.split('.')[0] in "
            f"{sorted(FORBIDDEN)!r})\n"
            "assert not bad, bad\n"
            "assert 'jax' not in sys.modules or 'jax' in before\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.fixture()
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")


def test_entry_points_default_to_the_card(no_cuda, tmp_path):
    from distributed_tensorflow_tpu_torch import ckpt
    from distributed_tensorflow_tpu_torch.cli.serve import main
    from distributed_tensorflow_tpu_torch.device import resolve_device
    from distributed_tensorflow_tpu_torch.models.bert import (
        BertConfig,
        BertForPreTraining,
    )

    cfg = BertConfig(vocab_size=32, hidden_size=24, num_layers=1,
                     intermediate_size=96, max_position=128)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BertForPreTraining(cfg)
    ckpt.save(tmp_path, 0, BertForPreTraining(cfg, device="cpu").state_dict())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--config=bert_base", f"--ckpt-dir={tmp_path}", "--bert-layers=1",
              "--bert-hidden=24", "--bert-vocab=32", "--selftest=1"])
    from distributed_tensorflow_tpu_torch.cli.train import main as train_main
    from distributed_tensorflow_tpu_torch.train import make_rng

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_rng(0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_main(["--config=bert_base", "--bert-layers=1", "--bert-hidden=24",
                    "--bert-vocab=32", "--steps=1"])
    from distributed_tensorflow_tpu_torch.data.loader import device_batches
    from distributed_tensorflow_tpu_torch.data.synthetic import synthetic_image_classification
    from distributed_tensorflow_tpu_torch.models import InceptionV3, LeNet5, ResNet20, ResNet50

    for model in (LeNet5, ResNet20, ResNet50, InceptionV3):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            model()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        next(device_batches(synthetic_image_classification(4, (2, 2, 1), 2), 2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_main(["--config=cifar_resnet20", "--image-size=8", "--global-batch=8",
                    "--steps=1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_main(["--config=imagenet_inception_async", "--image-size=75",
                    "--global-batch=4", "--steps=1"])
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_pw_bench", ROOT / "scripts" / "torch_pw_bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(["--shapes=stage1"])
