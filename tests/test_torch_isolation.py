"""The port stands alone: no JAX-side imports, and no silent CPU fallback."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "distributed_tensorflow_tpu"}


def _port_files():
    files = sorted((ROOT / "distributed_tensorflow_tpu_torch").rglob("*.py"))
    return files + sorted((ROOT / "scripts").glob("torch_*.py")) + [ROOT / "chip_smoke.py"]


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
    bad = [
        f"{f.relative_to(ROOT)}:{line} imports {root}"
        for f in files
        for line, root in _imported_roots(f)
        if root in FORBIDDEN
    ]
    assert not bad, bad


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
