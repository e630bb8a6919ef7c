"""``scripts/torch_pw_bench.py`` on the CPU: its flags and the numerics check.

On the CPU the script runs the plain dgrad and wgrad only (no kernel, no
timing), so this covers the argument handling, the shape groups and the
``--check`` comparison against f32 references of the same bf16 inputs at
one image per shape (M = HW^2) in place of 128. The kernels' own check and
times come from the same script on the card (``chip_smoke.py`` runs it).
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import pytest

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "torch_pw_bench.py"


@pytest.fixture(scope="module")
def bench():
    spec = importlib.util.spec_from_file_location("torch_pw_bench", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _lines(capsys):
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]


def test_shape_groups_are_the_jax_scripts(bench):
    assert sum(len(v) for v in bench.SHAPES.values()) == 9
    assert bench.SHAPES["stage1"][0] == (128, 56, 256, 64)


@pytest.mark.parametrize("group,n", [("stage1", 3), ("all", 9), ("resnet50", 13)])
def test_cpu_check_runs_the_plain_versions(bench, capsys, group, n):
    assert bench.main(["--device=cpu", "--check", f"--shapes={group}", "--batch=1"]) == 0
    lines = _lines(capsys)
    checks = [ln for ln in lines if ln.get("check") == "numerics"]
    assert len(checks) == n
    assert all(c["max_abs_err_dw"] <= 1e-5 * c["range_dw"] for c in checks)
    assert lines[-1] == {"launches": {"pw_dgrad": 0, "pw_wgrad": 0},
                         "made": {"pw_dgrad": 0, "pw_wgrad": 0}}


def test_resnet50_table_is_one_training_step(bench):
    """29 units of the pw_dgrad route at 12 shapes and 2 of pw_dgrad_n64,
    every shape in [128, 4096] channels and M a multiple of 16 (the units
    that take the kernel)."""
    assert len(bench.RESNET50) == 12 and sum(bench.RESNET50.values()) == 29
    assert bench.RESNET50_N64 == {(128, 56, 256, 64): 2}
    for b, hw, k, n in bench.RESNET50:
        m, _, _ = bench.mkn(b, hw, k, n)
        assert m % 16 == 0 and 128 <= min(k, n) and max(k, n) <= 4096


def test_per_step_weights_each_shape_by_its_units(bench):
    """``per_step`` sums each dgrad row's times times its units a step, and
    keeps the graph times only when the rows have them."""
    rows = [{"kernel": "pw_dgrad", "M": m, "K": k, "N": n, "ms": 1.0, "library_ms": 0.5,
             "bound_ms": 0.25, "graph_ms": 0.75, "library_graph_ms": 0.5}
            for m, k, n in (bench.mkn(*sh) for sh in [*bench.RESNET50, *bench.RESNET50_N64])]
    rows.append({"kernel": "pw_wgrad", "M": 1, "K": 8, "N": 8, "ms": 99.0})
    step = bench.per_step(rows)
    assert step["pw_dgrad"] == {"ms": 29.0, "library_ms": 14.5, "graph_ms": 21.75,
                                "library_graph_ms": 14.5, "bound_ms": 7.25, "units": 29}
    assert step["pw_dgrad_n64"]["ms"] == 2.0 and step["pw_dgrad_n64"]["units"] == 2
    for r in rows:
        r.pop("graph_ms", None)
        r.pop("library_graph_ms", None)
    assert "graph_ms" not in bench.per_step(rows)["pw_dgrad"]


def test_refuses_an_unknown_shape_group(bench, capsys):
    with pytest.raises(SystemExit):
        bench.main(["--device=cpu", "--shapes=stage5"])
    assert "invalid choice" in capsys.readouterr().err
