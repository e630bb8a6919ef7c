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


@pytest.mark.parametrize("group,n", [("stage1", 3), ("all", 9)])
def test_cpu_check_runs_the_plain_versions(bench, capsys, group, n):
    assert bench.main(["--device=cpu", "--check", f"--shapes={group}", "--batch=1"]) == 0
    lines = _lines(capsys)
    checks = [ln for ln in lines if ln.get("check") == "numerics"]
    assert len(checks) == n
    assert all(c["max_abs_err_dw"] <= 1e-5 * c["range_dw"] for c in checks)
    assert lines[-1] == {"launches": {"pw_dgrad": 0, "pw_wgrad": 0},
                         "made": {"pw_dgrad": 0, "pw_wgrad": 0}}


def test_refuses_an_unknown_shape_group(bench, capsys):
    with pytest.raises(SystemExit):
        bench.main(["--device=cpu", "--shapes=stage5"])
    assert "invalid choice" in capsys.readouterr().err
