"""The train CLI's feed and observability flags, and ``POST /profilez``,
on the CPU.

- ``--metrics-jsonl`` writes one record a logged step (and one an eval)
  with the JAX CLI's keys for the same tiny run; ``--tb-dir`` writes a
  TensorBoard event file; ``--trace-dir`` a Chrome trace with the loop's
  ``host_wait``/``dispatch``/``device`` spans; ``--profile-dir
  --profile-steps 2`` a ``torch.profiler`` Chrome trace; without the
  ``tensorboard`` package ``--tb-dir`` is refused before anything runs.
- ``--device-pool 3``: the first three steps equal the streamed run's bit
  for bit (the step never writes into a batch the pool reuses), and a run
  resumed from its step-2 checkpoint equals the uninterrupted one.
- ``POST /profilez`` replies with the JAX server's keys, and 503 without a
  trace directory.

LeNet-5 at 28x28, 8 images a batch.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu_torch.cli import train as cli

RUN = ["--config=mnist_lenet", "--device=cpu", "--global-batch=8", "--log-every=1",
       "--lr-schedule=constant"]


def _records(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_metrics_jsonl_carries_the_jax_cli_keys(tmp_path):
    from distributed_tensorflow_tpu.cli.train import main as jax_main

    extra = ["--steps=2", "--eval-every=2", "--eval-batches=1"]
    assert cli.main(RUN + extra + [f"--metrics-jsonl={tmp_path / 'port.jsonl'}"]) == 0
    assert jax_main([a for a in RUN if not a.startswith("--device")] + extra
                    + [f"--metrics-jsonl={tmp_path / 'jax.jsonl'}"]) == 0
    got, want = _records(tmp_path / "port.jsonl"), _records(tmp_path / "jax.jsonl")
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2, 2]
    for g, w in zip(got, want):
        assert set(g) == set(w), (sorted(g), sorted(w))
    assert np.isfinite(got[0]["loss"]) and "eval_accuracy" in got[2]


def test_trace_profile_and_tensorboard_files(tmp_path):
    pytest.importorskip("tensorboard")
    assert cli.main(RUN + ["--steps=4", f"--trace-dir={tmp_path / 'trace'}",
                           f"--profile-dir={tmp_path / 'prof'}", "--profile-steps=2",
                           f"--tb-dir={tmp_path / 'tb'}", "--trace-buffer=64"]) == 0
    spans = json.loads((tmp_path / "trace" / "train_trace.json").read_text())["traceEvents"]
    names = {e["name"] for e in spans}
    assert {"host_wait", "dispatch", "device"} <= names
    assert sum(e["name"] == "dispatch" for e in spans) == 4
    (prof,) = (tmp_path / "prof").glob("*.pt.trace.json")
    events = json.loads(prof.read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert list((tmp_path / "tb").glob("events.out.tfevents.*"))


def test_tb_dir_is_refused_at_once_without_tensorboard(tmp_path, monkeypatch, capsys):
    import importlib.util

    find_spec = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "tensorboard" else find_spec(name, *a))
    with pytest.raises(SystemExit):
        cli.main(RUN + ["--steps=1", f"--tb-dir={tmp_path}"])
    assert "tensorboard package is not installed" in capsys.readouterr().err
    assert not any(tmp_path.iterdir())


def _state(ckpt_dir, step):
    blob = torch.load(ckpt_dir / f"step_{step:08d}.pt", weights_only=True)
    return blob["params"]


def _assert_params_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_device_pool_reuses_batches_safely_and_resumes(tmp_path):
    streamed, pooled, resumed = (tmp_path / d for d in ("streamed", "pooled", "resumed"))
    assert cli.main(RUN + ["--steps=3", f"--ckpt-dir={streamed}"]) == 0
    assert cli.main(RUN + ["--steps=5", "--device-pool=3", f"--ckpt-dir={pooled}",
                           "--ckpt-every=1"]) == 0
    # Steps 1-3 of the pool are stream positions 0-2, untouched by the steps.
    _assert_params_equal(_state(pooled, 3), _state(streamed, 3))
    assert cli.main(RUN + ["--steps=2", "--device-pool=3", f"--ckpt-dir={resumed}"]) == 0
    assert cli.main(RUN + ["--steps=5", "--device-pool=3", f"--ckpt-dir={resumed}"]) == 0
    _assert_params_equal(_state(resumed, 5), _state(pooled, 5))
    assert not torch.equal(_state(pooled, 5)["conv1.weight"], _state(pooled, 3)["conv1.weight"])


def _post(url):
    req = urllib.request.Request(url, data=b"", method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_profilez_replies_with_the_jax_keys(tmp_path):
    import threading

    from distributed_tensorflow_tpu_torch.models.bert import BertConfig, BertForPreTraining
    from distributed_tensorflow_tpu_torch.serve import (
        BatcherConfig,
        BertInferenceEngine,
        Client,
        build_http_server,
    )

    model = BertForPreTraining(BertConfig(vocab_size=32, hidden_size=16, num_layers=1,
                                          num_heads=2, intermediate_size=32,
                                          max_position=16), device="cpu")
    engine = BertInferenceEngine(model, dict(model.named_parameters()), "cpu",
                                 buckets=(16,), max_batch=1, batch_tiers=(1,))
    with Client(engine, BatcherConfig(max_batch=1, max_delay_ms=1.0)) as client:
        for trace_dir in (str(tmp_path), None):
            server = build_http_server(client, port=0, trace_dir=trace_dir)
            thread = threading.Thread(target=server.serve_forever, daemon=True)
            thread.start()
            try:
                url = "http://127.0.0.1:%d/profilez" % server.server_address[1]
                code, body = _post(url + "?ms=20")
                if trace_dir is None:
                    assert code == 503 and "trace_dir" in body["error"]
                    continue
                assert code == 200
                assert {"trace_dir", "requested_ms", "wall_ms"} <= set(body)
                assert body["requested_ms"] == 20.0 and body["wall_ms"] >= 20.0
                assert json.loads(open(body["path"]).read())["traceEvents"]
                assert _post(url + "?ms=x")[0] == 400
            finally:
                server.shutdown()
                server.server_close()
                thread.join(10)
