"""The serve CLI's ``lm_base`` preset and decode flags on the CPU: the train
CLI writes a tiny ``lm_base`` checkpoint, then ``cli.serve`` serves it
through the continuous batcher with the prefix cache, chunked prefill,
speculation, EDF and preemption on, in-process (``--selftest``) and over
HTTP; the fleet-serving flags pass JAX's checks."""

from __future__ import annotations

import json
import logging
import threading
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

GEOM = ["--bert-layers=1", "--bert-hidden=48", "--bert-vocab=64"]
DECODE = ["--slots=3", "--prefix-cache-mb=0.05", "--block-tokens=4", "--prefill-chunk=8",
          "--spec-tokens=2", "--sched=edf", "--preempt"]


@pytest.fixture(scope="module")
def lm_ckpt(tmp_path_factory):
    from distributed_tensorflow_tpu_torch.cli.train import main

    ck = tmp_path_factory.mktemp("lm") / "ck"
    assert main(["--config=lm_base", "--device=cpu", *GEOM, "--steps=3",
                 "--global-batch=8", f"--ckpt-dir={ck}"]) == 0
    return ck


def test_selftest_serves_every_request_continuously(lm_ckpt, capsys, caplog):
    from distributed_tensorflow_tpu_torch.cli.serve import main

    with caplog.at_level(logging.INFO, logger="distributed_tensorflow_tpu_torch.cli.serve"):
        assert main(["--config=lm_base", "--device=cpu", f"--ckpt-dir={lm_ckpt}", *GEOM,
                     *DECODE, "--selftest=6"]) == 0
    snap = json.loads(capsys.readouterr().out)
    assert snap["requests"] == 6 and snap["errors"] == 0 and snap["tokens"] > 0
    line = next(r.getMessage() for r in caplog.records if "selftest ok" in r.getMessage())
    status = json.loads(line.split("batcher status ", 1)[1])
    assert status["mode"] == "continuous" and status["served"] == 6
    assert status["slots"] == 3 and status["slots_active"] == 0
    assert status["prefix_cache"]["lookups"] == 6
    assert status["speculation"]["spec_tokens"] == 2
    assert status["sched"]["policy"] == "edf" and status["sched"]["preempt"] is True


def test_generate_route_through_the_cli_client(lm_ckpt):
    """The CLI's client over HTTP: ``/v1/generate`` with a priority and a
    deadline, and the stream equals the engine's own greedy decode under
    flush admission (``--flush-admission``)."""
    from distributed_tensorflow_tpu_torch.cli.serve import (
        PRESETS,
        build_serving_client,
        make_parser,
    )
    from distributed_tensorflow_tpu_torch.serve import build_http_server

    streams = {}
    for flush in (False, True):
        argv = ["--config=lm_base", "--device=cpu", f"--ckpt-dir={lm_ckpt}", *GEOM, *DECODE,
                "--flight-buffer=0", "--trace-buffer=0"]
        if flush:
            argv = [a for a in argv if a not in ("--sched=edf", "--preempt")]
            argv.append("--flush-admission")
        client, _ = build_serving_client(PRESETS["lm_base"], make_parser().parse_args(argv))
        server = build_http_server(client, port=0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            req = urllib.request.Request(
                "http://{}:{}/v1/generate".format(*server.server_address),
                data=json.dumps({"input_ids": list(range(5, 20)), "max_new_tokens": 6,
                                 "priority": 0, "deadline_ms": 60000}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                body = json.loads(resp.read())
        finally:
            server.shutdown()
            server.server_close()
            client.close()
            thread.join(timeout=5)
        assert body["n_tokens"] == 6 and body["prompt_len"] == 15
        assert body["batching"]["mode"] == ("flush" if flush else "continuous")
        streams[flush] = body["tokens"]
    assert streams[False] == streams[True]


@pytest.mark.parametrize("flag", ["--disagg-role=decode", "--kv-transfer-budget-mb=8",
                                  "--stream-migrate", "--fault-plan=seed=1",
                                  "--fault-steps=10"])
def test_fleet_flags_are_refused(flag, capsys, tmp_path):
    """The fleet flags and the serving fault-injection flags are ported:
    each passes the argument checks (a decode role beside its prefix
    cache), and the run goes on to the (empty) checkpoint directory."""
    from distributed_tensorflow_tpu_torch.cli.serve import main

    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        main(["--config=lm_base", flag, "--prefix-cache-mb=0.05", f"--ckpt-dir={tmp_path}",
              "--device=cpu"])
    assert "Queue A item 7" not in capsys.readouterr().err


@pytest.mark.parametrize("argv,message", [
    (["--config=lm_base", "--disagg-role=decode"],
     "--disagg-role decode requires --prefix-cache-mb > 0"),
    (["--config=bert_base", "--stream-migrate"],
     "--stream-migrate applies to causal-LM (decode) presets only"),
], ids=["decode-without-prefix-cache", "stream-migrate-on-bert"])
def test_fleet_flags_keep_jaxs_checks(argv, message, capsys, tmp_path):
    """JAX's checks of the fleet flags: a decode role needs the prefix-cache
    pool its adopted chains land in, and migration needs a decode engine."""
    from distributed_tensorflow_tpu_torch.cli.serve import main

    with pytest.raises(SystemExit) as ei:
        main(argv + [f"--ckpt-dir={tmp_path}", "--device=cpu"])
    assert ei.value.code == 2
    assert message in capsys.readouterr().err


def test_global_batch_and_staleness_are_parsed_and_served(lm_ckpt, capsys):
    """The JAX serve CLI's ``--global-batch`` and ``--staleness`` (the
    training run's, for its restore template): parsed and checked, and the
    checkpoint serves with them (the restore reads the parameters only)."""
    from distributed_tensorflow_tpu_torch.cli.serve import main

    assert main(["--config=lm_base", "--device=cpu", f"--ckpt-dir={lm_ckpt}", *GEOM,
                 "--slots=3", "--global-batch=8", "--staleness=2", "--selftest=2"]) == 0
    assert json.loads(capsys.readouterr().out)["requests"] == 2


def test_payload_maker_fits_the_cache():
    """``--selftest``'s payloads: prompt + budget always fit the slot pages
    (lm_base's 128 positions cap the largest bucket + 32 new tokens)."""
    from distributed_tensorflow_tpu_torch.cli import serve

    captured = {}

    class _Engine:
        def __init__(self, *a, **kw):
            self.buckets, self.cache_len = (64, 128), 128
            captured["engine"] = self

    args = serve.make_parser().parse_args(["--config=lm_base", "--ckpt-dir=x", "--device=cpu"])
    restore = SimpleNamespace(restore_serving_state=lambda *a, **kw: ({}, {}, 0))
    import distributed_tensorflow_tpu_torch.ckpt as ckpt_mod
    import distributed_tensorflow_tpu_torch.serve as serve_mod

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(ckpt_mod, "restore_serving_state", restore.restore_serving_state)
        mp.setattr(serve_mod, "CausalLMEngine", _Engine)
        _, make_payload, _ = serve._build_engine(serve.PRESETS["lm_base"], args, None)
    finally:
        mp.undo()
    rng = np.random.default_rng(0)
    for _ in range(200):
        p = make_payload(rng)
        assert 4 <= len(p["input_ids"]) <= 128
        assert len(p["input_ids"]) + p["max_new_tokens"] <= 128
