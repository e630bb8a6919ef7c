"""Port parity for BERT serving: the PyTorch engine against the JAX engine.

Both engines serve the same tiny fp32 BERT (params converted by
``interop``) on the same payloads; ``pred_ids`` must be equal, the score,
embedding and NSP probabilities within 1e-5 (f32 math in different
orders). The batcher, HTTP and CLI cases run the port alone, on the CPU.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.models.bert import (
    BertConfig as JaxBertConfig,
    BertForPreTraining as JaxBert,
)
from distributed_tensorflow_tpu.serve import BertInferenceEngine as JaxEngine
from distributed_tensorflow_tpu_torch import ckpt
from distributed_tensorflow_tpu_torch.interop import bert_params_from_flax
from distributed_tensorflow_tpu_torch.models.bert import BertConfig, BertForPreTraining
from distributed_tensorflow_tpu_torch.obs.memory import MemoryRegistry
from distributed_tensorflow_tpu_torch.obs.metrics import ServeMetrics
from distributed_tensorflow_tpu_torch.serve import (
    Backpressure,
    BatcherConfig,
    BertInferenceEngine,
    Client,
    DynamicBatcher,
    RequestError,
    build_http_server,
)

GEOM = dict(vocab_size=64, hidden_size=32, num_layers=1, num_heads=2,
            intermediate_size=64, max_position=32)
ENGINE_KW = dict(buckets=(16, 32, 64), max_batch=4, batch_tiers=(2, 4))


@pytest.fixture(scope="module")
def flax_params():
    variables = jax.jit(JaxBert(JaxBertConfig(**GEOM)).init)(
        jax.random.key(0),
        jnp.zeros((1, 8), jnp.int32),
        jnp.ones((1, 8), bool),
        jnp.zeros((1, 8), jnp.int32),
    )
    return jax.tree.map(np.asarray, variables["params"])


def _torch_engine(flax_params, **kw):
    model = BertForPreTraining(BertConfig(**GEOM), device="cpu")
    return BertInferenceEngine(
        model, bert_params_from_flax(flax_params), "cpu",
        memory=kw.pop("memory", MemoryRegistry()), **{**ENGINE_KW, **kw},
    )


@pytest.fixture(scope="module")
def engine(flax_params):
    return _torch_engine(flax_params)


def _payloads(seed, lengths, targets=True):
    rng = np.random.default_rng(seed)
    out = []
    for i, n in enumerate(lengths):
        ids = rng.integers(5, GEOM["vocab_size"], size=n)
        p = {"input_ids": ids}
        if targets and i % 2 == 0:
            tgt = np.full(n, -1)
            tgt[::3] = ids[::3]
            p["mlm_targets"] = tgt
        out.append(p)
    return out


def test_run_batch_matches_jax_engine(flax_params, engine):
    jax_engine = JaxEngine(JaxBert(JaxBertConfig(**GEOM)), flax_params, **ENGINE_KW)
    assert jax_engine.buckets == engine.buckets == (16, 32)
    assert jax_engine.batch_tiers == engine.batch_tiers == (2, 4)
    for lengths in ((3, 9, 14), (20, 31), (32,)):
        payloads = _payloads(len(lengths), lengths)
        ours, ref = engine.run_batch(payloads), jax_engine.run_batch(payloads)
        for a, b in zip(ours, ref):
            assert a["bucket"] == b["bucket"]
            np.testing.assert_array_equal(a["pred_ids"], b["pred_ids"])
            assert (a["score"] is None) == (b["score"] is None)
            if a["score"] is not None:
                np.testing.assert_allclose(a["score"], b["score"], rtol=1e-5)
            np.testing.assert_allclose(a["embedding"], b["embedding"], atol=1e-5)
            np.testing.assert_allclose(a["nsp_probs"], b["nsp_probs"], atol=1e-5)


def test_bucket_and_tier_selection(engine):
    assert engine.bucket_for(1) == 16
    assert engine.bucket_for(16) == 16
    assert engine.bucket_for(17) == 32
    with pytest.raises(RequestError, match="exceeds the largest bucket"):
        engine.bucket_for(33)
    assert [engine.tier_for(n) for n in (1, 2, 3, 4)] == [2, 2, 4, 4]
    with pytest.raises(ValueError, match="exceeds max_batch"):
        engine.tier_for(5)
    st = engine.grid_status()
    assert st["cells_total"] == st["cells_compiled"] == 4
    assert st["warm_fraction"] == 1.0


def test_validate_rejects_bad_payloads(engine):
    with pytest.raises(RequestError, match="non-empty"):
        engine.validate({"input_ids": []})
    with pytest.raises(RequestError, match="non-empty"):
        engine.validate({"input_ids": [[1, 2]]})
    with pytest.raises(RequestError, match="exceeds"):
        engine.validate({"input_ids": list(range(40))})
    with pytest.raises(RequestError, match="mlm_targets"):
        engine.validate({"input_ids": [1, 2, 3], "mlm_targets": [1]})


def test_results_independent_of_batchmates(engine):
    ids = np.random.default_rng(1).integers(5, 64, size=12)
    solo = engine.run_batch([{"input_ids": ids, "mlm_targets": ids}])[0]
    crowd = engine.run_batch(
        [{"input_ids": ids, "mlm_targets": ids}] + _payloads(2, (9, 20, 5), False)
    )[0]
    assert crowd["bucket"] == 32 and solo["bucket"] == 16
    np.testing.assert_array_equal(solo["pred_ids"], crowd["pred_ids"])
    np.testing.assert_allclose(solo["score"], crowd["score"], rtol=1e-5)
    np.testing.assert_allclose(solo["embedding"], crowd["embedding"], atol=1e-5)


def test_return_logits_match_the_model(flax_params):
    eng = _torch_engine(flax_params, return_logits=True, batch_tiers=(4,))
    payloads = _payloads(4, (5, 11))
    results = eng.run_batch(payloads)
    ids = torch.zeros((2, 16), dtype=torch.int32)
    mask = torch.zeros((2, 16), dtype=torch.bool)
    for r, p in enumerate(payloads):
        ids[r, : len(p["input_ids"])] = torch.as_tensor(p["input_ids"])
        mask[r, : len(p["input_ids"])] = True
    with torch.inference_mode():
        logits, _, _ = eng.model.serve_outputs(ids, mask, torch.zeros_like(ids))
    for r, (p, res) in enumerate(zip(payloads, results)):
        n = len(p["input_ids"])
        assert res["mlm_logits"].shape == (n, GEOM["vocab_size"])
        np.testing.assert_allclose(res["mlm_logits"], logits[r, :n].numpy(), atol=1e-5)
        np.testing.assert_array_equal(res["pred_ids"], res["mlm_logits"].argmax(-1))


def test_engine_needs_cpu_asked_for(flax_params):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    model = BertForPreTraining(BertConfig(**GEOM), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BertInferenceEngine(model, bert_params_from_flax(flax_params))


# ----------------------------------------------------------------- batcher


def _echo(payloads):
    return [{"v": p} for p in payloads]


@pytest.mark.parametrize("mode", ["size", "deadline"])
def test_batcher_flushes(mode):
    sizes = []

    def run(payloads):
        sizes.append(len(payloads))
        return _echo(payloads)

    delay = 10_000.0 if mode == "size" else 30.0
    with DynamicBatcher(run, BatcherConfig(max_batch=4, max_delay_ms=delay)) as b:
        t0 = time.monotonic()
        n = 4 if mode == "size" else 1
        results = [f.result(timeout=5) for f in [b.submit(i) for i in range(n)]]
        elapsed = time.monotonic() - t0
    assert [r["v"] for r in results] == list(range(n))
    assert sizes == [n]
    if mode == "size":
        assert elapsed < 5.0
    else:
        assert elapsed >= 0.025


def test_batcher_backpressure_and_failure_isolation():
    release = threading.Event()

    def slow(payloads):
        release.wait(timeout=10)
        if payloads == ["boom"]:
            raise RuntimeError("engine exploded")
        return _echo(payloads)

    m = ServeMetrics()
    b = DynamicBatcher(
        slow, BatcherConfig(max_batch=1, max_delay_ms=0.0, max_queue=2), m
    )
    try:
        first = b.submit("boom")
        time.sleep(0.05)
        queued = [b.submit(i) for i in range(2)]
        with pytest.raises(Backpressure) as ei:
            b.submit("overflow")
        assert ei.value.retry_after_s > 0
        release.set()
        with pytest.raises(RuntimeError, match="exploded"):
            first.result(timeout=5)
        assert [f.result(timeout=5)["v"] for f in queued] == [0, 1]
        assert b.submit("again").result(timeout=5) == {"v": "again"}
    finally:
        release.set()
        b.close()
    assert m.rejected.value == 1 and m.errors.value == 1


def test_client_bucket_queues_over_engine(engine):
    with Client(engine, BatcherConfig(max_batch=4, max_delay_ms=2.0,
                                      bucket_queues=True)) as client:
        futs = [client.submit(p) for p in _payloads(3, (4, 20, 6, 30, 9, 12))]
        results = [f.result(timeout=30) for f in futs]
        with pytest.raises(RequestError):
            client.submit({"input_ids": []})
    assert [r["bucket"] for r in results] == [16, 32, 16, 32, 16, 16]
    snap = client.metrics.snapshot()
    assert snap["requests"] == 6 and snap["errors"] == 0
    assert set(snap["bucket_hits"]) <= {"16", "32"}


# -------------------------------------------------------------------- HTTP


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read().decode()


def _post(url, body: dict):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.status, json.loads(r.read())


def _prom_counters(text: str) -> dict:
    out = {}
    for line in text.splitlines():
        if line.startswith("#") or not line.strip():
            continue
        name, _, value = line.rpartition(" ")
        base = name.split("{")[0]
        if base.endswith(("_total", "_count", "_sum", "_bucket")):
            out[name] = float(value)
    return out


def test_http_round_trip(flax_params):
    memory = MemoryRegistry()
    client = Client(_torch_engine(flax_params, memory=memory),
                    BatcherConfig(max_batch=4, max_delay_ms=2.0))
    server = build_http_server(client, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = "http://{}:{}".format(*server.server_address)
    try:
        code, body = _get(base + "/healthz")
        assert code == 200 and json.loads(body)["status"] == "ready"
        _, prom1 = _get(base + "/metrics?format=prom")
        ids = list(range(5, 25))
        code, body = _post(base + "/v1/mlm", {"input_ids": ids, "mlm_targets": ids})
        assert code == 200 and body["bucket"] == 32
        assert len(body["pred_ids"]) == 20 and body["score"] < 0
        assert "embedding" not in body and "phases" in body
        code, body = _post(base + "/v1/embed", {"input_ids": [7, 8, 9]})
        assert code == 200 and len(body["embedding"]) == GEOM["hidden_size"]
        _, prom2 = _get(base + "/metrics?format=prom")
        c1, c2 = _prom_counters(prom1), _prom_counters(prom2)
        assert c2, "no counter families exported"
        for name, v in c1.items():
            assert c2.get(name, v) >= v, name
        assert c2['serve_requests_total'] == c1.get('serve_requests_total', 0) + 2
        memz = json.loads(_get(base + "/memz")[1])
        assert memz["components"]["bert_params"] > 0
        assert memz["devices"][0]["reported"] is False
        assert json.loads(_get(base + "/compilez")[1])["warm_fraction"] == 1.0
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base + "/v1/generate", {"input_ids": [1]})
        assert ei.value.code == 404
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base + "/v1/mlm", {"input_ids": []})
        assert ei.value.code == 400
        assert _post(base + "/drainz", {})[1]["draining"] is True
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(base + "/healthz")
        assert ei.value.code == 503
    finally:
        server.shutdown()
        server.server_close()
        client.close()
        thread.join(timeout=5)


# --------------------------------------------------------- checkpoint + CLI


def test_checkpoint_and_cli_selftest(tmp_path, flax_params, capsys):
    from distributed_tensorflow_tpu_torch.cli.serve import main

    with pytest.raises(FileNotFoundError):
        ckpt.restore_serving_state(tmp_path / "none")
    sd = bert_params_from_flax(flax_params)
    ckpt.save(tmp_path / "ck", 3, sd)
    ckpt.save(tmp_path / "ck", 7, sd)
    params, state, step = ckpt.restore_serving_state(
        tmp_path / "ck", weight_dtype="bfloat16"
    )
    assert step == 7 and state == {}
    assert params["mlm_bias"].dtype == torch.bfloat16
    # The bert_base preset (12 heads, bf16, max_position 128) at smoke width.
    model = BertForPreTraining(
        BertConfig(vocab_size=64, hidden_size=48, num_layers=1,
                   intermediate_size=192, max_position=128), device="cpu"
    )
    ckpt.save(tmp_path / "preset", 1, model.state_dict())
    flags = ["--config=bert_base", f"--ckpt-dir={tmp_path / 'preset'}",
             "--bert-layers=1", "--bert-hidden=48", "--bert-vocab=64"]
    assert main(flags + ["--device=cpu", "--buckets", "16", "32",
                         "--max-batch=2", "--selftest=3"]) == 0
    assert json.loads(capsys.readouterr().out)["requests"] == 3
    # Refused at argument time: a decode role on lm_base without the prefix
    # cache its adopted chains land in (JAX's check), and a KV dtype on a
    # preset that owns no KV cache.
    for bad in (["--config=lm_base", "--disagg-role=decode"], ["--kv-dtype=int8"]):
        argv = flags[1:] + bad if bad[0].startswith("--config") else flags + bad
        with pytest.raises(SystemExit) as ei:
            main(argv)
        assert ei.value.code == 2
