"""The port's ``ContinuousBatcher`` (serve/batcher.py): scheduling, parity
with the JAX package's batcher, the prefix cache and ``/v1/generate``.

Mirrors the JAX package's ``tests/test_serve_decode.py``. Scheduling runs on
a pure-Python stub engine whose token stream is a closed-form function of
(prompt, position): slot reuse, EOS, continuous versus flush admission,
``close(drain=False)``, a failing dispatch and the race soaks pin the slot
table with no engine compute. Parity runs on the tiny real engine pair of
``tests/_torch_serve_common.py``: the same requests submitted in the same
order to the JAX batcher over the JAX engine and to the port's batcher over
the port's engine give equal token streams, exactly (greedy and
seeded-sampled rows; sampling is keyed on (seed, absolute position), so a
stream does not depend on its batchmates). The speculative mode's parity is
in ``tests/test_torch_serve_spec.py``, on prompts where speculation engages.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
from _torch_serve_common import CHUNKED, jax_engine, port_engine, ref_greedy, run_batcher

from distributed_tensorflow_tpu.serve import BatcherConfig as JaxBatcherConfig
from distributed_tensorflow_tpu.serve import ContinuousBatcher as JaxBatcher
from distributed_tensorflow_tpu_torch.obs.metrics import ServeMetrics
from distributed_tensorflow_tpu_torch.obs.sanitizer import sanitize_races
from distributed_tensorflow_tpu_torch.serve import batcher as batcher_mod
from distributed_tensorflow_tpu_torch.serve import kvpool as kvpool_mod
from distributed_tensorflow_tpu_torch.serve import (
    BatcherConfig,
    Client,
    ContinuousBatcher,
    build_http_server,
)
from distributed_tensorflow_tpu_torch.serve.batcher import StreamState

# ------------------------------------------------- scheduling (stub engine)


class _StubDecodeEngine:
    """Closed-form decode engine: token k of a request is a pure function
    of (prompt, k), so any scheduling (solo, joined mid-flight, after slot
    reuse) must deliver the same stream."""

    def __init__(self, slots=3, max_batch=2, max_new_tokens=8, step_delay_s=0.0):
        self.slots = slots
        self.max_batch = max_batch
        self.max_new_tokens = max_new_tokens
        self.step_delay_s = step_delay_s
        self.lock = threading.Lock()
        self._state = {}    # slot -> (prompt_sum, steps_taken); never cleared
        self.prefills = []  # admitted slot ids, in dispatch order
        self.events = []    # ("prefill"/"chunk"/"decode", slot ids)

    @staticmethod
    def token(prompt_sum, k):
        return (prompt_sum + 7 * k) % 50 + 5

    def validate(self, payload):
        pass

    def bucket_for(self, n):
        return 8 if n <= 8 else 16

    def prefill(self, admissions):
        with self.lock:
            toks = {}
            for a in admissions:
                psum = int(np.sum(a["input_ids"]))
                self._state[a["slot"]] = (psum, 1)
                self.prefills.append(a["slot"])
                toks[a["slot"]] = self.token(psum, 0)
            self.events.append(("prefill", tuple(a["slot"] for a in admissions)))
        return ("prefill", [toks[a["slot"]] for a in admissions])

    def decode(self, lengths, active, temps, seeds):
        with self.lock:
            toks = np.zeros(self.slots, np.int64)
            live = []
            for slot, is_active in enumerate(active):
                if not is_active or slot not in self._state:
                    continue
                psum, k = self._state[slot]
                toks[slot] = self.token(psum, k)
                self._state[slot] = (psum, k + 1)
                live.append(slot)
            self.events.append(("decode", tuple(live)))
        return ("decode", toks)

    def fetch_step(self, handle):
        if self.step_delay_s:
            time.sleep(self.step_delay_s)
        return np.asarray(handle[1])


class _StubChunkedEngine(_StubDecodeEngine):
    """Chunked twin: ``prefill_chunks`` and a real ``KVBlockPool``, so the
    batcher walks the trie/pin/insert path with no device work."""

    def __init__(self, pool, chunk=4, **kw):
        super().__init__(**kw)
        self.prefill_chunk_size = chunk
        self.prefix_cache = pool
        self.inserted = []

    def prefill_chunks(self, rows):
        with self.lock:
            toks = []
            for r in rows:
                if int(r["start"]) + int(r["n_tokens"]) >= int(r["length"]):
                    psum = int(np.sum(r["input_ids"]))
                    self._state[int(r["slot"])] = (psum, 1)
                    toks.append(self.token(psum, 0))
                else:
                    toks.append(0)  # mid-prompt lane: nobody reads it
            self.events.append(("chunk", tuple(int(r["slot"]) for r in rows)))
        return ("chunk", toks)

    def insert_prefix(self, slot, new_blocks):
        self.inserted.append((slot, tuple(new_blocks)))


def _expected(prompt, n):
    psum = int(np.sum(prompt))
    return [_StubDecodeEngine.token(psum, k) for k in range(n)]


def _wait(cond, msg, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {msg}"
        time.sleep(0.002)


def test_slot_free_and_reuse():
    """5 requests through 2 slots: every stream correct, occupancy never
    above the table, freed slots reused."""
    eng = _StubDecodeEngine(slots=2, max_batch=2)
    reqs = [{"input_ids": np.arange(1, 4 + i), "max_new_tokens": 3 + (i % 3)}
            for i in range(5)]
    with ContinuousBatcher(eng, BatcherConfig(max_batch=2)) as b:
        futs = [b.submit(dict(r)) for r in reqs]
        results = [f.result(timeout=30) for f in futs]
        _wait(lambda: b.status()["slots_active"] == 0, "the table to drain")
        st = b.status()
        assert st["slots"] == 2 and st["slots_active"] == 0
    for r, req in zip(results, reqs):
        assert r["tokens"] == _expected(req["input_ids"], req["max_new_tokens"])
    assert max((len(s) for kind, s in eng.events if kind == "decode"), default=0) <= 2
    assert len(eng.prefills) == 5 and max(eng.prefills) <= 1
    assert max(eng.prefills.count(s) for s in set(eng.prefills)) >= 2


def test_eos_frees_slot_early():
    """EOS frees the slot at once; the next request takes it while a step
    dispatched for the finished occupant is still in flight (two steps in
    flight, slow fetches), and the generation tag keeps that stale token
    out of the new occupant's stream."""
    eng = _StubDecodeEngine(slots=1, max_batch=1, step_delay_s=0.01)
    prompt, other = np.arange(1, 5), np.arange(3, 9)
    toks = _expected(prompt, 8)
    with ContinuousBatcher(eng, BatcherConfig(max_batch=1, max_in_flight=2)) as b:
        first = b.submit({"input_ids": prompt, "max_new_tokens": 8, "eos_id": toks[2]})
        second = b.submit({"input_ids": other, "max_new_tokens": 4})
        r, r2 = first.result(timeout=30), second.result(timeout=30)
    assert r["tokens"] == toks[:3] and r["n_tokens"] == 3
    assert r2["tokens"] == _expected(other, 4)
    # A step for the first request was dispatched after its EOS step.
    assert sum(1 for kind, s in eng.events if kind == "decode" and s) > 2 + 3


@pytest.mark.parametrize("admission", ["continuous", "flush"])
def test_admission_modes(admission):
    """Continuous: a request arriving while the table is busy joins the
    in-flight batch (some decode step carries both). Flush: every admission
    happens against an EMPTY table (each ran solo, static-batch style)."""
    eng = _StubDecodeEngine(slots=2, max_batch=2, step_delay_s=0.01)
    with ContinuousBatcher(eng, BatcherConfig(max_batch=2, max_in_flight=1),
                           admission=admission) as b:
        assert b.status()["mode"] == admission
        f1 = b.submit({"input_ids": np.arange(1, 5), "max_new_tokens": 8})
        _wait(lambda: eng.prefills, "the first admission")
        f2 = b.submit({"input_ids": np.arange(2, 6), "max_new_tokens": 3})
        r1, r2 = f1.result(timeout=30), f2.result(timeout=30)
    assert r1["tokens"] == _expected(np.arange(1, 5), 8)
    assert r2["tokens"] == _expected(np.arange(2, 6), 3)
    both = any(kind == "decode" and len(s) == 2 for kind, s in eng.events)
    assert both == (admission == "continuous")


def test_close_nodrain_finishes_in_flight_fails_queued():
    eng = _StubDecodeEngine(slots=1, max_batch=1, step_delay_s=0.01)
    b = ContinuousBatcher(eng, BatcherConfig(max_batch=1))
    try:
        live = b.submit({"input_ids": np.arange(1, 5), "max_new_tokens": 10})
        _wait(lambda: b.status()["slots_active"], "the first admission")
        queued = b.submit({"input_ids": np.arange(2, 6)})
    finally:
        b.close(drain=False)
    assert live.result(timeout=5)["tokens"] == _expected(np.arange(1, 5), 10)
    with pytest.raises(RuntimeError, match="closed"):
        queued.result(timeout=5)
    with pytest.raises(RuntimeError, match="closed"):
        b.submit({"input_ids": np.arange(3)})


def test_decode_dispatch_failure_fails_occupants_only():
    class Exploding(_StubDecodeEngine):
        def __init__(self):
            super().__init__(slots=1, max_batch=1)
            self.fail = False

        def decode(self, *a):
            if self.fail:
                raise RuntimeError("decode exploded")
            return super().decode(*a)

    eng = Exploding()
    m = ServeMetrics()
    with ContinuousBatcher(eng, BatcherConfig(max_batch=1), metrics=m) as b:
        eng.fail = True
        bad = b.submit({"input_ids": np.arange(1, 5), "max_new_tokens": 4})
        with pytest.raises(RuntimeError, match="decode exploded"):
            bad.result(timeout=10)
        eng.fail = False
        ok = b.submit({"input_ids": np.arange(2, 6), "max_new_tokens": 3})
        assert ok.result(timeout=10)["tokens"] == _expected(np.arange(2, 6), 3)
    assert m.rejected_by_cause.snapshot().get("engine_failure") == 1


def test_chunked_prefill_interleaves_with_decode():
    """While a long prompt chunk-prefills, the in-flight request keeps
    taking decode steps BETWEEN its chunks."""
    eng = _StubChunkedEngine(kvpool_mod.KVBlockPool(8, 4), chunk=4, slots=2, max_batch=2,
                             step_delay_s=0.005)
    with ContinuousBatcher(eng, BatcherConfig(max_batch=2, max_in_flight=1)) as b:
        f1 = b.submit({"input_ids": np.arange(1, 5), "max_new_tokens": 10})
        _wait(lambda: any(k == "decode" for k, _ in eng.events), "a decode step")
        f2 = b.submit({"input_ids": np.arange(2, 14), "max_new_tokens": 3})
        r1, r2 = f1.result(timeout=30), f2.result(timeout=30)
    assert r1["tokens"] == _expected(np.arange(1, 5), 10)
    assert r2["tokens"] == _expected(np.arange(2, 14), 3)
    long_chunks = [i for i, (k, _) in enumerate(eng.events) if k == "chunk"][-3:]
    assert len(long_chunks) == 3
    assert any(eng.events[i][0] == "decode"
               for i in range(long_chunks[0] + 1, long_chunks[-1]))


@pytest.mark.parametrize("pool", [False, True], ids=["slots", "prefix_pool"])
def test_race_soak(pool):
    """Concurrent submitters over the slot table (and, with ``pool``, the
    chunked stub over a real eviction-prone ``KVBlockPool`` under shared
    heads) under the race sanitizer: every declared attribute stays
    happens-before ordered, the lock graph acyclic, streams exact. The
    batcher is built inside the context so its threads are tracked.
    Bounded: 4 threads x 10 requests."""
    modules = [batcher_mod, kvpool_mod] if pool else [batcher_mod]
    with sanitize_races(modules=modules) as san:
        eng = (_StubChunkedEngine(kvpool_mod.KVBlockPool(6, 4), chunk=4, slots=3, max_batch=2)
               if pool else _StubDecodeEngine(slots=3, max_batch=2))
        b = ContinuousBatcher(eng, BatcherConfig(max_batch=2, max_queue=256, max_in_flight=2))
        heads = [np.arange(10 * h + 1, 10 * h + 9) for h in range(3)]
        results, errs = {}, []

        def worker(base):
            rng = np.random.default_rng(base)
            try:
                futs = []
                for _ in range(10):
                    tail = rng.integers(1, 40, size=int(rng.integers(1, 5) if pool
                                                        else rng.integers(2, 9)))
                    prompt = (np.concatenate([heads[int(rng.integers(0, 3))], tail])
                              if pool else tail)
                    n = int(rng.integers(1, 7))
                    futs.append((prompt, n, b.submit({"input_ids": prompt,
                                                      "max_new_tokens": n})))
                for j, (prompt, n, f) in enumerate(futs):
                    results[(base, j)] = (f.result(timeout=30)["tokens"], _expected(prompt, n))
            except Exception as e:  # pragma: no cover - surfaced via errs
                errs.append(e)

        threads = [threading.Thread(target=worker, args=(base,)) for base in (1, 2, 3, 4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        st = b.status()
        b.close()
        assert not errs
        assert len(results) == 40
        for got, want in results.values():
            assert got == want
        if pool:
            assert st["prefix_cache"]["hits"] > 0
        assert san.acquisitions > 0 and san.accesses > 0
        san.assert_clean()


# ------------------------------------------- parity with the JAX batcher


def _requests(seed: int, head: bool):
    """7 requests through 3 slots (admissions join mid-flight and reuse
    slots), every other one sampled at 0.8 with its own seed; with ``head``
    they share a 12-token head (3 pool blocks of 4)."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(5, 64, size=12)
    out = []
    for i in range(7):
        if head:
            ids = np.concatenate([shared, rng.integers(5, 64, size=int(rng.integers(1, 4)))])
        else:
            ids = rng.integers(5, 64, size=int(rng.integers(3, 15)))
        out.append({"input_ids": ids, "max_new_tokens": int(rng.integers(2, 9)),
                    "temperature": 0.8 if i % 2 else 0.0, "seed": 100 + i})
    return out


MODES = {"plain": {}, "chunked_prefix": CHUNKED}


@pytest.fixture(scope="module")
def pairs():
    return {mode: (jax_engine(**kw), port_engine(**kw)) for mode, kw in MODES.items()}


@pytest.mark.parametrize("mode", list(MODES))
def test_streams_match_jax_batcher(mode, pairs):
    """The same requests, in the same order, through the JAX batcher over
    the JAX engine and the port's over the port's: equal streams, exactly;
    greedy ones equal the full-forward reference. With the prefix cache a
    first request publishes the head, then the rest hit it."""
    jeng, peng = pairs[mode]
    head = mode == "chunked_prefix"
    reqs = _requests(11, head)
    if head:
        reqs = [dict(reqs[0], temperature=0.0)] + reqs
    cfg = BatcherConfig(max_batch=2, max_queue=32)
    want, _ = run_batcher(JaxBatcher, jeng, cfg, reqs[:1])
    got, _ = run_batcher(ContinuousBatcher, peng, cfg, reqs[:1])
    m = ServeMetrics()
    want += run_batcher(JaxBatcher, jeng, cfg, reqs[1:])[0]
    more, st = run_batcher(ContinuousBatcher, peng, cfg, reqs[1:], metrics=m)
    got += more
    assert got == want
    for r, stream in zip(reqs, got):
        assert len(stream) == r["max_new_tokens"]
        if not r["temperature"]:
            assert stream == ref_greedy(r["input_ids"], r["max_new_tokens"])
    if head:
        assert m.prefix_hits.value >= len(reqs) - 1
        assert st["prefix_cache"]["tokens_saved"] >= 12 * (len(reqs) - 1)
        # Cache hits leave the streams as the cold path gives them.
        cold, _ = run_batcher(ContinuousBatcher, pairs["plain"][1], cfg, reqs)
        assert got == cold


# ----------------------------------------------------------- prefix cache


@pytest.fixture(scope="module")
def prefix_port():
    return port_engine(**CHUNKED)


def test_result_fields_and_phases(prefix_port):
    """Results carry tokens/n_tokens/prompt_len/bucket; the contiguous
    phases sum exactly to wall latency; the pool's bytes follow its blocks
    (2 x 1 layer x 4 tokens x 32 x f32 = 1024 a block)."""
    reqs = _requests(3, head=True)[:3]
    with ContinuousBatcher(prefix_port, BatcherConfig(max_batch=2)) as b:
        futs = [b.submit(dict(r)) for r in reqs]
        results = [f.result(timeout=60) for f in futs]
        st = b.status()
    for f, r, req in zip(futs, results, reqs):
        assert r["n_tokens"] == req["max_new_tokens"] == len(r["tokens"])
        assert r["prompt_len"] == len(req["input_ids"])
        assert r["bucket"] == prefix_port.bucket_for(len(req["input_ids"]))
        assert set(f.phases) == {"queue_wait", "prefill", "decode"}
        assert abs(sum(f.phases.values()) - f.latency_s) < 1e-9
    pc = st["prefix_cache"]
    assert pc["blocks_used"] > 0 and pc["bytes_used"] == pc["blocks_used"] * 1024
    assert prefix_port.prefix_cache.n_blocks == prefix_port._pool_blocks


def test_prefix_cache_cow_isolation(prefix_port):
    """A request that matches a shared head and then diverges must not
    corrupt the published pages: the original prompt replayed afterwards
    still equals its cache-free reference."""
    rng = np.random.default_rng(17)
    head = rng.integers(5, 64, size=12)
    a = {"input_ids": np.concatenate([head, [7, 9]]), "max_new_tokens": 6}
    b_req = {"input_ids": np.concatenate([head, [33]]), "max_new_tokens": 6}
    ref_a, ref_b = ref_greedy(a["input_ids"], 6), ref_greedy(b_req["input_ids"], 6)
    m = ServeMetrics()
    with ContinuousBatcher(prefix_port, BatcherConfig(max_batch=2), metrics=m) as bt:
        assert bt.submit(dict(a)).result(timeout=60)["tokens"] == ref_a
        assert bt.submit(dict(b_req)).result(timeout=60)["tokens"] == ref_b
        assert bt.submit(dict(a)).result(timeout=60)["tokens"] == ref_a
    assert m.prefix_hits.value >= 2


def test_prefix_cache_eviction_under_pressure():
    """A pool of 4 blocks under 6 distinct 3-block prompts: chains evict
    LRU-leaf first, the streams stay exact on both passes."""
    engine = port_engine(slots=2, max_new_tokens=6, prefix_cache_mb=4096 / 2**20,
                         block_tokens=4, prefill_chunk=8)
    assert engine.prefix_cache.n_blocks == 4
    rng = np.random.default_rng(23)
    reqs = [{"input_ids": rng.integers(5, 64, size=13), "max_new_tokens": 3}
            for _ in range(6)]
    refs = [ref_greedy(r["input_ids"], 3) for r in reqs]
    with ContinuousBatcher(engine, BatcherConfig(max_batch=2)) as b:
        for _ in range(2):
            futs = [b.submit(dict(r)) for r in reqs]
            for f, ref in zip(futs, refs):
                assert f.result(timeout=60)["tokens"] == ref
    st = engine.prefix_cache.stats()
    assert st["evictions"] > 0 and st["blocks_used"] <= 4


# ------------------------------------------------------------- HTTP front end


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as resp:
        return resp.status, resp.read()


def test_http_generate_and_drain(pairs):
    """``POST /v1/generate`` end to end (tokens, batching mode and slots,
    phases), the slot table on ``/statusz``, the decode families in the
    prom text, the fleet routes' 503s, and ``/drainz`` flipping
    ``/healthz``."""
    engine = pairs["plain"][1]
    client = Client(engine, BatcherConfig(max_batch=2))
    server = build_http_server(client, port=0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    base = "http://%s:%d" % server.server_address
    try:
        ids = list(range(5, 12))
        code, body = _post(base + "/v1/generate", {"input_ids": ids, "max_new_tokens": 4,
                                                   "priority": 0, "deadline_ms": 5000})
        assert code == 200
        assert body["tokens"] == ref_greedy(ids, 4)
        assert body["n_tokens"] == 4 and body["prompt_len"] == 7 and body["bucket"] == 16
        assert body["batching"] == {"mode": "continuous", "slots": 3, "slots_active": 0}
        assert set(body["phases"]) == {"queue_wait", "prefill", "decode"}
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base + "/v1/generate", {"input_ids": []})
        assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:  # a BERT route
            _post(base + "/v1/mlm", {"input_ids": ids})
        assert e.value.code == 404
        st = json.loads(_get(base + "/statusz")[1])
        assert st["batcher"]["mode"] == "continuous" and st["batcher"]["slots"] == 3
        assert st["batcher"]["sched"]["policy"] == "fifo"
        text = _get(base + "/metrics?format=prom")[1].decode()
        for family in ("serve_tokens_total", "serve_decode_steps_total",
                       'phase="decode_step"', "serve_ttft", "serve_kv_bytes_per_token"):
            assert family in text
        for route in ("/v1/kv_transfer", "/v1/stream_migrate", "/v1/stream_wait",
                      "/migratez"):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(base + route, {})
            assert e.value.code == 503
            assert "disabled: server built without" in json.loads(e.value.read())["error"]
        code, drain = _post(base + "/drainz", {})
        assert code == 200 and drain["progress"]["tokens_remaining"] == 0
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(base + "/healthz")
        assert e.value.code == 503
    finally:
        server.shutdown()
        server.server_close()
        client.close()


@pytest.mark.parametrize("batcher_cls,config_cls", [(ContinuousBatcher, BatcherConfig),
                                                    (JaxBatcher, JaxBatcherConfig)],
                         ids=["port", "jax"])
def test_fleet_methods_fail_cleanly_on_a_closed_batcher(batcher_cls, config_cls):
    """``adopt_chain``, ``adopt_stream`` (with pages and page-less) and
    ``export_streams`` on a closed batcher raise at once, the port's as the
    JAX package's do (one closed-form stub engine for both)."""
    engine = _StubDecodeEngine()
    engine.stream_migrate = True  # past the slot-import check to the close
    b = batcher_cls(engine, config_cls(max_batch=2))
    b.close()
    state = StreamState("closed-1", [5, 6, 7], [8], max_new_tokens=4, length=3)
    for call in (lambda: b.adopt_chain([1, 2, 3, 4]),
                 lambda: b.adopt_stream(state, np.zeros(1), np.zeros(1)),
                 lambda: b.adopt_stream(state),
                 lambda: b.export_streams(2.0)):
        with pytest.raises(RuntimeError, match="batcher is closed"):
            call()
