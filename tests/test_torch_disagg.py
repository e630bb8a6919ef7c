"""The port's disaggregated prefill/decode serving
(``distributed_tensorflow_tpu_torch/serve/disagg.py``) against the JAX
package's: the chain wire format byte for byte (fp32, bf16, int8 v3) and
every refusal with JAX's message, the transfer budget's queue and shed,
the pool's ``cached_len`` peek, and the real-engine transfer path at the
JAX tests' tiny causal LM (export from a prefill role's pool, adopt on a
``kv_transfer=True`` decode role, streams equal to the full-forward greedy
reference), and chains crossing between the two packages in both
directions (a JAX prefill engine's chain adopted by a port decode engine,
and the reverse, each giving the JAX colocated engine's stream).

Every wait carries its own timeout of a few seconds, so no test can hang.
"""

from __future__ import annotations

import concurrent.futures
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import ml_dtypes
import numpy as np
import pytest
import torch
from _torch_fleet_common import MAX_NEW, jax_client, port_client, ref_greedy

from distributed_tensorflow_tpu.serve import disagg as jax_disagg
from distributed_tensorflow_tpu_torch.obs.flightrec import FlightRecorder
from distributed_tensorflow_tpu_torch.serve import (
    DisaggServingPair,
    KVBlockPool,
    build_http_server,
)
from distributed_tensorflow_tpu_torch.serve.batcher import Backpressure
from distributed_tensorflow_tpu_torch.serve.disagg import (
    WIRE_VERSION,
    TransferBudget,
    WireError,
    deserialize_chain,
    make_kv_receiver,
    serialize_chain,
)

META = {"num_layers": 2, "block_tokens": 4, "heads": 2, "head_dim": 3,
        "dtype": "float32", "max_chain": 8}
T = 5.0  # seconds: the bound of every future, HTTP and queue wait below


def _chain(n_blocks: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    shape = (META["num_layers"], n_blocks, META["block_tokens"],
             META["heads"], META["head_dim"])
    pk = rng.standard_normal(shape).astype(np.float32)
    pv = rng.standard_normal(shape).astype(np.float32)
    ids = list(rng.integers(5, 60, size=n_blocks * META["block_tokens"]))
    return ids, pk, pv


def _np(t: torch.Tensor) -> bytes:
    return t.view(torch.uint8).numpy().tobytes()


# ------------------------------------------------------------- wire format


def test_wire_round_trip_bit_exact():
    ids, pk, pv = _chain(3)
    buf = serialize_chain(ids, torch.from_numpy(pk), torch.from_numpy(pv), META)
    ids2, k2, v2, header = deserialize_chain(buf)
    assert ids2 == [int(t) for t in ids]
    # Bit-exactness, not closeness: the decode role must read the very
    # bytes the prefill role computed.
    assert _np(k2) == pk.tobytes() and _np(v2) == pv.tobytes()
    assert isinstance(k2, torch.Tensor) and k2.dtype == torch.float32
    assert header["n_blocks"] == 3
    assert header["page_meta"]["dtype"] == "float32"


def test_wire_refuses_truncation():
    ids, pk, pv = _chain(2)
    buf = serialize_chain(ids, pk, pv, META)
    with pytest.raises(WireError, match="prefix"):
        deserialize_chain(buf[:6])
    with pytest.raises(WireError, match="truncated header"):
        deserialize_chain(buf[:12])
    with pytest.raises(WireError, match="payload"):
        deserialize_chain(buf[:-50])


def test_wire_refuses_bad_magic_and_corrupt_header():
    ids, pk, pv = _chain(2)
    buf = serialize_chain(ids, pk, pv, META)
    with pytest.raises(WireError, match="magic"):
        deserialize_chain(b"NOPE" + buf[4:])
    corrupt = bytearray(buf)
    corrupt[12] = 0xFF  # inside the JSON header: parse fails closed
    with pytest.raises(WireError):
        deserialize_chain(bytes(corrupt))


def test_wire_refuses_version_from_the_future():
    ids, pk, pv = _chain(1)
    buf = serialize_chain(ids, pk, pv, META)
    future = buf[:4] + (WIRE_VERSION + 1).to_bytes(2, "big") + buf[6:]
    with pytest.raises(WireError, match="version"):
        deserialize_chain(future)


def test_wire_refuses_corrupt_payload_crc():
    ids, pk, pv = _chain(2)
    buf = bytearray(serialize_chain(ids, pk, pv, META))
    buf[-1] ^= 0x01  # one bit flip in the last v-page byte
    with pytest.raises(WireError, match="CRC"):
        deserialize_chain(bytes(buf))


def test_wire_refuses_token_key_coverage_mismatch():
    ids, pk, pv = _chain(2)
    # Token keys for 3 blocks but only 2 pages carried: a receiving pool
    # would index a block whose pages never arrived.
    with pytest.raises(ValueError, match="cover"):
        serialize_chain(ids + [1, 2, 3, 4], pk, pv, META)
    with pytest.raises(ValueError, match="page_meta"):
        serialize_chain(ids, pk, pv, {**META, "heads": 7})


# ------------------------------------------------ byte identity with JAX


def _pages(dtype: str, seed: int = 4):
    """Seeded ``(ids, jax-side pages, port-side pages, meta)`` of 3 blocks:
    numpy for the JAX serializer, torch for the port's (int8 as ``{q, s}``
    trees)."""
    ids, pk, pv = _chain(3, seed)
    meta = {**META, "dtype": dtype}
    if dtype == "bfloat16":
        jk, jv = pk.astype(ml_dtypes.bfloat16), pv.astype(ml_dtypes.bfloat16)
        tk = torch.from_numpy(pk).to(torch.bfloat16)
        tv = torch.from_numpy(pv).to(torch.bfloat16)
        return ids, (jk, jv), (tk, tv), meta
    if dtype == "int8":
        rng = np.random.default_rng(seed + 1)

        def side():
            return {"q": rng.integers(-127, 128, size=pk.shape).astype(np.int8),
                    "s": rng.random(pk.shape[:3]).astype(np.float32)}

        jk, jv = side(), side()
        tk = {k: torch.from_numpy(v.copy()) for k, v in jk.items()}
        tv = {k: torch.from_numpy(v.copy()) for k, v in jv.items()}
        return ids, (jk, jv), (tk, tv), meta
    return ids, (pk, pv), (torch.from_numpy(pk), torch.from_numpy(pv)), meta


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_chain_buffer_equals_jax_byte_for_byte(dtype):
    ids, (jk, jv), (tk, tv), meta = _pages(dtype)
    want = jax_disagg.serialize_chain(ids, jk, jv, meta)
    assert serialize_chain(ids, tk, tv, meta) == want
    # The same pages as numpy (bf16 through ml_dtypes) frame identically.
    assert serialize_chain(ids, jk, jv, meta) == want
    version = int.from_bytes(want[4:6], "big")
    assert version == (3 if dtype == "int8" else 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_each_parser_accepts_the_others_chain(dtype):
    ids, (jk, jv), (tk, tv), meta = _pages(dtype)
    jbuf = jax_disagg.serialize_chain(ids, jk, jv, meta)
    pbuf = serialize_chain(ids, tk, tv, meta)
    ids_p, k_p, v_p, h_p = deserialize_chain(jbuf)
    ids_j, k_j, v_j, h_j = jax_disagg.deserialize_chain(pbuf)
    assert ids_p == ids_j == [int(t) for t in ids] and h_p == h_j
    if dtype == "int8":
        for side_p, side_j in ((k_p, k_j), (v_p, v_j)):
            assert _np(side_p["q"]) == side_j["q"].tobytes()
            assert _np(side_p["s"]) == side_j["s"].tobytes()
    else:
        assert str(k_p.dtype) == f"torch.{dtype}"
        assert _np(k_p) == k_j.tobytes() and _np(v_p) == v_j.tobytes()


def _malformed(buf: bytes) -> dict:
    """Named malformations of a chain buffer, each one JAX refuses."""
    hlen = int.from_bytes(buf[6:10], "big")
    header = json.loads(buf[10:10 + hlen])

    def retag(**patch):
        h = json.dumps({**header, **patch}, separators=(",", ":")).encode()
        return buf[:6] + len(h).to_bytes(4, "big") + h + buf[10 + hlen:]

    return {
        "short": buf[:6],
        "header_cut": buf[:12],
        "payload_cut": buf[:-50],
        "magic": b"NOPE" + buf[4:],
        "future": buf[:4] + (9).to_bytes(2, "big") + buf[6:],
        "stream_version": buf[:4] + (2).to_bytes(2, "big") + buf[6:],
        "json": buf[:12] + b"\xff" + buf[13:],
        "crc": buf[:-1] + bytes([buf[-1] ^ 1]),
        "layout": retag(layout="thdlb"),
        "coverage": retag(token_ids=header["token_ids"] + [1, 2, 3, 4]),
        "dtype_version": retag(page_meta={**header["page_meta"], "dtype": "int8"}),
        "missing": retag(n_blocks=None),
        "dtype_name": retag(page_meta={**header["page_meta"], "dtype": "float99"}),
    }


def test_every_chain_refusal_is_jaxs_message_for_message():
    ids, pk, pv = _chain(3)
    buf = jax_disagg.serialize_chain(ids, pk, pv, META)
    for name, bad in _malformed(buf).items():
        with pytest.raises(jax_disagg.WireError) as je:
            jax_disagg.deserialize_chain(bad)
        with pytest.raises(WireError) as pe:
            deserialize_chain(bad)
        assert str(pe.value) == str(je.value), name


# --------------------------------------------------------- transfer budget


def test_budget_grants_and_releases():
    b = TransferBudget(1000)
    b.acquire(600)
    b.acquire(400)
    d = b.digest()
    assert d["in_flight_bytes"] == 1000 and d["granted_total"] == 2
    b.release(600)
    b.acquire(500)
    b.release(900)
    assert b.digest()["in_flight_bytes"] == 0


def test_budget_sheds_oversized_immediately():
    b = TransferBudget(100, timeout_s=T)
    t0 = time.monotonic()
    with pytest.raises(Backpressure):
        b.acquire(101)  # can never fit: no point waiting
    assert time.monotonic() - t0 < 1.0
    assert b.digest()["shed_total"] == 1


def test_budget_sheds_on_timeout_and_full_queue():
    b = TransferBudget(100, max_queued=1, timeout_s=0.05)
    b.acquire(80)
    with pytest.raises(Backpressure):
        b.acquire(40)  # queues, then times out
    # Saturate the waiter queue from a thread, then the next acquire must
    # shed immediately instead of queueing behind it.
    b2 = TransferBudget(100, max_queued=1, timeout_s=1.0)
    b2.acquire(100)
    started = threading.Event()

    def waiter():
        started.set()
        try:
            b2.acquire(50)
        except Backpressure:
            pass

    t = threading.Thread(target=waiter)
    t.start()
    assert started.wait(T)
    time.sleep(0.05)  # let the waiter enter the queue
    with pytest.raises(Backpressure):
        b2.acquire(50)
    b2.release(100)  # unblocks the queued waiter
    t.join(timeout=T)
    assert not t.is_alive() and b2.digest()["queued"] == 0


def test_budget_waiter_unblocks_on_release():
    b = TransferBudget(100, timeout_s=T)
    b.acquire(100)
    got = threading.Event()

    def waiter():
        b.acquire(60)
        got.set()

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.02)
    assert not got.is_set()
    b.release(100)
    t.join(timeout=T)
    assert got.is_set()
    assert b.digest()["in_flight_bytes"] == 60


def test_budget_validates_cap():
    with pytest.raises(ValueError, match="cap_bytes"):
        TransferBudget(0)


# ------------------------------------------------------------- kvpool peek


def test_kvpool_cached_len_peeks_without_pinning():
    pool = KVBlockPool(8, 4)
    prompt = list(range(1, 13))
    pool.insert(prompt)
    # Same one-token-suffix cap as match, but no pin: release not needed.
    assert pool.cached_len(prompt) == 8
    # One extra token lifts the cap past the last inserted block.
    assert pool.cached_len(prompt + [99]) == 12
    assert pool.cached_len([7, 7, 7, 7]) == 0
    m = pool.match(prompt)  # still fully matchable: nothing was pinned
    assert m.cached_len == 8
    pool.release(m)


# ------------------------------------------- real engines: transfer + parity


@pytest.fixture(scope="module")
def role_pair():
    """A prefill-role and decode-role client pair of the port, wired
    through DisaggServingPair on the WIRE transport (the loopback
    rehearsal of POST /v1/kv_transfer)."""
    pre_c = port_client(kv_transfer=True)
    dec_c = port_client(FlightRecorder(512), kv_transfer=True)
    budget = TransferBudget(16 * 1024 * 1024)
    pair = DisaggServingPair(
        prefill_batcher=pre_c.batcher, decode_batcher=dec_c.batcher,
        prefill_engine=pre_c.engine, decode_engine=dec_c.engine,
        budget=budget, transport="wire", metrics=dec_c.metrics,
        recorder=dec_c.recorder, timeout_s=T,
    )
    yield pair, pre_c, dec_c, budget
    pre_c.close()
    dec_c.close()


def _published(client, prompt) -> bytes:
    """Prefill ``prompt`` on ``client``'s engine and serialize its chain."""
    eng = client.engine
    client.call({"input_ids": prompt, "max_new_tokens": 1}, timeout=T)
    pool = eng.prefix_cache
    m = pool.match(list(prompt) + [1])  # +1 token: match every block
    try:
        assert m.blocks, "prefill publish must index the prompt"
        n = len(m.blocks)
        pk, pv = eng.export_prefix_pages(m.blocks)
        return serialize_chain([int(t) for t in prompt[: n * pool.block_tokens]],
                               pk[:, :n], pv[:, :n], eng.page_meta())
    finally:
        pool.release(m)


@pytest.mark.parametrize("transport", ["wire", "d2d"])
def test_disagg_streams_match_full_forward_reference(role_pair, transport):
    pair, _, dec_c, _ = role_pair
    pair.transport = transport
    rng = np.random.default_rng(3 if transport == "wire" else 5)
    hits0 = dec_c.metrics.prefix_hits.value
    for i in range(3):
        prompt = rng.integers(5, 64, size=int(rng.integers(12, 17)))
        n = int(rng.integers(2, 5))
        got = pair.generate({"input_ids": prompt, "max_new_tokens": n})["tokens"]
        assert got == ref_greedy(prompt, n), f"request {i}"
    # Distinct prompts: any decode-side hit can ONLY be an adopted chain.
    assert dec_c.metrics.prefix_hits.value > hits0


def test_transfer_records_events_and_metrics(role_pair):
    pair, _, dec_c, budget = role_pair
    pair.transport = "wire"
    prompt = np.random.default_rng(9).integers(5, 64, size=16)
    pair.generate({"input_ids": prompt, "max_new_tokens": 2})
    kinds = [e["kind"] for e in dec_c.recorder.events()]
    assert "kv_transfer_start" in kinds and "kv_transfer_done" in kinds
    snap = dec_c.metrics.snapshot()
    assert snap["kv_transfer_bytes"]["decode"] > 0
    assert snap["kv_transfer_seconds"]["decode"]["count"] >= 1
    assert budget.digest()["granted_total"] >= 1
    assert budget.digest()["in_flight_bytes"] == 0


def test_budget_shed_degrades_to_a_full_reprefill(role_pair):
    """A pair whose budget can carry no chain still serves every request
    (the decode role re-prefills the whole prompt): degraded, not failed."""
    _, pre_c, dec_c, _ = role_pair
    tiny = TransferBudget(1, timeout_s=0.05)
    pair = DisaggServingPair(prefill_batcher=pre_c.batcher, decode_batcher=dec_c.batcher,
                             prefill_engine=pre_c.engine, decode_engine=dec_c.engine,
                             budget=tiny, timeout_s=T)
    prompt = np.random.default_rng(11).integers(5, 64, size=14)
    assert pair.generate({"input_ids": prompt, "max_new_tokens": 3})["tokens"] == \
        ref_greedy(prompt, 3)
    assert tiny.digest()["shed_total"] == 1


def test_export_import_round_trip_pages_bit_exact(role_pair):
    """The transferred pages ARE the prefill role's pool bytes: export a
    published chain, wire round trip, and compare against a direct read of
    the source pool."""
    _, pre_c, _, _ = role_pair
    eng = pre_c.engine
    prompt = np.random.default_rng(17).integers(5, 64, size=16)
    pre_c.call({"input_ids": prompt, "max_new_tokens": 1}, timeout=T)
    pool = eng.prefix_cache
    m = pool.match(list(prompt) + [1])
    try:
        assert m.blocks, "prefill publish must index the prompt"
        pk, pv = eng.export_prefix_pages(m.blocks)
        n = len(m.blocks)
        src = eng._pool_k[:, m.blocks]
        assert torch.equal(pk[:, :n], src)
        ids = [int(t) for t in prompt[: n * pool.block_tokens]]
        buf = serialize_chain(ids, pk[:, :n], pv[:, :n], eng.page_meta())
        ids2, k2, _, _ = deserialize_chain(buf)
        assert _np(k2) == _np(src.contiguous()) and ids2 == ids
    finally:
        pool.release(m)


def test_receiver_refuses_geometry_mismatch_and_garbage(role_pair):
    _, _, dec_c, _ = role_pair
    receive = make_kv_receiver(dec_c.batcher, dec_c.engine, recorder=dec_c.recorder,
                               timeout_s=T)
    with pytest.raises(WireError):
        receive(b"garbage bytes, not a chain")
    ids, pk, pv = _chain(2)
    # META geometry differs from the tiny engine's: refuse, don't adopt.
    with pytest.raises(WireError, match="geometry"):
        receive(serialize_chain(ids, pk, pv, META))
    causes = [e.get("cause") for e in dec_c.recorder.events()
              if e["kind"] == "kv_transfer_reject"]
    assert "wire" in causes and "geometry" in causes


def test_receiver_budget_shed_raises_backpressure(role_pair):
    _, pre_c, dec_c, _ = role_pair
    buf = _published(pre_c, np.random.default_rng(23).integers(5, 64, size=16))
    tiny = TransferBudget(1, max_queued=1, timeout_s=0.05)
    receive = make_kv_receiver(dec_c.batcher, dec_c.engine, budget=tiny, timeout_s=T)
    with pytest.raises(Backpressure):
        receive(buf)
    assert tiny.digest()["shed_total"] == 1
    # Under a roomy budget the same buffer adopts cleanly.
    receive_ok = make_kv_receiver(dec_c.batcher, dec_c.engine,
                                  budget=TransferBudget(1 << 24), timeout_s=T)
    out = receive_ok(buf)
    assert out["bytes"] == len(buf) and out["adopted_blocks"] == 4


def test_adopt_chain_fails_cleanly_on_closed_batcher():
    c = port_client(kv_transfer=True)
    c.close()
    with pytest.raises(RuntimeError, match="closed"):
        c.batcher.adopt_chain([1, 2, 3, 4])


def _post(url: str, data: bytes):
    req = urllib.request.Request(url, data=data, method="POST",
                                 headers={"Content-Type": "application/octet-stream"})
    with urllib.request.urlopen(req, timeout=T) as r:
        return json.loads(r.read())


def test_kv_transfer_http_route(role_pair):
    """POST /v1/kv_transfer end to end: garbage -> 400, a well-formed chain
    -> 200 + adoption digest, and /statusz carries the budget."""
    _, pre_c, dec_c, _ = role_pair
    budget = TransferBudget(1 << 24)
    receiver = make_kv_receiver(dec_c.batcher, dec_c.engine, budget=budget, timeout_s=T)
    server = build_http_server(dec_c, port=0, kv_receiver=receiver, transfer_budget=budget)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = "http://%s:%d" % server.server_address
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base + "/v1/kv_transfer", b"not a chain")
        assert e.value.code == 400
        buf = _published(pre_c, np.random.default_rng(29).integers(5, 64, size=16))
        assert _post(base + "/v1/kv_transfer", buf)["bytes"] == len(buf)
        with urllib.request.urlopen(base + "/statusz", timeout=T) as r:
            status = json.loads(r.read())
        assert status["kv_transfer"]["granted_total"] >= 1
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=T)


# --------------------------------------- chains across the two packages


def _jax_published(client, prompt) -> bytes:
    """Prefill ``prompt`` on a JAX client and serialize its chain (JAX's
    own export and serializer)."""
    eng = client.engine
    client.call({"input_ids": prompt, "max_new_tokens": 1}, timeout=T)
    pool = eng.prefix_cache
    m = pool.match(list(prompt) + [1])
    try:
        n = len(m.blocks)
        assert n, "prefill publish must index the prompt"
        pk, pv = jax.device_get(eng.export_prefix_pages(m.blocks))
        return jax_disagg.serialize_chain([int(t) for t in prompt[: n * pool.block_tokens]],
                                          np.asarray(pk)[:, :n], np.asarray(pv)[:, :n],
                                          eng.page_meta())
    finally:
        pool.release(m)


REQUESTS = [{"max_new_tokens": MAX_NEW}, {"max_new_tokens": MAX_NEW, "temperature": 0.8,
                                          "seed": 7}]


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_jax_chain_adopts_on_a_port_decode_engine(role_pair, sampled):
    """A chain exported by a JAX prefill engine, adopted by the port's
    decode role, gives the JAX colocated engine's stream."""
    _, _, dec_c, _ = role_pair
    jax_c = jax_client("prefill")
    prompt = np.random.default_rng(31 + sampled).integers(5, 64, size=15)
    payload = {"input_ids": prompt, **REQUESTS[sampled]}
    want = jax_c.call(dict(payload), timeout=T)["tokens"]
    receive = make_kv_receiver(dec_c.batcher, dec_c.engine, timeout_s=T)
    assert receive(_jax_published(jax_c, prompt))["adopted_blocks"] == 3
    hits0 = dec_c.metrics.prefix_hits.value
    assert dec_c.call(dict(payload), timeout=T)["tokens"] == want
    assert dec_c.metrics.prefix_hits.value == hits0 + 1


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_port_chain_adopts_on_a_jax_decode_engine(role_pair, sampled):
    """The reverse: the port's prefill role's chain, adopted by a JAX
    decode engine through JAX's receiver, gives the JAX colocated stream."""
    _, pre_c, _, _ = role_pair
    jax_dec = jax_client("decode")
    prompt = np.random.default_rng(41 + sampled).integers(5, 64, size=15)
    payload = {"input_ids": prompt, **REQUESTS[sampled]}
    want = jax_client("prefill").call(dict(payload), timeout=T)["tokens"]
    receive = jax_disagg.make_kv_receiver(jax_dec.batcher, jax_dec.engine)
    # JAX's receiver waits on its adoption without a timeout: bound it here.
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        out = pool.submit(receive, _published(pre_c, prompt)).result(timeout=T)
    assert out["adopted_blocks"] == 3
    hits0 = jax_dec.metrics.prefix_hits.value
    assert jax_dec.call(dict(payload), timeout=T)["tokens"] == want
    assert jax_dec.metrics.prefix_hits.value == hits0 + 1
