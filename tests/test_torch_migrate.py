"""The port's live decode-stream migration
(``distributed_tensorflow_tpu_torch/serve/disagg.py`` stream wire v2/v4 and
the continuous batcher's ``export_streams``/``adopt_stream``) against the
JAX package's: the stream buffers byte for byte and every refusal with
JAX's message, export/adopt parity against the full-forward greedy
reference (composed with the prefix cache, chunked prefill and
speculation; one process and a TP 2 gloo group), the HTTP routes
(``/v1/stream_migrate``, ``/v1/stream_wait``, ``/drainz`` progress, the
``X-Request-Id`` header), the degradation ladder (wire corruption falls
back page-less, a dead survivor re-adopts locally: no stream lost or
duplicated), and streams crossing between the two packages mid-generation,
greedy and sampled, in both directions.

Every wait carries its own timeout of a few seconds, so no test can hang.
"""

from __future__ import annotations

import json
import socket
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from _torch_fleet_common import (
    MAX_NEW,
    Pacer,
    export_live,
    jax_client,
    port_client,
    ref_greedy,
    wait_active,
)

from distributed_tensorflow_tpu.serve import batcher as jax_batcher
from distributed_tensorflow_tpu.serve import disagg as jax_disagg
from distributed_tensorflow_tpu_torch.obs.flightrec import FlightRecorder
from distributed_tensorflow_tpu_torch.serve import (
    BatcherConfig,
    Client,
    RequestError,
    build_http_server,
)
from distributed_tensorflow_tpu_torch.serve.batcher import Backpressure, StreamState
from distributed_tensorflow_tpu_torch.serve.disagg import (
    _PREFIX,
    WIRE_VERSION,
    WIRE_VERSION_STREAM,
    TransferBudget,
    WireError,
    deserialize_chain,
    deserialize_stream,
    make_stream_receiver,
    migrate_streams,
    serialize_chain,
    serialize_stream,
)
from distributed_tensorflow_tpu_torch.serve.faultinject import (
    FaultEvent,
    FaultInjector,
    FaultPlan,
)

# Pure-wire geometry (no engine): head_dim 3 keeps payloads tiny.
SMETA = {"num_layers": 2, "cache_len": 24, "heads": 2, "head_dim": 3,
         "dtype": "float32"}
# v1 chain geometry for the cross-version refusal test.
CMETA = {"num_layers": 2, "block_tokens": 4, "heads": 2, "head_dim": 3,
         "dtype": "float32", "max_chain": 8}
T = 5.0  # seconds: the bound of every future, HTTP and export wait below


def _state(n_prompt=6, n_gen=3, rid="mig-wire-1", cls=StreamState, **kw):
    rng = np.random.default_rng(n_prompt * 31 + n_gen)
    d = dict(
        request_id=rid,
        input_ids=[int(t) for t in rng.integers(5, 60, size=n_prompt)],
        tokens=[int(t) for t in rng.integers(5, 60, size=n_gen)],
        seed=3,
        temperature=0.0,
        eos_id=None,
        max_new_tokens=8,
        length=n_prompt + n_gen - 1,
    )
    d.update(kw)
    return cls(**d)


def _stages(meta=SMETA, seed=0):
    rng = np.random.default_rng(seed)
    shape = (meta["num_layers"], meta["cache_len"], meta["heads"],
             meta["head_dim"])
    pk = rng.standard_normal(shape).astype(meta["dtype"])
    pv = rng.standard_normal(shape).astype(meta["dtype"])
    return torch.from_numpy(pk), torch.from_numpy(pv)


def _retag(buf: bytes, **patch) -> bytes:
    """Re-write header fields of a wire buffer (tamper helper): the CRC
    covers state + payload, NOT the envelope fields, so envelope checks
    must each refuse on their own."""
    magic, version, hlen = _PREFIX.unpack_from(buf)
    header = json.loads(buf[_PREFIX.size:_PREFIX.size + hlen])
    header.update(patch)
    hb = json.dumps(header, separators=(",", ":")).encode()
    return _PREFIX.pack(magic, version, len(hb)) + hb + buf[_PREFIX.size + hlen:]


def _np(t: torch.Tensor) -> bytes:
    return t.contiguous().view(torch.uint8).numpy().tobytes()


# ------------------------------------------------------ stream wire format


def test_stream_wire_round_trip_paged_bit_exact():
    st = _state(n_prompt=8, n_gen=4)  # length 11
    pk, pv = _stages()
    buf = serialize_stream(st, pk, pv, SMETA)
    sd, k2, v2, header = deserialize_stream(buf)
    assert sd == st.to_dict()
    assert header["n_tokens"] == st.length == 11
    # Bit-exactness of exactly the settled positions: the receiver writes
    # the very bytes the victim's cache held, padded, never recast.
    assert _np(k2) == _np(pk[:, :11]) and _np(v2) == _np(pv[:, :11])
    assert StreamState.from_dict(sd).to_dict() == st.to_dict()


def test_stream_wire_round_trip_page_less():
    st = _state(n_prompt=5, n_gen=2)
    sd, pk, pv, header = deserialize_stream(serialize_stream(st))
    assert sd == st.to_dict() and pk is None and pv is None
    assert header["n_tokens"] == 0 and header["page_meta"] == {}


def test_stream_wire_refuses_truncation():
    buf = serialize_stream(_state(), *_stages(), SMETA)
    with pytest.raises(WireError, match="prefix"):
        deserialize_stream(buf[:6])
    with pytest.raises(WireError, match="truncated header"):
        deserialize_stream(buf[:_PREFIX.size + 2])
    with pytest.raises(WireError, match="payload"):
        deserialize_stream(buf[:-40])


def test_stream_wire_refuses_bad_magic_and_corrupt_header():
    buf = serialize_stream(_state(), *_stages(), SMETA)
    with pytest.raises(WireError, match="magic"):
        deserialize_stream(b"NOPE" + buf[4:])
    corrupt = bytearray(buf)
    corrupt[_PREFIX.size + 1] = 0xFF  # inside the JSON header
    with pytest.raises(WireError):
        deserialize_stream(bytes(corrupt))


def test_stream_wire_versions_do_not_cross():
    """A v1 chain buffer must not parse as a v2 stream, nor the reverse:
    both sides refuse on version BEFORE trusting any header byte."""
    rng = np.random.default_rng(0)
    shape = (2, 2, 4, 2, 3)
    ids = [int(t) for t in rng.integers(5, 60, size=8)]
    chain = serialize_chain(ids, rng.standard_normal(shape).astype("f4"),
                            rng.standard_normal(shape).astype("f4"), CMETA)
    with pytest.raises(WireError, match="version"):
        deserialize_stream(chain)
    stream = serialize_stream(_state(), *_stages(), SMETA)
    with pytest.raises(WireError, match="version"):
        deserialize_chain(stream)
    assert WIRE_VERSION_STREAM == WIRE_VERSION + 1  # distinct on the wire


def test_stream_wire_refuses_layout_and_length_mismatch():
    buf = serialize_stream(_state(), *_stages(), SMETA)
    with pytest.raises(WireError, match="layout"):
        deserialize_stream(_retag(buf, layout="thld"))
    # n_tokens != state length: a resumed slot would attend over positions
    # that never arrived.
    with pytest.raises(WireError, match="length"):
        deserialize_stream(_retag(buf, n_tokens=9))
    pl = serialize_stream(_state())
    with pytest.raises(WireError, match="stray payload"):
        deserialize_stream(pl + b"x")


def test_stream_wire_refuses_crc_corruption():
    buf = bytearray(serialize_stream(_state(), *_stages(), SMETA))
    buf[-1] ^= 0x01  # one bit flip in the last v-page byte
    with pytest.raises(WireError, match="CRC"):
        deserialize_stream(bytes(buf))
    # State tamper (seed swap) with the envelope intact: the CRC covers
    # the canonical state bytes, so a doctored resume refuses too.
    buf2 = serialize_stream(_state(), *_stages(), SMETA)
    sd = _state().to_dict()
    sd["seed"] = 99
    with pytest.raises(WireError, match="CRC"):
        deserialize_stream(_retag(buf2, stream=sd))


def test_stream_wire_serializer_refusals():
    st = _state()
    pk, pv = _stages()
    with pytest.raises(ValueError, match="both"):
        serialize_stream(st, pk, None, SMETA)
    with pytest.raises(ValueError, match="stream_page_meta"):
        serialize_stream(st, pk, pv, None)
    with pytest.raises(ValueError, match="length"):
        serialize_stream(_state(length=0), pk, pv, SMETA)
    with pytest.raises(ValueError, match="shapes differ"):
        serialize_stream(st, pk, pv[:, :, :1], SMETA)
    with pytest.raises(ValueError, match="disagree"):
        serialize_stream(st, pk, pv, {**SMETA, "heads": 7})


# ------------------------------------------------ byte identity with JAX


def _stream_case(case: str):
    """``(jax buffer, port buffer)`` of one seeded stream: ``paged`` (v2),
    ``page_less`` (v2) or ``int8`` (v4)."""
    st_j = _state(n_prompt=8, n_gen=4, cls=jax_batcher.StreamState, temperature=0.7)
    st_p = _state(n_prompt=8, n_gen=4, temperature=0.7)
    if case == "page_less":
        return jax_disagg.serialize_stream(st_j), serialize_stream(st_p)
    if case == "int8":
        rng = np.random.default_rng(5)
        meta = {**SMETA, "dtype": "int8"}
        shape = (2, 24, 2, 3)
        jk, jv = ({"q": rng.integers(-127, 128, size=shape).astype(np.int8),
                   "s": rng.random(shape[:2]).astype(np.float32)} for _ in range(2))
        tk = {k: torch.from_numpy(v.copy()) for k, v in jk.items()}
        tv = {k: torch.from_numpy(v.copy()) for k, v in jv.items()}
        return (jax_disagg.serialize_stream(st_j, jk, jv, meta),
                serialize_stream(st_p, tk, tv, meta))
    pk, pv = _stages()
    return (jax_disagg.serialize_stream(st_j, pk.numpy(), pv.numpy(), SMETA),
            serialize_stream(st_p, pk, pv, SMETA))


@pytest.mark.parametrize("case", ["paged", "page_less", "int8"])
def test_stream_buffer_equals_jax_byte_for_byte(case):
    jbuf, pbuf = _stream_case(case)
    assert pbuf == jbuf
    assert int.from_bytes(jbuf[4:6], "big") == (4 if case == "int8" else 2)
    # Each parser takes the other's buffer to the same state and pages.
    sd_p, k_p, _, h_p = deserialize_stream(jbuf)
    sd_j, k_j, _, h_j = jax_disagg.deserialize_stream(pbuf)
    assert sd_p == sd_j and h_p == h_j
    if case == "int8":
        assert _np(k_p["q"]) == k_j["q"].tobytes() and _np(k_p["s"]) == k_j["s"].tobytes()
    elif case == "paged":
        assert _np(k_p) == k_j.tobytes()


def test_every_stream_refusal_is_jaxs_message_for_message():
    jbuf, _ = _stream_case("paged")
    sd = json.loads(jbuf[_PREFIX.size:_PREFIX.size + _PREFIX.unpack_from(jbuf)[2]])["stream"]
    bad = {
        "short": jbuf[:6],
        "header_cut": jbuf[:_PREFIX.size + 2],
        "payload_cut": jbuf[:-40],
        "magic": b"NOPE" + jbuf[4:],
        "chain_version": jbuf[:4] + (1).to_bytes(2, "big") + jbuf[6:],
        "json": jbuf[:_PREFIX.size + 1] + b"\xff" + jbuf[_PREFIX.size + 2:],
        "crc": jbuf[:-1] + bytes([jbuf[-1] ^ 1]),
        "layout": _retag(jbuf, layout="thld"),
        "length": _retag(jbuf, n_tokens=9),
        "stray": _stream_case("page_less")[0] + b"x",
        "state": _retag(jbuf, stream={**sd, "seed": 99}),
        "missing": _retag(jbuf, stream={k: v for k, v in sd.items() if k != "tokens"}),
        "dtype_version": _retag(jbuf, page_meta={**SMETA, "dtype": "int8"}),
        "quant_page_less": _stream_case("page_less")[0][:4] + (4).to_bytes(2, "big")
        + _stream_case("page_less")[0][6:],
    }
    for name, buf in bad.items():
        with pytest.raises(jax_disagg.WireError) as je:
            jax_disagg.deserialize_stream(buf)
        with pytest.raises(WireError) as pe:
            deserialize_stream(buf)
        assert str(pe.value) == str(je.value), name


# ------------------------------------------- real engines: export + adopt


@pytest.fixture(scope="module")
def mig_pair():
    """Victim client A and survivor client B (identical composed engines:
    prefix cache + chunked prefill + speculation beside the slot
    export/import cells), plus B's mounted stream receiver."""
    a = port_client(FlightRecorder(2048), spec_tokens=2, stream_migrate=True)
    b = port_client(FlightRecorder(2048), spec_tokens=2, stream_migrate=True)
    recv = make_stream_receiver(b.batcher, b.engine, budget=TransferBudget(64 << 20),
                                metrics=b.metrics, recorder=b.recorder)
    yield a, b, recv
    a.close()
    b.close()


@pytest.fixture(scope="module")
def mig_server(mig_pair):
    """B's HTTP face with the stream receiver mounted: the loopback
    rehearsal of a real survivor replica."""
    _, b, recv = mig_pair
    server = build_http_server(b, port=0, stream_receiver=recv, transfer_budget=recv.budget)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield server.server_address
    server.shutdown()
    server.server_close()
    thread.join(timeout=T)


def _payload(prompt) -> dict:
    return {"input_ids": [int(t) for t in prompt], "max_new_tokens": MAX_NEW}


def test_paged_migration_parity_single_process(mig_pair):
    a, b, recv = mig_pair
    prompt = np.random.default_rng(41).integers(5, 64, size=10)
    exp = export_live(a.batcher, _payload(prompt), "par-paged-1")
    out = recv(serialize_stream(exp.state, exp.pages_k, exp.pages_v,
                                a.engine.stream_page_meta()))
    assert out["adopted"] and out["pages"]
    assert out["request_id"] == "par-paged-1"  # id survives the hop
    assert out["resume_at"] == len(exp.state.tokens) > 0
    res = recv.wait("par-paged-1", timeout_s=T)
    # Bit-identical to the uninterrupted stream: the (seed, absolute
    # position) sampling contract, with the shipped pages re-attended.
    assert res["tokens"] == ref_greedy(prompt, MAX_NEW)
    # The id is single-use once collected (the 404 -> replay cue).
    with pytest.raises(KeyError):
        recv.wait("par-paged-1", timeout_s=1)
    assert "stream_adopt" in [e["kind"] for e in b.recorder.events()]
    assert b.metrics.stream_migrations.snapshot().get("adopted", 0) >= 1


def test_page_less_migration_parity(mig_pair):
    a, _, recv = mig_pair
    prompt = np.random.default_rng(43).integers(5, 64, size=9)
    exp = export_live(a.batcher, _payload(prompt), "par-pageless-1", want_pages=False)
    out = recv(serialize_stream(exp.state))  # drop the pages on purpose
    assert out["adopted"] and not out["pages"]
    # Re-prefill replay: same bits, just slower.
    assert recv.wait("par-pageless-1", timeout_s=T)["tokens"] == ref_greedy(prompt, MAX_NEW)


def test_paged_migration_parity_tp2(tmp_path):
    """A TP 2 serving group (two gloo ranks) adopts a stream exported from
    one process, and exports one that one process adopts: both finish
    equal to one process's uninterrupted stream, pages carried whole-head
    (the group gathers on export and cuts on import)."""
    from test_torch_multiprocess import _launch

    out = _launch(tmp_path, "migrate_tp", n_groups=1, world=2)[0]
    for name in ("into_group", "out_of_group"):
        case = out[name]
        assert case["pages"] and 0 < case["resume_at"] < case["max_new"], name
        assert case["tokens"] == case["reference"], name
    assert out["stream_heads"] == 2


def test_migration_composes_with_prefix_cache_and_spec(mig_pair):
    """Two concurrent streams sharing a prompt head (prefix-cache food) on
    spec-decoding engines, both lifted mid-flight: every token list matches
    the reference, none lost, none doubled."""
    a, _, recv = mig_pair
    rng = np.random.default_rng(53)
    head = rng.integers(5, 64, size=8)
    prompts = [np.concatenate([head, rng.integers(5, 64, size=3)]) for _ in range(2)]
    refs = {f"comp-{i}": ref_greedy(p, MAX_NEW) for i, p in enumerate(prompts)}
    a.batcher.fault_injector = Pacer(0.05)
    try:
        futs = {f"comp-{i}": a.batcher.submit(_payload(p), request_id=f"comp-{i}")
                for i, p in enumerate(prompts)}
        wait_active(a.batcher, 2)
        exported = a.batcher.export_streams(T)
    finally:
        a.batcher.fault_injector = None
    assert exported, "both streams finished before the export could run"
    got = {}
    for exp in exported:
        rid = exp.state.request_id
        if exp.pages_k is not None:
            buf = serialize_stream(exp.state, exp.pages_k, exp.pages_v,
                                   a.engine.stream_page_meta())
        else:
            buf = serialize_stream(exp.state)
        recv(buf)
        got[rid] = recv.wait(rid, timeout_s=T)["tokens"]
    for rid, fut in futs.items():
        if rid not in got:  # finished on A before the export: still parity
            got[rid] = fut.result(timeout=T)["tokens"]
    assert got == refs
    assert len(got) == len(futs)  # exactly once: no lost, no duplicated


def test_receiver_refusals_fail_closed(mig_pair):
    _, b, recv = mig_pair
    before = b.metrics.stream_migrations.snapshot().get("rejected", 0)
    meta = b.engine.stream_page_meta()

    with pytest.raises(WireError):
        recv(b"garbage bytes, not a stream")

    # Geometry: SMETA's toy head_dim never matches the real engine's.
    st = _state(n_prompt=8, n_gen=4, rid="ref-geo")
    with pytest.raises(WireError, match="geometry"):
        recv(serialize_stream(st, *_stages(), SMETA))

    # A paged stream aimed at an engine with no slot-import cell.
    no_import = make_stream_receiver(b.batcher, engine=None, metrics=b.metrics,
                                     recorder=b.recorder)
    gk, gv = _stages(meta, seed=1)
    good = serialize_stream(_state(n_prompt=8, n_gen=4, rid="ref-noimp"), gk, gv, meta)
    with pytest.raises(WireError, match="stream_migrate"):
        no_import(good)

    # Budget shed: surfaces as Backpressure (429), not a refusal 400.
    tight = make_stream_receiver(b.batcher, b.engine,
                                 budget=TransferBudget(1, timeout_s=0.05),
                                 metrics=b.metrics, recorder=b.recorder)
    with pytest.raises(Backpressure):
        tight(good)

    # Settled-slot invariant: wire-consistent (n_tokens == length) but
    # length != prompt + generated - 1 must refuse at adoption.
    bad = _state(n_prompt=8, n_gen=4, rid="ref-inv", length=12)
    with pytest.raises(WireError, match="refused"):
        recv(serialize_stream(bad, gk, gv, meta))

    # Capacity: prompt + max_new beyond this engine's cache pages.
    big = _state(n_prompt=20, n_gen=3, rid="ref-cap", length=22, max_new_tokens=MAX_NEW)
    with pytest.raises(WireError, match="refused"):
        recv(serialize_stream(big, gk, gv, meta))

    causes = {e.get("cause") for e in b.recorder.events()
              if e["kind"] == "stream_migrate_reject"}
    assert {"wire", "geometry", "no_import", "budget", "state"} <= causes
    assert b.metrics.stream_migrations.snapshot()["rejected"] >= before + 6


# --------------------------------------------------- HTTP routes + drains


def _post_json(url, body=None, headers=None, timeout=T):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method="POST", headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def test_stream_migrate_http_route_and_wait(mig_pair, mig_server):
    a, _, _ = mig_pair
    base = "http://%s:%d" % mig_server

    req = urllib.request.Request(base + "/v1/stream_migrate", data=b"not a stream",
                                 method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=T)
    assert e.value.code == 400

    code, body = _post_json(base + "/v1/stream_wait", {})
    assert code == 400 and "request_id" in body["error"]
    code, body = _post_json(base + "/v1/stream_wait", {"request_id": "never-adopted"})
    assert code == 404

    prompt = np.random.default_rng(59).integers(5, 64, size=10)
    exp = export_live(a.batcher, _payload(prompt), "http-mig-1")
    buf = serialize_stream(exp.state, exp.pages_k, exp.pages_v, a.engine.stream_page_meta())
    req = urllib.request.Request(base + "/v1/stream_migrate", data=buf, method="POST")
    with urllib.request.urlopen(req, timeout=T) as r:
        out = json.loads(r.read())
    assert out["adopted"] and out["request_id"] == "http-mig-1"

    with urllib.request.urlopen(base + "/statusz", timeout=T) as r:
        status = json.loads(r.read())
    assert "stream_migrate" in status  # pending registry is observable
    assert status["kv_transfer"]["granted_total"] >= 1

    code, body = _post_json(base + "/v1/stream_wait",
                            {"request_id": "http-mig-1", "timeout_s": T}, timeout=2 * T)
    assert code == 200
    assert body["request_id"] == "http-mig-1"  # correlation across the hop
    assert body["tokens"] == ref_greedy(prompt, MAX_NEW)


class _StubEngine:
    """Pure-python engine for the HTTP-only tests."""

    max_batch = 4

    def validate(self, payload):
        if "input_ids" not in payload:
            raise RequestError("input_ids required")

    def run_batch(self, payloads):
        return [{"pred_ids": np.asarray(p["input_ids"], np.int32), "score": -1.5,
                 "bucket": 16} for p in payloads]


def test_request_id_header_and_drainz_progress():
    client = Client(_StubEngine(), BatcherConfig(max_batch=4, max_delay_ms=2.0))
    server = build_http_server(client, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = "http://%s:%d" % server.server_address
    try:
        code, body = _post_json(base + "/v1/mlm", {"input_ids": [1, 2, 3]},
                                headers={"X-Request-Id": "corr-42"})
        assert code == 200
        # The caller's id IS the id: failover and migration both key their
        # follow-ups (stream_wait, replay) on it surviving.
        assert body["request_id"] == "corr-42"

        code, body = _post_json(base + "/drainz")
        assert code == 200 and body["draining"] is True
        for k in ("slots_active", "queued", "in_flight"):
            assert k in body["progress"]
        # Draining refuses new work at the door, attributably.
        code, body = _post_json(base + "/v1/mlm", {"input_ids": [4]},
                                headers={"X-Request-Id": "corr-43"})
        assert code == 503 and body["request_id"] == "corr-43"
        # A server built without the fleet mounts answers them 503.
        code, body = _post_json(base + "/migratez", {"targets": []})
        assert code == 503 and "without a migrator" in body["error"]
    finally:
        server.shutdown()
        server.server_close()
        client.close()
        thread.join(timeout=T)


# ------------------------------------------------ chaos: degrade, don't lose


def test_migrate_streams_chaos_wire_corrupt_zero_lost_dup(mig_pair, mig_server):
    """Seeded wire corruption against the victim-side orchestrator: the
    corrupted push refuses on CRC, the ladder degrades (page-less, then
    re-adopt), and every stream still resolves exactly once with the
    reference tokens."""
    a, _, recv = mig_pair
    rng = np.random.default_rng(61)
    prompts = [rng.integers(5, 64, size=int(n)) for n in rng.integers(8, 13, size=3)]
    refs = {f"chaos-{i}": ref_greedy(p, MAX_NEW) for i, p in enumerate(prompts)}
    a.batcher.fault_injector = Pacer(0.05)
    try:
        futs = {f"chaos-{i}": a.batcher.submit(_payload(p), request_id=f"chaos-{i}")
                for i, p in enumerate(prompts)}
        wait_active(a.batcher, 2)
        # Corrupt the SECOND outbound buffer (n_sent restarts at 1 per
        # migrate_streams call, so placement is deterministic): the first
        # stream lands clean, the second's paged push refuses on CRC and
        # falls back page-less to the same target.
        fi = FaultInjector(FaultPlan((FaultEvent("wire_corrupt", 2),)))
        digest = migrate_streams(a.batcher, a.engine, [mig_server], metrics=a.metrics,
                                 recorder=a.recorder, fault_injector=fi, timeout_s=T)
    finally:
        a.batcher.fault_injector = None
    assert digest["exported"] >= 2, "the streams finished before migration"
    assert digest["migrated"] + digest["readopted"] == digest["exported"]
    assert digest["migrated"] >= 1  # buffer 1 was clean: at least one lands
    assert len(fi.fired) == 1  # the drill actually corrupted a payload
    got = {}
    for rid, fut in futs.items():
        res = fut.result(timeout=T)
        if res.get("status") == "migrated":
            partial = res["tokens"]
            final = recv.wait(rid, timeout_s=T)
            # The victim's partial transcript is a PREFIX of the final one:
            # the hop appended, never rewrote.
            assert final["tokens"][:len(partial)] == partial
            got[rid] = final["tokens"]
        else:
            got[rid] = res["tokens"]
    assert got == refs  # zero lost, zero duplicated, bit-identical
    assert "stream_export" in [e["kind"] for e in a.recorder.events()]
    assert a.metrics.stream_migrations.snapshot().get("migrated", 0) >= 1


def test_migrate_streams_readopts_when_no_survivor(mig_pair):
    """Every push target dead: migration degrades to a local re-adopt —
    the drain takes longer, the stream still finishes HERE, correctly."""
    a, _, _ = mig_pair
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    dead_port = s.getsockname()[1]
    s.close()  # nobody listens here any more
    prompt = np.random.default_rng(67).integers(5, 64, size=10)
    a.batcher.fault_injector = Pacer(0.05)
    try:
        fut = a.batcher.submit(_payload(prompt), request_id="readopt-1")
        wait_active(a.batcher)
        digest = migrate_streams(a.batcher, a.engine, [("127.0.0.1", dead_port)],
                                 metrics=a.metrics, recorder=a.recorder, timeout_s=T)
    finally:
        a.batcher.fault_injector = None
    res = fut.result(timeout=T)
    assert digest["exported"] == digest["readopted"] == 1
    assert digest["migrated"] == 0 and res.get("status") != "migrated"
    assert res["tokens"] == ref_greedy(prompt, MAX_NEW)
    with pytest.raises(ValueError, match="target"):
        migrate_streams(a.batcher, a.engine, [])


# --------------------------------------- streams across the two packages


SAMPLING = [{}, {"temperature": 0.8, "seed": 11}]


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_jax_stream_finishes_on_the_port(mig_pair, sampled):
    """A stream exported mid-generation from the JAX batcher and adopted on
    the port's finishes with JAX's uninterrupted tokens."""
    _, b, recv = mig_pair
    jc = jax_client("prefill")
    payload = {**_payload(np.random.default_rng(71 + sampled).integers(5, 64, size=10)),
               **SAMPLING[sampled]}
    want = jc.call(dict(payload), timeout=T)["tokens"]
    exp = export_live(jc.batcher, payload, f"jax-to-port-{int(sampled)}")
    buf = jax_disagg.serialize_stream(exp.state, *(np.asarray(p) for p in
                                                   (exp.pages_k, exp.pages_v)),
                                      jc.engine.stream_page_meta())
    out = recv(buf)
    assert out["pages"] and 0 < out["resume_at"] < MAX_NEW
    assert recv.wait(exp.state.request_id, timeout_s=T)["tokens"] == want


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_port_stream_finishes_on_jax(mig_pair, sampled):
    """The reverse: a stream exported from the port's batcher, adopted by
    the JAX batcher through JAX's receiver, finishes with JAX's
    uninterrupted tokens."""
    a, _, _ = mig_pair
    jc = jax_client("decode")
    payload = {**_payload(np.random.default_rng(73 + sampled).integers(5, 64, size=10)),
               **SAMPLING[sampled]}
    want = jc.call(dict(payload), timeout=T)["tokens"]
    exp = export_live(a.batcher, payload, f"port-to-jax-{int(sampled)}")
    jrecv = jax_disagg.make_stream_receiver(jc.batcher, jc.engine)
    out = jrecv(serialize_stream(exp.state, exp.pages_k, exp.pages_v,
                                 a.engine.stream_page_meta()))
    assert out["pages"] and 0 < out["resume_at"] < MAX_NEW
    assert jrecv.wait(exp.state.request_id, timeout_s=T)["tokens"] == want
