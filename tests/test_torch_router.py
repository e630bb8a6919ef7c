"""The port's fleet router (serve/router.py, cli/router.py) on the CPU.

Three layers:

* every test of the JAX package's ``tests/test_router.py``, over the
  port's router, supervisor and serving stack (the two it marks slow are
  slow here too);
* the port held against the JAX router on the same inputs: the four pure
  pickers, a routing sequence over the same in-process stubs (same config,
  same seed: same picks, same ``fleetz()`` keys), the migrated-answer
  collection and its ``resume_tokens`` replay over the same scripted
  transport, and the lost/ready sequence under the same ``probe_timeout``
  plan;
* what the JAX suite never drives: ``hot_swap``'s drain deadline
  migrating live streams off a paced ``cli.serve`` replica (fp32, the
  streams collected by ``route`` equal to uninterrupted ones), a real
  ``resume_tokens`` replay, and ``cli.router`` in spawn + adopt mode under
  SIGTERM leaving no replica process.

Every spawned process and every wait carries a timeout of seconds.
"""

from __future__ import annotations

import json
import random
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from distributed_tensorflow_tpu.obs.flightrec import FlightRecorder as JaxFlightRecorder
from distributed_tensorflow_tpu.serve import faultinject as jax_faultinject
from distributed_tensorflow_tpu.serve import router as jax_router
from distributed_tensorflow_tpu_torch.obs.fleet import ReplicaSupervisor
from distributed_tensorflow_tpu_torch.obs.flightrec import FlightRecorder
from distributed_tensorflow_tpu_torch.obs.sanitizer import sanitize_races
from distributed_tensorflow_tpu_torch.serve import faultinject as port_faultinject
from distributed_tensorflow_tpu_torch.serve import router as router_mod
from distributed_tensorflow_tpu_torch.serve.batcher import BatcherConfig
from distributed_tensorflow_tpu_torch.serve.engine import RequestError
from distributed_tensorflow_tpu_torch.serve.router import (
    Router,
    RouterConfig,
    build_router_server,
    pick_power_of_two,
    prefix_affinity_key,
    rendezvous_pick,
    replica_load,
)
from distributed_tensorflow_tpu_torch.serve.server import Client, build_http_server

REPO_ROOT = Path(__file__).resolve().parent.parent
T = 30.0  # seconds: the bound of every wait on a spawned process below


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ------------------------------------------------------------ policy math


def test_replica_load_sums_queue_in_flight_slots():
    assert replica_load(
        {"queue_depth": 3, "in_flight": 2, "slots_active": 4}
    ) == 9.0
    # Missing keys count zero: flush-mode and stub replicas rank on the
    # same scale as decode replicas.
    assert replica_load({"queue_depth": 1}) == 1.0
    assert replica_load({}) == 0.0


def test_pick_power_of_two_prefers_less_loaded():
    rng = random.Random(0)
    # Two replicas: both are always sampled, so the cooler one must win
    # every single draw.
    assert all(
        pick_power_of_two([0.0, 100.0], rng) == 0 for _ in range(50)
    )
    # Single replica and empty input edge cases.
    assert pick_power_of_two([7.0], rng) == 0
    with pytest.raises(ValueError):
        pick_power_of_two([], rng)


def test_pick_power_of_two_spreads_under_equal_load():
    rng = random.Random(1)
    counts = [0] * 4
    for _ in range(400):
        counts[pick_power_of_two([1.0] * 4, rng)] += 1
    # Equal loads: ties go to the first sampled index, which is uniform —
    # every replica gets a meaningful share.
    assert all(c > 40 for c in counts), counts


def test_pick_power_of_two_beats_hot_replica():
    rng = random.Random(2)
    loads = [10.0, 0.0, 10.0, 10.0]
    hits = sum(
        1 for _ in range(300) if pick_power_of_two(loads, rng) == 1
    )
    # The cool replica wins every draw that samples it (1 - C(3,2)/C(4,2)
    # = half the draws); well above its uniform 1/4 share.
    assert hits > 100, hits


def test_prefix_affinity_key_stable_and_head_only():
    key = prefix_affinity_key([3, 1, 4, 1, 5, 9, 2, 6], 16)
    # Pinned literal (the JAX package's): blake2b is process- and
    # run-stable, so both routers map the same prompt heads to the same
    # replicas.
    assert key == "9757941b9a901cd3"
    # numpy-ish inputs hash identically to plain ints.
    assert prefix_affinity_key((3, 1, 4, 1, 5, 9, 2, 6), 16) == key
    assert prefix_affinity_key(np.array([3, 1, 4, 1, 5, 9, 2, 6]), 16) == key
    # Only the head participates: same first 4 tokens, different tails.
    a = prefix_affinity_key([1, 2, 3, 4, 7, 8], 4)
    b = prefix_affinity_key([1, 2, 3, 4, 9, 10, 11], 4)
    assert a == b
    assert prefix_affinity_key([1, 2, 3, 5, 7, 8], 4) != a
    assert prefix_affinity_key([], 16) is None


def test_rendezvous_pick_stable_and_minimal_remap():
    names = [f"replica-{i}" for i in range(5)]
    keys = [f"k{i}" for i in range(200)]
    placed = {k: rendezvous_pick(k, names) for k in keys}
    # Deterministic: same inputs, same picks.
    assert placed == {k: rendezvous_pick(k, names) for k in keys}
    # Losing one replica remaps ONLY the keys that lived on it.
    lost = "replica-2"
    survivors = [n for n in names if n != lost]
    for k in keys:
        if placed[k] != lost:
            assert rendezvous_pick(k, survivors) == placed[k]


# ------------------------------------------------------ ReplicaSupervisor


def test_supervisor_threshold_then_restart_verdict():
    sup = ReplicaSupervisor(fail_threshold=3, max_restarts=2)
    sup.record_poll(False)
    sup.record_poll(False)
    assert sup.verdict() == "none"  # below threshold: transient blip
    sup.record_poll(True)           # one good poll resets the count
    sup.record_poll(False)
    sup.record_poll(False)
    assert sup.verdict() == "none"
    sup.record_poll(False)
    assert sup.verdict() == "restart"


def test_supervisor_budget_exhaustion_quarantines():
    sup = ReplicaSupervisor(
        fail_threshold=1, max_restarts=2, backoff_base_s=0.5,
        backoff_factor=2.0, backoff_max_s=30.0,
    )
    sup.record_poll(False)
    assert sup.verdict() == "restart"
    assert sup.record_restart() == 0.5
    sup.record_poll(False)
    assert sup.verdict() == "restart"
    assert sup.record_restart() == 1.0  # exponential backoff
    sup.record_poll(False)
    assert sup.verdict() == "quarantine"  # budget burned, never re-restart
    assert sup.summary()["total_restarts"] == 2


def test_supervisor_progress_resets_budget():
    """A replica that comes back READY made progress — only back-to-back
    failures burn the budget."""
    sup = ReplicaSupervisor(fail_threshold=1, max_restarts=2)
    for _ in range(10):  # far past max_restarts in total
        sup.record_poll(False)
        assert sup.verdict() == "restart"
        sup.record_restart()
        sup.record_ready()  # progress: consecutive count resets
    assert sup.summary()["total_restarts"] == 10
    assert sup.summary()["consecutive_restarts"] == 0


def test_supervisor_backoff_caps():
    sup = ReplicaSupervisor(
        fail_threshold=1, max_restarts=10,
        backoff_base_s=1.0, backoff_factor=10.0, backoff_max_s=5.0,
    )
    assert sup.record_restart() == 1.0
    assert sup.record_restart() == 5.0  # capped, not 10.0
    assert sup.record_restart() == 5.0


# ----------------------------------------- in-process fleets (real HTTP)


class _StubEngine:
    max_batch = 8

    def validate(self, payload):
        if "input_ids" not in payload:
            raise RequestError("input_ids required")

    def run_batch(self, payloads):
        return [
            {"pred_ids": [int(t) for t in p["input_ids"]], "score": 0.0}
            for p in payloads
        ]


class _StubStack:
    """One in-process replica: the port's Client + HTTP server on an
    ephemeral port."""

    def __init__(self):
        self.client = Client(
            _StubEngine(), BatcherConfig(max_batch=8, max_delay_ms=1.0)
        )
        self.server = build_http_server(self.client, port=0)
        self.thread = threading.Thread(
            target=self.server.serve_forever, daemon=True
        )
        self.thread.start()
        host, port = self.server.server_address
        self.url = f"http://{host}:{port}"

    def stop(self):
        self.server.shutdown()
        self.server.server_close()
        self.client.close()
        self.thread.join(timeout=5)


@pytest.fixture()
def stub_fleet():
    """Three adopted in-process replicas behind a fast-polling router."""
    stacks = [_StubStack() for _ in range(3)]
    recorder = FlightRecorder(capacity=256)
    router = Router(
        [(f"replica-{i}", s.url, None) for i, s in enumerate(stacks)],
        RouterConfig(
            poll_interval_s=0.05, poll_timeout_s=2.0, fail_threshold=2,
            max_retries=2, request_timeout_s=10.0, affinity_tokens=4,
        ),
        recorder=recorder,
    )
    router.start()
    assert router.wait_ready(3, timeout=10)
    yield router, stacks, recorder
    router.close()
    for s in stacks:
        try:
            s.stop()
        except Exception:
            pass


def test_router_routes_and_labels_replica(stub_fleet):
    router, _, _ = stub_fleet
    code, body = router.route("/v1/mlm", {"input_ids": [1, 2, 3]})
    assert code == 200
    assert body["pred_ids"] == [1, 2, 3]
    assert body["replica"].startswith("replica-")
    assert body["request_id"]
    z = router.fleetz()
    assert z["requests"] == 1
    assert z["n_ready"] == 3


def test_router_affinity_pins_prompt_head(stub_fleet):
    """Same prompt head -> same replica, across many requests and
    regardless of tail content (the prefix-cache warmth contract)."""
    router, _, _ = stub_fleet
    served = set()
    for tail in range(12):
        code, body = router.route(
            "/v1/mlm", {"input_ids": [5, 6, 7, 8, 100 + tail]}
        )
        assert code == 200
        served.add(body["replica"])
    assert len(served) == 1, served
    # A different head may land elsewhere; with 64 heads at least one
    # must (rendezvous spreads keys across all replicas).
    heads = {
        router.route("/v1/mlm", {"input_ids": [h, h + 1]})[1]["replica"]
        for h in range(0, 128, 2)
    }
    assert len(heads) > 1, heads


def test_router_bad_request_is_final_not_retried(stub_fleet):
    router, _, _ = stub_fleet
    code, body = router.route("/v1/mlm", {"wrong": True})
    assert code == 400
    assert router.fleetz()["retries"] == 0  # malformed everywhere: no hops


def test_router_failover_onto_survivor(stub_fleet):
    router, stacks, recorder = stub_fleet
    stacks[0].stop()  # connection refused from now on
    # Until the poll threshold flips it down, routing may still pick the
    # dead replica — every request must still succeed via failover.
    for i in range(20):
        code, body = router.route("/v1/mlm", {"input_ids": [i]})
        assert code == 200, body
    # The poll loop marks it lost (adopted replica: down, not restarted).
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        states = {
            r["name"]: r["state"] for r in router.fleetz()["replicas"]
        }
        if states["replica-0"] == "down":
            break
        time.sleep(0.05)
    assert states["replica-0"] == "down", states
    kinds = [e["kind"] for e in recorder.events()]
    assert "replica_lost" in kinds


def test_router_sheds_with_request_id_when_fleet_is_gone(stub_fleet):
    router, stacks, _ = stub_fleet
    for s in stacks:
        s.stop()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        if router.fleetz()["n_ready"] == 0:
            break
        time.sleep(0.05)
    code, body = router.route("/v1/mlm", {"input_ids": [1]})
    assert code == 503
    assert body["shed"] is True
    assert body["request_id"]  # minted at the door: shed load stays
    assert router.fleetz()["shed"] >= 1  # attributable


def test_router_retry_bound_is_exact(monkeypatch):
    """max_retries bounds the failover hops: attempts = 1 + max_retries,
    never more, each on a distinct replica."""
    calls = []

    def dead_post(url, payload, rid, timeout):
        calls.append(url)
        raise OSError("synthetic transport failure")

    monkeypatch.setattr(router_mod, "_post_json", dead_post)
    router = Router(
        [(f"replica-{i}", f"http://127.0.0.1:{59000 + i}", None)
         for i in range(4)],
        RouterConfig(max_retries=2, seed=0),
    )
    # Force routable state without a poll thread.
    with router._lock:
        for r in router.replicas:
            r.state = "ready"
    code, body = router.route("/v1/mlm", {"input_ids": [1]})
    assert code == 503 and body["shed"] is True
    assert len(calls) == 3  # 1 attempt + 2 failover hops
    assert len(set(calls)) == 3  # all distinct replicas
    assert router.fleetz()["retries"] == 2


def test_router_drain_aware_routing(stub_fleet):
    """A draining replica leaves the routable set (poll sees the 503
    body) but is NOT restarted — draining is intentional, not a loss."""
    router, stacks, recorder = stub_fleet
    stacks[0].client.start_draining()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        states = {
            r["name"]: r["state"] for r in router.fleetz()["replicas"]
        }
        if states["replica-0"] == "draining":
            break
        time.sleep(0.05)
    assert states["replica-0"] == "draining", states
    for i in range(20):
        code, body = router.route("/v1/mlm", {"input_ids": [i]})
        assert code == 200
        assert body["replica"] != "replica-0"
    assert "replica_lost" not in [e["kind"] for e in recorder.events()]


def test_router_door_backpressure():
    router = Router(
        [("replica-0", "http://127.0.0.1:59999", None)],
        RouterConfig(max_in_flight_per_replica=1),
    )
    with router._lock:
        router.replicas[0].state = "ready"
        router.replicas[0].in_flight = 1  # at the cap
    code, body = router.route("/v1/mlm", {"input_ids": [1]})
    assert code == 429
    assert body["retry_after_s"] > 0
    assert body["request_id"]
    assert router.fleetz()["door_429"] == 1


def test_router_http_face(stub_fleet):
    router, _, _ = stub_fleet
    front = build_router_server(router, port=0)
    t = threading.Thread(target=front.serve_forever, daemon=True)
    t.start()
    base = "http://%s:%d" % front.server_address
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            assert r.status == 200
            assert json.loads(r.read())["n_ready"] == 3
        with urllib.request.urlopen(base + "/fleetz", timeout=10) as r:
            z = json.loads(r.read())
            assert len(z["replicas"]) == 3
        req = urllib.request.Request(
            base + "/v1/mlm",
            data=json.dumps({"input_ids": [4, 5]}).encode(),
            headers={"Content-Type": "application/json",
                     "X-Request-Id": "fixed-id"},
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=10) as r:
            body = json.loads(r.read())
            assert body["pred_ids"] == [4, 5]
            assert body["request_id"] == "fixed-id"
            assert body["replica"].startswith("replica-")
        with urllib.request.urlopen(
            base + "/metrics?format=prom", timeout=10
        ) as r:
            text = r.read().decode()
            assert "router_replica_up{" in text
            assert "router_requests_total{" in text
        # The operator drain: every replica answers with its progress.
        req = urllib.request.Request(base + "/drainz", data=b"{}", method="POST")
        with urllib.request.urlopen(req, timeout=10) as r:
            body = json.loads(r.read())
        assert body["draining"] is True
        assert set(body["progress"]) == {"replica-0", "replica-1", "replica-2"}
        assert all(p["queued"] == 0 for p in body["progress"].values())
    finally:
        front.shutdown()
        front.server_close()
        t.join(timeout=5)


# ------------------------------------------------- sanitizer soak


def test_router_race_soak():
    """Concurrent routing + the poll thread under the race sanitizer:
    every access to the router's declared shared state must be
    happens-before ordered. The router is BUILT inside the context so
    its poll thread is tracked."""
    stacks = [_StubStack() for _ in range(2)]
    try:
        with sanitize_races(modules=[router_mod]) as san:
            router = Router(
                [(f"replica-{i}", s.url, None)
                 for i, s in enumerate(stacks)],
                RouterConfig(
                    poll_interval_s=0.02, fail_threshold=2,
                    request_timeout_s=10.0,
                ),
            )
            router.start()
            assert router.wait_ready(2, timeout=10)
            errs = []

            def worker(base):
                try:
                    for i in range(12):
                        code, _ = router.route(
                            "/v1/mlm", {"input_ids": [base, i]}
                        )
                        assert code == 200
                except Exception as e:  # noqa: BLE001
                    errs.append(e)

            ts = [
                threading.Thread(target=worker, args=(k,), daemon=True)
                for k in range(4)
            ]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
            router.close()
        assert not errs, errs
        san.assert_clean()
    finally:
        for s in stacks:
            s.stop()


# ------------------------------------- 2-process kill-and-failover drill


def _stub_ports(n: int) -> list[int]:
    return [_free_port() for _ in range(n)]


@pytest.mark.slow
def test_kill_and_failover_two_processes(tmp_path):
    """The chaos headline over real processes: SIGKILL one of two spawned
    replicas mid-traffic; every request still answers 200 (failover onto
    the survivor) and the router restarts the dead replica within its
    budget."""
    ports = _stub_ports(2)
    helper = str(REPO_ROOT / "tests" / "_torch_router_replica.py")

    def make_cmd(name, port):
        return [sys.executable, helper, str(port), "v1"]

    recorder = FlightRecorder(capacity=1024)
    router = Router(
        [
            (f"replica-{i}", f"http://127.0.0.1:{p}",
             make_cmd(f"replica-{i}", p))
            for i, p in enumerate(ports)
        ],
        RouterConfig(
            poll_interval_s=0.1, poll_timeout_s=2.0, fail_threshold=2,
            max_restarts=3, backoff_base_s=0.2, start_grace_s=120.0,
            request_timeout_s=30.0,
        ),
        recorder=recorder,
        log_dir=tmp_path,
    )
    try:
        router.start()
        assert router.wait_ready(2, timeout=90), router.fleetz()
        failures = []
        stop = threading.Event()

        def traffic():
            i = 0
            while not stop.is_set():
                code, body = router.route(
                    "/v1/mlm", {"input_ids": [i % 50, (i * 7) % 50]}
                )
                if code != 200:
                    failures.append((code, body))
                i += 1
                time.sleep(0.005)

        t = threading.Thread(target=traffic, daemon=True)
        t.start()
        time.sleep(0.5)  # traffic flowing on both replicas
        victim = router.replicas[0]
        victim.proc.send_signal(signal.SIGKILL)
        deadline = time.monotonic() + 90
        restarted = False
        while time.monotonic() < deadline:
            z = router.fleetz()
            rep = z["replicas"][0]
            if (
                rep["supervisor"]["total_restarts"] >= 1
                and rep["state"] == "ready"
            ):
                restarted = True
                break
            time.sleep(0.1)
        time.sleep(0.5)  # traffic lands on the restarted replica too
        stop.set()
        t.join(timeout=30)
        assert restarted, router.fleetz()
        assert not failures, failures[:5]
        kinds = [e["kind"] for e in recorder.events()]
        assert "replica_lost" in kinds
        assert "replica_restart" in kinds
        assert kinds.count("router_spawn") >= 3  # 2 spawns + 1 relaunch
    finally:
        router.close()


@pytest.mark.slow
def test_hot_swap_two_processes_zero_loss(tmp_path):
    """Rolling checkpoint hot-swap across 2 real replicas under traffic:
    zero request failures, and every replica comes back on the new tag."""
    ports = _stub_ports(2)
    helper = str(REPO_ROOT / "tests" / "_torch_router_replica.py")
    recorder = FlightRecorder(capacity=1024)
    router = Router(
        [
            (f"replica-{i}", f"http://127.0.0.1:{p}",
             [sys.executable, helper, str(p), "v1"])
            for i, p in enumerate(ports)
        ],
        RouterConfig(
            poll_interval_s=0.1, fail_threshold=2, start_grace_s=120.0,
            ready_timeout_s=120.0, drain_timeout_s=60.0,
            request_timeout_s=30.0,
        ),
        recorder=recorder,
        log_dir=tmp_path,
    )
    try:
        router.start()
        assert router.wait_ready(2, timeout=90), router.fleetz()
        assert {r.tag for r in router.replicas} == {"v1"}
        failures = []
        stop = threading.Event()

        def traffic():
            i = 0
            while not stop.is_set():
                code, body = router.route(
                    "/v1/mlm", {"input_ids": [i % 50]}
                )
                if code != 200:
                    failures.append((code, body))
                i += 1
                time.sleep(0.005)

        t = threading.Thread(target=traffic, daemon=True)
        t.start()
        time.sleep(0.3)

        def new_cmd(replica):
            port = replica.base_url.rsplit(":", 1)[1]
            return [sys.executable, helper, port, "v2"]

        out = router.hot_swap(new_cmd, expected_tag="v2")
        time.sleep(0.3)
        stop.set()
        t.join(timeout=30)
        assert len(out["swapped"]) == 2
        assert not failures, failures[:5]
        with router._lock:
            tags = {r.tag for r in router.replicas}
        assert tags == {"v2"}, tags
        stages = [
            (e.get("replica"), e["stage"])
            for e in recorder.events() if e["kind"] == "hot_swap"
        ]
        assert ("replica-0", "drain") in stages
        assert ("replica-1", "ready") in stages
        assert (None, "done") in stages
    finally:
        router.close()


# ------------------------------------------ the port against the JAX router


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_pickers_equal_jax(seed):
    """The four pure pickers, port against JAX on the same seeded loads,
    prompts and keys: the same p2c draws from the same
    ``random.Random(seed)``, the same affinity keys and rendezvous picks."""
    gen = np.random.default_rng(seed)
    rng_p, rng_j = random.Random(seed), random.Random(seed)
    for _ in range(64):
        n = int(gen.integers(1, 8))
        status = {k: int(v) for k, v in zip(("queue_depth", "in_flight", "slots_active"),
                                            gen.integers(0, 5, 3)) if gen.random() < 0.8}
        assert replica_load(status) == jax_router.replica_load(status)
        loads = [float(x) for x in gen.integers(0, 6, n)]
        assert pick_power_of_two(loads, rng_p) == jax_router.pick_power_of_two(loads, rng_j)
        prompt = gen.integers(0, 50_000, int(gen.integers(0, 40)))
        k = int(gen.integers(0, 24))
        key = prefix_affinity_key(prompt, k)
        assert key == jax_router.prefix_affinity_key(prompt, k)
        names = [f"replica-{i}" for i in range(n)]
        if key is not None:
            assert rendezvous_pick(key, names) == jax_router.rendezvous_pick(key, names)
    assert rng_p.getstate() == rng_j.getstate()


def _ready(router) -> None:
    with router._lock:
        for r in router.replicas:
            r.state = "ready"


@pytest.fixture(scope="module")
def stub_pair():
    """Four in-process port replicas both routers front."""
    stacks = [_StubStack() for _ in range(4)]
    yield stacks
    for s in stacks:
        s.stop()


@pytest.mark.parametrize("affinity_tokens", [0, 4])
def test_routing_sequence_equals_jax(stub_pair, affinity_tokens):
    """A port Router and a JAX Router with the same config and seed drive
    the same request sequence over the same stubs (states set ready, no
    poll thread, so only the seeded draws and the prompts decide): the
    same replica for every request, and ``fleetz()`` and ``families()``
    with the same keys and names."""
    specs = [(f"replica-{i}", s.url, None) for i, s in enumerate(stub_pair)]
    cfg = dict(seed=11, affinity_tokens=affinity_tokens, request_timeout_s=10.0)
    port = Router(specs, RouterConfig(**cfg))
    jax = jax_router.Router(specs, jax_router.RouterConfig(**cfg))
    _ready(port)
    _ready(jax)
    gen = np.random.default_rng(5)
    heads = [gen.integers(0, 100, 6) for _ in range(5)]
    picks = {"port": [], "jax": []}
    for i in range(40):
        ids = [int(t) for t in np.concatenate([heads[i % 5], gen.integers(0, 100, 3)])]
        for name, r in (("port", port), ("jax", jax)):
            code, body = r.route("/v1/mlm", {"input_ids": ids}, request_id=f"seq-{i}")
            assert code == 200 and body["pred_ids"] == ids
            picks[name].append(body["replica"])
    assert picks["port"] == picks["jax"]
    assert len(set(picks["port"])) > 1
    zp, zj = port.fleetz(), jax.fleetz()
    assert set(zp) == set(zj)
    assert [set(r) for r in zp["replicas"]] == [set(r) for r in zj["replicas"]]
    assert [set(r["supervisor"]) for r in zp["replicas"]] == [
        set(r["supervisor"]) for r in zj["replicas"]]
    assert [r["requests"] for r in zp["replicas"]] == [r["requests"] for r in zj["replicas"]]
    assert [f.name for f in port.families()] == [f.name for f in jax.families()]
    port.close()
    jax.close()


def _scripted_transport(script: dict, calls: list, real=None):
    """A ``_post_json`` stand-in: each URL answers from ``script`` (a list
    of outcomes consumed in order: ``(code, body)`` or an exception), or
    through ``real`` when the URL has no script."""
    lock = threading.Lock()

    def post(url, payload, rid, timeout):
        with lock:
            calls.append((url, json.dumps(payload, sort_keys=True), rid))
            outcomes = script.get(url)
            out = outcomes.pop(0) if outcomes else None
        if out is None:
            if real is None:
                raise OSError(f"no route to {url}")
            return real(url, payload, rid, timeout)
        if isinstance(out, BaseException):
            raise out
        return out

    return post


def _migration_script(victim: str, hop: str, final: str):
    """The victim answers ``migrated`` to ``hop``; ``hop``'s stream_wait
    says 504 (still generating), then ``migrated`` onward to ``final``,
    whose stream_wait answers the finished stream."""
    tokens = [7, 3, 9, 1, 4, 4, 2, 8]
    return {
        victim + "/v1/generate": [(200, {"status": "migrated", "target": hop[7:],
                                         "tokens": tokens[:2]})],
        hop + "/v1/stream_wait": [(504, {"error": "still generating"}),
                                  (200, {"status": "migrated", "target": final[7:],
                                         "tokens": tokens[:5]})],
        final + "/v1/stream_wait": [(200, {"tokens": tokens, "n_tokens": len(tokens)})],
    }, tokens


def _pin(prefix_names, target, k=4, n=1, seed=0):
    gen = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        ids = [int(t) for t in gen.integers(0, 100, 8)]
        if rendezvous_pick(prefix_affinity_key(ids, k), sorted(prefix_names)) == target:
            out.append(ids)
    return out


def test_collect_migrated_follows_hops_like_jax(monkeypatch):
    """``route``'s collection of a ``migrated`` answer: ``/v1/stream_wait``
    on the target, through a 504 (still generating) and an onward hop, to
    the finished stream. The port and the JAX router over the same
    scripted transport make the same calls and answer the same body."""
    urls = [f"http://127.0.0.1:{59100 + i}" for i in range(3)]
    specs = [(f"replica-{i}", u, None) for i, u in enumerate(urls)]
    (ids,) = _pin([s[0] for s in specs], "replica-0")
    results = {}
    for name, mod in (("port", router_mod), ("jax", jax_router)):
        script, tokens = _migration_script(urls[0], urls[1], urls[2])
        calls = []
        monkeypatch.setattr(mod, "_post_json", _scripted_transport(script, calls))
        r = mod.Router(specs, mod.RouterConfig(affinity_tokens=4, request_timeout_s=5.0))
        _ready(r)
        code, body = r.route("/v1/generate", {"input_ids": ids}, request_id="mig-1")
        results[name] = (code, body, calls, r.fleetz()["retries"])
        assert code == 200 and body["tokens"] == tokens
        assert body["request_id"] == "mig-1" and body["replica"] == "replica-0"
    assert results["port"] == results["jax"]
    calls = results["port"][2]
    assert [c[0] for c in calls] == [urls[0] + "/v1/generate", urls[1] + "/v1/stream_wait",
                                     urls[1] + "/v1/stream_wait", urls[2] + "/v1/stream_wait"]
    assert results["port"][3] == 0  # collection is not a failover


def test_replay_with_resume_tokens_when_target_is_gone_like_jax(monkeypatch):
    """The migrated stream's target cannot answer (connection refused):
    the request replays through normal routing with the tokens the client
    was shown as ``resume_tokens``. Port and JAX: the same calls, the same
    replay payload, one retry."""
    urls = [f"http://127.0.0.1:{59200 + i}" for i in range(3)]
    specs = [(f"replica-{i}", u, None) for i, u in enumerate(urls)]
    (ids,) = _pin([s[0] for s in specs], "replica-0", seed=1)
    shown = [5, 6, 7]
    results = {}
    for name, mod in (("port", router_mod), ("jax", jax_router)):
        script = {
            urls[0] + "/v1/generate": [(200, {"status": "migrated", "target": urls[1][7:],
                                              "tokens": shown}),
                                       OSError("victim gone")],
            urls[1] + "/v1/stream_wait": [OSError("refused")],
            urls[1] + "/v1/generate": [OSError("refused")],
            urls[2] + "/v1/generate": [(200, {"tokens": shown + [8, 9], "n_tokens": 5})],
        }
        calls = []
        monkeypatch.setattr(mod, "_post_json", _scripted_transport(script, calls))
        r = mod.Router(specs, mod.RouterConfig(affinity_tokens=4, request_timeout_s=5.0,
                                               max_retries=2))
        _ready(r)
        code, body = r.route("/v1/generate", {"input_ids": ids}, request_id="mig-2")
        results[name] = (code, body, calls, r.fleetz()["retries"])
    assert results["port"] == results["jax"]
    code, body, calls, retries = results["port"]
    assert code == 200 and body["tokens"] == shown + [8, 9]
    replays = [json.loads(p) for url, p, _ in calls if url.endswith("/v1/generate")][1:]
    assert replays and all(p["resume_tokens"] == shown and p["input_ids"] == ids
                           for p in replays)
    assert retries >= 2  # the replay, then the failover off the dead victim


def _poll_sequence(mod, recorder_cls, faults, plan_events, stacks, passes: int):
    plan = faults.FaultPlan(tuple(faults.FaultEvent("probe_timeout", s) for s in plan_events),
                            seed=None)
    recorder = recorder_cls(capacity=512)
    router = mod.Router([(f"replica-{i}", s.url, None) for i, s in enumerate(stacks)],
                        mod.RouterConfig(fail_threshold=2, poll_timeout_s=5.0,
                                         start_grace_s=0.0),
                        recorder=recorder)
    router.fault_injector = faults.FaultInjector(plan, recorder=recorder)
    seq = []
    for _ in range(passes):
        router._poll_once()
        seq.append(tuple(r["state"] for r in router.fleetz()["replicas"]))
    events = [(e["kind"], e.get("replica")) for e in recorder.events()
              if e["kind"] in ("replica_lost", "fault_injected")]
    router.close()
    return seq, events


@pytest.mark.parametrize("plan_events", [(3, 5, 7), (2, 4, 5, 6, 11), (1, 2)])
def test_probe_timeout_plan_gives_jaxs_lost_and_ready_sequence(stub_pair, plan_events):
    """A ``probe_timeout`` plan (the router's ``--fault-plan``) on the
    port's router and on the JAX router over the same stubs, one poll pass
    at a time: the same state after every pass (lost at two swallowed
    probes in a row, back ``ready`` at the next answer) and the same
    ``replica_lost`` / ``fault_injected`` events."""
    stacks = stub_pair[:2]
    port = _poll_sequence(router_mod, FlightRecorder, port_faultinject, plan_events, stacks, 8)
    jax = _poll_sequence(jax_router, JaxFlightRecorder, jax_faultinject, plan_events, stacks, 8)
    assert port == jax
    seq, events = port
    assert sum(k == "fault_injected" for k, _ in events) == len(plan_events)
    if plan_events == (3, 5, 7):  # replica-0's 2nd, 3rd and 4th probes
        assert seq[2][0] == "down" and seq[4][0] == "ready"
        assert ("replica_lost", "replica-0") in events


# ------------------------------- real replicas: hot swap, replay, the CLI

LM_GEOM = ["--bert-layers", "1", "--bert-hidden", "48", "--bert-vocab", "64"]
MAX_NEW = 16


@pytest.fixture(scope="module")
def lm_fleet(tmp_path_factory):
    """A tiny ``lm_base`` checkpoint, a pacing plan, and survivor S: the
    fp32 ``cli.serve`` replica (``scripts/torch_mp_train.py --serve``'s
    ``lm_base_f32``) with ``--stream-migrate``, adopted by the tests."""
    from distributed_tensorflow_tpu_torch.cli.train import main

    root = tmp_path_factory.mktemp("router_fleet")
    ck = root / "ck"
    assert main(["--config=lm_base", "--device=cpu", *LM_GEOM, "--steps=2",
                 "--global-batch=8", f"--ckpt-dir={ck}"]) == 0
    plan = root / "pace.json"
    plan.write_text(json.dumps({"seed": None, "events": [
        {"kind": "slow_decode_step", "step": s, "duration_s": 0.05} for s in range(2, 2000)]}))

    def argv(port: int, *extra: str) -> list[str]:
        return [sys.executable, str(REPO_ROOT / "scripts" / "torch_mp_train.py"), "--serve",
                "--config", "lm_base_f32", "--ckpt-dir", str(ck), "--device", "cpu",
                "--port", str(port), *LM_GEOM, "--buckets", "32", "64", "--slots", "4",
                "--max-batch", "4", "--max-new-tokens", str(MAX_NEW), "--stream-migrate",
                *extra]

    s_port = _free_port()
    log = open(root / "s.log", "w")
    proc = subprocess.Popen(argv(s_port), cwd=REPO_ROOT, stdout=log, stderr=subprocess.STDOUT)
    url = f"http://127.0.0.1:{s_port}"
    try:
        _await_healthz(url, proc, root / "s.log")
        yield {"ck": ck, "plan": plan, "argv": argv, "s_url": url, "root": root}
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=T)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=T)
        log.close()


def _await_healthz(url: str, proc, log: Path, timeout: float = 120.0) -> None:
    deadline = time.monotonic() + timeout
    while True:
        assert proc.poll() is None, log.read_text()[-3000:]
        try:
            with urllib.request.urlopen(url + "/healthz", timeout=5) as r:
                if r.status == 200:
                    return
        except OSError:
            pass
        assert time.monotonic() < deadline, f"{url} not ready: {log.read_text()[-3000:]}"
        time.sleep(0.1)


def _generate(url: str, payload: dict, timeout: float = T) -> tuple[int, dict]:
    req = urllib.request.Request(url + "/v1/generate", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _lm_payloads(names, target: str, n: int, seed: int) -> list[dict]:
    gen = np.random.default_rng(seed)
    k = RouterConfig().affinity_tokens
    out = []
    while len(out) < n:
        ids = [int(t) for t in gen.integers(4, 64, int(gen.integers(17, 30)))]
        if rendezvous_pick(prefix_affinity_key(ids, k), sorted(names)) == target:
            i = len(out)
            out.append({"input_ids": ids, "max_new_tokens": MAX_NEW,
                        "temperature": 0.8 if i % 2 else 0.0, "seed": 40 + i})
    return out


def test_hot_swap_drain_deadline_migrates_live_streams(lm_fleet, tmp_path):
    """``hot_swap`` of the owned replica A (paced: its streams sit
    mid-generation) while 3 streams routed to it are live: the drain
    deadline moves them to the survivor S by ``/migratez``, ``route``
    collects each ``migrated`` answer by ``/v1/stream_wait``, and every
    stream equals S's uninterrupted one (fp32); A comes back on the new
    tag after the drain, migrate, restart and ready stages."""
    argv = lm_fleet["argv"]
    a_port = _free_port()
    recorder = FlightRecorder(capacity=1024)
    router = Router(
        [("a", f"http://127.0.0.1:{a_port}",
          argv(a_port, "--fault-plan", str(lm_fleet["plan"]), "--tag", "v1")),
         ("s", lm_fleet["s_url"], None)],
        RouterConfig(poll_interval_s=0.1, start_grace_s=120.0, drain_timeout_s=0.2,
                     ready_timeout_s=120.0, request_timeout_s=60.0,
                     affinity_max_imbalance=1e9),
        recorder=recorder, log_dir=tmp_path)
    payloads = _lm_payloads(["a", "s"], "a", 3, seed=3)
    want = []
    for p in payloads:
        code, body = _generate(lm_fleet["s_url"], p)
        assert code == 200
        want.append(body["tokens"])
    try:
        router.start()
        assert router.wait_ready(2, timeout=120), router.fleetz()
        got = {}

        def one(i):
            got[i] = router.route("/v1/generate", payloads[i], request_id=f"swap-{i}")

        threads = [threading.Thread(target=one, args=(i,)) for i in range(len(payloads))]
        for t in threads:
            t.start()
        a_url = f"http://127.0.0.1:{a_port}"
        deadline = time.monotonic() + T
        while True:
            with urllib.request.urlopen(a_url + "/statusz", timeout=5) as r:
                st = json.loads(r.read())["batcher"]
            if st["slots_active"] == 3 and st["tokens_remaining"] <= 3 * (MAX_NEW - 2):
                break
            assert time.monotonic() < deadline, st
            time.sleep(0.005)
        out = router.hot_swap(
            lambda r: argv(a_port, "--fault-plan", str(lm_fleet["plan"]), "--tag", "v2"),
            expected_tag="v2")
        for t in threads:
            t.join(timeout=T)
        assert out["swapped"] == [{"replica": "a", "tag": "v2"}]
        for i in range(len(payloads)):
            code, body = got[i]
            assert code == 200, body
            assert body.get("status") != "migrated" and body["tokens"] == want[i], (i, body)
            assert body["request_id"] == f"swap-{i}"
        stages = [e["stage"] for e in recorder.events()
                  if e["kind"] == "hot_swap" and e.get("replica") == "a"]
        assert stages == ["drain", "migrate", "restart", "ready"]
        mig = [e for e in recorder.events() if e.get("stage") == "migrate"][0]
        assert mig["exported"] == mig["migrated"] == 3
        z = router.fleetz()
        assert z["stream_migrations"] == 1 and z["replicas"][0]["tag"] == "v2"
        assert z["replicas"][0]["state"] == "ready"
    finally:
        router.close()


def test_resume_tokens_replay_repeats_and_skips_no_token(lm_fleet):
    """The replay ``route`` sends when a migrated stream's target cannot
    answer: the prompt with the tokens already shown as
    ``resume_tokens``. On a real replica the answer's token list equals
    the uninterrupted stream, greedy and sampled, wherever the cut falls."""
    url = lm_fleet["s_url"]
    for p in _lm_payloads(["s"], "s", 2, seed=7):
        code, body = _generate(url, p)
        assert code == 200
        full = body["tokens"]
        for cut in (1, 5, MAX_NEW - 1):
            code, body = _generate(url, {**p, "resume_tokens": full[:cut]})
            assert code == 200 and body["tokens"] == full, (cut, body)


def test_router_replays_onto_a_real_replica(lm_fleet, monkeypatch):
    """``route`` end to end: the first replica answers ``migrated`` to a
    target that is gone, and the replay lands on the real survivor with
    ``resume_tokens``: the stream comes back whole, no token repeated or
    skipped."""
    url = lm_fleet["s_url"]
    (p,) = _lm_payloads(["ghost", "s"], "ghost", 1, seed=9)
    code, body = _generate(url, p)
    full = body["tokens"]
    ghost = f"http://127.0.0.1:{_free_port()}"
    dead = f"127.0.0.1:{_free_port()}"
    calls = []
    script = {ghost + "/v1/generate": [(200, {"status": "migrated", "target": dead,
                                              "tokens": full[:6]})]}
    monkeypatch.setattr(router_mod, "_post_json",
                        _scripted_transport(script, calls, real=router_mod._post_json))
    router = Router([("ghost", ghost, None), ("s", url, None)],
                    RouterConfig(request_timeout_s=T))
    _ready(router)
    code, body = router.route("/v1/generate", p, request_id="replay-1")
    assert code == 200 and body["tokens"] == full, body
    assert body["replica"] == "s"
    replay = [json.loads(pl) for u, pl, _ in calls if u == url + "/v1/generate"]
    assert replay and replay[0]["resume_tokens"] == full[:6]
    router.close()


def test_cli_router_sigterm_leaves_no_replica(lm_fleet, tmp_path):
    """``cli.router`` with one spawned ``cli.serve`` replica (on the CPU:
    the serve CLI's own ``--device cpu`` after ``--``) and S adopted, its
    ``--fault-plan`` arming ``probe_timeout``: ready, one generate through
    it, then SIGTERM: exit 0 and the spawned replica gone."""
    port, base = _free_port(), _free_port()
    plan = tmp_path / "probe.json"
    plan.write_text(json.dumps({"seed": None, "events": [{"kind": "probe_timeout", "step": 1}]}))
    log = tmp_path / "router.log"
    with open(log, "w") as fh:
        proc = subprocess.Popen(
            [sys.executable, "-m", "distributed_tensorflow_tpu_torch.cli.router",
             "--port", str(port), "--replicas", "1", "--replica-base-port", str(base),
             "--adopt", lm_fleet["s_url"], "--poll-interval", "0.1",
             "--fault-plan", str(plan), "--log-dir", str(tmp_path / "replicas"),
             "--", "--config", "lm_base", "--ckpt-dir", str(lm_fleet["ck"]), "--device", "cpu",
             *LM_GEOM, "--buckets", "32", "--slots", "2", "--max-new-tokens", str(MAX_NEW)],
            cwd=REPO_ROOT, stdout=fh, stderr=subprocess.STDOUT)
    url = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 120
        while True:
            assert proc.poll() is None, log.read_text()[-3000:]
            try:
                with urllib.request.urlopen(url + "/healthz", timeout=5) as r:
                    if json.loads(r.read())["n_ready"] == 2:
                        break
            except OSError:
                pass
            assert time.monotonic() < deadline, log.read_text()[-3000:]
            time.sleep(0.1)
        with urllib.request.urlopen(url + "/fleetz", timeout=5) as r:
            z = json.loads(r.read())
        owned = [rep for rep in z["replicas"] if rep["owned"]]
        assert [rep["name"] for rep in z["replicas"]] == ["replica-0", "adopted-0"]
        pid = owned[0]["pid"]
        code, body = _generate(url, {"input_ids": [5, 9, 2, 44, 17], "max_new_tokens": 4})
        assert code == 200 and body["n_tokens"] == 4 and body["replica"] in (
            "replica-0", "adopted-0")
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=T) == 0, log.read_text()[-3000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=T)
    text = log.read_text()
    assert "router fault plan armed: 1 scheduled events" in text
    assert "shutting down fleet" in text
    assert not Path(f"/proc/{pid}").exists() or _is_zombie_of_nobody(pid)


def _is_zombie_of_nobody(pid: int) -> bool:
    try:
        state = Path(f"/proc/{pid}/stat").read_text().split()[2]
    except OSError:
        return True
    return state == "Z"


def test_cli_router_refuses_without_replicas(capsys):
    from distributed_tensorflow_tpu_torch.cli.router import main

    with pytest.raises(SystemExit) as e:
        main([])
    assert e.value.code == 2
    assert "need --replicas N (spawn) and/or --adopt URL" in capsys.readouterr().err
    with pytest.raises(SystemExit) as e:
        main(["--replicas", "2"])
    assert e.value.code == 2
    assert "spawn mode needs replica flags after --" in capsys.readouterr().err


def test_cli_router_fault_plan_spec_is_placed_like_serve(monkeypatch):
    """A key=value ``--fault-plan`` is placed within ``FAULT_PROBES``
    probe ordinals (the JAX CLI passes no horizon, so its spec form
    raises): the events both packages' ``FaultPlan.parse`` place for that
    spec and horizon."""
    from distributed_tensorflow_tpu_torch.cli import router as cli

    seen = {}

    class _Stop(Exception):
        pass

    def fake_start(self):
        seen["plan"] = self.fault_injector.plan
        raise _Stop

    monkeypatch.setattr(router_mod.Router, "start", fake_start)
    with pytest.raises(_Stop):
        cli.main(["--adopt", "http://127.0.0.1:1", "--fault-plan", "seed=7,probe_timeout=3"])
    want = port_faultinject.FaultPlan.parse("seed=7,probe_timeout=3", num_steps=cli.FAULT_PROBES)
    assert seen["plan"].events == want.events
    assert [e.kind for e in want.events] == ["probe_timeout"] * 3
    jax_plan = jax_faultinject.FaultPlan.parse("seed=7,probe_timeout=3",
                                               num_steps=cli.FAULT_PROBES)
    assert [(e.kind, e.step) for e in want.events] == [(e.kind, e.step) for e in jax_plan.events]
    with pytest.raises(ValueError, match="needs num_steps"):
        jax_faultinject.FaultPlan.parse("seed=7,probe_timeout=3")
