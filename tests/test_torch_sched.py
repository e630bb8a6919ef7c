"""The port's priority-preemptive slot scheduling: EDF admission, KV-page
parking, and pause/resume.

Mirrors the JAX package's ``tests/test_sched.py`` on the port's
``ContinuousBatcher`` and ``KVBlockPool``. The invariant: a stream parked
off its slot (its KV lane published into prefix-pool pages, or dropped for
a page-less park) and resumed by ``resume_tokens`` replay is bit-identical
to the same stream run uninterrupted. The stub engine makes that checkable
in closed form (the next token is a function of the cumulative sum of every
token so far), and the real-engine case runs the same scenario through the
JAX and the port's engines with chunked prefill, the prefix cache,
speculation and int8 weights and KV stacked: the parked-and-resumed streams
equal the solo ones and each other, exactly.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
from _torch_serve_common import CHUNKED, jax_engine, port_engine

from distributed_tensorflow_tpu.serve import BatcherConfig as JaxConfig
from distributed_tensorflow_tpu.serve import ContinuousBatcher as JaxBatcher
from distributed_tensorflow_tpu_torch.obs.flightrec import EVENT_KINDS, FlightRecorder
from distributed_tensorflow_tpu_torch.obs.metrics import ServeMetrics
from distributed_tensorflow_tpu_torch.obs.sanitizer import sanitize_races
from distributed_tensorflow_tpu_torch.serve import batcher as batcher_mod
from distributed_tensorflow_tpu_torch.serve import kvpool as kvpool_mod
from distributed_tensorflow_tpu_torch.serve.batcher import (
    Backpressure,
    BatcherConfig,
    ContinuousBatcher,
    DynamicBatcher,
    drain_retry_after_s,
)
from distributed_tensorflow_tpu_torch.serve.engine import RequestError
from distributed_tensorflow_tpu_torch.serve.kvpool import KVBlockPool

# ------------------------------------------------- resume-exact stub engine


class _SchedEngine:
    """Resume-exact decode stub: token t_{k+1} = f(S_k) where S_k is the
    cumulative sum of EVERY token so far (prompt + generated). Unlike the
    (prompt, k)-indexed stub in test_torch_serve_decode.py, this survives
    ``resume_tokens`` replay bit-exactly: a resumed prefill's effective
    prompt (original + generated-so-far) sums to exactly the S the
    uninterrupted stream had, so the continuation is identical."""

    def __init__(self, slots=2, max_batch=2, max_new_tokens=32,
                 step_delay_s=0.0):
        self.slots = slots
        self.max_batch = max_batch
        self.max_new_tokens = max_new_tokens
        self.step_delay_s = step_delay_s
        self.lock = threading.Lock()
        self._state = {}    # slot -> S (never cleared; next prefill resets)
        self.admitted = []  # effective-prompt tuples, in admission order
        self.events = []    # ("prefill"/"chunk"/"decode", slot-tuple)

    @staticmethod
    def next_token(S):
        return (S * 9973 + 12345) % 50 + 5

    def validate(self, payload):
        pass

    def bucket_for(self, n):
        if n <= 8:
            return 8
        if n <= 32:
            return 32
        raise ValueError(f"prompt of {n} exceeds the largest bucket")

    def prefill(self, admissions):
        with self.lock:
            toks = []
            for a in admissions:
                S = int(np.sum(a["input_ids"]))
                t = self.next_token(S)
                self._state[a["slot"]] = S + t
                self.admitted.append(tuple(int(x) for x in a["input_ids"]))
                toks.append(t)
            self.events.append(
                ("prefill", tuple(a["slot"] for a in admissions))
            )
        return ("prefill", toks)

    def decode(self, lengths, active, temps, seeds):
        with self.lock:
            toks = np.zeros(self.slots, np.int64)
            live = []
            for slot, on in enumerate(active):
                if not on or slot not in self._state:
                    continue
                S = self._state[slot]
                t = self.next_token(S)
                toks[slot] = t
                self._state[slot] = S + t
                live.append(slot)
            self.events.append(("decode", tuple(live)))
        return ("decode", toks)

    def fetch_step(self, handle):
        if self.step_delay_s:
            time.sleep(self.step_delay_s)
        return np.asarray(handle[1])


class _SchedChunkedEngine(_SchedEngine):
    """Chunked twin: prefill_chunks + insert_prefix + a real KVBlockPool,
    so the batcher walks the trie/pin/index/park path without device work.
    Cumulative-sum sampling as above — the final chunk's row carries the
    full effective prompt, which is all the state the engine needs."""

    def __init__(self, pool, chunk=4, **kw):
        super().__init__(**kw)
        self.prefill_chunk_size = chunk
        self.prefix_cache = pool
        self.inserted = []  # (slot, new_blocks) from insert_prefix

    def prefill_chunks(self, rows):
        with self.lock:
            toks = []
            for r in rows:
                if int(r["start"]) + int(r["n_tokens"]) >= int(r["length"]):
                    S = int(np.sum(r["input_ids"]))
                    t = self.next_token(S)
                    self._state[int(r["slot"])] = S + t
                    self.admitted.append(
                        tuple(int(x) for x in r["input_ids"])
                    )
                    toks.append(t)
                else:
                    toks.append(0)  # mid-prompt lane: nobody reads it
            self.events.append(
                ("chunk", tuple(int(r["slot"]) for r in rows))
            )
        return ("chunk", toks)

    def insert_prefix(self, slot, new_blocks):
        self.inserted.append((slot, tuple(new_blocks)))


def _expected(prompt, n):
    S, out = int(np.sum(prompt)), []
    for _ in range(n):
        t = _SchedEngine.next_token(S)
        out.append(t)
        S += t
    return out


def _poll(cond, timeout_s=10.0, msg="condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.002)
    raise AssertionError(f"timed out waiting for {msg}")


def _decode_steps(eng):
    with eng.lock:
        return sum(1 for k, s in eng.events if k == "decode" and s)


# ------------------------------------------------- Retry-After arithmetic


def test_drain_retry_after_arithmetic():
    """The 429 hint is drain arithmetic, not a constant: queued units over
    the observed service rate, floored at one flush window, capped."""
    # 20 tokens owed at 10 tok/s -> 2 s.
    assert drain_retry_after_s(20.0, 10.0, 0.008) == pytest.approx(2.0)
    # Faster drain than the floor -> the floor.
    assert drain_retry_after_s(1.0, 1000.0, 0.25) == pytest.approx(0.25)
    # A stall cannot send clients away for minutes: capped at 30 s.
    assert drain_retry_after_s(1e6, 1.0, 0.008) == pytest.approx(30.0)
    assert drain_retry_after_s(1e6, 1.0, 0.008, cap_s=5.0) == (
        pytest.approx(5.0)
    )
    # No drain observed in the window (or nothing queued): the floor is
    # the only honest answer.
    assert drain_retry_after_s(50.0, 0.0, 0.125) == pytest.approx(0.125)
    assert drain_retry_after_s(0.0, 10.0, 0.125) == pytest.approx(0.125)


def test_dynamic_backpressure_derives_retry_after():
    """DynamicBatcher's shed hint = queue depth / recent completion rate
    (requests over requests/s), not the old fixed flush window."""
    ev = threading.Event()

    def run_batch(payloads):
        ev.wait(10.0)
        return [{"ok": 1} for _ in payloads]

    m = ServeMetrics()
    m.ok_w.add(5.0)  # 5 completions in the 10 s window -> 0.5 req/s
    b = DynamicBatcher(
        run_batch,
        BatcherConfig(max_batch=1, max_delay_ms=8.0, max_queue=4),
        m,
    )
    try:
        exc = None
        for _ in range(8):
            try:
                b.submit({"input_ids": np.arange(1, 4)})
            except Backpressure as e:
                exc = e
                break
        assert exc is not None
        # 4 queued requests at 0.5 req/s -> 8 s (floor 8 ms, cap 30 s).
        assert exc.retry_after_s == pytest.approx(8.0, rel=0.05)
    finally:
        ev.set()
        b.close(drain=False)


def test_continuous_backpressure_derives_retry_after():
    """ContinuousBatcher's hint = tokens the queue still OWES over the
    recent token rate — a queue of heavy generations backs clients off
    longer than the same depth of light ones."""
    eng = _SchedEngine(slots=1, max_batch=1, step_delay_s=0.2)
    m = ServeMetrics()
    m.tokens_w.add(100.0)  # 100 tokens in the 10 s window -> 10 tok/s
    b = ContinuousBatcher(
        eng, BatcherConfig(max_batch=1, max_delay_ms=8.0, max_queue=2), m
    )
    try:
        b.submit({"input_ids": np.arange(1, 5), "max_new_tokens": 3})
        # Wait for the holder's admission so the next two genuinely queue.
        _poll(lambda: len(eng.admitted) == 1, msg="holder admission")
        b.submit({"input_ids": np.arange(2, 6), "max_new_tokens": 6})
        b.submit({"input_ids": np.arange(3, 7), "max_new_tokens": 14})
        with pytest.raises(Backpressure) as ei:
            b.submit({"input_ids": np.arange(4, 8), "max_new_tokens": 1})
        # Queue owes 6 + 14 = 20 tokens at 10 tok/s -> 2 s.
        assert ei.value.retry_after_s == pytest.approx(2.0, rel=0.05)
    finally:
        b.close(drain=False)


# ------------------------------------------------- config validation


def test_sched_config_validation():
    with pytest.raises(ValueError, match="sched"):
        BatcherConfig(sched="lifo")
    with pytest.raises(ValueError, match="preempt"):
        BatcherConfig(preempt=True)  # fifo cannot order deadline waiters
    with pytest.raises(ValueError, match="preempt_margin_ms"):
        BatcherConfig(sched="edf", preempt_margin_ms=-1.0)
    with pytest.raises(ValueError, match="default_priority"):
        BatcherConfig(default_priority=-1)
    # The flush batcher holds no slots to reorder or preempt.
    with pytest.raises(ValueError, match="DynamicBatcher"):
        DynamicBatcher(lambda p: [{}] * len(p), BatcherConfig(sched="edf"))
    # Flush admission only ever fills an EMPTY table: nothing to preempt.
    with pytest.raises(ValueError, match="admission"):
        ContinuousBatcher(
            _SchedEngine(slots=1),
            BatcherConfig(sched="edf", preempt=True),
            admission="flush",
        )


# ------------------------------------------------- admission ordering


def _order_scenario(sched):
    """One slot held busy, three waiters queued: (pri=1, no deadline),
    (pri=1, deadline), (pri=0, no deadline) — in that arrival order.
    Returns the effective-prompt admission order after the holder."""
    eng = _SchedEngine(slots=1, max_batch=1, step_delay_s=0.02)
    p_hold = np.arange(1, 5)
    p_a, p_b, p_c = np.arange(11, 15), np.arange(21, 25), np.arange(31, 35)
    with ContinuousBatcher(
        eng, BatcherConfig(max_batch=1, sched=sched)
    ) as b:
        f0 = b.submit({"input_ids": p_hold, "max_new_tokens": 8})
        _poll(lambda: len(eng.admitted) == 1, msg="holder admission")
        fa = b.submit({
            "input_ids": p_a, "max_new_tokens": 2, "priority": 1,
        })
        fb = b.submit({
            "input_ids": p_b, "max_new_tokens": 2, "priority": 1,
            "deadline_ms": 10_000,
        })
        fc = b.submit({
            "input_ids": p_c, "max_new_tokens": 2, "priority": 0,
        })
        for prompt, n, f in (
            (p_hold, 8, f0), (p_a, 2, fa), (p_b, 2, fb), (p_c, 2, fc),
        ):
            assert f.result(timeout=30)["tokens"] == _expected(prompt, n)
    return eng.admitted[1:], (tuple(p_a), tuple(p_b), tuple(p_c))


@pytest.mark.parametrize("sched", ["edf", "fifo"])
def test_admission_order(sched):
    """EDF: priority class dominates, earliest deadline wins within a
    class, deadline-less entries sort behind every deadline holder,
    whatever the arrival order. FIFO (the control arm): arrival order,
    blind to class and deadline."""
    order, (a, b_, c) = _order_scenario(sched)
    assert order == ([c, b_, a] if sched == "edf" else [a, b_, c])


# ------------------------------------------------- preempt -> resume parity


def test_preempt_pageless_resume_bit_parity():
    """A decoding low-priority victim parks page-less (no prefix pool on
    the monolithic-prefill stub), the urgent waiter takes its slot, and
    the victim resumes via resume_tokens replay — both streams bit-exact,
    and the books (status, metrics, flight recorder) all agree."""
    eng = _SchedEngine(slots=1, max_batch=1, step_delay_s=0.02)
    m = ServeMetrics()
    rec = FlightRecorder(capacity=256)
    p_vic, p_hi = np.arange(1, 5), np.arange(41, 45)
    b = ContinuousBatcher(
        eng,
        BatcherConfig(
            max_batch=1, sched="edf", preempt=True,
            preempt_margin_ms=1e6, default_priority=1,
        ),
        m, recorder=rec,
    )
    try:
        fv = b.submit({
            "input_ids": p_vic, "max_new_tokens": 10, "priority": 2,
        })
        # Let the victim generate a few tokens so the park carries a
        # non-empty resume prefix.
        _poll(lambda: _decode_steps(eng) >= 3, msg="victim progress")
        fh = b.submit({
            "input_ids": p_hi, "max_new_tokens": 3, "priority": 0,
            "deadline_ms": 5,
        })
        assert fh.result(timeout=30)["tokens"] == _expected(p_hi, 3)
        rv = fv.result(timeout=30)
        assert rv["tokens"] == _expected(p_vic, 10)
        assert rv["n_tokens"] == 10
        st = b.status()
    finally:
        b.close()
    sched = st["sched"]
    assert sched["policy"] == "edf" and sched["preempt"] is True
    assert sched["preempt_parked"] == 1
    assert sched["preempt_resumed"] == 1
    assert sched["preempt_aborted"] == 0
    assert m.preemptions.snapshot() == {"pageless": 1}
    # Three admissions: victim, waiter, victim's replay — whose effective
    # prompt is the original plus every token generated before the park.
    assert len(eng.admitted) == 3
    assert eng.admitted[1] == tuple(p_hi)
    assert eng.admitted[2][:len(p_vic)] == tuple(p_vic)
    assert len(eng.admitted[2]) > len(p_vic)
    kinds = [e["kind"] for e in rec.events()]
    assert "slot_preempt" in kinds and "slot_resume" in kinds
    pre = next(e for e in rec.events() if e["kind"] == "slot_preempt")
    res = next(e for e in rec.events() if e["kind"] == "slot_resume")
    assert pre["reason"] == "pageless" and pre["n_tokens"] >= 1
    assert res["rounds"] == 1 and res["resume_tokens"] == pre["n_tokens"]


def test_preempt_paged_resume_hits_parked_pages():
    """With a prefix pool, the park exports the victim's settled KV lane
    into pool pages; the resume's trie match then covers the parked
    prefix (a near-free re-prefill) and the stream stays bit-exact."""
    pool = KVBlockPool(32, 4)
    eng = _SchedChunkedEngine(
        pool, chunk=4, slots=1, max_batch=1, step_delay_s=0.02
    )
    m = ServeMetrics()
    p_vic, p_hi = np.arange(1, 9), np.arange(51, 55)
    b = ContinuousBatcher(
        eng,
        BatcherConfig(
            max_batch=1, sched="edf", preempt=True,
            preempt_margin_ms=1e6, default_priority=1,
        ),
        m,
    )
    try:
        fv = b.submit({
            "input_ids": p_vic, "max_new_tokens": 10, "priority": 2,
        })
        _poll(lambda: _decode_steps(eng) >= 3, msg="victim progress")
        fh = b.submit({
            "input_ids": p_hi, "max_new_tokens": 3, "priority": 0,
            "deadline_ms": 5,
        })
        assert fh.result(timeout=30)["tokens"] == _expected(p_hi, 3)
        assert fv.result(timeout=30)["tokens"] == _expected(p_vic, 10)
        st = b.status()
    finally:
        b.close()
    assert m.preemptions.snapshot() == {"paged": 1}
    assert st["sched"]["preempt_parked"] == 1
    assert st["sched"]["preempt_resumed"] == 1
    # The resume matched the parked chain: at least 8 prompt tokens (two
    # full blocks of the settled victim sequence) came from the pool.
    assert st["prefix_cache"]["hits"] >= 1
    assert m.prefix_tokens_saved.value >= 8
    # The park's page copy went through the engine's insert hook.
    assert any(blocks for _, blocks in eng.inserted)


def test_preempt_while_prefill_chunk_in_flight():
    """Preemption landing while the victim's prefill chunk is still in
    flight: the victim parks page-less immediately (nothing generated is
    lost — there IS nothing generated), the stale chunk's completion
    drops on the gen tag, and the replayed prefill is bit-exact."""
    pool = KVBlockPool(32, 4)
    eng = _SchedChunkedEngine(
        pool, chunk=4, slots=1, max_batch=1, step_delay_s=0.05
    )
    m = ServeMetrics()
    p_vic = np.arange(1, 17)  # 16 tokens -> 4 chunks at 50 ms each
    p_hi = np.arange(51, 55)
    b = ContinuousBatcher(
        eng,
        BatcherConfig(
            max_batch=1, sched="edf", preempt=True,
            preempt_margin_ms=1e6, default_priority=1,
        ),
        m,
    )
    try:
        fv = b.submit({
            "input_ids": p_vic, "max_new_tokens": 4, "priority": 2,
        })
        _poll(
            lambda: any(k == "chunk" for k, _ in eng.events),
            msg="first prefill chunk",
        )
        fh = b.submit({
            "input_ids": p_hi, "max_new_tokens": 2, "priority": 0,
            "deadline_ms": 5,
        })
        assert fh.result(timeout=30)["tokens"] == _expected(p_hi, 2)
        assert fv.result(timeout=30)["tokens"] == _expected(p_vic, 4)
        st = b.status()
    finally:
        b.close()
    assert st["sched"]["preempt_parked"] == 1
    assert m.preemptions.snapshot() == {"pageless": 1}


def test_park_pool_full_victim_finishes():
    """The degradation path: when the pool cannot hold the victim's full
    settled sequence, the preemption ABORTS — the victim keeps its slot
    and finishes (it is never lost), the waiter takes the natural free,
    and the abort is visible in every book."""
    pool = KVBlockPool(2, 4)
    # Pin the whole pool under someone else's chain: index() can then
    # neither find nor allocate a single block for the victim.
    other = list(range(100, 108))
    assert len(pool.insert(other)) == 2
    # match() caps at a one-token suffix, so probe one past the chain to
    # pin BOTH blocks.
    pin = pool.match(other + [999])
    assert pin.cached_len == 8
    eng = _SchedChunkedEngine(
        pool, chunk=4, slots=1, max_batch=1, step_delay_s=0.02
    )
    m = ServeMetrics()
    rec = FlightRecorder(capacity=256)
    p_vic, p_hi = np.arange(1, 9), np.arange(51, 55)
    b = ContinuousBatcher(
        eng,
        BatcherConfig(
            max_batch=1, sched="edf", preempt=True,
            preempt_margin_ms=1e6, default_priority=1,
        ),
        m, recorder=rec,
    )
    try:
        fv = b.submit({
            "input_ids": p_vic, "max_new_tokens": 8, "priority": 2,
        })
        _poll(lambda: _decode_steps(eng) >= 3, msg="victim progress")
        fh = b.submit({
            "input_ids": p_hi, "max_new_tokens": 2, "priority": 0,
            "deadline_ms": 5,
        })
        # The victim ran to completion — all 8 tokens, not a truncation.
        rv = fv.result(timeout=30)
        assert rv["tokens"] == _expected(p_vic, 8)
        assert rv["n_tokens"] == 8
        assert fh.result(timeout=30)["tokens"] == _expected(p_hi, 2)
        st = b.status()
    finally:
        b.close()
        pool.release(pin)
    assert m.preemptions.snapshot() == {"park_full": 1}
    assert st["sched"]["preempt_aborted"] == 1
    assert st["sched"]["preempt_parked"] == 0
    assert st["sched"]["preempt_resumed"] == 0
    # No replay happened: exactly the two original admissions.
    assert len(eng.admitted) == 2
    pre = next(e for e in rec.events() if e["kind"] == "slot_preempt")
    assert pre["reason"] == "park_full" and pre["aborted"] is True


# ------------------------------------------------- kvpool index / forget


def test_kvpool_index_reports_coverage():
    pool = KVBlockPool(4, 4)
    seq = list(range(1, 9))
    new, covered = pool.index(seq)
    assert covered == 2 and [b for _, b in new] == [0, 1]
    # Idempotent: the chain is cached now, nothing new to copy.
    new2, covered2 = pool.index(seq)
    assert new2 == [] and covered2 == 2
    # The trailing partial block never counts toward coverage.
    _, covered3 = pool.index(list(range(1, 12)))
    assert covered3 == 2
    # A fully pinned pool cannot cover a new chain: covered < want.
    pin = pool.match(seq + [99])  # +1 past the chain pins both blocks
    pool.index(list(range(20, 29)))  # takes the 2 free blocks
    pin2 = pool.match(list(range(20, 29)))
    new4, covered4 = pool.index(list(range(50, 62)))
    assert new4 == [] and covered4 == 0
    pool.release(pin)
    pool.release(pin2)


def test_kvpool_forget_undoes_failed_publish():
    pool = KVBlockPool(4, 4)
    seq = list(range(1, 9))
    pool.index(seq)
    assert pool.stats()["blocks_used"] == 2
    assert pool.forget(seq) == 2
    assert pool.stats()["blocks_used"] == 0
    assert pool.cached_len(seq) == 0
    # Pinned chains are not forgettable (a reader holds the pages)...
    pool.index(seq)
    pin = pool.match(seq + [99])  # +1 past the chain pins both blocks
    assert pool.forget(seq) == 0
    pool.release(pin)
    # ...and interior nodes survive a forget of a longer chain's tail.
    long = list(range(1, 17))
    pool.index(long)
    pin = pool.match(seq + [99])  # pins the first 2 blocks only
    assert pool.forget(long) == 2  # drops the unpinned tail blocks
    assert pool.cached_len(long) == 8
    pool.release(pin)


# ------------------------------------------------- observability surfaces


def test_status_and_prom_expose_sched_state():
    from distributed_tensorflow_tpu_torch.obs.export import prometheus_text

    eng = _SchedEngine(slots=1, max_batch=1, step_delay_s=0.05)
    m = ServeMetrics()
    with ContinuousBatcher(
        eng,
        BatcherConfig(
            max_batch=1, sched="edf", preempt=True, default_priority=1,
        ),
        m,
    ) as b:
        f0 = b.submit({"input_ids": np.arange(1, 5), "max_new_tokens": 6})
        _poll(lambda: len(eng.admitted) == 1, msg="holder admission")
        f1 = b.submit({
            "input_ids": np.arange(11, 15), "max_new_tokens": 1,
            "priority": 0, "deadline_ms": 60_000,
        })
        f2 = b.submit({
            "input_ids": np.arange(21, 25), "max_new_tokens": 1,
            "priority": 2,
        })
        st = b.status()
        snap = m.snapshot()
        text = prometheus_text(m)
        for f in (f0, f1, f2):
            f.result(timeout=30)
    sched = st["sched"]
    assert sched["policy"] == "edf" and sched["preempt"] is True
    assert sched["preempt_margin_ms"] == pytest.approx(20.0)
    # Holder occupies class 1 (the default), the waiters queue in 0 and 2.
    assert sched["classes"]["1"]["active"] == 1
    assert sched["classes"]["0"]["queued"] == 1
    assert sched["classes"]["2"]["queued"] == 1
    # The holder's class drained to 0 at admission; its gauge stays
    # published at zero (a scrape must see the drop, not a vanished
    # series).
    assert {
        k: v for k, v in snap["sched_queue_depth"].items() if v
    } == {"0": 1.0, "2": 1.0}
    assert "preemptions" in snap
    assert 'serve_sched_queue_depth{class="0"} 1' in text
    m.preemptions.inc("paged")
    assert 'serve_preemptions_total{reason="paged"} 1' in prometheus_text(m)


def test_flight_recorder_documents_sched_kinds():
    assert "slot_preempt" in EVENT_KINDS
    assert "slot_resume" in EVENT_KINDS


# ------------------------------------------------- sanitizer soak


def test_sched_preempt_race_soak():
    """Concurrent mixed-priority submitters (half carrying tight
    deadlines) over a preempting batcher with a real eviction-prone pool,
    under the race sanitizer: every stream bit-exact through any number
    of park/resume round trips, and the declared scheduler state stays
    happens-before ordered."""
    with sanitize_races(modules=[batcher_mod, kvpool_mod]) as san:
        pool = kvpool_mod.KVBlockPool(16, 4)
        eng = _SchedChunkedEngine(pool, chunk=4, slots=3, max_batch=2)
        b = ContinuousBatcher(
            eng,
            BatcherConfig(
                max_batch=2, max_queue=256, max_in_flight=2,
                sched="edf", preempt=True, preempt_margin_ms=50.0,
                default_priority=1,
            ),
        )
        results = {}
        errs = []

        def worker(base):
            rng = np.random.default_rng(base)
            try:
                futs = []
                for i in range(10):
                    prompt = rng.integers(
                        1, 40, size=int(rng.integers(4, 13))
                    )
                    n = int(rng.integers(1, 7))
                    payload = {"input_ids": prompt, "max_new_tokens": n,
                               "priority": int(rng.integers(0, 3))}
                    if rng.random() < 0.5:
                        payload["deadline_ms"] = float(rng.integers(1, 30))
                    futs.append((prompt, n, b.submit(payload)))
                for j, (prompt, n, f) in enumerate(futs):
                    results[(base, j)] = (
                        f.result(timeout=60)["tokens"], _expected(prompt, n)
                    )
            except Exception as e:  # pragma: no cover - surfaced via errs
                errs.append(e)

        threads = [
            threading.Thread(target=worker, args=(base,))
            for base in (1, 2, 3, 4)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        st = b.status()
        b.close()
        assert not errs
        assert len(results) == 40
        for got, want in results.values():
            assert got == want
        # Every park was either resumed to completion or aborted-to-finish;
        # nothing leaks into a terminal parked state.
        assert st["sched"]["preempt_parked"] == st["sched"]["preempt_resumed"]
        assert san.acquisitions > 0
        san.assert_clean()


# ------------------------------------------------- real-engine composition

# The full serving stack in one engine (as the JAX test's stacked engine):
# chunked prefill + prefix cache + speculation + int8 weights and KV.
STACKED = dict(CHUNKED, slots=2, spec_tokens=3, weight_dtype="int8", kv_dtype="int8")


class _Slowed:
    """An engine whose step fetch takes ``delay_s`` longer: the victims are
    still decoding when the urgent request arrives, on any host."""

    def __init__(self, engine, delay_s=0.02):
        self._engine, self._delay_s = engine, delay_s

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def fetch_step(self, handle):
        time.sleep(self._delay_s)
        return self._engine.fetch_step(handle)


@pytest.fixture(scope="module")
def stacked():
    return {"jax": (jax_engine(**STACKED), JaxBatcher, JaxConfig),
            "port": (port_engine(**STACKED), ContinuousBatcher, BatcherConfig)}


def test_engine_validate_rejects_bad_sched_fields(stacked):
    engine = stacked["port"][0]
    ok = {"input_ids": np.arange(1, 5), "max_new_tokens": 2}
    engine.validate({**ok, "priority": 2, "deadline_ms": 50})
    for bad, field in (({"priority": "high"}, "priority"), ({"priority": -1}, "priority"),
                       ({"deadline_ms": "soon"}, "deadline_ms"),
                       ({"deadline_ms": 0}, "deadline_ms")):
        with pytest.raises(RequestError, match=field):
            engine.validate({**ok, **bad})


def _preempted_run(engine, batcher_cls, config_cls):
    """Two priority-2 victims (one greedy, one sampled) fill the two slots;
    a priority-0 request with a 5 ms deadline arrives while they decode.
    Returns the solo streams, the contended streams and the sched digest."""
    reqs = [
        {"input_ids": np.arange(1, 5), "max_new_tokens": 8, "priority": 2},
        {"input_ids": np.arange(3, 7), "max_new_tokens": 8, "priority": 2,
         "temperature": 0.8, "seed": 5},
        {"input_ids": np.arange(5, 9), "max_new_tokens": 4, "priority": 0},
    ]
    with batcher_cls(engine, config_cls(max_batch=2)) as b:
        solo = [b.submit(dict(r)).result(timeout=120)["tokens"] for r in reqs]
    b = batcher_cls(_Slowed(engine), config_cls(max_batch=2, sched="edf", preempt=True,
                                                preempt_margin_ms=1e6, default_priority=1))
    try:
        futs = [b.submit(dict(r)) for r in reqs[:2]]
        _poll(lambda: b.status()["slots_active"] == 2, timeout_s=60, msg="both victims")
        futs.append(b.submit({**reqs[2], "deadline_ms": 5}))
        got = [f.result(timeout=120)["tokens"] for f in futs]
        st = b.status()
    finally:
        b.close()
    return solo, got, st["sched"]


def test_preempt_resume_parity_full_stack(stacked):
    """Preempt -> park -> resume through the real engines with chunked
    prefill, the prefix cache, speculation and int8 KV stacked: every
    stream equals its solo run, and the port's streams equal the JAX
    package's (greedy and sampled)."""
    runs = {name: _preempted_run(*parts) for name, parts in stacked.items()}
    (jsolo, jgot, _), (psolo, pgot, sched) = runs["jax"], runs["port"]
    assert pgot == psolo
    assert jgot == jsolo
    assert psolo == jsolo
    assert sched["preempt_parked"] >= 1
    assert sched["preempt_resumed"] == sched["preempt_parked"]
