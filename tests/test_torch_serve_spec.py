"""The port's speculative decoding (serve/spec.py and the continuous
batcher's verify path) against the JAX package's.

Mirrors the JAX package's ``tests/test_serve_spec.py``: ``NGramDrafter`` and
``SlotSpec`` return exactly what the JAX ones return on seeded histories and
outcome sequences; the engine's plan validation; and, on the tiny real
engines of ``tests/_torch_serve_common.py``, the speculative batcher's
streams equal the plain batcher's and the JAX speculative batcher's, token
for token (greedy and seeded-sampled rows, a rejected draft, EOS inside an
accepted run), with speculation engaged; then the race soak under the
port's ``sanitize_races``.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
from _torch_serve_common import (
    jax_engine,
    port_engine,
    predictive_prompt,
    ref_greedy,
    run_batcher,
)

from distributed_tensorflow_tpu.serve import ContinuousBatcher as JaxBatcher
from distributed_tensorflow_tpu.serve.spec import NGramDrafter as JaxDrafter
from distributed_tensorflow_tpu.serve.spec import SlotSpec as JaxSlotSpec
from distributed_tensorflow_tpu.serve.spec import SpecConfig as JaxSpecConfig
from distributed_tensorflow_tpu_torch.obs.flightrec import FlightRecorder
from distributed_tensorflow_tpu_torch.obs.metrics import ServeMetrics
from distributed_tensorflow_tpu_torch.obs.sanitizer import sanitize_races
from distributed_tensorflow_tpu_torch.serve import batcher as batcher_mod
from distributed_tensorflow_tpu_torch.serve import (
    BatcherConfig,
    ContinuousBatcher,
    NGramDrafter,
)
from distributed_tensorflow_tpu_torch.serve.spec import SlotSpec, SpecConfig

# ------------------------------------------------ drafter and SlotSpec units


def test_ngram_drafter_prefers_longest_then_most_recent_and_validates():
    d = NGramDrafter(min_match=2, max_match=4)
    assert d.draft([1, 2, 3, 7, 1, 2, 3, 9, 5, 1, 2, 3], 2) == [9, 5]
    assert d.draft([3, 9, 5, 8, 6, 9, 5, 4, 3, 9, 5], 1) == [8]
    assert d.draft([1, 2, 3, 4], 3) == []
    assert d.draft([1, 2], 3) == []
    assert d.draft([1, 2, 3, 1, 2, 3], 0) == []
    assert d.draft([1, 2, 9, 8, 7, 6, 1, 2], 2) == [9, 8]
    for bad in ({"min_match": 0}, {"min_match": 3, "max_match": 2}):
        with pytest.raises(ValueError):
            NGramDrafter(**bad)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_drafter_and_slot_spec_match_jax(seed):
    """Seeded histories over a small alphabet (so n-grams repeat) and
    seeded outcome sequences: the drafts, every backoff verdict, the
    ``speculating`` flag through the re-probe clock and ``digest`` equal
    the JAX package's."""
    rng = np.random.default_rng(seed)
    kw = dict(spec_tokens=int(rng.integers(1, 6)), min_match=int(rng.integers(1, 4)),
              backoff_threshold=float(rng.uniform(0.1, 0.6)), reprobe_period=int(rng.integers(2, 6)))
    kw["max_match"] = kw["min_match"] + int(rng.integers(0, 3))
    ours, theirs = SlotSpec(SpecConfig(**kw)), JaxSlotSpec(JaxSpecConfig(**kw))
    drafter, jax_drafter = NGramDrafter(kw["min_match"], kw["max_match"]), \
        JaxDrafter(kw["min_match"], kw["max_match"])
    flips = 0
    for _ in range(200):
        hist = [int(t) for t in rng.integers(0, 4, int(rng.integers(0, 30)))]
        k = int(rng.integers(0, 6))
        assert drafter.draft(hist, k) == jax_drafter.draft(hist, k)
        assert ours.propose(hist, k) == theirs.propose(hist, k)
        assert ours.speculating == theirs.speculating
        if rng.random() < 0.3:
            ours.note_plain_step()
            theirs.note_plain_step()
            continue
        d = int(rng.integers(0, kw["spec_tokens"] + 1))
        a = int(rng.integers(0, d + 1)) if rng.random() < 0.5 else 0
        verdict = ours.record(d, a)
        assert verdict == theirs.record(d, a)
        flips += verdict is not None
        assert ours.digest() == theirs.digest()
    assert flips > 0


def test_slot_spec_backoff_engages_and_reprobes():
    cfg = SpecConfig(spec_tokens=4, warmup_verifies=3, backoff_threshold=0.25,
                     ema_alpha=0.3, reprobe_period=4)
    s = SlotSpec(cfg)
    assert s.speculating
    assert [s.record(0, 0) for _ in range(4)] == [None, None, None, "engage"]
    assert s.backed_off and not s.speculating
    for _ in range(4):
        s.note_plain_step()
    assert s.speculating
    assert s.record(4, 4) == "disengage"
    assert not s.backed_off and s.speculating
    t = SlotSpec(SpecConfig(spec_tokens=4))
    for d, a in ((3, 3), (3, 1), (0, 0)):
        t.record(d, a)
    assert (t.drafted, t.accepted, t.rejects) == (6, 4, 1)
    assert t.digest()["k"] == 4 and not t.digest()["backed_off"]


# --------------------------------------------------- engine plan validation


@pytest.mark.parametrize("bad", [{"spec_tokens": -1},
                                 {"spec_tokens": 2, "spec_min_match": 0},
                                 {"spec_tokens": 8}])  # k >= max_new_tokens
def test_plan_spec_rejects_bad_configs(bad):
    with pytest.raises(ValueError):
        port_engine(**bad)


def test_engine_spec_config():
    assert port_engine().spec is None
    eng = port_engine(spec_tokens=3, spec_min_match=1, spec_backoff=0.4)
    assert eng.spec == SpecConfig(spec_tokens=3, min_match=1, backoff_threshold=0.4)
    assert callable(eng.verify)


# ----------------------------------------------- batcher streams vs JAX, plain


@pytest.fixture(scope="module")
def engines():
    return {"jax_spec": jax_engine(spec_tokens=3), "spec": port_engine(spec_tokens=3),
            "plain": port_engine()}


def _reject_prompt(seed: int, n_new: int = 6):
    """Like ``predictive_prompt`` but the tokens after ``[t, c0]`` are
    deliberately wrong: the drafter proposes them and verify rejects."""
    rng = np.random.default_rng(seed)
    t = int(rng.integers(5, 64))
    c = ref_greedy(rng.integers(5, 64, size=12), n_new)
    for _ in range(8):
        wrong = [(ci - 5 + 7) % 59 + 5 for ci in c[1:4]]
        p = [int(rng.integers(5, 64)), t, c[0]] + wrong + [
            int(x) for x in rng.integers(5, 64, size=5)] + [t]
        c2 = ref_greedy(p, n_new)
        if c2 == c:
            break
        c = c2
    return np.array(p, np.int32), c


def _spec_requests():
    """Predictive prompts (the drafter proposes the model's own
    continuation), greedy and seeded-sampled; one with EOS inside what an
    accepted run would emit; a rejected-draft prompt; an undraftable
    random one."""
    reqs = []
    for seed in (1, 3, 9):
        p, c = predictive_prompt(seed)
        reqs.append({"input_ids": p, "max_new_tokens": len(c)})
        reqs.append({"input_ids": p, "max_new_tokens": len(c), "temperature": 0.8,
                     "seed": 100 + seed})
    p, c = predictive_prompt(3)
    reqs.append({"input_ids": p, "max_new_tokens": len(c), "eos_id": c[2]})
    p, _ = _reject_prompt(21)
    reqs.append({"input_ids": p, "max_new_tokens": 6})
    reqs.append({"input_ids": np.random.default_rng(0).integers(5, 64, size=10),
                 "max_new_tokens": 6, "temperature": 1.2, "seed": 7})
    return reqs


def test_spec_streams_match_plain_and_jax(engines):
    """The speculative batcher's streams equal the plain batcher's and the
    JAX speculative batcher's, exactly; greedy ones equal the full-forward
    reference; EOS inside an accepted run stops the stream there; and
    speculation engaged (accepted runs emit > 1 token a slot-step) with a
    reject exercised."""
    reqs = _spec_requests()
    cfg, m = BatcherConfig(max_batch=2, max_queue=32), ServeMetrics()
    got, st = run_batcher(ContinuousBatcher, engines["spec"], cfg, reqs, metrics=m)
    plain, pst = run_batcher(ContinuousBatcher, engines["plain"], cfg, reqs)
    want, _ = run_batcher(JaxBatcher, engines["jax_spec"], cfg, reqs)
    assert got == plain == want
    for r, stream in zip(reqs, got):
        if "eos_id" in r:
            assert stream == ref_greedy(r["input_ids"], r["max_new_tokens"])[:3]
        elif not r.get("temperature"):
            assert stream == ref_greedy(r["input_ids"], r["max_new_tokens"])
    snap = m.snapshot()
    assert snap["accepted_tokens"] > 0 and snap["spec_rejects"] >= 1
    assert snap["draft_tokens"] > snap["accepted_tokens"]
    sp = st["speculation"]
    assert sp["spec_tokens"] == 3 and sp["mode_k"] == {"speculating": 3, "backed_off": 0}
    assert sp["accepted_tokens"] == snap["accepted_tokens"]
    assert st["tokens_per_step"] > 1.0
    assert pst["tokens_per_step"] == pytest.approx(1.0) and "speculation" not in pst


def test_adaptive_backoff_on_random_stream(engines):
    """An undraftable stream (all-distinct prompt) folds empty proposals
    into the EMA and backs off, with a ``spec_backoff`` event, and still
    matches the reference."""
    prompt = np.arange(5, 19)
    rec = FlightRecorder(capacity=256)
    with ContinuousBatcher(engines["spec"], BatcherConfig(max_batch=2), recorder=rec) as b:
        r = b.submit({"input_ids": prompt, "max_new_tokens": 8}).result(timeout=120)
        st = b.status()
    assert r["tokens"] == ref_greedy(prompt, 8)
    assert any(e["engaged"] for e in rec.events() if e["kind"] == "spec_backoff")
    assert st["speculation"]["draft_tokens"] == 0


def test_prefix_cache_composes_with_speculation():
    """Cached head and speculated tail: replays gather the head's pages at
    admission and still speculate during decode; streams exact."""
    engine = port_engine(prefix_cache_mb=0.05, block_tokens=4, prefill_chunk=8, spec_tokens=3)
    p, c = predictive_prompt(4)
    req = {"input_ids": p, "max_new_tokens": len(c)}
    m = ServeMetrics()
    with ContinuousBatcher(engine, BatcherConfig(max_batch=2), metrics=m) as b:
        assert b.submit(dict(req)).result(timeout=120)["tokens"] == c
        for f in [b.submit(dict(req)) for _ in range(3)]:
            assert f.result(timeout=120)["tokens"] == c
    assert m.prefix_hits.value >= 3 and m.snapshot()["accepted_tokens"] > 0


def test_speculative_batcher_race_soak(engines):
    """Concurrent submitters through the port's speculative engine under
    the race sanitizer: the spec slot fields and counters stay
    happens-before ordered across verify/decode/plan, every stream exact.
    Bounded: 3 threads x 4 requests."""
    preds = [predictive_prompt(s) for s in (3, 8)]
    with sanitize_races(modules=[batcher_mod]) as san:
        b = ContinuousBatcher(engines["spec"], BatcherConfig(max_batch=2, max_queue=64))
        results, errs = {}, []

        def worker(base):
            rng = np.random.default_rng(base)
            try:
                futs = []
                for i in range(4):
                    if i % 2 == 0:
                        p, c = preds[base % len(preds)]
                        futs.append((c, b.submit({"input_ids": p, "max_new_tokens": len(c)})))
                    else:
                        prompt = rng.integers(5, 64, size=10)
                        n = int(rng.integers(2, 7))
                        futs.append((ref_greedy(prompt, n),
                                     b.submit({"input_ids": prompt, "max_new_tokens": n})))
                for j, (ref, f) in enumerate(futs):
                    results[(base, j)] = (f.result(timeout=120)["tokens"], ref)
            except Exception as e:  # pragma: no cover - surfaced via errs
                errs.append(e)

        threads = [threading.Thread(target=worker, args=(base,)) for base in (1, 2, 3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        b.close()
        assert not errs
        assert len(results) == 12
        for got, ref in results.values():
            assert got == ref
        assert san.accesses > 0
        san.assert_clean()
