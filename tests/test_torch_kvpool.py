"""The port's ``KVBlockPool`` (serve/kvpool.py): the contract cases of the
JAX package's ``tests/test_kvpool.py`` run on the port's copy, and a seeded
random sequence of ``insert/match/release/forget/index/cached_len`` under
eviction pressure applied to both pools, every return value and ``stats()``
equal (exact: the pool is pure host bookkeeping in both packages)."""

from __future__ import annotations

import threading

import numpy as np
import pytest

from distributed_tensorflow_tpu.serve.kvpool import KVBlockPool as JaxPool
from distributed_tensorflow_tpu_torch.serve.kvpool import KVBlockPool, PrefixMatch


def _prompt(*blocks):
    out = []
    for b in blocks:
        out.extend(b)
    return out


A, B, C, D = (1, 2, 3, 4), (5, 6, 7, 8), (9, 10, 11, 12), (13, 14, 15, 16)


def test_ctor_validates():
    with pytest.raises(ValueError, match="block"):
        KVBlockPool(0, 4)
    with pytest.raises(ValueError, match="block_tokens"):
        KVBlockPool(4, 0)


def test_insert_indexes_full_blocks_only():
    pool = KVBlockPool(8, 4)
    new = pool.insert(_prompt(A, B) + [99, 98])
    assert [idx for _, idx in new] == [0, 1]
    assert len({blk for blk, _ in new}) == 2
    assert pool.stats()["blocks_used"] == 2
    assert pool.insert(_prompt(A, B) + [99, 98]) == []
    new = pool.insert(_prompt(A, C))
    assert [idx for _, idx in new] == [1]
    assert pool.stats()["blocks_used"] == 3


def test_match_caps_to_leave_a_suffix():
    pool = KVBlockPool(8, 4)
    pool.insert(_prompt(A, B))
    m = pool.match(_prompt(A, B))
    assert m.cached_len == 4 and len(m.blocks) == 1
    pool.release(m)
    m = pool.match(_prompt(A, B) + [42])
    assert m.cached_len == 8 and len(m.blocks) == 2
    pool.release(m)
    m = pool.match(_prompt(A, D) + [42])
    assert m.cached_len == 4
    pool.release(m)
    for ids in (_prompt(C, D), list(A)):
        m = pool.match(ids)
        assert m.cached_len == 0 and m.blocks == []
        pool.release(m)


def test_release_is_idempotent_and_unpins():
    pool = KVBlockPool(2, 4)
    pool.insert(_prompt(A, B))
    m = pool.match(_prompt(A, B) + [42])
    assert all(n.refs == 1 for n in m._nodes)
    pool.release(m)
    pool.release(m)
    assert all(n.refs == 0 for n in m._nodes)


def test_lru_evicts_coldest_leaf_keeping_prefix_closure():
    pool = KVBlockPool(3, 4)
    pool.insert(_prompt(A, B))
    pool.insert(_prompt(A, C))
    pool.match(_prompt(A, C) + [42])
    new = pool.insert(_prompt(A, D))
    assert [idx for _, idx in new] == [1]
    assert pool.stats()["evictions"] == 1
    assert pool.match(_prompt(A, B) + [42]).cached_len == 4
    assert pool.match(_prompt(A, D) + [42]).cached_len == 8


def test_pinned_chains_are_not_evicted():
    pool = KVBlockPool(2, 4)
    pool.insert(_prompt(A, B))
    m = pool.match(_prompt(A, B) + [42])
    assert pool.insert(_prompt(C, D)) == []
    assert pool.match(_prompt(C, D) + [42]).cached_len == 0
    pool.release(m)
    assert len(pool.insert(_prompt(C, D))) == 2


def test_byte_accounting():
    pool = KVBlockPool(4, 4, bytes_per_block=1024, dtype="int8")
    pool.insert(_prompt(A, B) + [42])
    st = pool.stats()
    assert st["bytes_used"] == 2 * 1024
    assert st["capacity_bytes"] == 4 * 1024
    assert st["blocks"] == 4 and st["block_tokens"] == 4 and st["dtype"] == "int8"


def test_concurrent_match_insert_release_is_consistent():
    pool = KVBlockPool(6, 4)
    errs = []

    def worker(seed):
        try:
            for i in range(200):
                ids = _prompt((A, B, C, D)[(seed + i) % 4], A) + [seed]
                m = pool.match(ids)
                pool.insert(ids)
                pool.release(m)
        except Exception as e:  # pragma: no cover - surfaced via errs
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errs
    assert pool.stats()["blocks_used"] <= pool.n_blocks
    assert all(n.refs == 0 for n in pool._by_block.values())


def test_match_returns_prefixmatch_type():
    pool = KVBlockPool(2, 4)
    assert isinstance(pool.match(list(range(9))), PrefixMatch)


class _Events:
    """A recorder stand-in: the pools' ``prefix_evict`` events."""

    enabled = True

    def __init__(self):
        self.events = []

    def record(self, kind, *args, **fields):
        self.events.append((kind, args, fields))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_operations_match_jax_pool(seed):
    """Seeded sequences over a 7-block pool of 3-token blocks, prompts
    drawn from a small alphabet so heads are shared and the pool stays
    under eviction pressure; pins are held across steps and released in
    random order. Every return value, ``stats()`` after every step and the
    eviction events are equal."""
    rng = np.random.default_rng(seed)
    jax_pool, port_pool = JaxPool(7, 3, 96, dtype="bfloat16"), KVBlockPool(7, 3, 96, dtype="bfloat16")
    jax_pool.recorder, port_pool.recorder = _Events(), _Events()
    pins: list[tuple] = []
    heads = [list(rng.integers(1, 5, 6)) for _ in range(4)]
    ops = {"insert": 0, "match": 0, "release": 0, "forget": 0, "index": 0, "cached_len": 0}
    for _ in range(400):
        ids = heads[int(rng.integers(len(heads)))][: int(rng.integers(0, 7))]
        ids = ids + [int(t) for t in rng.integers(1, 4, int(rng.integers(0, 8)))]
        op = str(rng.choice(list(ops)))
        if op == "release":
            if not pins:
                continue
            jm, pm = pins.pop(int(rng.integers(len(pins))))
            got = (jax_pool.release(jm), port_pool.release(pm))
        elif op == "match":
            jm, pm = jax_pool.match(ids), port_pool.match(ids)
            got = ((jm.blocks, jm.cached_len), (pm.blocks, pm.cached_len))
            pins.append((jm, pm))
        else:
            got = (getattr(jax_pool, op)(ids), getattr(port_pool, op)(ids))
        assert got[0] == got[1], (op, ids)
        assert jax_pool.stats() == port_pool.stats()
        ops[op] += 1
    assert all(ops.values()) and jax_pool.stats()["evictions"] > 5
    assert jax_pool.recorder.events == port_pool.recorder.events
