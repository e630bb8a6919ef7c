"""Block-granular KV prefix cache: radix trie over prompt-token blocks.

The host half of prefix-cache KV reuse (the vLLM/SGLang recipe adapted to
this repo's slot-table cache): the ENGINE owns a device-resident pool of
fixed-size KV pages ``[num_layers, n_blocks, block_tokens, heads,
head_dim]`` sharded like the slot cache; this module owns every piece of
bookkeeping about what those pages MEAN — a token-trie (radix) index
mapping prompt prefixes to chains of block ids, refcount pins, and LRU
eviction under the byte budget. No torch in here: the pool never touches a
device tensor, so trie ops cost microseconds on the decode loop.

Design contracts (tests/test_torch_kvpool.py pins them):

- **Block granularity.** One trie node per FULL block of ``block_tokens``
  prompt ids (the node key is that token tuple); partial trailing blocks
  are never indexed, so two prompts can only share whole pages.
- **Copy-on-read, not copy-on-write.** Published pages are IMMUTABLE: a
  matching request gathers COPIES of the chain into its own slot pages
  and extends those, so requests diverging after a shared head can never
  corrupt each other — the COW isolation property without ever needing a
  write-fault path. A block id is (re)written exactly once, at
  :meth:`insert` time, before any later dispatch can match it.
- **Match leaves a suffix.** :meth:`match` caps the walk at
  ``(prompt_len - 1) // block_tokens`` blocks so at least one prompt
  token always remains for suffix prefill — the engine needs a real
  forward to produce first-token logits.
- **Pin across the gather window.** ``match`` increfs every node on the
  returned chain; the caller releases after the gather is DISPATCHED
  (device stream order then keeps the pages alive for the gather even if
  they are evicted and rewritten by a later insert).
- **LRU leaf eviction.** Allocation under a full pool evicts the
  least-recently-used refcount-0 LEAF — leaf-first keeps the trie
  prefix-closed (an interior page never outlives its children), and
  repeated allocation walks a cold chain back-to-front.

Thread safety: one internal lock orders every method; the continuous
batcher calls ``match``/``release`` while holding its own ``_cv`` (lock
order ``_cv -> pool``, never reversed) and ``insert``/``stats`` from the
decode-loop / HTTP threads. ``_RACETRACE_ATTRS`` lets the
``sanitize_races`` soak check that ordering at runtime.
"""

from __future__ import annotations

import threading

from distributed_tensorflow_tpu_torch.obs.flightrec import NULL_RECORDER

__all__ = ["KVBlockPool", "PrefixMatch"]


class _TrieNode:
    """One cached block: ``key`` is the block's token tuple, ``block`` the
    pool page holding its K/V. ``refs`` pins (gathers in flight), ``tick``
    is the LRU clock stamp."""

    __slots__ = ("key", "block", "parent", "children", "refs", "tick")

    def __init__(self, key, block, parent):
        self.key = key
        self.block = block
        self.parent = parent
        self.children: dict = {}
        self.refs = 0
        self.tick = 0


class PrefixMatch:
    """A pinned chain from :meth:`KVBlockPool.match`: ``blocks`` are the
    pool page ids covering the prompt's first ``cached_len`` tokens.
    Release is idempotent — the pool guards the unpin with ``_released``
    so every exit path (post-dispatch, slot failure, slot free) can call
    it unconditionally."""

    __slots__ = ("blocks", "cached_len", "_nodes", "_released")

    def __init__(self, blocks, cached_len, nodes):
        self.blocks = blocks
        self.cached_len = cached_len
        self._nodes = nodes
        self._released = False


class KVBlockPool:
    """Refcounted, LRU-evicted index over a fixed pool of KV pages."""

    # Watched by obs.sanitizer.sanitize_races (the
    # tests/test_torch_serve_decode.py soak); every access must be
    # ordered by self._lock.
    _RACETRACE_ATTRS = ("_free", "_by_block", "_ticks", "_evictions")

    def __init__(self, n_blocks: int, block_tokens: int,
                 bytes_per_block: int = 0, dtype: str = "float32"):
        if n_blocks < 1:
            raise ValueError(f"need at least one block, got {n_blocks}")
        if block_tokens < 1:
            raise ValueError(
                f"block_tokens must be >= 1, got {block_tokens}"
            )
        self.n_blocks = int(n_blocks)
        self.block_tokens = int(block_tokens)
        self.bytes_per_block = int(bytes_per_block)
        # Storage dtype of the pages this pool indexes (informational:
        # bytes_per_block already reflects it — int8 blocks carry their
        # per-position scale payload in the count, see engine
        # _plan_prefix_cache).
        self.dtype = str(dtype)
        self._lock = threading.Lock()
        self._root = _TrieNode(None, -1, None)
        self._free = list(range(self.n_blocks))
        self._by_block: dict[int, _TrieNode] = {}
        self._ticks = 0
        self._evictions = 0
        # Flight-recorder sink for prefix_evict events; the continuous
        # batcher swaps in its recorder when one is enabled. Recording is
        # a leaf-lock append (pool _lock -> recorder lock, never out).
        self.recorder = NULL_RECORDER

    # ------------------------------------------------------------- lookup

    def match(self, token_ids) -> PrefixMatch:
        """Longest cached prefix of ``token_ids`` in whole blocks, capped
        so at least one prompt token is left un-cached. Pins the chain;
        the caller MUST :meth:`release` once the page gather is
        dispatched (or the request dies first)."""
        ids = [int(t) for t in token_ids]
        bt = self.block_tokens
        limit = max(len(ids) - 1, 0) // bt
        with self._lock:
            self._ticks += 1
            tick = self._ticks
            node, nodes = self._root, []
            for b in range(limit):
                child = node.children.get(tuple(ids[b * bt:(b + 1) * bt]))
                if child is None:
                    break
                child.refs += 1
                child.tick = tick
                nodes.append(child)
                node = child
            return PrefixMatch(
                [n.block for n in nodes], len(nodes) * bt, nodes
            )

    def cached_len(self, token_ids) -> int:
        """No-pin peek: tokens of ``token_ids`` covered by cached blocks,
        under the same one-token-suffix cap as :meth:`match`. Advisory
        only (the answer can change the moment the lock drops) — the
        disagg transfer planner uses it to size the uncached remainder a
        wire push must carry; admission still does a real pinning
        :meth:`match`."""
        ids = [int(t) for t in token_ids]
        bt = self.block_tokens
        limit = max(len(ids) - 1, 0) // bt
        with self._lock:
            node, n = self._root, 0
            for b in range(limit):
                child = node.children.get(tuple(ids[b * bt:(b + 1) * bt]))
                if child is None:
                    break
                n += 1
                node = child
            return n * bt

    def release(self, match: PrefixMatch) -> None:
        """Unpin a matched chain (idempotent)."""
        with self._lock:
            if match._released:
                return
            match._released = True
            for n in match._nodes:
                n.refs -= 1

    # ------------------------------------------------------------- insert

    def insert(self, token_ids) -> list[tuple[int, int]]:
        """Index every full block of ``token_ids``, allocating pages for
        the ones not already cached. Returns ``(block_id, block_index)``
        pairs for the NEW pages — the caller must copy the slot's pages
        into them (``CausalLMEngine.insert_prefix``) before dispatching
        anything that could match them; single-dispatcher ordering plus
        the device stream makes that automatic. Allocation stops early
        (prefix closure) when nothing is evictable."""
        ids = [int(t) for t in token_ids]
        bt = self.block_tokens
        out: list[tuple[int, int]] = []
        with self._lock:
            self._ticks += 1
            tick = self._ticks
            node = self._root
            for b in range(len(ids) // bt):
                key = tuple(ids[b * bt:(b + 1) * bt])
                child = node.children.get(key)
                if child is None:
                    block = self._alloc_locked()
                    if block is None:
                        break
                    child = _TrieNode(key, block, node)
                    node.children[key] = child
                    self._by_block[block] = child
                    out.append((block, b))
                child.tick = tick
                node = child
        return out

    def index(self, token_ids) -> tuple[list[tuple[int, int]], int]:
        """:meth:`insert` plus a coverage report: ``(new_pairs,
        covered_blocks)`` where ``covered_blocks`` counts the full blocks
        of ``token_ids`` present in the trie AFTER the insert. The
        preemption park path needs the distinction insert alone cannot
        give — allocation stops early under a full pool, and a parked
        chain that only partially covers its sequence is useless (the
        resume would still re-prefill the tail from the break point, but
        the scheduler promised the victim a near-free resume and must
        abort the preemption instead when the pool cannot hold it)."""
        ids = [int(t) for t in token_ids]
        bt = self.block_tokens
        out: list[tuple[int, int]] = []
        covered = 0
        with self._lock:
            self._ticks += 1
            tick = self._ticks
            node = self._root
            for b in range(len(ids) // bt):
                key = tuple(ids[b * bt:(b + 1) * bt])
                child = node.children.get(key)
                if child is None:
                    block = self._alloc_locked()
                    if block is None:
                        break
                    child = _TrieNode(key, block, node)
                    node.children[key] = child
                    self._by_block[block] = child
                    out.append((block, b))
                child.tick = tick
                covered = b + 1
                node = child
        return out, covered

    def forget(self, token_ids) -> int:
        """Drop the trailing unpinned leaf run of ``token_ids``'s cached
        chain (deepest-first, stopping at the first pinned or interior
        node — prefix closure holds). The undo path for a park-publish
        whose device copy failed AFTER :meth:`index` grew the trie: those
        blocks advertise token content their pages never received, and
        serving them would break bit-parity. Returns blocks freed."""
        ids = [int(t) for t in token_ids]
        bt = self.block_tokens
        with self._lock:
            node, chain = self._root, []
            for b in range(len(ids) // bt):
                child = node.children.get(tuple(ids[b * bt:(b + 1) * bt]))
                if child is None:
                    break
                chain.append(child)
                node = child
            freed = 0
            for n in reversed(chain):
                if n.children or n.refs:
                    break
                del n.parent.children[n.key]
                del self._by_block[n.block]
                self._free.append(n.block)
                freed += 1
            return freed

    def _alloc_locked(self) -> int | None:
        if self._free:
            return self._free.pop()
        victim = None
        for node in self._by_block.values():
            if node.children or node.refs:
                continue
            if victim is None or node.tick < victim.tick:
                victim = node
        if victim is None:
            return None  # everything pinned or interior: cannot evict
        del victim.parent.children[victim.key]
        del self._by_block[victim.block]
        self._evictions += 1
        self.recorder.record("prefix_evict", block=victim.block,
                             tick=victim.tick)
        return victim.block

    # -------------------------------------------------------------- stats

    def stats(self) -> dict:
        """Occupancy digest for ``status()`` / the ``serve_kv_pool_bytes``
        gauge."""
        with self._lock:
            used = len(self._by_block)
            return {
                "block_tokens": self.block_tokens,
                "blocks": self.n_blocks,
                "blocks_used": used,
                "dtype": self.dtype,
                "bytes_per_block": self.bytes_per_block,
                "bytes_used": used * self.bytes_per_block,
                "capacity_bytes": self.n_blocks * self.bytes_per_block,
                "evictions": self._evictions,
            }
