"""Synthetic masked-LM pretraining data (port of ``data/text.py``).

Token streams follow a fixed random Markov chain (token_{t+1} =
perm[token_t] with occasional uniform noise), so MLM is learnable from
bidirectional context; sentence pairs either continue the chain (NSP label
0, "is next") or jump to an unrelated chain (label 1). BERT-style masking:
15% of positions, 80% -> [MASK], 10% -> random, 10% kept.

Vocab layout: 0=[PAD] 1=[CLS] 2=[SEP] 3=[MASK], content tokens 4..vocab-1.

:class:`TextCorpusMLM` builds the same batches from plain-text files (one
sentence per line, blank lines between documents), with a word-level
vocabulary: 0=[PAD] 1=[CLS] 2=[SEP] 3=[MASK] 4=[UNK], words 5..V-1.

The batches are numpy, drawn in the JAX package's order, so the same seeds
give bit-identical batches in both packages; only the placement differs
(``torch`` tensors on the given device). :class:`SyntheticLM` draws
left-to-right causal-LM batches over the same chains.
"""

from __future__ import annotations

import dataclasses
import re
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from distributed_tensorflow_tpu_torch.device import resolve_device
from distributed_tensorflow_tpu_torch.parallel.mesh import process_rows

PAD, CLS, SEP, MASK = 0, 1, 2, 3
NUM_SPECIAL = 4


def _apply_bert_masking(rng, ids, mask_prob, rand_lo, rand_hi):
    """The BERT masking recipe, shared by every MLM dataset: select
    ``mask_prob`` of content positions (``ids >= NUM_SPECIAL``), then
    80% → [MASK], 10% → random token from ``[rand_lo, rand_hi)``, 10% kept.
    Returns ``(masked_ids, targets)`` with ``targets = -1`` off-selection.

    Draw order (selection r, action, random replacements) is part of the
    determinism contract — changing it changes every seeded batch.
    """
    content = ids >= NUM_SPECIAL
    r = rng.random(ids.shape)
    selected = content & (r < mask_prob)
    targets = np.where(selected, ids, -1).astype(np.int32)
    action = rng.random(ids.shape)
    masked_ids = ids.copy()
    masked_ids[selected & (action < 0.8)] = MASK
    rand_sites = selected & (action >= 0.8) & (action < 0.9)
    masked_ids[rand_sites] = rng.integers(
        rand_lo, rand_hi, size=int(rand_sites.sum())
    )
    return masked_ids, targets


@dataclasses.dataclass
class SyntheticMLMConfig:
    vocab_size: int = 1000
    seq_len: int = 128
    mask_prob: float = 0.15
    noise: float = 0.05  # chance a chain step jumps uniformly
    seed: int = 0


class SyntheticMLM:
    """Generates BERT pretraining batches: ids/mask/types/mlm targets/nsp."""

    def __init__(self, cfg: SyntheticMLMConfig):
        assert cfg.vocab_size > NUM_SPECIAL + 1
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        n_content = cfg.vocab_size - NUM_SPECIAL
        self._perm = rng.permutation(n_content)

    def _chains(self, rng, nrows: int, length: int) -> np.ndarray:
        """Vectorized Markov chains: [nrows, length] content tokens."""
        n = self.cfg.vocab_size - NUM_SPECIAL
        out = np.empty((nrows, length), np.int64)
        tok = rng.integers(0, n, nrows)
        for i in range(length):
            out[:, i] = tok
            jump = rng.random(nrows) < self.cfg.noise
            tok = np.where(jump, rng.integers(0, n, nrows), self._perm[tok])
        return out + NUM_SPECIAL

    def batch(
        self, batch_size: int, *, seed: int | tuple[int, ...]
    ) -> dict[str, np.ndarray]:
        """One batch, fully vectorized (the step-loop hot path on host)."""
        cfg = self.cfg
        key = (seed,) if isinstance(seed, int) else tuple(seed)
        rng = np.random.default_rng((cfg.seed, *key))
        L = cfg.seq_len
        # [CLS] a... [SEP] b... [SEP] — split content evenly.
        n_a = (L - 3) // 2
        n_b = L - 3 - n_a
        a = self._chains(rng, batch_size, n_a + n_b)
        b_new = self._chains(rng, batch_size, n_b)
        nsp = (rng.random(batch_size) < 0.5).astype(np.int32)  # 1 = random b
        b = np.where(nsp[:, None] == 1, b_new, a[:, n_a:])
        ids = np.empty((batch_size, L), np.int32)
        ids[:, 0] = CLS
        ids[:, 1 : n_a + 1] = a[:, :n_a]
        ids[:, n_a + 1] = SEP
        ids[:, n_a + 2 : n_a + 2 + n_b] = b
        ids[:, -1] = SEP
        types = np.zeros((batch_size, L), np.int32)
        types[:, n_a + 2 :] = 1
        attention_mask = np.ones((batch_size, L), bool)

        masked_ids, targets = _apply_bert_masking(
            rng, ids, cfg.mask_prob, NUM_SPECIAL, cfg.vocab_size
        )
        return {
            "input_ids": masked_ids,
            "attention_mask": attention_mask,
            "token_type_ids": types,
            "mlm_targets": targets,
            "nsp_label": nsp,
        }


class SyntheticLM(SyntheticMLM):
    """Left-to-right causal-LM batches over the same Markov chains:
    ``input_ids`` / ``attention_mask`` only (``cfg.mask_prob`` is unused).
    Row lengths vary over ``[L/2, L]`` with PAD tails, so the shift-by-one
    loss weighting is exercised."""

    def batch(
        self, batch_size: int, *, seed: int | tuple[int, ...]
    ) -> dict[str, np.ndarray]:
        cfg = self.cfg
        key = (seed,) if isinstance(seed, int) else tuple(seed)
        rng = np.random.default_rng((cfg.seed, *key))
        L = cfg.seq_len
        ids = np.empty((batch_size, L), np.int32)
        ids[:, 0] = CLS
        ids[:, 1:] = self._chains(rng, batch_size, L - 1)
        lengths = rng.integers(max(2, L // 2), L + 1, batch_size)
        attention_mask = np.arange(L)[None, :] < lengths[:, None]
        ids[~attention_mask] = PAD
        return {"input_ids": ids, "attention_mask": attention_mask}


UNK = 4
NUM_SPECIAL_TEXT = 5  # PAD CLS SEP MASK UNK

_WORD_RE = re.compile(r"[a-zA-Z0-9']+|[^\sa-zA-Z0-9]")


def _words(line: str, lowercase: bool) -> list[str]:
    if lowercase:
        line = line.lower()
    return _WORD_RE.findall(line)


@dataclasses.dataclass
class TextCorpusConfig:
    """Real-text BERT pretraining corpus: the real-data path beside the
    synthetic Markov stand-in."""

    seq_len: int = 128
    vocab_size: int = 30522  # cap; actual vocab may be smaller
    mask_prob: float = 0.15
    lowercase: bool = True
    seed: int = 0


class TextCorpusMLM:
    """BERT pretraining batches from plain-text files.

    Format: one sentence per line; blank lines separate documents (the
    classic BERT pretraining input convention). Tokenization is word-level
    with an [UNK] bucket (vocab = most-frequent words up to
    ``vocab_size``); masking/NSP semantics are identical to
    :class:`SyntheticMLM` (15% masked: 80/10/10; 50% random next-sentence),
    and the batch dict is interchangeable — ``mlm_device_batches`` and the
    train step don't know which one they're fed.

    Vocab layout: 0=[PAD] 1=[CLS] 2=[SEP] 3=[MASK] 4=[UNK], words 5..V-1.

    ``vocab_from``: reuse another corpus's vocabulary instead of building
    one from these files — a held-out val split must tokenize with the
    TRAIN vocab (unseen words become [UNK]) or its ids would be meaningless
    to the model.
    """

    def __init__(
        self,
        paths,
        cfg: TextCorpusConfig,
        *,
        vocab_from: "TextCorpusMLM | None" = None,
    ):
        self.cfg = cfg
        sents: list[list[str]] = []
        doc_last: list[bool] = []  # True if sentence ends its document
        for path in paths:
            doc_open = False
            for line in Path(path).read_text().splitlines():
                ws = _words(line, cfg.lowercase)
                if not ws:
                    if doc_open and doc_last:
                        doc_last[-1] = True
                    doc_open = False
                    continue
                sents.append(ws)
                doc_last.append(False)
                doc_open = True
            if doc_last:
                doc_last[-1] = True
        if not sents:
            raise ValueError(f"no sentences found in {list(paths)}")
        if vocab_from is not None:
            self.vocab = vocab_from.vocab
            self._ids = vocab_from._ids
            self.vocab_size = vocab_from.vocab_size
        else:
            freq = Counter(w for s in sents for w in s)
            n_words = min(len(freq), cfg.vocab_size - NUM_SPECIAL_TEXT)
            self.vocab = [w for w, _ in freq.most_common(n_words)]
            self._ids = {w: NUM_SPECIAL_TEXT + i for i, w in enumerate(self.vocab)}
            self.vocab_size = NUM_SPECIAL_TEXT + n_words
        self._sents = [
            np.asarray([self._ids.get(w, UNK) for w in s], np.int32) for s in sents
        ]
        self._doc_last = np.asarray(doc_last)

    def _segment(self, start: int, budget: int) -> tuple[np.ndarray, int, bool]:
        """Pack consecutive sentences from ``start`` into <= budget tokens.

        Returns ``(tokens, next_idx, doc_ended)``: ``next_idx`` is the first
        sentence AFTER the ones consumed (where a true next-sentence
        continuation must start) and ``doc_ended`` whether the segment's
        document (or the corpus) ends at its last sentence — in which case
        no continuation exists.
        """
        out: list[np.ndarray] = []
        n, i = 0, start
        while True:
            s = self._sents[i]
            out.append(s[: budget - n])
            n += len(out[-1])
            at_end = bool(self._doc_last[i]) or i + 1 >= len(self._sents)
            if n >= budget or at_end:
                return np.concatenate(out), i + 1, at_end
            i += 1

    def batch(
        self, batch_size: int, *, seed: int | tuple[int, ...]
    ) -> dict[str, np.ndarray]:
        cfg = self.cfg
        key = (seed,) if isinstance(seed, int) else tuple(seed)
        rng = np.random.default_rng((cfg.seed, 1, *key))
        L = cfg.seq_len
        n_a = (L - 3) // 2
        n_b = L - 3 - n_a
        ids = np.full((batch_size, L), PAD, np.int32)
        types = np.zeros((batch_size, L), np.int32)
        nsp = (rng.random(batch_size) < 0.5).astype(np.int32)  # 1 = random b
        n_sents = len(self._sents)
        for r in range(batch_size):
            start = int(rng.integers(0, n_sents))
            a, nxt, doc_ended = self._segment(start, n_a)
            # Continuation = the sentence right after the ones A consumed,
            # same document; random = an unrelated position (NSP label 1).
            # If A ran to its document's end, no continuation exists — fall
            # back to a random segment and relabel the pair as random.
            if nsp[r] or doc_ended:
                nsp[r] = 1
                b, _, _ = self._segment(int(rng.integers(0, n_sents)), n_b)
            else:
                b, _, _ = self._segment(nxt, n_b)
            row_len = 1 + len(a) + 1 + len(b) + 1
            ids[r, 0] = CLS
            ids[r, 1 : 1 + len(a)] = a
            ids[r, 1 + len(a)] = SEP
            ids[r, 2 + len(a) : 2 + len(a) + len(b)] = b
            ids[r, row_len - 1] = SEP
            types[r, 2 + len(a) : row_len] = 1
        attention_mask = ids != PAD

        # Identical masking recipe to SyntheticMLM (content = non-special,
        # which here includes [UNK]); random replacements draw real words.
        masked_ids, targets = _apply_bert_masking(
            rng, ids, cfg.mask_prob, NUM_SPECIAL_TEXT, self.vocab_size
        )
        return {
            "input_ids": masked_ids,
            "attention_mask": attention_mask,
            "token_type_ids": types,
            "mlm_targets": targets,
            "nsp_label": nsp,
        }


# Fixed generation granularity for mlm_device_batches: global row r of batch
# k always comes from chunk r // _ROW_CHUNK, whatever the process count.
_ROW_CHUNK = 8


def mlm_device_batches(
    dataset: SyntheticMLM,
    global_batch: int,
    *,
    device="cuda",
    seed: int = 0,
    start_step: int = 0,
    seq_sharded: bool = False,
    expert_sharded: bool = False,
):
    """Infinite iterator of BERT batches as tensors on ``device`` (the card
    by default).

    Batch k, global row r is a pure function of ``(seed, k, r //
    _ROW_CHUNK)``, whatever the number of processes: under several
    processes each rank generates only the row chunks that overlap its
    contiguous slice of ``global_batch`` (:func:`..parallel.mesh.process_rows`
    on the active mesh: ranks along ``"model"``, ``"seq"`` and
    ``"pipeline"`` share rows) and keeps its rows of them, and one process
    generates them all. So a restored run resumes at ``start_step`` with
    the batches an uninterrupted run would have seen. ``seq_sharded=True``
    (the JAX package's ``bert_batch_specs(..., seq_sharded=True)`` layout)
    keeps this rank's contiguous slice of the sequence of every ``[B, L]``
    leaf along the mesh's ``"seq"`` axis; the ``[B]`` NSP label stays whole.
    ``expert_sharded=True`` (``expert_sharded=True`` there: the token-sharded
    MoE dispatch) splits the rows over the ``"expert"`` axis too.
    Generation runs inline in ``next()``; wrap it in
    :func:`~.prefetch.prefetch` to move it off the step's critical path.
    """
    from distributed_tensorflow_tpu_torch.parallel.mesh import active_mesh, coordinate

    dev = resolve_device(device)
    mesh = active_mesh()
    start_row, stop_row = process_rows(global_batch, mesh,
                                       ("expert",) if expert_sharded else ())
    first = start_row // _ROW_CHUNK * _ROW_CHUNK
    rows = slice(start_row - first, stop_row - first)
    cols = slice(None)
    if seq_sharded and "seq" in mesh.axis_names:
        n_seq, seq_len = mesh.shape["seq"], dataset.cfg.seq_len
        if seq_len % n_seq:
            raise ValueError(f"sequence length {seq_len} not divisible by the "
                             f"{n_seq}-way 'seq' axis")
        width = seq_len // n_seq
        start = coordinate(mesh, ("seq",)) * width
        cols = slice(start, start + width)
    # Chunk c's size is fixed by the GLOBAL batch (the final chunk may be
    # partial), so every process sizes chunk c identically.
    chunk_sizes = [
        (c, min(_ROW_CHUNK, global_batch - c * _ROW_CHUNK))
        for c in range(start_row // _ROW_CHUNK, -(-stop_row // _ROW_CHUNK))
    ]
    step = start_step
    while True:
        chunks = [dataset.batch(size, seed=(seed, step, c)) for c, size in chunk_sizes]
        batch = {k: np.concatenate([c[k] for c in chunks], axis=0)[rows] for k in chunks[0]}
        yield {
            k: torch.from_numpy(np.ascontiguousarray(v if v.ndim == 1 else v[:, cols])).to(dev)
            for k, v in batch.items()
        }
        step += 1
