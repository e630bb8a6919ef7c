"""Synthetic masked-LM pretraining data (port of ``data/text.py``).

Token streams follow a fixed random Markov chain (token_{t+1} =
perm[token_t] with occasional uniform noise), so MLM is learnable from
bidirectional context; sentence pairs either continue the chain (NSP label
0, "is next") or jump to an unrelated chain (label 1). BERT-style masking:
15% of positions, 80% -> [MASK], 10% -> random, 10% kept.

Vocab layout: 0=[PAD] 1=[CLS] 2=[SEP] 3=[MASK], content tokens 4..vocab-1.

The batches are numpy, drawn in the JAX package's order, so the same seeds
give bit-identical batches in both packages; only the placement differs
(``torch`` tensors on the given device). ``TextCorpusMLM`` (real text) and
``SyntheticLM`` are ported with a later slice.
"""

from __future__ import annotations

import dataclasses

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
):
    """Infinite iterator of BERT batches as tensors on ``device`` (the card
    by default).

    Batch k, global row r is a pure function of ``(seed, k, r //
    _ROW_CHUNK)``, whatever the number of processes: under several
    processes each rank generates only the row chunks of its contiguous
    slice of ``global_batch`` (:func:`..parallel.mesh.process_rows`), and
    one process generates them all. So a restored run resumes at
    ``start_step`` with the batches an uninterrupted run would have seen.
    Generation runs inline in ``next()``; wrap it in
    :func:`~.prefetch.prefetch` to move it off the step's critical path.
    """
    dev = resolve_device(device)
    start_row, stop_row = process_rows(global_batch)
    local_b = stop_row - start_row
    if start_row % _ROW_CHUNK or (local_b % _ROW_CHUNK and stop_row != global_batch):
        raise ValueError(
            f"per-process batch {local_b} (offset {start_row}) must align to "
            f"the {_ROW_CHUNK}-row generation chunk"
        )
    # Chunk c's size is fixed by the GLOBAL batch (the final chunk may be
    # partial), so every process sizes chunk c identically.
    chunk_sizes = [
        (c, min(_ROW_CHUNK, global_batch - c * _ROW_CHUNK))
        for c in range(start_row // _ROW_CHUNK, -(-stop_row // _ROW_CHUNK))
    ]
    step = start_step
    while True:
        chunks = [dataset.batch(size, seed=(seed, step, c)) for c, size in chunk_sizes]
        yield {
            k: torch.from_numpy(np.concatenate([c[k] for c in chunks], axis=0)).to(dev)
            for k in chunks[0]
        }
        step += 1
