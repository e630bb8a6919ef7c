"""Port parity: ``TextCorpusMLM`` (real-text BERT pretraining batches)
against the JAX package's, on a tiny corpus the test writes.

The vocabulary (frequency order, the ``[UNK]`` bucket under a cap, the
val split tokenized with the train vocabulary) and every batch field
must equal the JAX class's exactly, so ``mlm_device_batches`` cannot tell
which package's source feeds it.
"""

from __future__ import annotations

import numpy as np
import pytest

from distributed_tensorflow_tpu.data import text as jtext
from distributed_tensorflow_tpu_torch.data import text
from distributed_tensorflow_tpu_torch.data.text import mlm_device_batches


@pytest.fixture()
def corpus(tmp_path):
    (tmp_path / "a.txt").write_text(
        "The quick brown fox jumps over the lazy dog.\n"
        "The dog sleeps all day, doesn't it?\n"
        "Foxes are quick and clever\n"
        "\n"
        "Distributed training needs fast input pipelines\n"
        "the pipeline feeds the accelerator\n"
        "accelerators are fast\n"
    )
    (tmp_path / "b.txt").write_text(
        "tensor meshes shard the batch\n\n\ncollectives ride the interconnect\n"
        "rings and trees reduce gradients\n"
    )
    (tmp_path / "val").mkdir()
    (tmp_path / "val" / "c.txt").write_text("the fox rides an unseen zeppelin\nthe end\n")
    return tmp_path


def _both(paths, **cfg):
    return (text.TextCorpusMLM(paths, text.TextCorpusConfig(**cfg)),
            jtext.TextCorpusMLM(paths, jtext.TextCorpusConfig(**cfg)))


def test_vocab_and_unk_equal_jax(corpus):
    paths = [corpus / "a.txt", corpus / "b.txt"]
    for cap in (30522, 12):
        got, want = _both(paths, seq_len=32, vocab_size=cap)
        assert got.vocab == want.vocab and got.vocab_size == want.vocab_size
        assert got.vocab[0] == "the" and text.UNK == jtext.UNK == 4
        for a, b in zip(got._sents, want._sents):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got._doc_last, want._doc_last)
    assert got.vocab_size == 12 and any((s == text.UNK).any() for s in got._sents)
    assert text._words("Don't STOP!", True) == jtext._words("Don't STOP!", True)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_batches_equal_jax(corpus, seed):
    got, want = _both([corpus / "a.txt", corpus / "b.txt"], seq_len=24, seed=seed)
    for key in (0, (3, 1), (seed, 5, 2)):
        g, w = got.batch(6, seed=key), want.batch(6, seed=key)
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_nsp_continuation_is_the_next_sentence(tmp_path):
    """nsp=0 pairs A with the sentence right after it, in the same document."""
    (tmp_path / "c.txt").write_text("alpha\nbravo\ncharlie\ndelta\necho\n\nxray\nyankee\nzulu\n")
    ds = text.TextCorpusMLM([tmp_path / "c.txt"],
                            text.TextCorpusConfig(seq_len=7, mask_prob=0.0, seed=0))
    order = [ds._ids[w] for w in ("alpha", "bravo", "charlie", "delta", "echo")]
    follows = {order[i]: order[i + 1] for i in range(4)}
    d2 = [ds._ids[w] for w in ("xray", "yankee", "zulu")]
    follows.update({d2[0]: d2[1], d2[1]: d2[2]})
    checked = 0
    for s in range(12):
        b = ds.batch(16, seed=s)
        for r in np.flatnonzero(b["nsp_label"] == 0):
            ids = b["input_ids"][r]
            sep = np.flatnonzero(ids == text.SEP)[0]
            assert follows.get(int(ids[sep - 1])) == int(ids[sep + 1])
            checked += 1
    assert checked > 20


def test_val_split_reuses_the_train_vocab(corpus):
    train, jtrain = _both([corpus / "a.txt", corpus / "b.txt"], seq_len=16)
    val = text.TextCorpusMLM([corpus / "val" / "c.txt"], train.cfg, vocab_from=train)
    jval = jtext.TextCorpusMLM([corpus / "val" / "c.txt"], jtrain.cfg, vocab_from=jtrain)
    assert val.vocab_size == train.vocab_size
    assert (val._sents[0] == text.UNK).sum() == 4  # rides, an, unseen, zeppelin
    g, w = val.batch(4, seed=2), jval.batch(4, seed=2)
    for k in w:
        np.testing.assert_array_equal(g[k], w[k])


def test_mlm_device_batches_take_the_corpus(corpus):
    ds, jds = _both([corpus / "a.txt", corpus / "b.txt"], seq_len=16)
    b = next(mlm_device_batches(ds, 16, device="cpu", seed=1, start_step=2))
    want = [jds.batch(8, seed=(1, 2, c)) for c in (0, 1)]
    for k in want[0]:
        np.testing.assert_array_equal(b[k].numpy(), np.concatenate([w[k] for w in want]))
