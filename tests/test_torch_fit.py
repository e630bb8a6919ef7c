"""Port parity and behaviour: the MLM batch stream, ``fit`` with the
``Checkpointer``, and the training CLI, on the CPU at tiny sizes.

Batches must be bit-identical to the JAX package's for the same seeds
(numpy draws in the same order); resumed runs must reproduce the next loss
of an uninterrupted one exactly (same arithmetic on the same device). JAX
is imported inside the one test that needs it, so the spawned
data-parallel workers import only torch and the port.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu_torch.data.text import (
    SyntheticMLM,
    SyntheticMLMConfig,
    mlm_device_batches,
)
from distributed_tensorflow_tpu_torch.models.bert import (
    BertConfig,
    BertForPreTraining,
    make_bert_pretraining_loss,
)
from distributed_tensorflow_tpu_torch.train import (
    NonFiniteLossError,
    create_train_state,
    fit,
    make_train_step,
)

GEOM = dict(vocab_size=64, hidden_size=32, num_layers=1, num_heads=2,
            intermediate_size=64, max_position=16)


@pytest.mark.parametrize("global_batch", [16, 12], ids=["whole-chunks", "partial-chunk"])
def test_mlm_stream_is_bit_identical_to_jax(global_batch):
    import jax

    from distributed_tensorflow_tpu.data.text import SyntheticMLM as JaxMLM
    from distributed_tensorflow_tpu.data.text import SyntheticMLMConfig as JaxMLMConfig
    from distributed_tensorflow_tpu.data.text import mlm_device_batches as jax_batches
    from distributed_tensorflow_tpu.parallel.mesh import build_mesh

    mesh = build_mesh({"data": 1}, devices=jax.devices()[:1])
    cfg = dict(vocab_size=50, seq_len=24, seed=7)
    ref = jax_batches(JaxMLM(JaxMLMConfig(**cfg)), mesh, global_batch, seed=1)
    ours = mlm_device_batches(SyntheticMLM(SyntheticMLMConfig(**cfg)), global_batch,
                              device="cpu", seed=1)
    expected = [jax.tree.map(np.asarray, next(ref)) for _ in range(3)]
    for want in expected:
        got = next(ours)
        assert set(got) == set(want)
        for k in want:
            assert got[k].numpy().dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    # start_step resume: the stream picks up at batch 2.
    resumed = mlm_device_batches(SyntheticMLM(SyntheticMLMConfig(**cfg)), global_batch,
                                 device="cpu", seed=1, start_step=2)
    got = next(resumed)
    for k in expected[2]:
        np.testing.assert_array_equal(got[k].numpy(), expected[2][k], err_msg=k)


def test_lm_stream_is_bit_identical_to_jax():
    """``SyntheticLM`` through ``mlm_device_batches``: the JAX package's
    causal-LM batches (ids, PAD tails, masks) bit for bit."""
    import jax

    from distributed_tensorflow_tpu.data.text import SyntheticLM as JaxLM
    from distributed_tensorflow_tpu.data.text import SyntheticMLMConfig as JaxLMConfig
    from distributed_tensorflow_tpu.data.text import mlm_device_batches as jax_batches
    from distributed_tensorflow_tpu.parallel.mesh import build_mesh
    from distributed_tensorflow_tpu_torch.data.text import SyntheticLM

    mesh = build_mesh({"data": 1}, devices=jax.devices()[:1])
    cfg = dict(vocab_size=50, seq_len=24, seed=7)
    ref = jax_batches(JaxLM(JaxLMConfig(**cfg)), mesh, 12, seed=1)
    ours = mlm_device_batches(SyntheticLM(SyntheticMLMConfig(**cfg)), 12, device="cpu", seed=1)
    for _ in range(2):
        want = jax.tree.map(np.asarray, next(ref))
        got = next(ours)
        assert set(got) == set(want) == {"input_ids", "attention_mask"}
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
        assert not want["attention_mask"].all()  # PAD tails exercised


def _setup(seed: int):
    from distributed_tensorflow_tpu_torch.cli.train import PRESETS, _make_tx

    cfg = dataclasses.replace(PRESETS["bert_base"], num_steps=4, warmup_steps=1,
                              learning_rate=1e-3)
    model = BertForPreTraining(BertConfig(**GEOM, dropout_rate=0.1), device="cpu", seed=seed)
    tx, _ = _make_tx(cfg)
    state = create_train_state(dict(model.named_parameters()), tx)
    step = make_train_step(make_bert_pretraining_loss(model), tx, clip_norm=1.0)
    data = SyntheticMLM(SyntheticMLMConfig(vocab_size=GEOM["vocab_size"], seq_len=16))
    return state, step, lambda start: mlm_device_batches(data, 8, device="cpu", seed=1,
                                                         start_step=start)


def test_fit_checkpoint_resume_gives_the_same_next_loss(tmp_path):
    """A run saved at step 2 and restored into a fresh model (other init,
    other generator seed) takes step 3 with the same loss, dropout included,
    as the run that never stopped; the checkpoint also serves."""
    from distributed_tensorflow_tpu_torch.ckpt import Checkpointer, restore_serving_state

    losses = {}

    def record(key):
        return lambda step, state, metrics: losses.setdefault(key, {}).update(
            {step: metrics["loss"]})

    state, step, batches = _setup(seed=0)
    with Checkpointer(tmp_path / "ck") as ckpt:
        fit(state, step, batches(0), num_steps=3, rng=torch.Generator().manual_seed(11),
            log_every=1, hooks=(record("full"),), checkpointer=ckpt, ckpt_every=2)
    state2, step2, batches2 = _setup(seed=1)
    rng = torch.Generator().manual_seed(99)
    with Checkpointer(tmp_path / "ck") as ckpt:
        state2, start = ckpt.restore_latest(state2, generator=rng)
        assert start == 2 and state2.step == 2 and rng.initial_seed() == 11
        fit(state2, step2, batches2(start), num_steps=3, rng=rng, log_every=1,
            hooks=(record("resumed"),))
    assert losses["resumed"] == {3: losses["full"][3]}
    params, _, served_step = restore_serving_state(tmp_path / "ck")
    assert served_step == 2
    model = BertForPreTraining(BertConfig(**GEOM), device="cpu")
    model.load_state_dict(params)


def test_checkpointer_save_snapshots_cpu_state_before_it_changes(tmp_path, monkeypatch):
    """``Checkpointer.save`` on a CPU state writes that step's values even
    when the step after it updates the params, the stale ring and the
    BatchNorm statistics in place before the writer thread runs. The writer
    is held until the state has changed, so a snapshot that shares storage
    with the live tensors fails every time, not only when it loses a race."""
    import threading

    from distributed_tensorflow_tpu_torch.cli.train import PRESETS, _make_tx
    from distributed_tensorflow_tpu_torch.ckpt import Checkpointer
    from distributed_tensorflow_tpu_torch.ckpt import checkpoint as ck

    tx, _ = _make_tx(PRESETS["bert_base"])
    state = create_train_state({"w": torch.zeros(512, 1024)}, tx,
                               {"mean": torch.zeros(1024)}, staleness=1)
    release = threading.Event()
    write = ck._write

    def held_write(*args):
        assert release.wait(30), "the test never released the writer"
        return write(*args)

    monkeypatch.setattr(ck, "_write", held_write)
    with Checkpointer(tmp_path / "ck") as ckpt:
        ckpt.save(0, state)
        with torch.no_grad():
            for t in (state.params["w"], state.grad_buffer["w"], state.model_state["mean"]):
                t.add_(1)
        release.set()
        ckpt.wait()
    blob = torch.load(ck._step_path(tmp_path / "ck", 0), weights_only=True)
    assert torch.equal(blob["params"]["w"], torch.zeros(512, 1024))
    assert torch.equal(blob["grad_buffer"]["w"], torch.zeros(1, 512, 1024))
    assert torch.equal(blob["model_state"]["mean"], torch.zeros(1024))
    assert torch.equal(state.params["w"], torch.ones(512, 1024))


@pytest.mark.parametrize("policy", ["abort", "skip"])
def test_fit_nonfinite_loss_guard(policy):
    from distributed_tensorflow_tpu_torch.obs.flightrec import FlightRecorder

    state, step, batches = _setup(seed=0)

    def poisoned(state, batch, rng):
        state, metrics = step(state, batch, rng)
        metrics["loss"] = torch.tensor(float("nan"))
        return state, metrics

    recorder = FlightRecorder()
    if policy == "abort":
        with pytest.raises(NonFiniteLossError, match="step 2"):
            fit(state, poisoned, batches(0), num_steps=3, log_every=2, nonfinite=policy,
                recorder=recorder)
    else:
        state, _ = fit(state, poisoned, batches(0), num_steps=3, log_every=2,
                       nonfinite=policy, recorder=recorder)
        assert state.step == 3
    events = [e["kind"] for e in recorder.events()]
    assert "nonfinite_loss" in events
    # An injected nonfinite_loss reaches the same guard through the fetched
    # loss, under the same policy, and leaves the state finite.
    from distributed_tensorflow_tpu_torch.train import FaultEvent, FaultInjector, FaultPlan

    injector = FaultInjector(FaultPlan((FaultEvent("nonfinite_loss", state.step),)),
                             recorder=recorder)
    start = state.step
    if policy == "abort":
        with pytest.raises(NonFiniteLossError, match=f"step {start + 1}"):
            fit(state, step, batches(start), num_steps=start + 2, log_every=1,
                fault_injector=injector, recorder=recorder)
    else:
        state, _ = fit(state, step, batches(start), num_steps=start + 2, log_every=1,
                       nonfinite=policy, fault_injector=injector, recorder=recorder)
        assert state.step == start + 2
    assert all(torch.isfinite(p).all() for p in state.params.values())
    assert [e["fault"] for e in recorder.events() if e["kind"] == "fault_injected"] == [
        "nonfinite_loss"]


def test_train_cli_bert_base_on_cpu_then_serve(tmp_path):
    """The bert_base preset through ``cli.train`` on ``--device cpu`` at a
    tiny geometry; its checkpoint restores for serving and answers."""
    from distributed_tensorflow_tpu_torch.ckpt import latest_step, restore_serving_state
    from distributed_tensorflow_tpu_torch.cli.train import main
    from distributed_tensorflow_tpu_torch.serve import BertInferenceEngine

    ck = tmp_path / "ck"
    assert main(["--config", "bert_base", "--device", "cpu", "--bert-layers", "1",
                 "--bert-hidden", "48", "--bert-vocab", "64", "--steps", "3",
                 "--global-batch", "8", "--log-every", "1", "--eval-every", "3",
                 "--eval-batches", "1", "--ckpt-dir", str(ck)]) == 0
    assert latest_step(ck) == 3
    params, _, step = restore_serving_state(ck)
    assert step == 3
    cfg = BertConfig(vocab_size=64, hidden_size=48, num_layers=1, intermediate_size=192,
                     max_position=128, dtype=torch.bfloat16)
    engine = BertInferenceEngine(BertForPreTraining(cfg, device="cpu"), params, "cpu",
                                 buckets=(16,), max_batch=1, batch_tiers=(1,))
    out = engine.run_batch([{"input_ids": np.arange(5, 15)}])
    assert out[0]["pred_ids"].shape == (10,)


@pytest.mark.parametrize(
    "argv,message",
    [(["--config", "no_such_preset"], "unknown preset"),
     (["--config", "bert_base", "--moe-experts", "2", "--moe-topk", "3"],
      "--moe-topk=3 must be in [1, --moe-experts=2]"),
     (["--config", "bert_base", "--profile-steps", "2"],
      "--profile-steps requires --profile-dir")],
    ids=["preset", "parallel-flag", "profile-steps"],
)
def test_train_cli_refuses_unported_paths(argv, message, capsys):
    from distributed_tensorflow_tpu_torch.cli.train import main

    with pytest.raises(SystemExit):
        main(argv + ["--device", "cpu"])
    assert message in capsys.readouterr().err


def test_train_cli_lm_base_steps_match_jax(tmp_path):
    """The lm_base preset at a tiny width (1 layer, hidden 48, the preset's
    12 heads and 128 positions, vocab 64, 8 rows), its AdamW, decay mask
    and clipping at a constant 1e-3 (the preset's 1000-step warmup would
    leave the first updates at lr ~0): the CLI's three logged losses equal
    the JAX step's on the same initial params and the same ``SyntheticLM``
    batches, within 2e-2 (bf16 compute on both sides, the roundings at
    other points; the BERT recipe test's bf16 bound), and so do the moves
    of the loss from step 1."""
    import json

    import jax
    import jax.numpy as jnp

    from distributed_tensorflow_tpu.cli.train import PRESETS as JAX_PRESETS
    from distributed_tensorflow_tpu.cli.train import _decay_mask as jax_mask
    from distributed_tensorflow_tpu.cli.train import _make_tx as jax_tx
    from distributed_tensorflow_tpu.data.text import SyntheticLM as JaxLM
    from distributed_tensorflow_tpu.data.text import SyntheticMLMConfig as JaxLMConfig
    from distributed_tensorflow_tpu.data.text import mlm_device_batches as jax_batches
    from distributed_tensorflow_tpu.models.causal_lm import CausalLM, CausalLMConfig
    from distributed_tensorflow_tpu.models.causal_lm import make_causal_lm_loss
    from distributed_tensorflow_tpu.parallel.mesh import build_mesh
    from distributed_tensorflow_tpu.train import create_train_state as jax_state
    from distributed_tensorflow_tpu.train import make_train_step as jax_step
    from distributed_tensorflow_tpu.train.step import place_state
    from distributed_tensorflow_tpu_torch.cli.train import PRESETS, _decay_mask, main
    from distributed_tensorflow_tpu_torch.interop import causal_lm_params_to_flax

    width = dict(bert_layers=1, bert_hidden=48, bert_vocab=64, global_batch=8, num_steps=3,
                 lr_schedule="constant", learning_rate=1e-3)
    jsonl = tmp_path / "m.jsonl"
    assert main(["--config", "lm_base", "--device", "cpu", "--bert-layers", "1",
                 "--bert-hidden", "48", "--bert-vocab", "64", "--global-batch", "8",
                 "--steps", "3", "--lr-schedule", "constant", "--lr", "1e-3",
                 "--log-every", "1", "--prefetch", "0", "--metrics-jsonl", str(jsonl)]) == 0
    port_losses = [json.loads(line)["loss"] for line in jsonl.read_text().splitlines()]

    pcfg = dataclasses.replace(PRESETS["lm_base"], **width)
    init = pcfg.build(pcfg)("cpu")["params"]  # the CLI's seeded init
    flax = causal_lm_params_to_flax({k: v.detach() for k, v in init.items()}, num_heads=12)
    jcfg = dataclasses.replace(JAX_PRESETS["lm_base"], **width)
    mesh = build_mesh({"data": 1}, devices=jax.devices()[:1])
    tx, _ = jax_tx(jcfg)
    state = place_state(jax_state(jax.tree.map(jnp.asarray, flax), tx), mesh)
    model = CausalLM(CausalLMConfig(vocab_size=64, hidden_size=48, num_layers=1,
                                    num_heads=12, intermediate_size=192, max_position=128,
                                    dtype=jnp.bfloat16))
    step = jax_step(make_causal_lm_loss(model), tx, mesh, clip_norm=jcfg.clip_norm)
    batches = jax_batches(JaxLM(JaxLMConfig(vocab_size=64, seq_len=128, seed=0)), mesh, 8,
                          seed=1)
    jax_losses = []
    for _ in range(3):
        state, metrics = step(state, next(batches), jax.random.key(0))
        jax_losses.append(float(metrics["loss"]))
    assert len(port_losses) == 3 and np.isfinite(port_losses).all()
    np.testing.assert_allclose(port_losses, jax_losses, atol=2e-2)
    # The moves (about -0.06 and -0.04) within 2e-3: a lr off by 2x moves
    # them by 0.03 or more.
    np.testing.assert_allclose(np.diff(port_losses), np.diff(jax_losses), atol=2e-3)
    # The decay mask over the causal tree, leaf by leaf.
    mask = _decay_mask(init)
    filled = {k: torch.full_like(p, float(mask[k])) for k, p in init.items()}
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), b),
                 causal_lm_params_to_flax(filled, num_heads=12),
                 jax.tree.map(np.float32, jax_mask(flax)))


def test_train_cli_bert_base_reads_a_text_corpus(tmp_path, caplog):
    """``--data-dir`` with ``*.txt`` and ``val/*.txt``: the corpus's vocabulary
    is logged and the eval runs on the val split; a corpus without a val
    split, and a directory without text, give the JAX CLI's warnings."""
    from distributed_tensorflow_tpu_torch.cli.train import main

    corpus = tmp_path / "corpus"
    (corpus / "val").mkdir(parents=True)
    rng = np.random.default_rng(0)
    words = [f"w{i}" for i in range(40)]
    for name in ("a.txt", "b.txt", "val/c.txt"):
        docs = ["\n".join(" ".join(rng.choice(words, 6)) for _ in range(4)) for _ in range(3)]
        (corpus / name).write_text("\n\n".join(docs) + "\n")
    argv = ["--config", "bert_base", "--device", "cpu", "--bert-layers", "1",
            "--bert-hidden", "48", "--bert-vocab", "64", "--steps", "2", "--global-batch", "8",
            "--log-every", "1", "--eval-every", "2", "--eval-batches", "1"]
    with caplog.at_level("INFO"):
        assert main(argv + ["--data-dir", str(corpus)]) == 0
    assert "text corpus: 2 files, 24 sentences, vocab_size=43 (cap 64)" in caplog.text
    assert "eval_mlm_accuracy=" in caplog.text
    for data_dir, warning in ((corpus / "val", "RESAMPLE THE TRAINING TEXT"),
                              (tmp_path, "FALLING BACK TO SYNTHETIC MLM DATA")):
        caplog.clear()
        with caplog.at_level("WARNING"):
            assert main(argv + ["--steps", "1", "--data-dir", str(data_dir)]) == 0
        assert warning in caplog.text


def _dp_worker(rank, world, port, out_dir):
    """One rank of a 2-process gloo group: its slice of the batch stream and
    one sync-DP step of a row-mean loss."""
    import torch.distributed as dist

    from distributed_tensorflow_tpu_torch.parallel.collectives import pmean_tree, psum_tree
    from distributed_tensorflow_tpu_torch.train.state import Transform

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        summed = psum_tree({"x": torch.tensor([float(rank + 1)])})
        meaned = pmean_tree([torch.tensor([float(rank + 1)])])
        data = SyntheticMLM(SyntheticMLMConfig(vocab_size=50, seq_len=16, seed=7))
        batch = next(mlm_device_batches(data, 16, device="cpu", seed=1))
        state, step = _linear_dp_setup(create_train_state, make_train_step, Transform)
        state, metrics = step(state, batch, torch.Generator().manual_seed(0))
        torch.save({"batch": batch, "params": state.params, "loss": metrics["loss"],
                    "sum": summed["x"], "mean": meaned[0]}, out_dir / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _linear_dp_setup(create_train_state, make_train_step, Transform):
    """A linear model under a row-mean loss: its data-parallel mean gradient
    equals the full-batch gradient exactly (up to summation order)."""
    rng = np.random.default_rng(0)
    params = {"w": torch.tensor(rng.standard_normal(16), dtype=torch.float32,
                                requires_grad=True)}

    def loss_fn(params, model_state, batch, generator):
        x = batch["input_ids"].float() / 50.0
        return ((x @ params["w"]) ** 2).mean(), (model_state, {})

    tx = Transform(lambda p: torch.optim.SGD(p.values(), lr=0.1), lambda count: 0.1)
    return create_train_state(params, tx), make_train_step(loss_fn, tx, clip_norm=1.0)


def test_two_process_data_parallel_step_matches_one_process(tmp_path):
    """Under a 2-process gloo group: psum/pmean reduce across ranks, each
    rank generates its half of the global batch (together the one-process
    batch, bit for bit), and one sync-DP step equals the one-process step
    on the whole batch."""
    import socket
    import time

    import torch.multiprocessing as mp

    from distributed_tensorflow_tpu_torch.train.state import Transform

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.start_processes(_dp_worker, args=(2, port, tmp_path), nprocs=2, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + 120
    try:
        # join() returns each time a rank exits: True once both have.
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
            assert time.monotonic() < deadline, "the ranks did not finish within 120 s"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=True) for r in range(2)]
    data = SyntheticMLM(SyntheticMLMConfig(vocab_size=50, seq_len=16, seed=7))
    whole = next(mlm_device_batches(data, 16, device="cpu", seed=1))
    for k, v in whole.items():
        assert torch.equal(torch.cat([r["batch"][k] for r in ranks]), v), k
    state, step = _linear_dp_setup(create_train_state, make_train_step, Transform)
    state, metrics = step(state, whole, torch.Generator().manual_seed(0))
    for r in ranks:
        assert r["sum"].item() == 3.0 and r["mean"].item() == 1.5
        torch.testing.assert_close(r["params"]["w"], state.params["w"].detach(),
                                   atol=1e-6, rtol=1e-6)
        torch.testing.assert_close(r["loss"], metrics["loss"], atol=1e-6, rtol=1e-6)
