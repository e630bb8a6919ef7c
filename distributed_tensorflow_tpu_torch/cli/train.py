"""``python -m distributed_tensorflow_tpu_torch.cli.train --config <preset>``.

Port of the JAX package's ``cli/train.py``, on the card by default
(``--device cpu`` runs on the CPU), in one process or as one rank of a
multi-process job (``--coordinator-address host:port --num-processes N
--process-id i`` in each process, or a torchrun environment; each rank
trains on its own card and ``--global-batch`` stays global), for the
presets ``bert_base`` (MLM + NSP pretraining), ``lm_base`` (the causal
LM's next-token pretraining on ``SyntheticLM``), ``mnist_lenet``,
``cifar_resnet20``, ``imagenet_resnet50`` and ``imagenet_inception_async``
(image classification with BatchNorm statistics in the train state; the
last under K = 4 stale gradients), under synchronous or K-stale data
parallelism. The optimizer recipes keep the JAX names:
:func:`make_lr_schedule`, :func:`_decay_mask` and :func:`_make_tx`.

Data: ``--data-dir`` points the image presets at MNIST idx files, CIFAR-10
pickles or an ImageNet-class u8 cache, class-folder tree or TFRecord shards
(:mod:`..data.readers`), and ``bert_base`` at ``*.txt`` files with an
optional ``val/*.txt`` split (:class:`..data.text.TextCorpusMLM`); without
it (or when it holds no data, with a loud warning) the data is seeded and
synthetic. The image presets train through the host C++ pipeline with the
JAX presets' augmentation (``cifar``: pad-crop and flip; ``imagenet``:
random-resized crop, flip and, for u8 pixels, ImageNet mean/std), and
evaluate through the numpy feed (center crop, mean/std).

One deliberate difference from the JAX CLI: when the host library cannot
be built, the run fails with g++'s output instead of falling back to the
numpy feed, which would train on other batches. ``--no-native-input``
asks for the numpy feed. ``--device-pool N`` keeps the first N batches on
the card and cycles them; ``--prefetch N`` sets the feed's lookahead.

Observability: ``--metrics-jsonl`` and ``--tb-dir`` (refused at once when
the ``tensorboard`` package is missing) receive every logged step's
metrics, ``--trace-dir`` the host span trace (``train_trace.json``), and
``--profile-dir`` (``--profile-steps N``: the first N steps only) a
``torch.profiler`` Chrome trace with the card's kernels.

Model parallelism (``bert_base``): ``--tensor-parallel T`` shards heads and
the FFN over a ``"model"`` axis (Megatron), ``--seq-parallel S --sp-impl
ring|ulysses`` the sequence over a ``"seq"`` axis, ``--moe-experts N``
makes every FFN a mixture of N experts (``--moe-topk 1|2``: Switch or
GShard routing) which ``--expert-parallel E`` shards over an ``"expert"``
axis (``--moe-dispatch replicated|alltoall|sharded``; ``sharded`` splits
the batch rows over the expert axis too), and ``--pipeline-parallel P``
stage-shards the encoder over a ``"pipeline"`` axis under the GPipe
schedule (``--pipeline-microbatches M``, default 4P). The mesh is
``{"data": -1, "pipeline": P, "expert": E, "seq": S, "model": T}`` over the
job's processes, as in the JAX CLI, and its layout (``dp2-pp2-ep2``) is in
the log (the ``--metrics-jsonl`` records keep the JAX CLI's keys).
Parameters are drawn at the global expert count and layer stack, and
checkpoints hold the global tree, so they restore at any layout and serve
unchanged (a stacked encoder sequentially on one process). A requested
axis over which the workload shards no parameter (or no sequence), Ulysses
over heads the axis does not divide, ``--moe-dispatch sharded`` without
``--expert-parallel`` > 1, a ``--moe-topk`` outside ``[1, experts]`` and
per-shard rows the microbatches do not divide exit 2. ``lm_base`` trains
under ``--tensor-parallel N`` the same way (the causal LM's Megatron TP,
:func:`..models.causal_lm.causal_param_specs`; its checkpoint holds the
global tree and restores at any width); an expert or pipeline axis over
it exits 2, as in the JAX CLI.

Resilience: ``--resilient`` (``--max-restarts N``) runs the loop under
:func:`..train.resilience.run_resilient`: SIGTERM/SIGINT stop at the next
step with a final synchronous checkpoint and exit 0, and transient feeder
or checkpoint-IO failures restore the newest checkpoint and retry with
backoff. ``--fault-plan`` arms seeded fault injection in the loop, the feed
and the checkpointer; ``--nonfinite abort|skip`` is the NaN-loss policy;
``--beacon-dir`` writes this rank's health beacon at the log cadence and at
the end; ``--dump-dir`` arms the flight recorder, which an unhandled
failure dumps.

The other presets and the flags of the paths not ported yet are refused
with a message naming the slice that brings them. The JAX CLI trains
ResNet-50 and Inception-v3 with plain convolutions, so this one has no
``pw_backend`` or ``fused`` flag either; ``ResNet50(pw_backend=...)`` and
``InceptionV3(fused=True)`` select the kernels.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib.util
import itertools
import logging
import math
from collections.abc import Callable, Iterator
from pathlib import Path
from typing import Any

import numpy as np
import torch

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    """One training workload: model + data + optimization."""

    name: str
    build: Callable[["WorkloadConfig"], Any]  # cfg -> make(device) -> pieces
    global_batch: int
    num_steps: int
    learning_rate: float
    momentum: float = 0.9
    optimizer: str = "sgd"  # "sgd" | "adam" | "adamw"
    weight_decay: float = 0.0  # adamw decoupled weight decay
    clip_norm: float = 0.0  # > 0: global-norm gradient clipping in the step
    grad_accum: int = 1  # > 1: micro-slice gradient accumulation in the step
    lr_schedule: str = "constant"  # "constant" | "warmup_cosine" | "piecewise"
    warmup_steps: int = 0
    mode: str = "sync"  # "sync" | "stale"
    staleness: int = 0
    seq_parallel: int = 0  # > 0: "seq" axis size (BERT ring or Ulysses attention)
    sp_impl: str = "ring"  # "ring" | "ulysses"
    tensor_parallel: int = 0  # > 0: "model" axis size (BERT Megatron TP)
    moe_experts: int = 0  # > 0: a switch-MoE FFN with this many experts (BERT)
    expert_parallel: int = 0  # > 0: "expert" axis size (BERT MoE)
    # "replicated" | "alltoall" (capacity buffers over replicated tokens) |
    # "sharded" (the batch rows split over the expert axis too)
    moe_dispatch: str = "replicated"
    moe_topk: int = 1  # routing fan-out: 1 = Switch, 2 = GShard top-2
    pipeline_parallel: int = 0  # > 0: "pipeline" axis size (BERT GPipe stages)
    pipeline_microbatches: int = 0  # GPipe M; 0 -> 4 * pipeline_parallel
    remat: bool = False  # activation checkpointing over encoder layers
    bert_layers: int = 0  # > 0: override encoder depth (smoke runs)
    bert_hidden: int = 0  # > 0: override hidden size (intermediate = 4x)
    bert_vocab: int = 0  # > 0: override vocab size (smoke runs)
    image_size: int = 0  # > 0: override the image presets' square geometry
    dataset: str = ""  # dataset name for data.readers.load_dataset
    data_dir: str = ""  # where to look for it; synthetic fallback otherwise
    augment: str = ""  # "" | "cifar" (pad-crop+flip) | "imagenet" (RRC+flip)
    native_input: bool = True  # train through the host C++ pipeline
    # > 0: place the first N batches on the card once and cycle them: no
    # host->device transfer in the hot loop. For throughput runs on
    # feed-bound hosts; the model revisits the pool every N steps.
    device_pool: int = 0
    # Feed lookahead (data/prefetch.py): a feeder thread runs assembly and
    # the host->device copy this many batches ahead; 0 = synchronous feed.
    # Streams are bit-identical either way.
    prefetch: int = 2
    log_every: int = 50


def make_lr_schedule(cfg: WorkloadConfig) -> Callable[[int], float]:
    """The learning rate at update ``count`` (0-based), as optax computes it.

    ``warmup_cosine``: linear warmup from 0 to the peak over
    ``warmup_steps`` (default 5% of the run), then cosine decay to
    ``peak * 1e-3`` at ``num_steps`` (``optax.warmup_cosine_decay_schedule``).
    ``piecewise``: x0.1 from 50% and again from 75% of the run.
    ``constant``: the peak throughout. Update 0 of a warmup runs at lr 0.
    """
    lr = cfg.learning_rate
    if cfg.lr_schedule == "constant":
        return lambda count: lr
    if cfg.lr_schedule == "warmup_cosine":
        warmup = cfg.warmup_steps or max(1, cfg.num_steps // 20)
        decay = max(cfg.num_steps, warmup + 1) - warmup
        alpha = 1e-3

        def warmup_cosine(count: int) -> float:
            if count < warmup:
                return lr * count / warmup
            t = min(count - warmup, decay)
            return lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / decay)) + alpha)

        return warmup_cosine
    if cfg.lr_schedule == "piecewise":
        # optax takes the bounds as dict keys: a bound that repeats (at 1
        # and 2 steps both fall on one step) scales the rate once.
        bounds = {cfg.num_steps // 2, (3 * cfg.num_steps) // 4}
        return lambda count: lr * 0.1 ** sum(count >= b for b in bounds)
    raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")


def _decay_mask(params: dict[str, torch.Tensor]) -> dict[str, bool]:
    """AdamW decoupled-weight-decay mask, the canonical BERT recipe: decay
    weight matrices and embeddings only. Parameters of rank < 2, anything
    named like a bias (the MoE expert bias stacks ``experts_b1``/``_b2`` are
    2-D), and anything under a LayerNorm module (a stacked encoder's scales
    are 2-D too) never decay."""

    def decays(name: str, p: torch.Tensor) -> bool:
        parts = name.split(".")
        if p.dim() < 2 or "bias" in parts[-1] or parts[-1] in ("experts_b1", "experts_b2"):
            return False
        return not any(
            n == "ln" or n.endswith("_ln") or n.endswith("_bn")
            or "LayerNorm" in n or "BatchNorm" in n
            for n in parts[:-1]
        )

    return {name: decays(name, p) for name, p in params.items()}


def _make_tx(cfg: WorkloadConfig):
    """``(tx, schedule)`` for ``cfg.optimizer``, each the torch optimizer that
    computes optax's:

    - ``"adamw"`` (BERT): ``torch.optim.AdamW`` with two parameter groups
      (weight decay on the :func:`_decay_mask` leaves, none elsewhere) is
      optax's ``adamw`` (b1 0.9, b2 0.999, eps 1e-8, decay added to the Adam
      direction before the learning rate scales it);
    - ``"adam"``: ``torch.optim.Adam`` with the same constants;
    - ``"sgd"``: ``torch.optim.SGD(momentum=cfg.momentum, dampening=0,
      nesterov=False)`` is ``optax.sgd(momentum=...)`` from the first step
      (the trace starts at the first gradient), and plain SGD at momentum 0.

    Clipping is not here: the train step applies it
    (``make_train_step(clip_norm=...)``)."""
    from distributed_tensorflow_tpu_torch.train.state import Transform

    schedule = make_lr_schedule(cfg)
    if cfg.optimizer not in ("sgd", "adam", "adamw"):
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")

    def make(params: dict[str, torch.Tensor]) -> torch.optim.Optimizer:
        if cfg.optimizer == "sgd":
            return torch.optim.SGD(list(params.values()), lr=schedule(0),
                                   momentum=cfg.momentum, dampening=0.0, nesterov=False)
        if cfg.optimizer == "adam":
            return torch.optim.Adam(list(params.values()), lr=schedule(0),
                                    betas=(0.9, 0.999), eps=1e-8)
        mask = _decay_mask(params)
        groups = [
            {"params": [p for n, p in params.items() if mask[n]],
             "weight_decay": cfg.weight_decay},
            {"params": [p for n, p in params.items() if not mask[n]], "weight_decay": 0.0},
        ]
        return torch.optim.AdamW([g for g in groups if g["params"]], lr=schedule(0),
                                 betas=(0.9, 0.999), eps=1e-8)

    return Transform(make, schedule), schedule


def _build_bert_workload(cfg_kwargs: dict):
    def build(cfg: WorkloadConfig):
        from distributed_tensorflow_tpu_torch.data.text import (
            SyntheticMLM,
            SyntheticMLMConfig,
            TextCorpusConfig,
            TextCorpusMLM,
            mlm_device_batches,
        )
        from distributed_tensorflow_tpu_torch.models.bert import (
            BertConfig,
            BertForPreTraining,
            bert_param_specs,
            make_bert_eval_metrics,
            make_bert_pretraining_loss,
        )
        from distributed_tensorflow_tpu_torch.parallel.mesh import active_mesh

        def make(device):
            mesh = active_mesh()
            seq_parallel = mesh.shape.get("seq", 1) > 1
            tp = mesh.shape.get("model", 1)
            ep = mesh.shape.get("expert", 1)
            pp = mesh.shape.get("pipeline", 1)
            kwargs = dict(cfg_kwargs)
            if cfg.bert_layers:
                kwargs["num_layers"] = cfg.bert_layers
            if cfg.bert_hidden:
                kwargs["hidden_size"] = cfg.bert_hidden
                kwargs["intermediate_size"] = 4 * cfg.bert_hidden
            if cfg.bert_vocab:
                kwargs["vocab_size"] = cfg.bert_vocab
            if seq_parallel:
                kwargs.update(seq_axis="seq", sp_impl=cfg.sp_impl)
            if tp > 1:
                kwargs.update(model_axis="model", model_parallel=tp)
            # The GShard token-sharded layout: the expert axis carries rows.
            expert_sharded = cfg.moe_dispatch == "sharded" and ep > 1
            if cfg.moe_dispatch == "sharded" and ep <= 1:
                raise _Refusal("--moe-dispatch=sharded requires --expert-parallel > 1")
            if cfg.moe_experts:
                if cfg.moe_experts % ep:
                    raise _Refusal(f"--moe-experts={cfg.moe_experts} not divisible by "
                                   f"--expert-parallel={ep}")
                if not 1 <= cfg.moe_topk <= cfg.moe_experts:
                    raise _Refusal(f"--moe-topk={cfg.moe_topk} must be in [1, "
                                   f"--moe-experts={cfg.moe_experts}]")
                # The global expert count; the model draws it and keeps its slice.
                kwargs.update(moe_experts=cfg.moe_experts, moe_topk=cfg.moe_topk)
                if ep > 1:
                    kwargs.update(expert_axis="expert", expert_parallel=ep,
                                  moe_dispatch=cfg.moe_dispatch)
            if pp > 1:
                # Per-shard rows must split into the GPipe microbatches.
                rows = cfg.global_batch // math.prod(
                    mesh.shape[a] for a in mesh.axis_names if a in ("replica", "data")
                    or (expert_sharded and a == "expert"))
                micro = cfg.pipeline_microbatches or 4 * pp
                if rows % micro:
                    raise _Refusal(f"per-shard batch {rows} (global {cfg.global_batch}) not "
                                   f"divisible by pipeline_microbatches {micro}")
                kwargs.update(pipeline_axis="pipeline", pipeline_parallel=pp,
                              pipeline_microbatches=micro)
            elif cfg.pipeline_parallel > 1:
                # A pipeline-trained config on a mesh without the axis: the
                # stacked tree, run sequentially (serving a stacked checkpoint).
                kwargs.update(pipeline_parallel=cfg.pipeline_parallel)
            model_cfg = BertConfig(**kwargs, remat=cfg.remat)
            model = BertForPreTraining(model_cfg, device=device)
            L = model_cfg.max_position
            # Real corpus when --data-dir holds *.txt (one sentence per
            # line, blank line between documents); seeded synthetic Markov
            # chains otherwise. A val/*.txt subdirectory provides unseen
            # eval text, tokenized with the TRAIN vocab.
            txt_files, val_files = [], []
            if cfg.data_dir:
                txt_files = sorted(Path(cfg.data_dir).glob("*.txt"))
                val_files = sorted((Path(cfg.data_dir) / "val").glob("*.txt"))
            eval_data = None
            if txt_files:
                corpus_cfg = TextCorpusConfig(seq_len=L, vocab_size=model_cfg.vocab_size,
                                              seed=0)
                data = TextCorpusMLM(txt_files, corpus_cfg)
                logger.info("text corpus: %d files, %d sentences, vocab_size=%d (cap %d)",
                            len(txt_files), len(data._sents), data.vocab_size,
                            model_cfg.vocab_size)
                if val_files:
                    eval_data = TextCorpusMLM(val_files, corpus_cfg, vocab_from=data)
                else:
                    logger.warning(
                        "no val/*.txt under %s; eval will RESAMPLE THE TRAINING TEXT "
                        "with fresh masking (not held-out documents) — provide a val "
                        "split for a true held-out metric", cfg.data_dir)
            else:
                if cfg.data_dir:
                    logger.warning(
                        "no *.txt under %s; FALLING BACK TO SYNTHETIC MLM DATA%s",
                        cfg.data_dir,
                        (f" (IGNORING {len(val_files)} val/*.txt files — training "
                         "text must live at the top level)" if val_files else ""),
                    )
                data = SyntheticMLM(SyntheticMLMConfig(
                    vocab_size=model_cfg.vocab_size, seq_len=L, seed=0))

            def eval_batches(n_batches: int) -> Iterator[dict]:
                # Held-out stream: the val corpus when one exists, else a
                # disjoint seed over the training source.
                it = mlm_device_batches(eval_data if eval_data is not None else data,
                                        cfg.global_batch, device=device, seed=900_001,
                                        seq_sharded=seq_parallel,
                                        expert_sharded=expert_sharded)
                for _ in range(n_batches):
                    yield next(it)

            params = dict(model.named_parameters())
            specs = None
            if tp > 1 or ep > 1 or pp > 1:
                specs = bert_param_specs(params, "model" if tp > 1 else None,
                                         "expert" if ep > 1 else None,
                                         "pipeline" if pp > 1 else None)
            return {
                "params": params,
                "param_specs": specs,
                "seq_sharded": seq_parallel,
                "batch_axes": ("expert",) if expert_sharded else (),
                "model_state": {},
                "loss_fn": make_bert_pretraining_loss(model),
                "batches": lambda start_step=0: mlm_device_batches(
                    data, cfg.global_batch, device=device, seed=1, start_step=start_step,
                    seq_sharded=seq_parallel, expert_sharded=expert_sharded),
                "metric_fn": make_bert_eval_metrics(model),
                "eval_batches": eval_batches,
            }

        return make

    return build


def _image_batches(cfg: WorkloadConfig, ds, device, model_hw, *, train: bool, seed: int,
                   start_step: int = 0):
    """Train/eval batch stream over an image dataset (the JAX CLI's
    ``_image_batches``): training through the host C++ pipeline with the
    preset's augmentation unless ``native_input`` is off; evaluation and
    ``--no-native-input`` through the numpy feed (center crop). u8 pixels
    under ``augment="imagenet"`` are normalised by the ImageNet mean/std."""
    from distributed_tensorflow_tpu_torch.data.loader import (
        device_batches,
        native_device_batches,
    )
    from distributed_tensorflow_tpu_torch.data.readers import IMAGENET_MEAN, IMAGENET_STD

    store_hw = tuple(ds.images.shape[1:3])
    is_u8 = ds.images.dtype == np.uint8
    # Per-channel normalisation belongs to the real-pixel path; synthetic
    # float templates are already ~N(0, 1).
    mean = IMAGENET_MEAN if (is_u8 and cfg.augment == "imagenet") else None
    std = IMAGENET_STD if mean is not None else None
    out_size = model_hw if store_hw != model_hw else None
    if train and cfg.native_input:
        return native_device_batches(
            ds, cfg.global_batch, device=device, out_size=out_size,
            pad=4 if cfg.augment == "cifar" else 0,
            flip=cfg.augment in ("cifar", "imagenet"),
            rrc=cfg.augment == "imagenet",
            mean=mean, stddev=std, seed=seed, start_step=start_step,
            # One pinned buffer a batch the prefetch queue holds, plus the
            # one being written and the one whose copy is in flight.
            staging=max(cfg.prefetch, 0) + 2,
        )
    return device_batches(ds, cfg.global_batch, device=device, seed=seed,
                          start_step=start_step, out_size=out_size, mean=mean, stddev=std)


def _build_causal_lm_workload(cfg_kwargs: dict):
    def build(cfg: WorkloadConfig):
        from distributed_tensorflow_tpu_torch.data.text import (
            SyntheticLM,
            SyntheticMLMConfig,
            mlm_device_batches,
        )
        from distributed_tensorflow_tpu_torch.models.causal_lm import (
            CausalLM,
            CausalLMConfig,
            causal_param_specs,
            make_causal_lm_eval_metrics,
            make_causal_lm_loss,
        )
        from distributed_tensorflow_tpu_torch.parallel.mesh import active_mesh

        def make(device):
            mesh = active_mesh()
            tp = mesh.shape.get("model", 1)
            if mesh.shape.get("expert", 1) > 1 or mesh.shape.get("pipeline", 1) > 1:
                raise _Refusal("causal-LM workloads shard over data/model axes only "
                               "(no MoE or pipeline decoder variant)")
            kwargs = dict(cfg_kwargs)
            if cfg.bert_layers:
                kwargs["num_layers"] = cfg.bert_layers
            if cfg.bert_hidden:
                kwargs["hidden_size"] = cfg.bert_hidden
                kwargs["intermediate_size"] = 4 * cfg.bert_hidden
            if cfg.bert_vocab:
                kwargs["vocab_size"] = cfg.bert_vocab
            if tp > 1:
                # Megatron TP: drawn global, this rank's slices kept.
                kwargs.update(model_axis="model", model_parallel=tp)
            model_cfg = CausalLMConfig(**kwargs)
            model = CausalLM(model_cfg, device=device)
            data = SyntheticLM(SyntheticMLMConfig(
                vocab_size=model_cfg.vocab_size, seq_len=model_cfg.max_position, seed=0))

            def eval_batches(n_batches: int) -> Iterator[dict]:
                it = mlm_device_batches(data, cfg.global_batch, device=device, seed=900_001)
                for _ in range(n_batches):
                    yield next(it)

            params = dict(model.named_parameters())
            return {
                "params": params,
                "param_specs": causal_param_specs(params) if tp > 1 else None,
                "model_state": {},
                "loss_fn": make_causal_lm_loss(model),
                "batches": lambda start_step=0: mlm_device_batches(
                    data, cfg.global_batch, device=device, seed=1, start_step=start_step),
                "metric_fn": make_causal_lm_eval_metrics(model),
                "eval_batches": eval_batches,
            }

        return make

    return build


def _build_image_workload(model_factory, image_shape, num_classes, n_examples=4096):
    """``model_factory(shape, device)`` builds the model on the device
    (seeded init, the JAX package's ``jax.random.key(0)`` counterpart)."""

    def build(cfg: WorkloadConfig):
        from distributed_tensorflow_tpu_torch.data.readers import load_dataset
        from distributed_tensorflow_tpu_torch.parallel.mesh import process_index
        from distributed_tensorflow_tpu_torch.train.objectives import (
            init_model,
            make_classification_loss,
            make_classification_metrics,
        )

        shape = image_shape
        if cfg.image_size:
            shape = (cfg.image_size, cfg.image_size, image_shape[-1])

        def make(device):
            net = model_factory(shape, device)
            params, model_state = init_model(net)

            def load(split):
                return load_dataset(
                    cfg.dataset or "synthetic", cfg.data_dir or None, split=split,
                    fallback_examples=max(n_examples, cfg.global_batch),
                    image_shape=shape, num_classes=num_classes,
                    seed=0 if split == "train" else 1,
                )

            ds = load("train")
            store = tuple(ds.images.shape[1:3])
            if store != shape[:2] and (
                ds.images.dtype != np.uint8 or store[0] < shape[0] or store[1] < shape[1]
            ):
                raise ValueError(
                    f"dataset images are {ds.images.shape[1:]} but the model was "
                    f"configured for {shape}; a u8 store may only be LARGER than the "
                    "model geometry (train-time crop)")
            if process_index() == 0:
                logger.info(
                    "image feed: %d images %s %s; training through %s (augment=%r)",
                    len(ds), ds.images.shape[1:], ds.images.dtype,
                    "the host C++ pipeline" if cfg.native_input else "the numpy feed",
                    cfg.augment)
            # The val split loads on the first eval pass: preparing a real
            # val cache must not tax runs that never evaluate.
            eval_ds_box: list = []

            def eval_batches(n_batches: int) -> Iterator[dict]:
                if not eval_ds_box:
                    eval_ds_box.append(load("val"))
                it = _image_batches(cfg, eval_ds_box[0], device, shape[:2], train=False,
                                    seed=101)
                for _ in range(n_batches):
                    yield next(it)

            return {
                "params": params,
                "model_state": model_state,
                "model": net,
                "image_shape": shape,
                "loss_fn": make_classification_loss(net),
                "batches": lambda start_step=0: _image_batches(
                    cfg, ds, device, shape[:2], train=True, seed=1, start_step=start_step),
                "metric_fn": make_classification_metrics(net),
                "eval_batches": eval_batches,
            }

        return make

    return build


def _lenet(shape, device):
    from distributed_tensorflow_tpu_torch.models import LeNet5

    return LeNet5(device=device)


def _resnet20(shape, device):
    from distributed_tensorflow_tpu_torch.models import ResNet20

    return ResNet20(device=device, in_channels=shape[-1])


def _resnet50(shape, device):
    from distributed_tensorflow_tpu_torch.models import ResNet50

    return ResNet50(dtype=torch.bfloat16, device=device, in_channels=shape[-1])


def _inception(shape, device):
    from distributed_tensorflow_tpu_torch.models import InceptionV3

    # The aux classifier on at the canonical 299x299 geometry (main + 0.3 x
    # aux); smaller inputs cannot feed its 5x5 VALID conv.
    return InceptionV3(dtype=torch.bfloat16, aux_logits=shape[0] >= 299, device=device,
                       in_channels=shape[-1])


PRESETS = {
    "mnist_lenet": WorkloadConfig(
        name="mnist_lenet",
        build=_build_image_workload(_lenet, (28, 28, 1), 10),
        global_batch=128,
        num_steps=1000,
        learning_rate=0.05,
        dataset="mnist",
    ),
    "cifar_resnet20": WorkloadConfig(
        name="cifar_resnet20",
        build=_build_image_workload(_resnet20, (32, 32, 3), 10),
        global_batch=256,
        num_steps=2000,
        learning_rate=0.1,
        lr_schedule="piecewise",
        dataset="cifar10",
        augment="cifar",
    ),
    "imagenet_resnet50": WorkloadConfig(
        name="imagenet_resnet50",
        build=_build_image_workload(_resnet50, (224, 224, 3), 1000, n_examples=8192),
        global_batch=256,
        num_steps=5000,
        learning_rate=0.4,  # linear-scaling rule for large global batch
        lr_schedule="warmup_cosine",
        dataset="imagenet",
        augment="imagenet",
    ),
    "imagenet_inception_async": WorkloadConfig(
        name="imagenet_inception_async",
        build=_build_image_workload(_inception, (299, 299, 3), 1000, n_examples=8192),
        global_batch=256,
        num_steps=5000,
        learning_rate=0.05,
        momentum=0.0,
        lr_schedule="warmup_cosine",
        mode="stale",
        staleness=4,
        dataset="imagenet",
        augment="imagenet",
    ),
    "bert_base": WorkloadConfig(
        name="bert_base",
        build=_build_bert_workload(
            dict(max_position=128, dropout_rate=0.1, dtype=torch.bfloat16)
        ),
        global_batch=256,
        num_steps=10000,
        learning_rate=1e-4,
        # The canonical BERT pretraining recipe: AdamW with decoupled weight
        # decay (masked off LayerNorm scales and all biases) + global-norm
        # clipping at 1.0 inside the step.
        optimizer="adamw",
        weight_decay=0.01,
        clip_norm=1.0,
        lr_schedule="warmup_cosine",
        warmup_steps=1000,
    ),
    "lm_base": WorkloadConfig(
        name="lm_base",
        build=_build_causal_lm_workload(dict(max_position=128, dtype=torch.bfloat16)),
        global_batch=256,
        num_steps=10000,
        learning_rate=1e-4,
        # bert_base's decoupled-decay recipe: the decoder reuses its blocks.
        optimizer="adamw",
        weight_decay=0.01,
        clip_norm=1.0,
        lr_schedule="warmup_cosine",
        warmup_steps=1000,
    ),
}

# Presets of the JAX package that later slices bring (none left).
_UNPORTED_PRESETS: dict[str, str] = {}

# Flags of the JAX CLI that this slice's path does not read, with why.
_UNPORTED_FLAGS = {
    "--rng-impl": "dropout draws from a torch.Generator seeded by --seed",
}


class _Refusal(ValueError):
    """A request the CLI refuses with exit 2 once the workload is built."""


def run(cfg: WorkloadConfig, args: argparse.Namespace):
    """Train ``cfg`` on ``args.device``; returns ``(state, last_metrics)``."""
    from distributed_tensorflow_tpu_torch.ckpt import Checkpointer
    from distributed_tensorflow_tpu_torch.data.prefetch import prefetch
    from distributed_tensorflow_tpu_torch.obs.metrics import FeedMetrics, make_metric_hook
    from distributed_tensorflow_tpu_torch.obs.profile import trace_steps
    from distributed_tensorflow_tpu_torch.obs.trace import Tracer
    from distributed_tensorflow_tpu_torch.parallel.mesh import (
        build_mesh,
        initialize_runtime,
        layout_label,
        process_index,
    )
    from distributed_tensorflow_tpu_torch.train import (
        aggregate_metric_sums,
        create_train_state,
        fit,
        make_eval_step,
        make_rng,
        make_train_step,
    )

    # Multi-process bootstrap before anything touches a device: explicit
    # flags, or a launcher's environment; neither is one process.
    device = initialize_runtime(
        coordinator_address=args.coordinator_address or None,
        num_processes=args.num_processes if args.num_processes > 0 else None,
        process_id=args.process_id if args.process_id >= 0 else None,
        device=args.device,
        timeout_s=args.init_timeout,
    )
    mesh_spec = {"data": -1}
    for axis, width in (("pipeline", cfg.pipeline_parallel), ("expert", cfg.expert_parallel),
                        ("seq", cfg.seq_parallel), ("model", cfg.tensor_parallel)):
        if width:
            mesh_spec[axis] = width
    try:
        mesh = build_mesh(mesh_spec)
    except ValueError as e:
        raise _Refusal(f"the mesh {mesh_spec} does not fit the job's processes: {e}") from e
    layout = layout_label(mesh)
    if process_index() == 0:
        logger.info("workload=%s mesh=%s layout=%s device=%s", cfg.name, dict(mesh.shape),
                    layout, device)
    pieces = cfg.build(cfg)(device)
    # A model, expert or pipeline axis with no parameter sharded over it (or
    # a seq axis over a workload that shards no sequence) means every group
    # of those ranks computes identical gradients: silent N-fold waste, as
    # the JAX CLI says.
    from distributed_tensorflow_tpu_torch.models.bert import spec_axes

    specs = pieces.get("param_specs") or {}
    for axis, width in (("model", cfg.tensor_parallel), ("expert", cfg.expert_parallel),
                        ("pipeline", cfg.pipeline_parallel)):
        if width > 1 and not any(axis in spec_axes(s) for s in specs.values()):
            raise _Refusal(f"a {width}-way {axis!r} axis was requested but workload "
                           f"{cfg.name!r} shards no params over it")
    if cfg.seq_parallel > 1 and not pieces.get("seq_sharded"):
        raise _Refusal(f"a {cfg.seq_parallel}-way 'seq' axis was requested but "
                       f"workload {cfg.name!r} shards no sequence over it")
    tx, lr_schedule = _make_tx(cfg)
    staleness = cfg.staleness if cfg.mode == "stale" else 0
    state = create_train_state(pieces["params"], tx, pieces["model_state"], staleness=staleness)
    step = make_train_step(pieces["loss_fn"], tx, mode=cfg.mode, staleness=staleness,
                           clip_norm=cfg.clip_norm, grad_accum=cfg.grad_accum,
                           param_specs=pieces.get("param_specs"),
                           batch_axes=pieces.get("batch_axes", ()))
    rng = make_rng(args.seed, device)
    # Flight recorder (--dump-dir): the resilience and fault-injection paths
    # record their events here and an unhandled failure dumps the ring.
    # Built before the checkpointer and the feed, which carry the injector.
    recorder = None
    if args.dump_dir:
        from distributed_tensorflow_tpu_torch.obs.flightrec import FlightRecorder
        from distributed_tensorflow_tpu_torch.obs.memory import default_registry

        recorder = FlightRecorder(dump_dir=args.dump_dir)
        recorder.attach(memz_fn=default_registry().snapshot)
    # Deterministic fault injection (--fault-plan): one seeded schedule for
    # the loop, the feed stage and the checkpointer; every rank holds the
    # same plan.
    fault_injector = None
    if args.fault_plan:
        from distributed_tensorflow_tpu_torch.train.faultinject import FaultInjector, FaultPlan

        plan = FaultPlan.parse(args.fault_plan, num_steps=cfg.num_steps)
        fault_injector = FaultInjector(plan, recorder=recorder)
        logger.info("fault plan armed: %d scheduled events", len(plan.events))
    ckpt = (Checkpointer(args.ckpt_dir, fault_injector=fault_injector,
                         param_specs=pieces.get("param_specs"))
            if args.ckpt_dir else None)
    start = 0
    if ckpt is not None:
        state, start = ckpt.restore_latest(state, generator=rng)
    feed_metrics = FeedMetrics()
    # Resume-correct stream: a restored run consumes batches N.., not 0..
    # Resilient runs build one stream a segment through make_batches below.
    batches = None
    if not args.resilient:
        batches = pieces["batches"](0 if cfg.device_pool > 0 else start)
    if cfg.device_pool > 0:
        # Device-resident pool: the first N batches on the card once, then
        # cycled, so the host leaves the hot loop. The step never writes
        # into its batch, so reusing one is safe. The pool is ALWAYS stream
        # positions 0..N-1 and a resumed run re-enters the cycle at
        # start % N, which reproduces the uninterrupted run (a pool built
        # from position `start` would train on other data after a restart).
        src = batches
        try:
            pool = [next(src) for _ in range(cfg.device_pool)]
        finally:
            src.close()
        # Wait for the WHOLE pool's copies before the first timed step.
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        k = start % cfg.device_pool
        batches = itertools.cycle(pool[k:] + pool[:k])
        if process_index() == 0:
            logger.info("device_pool=%d batches resident on %s; the host feed is out "
                        "of the hot loop", cfg.device_pool, device)
    else:
        # Feed stage: assembly and the host->device copy run on a feeder
        # thread, cfg.prefetch batches ahead (0: synchronous, same metrics).
        if not args.resilient:
            batches = prefetch(batches, cfg.prefetch, metrics=feed_metrics,
                               fault_injector=fault_injector)

    evaluate = None
    if args.eval_every:
        eval_step = make_eval_step(pieces["metric_fn"], return_sums=True,
                                   batch_axes=pieces.get("batch_axes", ()))

        def evaluate(state):
            # (num, den) sums carry across the whole pass and divide once.
            return aggregate_metric_sums(
                eval_step(state, batch) for batch in pieces["eval_batches"](args.eval_batches))

    def lr_hook(step_: int, state_, metrics: dict) -> None:
        # Runs before the writers (hook order): `lr` lands in every record.
        if "loss" in metrics:
            metrics["lr"] = float(lr_schedule(step_ - 1))

    hook = make_metric_hook(logdir=args.tb_dir, jsonl=args.metrics_jsonl)
    hooks = (lr_hook, hook)
    # Fleet health beacon (--beacon-dir): the step timeline and straggler
    # detector in one atomically replaced JSON file a rank, refreshed at the
    # log cadence; aggregation is pull (obs/fleet.py read_beacons).
    timeline = beacon = None
    if args.beacon_dir:
        from distributed_tensorflow_tpu_torch.obs.fleet import HostBeacon, StepTimeline

        timeline = StepTimeline()
        beacon = HostBeacon(
            args.beacon_dir, process_index(), timeline,
            extras=fault_injector.summary if fault_injector is not None else None)
        hooks = (*hooks, lambda step_, state_, metrics_: beacon.write())
    # Host span trace (obs/trace.py), exported at the end of the run; the
    # device side is --profile-dir's torch.profiler trace.
    tracer = Tracer(buffer_size=args.trace_buffer) if args.trace_dir else None
    if recorder is not None and tracer is not None:
        recorder.attach(tracer_fn=tracer.summary)
    profile_cm = (trace_steps(args.profile_dir, num_steps=args.profile_steps or None,
                              device=device)
                  if args.profile_dir else contextlib.nullcontext())
    try:
        with profile_cm as win:
            step_fn = step
            if args.profile_steps:
                # Armed window: the profiler runs for exactly N steps.
                def step_fn(state_, batch_, rng_):
                    win.before_step()
                    out = step(state_, batch_, rng_)
                    win.after_step(out)
                    return out

            common = dict(
                num_steps=cfg.num_steps,
                rng=rng,
                log_every=cfg.log_every,
                hooks=hooks,
                checkpointer=ckpt,
                ckpt_every=args.ckpt_every,
                evaluate=evaluate,
                eval_every=args.eval_every,
                feed_metrics=feed_metrics,
                tracer=tracer,
                timeline=timeline,
                recorder=recorder,
                nonfinite=args.nonfinite,
                fault_injector=fault_injector,
            )
            if args.resilient:
                # SIGTERM/SIGINT -> final synchronous checkpoint and a clean
                # exit; transient feeder/checkpoint-IO failures restore the
                # newest checkpoint and re-enter the loop with backoff.
                from distributed_tensorflow_tpu_torch.train.resilience import (
                    ResilienceConfig,
                    run_resilient,
                )

                def make_batches(start_step: int):
                    return prefetch(pieces["batches"](start_step), cfg.prefetch,
                                    metrics=feed_metrics, fault_injector=fault_injector)

                report = run_resilient(
                    state, step_fn, make_batches,
                    config=ResilienceConfig(max_restarts=args.max_restarts), **common)
                state, last = report.state, report.metrics
                if report.preempted and process_index() == 0:
                    logger.info("preempted at step %d after %d restart(s); checkpoint is "
                                "durable", report.final_step, report.restarts)
            else:
                state, last = fit(state, step_fn, batches, **common)
        if ckpt is not None and ckpt.latest_step() != state.step:
            ckpt.save(state.step, state, generator=rng)
    except Exception as e:
        if recorder is not None:
            recorder.record("engine_failure", error=type(e).__name__)
            recorder.dump("train_failure", force=True)
        raise
    finally:
        if ckpt is not None:
            ckpt.close()
        for w in getattr(hook, "writers", ()):
            w.close()
        close = getattr(batches, "close", None)
        if close is not None:
            close()
        if beacon is not None:
            beacon.write()  # the final state, even for runs shorter than log_every
        if tracer is not None and process_index() == 0:
            out = tracer.export(Path(args.trace_dir) / "train_trace.json")
            logger.info("wrote host span trace to %s", out)
    return state, last


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Training on CUDA cards, one a process (or on the CPU)")
    p.add_argument("--config", required=True, help=f"workload preset; ported: {sorted(PRESETS)}")
    p.add_argument("--device", default="cuda",
                   help="training device: cuda (default: this rank's card; fails "
                        "without one) or cpu")
    p.add_argument("--coordinator-address", default="",
                   help="multi-process bootstrap: coordinator ip:port of the process "
                        "group (required for a manual launch)")
    p.add_argument("--num-processes", type=int, default=0,
                   help="multi-process bootstrap: total process count "
                        "(with --coordinator-address)")
    p.add_argument("--process-id", type=int, default=-1,
                   help="multi-process bootstrap: this process's rank in "
                        "[0, --num-processes)")
    p.add_argument("--init-timeout", type=float, default=300.0,
                   help="multi-process bootstrap: seconds the process group may take to "
                        "form before the run fails; a deployment setting, as "
                        "jax.distributed.initialize's initialization_timeout is (the "
                        "JAX CLI keeps that one at its default)")
    p.add_argument("--steps", type=int, default=0, help="override num_steps")
    p.add_argument("--global-batch", type=int, default=0)
    p.add_argument("--image-size", type=int, default=0,
                   help="override the image presets' square input size")
    p.add_argument("--grad-accum", type=int, default=0,
                   help="average the gradients of N micro-slices of each batch in the step")
    p.add_argument("--remat", action="store_true",
                   help="recompute encoder-layer activations in the backward "
                        "(torch.utils.checkpoint)")
    p.add_argument("--bert-layers", type=int, default=0,
                   help="override BERT encoder depth (smoke runs)")
    p.add_argument("--bert-hidden", type=int, default=0,
                   help="override BERT hidden size (intermediate = 4x)")
    p.add_argument("--bert-vocab", type=int, default=0,
                   help="override BERT vocab size (smoke runs)")
    p.add_argument("--seq-parallel", type=int, default=-1,
                   help="seq axis size for sequence parallelism (BERT)")
    p.add_argument("--sp-impl", default="", choices=["", "ring", "ulysses"],
                   help="sequence-parallel strategy: ring (K/V blocks passed around the "
                        "seq axis) or ulysses (all-to-all head re-partition)")
    p.add_argument("--tensor-parallel", type=int, default=-1,
                   help="model axis size for Megatron-TP sharding (BERT)")
    p.add_argument("--moe-experts", type=int, default=-1,
                   help="switch-MoE FFN with N experts (BERT; 0 = dense FFN)")
    p.add_argument("--moe-dispatch", default="",
                   choices=["", "replicated", "alltoall", "sharded"],
                   help="MoE dispatch layout: alltoall = capacity-buffer exchange over "
                        "replicated tokens; sharded = the GShard layout (batch rows split "
                        "over the expert axis, no replicated non-MoE compute)")
    p.add_argument("--moe-topk", type=int, default=-1,
                   help="routing fan-out: 1 = Switch top-1 (default), 2 = GShard top-2 "
                        "(renormalized gates, per-expert capacity unchanged)")
    p.add_argument("--expert-parallel", type=int, default=-1,
                   help="expert axis size for MoE sharding (BERT)")
    p.add_argument("--pipeline-parallel", type=int, default=-1,
                   help="pipeline-stage axis size for the BERT encoder (GPipe schedule; "
                        "0 disables)")
    p.add_argument("--pipeline-microbatches", type=int, default=0,
                   help="GPipe microbatch count M (default 4x stages)")
    p.add_argument("--staleness", type=int, default=-1,
                   help="K > 0: apply K-step-old gradients (async-stale emulation)")
    p.add_argument("--lr", type=float, default=0.0)
    p.add_argument("--lr-schedule", default="",
                   choices=["", "constant", "warmup_cosine", "piecewise"])
    p.add_argument("--log-every", type=int, default=0)
    p.add_argument("--eval-every", type=int, default=0,
                   help="run held-out eval every N steps (0 = off)")
    p.add_argument("--eval-batches", type=int, default=8,
                   help="number of global batches per eval pass")
    p.add_argument("--ckpt-dir", default="")
    p.add_argument("--ckpt-every", type=int, default=0)
    p.add_argument("--data-dir", default="",
                   help="directory with real dataset files: MNIST idx, CIFAR-10 pickles, "
                        "an ImageNet-class u8 cache, class folders or TFRecord shards for "
                        "the image presets; *.txt (+ val/*.txt) for bert_base (seeded "
                        "synthetic data, with a warning, when it holds none)")
    p.add_argument("--no-native-input", action="store_true",
                   help="train the image presets through the numpy feed (center crop, no "
                        "augmentation) instead of the host C++ pipeline")
    p.add_argument("--device-pool", type=int, default=0,
                   help="place the first N batches on the device and cycle them (the host "
                        "feed leaves the hot loop; the model revisits the pool every N steps)")
    p.add_argument("--prefetch", type=int, default=-1,
                   help="feed lookahead depth: a feeder thread runs batch assembly and the "
                        "host->device copy N batches ahead (default 2; 0 = synchronous). "
                        "Batch streams are bit-identical for any N")
    p.add_argument("--tb-dir", default="",
                   help="write every logged step's metrics as TensorBoard scalars here "
                        "(needs the tensorboard package)")
    p.add_argument("--metrics-jsonl", default="",
                   help="append every logged step's metrics to this JSONL file")
    p.add_argument("--profile-dir", default="",
                   help="write a torch.profiler Chrome trace (CPU, and the card's kernels "
                        "on CUDA) of the whole run to this directory")
    p.add_argument("--profile-steps", type=int, default=0,
                   help="arm the --profile-dir window for exactly N steps (starts at the "
                        "first step, stops after the Nth; 0 = the whole run)")
    p.add_argument("--trace-dir", default="",
                   help="record host-side step-phase spans (host_wait/dispatch/device/"
                        "metrics_fetch/checkpoint_save/eval) and write them here as Chrome "
                        "trace-event JSON (train_trace.json)")
    p.add_argument("--trace-buffer", type=int, default=4096,
                   help="span ring-buffer size for --trace-dir (the export holds the most "
                        "recent N spans)")
    p.add_argument("--beacon-dir", default="",
                   help="shared directory for per-rank health beacons (host_<rank>.json, "
                        "atomically replaced at the log cadence and at the end): step-time "
                        "and host-wait windows and straggler anomalies, aggregated by "
                        "obs.fleet.fleet_summary")
    p.add_argument("--dump-dir", default="",
                   help="flight-recorder dump directory: an unhandled training failure "
                        "writes one timestamped JSON with the event ring and the memory "
                        "and tracer digests (empty = disabled)")
    p.add_argument("--resilient", action="store_true",
                   help="preemption-safe supervised training: SIGTERM/SIGINT writes a "
                        "final synchronous checkpoint and exits cleanly; transient "
                        "feeder/checkpoint-IO failures restore the newest checkpoint and "
                        "retry with capped exponential backoff; a non-finite loss and "
                        "shape errors stay fatal")
    p.add_argument("--max-restarts", type=int, default=3,
                   help="consecutive no-progress restart budget for --resilient (a "
                        "restart that resumes from a newer checkpoint resets the count)")
    p.add_argument("--fault-plan", default="",
                   help="deterministic fault injection: a seeded spec like "
                        "'seed=7,feeder_error=2,ckpt_write_error=1,slow_step=1,"
                        "slow_step_s=0.1' or a path to a JSON plan; events fire in the "
                        "train loop, the feed stage and the checkpointer, and are recorded "
                        "to the flight recorder and the beacon")
    p.add_argument("--nonfinite", default="abort", choices=["abort", "skip"],
                   help="NaN/Inf step-loss policy, checked at the log cadence: abort "
                        "(default) raises NonFiniteLossError (a flight-recorder event and a "
                        "forced dump with --dump-dir); skip records the event and trains on")
    p.add_argument("--seed", type=int, default=0, help="seed of the run's dropout generator")
    return p


def main(argv: list[str] | None = None) -> int:
    parser = make_parser()
    args, unknown = parser.parse_known_args(argv)
    for arg in unknown:
        flag = arg.split("=", 1)[0]
        if flag in _UNPORTED_FLAGS:
            parser.error(f"{flag}: not ported to PyTorch ({_UNPORTED_FLAGS[flag]})")
    if unknown:
        parser.error(f"unrecognized arguments: {' '.join(unknown)}")
    if args.config not in PRESETS:
        if args.config in _UNPORTED_PRESETS:
            parser.error(f"--config {args.config}: not ported to PyTorch yet (comes "
                         f"with {_UNPORTED_PRESETS[args.config]}; ported: {sorted(PRESETS)})")
        parser.error(f"--config {args.config}: unknown preset (ported: {sorted(PRESETS)})")
    if args.grad_accum < 0:
        parser.error("--grad-accum must be >= 1")
    if args.profile_steps and not args.profile_dir:
        parser.error("--profile-steps requires --profile-dir")
    if args.device_pool < 0:
        parser.error("--device-pool must be >= 0")
    if args.resilient and args.device_pool > 0:
        parser.error("--resilient does not compose with --device-pool (the pool is rebuilt "
                     "per restart and would replay positions 0..N-1)")
    if args.sp_impl == "ulysses" and args.seq_parallel > 1:
        from distributed_tensorflow_tpu_torch.models.bert import BertConfig

        local_heads = BertConfig().num_heads // max(args.tensor_parallel, 1)
        if local_heads % args.seq_parallel:
            parser.error(f"--sp-impl ulysses: {local_heads} heads a model shard are not "
                         f"divisible by --seq-parallel {args.seq_parallel}; use the ring")
    if args.tb_dir and importlib.util.find_spec("tensorboard") is None:
        parser.error("--tb-dir: the tensorboard package is not installed here "
                     "(--metrics-jsonl writes the same records without it)")

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    overrides = {}
    for flag, field in (("steps", "num_steps"), ("global_batch", "global_batch"),
                        ("grad_accum", "grad_accum"), ("bert_layers", "bert_layers"),
                        ("bert_hidden", "bert_hidden"), ("bert_vocab", "bert_vocab"),
                        ("image_size", "image_size"),
                        ("lr", "learning_rate"), ("lr_schedule", "lr_schedule"),
                        ("log_every", "log_every")):
        if getattr(args, flag):
            overrides[field] = getattr(args, flag)
    if args.remat:
        overrides["remat"] = True
    if args.staleness >= 0:
        overrides["staleness"] = args.staleness
        if args.staleness:
            overrides["mode"] = "stale"
    if args.data_dir:
        overrides["data_dir"] = args.data_dir
    if args.no_native_input:
        overrides["native_input"] = False
    if args.device_pool:
        overrides["device_pool"] = args.device_pool
    if args.prefetch >= 0:
        overrides["prefetch"] = args.prefetch
    if args.seq_parallel >= 0:
        overrides["seq_parallel"] = args.seq_parallel
    if args.sp_impl:
        overrides["sp_impl"] = args.sp_impl
    if args.tensor_parallel >= 0:
        overrides["tensor_parallel"] = args.tensor_parallel
    if args.moe_experts >= 0:
        overrides["moe_experts"] = args.moe_experts
    if args.moe_dispatch:
        overrides["moe_dispatch"] = args.moe_dispatch
    if args.moe_topk == 0:
        parser.error("--moe-topk must be >= 1")
    if args.moe_topk > 0:
        overrides["moe_topk"] = args.moe_topk
    if args.expert_parallel >= 0:
        overrides["expert_parallel"] = args.expert_parallel
    if args.pipeline_parallel >= 0:
        overrides["pipeline_parallel"] = args.pipeline_parallel
    if args.pipeline_microbatches:
        overrides["pipeline_microbatches"] = args.pipeline_microbatches
    cfg = dataclasses.replace(PRESETS[args.config], **overrides)
    from distributed_tensorflow_tpu_torch.parallel.mesh import process_index, shutdown_runtime

    try:
        try:
            _, last = run(cfg, args)
        except _Refusal as e:
            parser.error(str(e))
        if last is not None and process_index() == 0:
            logger.info("final: %s", last)
    finally:
        shutdown_runtime()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
