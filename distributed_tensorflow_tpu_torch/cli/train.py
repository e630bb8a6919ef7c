"""``python -m distributed_tensorflow_tpu_torch.cli.train --config bert_base``.

Port of the JAX package's ``cli/train.py`` for the BERT pretraining
workload (MLM + NSP, synchronous or K-stale data parallelism) on one
process, on the card by default (``--device cpu`` runs on the CPU). The
optimizer recipe keeps the JAX names: :func:`make_lr_schedule`,
:func:`_decay_mask` and :func:`_make_tx`.

The other presets (the image workloads and the causal LM) and the flags of
the paths not ported yet are refused with a message naming the slice that
brings them. Data is the seeded synthetic Markov-chain MLM stream; the real
text corpus (``--data-dir``) comes with a later slice.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import math
from collections.abc import Callable, Iterator
from typing import Any

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
    weight_decay: float = 0.0  # adamw decoupled weight decay
    clip_norm: float = 0.0  # > 0: global-norm gradient clipping in the step
    grad_accum: int = 1  # > 1: micro-slice gradient accumulation in the step
    lr_schedule: str = "constant"  # "constant" | "warmup_cosine" | "piecewise"
    warmup_steps: int = 0
    mode: str = "sync"  # "sync" | "stale"
    staleness: int = 0
    remat: bool = False  # activation checkpointing over encoder layers
    bert_layers: int = 0  # > 0: override encoder depth (smoke runs)
    bert_hidden: int = 0  # > 0: override hidden size (intermediate = 4x)
    bert_vocab: int = 0  # > 0: override vocab size (smoke runs)
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
        bounds = (cfg.num_steps // 2, (3 * cfg.num_steps) // 4)
        return lambda count: lr * 0.1 ** sum(count >= b for b in bounds)
    raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")


def _decay_mask(params: dict[str, torch.Tensor]) -> dict[str, bool]:
    """AdamW decoupled-weight-decay mask, the canonical BERT recipe: decay
    weight matrices and embeddings only. Parameters of rank < 2, anything
    named like a bias, and anything under a LayerNorm module never decay."""

    def decays(name: str, p: torch.Tensor) -> bool:
        parts = name.split(".")
        if p.dim() < 2 or "bias" in parts[-1]:
            return False
        return not any(
            n == "ln" or n.endswith("_ln") or n.endswith("_bn")
            or "LayerNorm" in n or "BatchNorm" in n
            for n in parts[:-1]
        )

    return {name: decays(name, p) for name, p in params.items()}


def _make_tx(cfg: WorkloadConfig):
    """``(tx, schedule)`` for the BERT recipe: ``torch.optim.AdamW`` with
    two parameter groups (weight decay on the :func:`_decay_mask` leaves,
    none elsewhere) computes optax's ``adamw`` (b1 0.9, b2 0.999, eps 1e-8,
    decay added to the Adam direction before the learning rate scales it).
    Clipping is not here: the train step applies it
    (``make_train_step(clip_norm=...)``). SGD and Adam, the image presets'
    optimizers, come with the image slice."""
    from distributed_tensorflow_tpu_torch.train.state import Transform

    schedule = make_lr_schedule(cfg)

    def make(params: dict[str, torch.Tensor]) -> torch.optim.Optimizer:
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
            mlm_device_batches,
        )
        from distributed_tensorflow_tpu_torch.models.bert import (
            BertConfig,
            BertForPreTraining,
            make_bert_eval_metrics,
            make_bert_pretraining_loss,
        )

        def make(device):
            kwargs = dict(cfg_kwargs)
            if cfg.bert_layers:
                kwargs["num_layers"] = cfg.bert_layers
            if cfg.bert_hidden:
                kwargs["hidden_size"] = cfg.bert_hidden
                kwargs["intermediate_size"] = 4 * cfg.bert_hidden
            if cfg.bert_vocab:
                kwargs["vocab_size"] = cfg.bert_vocab
            model_cfg = BertConfig(**kwargs, remat=cfg.remat)
            model = BertForPreTraining(model_cfg, device=device)
            data = SyntheticMLM(SyntheticMLMConfig(
                vocab_size=model_cfg.vocab_size, seq_len=model_cfg.max_position, seed=0))

            def eval_batches(n_batches: int) -> Iterator[dict]:
                # Held-out stream: a disjoint seed over the synthetic source.
                it = mlm_device_batches(data, cfg.global_batch, device=device, seed=900_001)
                for _ in range(n_batches):
                    yield next(it)

            return {
                "params": dict(model.named_parameters()),
                "model_state": {},
                "loss_fn": make_bert_pretraining_loss(model),
                "batches": lambda start_step=0: mlm_device_batches(
                    data, cfg.global_batch, device=device, seed=1, start_step=start_step),
                "metric_fn": make_bert_eval_metrics(model),
                "eval_batches": eval_batches,
            }

        return make

    return build


PRESETS = {
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
        weight_decay=0.01,
        clip_norm=1.0,
        lr_schedule="warmup_cosine",
        warmup_steps=1000,
    ),
}

# Presets of the JAX package that later slices bring.
_UNPORTED_PRESETS = {
    "mnist_lenet": "the image slice",
    "cifar_resnet20": "the image slice",
    "imagenet_resnet50": "the image slice",
    "imagenet_inception_async": "the image slice",
    "lm_base": "the causal-LM slice",
}

# Flags of the JAX CLI that this slice's path does not read, with why.
_UNPORTED_FLAGS = {
    **dict.fromkeys(("--image-size", "--no-native-input", "--device-pool"),
                    "comes with the image slice"),
    "--data-dir": "comes with the real-text data slice (TextCorpusMLM)",
    **dict.fromkeys(("--seq-parallel", "--sp-impl", "--tensor-parallel", "--moe-experts",
                     "--moe-dispatch", "--moe-topk", "--pipeline-parallel",
                     "--pipeline-microbatches", "--expert-parallel"),
                    "comes with the model-parallel slice"),
    **dict.fromkeys(("--coordinator-address", "--num-processes", "--process-id"),
                    "comes with the multi-card slice"),
    **dict.fromkeys(("--resilient", "--max-restarts", "--fault-plan", "--nonfinite",
                     "--beacon-dir", "--dump-dir"), "comes with the resilient-training slice"),
    **dict.fromkeys(("--tb-dir", "--metrics-jsonl", "--profile-dir", "--profile-steps",
                     "--trace-dir", "--trace-buffer"), "comes with a later observability slice"),
    "--prefetch": "the feed runs two batches ahead",
    "--rng-impl": "dropout draws from a torch.Generator seeded by --seed",
}


def run(cfg: WorkloadConfig, args: argparse.Namespace):
    """Train ``cfg`` on ``args.device``; returns ``(state, last_metrics)``."""
    from distributed_tensorflow_tpu_torch.ckpt import Checkpointer
    from distributed_tensorflow_tpu_torch.data.prefetch import prefetch
    from distributed_tensorflow_tpu_torch.device import resolve_device
    from distributed_tensorflow_tpu_torch.obs.metrics import FeedMetrics
    from distributed_tensorflow_tpu_torch.train import (
        aggregate_metric_sums,
        create_train_state,
        fit,
        make_eval_step,
        make_rng,
        make_train_step,
    )

    device = resolve_device(args.device)
    logger.info("workload=%s device=%s", cfg.name, device)
    pieces = cfg.build(cfg)(device)
    tx, lr_schedule = _make_tx(cfg)
    staleness = cfg.staleness if cfg.mode == "stale" else 0
    state = create_train_state(pieces["params"], tx, pieces["model_state"], staleness=staleness)
    step = make_train_step(pieces["loss_fn"], tx, mode=cfg.mode, staleness=staleness,
                           clip_norm=cfg.clip_norm, grad_accum=cfg.grad_accum)
    rng = make_rng(args.seed, device)
    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if ckpt is not None:
        state, start = ckpt.restore_latest(state, generator=rng)
    feed_metrics = FeedMetrics()
    # Resume-correct stream: a restored run consumes batches N.., not 0..
    # Two batches of lookahead: one in flight while the next assembles.
    batches = prefetch(pieces["batches"](start), 2, metrics=feed_metrics)

    evaluate = None
    if args.eval_every:
        eval_step = make_eval_step(pieces["metric_fn"], return_sums=True)

        def evaluate(state):
            # (num, den) sums carry across the whole pass and divide once.
            return aggregate_metric_sums(
                eval_step(state, batch) for batch in pieces["eval_batches"](args.eval_batches))

    def lr_hook(step_: int, state_, metrics: dict) -> None:
        if "loss" in metrics:
            metrics["lr"] = float(lr_schedule(step_ - 1))

    try:
        state, last = fit(
            state, step, batches,
            num_steps=cfg.num_steps,
            rng=rng,
            log_every=cfg.log_every,
            hooks=(lr_hook,),
            checkpointer=ckpt,
            ckpt_every=args.ckpt_every,
            evaluate=evaluate,
            eval_every=args.eval_every,
            feed_metrics=feed_metrics,
        )
        if ckpt is not None and ckpt.latest_step() != state.step:
            ckpt.save(state.step, state, generator=rng)
    finally:
        if ckpt is not None:
            ckpt.close()
        batches.close()
    return state, last


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="BERT pretraining on one CUDA card (or the CPU)")
    p.add_argument("--config", required=True, help=f"workload preset; ported: {sorted(PRESETS)}")
    p.add_argument("--device", default="cuda",
                   help="training device: cuda (default; fails without a card) or cpu")
    p.add_argument("--steps", type=int, default=0, help="override num_steps")
    p.add_argument("--global-batch", type=int, default=0)
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

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    overrides = {}
    for flag, field in (("steps", "num_steps"), ("global_batch", "global_batch"),
                        ("grad_accum", "grad_accum"), ("bert_layers", "bert_layers"),
                        ("bert_hidden", "bert_hidden"), ("bert_vocab", "bert_vocab"),
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
    cfg = dataclasses.replace(PRESETS[args.config], **overrides)
    _, last = run(cfg, args)
    if last is not None:
        logger.info("final: %s", last)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
