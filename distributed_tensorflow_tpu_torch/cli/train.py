"""``python -m distributed_tensorflow_tpu_torch.cli.train --config <preset>``.

Port of the JAX package's ``cli/train.py``, on the card by default
(``--device cpu`` runs on the CPU), in one process or as one rank of a
multi-process job (``--coordinator-address host:port --num-processes N
--process-id i`` in each process, or a torchrun environment; each rank
trains on its own card and ``--global-batch`` stays global), for the
presets ``bert_base`` (MLM + NSP pretraining), ``mnist_lenet``,
``cifar_resnet20``, ``imagenet_resnet50`` and ``imagenet_inception_async``
(image classification with BatchNorm statistics in the train state; the
last under K = 4 stale gradients), under synchronous or K-stale data
parallelism. The optimizer recipes keep the JAX names:
:func:`make_lr_schedule`, :func:`_decay_mask` and :func:`_make_tx`.

Data is seeded and synthetic: the Markov-chain MLM stream, and class-template
images through the numpy feed (no augmentation; the JAX CLI falls back to
the same feed when its native pipeline cannot be built). The other presets
and the flags of the paths not ported yet (real-data readers among them,
``--data-dir``) are refused with a message naming the slice that brings
them. The JAX CLI trains ResNet-50 and Inception-v3 with plain
convolutions, so this one has no ``pw_backend`` or ``fused`` flag either;
``ResNet50(pw_backend=...)`` and ``InceptionV3(fused=True)`` select the
kernels.
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
    momentum: float = 0.9
    optimizer: str = "sgd"  # "sgd" | "adam" | "adamw"
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
    image_size: int = 0  # > 0: override the image presets' square geometry
    dataset: str = ""  # dataset name for data.readers.load_dataset
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


def _build_image_workload(model_factory, image_shape, num_classes, n_examples=4096):
    """``model_factory(shape, device)`` builds the model on the device
    (seeded init, the JAX package's ``jax.random.key(0)`` counterpart)."""

    def build(cfg: WorkloadConfig):
        from distributed_tensorflow_tpu_torch.data.loader import device_batches
        from distributed_tensorflow_tpu_torch.data.readers import load_dataset
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
                    cfg.dataset or "synthetic", None, split=split,
                    fallback_examples=max(n_examples, cfg.global_batch),
                    image_shape=shape, num_classes=num_classes,
                    seed=0 if split == "train" else 1,
                )

            ds = load("train")
            logger.info("image feed: numpy device_batches, no augmentation (the native "
                        "pipeline comes with a later slice)")
            eval_ds_box: list = []  # the val split loads on the first eval pass

            def eval_batches(n_batches: int) -> Iterator[dict]:
                if not eval_ds_box:
                    eval_ds_box.append(load("val"))
                it = device_batches(eval_ds_box[0], cfg.global_batch, device=device, seed=101)
                for _ in range(n_batches):
                    yield next(it)

            return {
                "params": params,
                "model_state": model_state,
                "model": net,
                "image_shape": shape,
                "loss_fn": make_classification_loss(net),
                "batches": lambda start_step=0: device_batches(
                    ds, cfg.global_batch, device=device, seed=1, start_step=start_step),
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
    ),
    "imagenet_resnet50": WorkloadConfig(
        name="imagenet_resnet50",
        build=_build_image_workload(_resnet50, (224, 224, 3), 1000, n_examples=8192),
        global_batch=256,
        num_steps=5000,
        learning_rate=0.4,  # linear-scaling rule for large global batch
        lr_schedule="warmup_cosine",
        dataset="imagenet",
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
}

# Presets of the JAX package that later slices bring.
_UNPORTED_PRESETS = {
    "lm_base": "the causal-LM slice",
}

# Flags of the JAX CLI that this slice's path does not read, with why.
_UNPORTED_FLAGS = {
    **dict.fromkeys(("--no-native-input", "--device-pool"),
                    "the native input pipeline and HBM batch pools come with a later "
                    "image slice; the feed is the numpy one"),
    "--data-dir": ("the real-data readers come with later slices (TextCorpusMLM for "
                   "bert_base; the MNIST/CIFAR/ImageFolder readers for the image presets)"),
    **dict.fromkeys(("--seq-parallel", "--sp-impl", "--tensor-parallel", "--moe-experts",
                     "--moe-dispatch", "--moe-topk", "--pipeline-parallel",
                     "--pipeline-microbatches", "--expert-parallel"),
                    "comes with the model-parallel slice"),
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
    from distributed_tensorflow_tpu_torch.obs.metrics import FeedMetrics
    from distributed_tensorflow_tpu_torch.parallel.mesh import (
        build_mesh,
        initialize_runtime,
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
    mesh = build_mesh({"data": -1})
    if process_index() == 0:
        logger.info("workload=%s mesh=%s device=%s", cfg.name, dict(mesh.shape), device)
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
    cfg = dataclasses.replace(PRESETS[args.config], **overrides)
    from distributed_tensorflow_tpu_torch.parallel.mesh import process_index, shutdown_runtime

    try:
        _, last = run(cfg, args)
        if last is not None and process_index() == 0:
            logger.info("final: %s", last)
    finally:
        shutdown_runtime()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
