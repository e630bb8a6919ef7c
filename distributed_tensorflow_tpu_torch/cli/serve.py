"""``python -m distributed_tensorflow_tpu_torch.cli.serve --config=<preset>``.

Serve a saved checkpoint behind the dynamic micro-batcher: rebuild the
model from the preset (plus the same geometry overrides the training run
used), restore the newest checkpoint from ``--ckpt-dir``, warm the forward
per batch tier (x sequence bucket) on ``--device`` (the card by default),
and expose it over HTTP (serve/server.py routes).

Port of the JAX package's ``cli/serve.py`` for ``bert_base`` (``POST
/v1/mlm`` and ``/v1/embed``; ``--weight-dtype int8`` packs the kernels at
restore) and the image presets ``mnist_lenet``, ``cifar_resnet20``,
``imagenet_resnet50`` and ``imagenet_inception_async`` (``POST
/v1/classify``: top-k through :class:`ImageClassifierEngine`, BatchNorm
from the checkpoint's running statistics). ``lm_base`` and the decode
flags are refused until the continuous batcher is ported: the decode
engine (:class:`CausalLMEngine`) exists, its batcher does not yet.

``--selftest N`` runs N synthetic requests through the in-process
:class:`Client` instead of binding a port and prints the metrics snapshot.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging

import numpy as np
import torch

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class ServePreset:
    """The serving half of a JAX-package workload preset: the BERT config
    overrides, or an image model (``cli/train.py`` PRESETS)."""

    name: str
    bert_kwargs: dict | None = None
    image_factory: str = ""  # a model factory of cli/train.py
    image_shape: tuple[int, int, int] = (0, 0, 0)


PRESETS = {
    "bert_base": ServePreset(
        name="bert_base",
        bert_kwargs=dict(max_position=128, dropout_rate=0.1, dtype=torch.bfloat16),
    ),
    "mnist_lenet": ServePreset("mnist_lenet", image_factory="_lenet",
                               image_shape=(28, 28, 1)),
    "cifar_resnet20": ServePreset("cifar_resnet20", image_factory="_resnet20",
                                  image_shape=(32, 32, 3)),
    "imagenet_resnet50": ServePreset("imagenet_resnet50", image_factory="_resnet50",
                                     image_shape=(224, 224, 3)),
    "imagenet_inception_async": ServePreset("imagenet_inception_async",
                                            image_factory="_inception",
                                            image_shape=(299, 299, 3)),
}

# Presets of the JAX package whose serving path is not ported yet.
_UNPORTED_PRESETS = {
    "lm_base": "decode serving needs the continuous batcher (ContinuousBatcher, "
               "serve/kvpool.py and /v1/generate: Queue A item 4 of ROADMAP.md)",
}

# Decode-serving flags of the JAX CLI (causal-LM presets): refused here.
_DECODE_FLAGS = {
    "slots": 8, "max_new_tokens": 32, "prefix_cache_mb": 0.0,
    "block_tokens": 16, "prefill_chunk": 0, "spec_tokens": 0,
    "kv_dtype": "", "disagg_role": "", "stream_migrate": False,
    "flush_admission": False, "sched": "fifo", "preempt": False,
}


def bert_config(preset: ServePreset, args):
    """The preset's :class:`BertConfig` with the CLI geometry overrides
    (the JAX CLI's ``--bert-hidden`` also sets intermediate = 4x)."""
    from distributed_tensorflow_tpu_torch.models.bert import BertConfig

    kwargs = dict(preset.bert_kwargs)
    if args.bert_layers:
        kwargs["num_layers"] = args.bert_layers
    if args.bert_hidden:
        kwargs["hidden_size"] = args.bert_hidden
        kwargs["intermediate_size"] = 4 * args.bert_hidden
    if args.bert_vocab:
        kwargs["vocab_size"] = args.bert_vocab
    return BertConfig(**kwargs)


def image_shape(preset: ServePreset, args) -> tuple[int, int, int]:
    """The image preset's geometry, square ``--image-size`` overriding."""
    if args.image_size:
        return (args.image_size, args.image_size, preset.image_shape[-1])
    return preset.image_shape


def _build_engine(preset: ServePreset, args, recorder):
    """Restore the checkpoint and build the preset's engine; returns
    ``(engine, make_payload, step)``."""
    from distributed_tensorflow_tpu_torch.ckpt import restore_serving_state
    from distributed_tensorflow_tpu_torch.serve import (
        BertInferenceEngine,
        ImageClassifierEngine,
    )

    weight_dtype = args.weight_dtype or None
    if preset.image_factory:
        from distributed_tensorflow_tpu_torch.cli import train as train_cli

        shape = image_shape(preset, args)
        params, model_state, step = restore_serving_state(args.ckpt_dir, recorder=recorder)
        # The template module is built on the CPU; the engine loads the
        # restored params into it and moves it to the serving device.
        model = getattr(train_cli, preset.image_factory)(shape, "cpu")
        engine = ImageClassifierEngine(
            model, params, model_state, args.device, image_shape=shape,
            max_batch=args.max_batch, batch_tiers=tuple(args.batch_tiers),
            top_k=args.top_k)

        def make_payload(rng: np.random.Generator) -> dict:
            return {"image": rng.standard_normal(shape).astype(np.float32)}

        return engine, make_payload, step

    from distributed_tensorflow_tpu_torch.models.bert import BertForPreTraining

    cfg = bert_config(preset, args)
    params, _, step = restore_serving_state(
        args.ckpt_dir, weight_dtype=weight_dtype, num_heads=cfg.num_heads,
        recorder=recorder)
    engine = BertInferenceEngine(
        BertForPreTraining(cfg, device="cpu"), params, args.device,
        buckets=tuple(args.buckets), max_batch=args.max_batch,
        batch_tiers=tuple(args.batch_tiers), weight_dtype=weight_dtype)
    vocab = cfg.vocab_size

    def make_payload(rng: np.random.Generator) -> dict:
        n = int(rng.integers(4, engine.buckets[-1] + 1))
        ids = rng.integers(5, vocab, size=n)
        return {"input_ids": ids, "mlm_targets": ids}

    return engine, make_payload, step


def build_serving_client(preset: ServePreset, args):
    """Preset + flags -> (Client, payload_maker) over the restored ckpt."""
    from distributed_tensorflow_tpu_torch.obs.flightrec import FlightRecorder
    from distributed_tensorflow_tpu_torch.obs.slo import SloSpec
    from distributed_tensorflow_tpu_torch.obs.trace import Tracer
    from distributed_tensorflow_tpu_torch.serve import BatcherConfig, Client

    fbuf = args.flight_buffer
    recorder = FlightRecorder(
        capacity=fbuf, enabled=fbuf > 0, dump_dir=args.dump_dir or None,
    )
    engine, make_payload, step = _build_engine(preset, args, recorder)
    logger.info("restored %s step %d for serving on %s", preset.name, step, args.device)

    buf = args.trace_buffer
    slo = SloSpec(
        latency_threshold_ms=args.slo_p99_ms,
        latency_target=args.slo_target,
        availability_target=args.slo_availability,
    )
    client = Client(
        engine,
        BatcherConfig(
            max_batch=args.max_batch,
            max_delay_ms=args.max_delay_ms,
            max_queue=args.max_queue,
            max_in_flight=args.max_in_flight,
            bucket_queues=args.bucket_queues,
        ),
        tracer=Tracer(buffer_size=buf, enabled=buf > 0),
        slo=slo,
        recorder=recorder,
        warmup_ready_fraction=args.warmup_ready_fraction,
        tag=args.tag or f"ckpt-{step}",
    )
    return client, make_payload


def _selftest(client, make_payload, n: int) -> int:
    rng = np.random.default_rng(0)
    futures = [client.submit(make_payload(rng)) for _ in range(n)]
    results = [f.result(timeout=120) for f in futures]
    assert len(results) == n
    print(json.dumps(client.metrics.snapshot(), indent=2, default=float))
    logger.info("selftest ok: %d requests served", n)
    return 0


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="serve a saved BERT or image-classifier checkpoint "
                    "(dynamic-batching inference)"
    )
    p.add_argument("--config", required=True,
                   help=f"workload preset; ported: {sorted(PRESETS)}")
    p.add_argument("--ckpt-dir", required=True,
                   help="checkpoint directory (newest step served)")
    p.add_argument("--device", default="cuda",
                   help="serving device: cuda (default; fails without a card) or cpu")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--tag", default=None,
                   help="deployment tag surfaced on /healthz (default "
                        "ckpt-<restored step>)")
    p.add_argument("--port", type=int, default=8000,
                   help="0 = ephemeral (logged at startup)")
    p.add_argument("--buckets", type=int, nargs="+", default=[128, 256, 512],
                   help="sequence-length buckets (clamped to the model's "
                        "max_position); one warmed cell per tier each")
    p.add_argument("--max-batch", type=int, default=8,
                   help="largest batch size / flush size")
    p.add_argument("--batch-tiers", type=int, nargs="+", default=[1, 2, 4, 8],
                   help="batch-size tiers (clamped to --max-batch); a partial "
                        "flush runs the smallest tier that fits")
    p.add_argument("--max-in-flight", type=int, default=2,
                   help="batches dispatched but not yet fetched; >1 overlaps "
                        "host assembly with device compute")
    p.add_argument("--bucket-queues", action="store_true",
                   help="queue per sequence bucket")
    p.add_argument("--max-delay-ms", type=float, default=8.0,
                   help="flush a partial batch after this wait")
    p.add_argument("--max-queue", type=int, default=64,
                   help="queue bound; beyond -> 429 + Retry-After")
    p.add_argument("--weight-dtype", default="",
                   choices=["", "float32", "bfloat16", "int8"],
                   help="BERT serving dtype for restored params (int8: per-channel "
                        "absmax packing at restore); empty keeps the checkpoint dtype")
    p.add_argument("--top-k", type=int, default=5,
                   help="image presets: classes returned per image")
    p.add_argument("--bert-layers", type=int, default=0)
    p.add_argument("--bert-hidden", type=int, default=0)
    p.add_argument("--bert-vocab", type=int, default=0)
    p.add_argument("--image-size", type=int, default=0,
                   help="image presets: the square input size the model trained at")
    p.add_argument("--slo-p99-ms", type=float, default=0.0,
                   help="latency SLO threshold in ms (0 = none)")
    p.add_argument("--slo-target", type=float, default=0.99)
    p.add_argument("--slo-availability", type=float, default=0.0,
                   help="availability SLO target fraction (0 = none)")
    p.add_argument("--trace-dir", default="",
                   help="receives a Chrome span trace at shutdown, and the "
                        "torch.profiler traces of POST /profilez")
    p.add_argument("--trace-buffer", type=int, default=4096,
                   help="span ring-buffer size (0 disables tracing)")
    p.add_argument("--flight-buffer", type=int, default=2048,
                   help="flight-recorder event ring size (0 disables)")
    p.add_argument("--dump-dir", default="",
                   help="where flight-recorder dumps land")
    p.add_argument("--warmup-ready-fraction", type=float, default=1.0,
                   help="/healthz reports 'starting' until this fraction of "
                        "the grid is warm")
    p.add_argument("--selftest", type=int, default=0,
                   help="serve N synthetic requests in-process and exit")
    for name, default in _DECODE_FLAGS.items():
        flag = "--" + name.replace("_", "-")
        if isinstance(default, bool):
            p.add_argument(flag, action="store_true", help=argparse.SUPPRESS)
        else:
            p.add_argument(flag, type=type(default), default=default,
                           help=argparse.SUPPRESS)
    return p


def main(argv: list[str] | None = None):
    parser = make_parser()
    args = parser.parse_args(argv)
    if args.config not in PRESETS:
        if args.config in _UNPORTED_PRESETS:
            parser.error(f"--config {args.config}: not ported to PyTorch yet: "
                         f"{_UNPORTED_PRESETS[args.config]} (ported: {sorted(PRESETS)})")
        parser.error(f"--config {args.config}: unknown preset "
                     f"(ported: {sorted(PRESETS)})")
    set_decode = [
        "--" + k.replace("_", "-") for k, d in _DECODE_FLAGS.items()
        if getattr(args, k) != d
    ]
    if set_decode:
        parser.error(f"{', '.join(set_decode)}: decode serving is not ported to "
                     f"PyTorch yet: {_UNPORTED_PRESETS['lm_base']}")
    if args.weight_dtype and PRESETS[args.config].image_factory:
        parser.error("--weight-dtype is not supported for image serving (the "
                     "classifier forward has no dequantize step)")

    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(name)s: %(message)s"
    )
    client, make_payload = build_serving_client(PRESETS[args.config], args)
    try:
        if args.selftest:
            return _selftest(client, make_payload, args.selftest)
        from distributed_tensorflow_tpu_torch.serve import build_http_server

        server = build_http_server(client, args.host, args.port,
                                   trace_dir=args.trace_dir or None)
        logger.info(
            "ready on http://%s:%d (POST /v1/mlm /v1/embed /v1/classify; GET /healthz "
            "/sloz /statusz /memz /compilez /tracez /metrics?format=prom, "
            "POST /profilez /drainz /debugz/dump)",
            *server.server_address,
        )
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            logger.info("shutting down")
        finally:
            server.server_close()
        return 0
    finally:
        client.close()
        if args.trace_dir and client.tracer.enabled:
            from pathlib import Path

            out = client.tracer.export(Path(args.trace_dir) / "serve_trace.json")
            logger.info("wrote span trace to %s", out)


if __name__ == "__main__":
    raise SystemExit(main())
