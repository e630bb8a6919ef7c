"""``python -m distributed_tensorflow_tpu_torch.cli.serve --config=<preset>``.

Serve a saved checkpoint behind the dynamic micro-batcher: rebuild the
model from the preset (plus the same geometry overrides the training run
used), restore the newest checkpoint from ``--ckpt-dir``, warm the forward
per batch tier (x sequence bucket) on ``--device`` (the card by default),
and expose it over HTTP (serve/server.py routes).

Port of the JAX package's ``cli/serve.py`` for ``bert_base`` (``POST
/v1/mlm`` and ``/v1/embed``; ``--weight-dtype int8`` packs the kernels at
restore), the image presets ``mnist_lenet``, ``cifar_resnet20``,
``imagenet_resnet50`` and ``imagenet_inception_async`` (``POST
/v1/classify``: top-k through :class:`ImageClassifierEngine`, BatchNorm
from the checkpoint's running statistics) and ``lm_base`` (``POST
/v1/generate``: :class:`CausalLMEngine` behind the continuous batcher,
with the decode flags ``--slots --max-new-tokens --prefix-cache-mb
--block-tokens --prefill-chunk --spec-tokens --spec-min-match
--spec-backoff --kv-dtype --flush-admission --sched --preempt
--preempt-margin-ms --default-priority``), serving fault injection
(``--fault-plan``, placed within ``--fault-steps`` decode steps; its
events fire in the continuous batcher's decode loop and on the migration
wire) and the fleet flags: ``--disagg-role prefill|decode`` (a decode role
adopts KV-page chains on ``POST /v1/kv_transfer``; it needs
``--prefix-cache-mb > 0``), ``--kv-transfer-budget-mb`` (its bytes-in-flight
cap) and ``--stream-migrate`` (``POST /v1/stream_migrate``,
``/v1/stream_wait`` and ``/migratez``). Under a serving group the leader
mounts them; the page cells gather and cut heads, so a TP group exports
and adopts whole-head pages.

Serving layouts. ``--tp`` / ``--pp`` / ``--ep`` (or an explicit ``--mesh
data=2,model=2``) shard each engine over that many ranks of the serving
job, the remainder going to data parallelism: Megatron TP, GPipe stages
and replicated-dispatch expert parallelism for BERT, TP for ``lm_base``.
A device is a process here, so the job is a process group: start one
process a rank with the same flags and its own ``--process-id``
(``--coordinator-address host:port --num-processes N``, as the train CLI
takes them). Rank 0 leads (restores, warms, serves HTTP or the selftest);
the others warm the same grid and follow its cells
(:mod:`..serve.group`) until it stops. A layout that does not fit the
job's ranks falls back to data-parallel serving with a warning; image
presets given model axes serve data-parallel with JAX's warning. The
checkpoint flags must match the training run's: ``--moe-experts`` /
``--moe-topk`` for a mixture of experts, ``--pp`` for a pipeline run's
stacked encoder (served sequentially when the mesh has no pipeline
axis); ``--global-batch`` and ``--staleness`` are parsed and checked as
the JAX CLI's are and change nothing here (the restore reads the
parameters only).

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
    causal_kwargs: dict | None = None  # a decode (causal-LM) preset
    image_factory: str = ""  # a model factory of cli/train.py
    image_shape: tuple[int, int, int] = (0, 0, 0)


PRESETS = {
    "bert_base": ServePreset(
        name="bert_base",
        bert_kwargs=dict(max_position=128, dropout_rate=0.1, dtype=torch.bfloat16),
    ),
    "lm_base": ServePreset(
        name="lm_base",
        causal_kwargs=dict(max_position=128, dtype=torch.bfloat16),
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


def _resolve_mesh_spec(args, n_ranks: int) -> tuple[dict, bool]:
    """Serving mesh spec from ``--mesh`` / ``--tp/--pp/--ep`` -> ``(spec,
    fell_back)``, as the JAX CLI resolves it: a request that cannot fit the
    job's ``n_ranks`` degrades to data-parallel serving with a warning."""
    from distributed_tensorflow_tpu_torch.parallel.mesh import MeshSpec
    from distributed_tensorflow_tpu_torch.serve.engine import plan_serve_mesh

    if args.mesh:
        try:
            spec = {}
            for part in args.mesh.split(","):
                name, _, size = part.partition("=")
                spec[name.strip()] = int(size)
            MeshSpec(spec).resolve(n_ranks)  # loud fit check, result unused
            return spec, False
        except ValueError as e:
            logger.warning(
                "--mesh %r does not fit the %d available devices (%s); "
                "falling back to single-chip data-parallel serving",
                args.mesh, n_ranks, e,
            )
            return {"data": -1}, True
    return plan_serve_mesh(tp=args.tp, pp=args.pp, ep=args.ep, n_devices=n_ranks)


def _overridden(kwargs: dict, args) -> dict:
    """A preset's model kwargs with the CLI geometry overrides (the JAX
    CLI's ``--bert-hidden`` also sets intermediate = 4x)."""
    kwargs = dict(kwargs)
    if args.bert_layers:
        kwargs["num_layers"] = args.bert_layers
    if args.bert_hidden:
        kwargs["hidden_size"] = args.bert_hidden
        kwargs["intermediate_size"] = 4 * args.bert_hidden
    if args.bert_vocab:
        kwargs["vocab_size"] = args.bert_vocab
    return kwargs


def bert_config(preset: ServePreset, args):
    """The preset's :class:`BertConfig` with the CLI geometry overrides and
    the training run's layout flags: ``--moe-experts``/``--moe-topk``, and
    ``--pp`` > 1 for the stacked encoder (whether or not the mesh keeps a
    pipeline axis)."""
    from distributed_tensorflow_tpu_torch.models.bert import BertConfig

    kwargs = _overridden(preset.bert_kwargs, args)
    if args.moe_experts:
        kwargs.update(moe_experts=args.moe_experts, moe_topk=args.moe_topk)
    if args.pp > 1:
        kwargs["pipeline_parallel"] = args.pp
    return BertConfig(**kwargs)


def causal_config(preset: ServePreset, args):
    """The decode preset's :class:`CausalLMConfig` with the same overrides
    (the train CLI's ``lm_base`` reads the ``--bert-*`` flags too)."""
    from distributed_tensorflow_tpu_torch.models.causal_lm import CausalLMConfig

    return CausalLMConfig(**_overridden(preset.causal_kwargs, args))


def image_shape(preset: ServePreset, args) -> tuple[int, int, int]:
    """The image preset's geometry, square ``--image-size`` overriding."""
    if args.image_size:
        return (args.image_size, args.image_size, preset.image_shape[-1])
    return preset.image_shape


def _build_engine(preset: ServePreset, args, recorder, mesh=None, device=None):
    """Restore the checkpoint and build the preset's engine over ``mesh``
    (None: one process) on ``device`` (default ``args.device``); returns
    ``(engine, make_payload, step)``."""
    from distributed_tensorflow_tpu_torch.ckpt import restore_serving_state
    from distributed_tensorflow_tpu_torch.serve import (
        BertInferenceEngine,
        ImageClassifierEngine,
    )

    weight_dtype = args.weight_dtype or None
    device = args.device if device is None else device
    if preset.causal_kwargs is not None:
        from distributed_tensorflow_tpu_torch.models.causal_lm import CausalLM
        from distributed_tensorflow_tpu_torch.serve import CausalLMEngine

        cfg = causal_config(preset, args)
        params, _, step = restore_serving_state(
            args.ckpt_dir, weight_dtype=weight_dtype, num_heads=cfg.num_heads,
            recorder=recorder)
        engine = CausalLMEngine(
            CausalLM(cfg, device="meta"), params, device, mesh=mesh,
            buckets=tuple(args.buckets), slots=args.slots, max_batch=args.max_batch,
            batch_tiers=tuple(args.batch_tiers), max_new_tokens=args.max_new_tokens,
            prefix_cache_mb=args.prefix_cache_mb, block_tokens=args.block_tokens,
            prefill_chunk=args.prefill_chunk, spec_tokens=args.spec_tokens,
            spec_min_match=args.spec_min_match, spec_backoff=args.spec_backoff,
            weight_dtype=weight_dtype, kv_dtype=args.kv_dtype or None,
            # Disaggregated roles move KV-page chains between engines, and
            # live stream migration checkpoints slots off to a peer: both
            # warm their page export/import cells with the rest.
            kv_transfer=bool(args.disagg_role), stream_migrate=args.stream_migrate)
        vocab = cfg.vocab_size

        def make_payload(rng: np.random.Generator) -> dict:
            # Prompt + budget must fit the slot pages (max_position caps
            # them below the largest bucket + --max-new-tokens).
            new = int(rng.integers(1, args.max_new_tokens + 1))
            n = int(rng.integers(4, min(engine.buckets[-1], engine.cache_len - new) + 1))
            return {"input_ids": rng.integers(5, vocab, size=n), "max_new_tokens": new}

        return engine, make_payload, step
    if preset.image_factory:
        from distributed_tensorflow_tpu_torch.cli import train as train_cli

        shape = image_shape(preset, args)
        params, model_state, step = restore_serving_state(args.ckpt_dir, recorder=recorder)
        # The template module is built on the CPU; the engine loads the
        # restored params into it and moves it to the serving device.
        model = getattr(train_cli, preset.image_factory)(shape, "cpu")
        engine = ImageClassifierEngine(
            model, params, model_state, device, mesh=mesh, image_shape=shape,
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
        BertForPreTraining(cfg, device="meta"), params, device, mesh=mesh,
        buckets=tuple(args.buckets), max_batch=args.max_batch,
        batch_tiers=tuple(args.batch_tiers), weight_dtype=weight_dtype)
    vocab = cfg.vocab_size

    def make_payload(rng: np.random.Generator) -> dict:
        n = int(rng.integers(4, engine.buckets[-1] + 1))
        ids = rng.integers(5, vocab, size=n)
        return {"input_ids": ids, "mlm_targets": ids}

    return engine, make_payload, step


def serving_mesh(preset: ServePreset, args):
    """The job's serving mesh (built and made active on every rank), or None
    for one process: the layout flags resolved against the job's ranks,
    image presets kept data-parallel."""
    from distributed_tensorflow_tpu_torch.parallel.mesh import (
        build_mesh,
        data_axes,
        process_count,
    )

    spec, _ = _resolve_mesh_spec(args, process_count())
    mesh = build_mesh(spec)
    if preset.image_factory and set(mesh.axis_names) - set(data_axes(mesh)):
        # Model parallelism is a BERT / causal-LM feature: an image model on
        # model axes would compute the same thing on every rank of them.
        logger.warning("--tp/--pp/--ep apply to BERT configs only; serving %s "
                       "data-parallel", preset.name)
        mesh = build_mesh({"data": -1})
    return mesh if mesh.size > 1 else None


def build_serving_client(preset: ServePreset, args, *, mesh=None, device=None):
    """Preset + flags -> (Client, payload_maker) over the restored ckpt
    (the leader's half of a serving group when ``mesh`` is given)."""
    from distributed_tensorflow_tpu_torch.obs.flightrec import FlightRecorder
    from distributed_tensorflow_tpu_torch.obs.slo import SloSpec
    from distributed_tensorflow_tpu_torch.obs.trace import Tracer
    from distributed_tensorflow_tpu_torch.serve import BatcherConfig, Client

    fbuf = args.flight_buffer
    recorder = FlightRecorder(
        capacity=fbuf, enabled=fbuf > 0, dump_dir=args.dump_dir or None,
    )
    engine, make_payload, step = _build_engine(preset, args, recorder, mesh, device)
    logger.info("restored %s step %d for serving on %s (layout %s)", preset.name, step,
                engine.device, engine.layout)

    buf = args.trace_buffer
    slo = SloSpec(
        latency_threshold_ms=args.slo_p99_ms,
        latency_target=args.slo_target,
        availability_target=args.slo_availability,
    )
    client = Client(
        engine,
        BatcherConfig(
            # A decode engine admits at most a slot table's worth at once.
            max_batch=min(args.max_batch, engine.max_batch),
            max_delay_ms=args.max_delay_ms,
            max_queue=args.max_queue,
            max_in_flight=args.max_in_flight,
            bucket_queues=args.bucket_queues,
            sched=args.sched,
            preempt=args.preempt,
            preempt_margin_ms=args.preempt_margin_ms,
            default_priority=args.default_priority,
        ),
        tracer=Tracer(buffer_size=buf, enabled=buf > 0),
        slo=slo,
        admission="flush" if args.flush_admission else "continuous",
        recorder=recorder,
        warmup_ready_fraction=args.warmup_ready_fraction,
        tag=args.tag or f"ckpt-{step}",
    )
    if args.fault_plan:
        from distributed_tensorflow_tpu_torch.serve.faultinject import FaultInjector, FaultPlan

        plan = FaultPlan.parse(args.fault_plan, num_steps=args.fault_steps)
        client.batcher.fault_injector = FaultInjector(plan, recorder=client.recorder)
        logger.info("serving fault plan armed: %d scheduled events (seed %s)",
                    len(plan.events), plan.seed)
    return client, make_payload


def _fleet_mounts(client, args) -> dict:
    """The fleet routes' handlers for ``build_http_server``: the KV-chain
    receiver of a decode role and the stream receiver and migrator of
    ``--stream-migrate``, sharing one transfer budget."""
    from distributed_tensorflow_tpu_torch.serve.disagg import (
        TransferBudget,
        make_kv_receiver,
        make_stream_receiver,
        migrate_streams,
    )

    mounts = {}
    budget = None
    if args.disagg_role == "decode" or args.stream_migrate:
        budget = TransferBudget(int(args.kv_transfer_budget_mb * 1024 * 1024))
        mounts["transfer_budget"] = budget
    if args.disagg_role == "decode":
        mounts["kv_receiver"] = make_kv_receiver(
            client.batcher, client.engine, budget=budget, metrics=client.metrics,
            recorder=client.recorder)
        logger.info("disaggregated decode role: accepting KV-page chains on POST "
                    "/v1/kv_transfer (budget %.1f MiB in flight)", args.kv_transfer_budget_mb)
    elif args.disagg_role == "prefill":
        logger.info("disaggregated prefill role: operators should cap max_new_tokens at 1 "
                    "and ship published pages with serve.disagg.post_kv_transfer")
    if args.stream_migrate:
        mounts["stream_receiver"] = make_stream_receiver(
            client.batcher, client.engine, budget=budget, metrics=client.metrics,
            recorder=client.recorder)

        def migrator(targets):
            return migrate_streams(
                client.batcher, client.engine, targets, metrics=client.metrics,
                recorder=client.recorder, fault_injector=client.batcher.fault_injector)

        mounts["migrator"] = migrator
        logger.info("live stream migration enabled: POST /v1/stream_migrate (budget %.1f "
                    "MiB in flight), /v1/stream_wait, /migratez", args.kv_transfer_budget_mb)
    return mounts


def _selftest(client, make_payload, n: int) -> int:
    rng = np.random.default_rng(0)
    futures = [client.submit(make_payload(rng)) for _ in range(n)]
    results = [f.result(timeout=120) for f in futures]
    assert len(results) == n
    print(json.dumps(client.metrics.snapshot(), indent=2, default=float))
    # The batcher's /statusz digest: admission mode, slots, prefix cache,
    # speculation and scheduling state for a decode engine.
    logger.info("selftest ok: %d requests served; batcher status %s", n,
                json.dumps(client.batcher.status(), default=float))
    return 0


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="serve a saved BERT, image-classifier or causal-LM checkpoint "
                    "(dynamic- and continuous-batching inference)"
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
    # Decode engine (lm_base): requests admit into KV-cache slots between
    # decode steps unless --flush-admission pins static batching.
    p.add_argument("--slots", type=int, default=8,
                   help="KV-cache slots = most sequences decoding at once (one "
                        "decode cell at this width)")
    p.add_argument("--max-new-tokens", type=int, default=32,
                   help="generation cap per request (requests may ask for less; "
                        "also sizes the per-slot cache pages)")
    p.add_argument("--prefix-cache-mb", type=float, default=0.0,
                   help="device MiB for the prefix-cache KV page pool; shared "
                        "prompt heads prefill once (0 disables)")
    p.add_argument("--block-tokens", type=int, default=16,
                   help="tokens per prefix-cache page; prompts share whole pages")
    p.add_argument("--prefill-chunk", type=int, default=0,
                   help="prefill prompts in chunks of at most this many tokens, "
                        "interleaved with decode steps (0 = monolithic prefill "
                        "unless --prefix-cache-mb is set)")
    p.add_argument("--spec-tokens", type=int, default=0,
                   help="speculative-decoding draft length k: verify up to k "
                        "n-gram-drafted tokens a slot in one [slots, k+1] forward "
                        "(0 disables; the output is the same either way)")
    p.add_argument("--spec-min-match", type=int, default=2,
                   help="shortest history n-gram the drafter may match")
    p.add_argument("--spec-backoff", type=float, default=0.25,
                   help="per-slot acceptance-EMA threshold below which "
                        "speculation backs off to plain decode (re-probing)")
    p.add_argument("--kv-dtype", default="",
                   choices=["", "float32", "bfloat16", "int8"],
                   help="KV-cache storage dtype (lm_base only): int8 pages carry "
                        "per-position scales; empty keeps the config dtype")
    p.add_argument("--flush-admission", action="store_true",
                   help="admit new requests only when the slot table is EMPTY "
                        "(static batching; the baseline for continuous admission)")
    p.add_argument("--sched", default="fifo", choices=["fifo", "edf"],
                   help="admission order: fifo (arrival) or edf (earliest "
                        "deadline first within priority class)")
    p.add_argument("--preempt", action="store_true",
                   help="preempt a lower-priority decode slot when a queued "
                        "deadline holder would miss its deadline (needs --sched "
                        "edf; preempted streams resume bit-identically)")
    p.add_argument("--preempt-margin-ms", type=float, default=20.0,
                   help="preempt when now + margin crosses a queued request's "
                        "deadline")
    p.add_argument("--default-priority", type=int, default=1,
                   help="priority class of requests that send none (0 = most "
                        "urgent)")
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
    p.add_argument("--fault-plan", default="",
                   help="serving fault-injection plan (drills): 'seed=..,dispatch_error=N,"
                        "slow_decode_step=N,wire_corrupt=N,replica_kill=N,slow_step_s=S' or "
                        "a FaultPlan JSON path; its events fire in the continuous batcher's "
                        "decode loop and on the migration wire (lm_base only)")
    p.add_argument("--fault-steps", type=int, default=1000,
                   help="decode-step horizon --fault-plan events are placed within when the "
                        "spec is key=value form")
    # Serving layouts (see the module docstring); a layout that does not fit
    # the job's ranks falls back to data-parallel serving with a warning.
    p.add_argument("--mesh", default="",
                   help="explicit serving mesh, e.g. 'data=2,model=2' (axes from "
                        "parallel.mesh.AXIS_ORDER; one axis may be -1). Overrides "
                        "--tp/--pp/--ep")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel (Megatron) ranks per engine; must divide "
                        "num_heads and intermediate_size")
    p.add_argument("--pp", type=int, default=1,
                   help="pipeline-parallel stages per engine; the checkpoint must be a "
                        "--pipeline-parallel=N run (stacked encoder)")
    p.add_argument("--ep", type=int, default=1,
                   help="expert-parallel ranks per engine; needs a --moe-experts "
                        "checkpoint divisible by it")
    p.add_argument("--moe-experts", type=int, default=0,
                   help="training run's --moe-experts (MoE ckpts)")
    p.add_argument("--moe-topk", type=int, default=1, help="training run's --moe-topk")
    p.add_argument("--global-batch", type=int, default=0,
                   help="training run's --global-batch (only needed when the preset "
                        "default doesn't match, e.g. pipeline runs validating "
                        "microbatch divisibility)")
    p.add_argument("--staleness", type=int, default=-1,
                   help="training run's staleness (stale-mode ckpts)")
    # The serving job's process group, as the train CLI takes it: one
    # process a rank (a device is a process here).
    p.add_argument("--coordinator-address", default="",
                   help="multi-process bootstrap: coordinator ip:port of the serving "
                        "job's process group (required for a manual launch)")
    p.add_argument("--num-processes", type=int, default=0,
                   help="multi-process bootstrap: total process count "
                        "(with --coordinator-address)")
    p.add_argument("--process-id", type=int, default=-1,
                   help="multi-process bootstrap: this process's rank in "
                        "[0, --num-processes); rank 0 leads, the others follow")
    p.add_argument("--init-timeout", type=float, default=300.0,
                   help="multi-process bootstrap: seconds the process group may take to "
                        "form, and a collective on its world group or the leader's "
                        "broadcast of a cell to its followers may wait, before the job "
                        "fails")
    # Fleet serving (serve/disagg.py): run this process as ONE role of a
    # prefill/decode pair, and/or let its live streams migrate.
    p.add_argument("--disagg-role", default="", choices=["", "prefill", "decode"],
                   help="disaggregated-serving role; decode requires --prefix-cache-mb > 0 "
                        "(the adopted chains land in the prefix-cache page pool)")
    p.add_argument("--kv-transfer-budget-mb", type=float, default=64.0,
                   help="bytes-in-flight cap (MiB) for inbound KV-page transfers and "
                        "migrated streams; transfers beyond it queue briefly then shed "
                        "with 429 + Retry-After (the sender re-prefills instead)")
    p.add_argument("--stream-migrate", action="store_true",
                   help="enable live decode-stream migration: mount POST "
                        "/v1/stream_migrate + /v1/stream_wait (receive side) and POST "
                        "/migratez (export side); causal-LM engines only")
    return p


def main(argv: list[str] | None = None):
    parser = make_parser()
    args = parser.parse_args(argv)
    if args.config not in PRESETS:
        parser.error(f"--config {args.config}: unknown preset "
                     f"(ported: {sorted(PRESETS)})")
    if args.disagg_role == "decode" and args.prefix_cache_mb <= 0:
        parser.error("--disagg-role decode requires --prefix-cache-mb > 0 "
                     "(adopted KV-page chains land in the prefix-cache "
                     "page pool)")
    if (args.stream_migrate or args.disagg_role) and PRESETS[args.config].causal_kwargs is None:
        parser.error(f"--{'stream-migrate' if args.stream_migrate else 'disagg-role'} "
                     "applies to causal-LM (decode) presets only")
    if args.staleness < -1:
        parser.error(f"--staleness must be >= -1 (-1: the preset's), got {args.staleness}")
    if args.global_batch < 0:
        parser.error(f"--global-batch must be >= 0 (0: the preset's), got {args.global_batch}")
    for flag in ("tp", "pp", "ep", "moe_topk"):
        if getattr(args, flag) < 1:
            parser.error(f"--{flag.replace('_', '-')} must be >= 1")
    if args.weight_dtype and PRESETS[args.config].image_factory:
        parser.error("--weight-dtype is not supported for image serving (the "
                     "classifier forward has no dequantize step)")
    if args.fault_plan and PRESETS[args.config].causal_kwargs is None:
        parser.error("--fault-plan only applies to causal-LM decode serving (its hooks "
                     "sit in the continuous batcher's decode loop)")
    if args.kv_dtype and PRESETS[args.config].causal_kwargs is None:
        parser.error("--kv-dtype only applies to causal-LM decode serving "
                     "(nothing else owns a KV cache)")

    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(name)s: %(message)s"
    )
    from distributed_tensorflow_tpu_torch.parallel.mesh import (
        initialize_runtime,
        shutdown_runtime,
    )

    preset = PRESETS[args.config]
    # The serving job's process group: explicit flags, or a launcher's
    # environment; neither is one process. A group that fails to form
    # raises: the job never serves at one process instead.
    device = initialize_runtime(
        coordinator_address=args.coordinator_address or None,
        num_processes=args.num_processes if args.num_processes > 0 else None,
        process_id=args.process_id if args.process_id >= 0 else None,
        device=args.device, timeout_s=args.init_timeout)
    try:
        mesh = serving_mesh(preset, args)
        if mesh is None or mesh.rank == 0:
            return _lead(preset, args, mesh, device)
        engine, _, step = _build_engine(preset, args, None, mesh, device)
        logger.info("serving group rank %d (%s, step %d): following the leader",
                    mesh.rank, engine.layout, step)
        return engine.follow()
    finally:
        shutdown_runtime()


def _lead(preset: ServePreset, args, mesh, device) -> int:
    """The leader's (or the one process's) serving: the client, then the
    selftest or the HTTP front end; closing the client stops the
    followers."""
    client, make_payload = build_serving_client(preset, args, mesh=mesh, device=device)
    try:
        if args.selftest:
            return _selftest(client, make_payload, args.selftest)
        from distributed_tensorflow_tpu_torch.serve import build_http_server

        server = build_http_server(client, args.host, args.port,
                                   trace_dir=args.trace_dir or None,
                                   **_fleet_mounts(client, args))
        logger.info(
            "ready on http://%s:%d (POST /v1/%s; GET /healthz /sloz /statusz /memz "
            "/compilez /tracez /metrics?format=prom, POST /profilez /drainz "
            "/debugz/dump)",
            *server.server_address,
            "classify" if hasattr(client.engine, "image_shape")
            else "generate" if hasattr(client.engine, "decode")
            else "mlm",
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
