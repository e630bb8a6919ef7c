"""Inference engines: checkpoint-loaded forwards over warmed shape grids.

Port of the JAX package's ``serve/engine.py``: the BERT engine (MLM scoring
/ embeddings, float or int8 weights), the causal-LM decode engine
(:class:`CausalLMEngine`, a slot-addressed KV cache on the device driven
cell by cell) and the image classifier (:class:`ImageClassifierEngine`,
top-k). For the BERT engine: every (batch tier x sequence bucket) cell the
engine will ever run is warmed at STARTUP by one forward at that shape,
timed into a :class:`CompileRecord`, so ``grid_status``/``warm_fraction``
keep their meaning (the JAX engine AOT-compiled one executable per cell;
capturing each cell as a CUDA graph is later work). Requests pad up to the
smallest bucket that fits (``buckets``, default {128, 256, 512} clamped to
``max_position``); partial batches pad with inert rows to the SMALLEST
batch tier that holds them.

The request path is split ``dispatch -> fetch``: ``dispatch`` fills pooled
host staging buffers (pinned on a card), copies them to the device without
blocking, enqueues the forward and the copy of its results into pinned
host buffers, and returns an :class:`InFlightBatch`; ``fetch`` waits on the
batch's CUDA event — the only synchronisation point — and slices per-row
results. The batcher overlaps batch k+1's assembly with batch k's device
work through that split.

Layouts. Without ``mesh`` an engine serves from one process (``layout ==
"single"``). With ``mesh``, the job's active mesh of a process group
(:func:`..parallel.mesh.build_mesh`), every rank builds the same engine and
serves its shard through a :class:`~.group.ServingGroup`: rank 0 leads, the
others ``follow()`` (see :mod:`.group`). The BERT engine serves Megatron TP
(``"model"``), replicated-dispatch expert parallelism (``"expert"``) and
the GPipe pipeline (``"pipeline"``, the stacked checkpoint); the causal LM
serves TP; the image engine data parallelism. A tier's rows split over the
``"data"`` ranks when the tier divides them, and are replicated when it
does not (the JAX engine's ``_batch_sharding_or_replicated``); the leader
gathers them. :func:`plan_serve_mesh` picks the layout.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from distributed_tensorflow_tpu_torch.device import resolve_device
from distributed_tensorflow_tpu_torch.models.quant import (
    cast_params,
    fp32_equiv_nbytes,
    is_quantized_leaf,
    is_quantized_tree,
    load_params,
    normalize_quant_dtype,
    quantize_kv,
    quantize_params,
    torch_dtype,
)
from distributed_tensorflow_tpu_torch.obs.memory import default_registry, tree_nbytes
from distributed_tensorflow_tpu_torch.serve.kvpool import KVBlockPool
from distributed_tensorflow_tpu_torch.serve.spec import SpecConfig

logger = logging.getLogger(__name__)


class RequestError(ValueError):
    """A malformed or un-servable request (maps to HTTP 400, not 500)."""


def plan_serve_mesh(
    tp: int = 1,
    pp: int = 1,
    ep: int = 1,
    n_devices: int | None = None,
) -> tuple[dict, bool]:
    """Serving-mesh spec for the requested model parallelism, with graceful
    degradation: returns ``(spec, fell_back)``.

    The model axes need ``tp * pp * ep`` ranks of the serving job (default
    its process count when a process group is up, else
    ``torch.cuda.device_count()``) and the remainder goes to data
    parallelism, so the product must divide the ranks. When it does not,
    serving falls back to ``{"data": -1}`` with a warning: a wrong-sized
    ``--tp`` degrades to slower serving and never dies at startup. The
    engines serve the spec's mesh over a :class:`~.group.ServingGroup`.
    """
    if n_devices is None:
        from distributed_tensorflow_tpu_torch.parallel.mesh import process_count

        n_devices = process_count() if dist.is_initialized() else torch.cuda.device_count()
    need = max(tp, 1) * max(pp, 1) * max(ep, 1)
    if need <= 1:
        return {"data": -1}, False
    if need > n_devices or n_devices % need:
        logger.warning(
            "requested serving mesh (tp=%d pp=%d ep=%d) needs %d devices "
            "to divide the %d available; falling back to single-device "
            "data-parallel serving",
            tp, pp, ep, need, n_devices,
        )
        return {"data": -1}, True
    spec = {"data": -1}
    if pp > 1:
        spec["pipeline"] = pp
    if ep > 1:
        spec["expert"] = ep
    if tp > 1:
        spec["model"] = tp
    return spec, False


def _normalize_tiers(tiers, max_batch: int) -> tuple[int, ...]:
    """Clamp the tier ladder to ``max_batch`` and guarantee a full-batch
    rung — the grid must always hold a ``max_batch``-row flush."""
    tiers = tuple(tiers) if tiers else (1, 2, 4, 8)
    t = {min(int(x), max_batch) for x in tiers if int(x) >= 1}
    t.add(max_batch)
    return tuple(sorted(t))


@dataclasses.dataclass
class InFlightBatch:
    """A dispatched-but-unfetched batch: host result buffers still being
    filled by the device, the event that marks them complete, and host
    bookkeeping."""

    out: dict
    key: tuple          # (tier, bucket) grid cell
    n: int              # real rows (the rest of the tier is padding)
    meta: list          # per-row bookkeeping (unpadded lengths)
    buffers: tuple      # staging buffers to recycle on fetch
    layout: str = ""
    event: object = None  # torch.cuda.Event recorded after the copies out
    t_assembled: float = 0.0
    t_got: float = 0.0


@dataclasses.dataclass
class CompileRecord:
    """One grid-cell warm-up: what it was, what it cost, whether it landed.
    ``size_bytes`` is None: eager cells have no executable to measure."""

    key: str
    seconds: float
    size_bytes: int | None = None
    ok: bool = True
    error: str | None = None


class _AotEngine:
    """Shared plumbing: the warm-up grid, the tier ladder, the staging-buffer
    pool and per-dispatch metrics (``self.metrics`` is wired by
    :class:`serve.server.Client`; it stays ``None`` for bare engines), and
    the serving group of a ``mesh`` (:mod:`.group`): cells run through
    :meth:`_issue`, a follower serves in :meth:`follow`, :meth:`close`
    stops the followers.

    Every grid-cell warm-up routes through :meth:`_compile_cell`, which
    times it into a :class:`CompileRecord`; :meth:`grid_status` aggregates
    them into the ``GET /compilez`` digest and the warm fraction the
    readiness probe reads.
    """

    _RACETRACE_ATTRS = ("_buf_pool", "_compile_records", "_cells_planned")

    def __init__(self, device, max_batch: int, batch_tiers=None, memory=None, mesh=None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        from distributed_tensorflow_tpu_torch.parallel.mesh import layout_label

        self.device = resolve_device(device)
        self.mesh = mesh
        self.layout = "single" if mesh is None else layout_label(mesh)
        self.group = None
        if mesh is not None and mesh.size > 1:
            from distributed_tensorflow_tpu_torch.serve.group import ServingGroup

            self.group = ServingGroup(mesh)
        self.max_batch = max_batch
        self.batch_tiers = _normalize_tiers(batch_tiers, max_batch)
        self.metrics = None
        self.memory = memory if memory is not None else default_registry()
        self._buf_lock = threading.Lock()
        self._buf_pool: dict[tuple, list[tuple]] = {}
        self._grid_lock = threading.Lock()
        self._compile_records: list[CompileRecord] = []
        self._cells_planned = 0

    def _axis(self, name: str) -> int:
        return 1 if self.mesh is None else self.mesh.shape.get(name, 1)

    # -- the serving group ----------------------------------------------

    def _issue(self, op: str, *operands):
        """Run cell ``_cell_<op>(*operands)``: through the group's channel
        on the leader of a started group, directly otherwise."""
        fn = getattr(self, f"_cell_{op}")
        if self.group is None:
            return fn(*operands)
        return self.group.issue(op, operands, fn)

    def _start_group(self) -> None:
        if self.group is not None:
            self.group.start()

    def follow(self) -> int:
        """A follower's serving loop: run the leader's cells until its stop;
        returns 0."""
        if self.group is None:
            raise RuntimeError("a one-process engine has no leader to follow")
        return self.group.follow(lambda op, operands: getattr(self, f"_cell_{op}")(*operands))

    def close(self) -> None:
        """Stop the followers (the leader's ``Client.close()`` calls this)."""
        if self.group is not None:
            self.group.stop()

    def _to_device(self, *host):
        """Host operands (tensors, pinned on the leader, or arrays) on the
        device, copied without blocking."""
        return [torch.as_tensor(h).to(self.device, non_blocking=True) for h in host]

    def _data_rows(self, tier: int) -> slice | None:
        """This rank's rows of a ``tier``-row batch: a contiguous split over
        the data axes when the tier divides them, None (every rank runs
        every row) when it does not or there are none."""
        if self.mesh is None:
            return None
        from distributed_tensorflow_tpu_torch.parallel.mesh import coordinate, data_axes

        axes = data_axes(self.mesh)
        dp = math.prod(self.mesh.shape[a] for a in axes)
        if dp <= 1 or tier % dp:
            return None
        n = tier // dp
        c = coordinate(self.mesh, axes)
        return slice(c * n, (c + 1) * n)

    def _gather_rows(self, out: dict) -> dict:
        """Every output's rows of all data ranks, in order (each rank's
        slice from :meth:`_data_rows`), on every rank."""
        from distributed_tensorflow_tpu_torch.parallel import collectives as coll
        from distributed_tensorflow_tpu_torch.parallel.mesh import axis_group, data_axes

        axes = data_axes(self.mesh)
        dp = math.prod(self.mesh.shape[a] for a in axes)
        group = axis_group(self.mesh, axes)
        return {k: coll._gather(v.contiguous(), group, dp, 0) for k, v in out.items()}

    # -- warm-up grid observability --------------------------------------

    def _plan_cells(self, n: int) -> None:
        with self._grid_lock:
            self._cells_planned += int(n)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _compile_cell(self, key: str, build):
        """Run one grid-cell warm-up (``build`` runs the forward at the
        cell's shape), recording wall time and failure. A failed warm-up
        records then re-raises."""
        t0 = time.monotonic()
        try:
            out = build()
            self._sync()
        except Exception as e:
            with self._grid_lock:
                self._compile_records.append(CompileRecord(
                    key=key, seconds=time.monotonic() - t0, ok=False,
                    error=f"{type(e).__name__}: {e}",
                ))
            raise
        with self._grid_lock:
            self._compile_records.append(
                CompileRecord(key=key, seconds=time.monotonic() - t0)
            )
        return out

    def grid_status(self) -> dict:
        """The ``GET /compilez`` digest: cell counts, cumulative warm-up
        seconds, warm fraction, the coldest cell, per-cell records."""
        with self._grid_lock:
            records = list(self._compile_records)
            planned = self._cells_planned
        compiled = sum(1 for r in records if r.ok)
        failed = len(records) - compiled
        total = max(planned, len(records))
        ok_records = [r for r in records if r.ok]
        coldest = max(ok_records, key=lambda r: r.seconds, default=None)
        return {
            "cells_total": total,
            "cells_compiled": compiled,
            "cells_failed": failed,
            "compile_seconds_total": sum(r.seconds for r in records),
            "warm_fraction": (compiled / total) if total else 1.0,
            "coldest_cell": (
                {"key": coldest.key, "seconds": coldest.seconds}
                if coldest is not None else None
            ),
            "cells": [dataclasses.asdict(r) for r in records],
        }

    def tier_for(self, n: int) -> int:
        """Smallest batch tier holding ``n`` rows."""
        for t in self.batch_tiers:
            if n <= t:
                return t
        raise ValueError(f"batch of {n} exceeds max_batch {self.max_batch}")

    def _host_empty(self, shape, dtype) -> torch.Tensor:
        """A host staging tensor: pinned when the engine serves from a card,
        so device copies can run asynchronously."""
        return torch.empty(shape, dtype=dtype, pin_memory=self.device.type == "cuda")

    def _take_buffers(self, key: tuple, make) -> tuple:
        """Pop a staging-buffer set for ``key`` or allocate a fresh one.
        Buffers return to the pool in ``fetch``, after the batch's event
        proves the device is done with them."""
        with self._buf_lock:
            pool = self._buf_pool.get(key)
            if pool:
                return pool.pop()
        buffers = make()
        self.memory.add("staging_buffers", tree_nbytes(buffers))
        return buffers

    def _give_buffers(self, key: tuple, buffers: tuple) -> None:
        with self._buf_lock:
            self._buf_pool.setdefault(key, []).append(buffers)

    def mesh_info(self) -> dict:
        """Topology digest (``GET /statusz``): the layout this engine serves,
        the axis sizes behind it, and the ranks one batch spans."""
        return {
            "layout": self.layout,
            "mesh_shape": {"data": 1} if self.mesh is None else dict(self.mesh.shape),
            "devices_per_engine": 1 if self.mesh is None else self.mesh.size,
            "platform": "gpu" if self.device.type == "cuda" else "cpu",
        }

    def _record_dispatch(self, tier: int, bucket, n: int) -> None:
        m = self.metrics
        if m is None:
            return
        m.tier_hits.inc(tier)
        m.layout_tier_hits.inc(f"{self.layout}/{tier}")
        if bucket is not None:
            m.bucket_hits.inc(bucket)
            m.layout_bucket_hits.inc(f"{self.layout}/{bucket}")
        m.tier_occupancy.observe(tier, n)
        m.padded_rows.inc(tier - n)

    def run_batch(self, payloads: list[dict]) -> list[dict]:
        """Blocking execute: ``fetch(dispatch(payloads))``."""
        return self.fetch(self.dispatch(payloads))


def _convert_params(params: dict, weight_dtype: str, cfg) -> dict:
    """The engines' weight conversion: pack to int8 (idempotent: a tree
    that ``restore_serving_state`` packed passes through) or cast to a
    float dtype other than the model's compute dtype."""
    if is_quantized_tree(params):
        return params
    if weight_dtype == "int8":
        return quantize_params(params, cfg.num_heads)
    if torch_dtype(weight_dtype) != cfg.dtype:
        return cast_params(params, torch_dtype(weight_dtype))
    return params


def _template_device(model) -> str:
    """Where to rebuild an engine's template for its layout: on the meta
    device when the caller's template has no storage (nothing is drawn),
    else on the CPU (drawn global, this rank's slices kept)."""
    return "meta" if next(model.parameters()).is_meta else "cpu"


def serving_params(model) -> dict:
    """A served model's parameters by name, each packed kernel as its
    ``{"_q8", "_q8_scale"}`` dict (for the memory ledger)."""
    out = {}
    for name, t in model.state_dict().items():
        if name.endswith(".weight_q8"):
            base = name.removesuffix("_q8")
            out[base] = {"_q8": t, "_q8_scale": model.get_buffer(base + "_scale")}
        elif not name.endswith(".weight_scale"):
            out[name] = t
    return out


def _make_bert_forward(model, return_logits: bool):
    """The serving forward: model outputs plus per-ROW MLM statistics in
    f32 (the training loss's masking/clamp recipe without the cross-row
    reduction: serving scores examples)."""

    def forward(input_ids, attention_mask, token_type_ids, mlm_targets):
        mlm_logits, nsp_logits, pooled = model.serve_outputs(
            input_ids, attention_mask, token_type_ids
        )
        weights = (mlm_targets >= 0).to(torch.float32)
        m = mlm_logits.amax(dim=-1, keepdim=True)
        shifted = mlm_logits.float() - m.float()
        lse = torch.log(torch.exp(shifted).sum(dim=-1)) + m[..., 0].float()
        tgt_logit = torch.gather(
            mlm_logits, -1, mlm_targets.clamp_min(0).long()[..., None]
        )[..., 0].float()
        ce = (lse - tgt_logit) * weights
        out = {
            "pred_ids": mlm_logits.argmax(dim=-1).to(torch.int32),
            "nll": ce.sum(dim=-1),
            "count": weights.sum(dim=-1),
            "embedding": pooled.float(),
            "nsp_probs": torch.softmax(nsp_logits, dim=-1),
        }
        if return_logits:
            out["mlm_logits"] = mlm_logits
        return out

    return forward


class BertInferenceEngine(_AotEngine):
    """MLM scoring / masked-token prediction / sentence embedding over a
    :class:`~..models.bert.BertForPreTraining`.

    ``model`` supplies the architecture and config (its axis-free, global
    form); ``params`` is the GLOBAL state dict to serve (from
    :func:`~..ckpt.restore_serving_state`). The engine loads ``params`` into
    ``model`` and moves it to ``device`` (the card by default;
    ``device="cpu"`` must be asked for).

    With ``mesh`` (see the module docstring) the model binds the mesh's
    model axes (:meth:`_serve_config`): Megatron TP (``num_heads`` and
    ``intermediate_size`` divisible by it), replicated-dispatch expert
    parallelism (``moe_experts`` divisible by it) and the GPipe pipeline
    (the stacked ``pipeline_parallel == axis size`` model; each tier runs
    ``M = gcd(local rows, configured M)`` microbatches). int8 packs the
    global tree, then each rank keeps its slice
    (:func:`~..interop.shard_params`), so every scale is the one the
    whole kernel gives.

    Request payload (one example per request): ``input_ids [l]``,
    optional ``token_type_ids [l]`` and ``mlm_targets [l]`` (-1 =
    unscored). Response per request: ``pred_ids [l]``, ``score`` (mean
    target log-prob, or None), ``embedding [H]``, ``nsp_probs [2]``,
    ``bucket``.
    """

    def __init__(
        self,
        model,
        params: dict,
        device="cuda",
        *,
        mesh=None,
        buckets: tuple[int, ...] = (128, 256, 512),
        max_batch: int = 8,
        batch_tiers: tuple[int, ...] | None = None,
        return_logits: bool = False,
        weight_dtype: str | None = None,
        memory=None,
    ):
        super().__init__(device, max_batch, batch_tiers, memory=memory, mesh=mesh)
        tp, ep, pp = (self._axis(a) for a in ("model", "expert", "pipeline"))
        serve_cfg = self._serve_config(model.cfg, tp, ep, pp)
        if serve_cfg != model.cfg:
            # This rank's shapes; the checkpoint's slices replace every value.
            model = type(model)(serve_cfg, device=_template_device(model))
        cfg = serve_cfg
        self.weight_dtype = self._plan_quant(cfg, tp=tp, ep=ep, pp=pp,
                                             weight_dtype=weight_dtype)
        params = _convert_params(params, self.weight_dtype, cfg)
        if is_quantized_tree(params):
            self.weight_dtype = "int8"
        if tp > 1 or ep > 1 or pp > 1:
            from distributed_tensorflow_tpu_torch.interop import shard_params
            from distributed_tensorflow_tpu_torch.models.bert import bert_param_specs

            params = shard_params(params, bert_param_specs(
                params, "model" if tp > 1 else None, "expert" if ep > 1 else None,
                "pipeline" if pp > 1 else None), self.mesh)
        self.buckets = tuple(sorted({min(int(b), cfg.max_position) for b in buckets}))
        if not self.buckets:
            raise ValueError("need at least one sequence bucket")
        self.return_logits = return_logits
        load_params(model, params)
        self.model = model.to(self.device).eval()
        self.params = serving_params(self.model)
        self.memory.register_tree(
            "bert_params", self.params, dtype=self.weight_dtype,
            fp32_nbytes=fp32_equiv_nbytes(self.params),
        )
        self._forward = _make_bert_forward(self.model, return_logits)
        self._microbatches = ((cfg.pipeline_microbatches or 4 * cfg.pipeline_parallel)
                              if cfg.pipelined else 0)
        # Warm every (tier, bucket) cell NOW: startup pays the first-call
        # costs (kernel build and load, allocator growth), requests do not.
        # Every rank of a group warms the same cells in the same order.
        self._plan_cells(len(self.batch_tiers) * len(self.buckets))
        for T in self.batch_tiers:
            for L in self.buckets:
                self._compile_cell(
                    f"bert/{self.layout}/t{T}/b{L}",
                    lambda T=T, L=L: self._warm(T, L),
                )
        self._start_group()
        logger.info(
            "BERT engine ready: layout=%s device=%s buckets=%s tiers=%s (%d cells)",
            self.layout, self.device, self.buckets, self.batch_tiers,
            len(self.batch_tiers) * len(self.buckets),
        )

    @staticmethod
    def _plan_quant(cfg, *, tp: int = 1, ep: int = 1, pp: int = 1,
                    weight_dtype: str | None = None) -> str:
        """Validate the weight-quantization knob for this config and layout
        and return the concrete dtype name (``None`` resolves to the model's
        compute dtype). int8 under a pipeline axis raises (the JAX rule: the
        stacked kernels' per-channel scales would span the stages), and so
        does int8 of a stacked encoder served sequentially. A mixture of
        experts goes int8 at one process or under EP: the dense kernels
        (the router's too) pack and the ``experts_*`` stacks stay fp32."""
        del tp, ep
        w = normalize_quant_dtype(weight_dtype, "weight_dtype")
        if w == "int8" and pp > 1:
            raise ValueError(
                f"weight_dtype=int8 does not support the stacked "
                f"pipeline-parallel variant (pipeline axis of {pp}): "
                "per-channel scales would span pipeline stages"
            )
        if w == "int8" and getattr(cfg, "stacked", False):
            raise ValueError("int8 weights do not serve a stacked-encoder model: the "
                             "per-channel scales of a stacked kernel would span its layers")
        return w or str(cfg.dtype).removeprefix("torch.")

    @staticmethod
    def _serve_config(cfg, tp: int, ep: int, pp: int):
        """Bind the model config to the mesh's model axes, with the JAX
        engine's checks and messages: loudly, at startup, never as a shape
        error mid-request."""
        if tp > 1:
            if cfg.num_heads % tp or cfg.intermediate_size % tp:
                raise ValueError(
                    f"model axis of {tp} must divide num_heads "
                    f"({cfg.num_heads}) and intermediate_size "
                    f"({cfg.intermediate_size})"
                )
            cfg = dataclasses.replace(cfg, model_axis="model", model_parallel=tp)
        if ep > 1:
            if not cfg.moe_experts or cfg.moe_experts % ep:
                raise ValueError(
                    f"expert axis of {ep} needs a MoE model with "
                    f"moe_experts divisible by it (got {cfg.moe_experts})"
                )
            # Replicated dispatch: every expert shard routes the full batch
            # and partial outputs psum — exact, and free of the capacity
            # all-to-all's batch-layout requirements (serving batches are
            # tiny).
            cfg = dataclasses.replace(cfg, expert_axis="expert", expert_parallel=ep,
                                      moe_dispatch="replicated")
        if pp > 1:
            if cfg.pipeline_parallel != pp:
                raise ValueError(
                    f"pipeline axis of {pp} needs the stacked "
                    f"pipeline_parallel={pp} model/checkpoint (got "
                    f"pipeline_parallel={cfg.pipeline_parallel}); pass the "
                    "training run's --pipeline-parallel to cli/serve"
                )
            cfg = dataclasses.replace(cfg, pipeline_axis="pipeline")
        return cfg

    def _warm(self, T: int, L: int):
        z = torch.zeros((T, L), dtype=torch.int32)
        mask = torch.zeros((T, L), dtype=torch.bool)
        mask[:, 0] = True
        return self._cell_dispatch(T, L, z, mask, z, z - 1)

    @torch.inference_mode()
    def _cell_dispatch(self, T: int, L: int, *host):
        """The forward of one (tier, bucket) cell on this rank's rows of the
        host batch, the outputs of every row gathered over the data ranks."""
        dev = self._to_device(*host)
        rows = self._data_rows(T)
        if rows is not None:
            dev = [d[rows] for d in dev]
        if self._microbatches:
            # GPipe needs M | rows: per tier, the largest M dividing both the
            # rank's rows and the configured M (a 1-row shard runs M = 1).
            m = math.gcd(dev[0].shape[0], self._microbatches)
            enc = self.model.bert.encoder
            if enc.cfg.pipeline_microbatches != m:
                enc.cfg = dataclasses.replace(enc.cfg, pipeline_microbatches=m)
        out = self._forward(*dev)
        return self._gather_rows(out) if rows is not None else out

    def bucket_for(self, length: int) -> int:
        for b in self.buckets:
            if length <= b:
                return b
        raise RequestError(
            f"sequence length {length} exceeds the largest bucket "
            f"{self.buckets[-1]}"
        )

    def validate(self, payload: dict) -> None:
        """Reject un-servable payloads BEFORE they enqueue."""
        ids = np.asarray(payload.get("input_ids", ()))
        if ids.ndim != 1 or ids.size == 0:
            raise RequestError("input_ids must be a non-empty 1-D id list")
        self.bucket_for(ids.shape[0])
        for k in ("token_type_ids", "mlm_targets"):
            if k in payload and np.asarray(payload[k]).shape != ids.shape:
                raise RequestError(f"{k} shape must match input_ids")

    def request_bucket(self, payload: dict) -> int:
        """Queue key for bucket-aware batching."""
        return self.bucket_for(np.asarray(payload["input_ids"]).shape[0])

    def _make_buffers(self, T: int, L: int) -> tuple:
        H = self.model.cfg.hidden_size
        host = self._host_empty
        outs = [
            host((T, L), torch.int32),      # pred_ids
            host((T,), torch.float32),      # nll
            host((T,), torch.float32),      # count
            host((T, H), torch.float32),    # embedding
            host((T, 2), torch.float32),    # nsp_probs
        ]
        if self.return_logits:
            outs.append(host((T, L, self.model.cfg.vocab_size), self.model.cfg.dtype))
        ins = (
            host((T, L), torch.int32),      # input_ids
            host((T, L), torch.bool),       # attention_mask
            host((T, L), torch.int32),      # token_type_ids
            host((T, L), torch.int32),      # mlm_targets
        )
        return ins + tuple(outs)

    _OUT_KEYS = ("pred_ids", "nll", "count", "embedding", "nsp_probs", "mlm_logits")

    def dispatch(self, payloads: list[dict]) -> InFlightBatch:
        """Assemble one micro-batch and launch it without blocking.

        Every row pads to the bucket of the LONGEST member; missing rows pad
        to the smallest tier with inert rows (mask True only at position 0,
        so no row softmaxes over zero keys; their outputs are dropped).
        """
        if len(payloads) > self.max_batch:
            raise ValueError(
                f"batch of {len(payloads)} exceeds max_batch {self.max_batch}"
            )
        lens = [np.asarray(p["input_ids"]).shape[0] for p in payloads]
        L = self.bucket_for(max(lens))
        T = self.tier_for(len(payloads))
        key = (T, L)
        buffers = self._take_buffers(key, lambda: self._make_buffers(T, L))
        ids, mask, types, targets = (b.numpy() for b in buffers[:4])
        ids.fill(0)
        mask.fill(False)
        types.fill(0)
        targets.fill(-1)
        for r, (p, l) in enumerate(zip(payloads, lens)):
            ids[r, :l] = np.asarray(p["input_ids"], np.int32)
            mask[r, :l] = True
            if "token_type_ids" in p:
                types[r, :l] = np.asarray(p["token_type_ids"], np.int32)
            if "mlm_targets" in p:
                targets[r, :l] = np.asarray(p["mlm_targets"], np.int32)
        mask[len(payloads):, 0] = True
        t_assembled = time.monotonic()
        out = self._issue("dispatch", T, L, *buffers[:4])
        with torch.inference_mode():
            host_out = dict(zip(self._OUT_KEYS, buffers[4:]))
            for k, h in host_out.items():
                h.copy_(out[k], non_blocking=True)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        self._record_dispatch(T, L, len(payloads))
        return InFlightBatch(
            out=host_out, key=key, n=len(payloads), meta=lens, buffers=buffers,
            layout=self.layout, event=event, t_assembled=t_assembled,
        )

    def fetch(self, inflight: InFlightBatch) -> list[dict]:
        """Wait for the batch (the one synchronisation point) and slice out
        per-row results as fresh numpy arrays."""
        if inflight.event is not None:
            inflight.event.synchronize()
        inflight.t_got = time.monotonic()
        out = {k: v.numpy() if v.dtype != torch.bfloat16 else v.float().numpy()
               for k, v in inflight.out.items()}
        L = inflight.key[1]
        results = []
        for r, l in enumerate(inflight.meta):
            count = float(out["count"][r])
            res = {
                "pred_ids": out["pred_ids"][r, :l].copy(),
                "score": (-float(out["nll"][r]) / count) if count else None,
                "embedding": out["embedding"][r].copy(),
                "nsp_probs": out["nsp_probs"][r].copy(),
                "bucket": L,
            }
            if self.return_logits:
                res["mlm_logits"] = out["mlm_logits"][r, :l].copy()
            results.append(res)
        self._give_buffers(inflight.key, inflight.buffers)
        return results


# ------------------------------------------------------------ causal LM
#
# The cell builders below are the JAX package's executable bodies. Each
# returns a function that updates the engine's device state IN PLACE (the
# slot caches, the last-token vector, the prefix pool) and returns what the
# host fetches: the in-place update stands in for JAX's buffer donation.
# Every cache, pool and last-token buffer carries one spare entry past its
# end (position ``cache_len``, block ``n_blocks``, slot ``slots``): the
# writes the JAX bodies drop with ``mode="drop"`` land there instead, so no
# index is out of range on the card and nothing waits on the host.


def _kv_leaf(cache):
    """The payload leaf of a KV operand: ``"q"`` of an int8 ``{"q", "s"}``
    dict, or the dense tensor. Geometry is read off this leaf."""
    return cache["q"] if isinstance(cache, dict) else cache


def _kv_map(fn, *caches):
    """``fn`` over a KV operand's leaves (``q`` and ``s`` together for an
    int8 cache, so pages move with their scales bit-exactly)."""
    if isinstance(caches[0], dict):
        return {k: fn(*(c[k] for c in caches)) for k in ("q", "s")}
    return fn(*caches)


def _kv_put(cache, index, fresh) -> None:
    """``cache[index] = fresh`` over every leaf; ``fresh`` is dense K/V,
    quantized at the write for an int8 cache (``index`` picks leading axes
    only, so the scale plane takes the same index)."""
    if isinstance(cache, dict):
        q, s = quantize_kv(fresh)
        cache["q"][index] = q
        cache["s"][index] = s
    else:
        cache[index] = fresh.to(cache.dtype)


def _make_causal_prefill(model, cache_len: int):
    """Prefill body for one (tier, bucket): the full causal forward, its K/V
    written into the admitted rows' slot pages, each row's FIRST token
    sampled on the device. Padding rows carry slot index ``S`` (one past
    the pool): their pages go to slot 0's spare position and their token to
    the last-token vector's spare entry. int8 caches quantize the fresh K/V
    at the write, as the incremental decode write does."""

    def prefill_fn(ck, cv, last, ids, mask, slots, lengths, temps, seeds):
        from distributed_tensorflow_tpu_torch.models.causal_lm import sample_tokens

        logits, k, v = model.prefill(ids, mask)
        T, L = ids.shape
        rows = torch.arange(T, device=ids.device)
        tok = sample_tokens(logits[rows, lengths.clamp_min(1) - 1], temps, seeds, lengths)
        real = slots < last.shape[0] - 1
        wslot = torch.where(real, slots, 0)[:, None]
        wpos = torch.where(real[:, None], torch.arange(L, device=ids.device)[None], cache_len)
        _kv_put(ck, (slice(None), wslot, wpos), k)
        _kv_put(cv, (slice(None), wslot, wpos), v)
        last[slots] = tok
        return tok

    return prefill_fn


def _make_causal_decode(model, cache_len: int):
    """Decode-step body (one shape: the full slot table): write each slot's
    pending token at its position, attend the cache prefix, sample the next
    token. ``last`` advances only where ``active``; idle lanes carry
    position ``cache_len``, so their K/V goes to the spare position (a
    mid-chunk-prefill slot rides decode steps inactive, and a stray write
    would corrupt pages its earlier chunks filled)."""

    def decode_fn(ck, cv, last, lengths, active, temps, seeds):
        from distributed_tensorflow_tpu_torch.models.causal_lm import sample_tokens

        pos = torch.where(active, lengths.clamp_max(cache_len - 1), cache_len)
        logits, _, _ = model.decode_step(last, pos, ck, cv)
        tok = sample_tokens(logits, temps, seeds, lengths + 1)
        last.copy_(torch.where(active, tok, last))
        return tok

    return decode_fn


def _make_causal_verify(model, cache_len: int, k: int):
    """Speculative-verify body (the full slot table, ``k + 1`` columns):
    score each verifying slot's last token plus up to ``k`` drafts in one
    forward, sample every column with the (seed, absolute position) key
    the successive decode steps would use, and advance ``last`` to the
    accepted prefix's next token on the device. Column ``j`` sits at
    ``lengths + j``; columns past ``n_input`` (all of a non-verifying slot)
    carry ``cache_len``. Draft ``j`` survives iff it equals the sampled
    token of column ``j - 1`` and every earlier draft survived."""

    def verify_fn(ck, cv, last, drafts, lengths, n_input, temps, seeds):
        from distributed_tensorflow_tpu_torch.models.causal_lm import sample_tokens

        S = drafts.shape[0]
        tokens = torch.cat([last[:, None], drafts], dim=1)  # [S, k+1]
        cols = torch.arange(k + 1, device=drafts.device)[None, :]
        pos = lengths[:, None] + cols
        wpos = torch.where(cols < n_input[:, None], pos, cache_len).clamp_max(cache_len)
        logits, _, _ = model.verify_step(tokens, wpos, ck, cv)
        # Column j's key is position lengths + j + 1: the key of the
        # (j+1)-th plain decode step after this point.
        tok = sample_tokens(
            logits.reshape(S * (k + 1), -1), temps.repeat_interleave(k + 1),
            seeds.repeat_interleave(k + 1), (pos + 1).reshape(-1),
        ).view(S, k + 1)
        dcols = torch.arange(k, device=drafts.device)[None, :]
        matches = (tok[:, :-1] == drafts) & (dcols < n_input[:, None] - 1)
        m = torch.cumprod(matches.to(torch.int32), dim=1).sum(dim=1)
        new_last = tok[torch.arange(S, device=drafts.device), m]
        last.copy_(torch.where(n_input > 0, new_last, last))
        return tok

    return verify_fn


def _make_causal_chunk_prefill(model, cache_len: int):
    """Chunk-prefill body for one (tier, chunk bucket): a page-gather
    prologue, one absolute-position prompt chunk, and the first token
    sampled where the chunk completes its row's prompt.

    The prologue copies each row's matched prefix chain (pool block ids in
    ``chain``, the first ``n_gather`` real) into the row's slot pages; rows
    past their first chunk pass ``n_gather == 0``. Pool pages are only read
    here. Lane ``c`` of row ``t`` holds position ``starts[t] + c`` when it
    is below ``lengths[t]``, else ``cache_len`` (the spare position), so
    padding lanes and padding rows (slot ``S``, length 0) write nothing
    real. ``is_last`` rows sample at the prompt's final lane, keyed on the
    absolute position exactly like the monolithic prefill."""

    def chunk_fn(ck, cv, last, pool_k, pool_v, ids, starts, lengths, chain, n_gather,
                 slots, temps, seeds):
        from distributed_tensorflow_tpu_torch.models.causal_lm import sample_tokens

        dev = ids.device
        T, C = ids.shape
        nl = _kv_leaf(ck).shape[0]
        real = slots < last.shape[0] - 1
        rows = torch.where(real, slots, 0)
        bt = _kv_leaf(pool_k).shape[2]
        span = chain.shape[1] * bt
        lane = torch.arange(span, device=dev)[None, :]
        gpos = torch.where(lane < (n_gather * bt)[:, None], lane, cache_len).clamp_max(cache_len)
        index = (slice(None), rows[:, None], gpos)
        for cache, pool in ((ck, pool_k), (cv, pool_v)):
            def blend(c, p):
                c[index] = p[:, chain].reshape(nl, T, span, *p.shape[3:])
            _kv_map(blend, cache, pool)
        pos = starts[:, None] + torch.arange(C, device=dev)[None, :]
        wpos = torch.where(pos < lengths[:, None], pos, cache_len).clamp_max(cache_len)
        logits, _, _ = model.prefill_chunk(ids, wpos, ck, cv, rows=rows)
        is_last = starts + C >= lengths
        li = (lengths - 1 - starts).clamp(0, C - 1)
        tok = sample_tokens(logits[torch.arange(T, device=dev), li], temps, seeds, lengths)
        last[slots] = torch.where(is_last, tok, last[rows])
        return tok

    return chunk_fn


def _make_prefix_insert(block_tokens: int):
    """Publish-to-pool body: copy a finished slot's prefix pages into newly
    allocated pool blocks (``block_ids`` padded with the pool's spare block
    id ``n_blocks``; ``block_pos`` the chain index each takes)."""

    def insert_fn(pool_k, pool_v, ck, cv, slot, block_ids, block_pos):
        nl, _, lc1 = _kv_leaf(ck).shape[:3]
        nb = (lc1 - 1) // block_tokens
        bp = block_pos.clamp_max(nb - 1)

        def publish(p, c):
            # Both ranks: c.shape[3:] is (h, d) for pages, () for scales.
            src = c[:, slot, : nb * block_tokens].reshape(nl, nb, block_tokens, *c.shape[3:])
            p[:, block_ids] = src[:, bp]

        _kv_map(publish, pool_k, ck)
        _kv_map(publish, pool_v, cv)

    return insert_fn


def _make_pool_export():
    """Gather-for-transfer body: a pinned chain's pool pages as a fixed
    ``[nl, max_chain, block_tokens, heads, head_dim]`` stage (pad lanes
    repeat block 0). Copies; the pool stays as it is."""

    def export_fn(pool_k, pool_v, block_ids):
        return (_kv_map(lambda a: a[:, block_ids], pool_k),
                _kv_map(lambda a: a[:, block_ids], pool_v))

    return export_fn


def _make_pool_import():
    """Adopt-transferred-pages body: write a ``[nl, max_chain, ...]`` stage
    into the pool at ``block_ids`` (pad lanes carry the spare block id)."""

    def import_fn(pool_k, pool_v, pages_k, pages_v, block_ids):
        def put(p, g):
            p[:, block_ids] = g
        _kv_map(put, pool_k, pages_k)
        _kv_map(put, pool_v, pages_v)

    return import_fn


def _make_slot_export():
    """Live-stream checkpoint body: ONE slot's lane of the slot cache as a
    ``[nl, cache_len, heads, head_dim]`` stage (spare position stripped).
    Copies; the cache stays live."""

    def export_fn(ck, cv, slot):
        def take(a):
            return a[:, slot, : a.shape[2] - 1].clone()
        return _kv_map(take, ck), _kv_map(take, cv)

    return export_fn


def _make_slot_import():
    """Resume-a-migrated-stream body: write a ``[nl, cache_len, ...]`` stage
    into ONE slot's lane and seed ``last_token[slot]``, so the next decode
    step continues the generation."""

    def import_fn(ck, cv, last, stage_k, stage_v, slot, tok):
        def put(a, st):
            a[:, slot, : a.shape[2] - 1] = st
        _kv_map(put, ck, stage_k)
        _kv_map(put, cv, stage_v)
        last[slot] = tok

    return import_fn


class CausalLMEngine(_AotEngine):
    """Autoregressive generation over a :class:`~..models.causal_lm.CausalLM`
    checkpoint with a slot-addressed KV cache on the device.

    The cache is a FIXED table of per-slot pages, ``k/v: [num_layers,
    slots, cache_len + 1, heads, head_dim]`` (one spare position, see
    :mod:`..models.causal_lm`), plus ``last_token [slots]``, on the device
    for the engine's lifetime; every cell updates them in place, so slot
    assignment and reuse never change a shape. The warmed grid:

    - ``prefill`` per (batch tier x prompt bucket): the full causal forward,
      its K/V written into the admitted rows' pages, each row's first
      token sampled on the device;
    - ``decode``, one cell at the full slot table: each slot's pending
      token in, the next one sampled; idle slots ride along masked;
    - ``verify`` (``spec_tokens > 0``), one cell at ``[slots, k + 1]``.

    ``last_token`` stays on the device, so step k+1 is dispatched against
    step k's un-fetched output; :meth:`fetch_step` is the one
    synchronisation point. Sampling is greedy at ``temperature == 0`` and
    seeded-categorical otherwise, keyed on (seed, absolute position) only,
    so a request's stream does not depend on its batchmates.

    **Chunked mode** (``prefix_cache_mb > 0`` or ``prefill_chunk > 0``)
    replaces the prefill grid by a chunk grid (tier x chunk bucket): a
    page-gather prologue plus one absolute-position chunk
    (:func:`_make_causal_chunk_prefill`). With a prefix-cache budget the
    engine also owns a pool of KV pages ``[nl, n_blocks + 1, block_tokens,
    heads, head_dim]``, the ``insert`` cell that publishes a finished
    slot's prefix into it, and the host trie that hands out block ids
    (``self.prefix_cache``, a :class:`~.kvpool.KVBlockPool` over blocks
    ``0..n_blocks-1``; the continuous batcher matches and inserts through
    it). ``kv_transfer`` adds the pool export/import cells and
    ``stream_migrate`` the slot export/import cells.

    ``spec_tokens > 0`` also sets ``self.spec``, the
    :class:`~.spec.SpecConfig` the batcher drafts against (``spec_backoff``
    is its acceptance-EMA threshold).

    ``weight_dtype="int8"`` packs kernels (idempotent: a tree
    ``restore_serving_state`` packed passes through); ``kv_dtype="int8"``
    stores cache and pool pages as ``{"q", "s"}``. ``device`` defaults to
    the card; ``device="cpu"`` must be asked for.

    With ``mesh`` (tensor parallelism only, as the JAX engine; see the
    module docstring) each rank holds ``num_heads / tp`` heads of every
    cache, pool page and page stage (an int8 cache's scale planes, one a
    position, have no head axis and are each rank's own); every other
    operand is replicated over the group. The logits after the model
    axis's sum are the same on every rank, so each rank samples the same
    tokens and the leader's fetch is the answer. Page exports gather the
    heads onto the leader and imports take the whole heads, so a stage's
    geometry does not depend on the layout; ``kv_bytes_per_token`` stays
    global.
    """

    def __init__(
        self,
        model,
        params: dict,
        device="cuda",
        *,
        buckets: tuple[int, ...] = (64, 128, 256),
        slots: int = 8,
        max_batch: int = 4,
        batch_tiers: tuple[int, ...] | None = None,
        max_new_tokens: int = 32,
        prefix_cache_mb: float = 0.0,
        block_tokens: int = 16,
        prefill_chunk: int = 0,
        spec_tokens: int = 0,
        spec_min_match: int = 2,
        spec_backoff: float = 0.25,
        kv_transfer: bool = False,
        stream_migrate: bool = False,
        weight_dtype: str | None = None,
        kv_dtype: str | None = None,
        memory=None,
        mesh=None,
    ):
        if slots < 1:
            raise ValueError(f"need at least one cache slot, got {slots}")
        super().__init__(device, min(max_batch, slots), batch_tiers, memory=memory, mesh=mesh)
        tp = self._tp = self._axis("model")
        serve_cfg = self._serve_config(model.cfg, tp, self._axis("expert"),
                                       self._axis("pipeline"))
        if serve_cfg != model.cfg:
            model = type(model)(serve_cfg, device=_template_device(model))
        cfg = serve_cfg
        self.weight_dtype, self.kv_dtype = self._plan_quant(
            cfg, tp=tp, weight_dtype=weight_dtype, kv_dtype=kv_dtype)
        params = _convert_params(params, self.weight_dtype, cfg)
        if is_quantized_tree(params):
            self.weight_dtype = "int8"
        if tp > 1:
            from distributed_tensorflow_tpu_torch.interop import shard_params
            from distributed_tensorflow_tpu_torch.models.causal_lm import causal_param_specs

            params = shard_params(params, causal_param_specs(params), self.mesh)
        self._kv_quantized = self.kv_dtype == "int8"
        self._kv_store_dtype = cfg.dtype if self._kv_quantized else torch_dtype(self.kv_dtype)
        load_params(model, params)
        self.model = model.to(self.device).eval()
        self.params = serving_params(self.model)
        self.slots = slots
        self.buckets = tuple(sorted({min(int(b), cfg.max_position) for b in buckets}))
        if not self.buckets:
            raise ValueError("need at least one prompt bucket")
        # Every slot's pages hold prompt + generated tokens; validate()
        # rejects requests that could not fit before they enqueue.
        self.cache_len = min(self.buckets[-1] + max_new_tokens, cfg.max_position)
        self.max_new_tokens = max_new_tokens
        self.spec_tokens = self._plan_spec(cfg, tp=tp, spec_tokens=spec_tokens,
                                           min_match=spec_min_match,
                                           max_new_tokens=max_new_tokens)
        # The continuous batcher drafts against this config (serve/spec.py)
        # when the engine also has a verify cell.
        self.spec = (
            SpecConfig(spec_tokens=self.spec_tokens, min_match=spec_min_match,
                       backoff_threshold=spec_backoff)
            if self.spec_tokens > 0 else None
        )

        heads, hd = cfg.num_heads // tp, cfg.hidden_size // cfg.num_heads
        cache_shape = (cfg.num_layers, slots, self.cache_len + 1, heads, hd)
        self._cache_k = self._kv_zeros(cache_shape)
        self._cache_v = self._kv_zeros(cache_shape)
        # last_token plus a spare entry for padding rows' writes.
        self._last_buf = torch.zeros(slots + 1, dtype=torch.int32, device=self.device)
        self._last_token = self._last_buf[:slots]
        self.memory.register_tree(
            "lm_params", self.params, dtype=self.weight_dtype,
            fp32_nbytes=fp32_equiv_nbytes(self.params),
        )
        kv_bytes = tree_nbytes(self._cache_k) + tree_nbytes(self._cache_v)
        logical = cfg.num_layers * slots * self.cache_len * heads * hd
        self.memory.register("kv_slot_cache", kv_bytes, dtype=self.kv_dtype,
                             fp32_nbytes=2 * logical * 4)
        # Per-slot share of the slot-table cache: the batcher multiplies it
        # by slots_active so /statusz and /memz agree on active bytes.
        self.slot_page_bytes = kv_bytes // slots

        self.block_tokens = int(block_tokens)
        self._chunked_mode = prefix_cache_mb > 0 or prefill_chunk > 0
        # The host trie over the pool's pages (serve/kvpool.py): blocks
        # 0..n_blocks-1 only; the pool's spare row n_blocks is never handed
        # out.
        self.prefix_cache = None
        self._pool_k = self._pool_v = None
        self._pool_blocks = 0
        if self._chunked_mode:
            chunk = int(prefill_chunk) if prefill_chunk > 0 else self.buckets[-1]
            self.prefill_chunk_size = min(chunk, self.buckets[-1])
            self._chunk_buckets = tuple(sorted(
                {b for b in self.buckets if b <= self.prefill_chunk_size}
                | {self.prefill_chunk_size}))
            self._max_chain = max(1, self.buckets[-1] // self.block_tokens)
            n_blocks, self._bytes_per_block = self._plan_prefix_cache(
                cfg, tp=tp, prefix_cache_mb=prefix_cache_mb, block_tokens=self.block_tokens,
                kv_dtype=self.kv_dtype)
            if prefix_cache_mb > 0:
                self.prefix_cache = KVBlockPool(n_blocks, self.block_tokens,
                                                self._bytes_per_block, dtype=self.kv_dtype)
            else:
                n_blocks = 1  # a dummy pool keeps one chunk operand layout
            self._pool_blocks = n_blocks
            pool_shape = (cfg.num_layers, n_blocks + 1, self.block_tokens, heads, hd)
            self._pool_k = self._kv_zeros(pool_shape)
            self._pool_v = self._kv_zeros(pool_shape)
            self.memory.register(
                "kv_prefix_pool", tree_nbytes(self._pool_k) + tree_nbytes(self._pool_v),
                dtype=self.kv_dtype,
                fp32_nbytes=2 * cfg.num_layers * n_blocks * self.block_tokens * heads * hd * 4)
        else:
            self.prefill_chunk_size = 0
        self._has_pool = self._chunked_mode and prefix_cache_mb > 0
        self._kv_transfer = bool(kv_transfer) and self._has_pool
        self.stream_migrate = bool(stream_migrate)

        L = self.cache_len
        self._prefill_cells = {}
        self._chunk_cells = {}
        n_cells = (len(self.batch_tiers) * (len(self._chunk_buckets) if self._chunked_mode
                                            else len(self.buckets))
                   + 1 + (1 if self.spec_tokens else 0) + (1 if self._has_pool else 0)
                   + (2 if self._kv_transfer else 0) + (2 if self.stream_migrate else 0))
        self._plan_cells(n_cells)
        if not self._chunked_mode:
            fn = _make_causal_prefill(self.model, L)
            for T in self.batch_tiers:
                for B in self.buckets:
                    self._prefill_cells[T, B] = fn
                    self._compile_cell(f"lm/{self.layout}/prefill/t{T}/b{B}",
                                       lambda T=T, B=B: self._warm_prefill(T, B))
        else:
            fn = _make_causal_chunk_prefill(self.model, L)
            for T in self.batch_tiers:
                for C in self._chunk_buckets:
                    self._chunk_cells[T, C] = fn
                    self._compile_cell(f"lm/{self.layout}/chunk/t{T}/c{C}",
                                       lambda T=T, C=C: self._warm_chunk(T, C))
            if self._has_pool:
                self._insert_cell = _make_prefix_insert(self.block_tokens)
                self._compile_cell(f"lm/{self.layout}/insert",
                                   lambda: self.insert_prefix(0, []))
            if self._kv_transfer:
                self._export_cell = _make_pool_export()
                self._import_cell = _make_pool_import()
                self._compile_cell(f"lm/{self.layout}/export",
                                   lambda: self.export_prefix_pages([]))
                self._compile_cell(f"lm/{self.layout}/import",
                                   lambda: self._warm_import())
        self._decode_cell = _make_causal_decode(self.model, L)
        self._compile_cell(f"lm/{self.layout}/decode", lambda: self._warm_decode())
        self._verify_cell = None
        if self.spec_tokens:
            self._verify_cell = _make_causal_verify(self.model, L, self.spec_tokens)
            self._compile_cell(f"lm/{self.layout}/verify", lambda: self._warm_verify())
        self._slot_export_cell = self._slot_import_cell = None
        if self.stream_migrate:
            self._slot_export_cell = _make_slot_export()
            self._slot_import_cell = _make_slot_import()
            self._compile_cell(f"lm/{self.layout}/slot_export",
                               lambda: self.export_slot_pages(0))
            # Slot 0's own lane back into it: the state is unchanged.
            self._compile_cell(f"lm/{self.layout}/slot_import",
                               lambda: self.import_slot_pages(
                                   0, *self.export_slot_pages(0),
                                   last_token=int(self._last_token[0])))
        self._start_group()
        logger.info(
            "causal-LM engine ready: layout=%s device=%s slots=%d cache_len=%d buckets=%s "
            "tiers=%s chunk=%s pool_blocks=%s spec_k=%s (%d cells)",
            self.layout, self.device, slots, self.cache_len, self.buckets, self.batch_tiers,
            self.prefill_chunk_size or None, self._pool_blocks if self._has_pool else None,
            self.spec_tokens or None, n_cells,
        )

    # -- planning (the JAX engine's static validators) -------------------

    @staticmethod
    def _serve_config(cfg, tp: int = 1, ep: int = 1, pp: int = 1):
        """Bind the decode model to the mesh's model axes, TP only (the JAX
        engine's checks and messages): the slot cache has no expert routing
        and a pipelined decode step would bubble most of every token."""
        if ep > 1:
            raise ValueError(
                f"expert axis of {ep}: the decode engine does not support "
                "expert parallelism (no MoE decoder variant)"
            )
        if pp > 1:
            raise ValueError(
                f"pipeline axis of {pp}: the decode engine does not support "
                "pipeline parallelism (a one-token step cannot fill a "
                "GPipe schedule)"
            )
        if tp > 1:
            if cfg.num_heads % tp or cfg.intermediate_size % tp:
                raise ValueError(
                    f"model axis of {tp} must divide num_heads "
                    f"({cfg.num_heads}) and intermediate_size "
                    f"({cfg.intermediate_size})"
                )
            cfg = dataclasses.replace(cfg, model_axis="model", model_parallel=tp)
        return cfg

    @staticmethod
    def _plan_prefix_cache(cfg, *, tp: int = 1, prefix_cache_mb: float = 0.0,
                           block_tokens: int = 16,
                           kv_dtype: str | None = None) -> tuple[int, int]:
        """Size and validate the prefix-page pool: ``(n_blocks,
        bytes_per_block)``; a budget below one block, or a TP width that
        cannot split the pages' head axis, raises at startup."""
        if block_tokens < 1:
            raise ValueError(f"block_tokens must be >= 1, got {block_tokens}")
        if tp > 1 and cfg.num_heads % tp:
            raise ValueError(
                f"model axis of {tp} must divide num_heads "
                f"({cfg.num_heads}) to shard prefix-cache pages"
            )
        kv = (normalize_quant_dtype(kv_dtype, "kv_dtype")
              or str(cfg.dtype).removeprefix("torch."))
        if kv == "int8":
            # int8 page payload + two f32 per-position scales (k and v).
            bytes_per_block = 2 * cfg.num_layers * block_tokens * (cfg.hidden_size + 4)
        else:
            bytes_per_block = (2 * cfg.num_layers * block_tokens * cfg.hidden_size
                               * torch_dtype(kv).itemsize)
        n_blocks = int(prefix_cache_mb * 2**20 // bytes_per_block)
        if prefix_cache_mb > 0 and n_blocks < 1:
            raise ValueError(
                f"--prefix-cache-mb {prefix_cache_mb:g} holds no {bytes_per_block}-byte "
                f"block (num_layers={cfg.num_layers}, block_tokens={block_tokens}, "
                f"hidden={cfg.hidden_size})")
        return n_blocks, bytes_per_block

    @staticmethod
    def _plan_spec(cfg, *, tp: int = 1, spec_tokens: int = 0, min_match: int = 2,
                   max_new_tokens: int = 32) -> int:
        """Validate the speculation knobs; returns the verify width ``k``
        (0 = off). ``tp`` adds no constraint (the verify cell shards as
        decode does)."""
        del tp
        if spec_tokens < 0:
            raise ValueError(f"spec_tokens must be >= 0, got {spec_tokens}")
        if spec_tokens == 0:
            return 0
        if min_match < 1:
            raise ValueError(f"spec min_match must be >= 1, got {min_match}")
        if spec_tokens >= max_new_tokens:
            raise ValueError(
                f"spec_tokens {spec_tokens} >= max_new_tokens {max_new_tokens}: a "
                "draft can never exceed the remaining generation budget")
        if spec_tokens + 1 > cfg.max_position:
            raise ValueError(
                f"spec_tokens {spec_tokens} + 1 exceeds max_position {cfg.max_position}")
        return int(spec_tokens)

    @staticmethod
    def _plan_quant(cfg, *, tp: int = 1, weight_dtype: str | None = None,
                    kv_dtype: str | None = None) -> tuple[str, str]:
        """Validate the quantization knobs; returns concrete ``(weight_dtype,
        kv_dtype)`` names (``None`` resolves to the model's compute dtype).
        ``tp`` adds no constraint: packed kernels shard like the kernels
        they replace and the KV scale planes have no head axis."""
        del tp
        w = normalize_quant_dtype(weight_dtype, "weight_dtype")
        k = normalize_quant_dtype(kv_dtype, "kv_dtype")
        default = str(cfg.dtype).removeprefix("torch.")
        return w or default, k or default

    def _kv_zeros(self, shape):
        if not self._kv_quantized:
            return torch.zeros(shape, dtype=self._kv_store_dtype, device=self.device)
        return {"q": torch.zeros(shape, dtype=torch.int8, device=self.device),
                "s": torch.zeros(shape[:-2], dtype=torch.float32, device=self.device)}

    def kv_bytes_per_token(self) -> int:
        """Slot-cache bytes ONE cached token occupies (K + V across all
        layers, plus scales at int8)."""
        cfg = self.model.cfg
        if self._kv_quantized:
            return 2 * cfg.num_layers * (cfg.hidden_size + 4)
        return 2 * cfg.num_layers * cfg.hidden_size * self._kv_store_dtype.itemsize

    # -- request surface -----------------------------------------------

    def bucket_for(self, length: int) -> int:
        for b in self.buckets:
            if length <= b:
                return b
        raise RequestError(
            f"prompt length {length} exceeds the largest bucket {self.buckets[-1]}")

    def _chunk_bucket_for(self, n: int) -> int:
        for c in self._chunk_buckets:
            if n <= c:
                return c
        raise ValueError(f"chunk of {n} exceeds prefill_chunk_size {self.prefill_chunk_size}")

    def validate(self, payload: dict) -> None:
        ids = np.asarray(payload.get("input_ids", ()))
        if ids.ndim != 1 or ids.size == 0:
            raise RequestError("input_ids must be a non-empty 1-D id list")
        max_new = int(payload.get("max_new_tokens", self.max_new_tokens))
        if max_new < 1:
            raise RequestError("max_new_tokens must be >= 1")
        # Migration replay: resume_tokens are already-delivered tokens the
        # re-prefill treats as prompt suffix.
        res = np.asarray(payload.get("resume_tokens", ()))
        if res.size and res.ndim != 1:
            raise RequestError("resume_tokens must be a 1-D id list")
        if res.size >= max_new:
            raise RequestError(
                f"resume_tokens of {res.size} already satisfy max_new_tokens "
                f"{max_new}: nothing left to generate")
        if not self._chunked_mode:
            self.bucket_for(ids.shape[0] + res.size)
        if ids.shape[0] + max_new > self.cache_len:
            raise RequestError(
                f"prompt of {ids.shape[0]} + max_new_tokens {max_new} exceeds the "
                f"{self.cache_len}-token cache pages")
        if float(payload.get("temperature", 0.0)) < 0.0:
            raise RequestError("temperature must be >= 0")
        pri = payload.get("priority")
        if pri is not None:
            try:
                pri = int(pri)
            except (TypeError, ValueError):
                raise RequestError("priority must be an integer") from None
            if pri < 0:
                raise RequestError(f"priority must be >= 0, got {pri}")
        ddl = payload.get("deadline_ms")
        if ddl is not None:
            try:
                ddl = float(ddl)
            except (TypeError, ValueError):
                raise RequestError("deadline_ms must be a number of milliseconds") from None
            if not ddl > 0.0:
                raise RequestError(f"deadline_ms must be > 0, got {ddl}")

    def request_bucket(self, payload: dict) -> int:
        n = np.asarray(payload["input_ids"]).shape[0]
        n += np.asarray(payload.get("resume_tokens", ())).size
        if self._chunked_mode and n > self.buckets[-1]:
            return self.buckets[-1]  # queue key only: chunks split the rest
        return self.bucket_for(n)

    # -- dispatch (the decode loop's thread only: the cells write the
    # -- engine's device state, single-writer by contract). Each entry
    # -- point packs its host operands, then runs its ``_cell_*`` through
    # -- ``_issue`` (a group's followers run the same cells) -------------

    def _launch(self, key, buffers, n, meta, op, *operands) -> InFlightBatch:
        """Run cell ``op`` on the host ``operands``, copy its token output
        into a pinned host buffer and record the event :meth:`fetch_step`
        waits on."""
        t_assembled = time.monotonic()
        tok = self._issue(op, *operands)
        with torch.inference_mode():
            host = self._host_empty(tuple(tok.shape), torch.int32)
            host.copy_(tok, non_blocking=True)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        return InFlightBatch(out={"tok": host}, key=key, n=n, meta=meta, buffers=buffers,
                             layout=self.layout, event=event, t_assembled=t_assembled)

    @torch.inference_mode()
    def _cell_prefill(self, T: int, L: int, *host):
        return self._prefill_cells[T, L](self._cache_k, self._cache_v, self._last_buf,
                                         *self._to_device(*host))

    @torch.inference_mode()
    def _cell_prefill_chunks(self, T: int, C: int, *host):
        return self._chunk_cells[T, C](self._cache_k, self._cache_v, self._last_buf,
                                       self._pool_k, self._pool_v, *self._to_device(*host))

    @torch.inference_mode()
    def _cell_decode(self, *host):
        return self._decode_cell(self._cache_k, self._cache_v, self._last_token,
                                 *self._to_device(*host))

    @torch.inference_mode()
    def _cell_verify(self, *host):
        return self._verify_cell(self._cache_k, self._cache_v, self._last_token,
                                 *self._to_device(*host))

    def prefill(self, admissions: list[dict]) -> InFlightBatch:
        """Admit up to a tier of requests into their assigned slots.

        ``admissions`` rows: ``{"slot", "input_ids", "temperature",
        "seed"}``. Returns without blocking; :meth:`fetch_step` yields the
        ``[tier]`` first-token vector (real rows in admitted order)."""
        if self._chunked_mode:
            raise RuntimeError(
                "engine built in chunked-prefill mode (prefix cache / prefill_chunk); "
                "admissions go through prefill_chunks")
        if len(admissions) > self.max_batch:
            raise ValueError(f"admitting {len(admissions)} exceeds max_batch {self.max_batch}")
        lens = [np.asarray(a["input_ids"]).shape[0] for a in admissions]
        L = self.bucket_for(max(lens))
        T = self.tier_for(len(admissions))
        key = ("prefill", T, L)
        buffers = self._take_buffers(key, lambda: (
            self._host_empty((T, L), torch.int32), self._host_empty((T, L), torch.bool),
            self._host_empty((T,), torch.int32), self._host_empty((T,), torch.int32),
            self._host_empty((T,), torch.float32), self._host_empty((T,), torch.int32)))
        ids, mask, slot_ix, lengths, temps, seeds = (b.numpy() for b in buffers)
        ids.fill(0)
        mask.fill(False)
        slot_ix.fill(self.slots)  # one past the pool: padding rows write nothing real
        lengths.fill(0)
        temps.fill(0.0)
        seeds.fill(0)
        for r, (a, n) in enumerate(zip(admissions, lens)):
            ids[r, :n] = np.asarray(a["input_ids"], np.int32)
            mask[r, :n] = True
            slot_ix[r] = int(a["slot"])
            lengths[r] = n
            temps[r] = float(a.get("temperature", 0.0))
            seeds[r] = int(a.get("seed", 0))
        mask[len(admissions):, 0] = True
        self._record_dispatch(T, L, len(admissions))
        return self._launch(key, buffers, len(admissions), [int(s) for s in slot_ix[:len(lens)]],
                            "prefill", T, L, *buffers)

    def prefill_chunks(self, rows: list[dict]) -> InFlightBatch:
        """Dispatch ONE prefill chunk for up to a tier of admitted slots.

        ``rows``: ``{"slot", "input_ids" (the FULL prompt), "start",
        "n_tokens", "length", "chain" (pool block ids, non-empty only on a
        row's first chunk, when its matched prefix gathers), "temperature",
        "seed"}``. Rows whose chunk completes the prompt sample their first
        token on the device (rows mid-prompt return lanes nobody reads)."""
        if not self._chunked_mode:
            raise RuntimeError(
                "prefill_chunks needs chunked mode (prefix_cache_mb or prefill_chunk "
                "at construction)")
        if len(rows) > self.max_batch:
            raise ValueError(f"admitting {len(rows)} exceeds max_batch {self.max_batch}")
        T = self.tier_for(len(rows))
        C = self._chunk_bucket_for(max(int(r["n_tokens"]) for r in rows))
        M = self._max_chain
        key = ("chunk", T, C)
        buffers = self._take_buffers(key, lambda: (
            self._host_empty((T, C), torch.int32), self._host_empty((T,), torch.int32),
            self._host_empty((T,), torch.int32), self._host_empty((T, M), torch.int32),
            self._host_empty((T,), torch.int32), self._host_empty((T,), torch.int32),
            self._host_empty((T,), torch.float32), self._host_empty((T,), torch.int32)))
        ids, starts, lengths, chain, n_gather, slot_ix, temps, seeds = (
            b.numpy() for b in buffers)
        ids.fill(0)
        starts.fill(0)
        lengths.fill(0)
        chain.fill(0)
        n_gather.fill(0)
        slot_ix.fill(self.slots)
        temps.fill(0.0)
        seeds.fill(0)
        for r, row in enumerate(rows):
            s0, n = int(row["start"]), int(row["n_tokens"])
            ids[r, :n] = np.asarray(row["input_ids"][s0:s0 + n], np.int32)
            starts[r] = s0
            lengths[r] = int(row["length"])
            blocks = row.get("chain") or ()
            if len(blocks) > M:
                raise ValueError(f"prefix chain of {len(blocks)} exceeds max chain {M}")
            chain[r, :len(blocks)] = blocks
            n_gather[r] = len(blocks)
            slot_ix[r] = int(row["slot"])
            temps[r] = float(row.get("temperature", 0.0))
            seeds[r] = int(row.get("seed", 0))
        self._record_dispatch(T, C, len(rows))
        return self._launch(key, buffers, len(rows), [int(s) for s in slot_ix[:len(rows)]],
                            "prefill_chunks", T, C, *buffers)

    def _require_pool(self) -> None:
        if not self._has_pool:
            raise RuntimeError("engine has no prefix cache (prefix_cache_mb=0)")

    def insert_prefix(self, slot: int, blocks: list[tuple[int, int]]) -> None:
        """Publish a fully-prefilled slot's prefix pages into the pool:
        ``blocks`` are ``(block_id, block_index)`` pairs. Dispatch-only;
        stream order puts the prompt's K/V in the pages before any later
        chunk can gather them."""
        self._require_pool()
        M = self._max_chain
        if len(blocks) > M:
            raise ValueError(f"inserting {len(blocks)} blocks exceeds max chain {M}")
        host = self._host_empty((2, M), torch.int64)
        ids, pos = host.numpy()
        ids.fill(self._pool_blocks)  # the spare block
        pos.fill(0)
        for j, (bid, bix) in enumerate(blocks):
            ids[j], pos[j] = int(bid), int(bix)
        self._issue("insert_prefix", int(slot), host)

    @torch.inference_mode()
    def _cell_insert_prefix(self, slot: int, host):
        # A pinned source copies without waiting on the device: the loop
        # thread that publishes never stalls behind the steps in flight.
        ids_d, pos_d = torch.as_tensor(host).to(self.device, non_blocking=True)
        self._insert_cell(self._pool_k, self._pool_v, self._cache_k, self._cache_v, slot,
                          ids_d, pos_d)

    def _gather_heads(self, stage):
        """A page stage of this rank's heads -> the whole heads (all-gathered
        over the model axis, on every rank); an int8 stage's scale plane is
        this rank's (the leader's on the leader), as the JAX engine's
        replicated scale spec returns one shard's."""
        if self._tp <= 1:
            return stage
        from distributed_tensorflow_tpu_torch.parallel import collectives as coll
        from distributed_tensorflow_tpu_torch.parallel.mesh import axis_group

        group = axis_group(self.mesh, "model")

        def gather(x):
            return coll._gather(x.contiguous(), group, self._tp, x.dim() - 2)
        if isinstance(stage, dict):
            return {"q": gather(stage["q"]), "s": stage["s"]}
        return gather(stage)

    def _local_heads(self, x):
        """This rank's heads of a whole-head page leaf (head axis -2)."""
        if self._tp <= 1:
            return x
        from distributed_tensorflow_tpu_torch.parallel.mesh import coordinate

        return x.chunk(self._tp, dim=x.dim() - 2)[coordinate(self.mesh, ("model",))]

    def export_prefix_pages(self, blocks: list[int]):
        """Gather published pool pages for a PINNED chain of block ids:
        ``(k, v)`` stages ``[nl, max_chain, block_tokens, heads, head_dim]``
        on the device (every head: a group gathers them), the chain's pages
        in order, pad lanes repeating block 0. Needs ``kv_transfer=True``.
        Reads only; in-place writes never free a buffer here, so it needs no
        retry loop."""
        if not self._kv_transfer:
            raise RuntimeError("engine built without kv_transfer=True (no pool-export cell)")
        M = self._max_chain
        if len(blocks) > M:
            raise ValueError(f"exporting {len(blocks)} blocks exceeds max chain {M}")
        idx = torch.zeros((M,), dtype=torch.int64)
        idx[:len(blocks)] = torch.as_tensor(list(blocks), dtype=torch.int64)
        return self._issue("export_prefix_pages", idx)

    @torch.inference_mode()
    def _cell_export_prefix_pages(self, idx):
        k, v = self._export_cell(self._pool_k, self._pool_v, idx.to(self.device))
        return self._gather_heads(k), self._gather_heads(v)

    def import_prefix_pages(self, blocks: list[tuple[int, int]], pages_k, pages_v) -> None:
        """Adopt transferred KV pages into the pool: ``blocks`` are
        ``(block_id, chain_index)`` pairs; ``pages_*`` are ``[nl, max_chain,
        block_tokens, heads, head_dim]`` stages of every head (host or
        device tensors, or numpy; ``{"q", "s"}`` at int8). Needs
        ``kv_transfer=True``."""
        if not self._kv_transfer:
            raise RuntimeError("engine built without kv_transfer=True (no pool-import cell)")
        M = self._max_chain
        if len(blocks) > M:
            raise ValueError(f"importing {len(blocks)} blocks exceeds max chain {M}")
        ids = torch.full((M,), self._pool_blocks, dtype=torch.int64)
        for bid, cix in blocks:
            if not 0 <= int(cix) < M:
                raise ValueError(f"chain index {cix} outside the {M}-lane page stage")
            ids[int(cix)] = int(bid)
        self._issue("import_prefix_pages", ids, pages_k, pages_v)

    @torch.inference_mode()
    def _cell_import_prefix_pages(self, ids, pages_k, pages_v):
        self._import_cell(self._pool_k, self._pool_v, self._stage(pages_k),
                          self._stage(pages_v), ids.to(self.device))

    def _stage(self, pages):
        """A received page stage on the device, in the cache's storage, cut
        to this rank's heads."""
        def put(x, like):
            return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x
                                   ).to(self.device, like.dtype)
        if isinstance(self._cache_k, dict):
            return {"q": self._local_heads(put(pages["q"], self._cache_k["q"])),
                    "s": put(pages["s"], self._cache_k["s"])}
        return self._local_heads(put(pages, self._cache_k))

    def _warm_import(self):
        k, v = self.export_prefix_pages([])
        self.import_prefix_pages([], k, v)

    def page_meta(self) -> dict:
        """Static page geometry the wire format stamps into its header: two
        pools are transfer-compatible iff these match (whole heads, at any
        layout)."""
        self._require_pool()
        nl, _, bt, heads, hd = _kv_leaf(self._pool_k).shape
        return {
            "num_layers": int(nl), "block_tokens": int(bt), "heads": int(heads) * self._tp,
            "head_dim": int(hd),
            # int8 pools report int8 (the q payload's dtype).
            "dtype": str(_kv_leaf(self._pool_k).dtype).removeprefix("torch."),
            "max_chain": int(self._max_chain),
        }

    def export_slot_pages(self, slot: int):
        """Checkpoint ONE live slot's KV lane: ``(k, v)`` stages ``[nl,
        cache_len, heads, head_dim]`` on the device, every head. Needs
        ``stream_migrate=True``."""
        if self._slot_export_cell is None:
            raise RuntimeError("engine built without stream_migrate=True (no slot-export cell)")
        return self._issue("export_slot_pages", int(slot))

    @torch.inference_mode()
    def _cell_export_slot_pages(self, slot: int):
        k, v = self._slot_export_cell(self._cache_k, self._cache_v, slot)
        return self._gather_heads(k), self._gather_heads(v)

    def import_slot_pages(self, slot: int, pages_k, pages_v, last_token: int) -> None:
        """Adopt a migrated stream's KV lane (every head) into ``slot`` and
        seed ``last_token[slot]``, so the next decode step continues it.
        Needs ``stream_migrate=True``."""
        if self._slot_import_cell is None:
            raise RuntimeError("engine built without stream_migrate=True (no slot-import cell)")
        self._issue("import_slot_pages", int(slot), pages_k, pages_v, int(last_token))

    @torch.inference_mode()
    def _cell_import_slot_pages(self, slot: int, pages_k, pages_v, last_token: int):
        self._slot_import_cell(self._cache_k, self._cache_v, self._last_buf,
                               self._stage(pages_k), self._stage(pages_v), slot, last_token)

    def stream_page_meta(self) -> dict:
        """Slot-lane geometry the stream wire format stamps into its header."""
        nl, _, lc1, heads, hd = _kv_leaf(self._cache_k).shape
        return {"num_layers": int(nl), "cache_len": int(lc1 - 1),
                "heads": int(heads) * self._tp, "head_dim": int(hd),
                "dtype": str(_kv_leaf(self._cache_k).dtype).removeprefix("torch.")}

    def decode(self, lengths, active, temps, seeds) -> InFlightBatch:
        """Dispatch ONE decode step over the full slot table (host arrays
        are snapshots; the batcher advances its lengths at dispatch so
        steps pipeline). Returns without blocking."""
        key = ("decode",)
        s = self.slots
        buffers = self._take_buffers(key, lambda: (
            self._host_empty((s,), torch.int32), self._host_empty((s,), torch.bool),
            self._host_empty((s,), torch.float32), self._host_empty((s,), torch.int32)))
        for b, src in zip(buffers, (lengths, active, temps, seeds)):
            np.copyto(b.numpy(), src)
        return self._launch(key, buffers, int(np.sum(active)), None, "decode", *buffers)

    def verify(self, drafts, lengths, n_input, temps, seeds) -> InFlightBatch:
        """Dispatch ONE speculative verify step over the full slot table.
        ``drafts [slots, k]``; ``n_input``: drafted + 1 for verifying lanes,
        0 for the rest. :meth:`fetch_step` yields the ``[slots, k + 1]``
        sampled-token matrix."""
        if self._verify_cell is None:
            raise RuntimeError("engine built without speculation (spec_tokens=0)")
        key = ("verify",)
        s = self.slots
        buffers = self._take_buffers(key, lambda: (
            self._host_empty((s, self.spec_tokens), torch.int32),
            self._host_empty((s,), torch.int32), self._host_empty((s,), torch.int32),
            self._host_empty((s,), torch.float32), self._host_empty((s,), torch.int32)))
        for b, src in zip(buffers, (drafts, lengths, n_input, temps, seeds)):
            np.copyto(b.numpy(), src)
        return self._launch(key, buffers, int(np.sum(np.asarray(n_input) > 0)), None,
                            "verify", *buffers)

    def fetch_step(self, inflight: InFlightBatch) -> np.ndarray:
        """Wait for a step's sampled-token vector (or a verify step's
        ``[slots, k + 1]`` matrix): the ONE synchronisation point of the
        decode path (the leader's only: it runs no collective)."""
        if inflight.event is not None:
            inflight.event.synchronize()
        tok = inflight.out["tok"].numpy().copy()
        inflight.t_got = time.monotonic()
        if inflight.buffers is not None:
            self._give_buffers(inflight.key, inflight.buffers)
        return tok

    # -- warm-up: each cell once at its shape, on inputs that change no
    # -- state (padding rows, idle lanes, spare blocks); every rank of a
    # -- group runs them itself, in one order --------------------------

    def _warm_prefill(self, T: int, L: int):
        """A prefill of ``T`` padding rows at bucket ``L``: every write lands
        in a spare entry."""
        buffers = (torch.zeros((T, L), dtype=torch.int32), torch.zeros((T, L), dtype=torch.bool),
                   torch.full((T,), self.slots, dtype=torch.int32),
                   torch.zeros((T,), dtype=torch.int32), torch.zeros((T,), dtype=torch.float32),
                   torch.zeros((T,), dtype=torch.int32))
        buffers[1][:, 0] = True
        return self.fetch_step(self._launch(("warm",), None, 0, [], "prefill", T, L, *buffers))

    def _warm_chunk(self, T: int, C: int):
        z = torch.zeros((T,), dtype=torch.int32)
        buffers = (torch.zeros((T, C), dtype=torch.int32), z, z,
                   torch.zeros((T, self._max_chain), dtype=torch.int32), z,
                   torch.full((T,), self.slots, dtype=torch.int32),
                   torch.zeros((T,), dtype=torch.float32), z)
        return self.fetch_step(self._launch(("warm",), None, 0, [], "prefill_chunks", T, C,
                                            *buffers))

    def _warm_decode(self):
        s = self.slots
        return self.fetch_step(self._launch(
            ("warm",), None, 0, None, "decode", torch.zeros((s,), dtype=torch.int32),
            torch.zeros((s,), dtype=torch.bool), torch.zeros((s,), dtype=torch.float32),
            torch.zeros((s,), dtype=torch.int32)))

    def _warm_verify(self):
        s = self.slots
        z = torch.zeros((s,), dtype=torch.int32)
        return self.fetch_step(self._launch(
            ("warm",), None, 0, None, "verify",
            torch.zeros((s, self.spec_tokens), dtype=torch.int32), z, z,
            torch.zeros((s,), dtype=torch.float32), z))


class ImageClassifierEngine(_AotEngine):
    """Top-k classification over a trained image classifier (LeNet,
    ResNet-20/50, Inception-v3) in eval mode, BatchNorm from the running
    statistics in ``model_state`` (``{"batch_stats": ...}``).

    Request payload: ``image`` ``[H, W, C]`` float32 at the engine's
    geometry (one image "bucket"). Response: ``top_ids [k]``,
    ``top_probs [k]``. ``device`` defaults to the card. A ``mesh`` serves
    data parallelism only: a tier's rows split over the group's ranks
    where they divide (see the module docstring).
    """

    def __init__(
        self,
        model,
        params: dict,
        model_state: dict | None = None,
        device="cuda",
        *,
        image_shape: tuple[int, int, int],
        max_batch: int = 8,
        batch_tiers: tuple[int, ...] | None = None,
        top_k: int = 5,
        memory=None,
        mesh=None,
    ):
        super().__init__(device, max_batch, batch_tiers, memory=memory, mesh=mesh)
        if mesh is not None and mesh.size != math.prod(
                mesh.shape.get(a, 1) for a in ("replica", "data")):
            raise ValueError(f"image serving is data-parallel only; got the mesh "
                             f"{dict(mesh.shape)}")
        if any(is_quantized_leaf(v) for v in params.values()):
            raise ValueError("image serving has no int8 mode (the classifier forward "
                             "has no dequantize step)")
        model.load_state_dict(params, strict=True, assign=True)
        self.model = model.to(self.device).eval()
        self.model_state = {
            k: ({n: t.to(self.device) for n, t in v.items()} if isinstance(v, dict)
                else v.to(self.device))
            for k, v in (model_state or {}).items()
        }
        self.image_shape = tuple(image_shape)
        self.top_k = top_k
        self.memory.register_tree("image_params",
                                  {"params": dict(self.model.state_dict()),
                                   **self.model_state})
        self._plan_cells(len(self.batch_tiers))
        outs = [
            self._compile_cell(
                f"image/{self.layout}/t{T}",
                lambda T=T: self._cell_dispatch(T, torch.zeros((T, *self.image_shape))))
            for T in self.batch_tiers
        ]
        self._k = outs[0]["top_ids"].shape[-1]  # top_k clamped to the classes
        self._start_group()
        logger.info("image engine ready: device=%s shape=%s tiers=%s top_k=%d",
                    self.device, self.image_shape, self.batch_tiers, top_k)

    @torch.inference_mode()
    def _forward(self, image):
        from distributed_tensorflow_tpu_torch.train.objectives import _apply

        logits, _ = _apply(self.model, self.model_state, image, False)
        probs = torch.softmax(logits.float(), dim=-1)
        top_probs, top_ids = torch.topk(probs, min(self.top_k, probs.shape[-1]), dim=-1)
        return {"top_ids": top_ids.to(torch.int32), "top_probs": top_probs}

    @torch.inference_mode()
    def _cell_dispatch(self, T: int, images):
        (image,) = self._to_device(images)
        rows = self._data_rows(T)
        out = self._forward(image if rows is None else image[rows])
        return self._gather_rows(out) if rows is not None else out

    def validate(self, payload: dict) -> None:
        img = np.asarray(payload.get("image", ()))
        if img.shape != self.image_shape:
            raise RequestError(
                f"image shape {img.shape} != engine geometry {self.image_shape}")

    def request_bucket(self, payload: dict) -> int:
        return 0  # one geometry: every request shares the single bucket

    def dispatch(self, payloads: list[dict]) -> InFlightBatch:
        if len(payloads) > self.max_batch:
            raise ValueError(f"batch of {len(payloads)} exceeds max_batch {self.max_batch}")
        T = self.tier_for(len(payloads))
        k = self._k
        buffers = self._take_buffers((T,), lambda: (
            self._host_empty((T, *self.image_shape), torch.float32),
            self._host_empty((T, k), torch.int32), self._host_empty((T, k), torch.float32)))
        imgs = buffers[0].numpy()
        imgs.fill(0.0)
        for r, p in enumerate(payloads):
            imgs[r] = np.asarray(p["image"], np.float32)
        t_assembled = time.monotonic()
        out = self._issue("dispatch", T, buffers[0])
        host = {"top_ids": buffers[1], "top_probs": buffers[2]}
        for key, h in host.items():
            h.copy_(out[key], non_blocking=True)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        self._record_dispatch(T, None, len(payloads))
        return InFlightBatch(out=host, key=(T,), n=len(payloads), meta=[], buffers=buffers,
                             layout=self.layout, event=event, t_assembled=t_assembled)

    def fetch(self, inflight: InFlightBatch) -> list[dict]:
        if inflight.event is not None:
            inflight.event.synchronize()
        inflight.t_got = time.monotonic()
        out = {k: v.numpy().copy() for k, v in inflight.out.items()}
        self._give_buffers(inflight.key, inflight.buffers)
        return [{"top_ids": out["top_ids"][r], "top_probs": out["top_probs"][r]}
                for r in range(inflight.n)]
