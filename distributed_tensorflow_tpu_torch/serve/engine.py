"""Inference engine: checkpoint-loaded BERT forward over a warmed shape grid.

Port of the JAX package's ``serve/engine.py`` for BERT on one device. Every
(batch tier x sequence bucket) cell the engine will ever run is warmed at
STARTUP by one forward at that shape, timed into a :class:`CompileRecord`,
so ``grid_status``/``warm_fraction`` keep their meaning (the JAX engine
AOT-compiled one executable per cell; capturing each cell as a CUDA graph
is later work). Requests pad up to the smallest bucket that fits
(``buckets``, default {128, 256, 512} clamped to ``max_position``); partial
batches pad with inert rows to the SMALLEST batch tier that holds them.

The request path is split ``dispatch -> fetch``: ``dispatch`` fills pooled
host staging buffers (pinned on a card), copies them to the device without
blocking, enqueues the forward and the copy of its results into pinned
host buffers, and returns an :class:`InFlightBatch`; ``fetch`` waits on the
batch's CUDA event — the only synchronisation point — and slices per-row
results. The batcher overlaps batch k+1's assembly with batch k's device
work through that split.

Layout: DP-only with ``data=1`` (``layout == "single"``): the model sits
whole on one device. The tensor, expert and pipeline layouts come with the
model-parallel slice.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time

import numpy as np
import torch

from distributed_tensorflow_tpu_torch.device import resolve_device
from distributed_tensorflow_tpu_torch.models.quant import (
    cast_params,
    normalize_quant_dtype,
    torch_dtype,
)
from distributed_tensorflow_tpu_torch.obs.memory import default_registry, tree_nbytes

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

    The model axes need ``tp * pp * ep`` devices (default
    ``torch.cuda.device_count()``) and the remainder goes to data
    parallelism, so the product must divide the device count. When it
    does not, serving falls back to one device a replica, data-parallel,
    with a warning: a wrong-sized ``--tp`` degrades to slower serving and
    never dies at startup. It only plans: the engines that serve the
    tensor, expert and pipeline layouts come with the model-parallel slice.
    """
    if n_devices is None:
        n_devices = torch.cuda.device_count()
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
    :class:`serve.server.Client`; it stays ``None`` for bare engines).

    Every grid-cell warm-up routes through :meth:`_compile_cell`, which
    times it into a :class:`CompileRecord`; :meth:`grid_status` aggregates
    them into the ``GET /compilez`` digest and the warm fraction the
    readiness probe reads.
    """

    _RACETRACE_ATTRS = ("_buf_pool", "_compile_records", "_cells_planned")

    def __init__(self, device, max_batch: int, batch_tiers=None, memory=None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.device = resolve_device(device)
        self.layout = "single"
        self.max_batch = max_batch
        self.batch_tiers = _normalize_tiers(batch_tiers, max_batch)
        self.metrics = None
        self.memory = memory if memory is not None else default_registry()
        self._buf_lock = threading.Lock()
        self._buf_pool: dict[tuple, list[tuple]] = {}
        self._grid_lock = threading.Lock()
        self._compile_records: list[CompileRecord] = []
        self._cells_planned = 0

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
        """Topology digest (``GET /statusz``)."""
        return {
            "layout": self.layout,
            "mesh_shape": {"data": 1},
            "devices_per_engine": 1,
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

    ``model`` supplies the architecture and config; ``params`` is the state
    dict to serve (from :func:`~..ckpt.restore_serving_state`). The engine
    loads ``params`` into ``model`` and moves it to ``device`` (the card by
    default; ``device="cpu"`` must be asked for).

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
        buckets: tuple[int, ...] = (128, 256, 512),
        max_batch: int = 8,
        batch_tiers: tuple[int, ...] | None = None,
        return_logits: bool = False,
        weight_dtype: str | None = None,
        memory=None,
    ):
        super().__init__(device, max_batch, batch_tiers, memory=memory)
        cfg = model.cfg
        w = normalize_quant_dtype(weight_dtype, "weight_dtype")
        self.weight_dtype = w or str(cfg.dtype).removeprefix("torch.")
        if torch_dtype(self.weight_dtype) != cfg.dtype:
            params = cast_params(params, torch_dtype(self.weight_dtype))
        self.buckets = tuple(sorted({min(int(b), cfg.max_position) for b in buckets}))
        if not self.buckets:
            raise ValueError("need at least one sequence bucket")
        self.return_logits = return_logits
        model.load_state_dict(params, strict=True, assign=True)
        self.model = model.to(self.device).eval()
        self.params = dict(self.model.state_dict())
        self.memory.register_tree(
            "bert_params", self.params, dtype=self.weight_dtype,
            fp32_nbytes=sum(
                t.numel() * 4 for t in self.params.values() if t.is_floating_point()
            ),
        )
        self._forward = _make_bert_forward(self.model, return_logits)
        # Warm every (tier, bucket) cell NOW: startup pays the first-call
        # costs (kernel build and load, allocator growth), requests do not.
        self._plan_cells(len(self.batch_tiers) * len(self.buckets))
        for T in self.batch_tiers:
            for L in self.buckets:
                self._compile_cell(
                    f"bert/{self.layout}/t{T}/b{L}",
                    lambda T=T, L=L: self._warm(T, L),
                )
        logger.info(
            "BERT engine ready: device=%s buckets=%s tiers=%s (%d cells)",
            self.device, self.buckets, self.batch_tiers,
            len(self.batch_tiers) * len(self.buckets),
        )

    @torch.inference_mode()
    def _warm(self, T: int, L: int):
        z = torch.zeros((T, L), dtype=torch.int32, device=self.device)
        mask = torch.zeros((T, L), dtype=torch.bool, device=self.device)
        mask[:, 0] = True
        return self._forward(z, mask, z, z - 1)

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
        with torch.inference_mode():
            dev = [b.to(self.device, non_blocking=True) for b in buffers[:4]]
            out = self._forward(*dev)
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
