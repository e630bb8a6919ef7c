"""Serving front ends: in-process :class:`Client` and a stdlib HTTP server.

``Client`` is the canonical surface — validate-at-submit, enqueue into the
:class:`DynamicBatcher` (or, for a decode engine, the
:class:`ContinuousBatcher`), block on the Future. The HTTP server is a thin
JSON adapter over the same client (``ThreadingHTTPServer``: one thread per
connection blocks on its Future while the flusher thread batches across
them — exactly the concurrency the micro-batcher exists to exploit).

Routes (port of the JAX package's ``serve/server.py``)::

    GET  /healthz    -> readiness probe: 200 {"status": "ready", ...} only
                        when the stack serves; 503 with the state string
                        (starting/degraded/draining/closed) otherwise
    GET  /metrics    -> ServeMetrics.snapshot() as JSON;
                        ``?format=prom`` -> Prometheus text exposition
                        (format 0.0.4) of every family + SLO + health
    GET  /sloz       -> declared SLOs: per-window attainment, error-budget
                        burn rates, ok/warn/page verdicts
    GET  /statusz    -> live status: queue depths, in-flight batches,
                        tier/bucket occupancy, rejections by cause,
                        recent-span summary
    GET  /tracez?spans=N -> drain the span ring buffer as Chrome
                        trace-event JSON (Perfetto / chrome://tracing)
    GET  /memz       -> device-memory accounting: per-component
                        reservations, per-device CUDA memory statistics
    GET  /compilez   -> warm-up grid digest: cells total/compiled/failed,
                        cumulative warm-up seconds, per-cell records
    POST /debugz/dump-> force a flight-recorder dump
    POST /profilez?ms=N -> capture a bounded ``torch.profiler`` window on
                        the RUNNING server (needs trace_dir): replies
                        trace_dir, requested_ms, wall_ms
    POST /drainz     -> flip to draining: /healthz goes 503 so the router
                        stops routing here, while in-flight + already-
                        queued requests still complete
    POST /v1/mlm     -> BERT: pred_ids / score / nsp_probs for one example
    POST /v1/embed   -> BERT: pooled [CLS] embedding for one example
    POST /v1/classify-> image engine: top_ids / top_probs for one image
    POST /v1/generate-> causal LM: generated tokens for one prompt
                        (continuous batching: the request joins the
                        in-flight decode batch between steps; optional
                        "priority" class + "deadline_ms" TTFT deadline
                        drive EDF admission and slot preemption when the
                        batcher runs --sched edf / --preempt)
    POST /v1/kv_transfer -> decode role: adopt a KV-page chain (octet-stream
                        wire buffer, serve/disagg.py); 400 on a refusal,
                        429 on a transfer-budget shed
    POST /v1/stream_migrate -> adopt a migrated live stream (octet-stream;
                        same 400/429 contract)
    POST /v1/stream_wait -> {"request_id"}: the adopted stream's finished
                        generation; 404 for an id never adopted here
    POST /migratez   -> {"targets": [[host, port], ..]}: export every live
                        stream and push it to those survivors
                        (the four fleet routes answer 503 on a server
                        built without their receiver or migrator)

A request route the engine cannot answer (``/v1/generate`` on a BERT or
image engine, the others on a decode engine) answers 404.

Every request gets a ``request_id`` (honoring an ``X-Request-Id`` header
when the client sends one) that rides through the batcher and comes back
in the response — success bodies also carry ``phases``, the per-request
latency breakdown (``queue_wait/batch_assemble/dispatch/device/fetch``,
milliseconds).

Error mapping: RequestError -> 400; Backpressure -> 429 + ``Retry-After``;
:class:`Draining` (submit during drain) -> 503; anything the engine raises
mid-batch -> 500. All error bodies carry the ``request_id``.
"""

from __future__ import annotations

import itertools
import json
import logging
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from distributed_tensorflow_tpu_torch.obs.export import (
    PROM_CONTENT_TYPE,
    prometheus_text,
)
from distributed_tensorflow_tpu_torch.obs.flightrec import NULL_RECORDER
from distributed_tensorflow_tpu_torch.obs.health import HealthTracker
from distributed_tensorflow_tpu_torch.obs.memory import default_registry
from distributed_tensorflow_tpu_torch.obs.metrics import ServeMetrics
from distributed_tensorflow_tpu_torch.obs.slo import SloSpec, SloTracker
from distributed_tensorflow_tpu_torch.obs.timeseries import bounds_with
from distributed_tensorflow_tpu_torch.obs.trace import Tracer
from distributed_tensorflow_tpu_torch.serve.batcher import (
    BatcherConfig,
    ContinuousBatcher,
    DynamicBatcher,
)
from distributed_tensorflow_tpu_torch.serve.engine import RequestError

logger = logging.getLogger(__name__)


class Draining(Exception):
    """A submit arrived while the stack was draining (or closed): new work
    is shed AT THE DOOR with an attributable ``request_id``. The HTTP layer
    maps this to 503."""

    def __init__(self, request_id: str, state: str = "draining"):
        super().__init__(f"shedding: server is {state}")
        self.request_id = request_id
        self.state = state


class Client:
    """In-process serving client: ``submit`` returns a Future, ``call``
    blocks for the result. Payloads validate BEFORE they enqueue so a
    malformed request fails alone instead of poisoning its batch.

    The resolved Future carries ``future.request_id`` and
    ``future.phases`` (the per-phase latency breakdown in seconds).

    A decode engine (one with ``prefill`` and ``decode``) is served by the
    :class:`ContinuousBatcher`; ``admission`` picks continuous admission
    or the flush baseline (admit only into an empty slot table).
    """

    def __init__(
        self,
        engine,
        config: BatcherConfig | None = None,
        metrics: ServeMetrics | None = None,
        tracer: Tracer | None = None,
        slo: SloSpec | None = None,
        admission: str = "continuous",
        recorder=None,
        memory=None,
        warmup_ready_fraction: float = 1.0,
        tag: str | None = None,
    ):
        self.engine = engine
        self.tag = tag
        self._shed_ids = itertools.count()
        self.recorder = recorder if recorder is not None else NULL_RECORDER
        self.memory = (
            memory
            if memory is not None
            else getattr(engine, "memory", None) or default_registry()
        )
        if metrics is None:
            # Insert the SLO latency threshold as an explicit histogram
            # bound so windowed attainment at the threshold is EXACT.
            threshold_s = (slo.latency_threshold_ms / 1e3) if slo else 0.0
            metrics = ServeMetrics(latency_bounds=bounds_with(threshold_s))
        self.metrics = metrics
        self.tracer = tracer if tracer is not None else Tracer()
        if config is None:
            config = BatcherConfig(max_batch=engine.max_batch)
        elif config.max_batch > engine.max_batch:
            raise ValueError(
                f"batcher max_batch {config.max_batch} exceeds engine "
                f"max_batch {engine.max_batch}"
            )
        # Engines that expose the split hot path (dispatch/fetch) get the
        # overlapped batcher; engines that expose a bucket key get
        # bucket-aware queues when the config asks for them. Stub engines
        # with only run_batch keep the serial path. Decode engines
        # (prefill + per-step decode over a slot table) get the
        # continuous batcher, and nothing else: bucket_queues is moot
        # there (admission groups pad per group, not per flush).
        if getattr(engine, "metrics", False) is None:
            engine.metrics = self.metrics  # per-tier/bucket instruments
        if hasattr(engine, "prefill") and hasattr(engine, "decode"):
            self.batcher = ContinuousBatcher(
                engine,
                config,
                metrics=self.metrics,
                admission=admission,
                tracer=self.tracer,
                recorder=self.recorder,
                layout=getattr(engine, "layout", ""),
            )
        else:
            bucket_for = (
                getattr(engine, "request_bucket", None)
                if config.bucket_queues
                else None
            )
            if config.bucket_queues and bucket_for is None:
                raise ValueError(
                    "bucket_queues=True needs an engine with request_bucket()"
                )
            self.batcher = DynamicBatcher(
                engine.run_batch,
                config,
                metrics=self.metrics,
                dispatch=getattr(engine, "dispatch", None),
                fetch=getattr(engine, "fetch", None),
                bucket_for=bucket_for,
                tracer=self.tracer,
                recorder=self.recorder,
                layout=getattr(engine, "layout", ""),
            )
        self.slo = SloTracker(
            self.metrics, slo or SloSpec(), recorder=self.recorder
        )
        gs = getattr(engine, "grid_status", None)
        self._grid_status = gs if callable(gs) else None
        self.health = HealthTracker(
            status_fn=self.batcher.status,
            metrics=self.metrics if self.metrics.windowed else None,
            slo=self.slo if self.slo.spec.enabled else None,
            warmup_fn=(
                (lambda: self._grid_status()["warm_fraction"])
                if self._grid_status is not None else None
            ),
            warmup_target=warmup_ready_fraction,
            recorder=self.recorder,
        )
        if self._grid_status is None:
            # No grid to warm (stub engine): serve immediately. Grid
            # engines stay ``starting`` until a probe sees the warm
            # fraction reach the target.
            self.health.mark_ready()
        self.recorder.attach(
            metrics_fn=self.metrics.snapshot,
            memz_fn=self.memory.snapshot,
            compilez_fn=self.grid_status,
            tracer_fn=self.tracer.summary,
        )

    def grid_status(self) -> dict:
        """The engine's warm-up grid digest (an always-warm placeholder for
        engines without one, so /compilez answers on every stack)."""
        if self._grid_status is not None:
            return self._grid_status()
        return {
            "cells_total": 0,
            "cells_compiled": 0,
            "cells_failed": 0,
            "compile_seconds_total": 0.0,
            "warm_fraction": 1.0,
            "coldest_cell": None,
            "cells": [],
        }

    def submit(self, payload: dict, request_id: str | None = None) -> Future:
        state = self.health.lifecycle
        if state in ("draining", "closed"):
            rid = request_id or f"shed-{next(self._shed_ids):06d}"
            self.metrics.rejected_by_cause.inc(state)
            self.tracer.instant(
                "rejected", "serve", request_id=rid, cause=state,
            )
            self.recorder.record("request_reject", rid, cause=state)
            raise Draining(rid, state)
        try:
            self.engine.validate(payload)  # RequestError before enqueue
        except RequestError:
            self.metrics.rejected_by_cause.inc("validation")
            self.tracer.instant(
                "rejected", "serve", request_id=request_id,
                cause="validation",
            )
            raise
        return self.batcher.submit(payload, request_id=request_id)

    def call(self, payload: dict, timeout: float | None = 60.0) -> dict:
        return self.submit(payload).result(timeout=timeout)

    def start_draining(self) -> None:
        """Flip /healthz to 503 (state ``draining``) WITHOUT closing."""
        if self.health.lifecycle in ("starting", "ready"):
            try:
                self.health.mark_draining()
            except ValueError:
                pass  # concurrent drain/close won the transition race

    def close(self) -> None:
        self.health.mark_closed()
        self.batcher.close()
        # A serving group's leader stops its followers (serve/group.py).
        stop = getattr(self.engine, "close", None)
        if callable(stop):
            stop()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _jsonable(obj):
    """numpy -> plain python, recursively (json.dumps chokes on ndarrays)."""
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


def build_http_server(
    client: Client,
    host: str = "127.0.0.1",
    port: int = 0,
    *,
    trace_dir: str | None = None,
    kv_receiver=None,
    transfer_budget=None,
    stream_receiver=None,
    migrator=None,
):
    """Build (not start) a ``ThreadingHTTPServer`` over ``client``.

    ``port=0`` binds an ephemeral port (read ``server.server_address``).
    Call ``serve_forever()`` to run; ``shutdown()`` to stop. ``trace_dir``
    is where ``POST /profilez`` writes its ``torch.profiler`` traces (None:
    the route answers 503).

    Disaggregated decode roles pass ``kv_receiver`` (a ``bytes -> dict``
    callable from :func:`~distributed_tensorflow_tpu_torch.serve.disagg.make_kv_receiver`)
    to mount ``POST /v1/kv_transfer`` — octet-stream wire buffers, 400 on
    a ``WireError`` refusal, 429 on a budget shed — and ``transfer_budget``
    (a :class:`~distributed_tensorflow_tpu_torch.serve.disagg.TransferBudget`)
    to surface the bytes-in-flight digest under ``/statusz``.

    Live stream migration adds two more optional mounts:
    ``stream_receiver`` (a
    :class:`~distributed_tensorflow_tpu_torch.serve.disagg.StreamReceiver`)
    mounts ``POST /v1/stream_migrate`` — same octet-stream/400/429
    contract as kv_transfer — plus ``POST /v1/stream_wait`` (JSON
    ``{"request_id": ..}``), which blocks for an adopted stream's finished
    generation and 404s for unknown ids (the caller's cue to replay with
    ``resume_tokens``). ``migrator`` (a ``targets -> dict`` callable
    wrapping :func:`~distributed_tensorflow_tpu_torch.serve.disagg.migrate_streams`)
    mounts ``POST /migratez`` — export every live stream here and push
    them to the given ``[[host, port], ..]`` survivors.
    """

    class Handler(BaseHTTPRequestHandler):
        # POST path -> the keys of the engine result it exposes; both BERT
        # routes run the SAME forward, /v1/embed just answers with less.
        _routes = {
            "/v1/mlm": ("pred_ids", "score", "nsp_probs", "bucket"),
            "/v1/embed": ("embedding", "bucket"),
            "/v1/classify": ("top_ids", "top_probs"),
            # status/target surface only on a stream that migrated away
            # mid-generation (POST /migratez): the caller sees status ==
            # "migrated" and collects the finished stream from the target
            # via /v1/stream_wait; ordinary results carry neither key.
            "/v1/generate": ("tokens", "n_tokens", "prompt_len", "bucket",
                             "status", "target"),
        }
        # Fleet-serving mounts: route -> (handler, the 503 answer of a
        # server built without it).
        _fleet = {
            "/v1/kv_transfer": (kv_receiver, "kv transfer disabled: server "
                                "built without a receiver (decode role only)"),
            "/v1/stream_migrate": (stream_receiver, "stream migration "
                                   "disabled: server built without a "
                                   "stream receiver"),
            "/v1/stream_wait": (stream_receiver, "stream migration disabled: "
                                "server built without a stream receiver"),
            "/migratez": (migrator, "stream migration disabled: server "
                          "built without a migrator"),
        }

        def log_message(self, fmt, *args):  # route access logs into logging
            logger.debug("http: " + fmt, *args)

        def _reply(self, code: int, body: dict, headers: dict | None = None):
            data = json.dumps(_jsonable(body)).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)

        def _reply_text(self, code: int, text: str, content_type: str):
            data = text.encode()
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _statusz(self) -> dict:
            snap = client.metrics.snapshot()
            tracer = client.tracer
            mesh_info = getattr(client.engine, "mesh_info", None)
            return {
                "engine": type(client.engine).__name__,
                "tag": client.tag,
                "mesh": mesh_info() if callable(mesh_info) else None,
                "batcher": client.batcher.status(),
                "queue_depth": snap["queue_depth"],
                "in_flight": snap["in_flight"],
                "requests": snap["requests"],
                "rejected_by_cause": snap["rejected_by_cause"],
                "errors": snap["errors"],
                "tier_occupancy": snap["tier_occupancy"],
                "bucket_hits": snap["bucket_hits"],
                "layout_tier_hits": snap["layout_tier_hits"],
                "phase_ms": snap["phase_ms"],
                "tracer": tracer.status(),
                "recent_spans": tracer.summary(),
                "grid": {
                    k: v
                    for k, v in client.grid_status().items()
                    if k != "cells"
                },
                "flight_recorder": client.recorder.status(),
                **(
                    {"kv_transfer": transfer_budget.digest()}
                    if transfer_budget is not None else {}
                ),
                **(
                    {"stream_migrate": stream_receiver.digest()}
                    if stream_receiver is not None else {}
                ),
            }

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/healthz":
                code, body = client.health.probe()
                body["engine"] = type(client.engine).__name__
                body["tag"] = client.tag
                self._reply(code, body)
            elif url.path == "/metrics":
                q = parse_qs(url.query)
                if q.get("format", [""])[0] == "prom":
                    self._reply_text(
                        200,
                        prometheus_text(
                            client.metrics,
                            slo=(
                                client.slo
                                if client.slo.spec.enabled
                                else None
                            ),
                            health=client.health,
                            memory=client.memory,
                            grid=client.grid_status(),
                        ),
                        PROM_CONTENT_TYPE,
                    )
                else:
                    self._reply(200, client.metrics.snapshot())
            elif url.path == "/sloz":
                state, _ = client.health.state()
                self._reply(200, {"health": state, **client.slo.report()})
            elif url.path == "/statusz":
                self._reply(200, self._statusz())
            elif url.path == "/memz":
                self._reply(200, client.memory.snapshot())
            elif url.path == "/compilez":
                self._reply(200, client.grid_status())
            elif url.path == "/tracez":
                q = parse_qs(url.query)
                try:
                    n = int(q["spans"][0]) if "spans" in q else None
                except ValueError:
                    self._reply(400, {"error": "spans must be an integer"})
                    return
                spans = client.tracer.drain(n)
                self._reply(200, client.tracer.chrome_json(spans))
            else:
                self._reply(404, {"error": f"no route {url.path}"})

        def _profilez(self, url) -> None:
            if trace_dir is None:
                self._reply(
                    503,
                    {"error": "profiling disabled: server built without "
                              "trace_dir (pass --trace-dir)"},
                )
                return
            q = parse_qs(url.query)
            try:
                ms = float(q["ms"][0]) if "ms" in q else 500.0
            except ValueError:
                self._reply(400, {"error": "ms must be a number"})
                return
            from distributed_tensorflow_tpu_torch.obs.profile import profile_window

            # Blocks THIS handler thread for the window; the serving hot
            # path keeps running underneath, so the capture sees live
            # traffic.
            self._reply(200, profile_window(
                trace_dir, ms, device=getattr(client.engine, "device", None)))

        def _wire_post(self, path: str, receiver) -> None:
            """``/v1/kv_transfer`` and ``/v1/stream_migrate``: an
            octet-stream wire buffer into its receiver."""
            try:
                n = int(self.headers.get("Content-Length", 0))
                out = receiver(self.rfile.read(n))
            except ValueError as e:  # WireError: refuse, don't adopt
                self._reply(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — budget shed or adoption failure
                retry = getattr(e, "retry_after_s", None)
                if retry is not None:
                    self._reply(
                        429,
                        {"error": str(e), "retry_after_s": retry},
                        headers={"Retry-After": f"{retry:.3f}"},
                    )
                else:
                    logger.exception("%s failed", path)
                    client.recorder.record(
                        "server_error", "", error=type(e).__name__,
                    )
                    self._reply(500, {"error": str(e)})
            else:
                self._reply(200, out)

        def _stream_wait(self) -> None:
            rid = None
            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
                rid = payload.get("request_id")
                if not rid:
                    self._reply(
                        400, {"error": "stream_wait needs a request_id"}
                    )
                    return
                result = stream_receiver.wait(
                    rid, float(payload.get("timeout_s", 60.0))
                )
            except json.JSONDecodeError as e:
                self._reply(400, {"error": f"bad JSON: {e}"})
            except KeyError:
                # Unknown id: this replica never adopted the stream (or
                # already handed its result out) — the caller's cue to
                # replay with resume_tokens.
                self._reply(
                    404,
                    {"error": f"no adopted stream {rid!r} here",
                     "request_id": rid},
                )
            except (FutureTimeout, TimeoutError):
                self._reply(
                    504,
                    {"error": "stream still generating", "request_id": rid},
                )
            except Exception as e:  # noqa: BLE001 — the resumed stream failed
                logger.exception("stream_wait %s failed", rid)
                self._reply(500, {"error": str(e), "request_id": rid})
            else:
                fields = self._routes["/v1/generate"]
                body = {k: result[k] for k in fields if k in result}
                body["request_id"] = rid
                self._reply(200, body)

        def _migratez(self) -> None:
            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
                targets = [
                    (str(t[0]), int(t[1]))
                    for t in payload.get("targets", ())
                ]
                out = migrator(targets)
            except (ValueError, TypeError, IndexError,
                    json.JSONDecodeError) as e:
                self._reply(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001
                logger.exception("stream migration failed")
                client.recorder.record(
                    "server_error", "", error=type(e).__name__,
                )
                self._reply(500, {"error": str(e)})
            else:
                self._reply(200, out)

        def do_POST(self):
            url = urlparse(self.path)
            if url.path == "/profilez":
                self._profilez(url)
                return
            if url.path in self._fleet:
                handler, unmounted = self._fleet[url.path]
                if handler is None:
                    self._reply(503, {"error": unmounted})
                elif url.path == "/v1/stream_wait":
                    self._stream_wait()
                elif url.path == "/migratez":
                    self._migratez()
                else:
                    self._wire_post(url.path, handler)
                return
            if url.path == "/drainz":
                client.start_draining()
                code, body = client.health.probe()
                # Drain progress: how much work remains (the decode
                # batcher adds occupied slots and the tokens they owe).
                st = client.batcher.status()
                self._reply(200, {
                    "draining": True,
                    "progress": {
                        "slots_active": st.get("slots_active", 0),
                        "queued": st.get("queue_depth", 0),
                        "in_flight": st.get("in_flight", 0),
                        "tokens_remaining": st.get("tokens_remaining", 0),
                    },
                    **body,
                })
                return
            if url.path == "/debugz/dump":
                if not client.recorder.enabled:
                    self._reply(
                        503,
                        {"error": "flight recorder disabled "
                                  "(pass --flight-buffer > 0)"},
                    )
                    return
                out = client.recorder.dump("manual", force=True)
                if isinstance(out, dict):
                    self._reply(200, out)
                else:
                    self._reply(200, {"reason": "manual", "path": str(out)})
                return
            fields = self._routes.get(url.path)
            # /v1/generate fronts decode engines only, the other request
            # routes the rest: a route the engine cannot answer is absent.
            decode = hasattr(client.engine, "prefill") and hasattr(client.engine, "decode")
            if fields is None or (url.path == "/v1/generate") != decode:
                self._reply(404, {"error": f"no route {url.path}"})
                return
            rid = self.headers.get("X-Request-Id") or None
            fut = None
            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
                if not isinstance(payload, dict):
                    raise RequestError("request body must be a JSON object")
                fut = client.submit(payload, request_id=rid)
                rid = getattr(fut, "request_id", rid)
                result = fut.result(timeout=60.0)
            except RequestError as e:
                self._reply(400, {"error": str(e), "request_id": rid})
            except Draining as e:
                self._reply(
                    503,
                    {
                        "error": str(e),
                        "request_id": e.request_id,
                        "status": e.state,
                    },
                )
            except json.JSONDecodeError as e:
                self._reply(
                    400, {"error": f"bad JSON: {e}", "request_id": rid}
                )
            except Exception as e:  # Backpressure or engine failure
                rid = getattr(e, "request_id", None) or rid
                retry = getattr(e, "retry_after_s", None)
                if retry is not None:
                    self._reply(
                        429,
                        {
                            "error": str(e),
                            "retry_after_s": retry,
                            "request_id": rid,
                        },
                        headers={"Retry-After": f"{retry:.3f}"},
                    )
                else:
                    logger.exception("request %s failed", rid)
                    client.recorder.record(
                        "server_error", rid, error=type(e).__name__,
                    )
                    client.recorder.trigger("server_error")
                    self._reply(500, {"error": str(e), "request_id": rid})
            else:
                body = {k: result[k] for k in fields if k in result}
                body["request_id"] = rid
                # Which batching served this (flush vs continuous) + slot
                # occupancy on decode replicas: one consistent status read.
                st = client.batcher.status()
                body["batching"] = {
                    "mode": st["mode"],
                    **({"slots": st["slots"], "slots_active": st["slots_active"]}
                       if "slots" in st else {}),
                }
                phases = getattr(fut, "phases", None)
                if phases is not None:
                    body["phases"] = {
                        k: v * 1e3 for k, v in phases.items()  # ms
                    }
                self._reply(200, body)

    server = ThreadingHTTPServer((host, port), Handler)
    logger.info("serving on http://%s:%d", *server.server_address)
    return server
