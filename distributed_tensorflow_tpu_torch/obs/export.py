"""Prometheus text-format exposition (format 0.0.4) for the obs layer.

``GET /metrics?format=prom`` renders every ``ServeMetrics`` family — the
cumulative counters/gauges, native Prometheus histograms cut from the
windowed-bucket cumulative counts (monotone across scrapes by
construction), quantile gauges from the sample-ring summaries, the
trailing-window rate/quantile gauges, and (when configured) the SLO
attainment/burn-rate/verdict and readiness-state families.

The renderer is deliberately dumb: build :class:`Family` rows, then
:func:`render` emits ``# HELP`` / ``# TYPE`` / sample lines with label
escaping per the exposition spec (``\\`` -> ``\\\\``, ``"`` -> ``\\"``,
newline -> ``\\n``).  Tests parse every emitted line back
(tests/test_serve_health.py) — if it doesn't round-trip, it doesn't ship.
"""

from __future__ import annotations

import math

_VERDICT_VALUE = {"ok": 0, "warn": 1, "page": 2}


def escape_label_value(v: str) -> str:
    return (
        str(v)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _fmt(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if math.isnan(f):
        return "NaN"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class Family:
    """One exposition family: a TYPE/HELP header plus sample lines.

    ``samples`` rows are ``(suffix, labels, value)`` — suffix is appended
    to the family name (``_bucket``/``_sum``/``_count`` for histograms,
    empty otherwise).
    """

    def __init__(self, name: str, mtype: str, help_: str):
        self.name = name
        self.mtype = mtype
        self.help = help_
        self.samples: list[tuple[str, dict, float]] = []

    def add(self, value, labels: dict | None = None, suffix: str = "") -> "Family":
        self.samples.append((suffix, labels or {}, value))
        return self


def render(families: list[Family]) -> str:
    lines = []
    for fam in families:
        if not fam.samples:
            continue
        lines.append(f"# HELP {fam.name} {fam.help}")
        lines.append(f"# TYPE {fam.name} {fam.mtype}")
        for suffix, labels, value in fam.samples:
            if labels:
                lbl = ",".join(
                    f'{k}="{escape_label_value(v)}"'
                    for k, v in sorted(labels.items())
                )
                lines.append(f"{fam.name}{suffix}{{{lbl}}} {_fmt(value)}")
            else:
                lines.append(f"{fam.name}{suffix} {_fmt(value)}")
    return "\n".join(lines) + "\n"


def histogram_family(
    name: str, help_: str, cumulatives: dict[tuple, dict]
) -> Family:
    """Native Prometheus histogram from ``WindowedHistogram.cumulative()``
    snapshots, one labelset per entry.  Bucket lines are CUMULATIVE counts
    (``le`` convention) ending at ``+Inf == _count`` — monotone across
    scrapes because the source counts are since-boot."""
    fam = Family(name, "histogram", help_)
    for labels_items, cum in cumulatives.items():
        labels = dict(labels_items)
        acc = 0
        for bound, count in zip(cum["bounds"], cum["counts"]):
            acc += count
            fam.add(acc, {**labels, "le": _fmt(bound)}, "_bucket")
        fam.add(cum["count"], {**labels, "le": "+Inf"}, "_bucket")
        fam.add(cum["sum"], labels, "_sum")
        fam.add(cum["count"], labels, "_count")
    return fam


def _summary_quantiles(name: str, help_: str, summaries: dict[tuple, dict],
                       scale: float = 1.0) -> Family:
    """Quantile gauges from a sample-ring ``Histogram.summary()`` dict
    (p50/p90/p99 + max) — the legacy estimator, kept alongside the
    bucketed histograms for continuity with the JSON snapshot."""
    fam = Family(name, "gauge", help_)
    for labels_items, summ in summaries.items():
        labels = dict(labels_items)
        for q, key in (("0.5", "p50"), ("0.9", "p90"), ("0.99", "p99")):
            fam.add(summ[key] * scale, {**labels, "quantile": q})
    return fam


def _split_layout_labels(snapshot: dict, value_key: str) -> list[tuple[dict, float]]:
    """``"<layout>/<x>" -> value`` labelled-counter snapshots into
    ``{layout=..., <value_key>=...}`` label pairs."""
    out = []
    for key, v in snapshot.items():
        layout, _, rest = key.partition("/")
        out.append(({"layout": layout, value_key: rest}, v))
    return out


def _kv_bytes_per_token_family(m) -> Family:
    """Per-dtype slot-cache bytes per cached token (models/quant.py int8
    KV halves-and-then-some this; the label keeps fp32 and int8 engines
    distinguishable on one dashboard)."""
    fam = Family("serve_kv_bytes_per_token", "gauge",
                 "slot-cache bytes one cached token occupies, by KV dtype")
    for dtype, v in m.kv_bytes_per_token.snapshot().items():
        fam.add(v, {"dtype": dtype})
    return fam


def serve_families(
    metrics, slo=None, health=None, memory=None, grid=None
) -> list[Family]:
    """Every ``ServeMetrics`` family (plus SLO + health + memory + compile
    grid when given) as exposition rows. ``memory`` is a
    :class:`~.memory.MemoryRegistry`; ``grid`` is an engine
    ``grid_status()`` digest dict."""
    m = metrics
    fams = [
        Family("serve_requests_total", "counter",
               "requests accepted into the batcher queue")
        .add(m.requests.value),
        Family("serve_rejected_total", "counter",
               "requests shed by backpressure").add(m.rejected.value),
        Family("serve_batches_total", "counter",
               "batches flushed to the engine").add(m.batches.value),
        Family("serve_errors_total", "counter",
               "batches that raised in the engine").add(m.errors.value),
        Family("serve_padded_rows_total", "counter",
               "executable rows burned on padding").add(m.padded_rows.value),
        Family("serve_queue_depth", "gauge",
               "requests waiting in the batcher").add(m.queue_depth.value),
        Family("serve_in_flight", "gauge",
               "batches dispatched but not yet fetched").add(m.in_flight.value),
        # Decode (continuous-batching) families — zero-valued but present
        # on scoring-only replicas, so dashboards need no per-mode wiring.
        Family("serve_tokens_total", "counter",
               "generated tokens delivered").add(m.tokens.value),
        Family("serve_decode_steps_total", "counter",
               "decode-step executions over the slot table")
        .add(m.decode_steps.value),
        Family("serve_slots_active", "gauge",
               "occupied KV-cache slots").add(m.slots_active.value),
        Family("serve_prefix_lookups_total", "counter",
               "admissions that consulted the prefix-cache trie")
        .add(m.prefix_lookups.value),
        Family("serve_prefix_hits_total", "counter",
               "admissions that matched a cached prompt prefix")
        .add(m.prefix_hits.value),
        Family("serve_prefix_tokens_saved_total", "counter",
               "prompt tokens skipped via cached KV pages")
        .add(m.prefix_tokens_saved.value),
        Family("serve_kv_pool_bytes", "gauge",
               "KV bytes held by the prefix-cache block pool")
        .add(m.kv_pool_bytes.value),
        _kv_bytes_per_token_family(m),
        # Speculative-decoding families (serve/spec.py).
        Family("serve_spec_draft_tokens_total", "counter",
               "speculative draft tokens proposed")
        .add(m.draft_tokens.value),
        Family("serve_spec_accepted_tokens_total", "counter",
               "speculative draft tokens accepted by verify")
        .add(m.accepted_tokens.value),
        Family("serve_spec_rejects_total", "counter",
               "verify steps that rejected at least one draft")
        .add(m.spec_rejects.value),
        Family("serve_spec_acceptance_ratio", "gauge",
               "lifetime draft-acceptance ratio (accepted/drafted)")
        .add(
            m.accepted_tokens.value / m.draft_tokens.value
            if m.draft_tokens.value else 0.0
        ),
    ]

    by_cause = Family("serve_rejected_by_cause_total", "counter",
                      "requests that never produced a result, by cause")
    for cause, v in m.rejected_by_cause.snapshot().items():
        by_cause.add(v, {"cause": cause})
    fams.append(by_cause)

    tier_hits = Family("serve_tier_hits_total", "counter",
                       "dispatches per batch tier")
    for tier, v in m.tier_hits.snapshot().items():
        tier_hits.add(v, {"tier": tier})
    fams.append(tier_hits)

    bucket_hits = Family("serve_bucket_hits_total", "counter",
                         "dispatches per sequence bucket")
    for bucket, v in m.bucket_hits.snapshot().items():
        bucket_hits.add(v, {"bucket": bucket})
    fams.append(bucket_hits)

    layout_tiers = Family("serve_layout_tier_hits_total", "counter",
                          "dispatches per mesh layout and batch tier")
    for labels, v in _split_layout_labels(m.layout_tier_hits.snapshot(), "tier"):
        layout_tiers.add(v, labels)
    fams.append(layout_tiers)

    layout_buckets = Family("serve_layout_bucket_hits_total", "counter",
                            "dispatches per mesh layout and sequence bucket")
    for labels, v in _split_layout_labels(
        m.layout_bucket_hits.snapshot(), "bucket"
    ):
        layout_buckets.add(v, labels)
    fams.append(layout_buckets)

    # Disaggregated-serving KV-page transfer families (serve/disagg.py),
    # role-labelled ("prefill" = chain exported, "decode" = chain adopted).
    kv_bytes = Family("serve_kv_transfer_bytes_total", "counter",
                      "KV-page bytes moved between engine roles")
    for role, v in m.kv_transfer_bytes.snapshot().items():
        kv_bytes.add(v, {"role": role})
    fams.append(kv_bytes)
    kv_secs = m.kv_transfer_seconds.snapshot()
    if kv_secs:
        fams.append(_summary_quantiles(
            "serve_kv_transfer_seconds",
            "per-transfer wall time quantiles by engine role",
            {(("role", role),): summ for role, summ in kv_secs.items()},
        ))

    # Live stream-migration outcomes (serve/disagg.py): "adopted" and
    # "rejected" count on the receiving replica, "migrated" and
    # "readopted" on the exporting one.
    migrations = Family("serve_stream_migrations_total", "counter",
                        "live decode-stream migrations by outcome")
    for outcome, v in m.stream_migrations.snapshot().items():
        migrations.add(v, {"outcome": outcome})
    fams.append(migrations)

    # Priority-preemptive scheduling (serve/batcher.py): parks by how they
    # went ("paged"/"pageless"/aborts) and live queue depth per priority
    # class (label "0" is the most urgent).
    preempts = Family("serve_preemptions_total", "counter",
                      "slot preemptions (parks + aborted parks) by reason")
    for reason, v in m.preemptions.snapshot().items():
        preempts.add(v, {"reason": reason})
    fams.append(preempts)
    sched_depth = Family("serve_sched_queue_depth", "gauge",
                         "queued requests per priority class")
    for cls, v in m.sched_queue_depth.snapshot().items():
        sched_depth.add(v, {"class": cls})
    fams.append(sched_depth)

    # Sample-ring quantile gauges (legacy estimator; ms families in the
    # JSON snapshot stay seconds here — exposition is SI).
    fams.append(_summary_quantiles(
        "serve_latency_quantile_seconds",
        "submit->reply latency quantiles (sample-ring estimator)",
        {(): m.latency.summary()},
    ))
    fams.append(_summary_quantiles(
        "serve_batch_occupancy_rows",
        "rows per flushed batch, quantiles",
        {(): m.batch_occupancy.summary()},
    ))
    fams.append(_summary_quantiles(
        "serve_tier_occupancy_rows",
        "rows per dispatch by batch tier, quantiles",
        {
            (("tier", tier),): summ
            for tier, summ in m.tier_occupancy.snapshot().items()
        },
    ))
    phase_summaries = {
        (("phase", name),): summ for name, summ in m.phase.snapshot().items()
    }
    fams.append(_summary_quantiles(
        "serve_phase_quantile_seconds",
        "per-request phase latency quantiles (sample-ring estimator)",
        phase_summaries,
    ))
    # Per-token latency quantiles (decode path; per-token samples also ride
    # the phase family as "decode_step").
    if m.ttft.summary()["count"]:
        fams.append(_summary_quantiles(
            "serve_ttft_quantile_seconds",
            "submit->first-token latency quantiles",
            {(): m.ttft.summary()},
        ))
    if m.itl.summary()["count"]:
        fams.append(_summary_quantiles(
            "serve_itl_quantile_seconds",
            "inter-token latency quantiles",
            {(): m.itl.summary()},
        ))

    if getattr(m, "windowed", False):
        # Native histograms from the windowed families' cumulative counts.
        fams.append(histogram_family(
            "serve_latency_seconds",
            "submit->reply latency (bucketed, cumulative since boot)",
            {(): m.latency_w.cumulative()},
        ))
        fams.append(histogram_family(
            "serve_phase_seconds",
            "per-request phase latency (bucketed, cumulative since boot)",
            {
                (("phase", str(label)),): m.phase_w.get(label).cumulative()
                for label in m.phase_w.labels()
            },
        ))
        # Trailing-window rate + quantile gauges.
        rates = Family("serve_window_rate", "gauge",
                       "trailing-window request rates by series (per second)")
        lat_q = Family("serve_window_latency_seconds", "gauge",
                       "trailing-window latency quantiles")
        for w in m.WINDOWS_S:
            wl = f"{w:g}s"
            for series, c in (
                ("requests", m.requests_w), ("ok", m.ok_w),
                ("rejected", m.rejected_w), ("failed", m.bad_w),
                ("tokens", m.tokens_w), ("spec_drafted", m.drafted_w),
                ("spec_accepted", m.accepted_w),
            ):
                rates.add(c.rate(w), {"window": wl, "series": series})
            summ = m.latency_w.window_summary(w)
            for q, key in (("0.5", "p50"), ("0.9", "p90"), ("0.99", "p99")):
                lat_q.add(summ[key], {"window": wl, "quantile": q})
        fams.extend([rates, lat_q])

    if slo is not None:
        rep = slo.report()
        att = Family("serve_slo_attainment", "gauge",
                     "fraction of good events per SLO and window")
        burn = Family("serve_slo_burn_rate", "gauge",
                      "error-budget burn multiple per SLO and window")
        verd = Family("serve_slo_verdict", "gauge",
                      "per-SLO verdict (0=ok 1=warn 2=page)")
        for s in rep["slos"]:
            for wl, row in s["windows"].items():
                att.add(row["attainment"], {"slo": s["name"], "window": wl})
                burn.add(row["burn_rate"], {"slo": s["name"], "window": wl})
            verd.add(_VERDICT_VALUE[s["verdict"]], {"slo": s["name"]})
        fams.extend([att, burn, verd])

    if health is not None:
        from distributed_tensorflow_tpu_torch.obs.health import (
            SERVING_STATES,
            STATES,
        )

        state, _ = health.state()
        hs = Family("serve_health_state", "gauge",
                    "readiness state (one-hot)")
        for s in STATES:
            hs.add(1 if s == state else 0, {"state": s})
        fams.append(hs)
        fams.append(
            Family("serve_ready", "gauge",
                   "1 when /healthz answers 200")
            .add(1 if state in SERVING_STATES else 0)
        )

    if memory is not None:
        snap = memory.snapshot()
        dtypes = snap.get("component_dtypes", {})
        hbm = Family("hbm_reserved_bytes", "gauge",
                     "accounted device-memory reservation per component")
        for comp, nbytes in snap["components"].items():
            lbl = {"component": comp}
            # Quantized serving: components that declared a storage dtype
            # carry it, so "how much of HBM is int8" is one PromQL sum.
            if comp in dtypes:
                lbl["dtype"] = dtypes[comp]
            hbm.add(nbytes, lbl)
        fams.append(hbm)
        released = Family("hbm_released_bytes_total", "counter",
                          "device bytes released per component since boot")
        for comp, nbytes in snap["released"].items():
            released.add(nbytes, {"component": comp})
        fams.append(released)
        saved = Family(
            "hbm_bytes_saved_vs_fp32", "gauge",
            "bytes saved vs an fp32 baseline per quantized component",
        )
        for comp, nbytes in snap.get("bytes_saved_vs_fp32", {}).items():
            saved.add(nbytes, {"component": comp})
        fams.append(saved)
        in_use = Family("hbm_device_bytes_in_use", "gauge",
                        "backend-reported bytes_in_use per local device")
        limit = Family("hbm_device_bytes_limit", "gauge",
                       "backend-reported byte limit per local device")
        for row in snap["devices"]:
            if row.get("reported"):
                lbl = {"device": str(row["device"]),
                       "platform": row["platform"]}
                in_use.add(row["bytes_in_use"], lbl)
                limit.add(row["bytes_limit"], lbl)
        fams.extend([in_use, limit])

    if grid is not None:
        cells = Family("serve_compile_cells", "gauge",
                       "AOT grid cells by compile state")
        cells.add(grid["cells_compiled"], {"state": "compiled"})
        cells.add(grid["cells_failed"], {"state": "failed"})
        cells.add(
            max(grid["cells_total"] - grid["cells_compiled"]
                - grid["cells_failed"], 0),
            {"state": "pending"},
        )
        fams.append(cells)
        fams.append(
            Family("serve_compile_seconds_total", "counter",
                   "cumulative AOT grid compile wall time")
            .add(grid["compile_seconds_total"])
        )
        fams.append(
            Family("serve_grid_warm_fraction", "gauge",
                   "fraction of planned AOT grid cells compiled")
            .add(grid["warm_fraction"])
        )
    return fams


def prometheus_text(metrics, slo=None, health=None, memory=None,
                    grid=None) -> str:
    """The ``GET /metrics?format=prom`` body."""
    return render(serve_families(
        metrics, slo=slo, health=health, memory=memory, grid=grid
    ))


#: content type for the exposition reply
PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
