"""shardcheck: mesh-axis and serving-layout validation before any device exists.

Two halves:

* **Static (SC001)** — every literal axis name appearing in a
  ``PartitionSpec``/``P(...)`` constructor, a collective (JAX's ``lax``
  forms — ``psum``/``pmean``/``all_to_all``/... — and the port's
  ``parallel/collectives.py`` ones: ``psum``, ``ppermute``, ``all_to_all``,
  ``all_gather``, ``axis_index``, ``axis_size``, ...), or a
  ``mesh.shape[...]`` / ``mesh.shape.get(...)`` lookup must be declared in
  ``AXIS_ORDER`` in ``parallel/mesh.py``. The axis vocabulary is read from
  the *analyzed tree's own* ``parallel/mesh.py`` AST, so this pass needs no
  imports and follows the code under analysis, not the installed package.

* **Config sweep (SC002, full mode only)** — re-run the tp/ep/pp
  divisibility arithmetic that ``serve/engine.py::_serve_config`` enforces
  at runtime, over the default CLI serving configs (every BERT and LM
  preset from ``cli/train.py``) crossed with the serving mesh layouts
  (``tests/test_torch_serve_mesh.py``'s, the CLI default and the fallback
  probes), on an 8-device topology. Each
  (preset, layout) cell must resolve to one of three *designed* outcomes:
  ``serves``, ``falls_back`` (plan_serve_mesh warn-not-crash), or
  ``rejects`` (clean ValueError at startup). Anything else — an unexpected
  exception type, or a layout the planner accepts but the engine then dies
  on — is a finding: it would surface as a raw error deep in the engine's
  build on real hardware.
  Decode cells that serve are further crossed with the prefix-cache,
  speculation, and disaggregated role-split plans (``DISAGG_VARIANTS`` →
  ``parallel/mesh.py::plan_disagg_mesh``), each under the same
  plan-or-clean-ValueError contract. Every serving cell (BERT and
  decode) is also crossed with ``QUANT_VARIANTS`` — the weight/KV
  storage-dtype plans from ``_plan_quant`` — so an unsupported dtype or
  an int8 × pipeline combination rejects at startup instead of dying
  when the params quantize on the card.

Port of the JAX package's ``analysis/shardcheck.py``: the same variants,
layouts, outcomes and messages, over the port's planners.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Iterable

from .findings import Finding, ScopeIndex, SourceFile, dotted_name

__all__ = ["run", "run_config_sweep", "CHECKS", "declared_axes", "DEFAULT_LAYOUTS"]

CHECKS = ("SC001", "SC002")

_SPEC_CTORS = {"P", "PartitionSpec", "jax.sharding.PartitionSpec"}
_COLLECTIVES = {
    "lax.psum",
    "lax.pmean",
    "lax.pmax",
    "lax.pmin",
    "lax.axis_index",
    "lax.all_gather",
    "lax.all_to_all",
    "lax.ppermute",
    "lax.psum_scatter",
    "jax.lax.psum",
    "jax.lax.pmean",
    "jax.lax.pmax",
    "jax.lax.pmin",
    "jax.lax.axis_index",
    "jax.lax.all_gather",
    "jax.lax.all_to_all",
    "jax.lax.ppermute",
    "jax.lax.psum_scatter",
}
# The port's collectives (parallel/collectives.py), called bare, as
# ``coll.X`` or as ``collectives.X``: the argument index of the axis name.
_PORT_COLLECTIVE_AXIS_ARG = {
    "psum": 1, "pmean_tree": 1, "psum_tree": 1, "ppermute": 1,
    "all_to_all": 1, "all_gather": 1, "axis_index": 0, "axis_size": 0,
}
_PORT_COLLECTIVES = {
    f"{mod}{name}": pos
    for name, pos in _PORT_COLLECTIVE_AXIS_ARG.items()
    for mod in ("", "coll.", "collectives.")
}

# Prefix-cache / chunked-prefill configurations crossed into every decode
# cell that serves: (prefix_cache_mb, block_tokens). The 0.0 row is the
# cache-disabled plan (must stay a no-op, never a reject) and the rest
# exercise the byte-budget -> page-count arithmetic per TP shard layout.
PREFIX_CACHE_VARIANTS: tuple[tuple[float, int], ...] = (
    (0.0, 16),
    (8.0, 16),
    (8.0, 32),
)

# Speculative-decoding configurations crossed into every decode cell that
# serves: (spec_tokens, min_match, max_new_tokens). The 0 row is the
# spec-off plan (must stay a no-op, never a reject); the oversized rows
# must reject with a clean ValueError at plan time (a draft wider than the
# generation budget or the position table would be a runtime shape error).
SPEC_VARIANTS: tuple[tuple[int, int, int], ...] = (
    (0, 2, 32),
    (4, 2, 32),
    (8, 3, 32),
    (32, 2, 32),   # spec_tokens == max_new_tokens: must reject
)

# Quantized-serving configurations crossed into EVERY serving cell (BERT
# one-shot and causal-LM decode): (weight_dtype, kv_dtype). The
# (None, None) row is the quant-off plan (must resolve to the config
# dtype, never reject); int8 rows exercise the per-channel weight /
# per-position KV storage plans across TP shardings; the fp8 row is an
# unsupported dtype that must reject with a clean ValueError at plan
# time. kv_dtype is ignored for BERT cells (no KV cache there).
QUANT_VARIANTS: tuple[tuple[str | None, str | None], ...] = (
    (None, None),
    ("int8", "int8"),
    ("int8", None),
    (None, "int8"),
    ("bfloat16", "bfloat16"),
    ("fp8", None),   # unsupported: must reject with a clean ValueError
)

# Disaggregated-serving role splits crossed into every decode cell that
# serves: (prefill_devices, prefill_tp, decode_tp) over the sweep's
# 8-device topology. plan_disagg_mesh holds the same plan-or-clean-
# ValueError contract as plan_serve_mesh: oversized asks shrink with a
# note, non-dividing role tp drops to the largest divisor, and only
# genuinely invalid inputs (the 0 row) may reject — anything else raised
# would be a raw startup crash on a real role split.
DISAGG_VARIANTS: tuple[tuple[int, int, int], ...] = (
    (-1, 1, 1),  # auto half split, no role tp
    (-1, 2, 2),  # tp on both roles
    (2, 2, 4),   # explicit prefill subset, asymmetric tp
    (8, 1, 1),   # prefill wants the whole slice: must shrink, never crash
    (-1, 3, 1),  # non-dividing prefill tp: must fall back to a divisor
    (0, 1, 1),   # invalid: must reject with a clean ValueError
)

# Priority-scheduling configurations swept once per run (the scheduler
# plan is layout-independent): (sched, preempt, preempt_margin_ms,
# default_priority). Every combination must either plan (BatcherConfig
# constructs) or reject with a clean ValueError at config time — a knob
# combo that only dies when the decode loop first preempts would strand
# live streams. The invalid rows pin the designed rejections: preemption
# without EDF (FIFO cannot order deadline waiters), an unknown policy,
# a negative margin, and a negative default class.
SCHED_VARIANTS: tuple[tuple[str, bool, float, int], ...] = (
    ("fifo", False, 20.0, 1),   # the defaults: must plan
    ("edf", False, 20.0, 0),    # ordering without preemption: must plan
    ("edf", True, 20.0, 1),     # the full feature: must plan
    ("edf", True, 0.0, 0),      # zero margin (preempt at the deadline)
    ("fifo", True, 20.0, 1),    # preempt needs edf: must reject
    ("lifo", False, 20.0, 1),   # unknown policy: must reject
    ("edf", True, -5.0, 1),     # negative margin: must reject
    ("edf", False, 20.0, -1),   # negative default class: must reject
)

# Mesh layouts exercised by the serving-mesh tests plus the CLI default
# and the documented fallback probes, as (tp, pp, ep) on 8 devices.
DEFAULT_LAYOUTS: tuple[tuple[int, int, int], ...] = (
    (1, 1, 1),  # cli/serve.py defaults (dp over all chips)
    (2, 1, 1),
    (4, 1, 1),  # test_serve_mesh TP parity layout
    (1, 2, 1),  # PP layout (dp4-pp2)
    (1, 1, 4),  # EP layout (dp2-ep4)
    (2, 2, 2),  # combined tp2-pp2-ep2
    (16, 1, 1),  # oversized: must fall back, never crash
    (3, 1, 1),  # non-dividing: must fall back, never crash
)


def declared_axes(sources: Iterable[SourceFile]) -> set[str]:
    """Extract AXIS_ORDER from the analyzed tree's parallel/mesh.py."""
    for src in sources:
        if not src.rel.endswith("parallel/mesh.py"):
            continue
        for node in ast.walk(src.tree):
            if (
                isinstance(node, ast.Assign)
                and any(
                    isinstance(t, ast.Name) and t.id == "AXIS_ORDER"
                    for t in node.targets
                )
                and isinstance(node.value, (ast.Tuple, ast.List))
            ):
                return {
                    elt.value
                    for elt in node.value.elts
                    if isinstance(elt, ast.Constant) and isinstance(elt.value, str)
                }
    return set()


def run(sources: Iterable[SourceFile]) -> list[Finding]:
    sources = list(sources)
    axes = declared_axes(sources)
    if not axes:
        return []  # nothing to validate against (fixture trees without mesh.py)
    findings: list[Finding] = []
    for src in sources:
        scopes = ScopeIndex(src.tree)
        for node in ast.walk(src.tree):
            for line, name in _literal_axis_uses(node):
                if name not in axes:
                    findings.append(
                        Finding(
                            check="SC001",
                            path=src.rel,
                            line=line,
                            scope=scopes.lookup(line),
                            message=(
                                f"axis name '{name}' is not declared in "
                                f"parallel/mesh.py AXIS_ORDER {sorted(axes)}"
                            ),
                        )
                    )
    return findings


def _literal_axis_uses(node: ast.AST) -> list[tuple[int, str]]:
    out: list[tuple[int, str]] = []
    if isinstance(node, ast.Call):
        callee = dotted_name(node.func) or ""
        if callee in _SPEC_CTORS:
            for arg in node.args:
                out.extend(_axis_literals(arg))
        elif callee in _COLLECTIVES and len(node.args) >= 2:
            out.extend(_axis_literals(node.args[1]))
        elif callee in _COLLECTIVES:
            for kw in node.keywords:
                if kw.arg in {"axis_name", "axis"}:
                    out.extend(_axis_literals(kw.value))
        elif callee in _PORT_COLLECTIVES:
            pos = _PORT_COLLECTIVES[callee]
            if len(node.args) > pos:
                out.extend(_axis_literals(node.args[pos]))
            for kw in node.keywords:
                if kw.arg in {"axis_name", "axis"}:
                    out.extend(_axis_literals(kw.value))
        elif (
            isinstance(node.func, ast.Attribute)
            and node.func.attr == "get"
            and (dotted_name(node.func.value) or "").endswith(".shape")
            and node.args
        ):
            out.extend(_axis_literals(node.args[0]))
    elif (
        isinstance(node, ast.Subscript)
        and (dotted_name(node.value) or "").endswith(".shape")
    ):
        out.extend(_axis_literals(node.slice))
    return out


def _axis_literals(expr: ast.expr) -> list[tuple[int, str]]:
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return [(expr.lineno, expr.value)]
    if isinstance(expr, (ast.Tuple, ast.List)):
        out: list[tuple[int, str]] = []
        for elt in expr.elts:
            out.extend(_axis_literals(elt))
        return out
    return []


# ---------------------------------------------------------------- SC002


def run_config_sweep(
    n_devices: int = 8,
    layouts: Iterable[tuple[int, int, int]] = DEFAULT_LAYOUTS,
) -> tuple[list[Finding], list[dict]]:
    """Cross BERT presets with serving layouts; classify every cell.

    Returns ``(findings, matrix)`` where matrix rows record the designed
    outcome per cell (for the JSON report). Imports the package lazily —
    this is the only part of shardcheck that needs torch importable.
    """
    from ..cli.train import PRESETS
    from ..models.bert import BertConfig
    from ..models.causal_lm import CausalLMConfig
    from ..parallel.mesh import plan_disagg_mesh
    from ..serve.engine import (
        BertInferenceEngine,
        CausalLMEngine,
        plan_serve_mesh,
    )

    findings: list[Finding] = []
    matrix: list[dict] = []
    # Scheduler knob sweep (serve/batcher.py): layout-independent, so it
    # runs once, not per cell. Each variant must construct a BatcherConfig
    # or reject with a clean ValueError; the batcher classes that cannot
    # honor a policy (DynamicBatcher reorders nothing, flush admission
    # preempts nothing) must reject the config at BUILD time, before any
    # scheduler thread exists.
    from ..serve.batcher import (
        BatcherConfig,
        ContinuousBatcher,
        DynamicBatcher,
    )

    class _NullEngine:  # attribute surface only; never dispatched
        slots = 1
        max_batch = 1

    # "outcome" keeps the cell uniform with the layout cells for the
    # sweep summary; the per-variant plans/rejects verdicts live inside.
    sched_cell: dict = {"sweep": "sched", "outcome": "sched_variants",
                        "variants": []}
    for sched, preempt, margin, default_pri in SCHED_VARIANTS:
        row: dict = {
            "sched": sched, "preempt": preempt,
            "preempt_margin_ms": margin, "default_priority": default_pri,
        }
        try:
            cfg = BatcherConfig(
                sched=sched, preempt=preempt, preempt_margin_ms=margin,
                default_priority=default_pri,
            )
        except ValueError as exc:
            row["rejects"] = str(exc)
            sched_cell["variants"].append(row)
            continue
        except Exception as exc:
            findings.append(
                Finding(
                    check="SC002",
                    path="distributed_tensorflow_tpu_torch/serve/batcher.py",
                    line=0,
                    scope="BatcherConfig",
                    message=(
                        f"sched variant sched={sched} preempt={preempt} "
                        f"margin={margin} default_priority={default_pri} "
                        f"raised {type(exc).__name__} instead of a clean "
                        f"ValueError: {exc}"
                    ),
                )
            )
            row["raised"] = type(exc).__name__
            sched_cell["variants"].append(row)
            continue
        row["plans"] = True
        if cfg.sched != "fifo":
            # The flush batcher holds no slots: a non-FIFO policy must be
            # rejected before its flusher thread ever starts.
            try:
                DynamicBatcher(lambda p: [{} for _ in p], cfg)
                findings.append(
                    Finding(
                        check="SC002",
                        path="distributed_tensorflow_tpu_torch/serve/batcher.py",
                        line=0,
                        scope="DynamicBatcher",
                        message=(
                            f"DynamicBatcher accepted sched={cfg.sched!r} "
                            f"— the flush batcher cannot reorder or "
                            f"preempt and must reject at build time"
                        ),
                    )
                )
                row["dynamic_accepts"] = True
            except ValueError as exc:
                row["dynamic_rejects"] = str(exc)
        if cfg.preempt:
            # Flush admission only ever fills an empty table: preemption
            # there must be a clean build-time rejection too.
            try:
                ContinuousBatcher(_NullEngine(), cfg, admission="flush")
                findings.append(
                    Finding(
                        check="SC002",
                        path="distributed_tensorflow_tpu_torch/serve/batcher.py",
                        line=0,
                        scope="ContinuousBatcher",
                        message=(
                            "ContinuousBatcher accepted preempt=True with "
                            "flush admission — there is never an occupied "
                            "slot to preempt for a waiter"
                        ),
                    )
                )
                row["flush_accepts"] = True
            except ValueError as exc:
                row["flush_rejects"] = str(exc)
        sched_cell["variants"].append(row)
    matrix.append(sched_cell)
    # Every preset with a transformer serving path: BERT one-shot scoring
    # AND the causal-LM decode engines — a decode layout that only dies at
    # executable build time is exactly the raw-XLA-error class SC002 exists
    # to catch.
    presets = {
        name: (wl, BertConfig, BertInferenceEngine)
        for name, wl in PRESETS.items()
        if "bert" in name.lower()
    }
    presets.update({
        name: (wl, CausalLMConfig, CausalLMEngine)
        for name, wl in PRESETS.items()
        if name.lower().startswith("lm")
    })
    for name, (wl, config_cls, engine_cls) in presets.items():
        # Mirror cli/serve.py config reconstruction: config-class defaults
        # with the preset's geometry overrides. max_position/dtype don't
        # affect the divisibility arithmetic under test.
        overrides: dict = {}
        if wl.bert_layers:
            overrides["num_layers"] = wl.bert_layers
        if wl.bert_hidden:
            overrides.update(
                hidden_size=wl.bert_hidden, intermediate_size=4 * wl.bert_hidden
            )
        if wl.bert_vocab:
            overrides["vocab_size"] = wl.bert_vocab
        if getattr(wl, "moe_experts", 0) and config_cls is BertConfig:
            overrides["moe_experts"] = wl.moe_experts
        base_cfg = config_cls(**overrides)

        for tp, pp, ep in layouts:
            cell = {"preset": name, "tp": tp, "pp": pp, "ep": ep}
            try:
                spec, fell_back = plan_serve_mesh(
                    tp=tp, pp=pp, ep=ep, n_devices=n_devices
                )
            except Exception as exc:  # planner must never raise
                findings.append(
                    Finding(
                        check="SC002",
                        path="distributed_tensorflow_tpu_torch/serve/engine.py",
                        line=0,
                        scope="plan_serve_mesh",
                        message=(
                            f"planner raised {type(exc).__name__} for layout "
                            f"tp={tp} pp={pp} ep={ep} on {n_devices} devices "
                            f"(must warn and fall back): {exc}"
                        ),
                    )
                )
                cell["outcome"] = f"planner-raised:{type(exc).__name__}"
                matrix.append(cell)
                continue
            if fell_back:
                cell["outcome"] = "falls_back"
                matrix.append(cell)
                continue
            cfg = base_cfg
            if pp > 1 and config_cls is BertConfig:
                # cli/serve.py sets pipeline_parallel from --pp at load time
                # (the decoder config has no pipeline field — its engine
                # rejects pp>1 outright, which is the outcome under test).
                cfg = BertConfig(**{**overrides, "pipeline_parallel": pp})
            try:
                engine_cls._serve_config(cfg, tp=tp, ep=ep, pp=pp)
                cell["outcome"] = "serves"
                # Quantized-serving plan (engine _plan_quant): every
                # weight/kv dtype combination on a serving cell must
                # normalize to a storage plan or reject with a clean
                # ValueError — a dtype that only dies when the params
                # quantize or the cache allocates would be a raw XLA
                # error on metal.
                cell["quant"] = qplans = []
                for wd, kd in QUANT_VARIANTS:
                    qrow: dict = {"weight_dtype": wd, "kv_dtype": kd}
                    try:
                        if engine_cls is CausalLMEngine:
                            w, k = engine_cls._plan_quant(
                                cfg, tp=tp, weight_dtype=wd, kv_dtype=kd
                            )
                            qrow.update(weights=w, kv=k)
                        else:
                            w = engine_cls._plan_quant(
                                cfg, tp=tp, ep=ep, pp=pp, weight_dtype=wd
                            )
                            qrow.update(weights=w)
                    except ValueError as exc:
                        qrow["rejects"] = str(exc)
                    except Exception as exc:
                        findings.append(
                            Finding(
                                check="SC002",
                                path=(
                                    "distributed_tensorflow_tpu_torch/"
                                    "serve/engine.py"
                                ),
                                line=0,
                                scope=(
                                    f"{engine_cls.__name__}._plan_quant"
                                ),
                                message=(
                                    f"quant plan weight={wd} kv={kd} on "
                                    f"preset '{name}' layout tp={tp} "
                                    f"pp={pp} raised "
                                    f"{type(exc).__name__} instead of a "
                                    f"clean ValueError: {exc}"
                                ),
                            )
                        )
                        qrow["raised"] = type(exc).__name__
                    qplans.append(qrow)
                if engine_cls is CausalLMEngine:
                    # Cross the serving cell with the prefix-cache budget
                    # arithmetic (serve/kvpool.py + engine page pool): each
                    # variant must plan a page count or reject with a clean
                    # ValueError — a budget that only dies when the pool
                    # tensor is allocated would be a raw XLA OOM on metal.
                    cell["prefix_cache"] = plans = []
                    for mb, bt in PREFIX_CACHE_VARIANTS:
                        try:
                            n_blocks, bpb = engine_cls._plan_prefix_cache(
                                cfg, tp=tp, prefix_cache_mb=mb,
                                block_tokens=bt,
                            )
                            plans.append({
                                "mb": mb, "block_tokens": bt,
                                "blocks": n_blocks,
                                "bytes_per_block": bpb,
                            })
                        except ValueError as exc:
                            plans.append({
                                "mb": mb, "block_tokens": bt,
                                "rejects": str(exc),
                            })
                        except Exception as exc:
                            findings.append(
                                Finding(
                                    check="SC002",
                                    path=(
                                        "distributed_tensorflow_tpu_torch/"
                                        "serve/engine.py"
                                    ),
                                    line=0,
                                    scope=(
                                        f"{engine_cls.__name__}"
                                        "._plan_prefix_cache"
                                    ),
                                    message=(
                                        f"prefix-cache plan mb={mb} "
                                        f"block_tokens={bt} on preset "
                                        f"'{name}' layout tp={tp} raised "
                                        f"{type(exc).__name__} instead of "
                                        f"a clean ValueError: {exc}"
                                    ),
                                )
                            )
                            plans.append({
                                "mb": mb, "block_tokens": bt,
                                "raised": type(exc).__name__,
                            })
                    # Same contract for the speculative-decoding plan
                    # (serve/spec.py + the verify grid cell): each variant
                    # plans a draft width or rejects with a clean
                    # ValueError at startup, never a runtime shape error.
                    cell["speculation"] = splans = []
                    for sk, mm, mnt in SPEC_VARIANTS:
                        try:
                            k = engine_cls._plan_spec(
                                cfg, tp=tp, spec_tokens=sk,
                                min_match=mm, max_new_tokens=mnt,
                            )
                            splans.append({
                                "spec_tokens": sk, "min_match": mm,
                                "max_new_tokens": mnt, "k": k,
                            })
                        except ValueError as exc:
                            splans.append({
                                "spec_tokens": sk, "min_match": mm,
                                "max_new_tokens": mnt,
                                "rejects": str(exc),
                            })
                        except Exception as exc:
                            findings.append(
                                Finding(
                                    check="SC002",
                                    path=(
                                        "distributed_tensorflow_tpu_torch/"
                                        "serve/engine.py"
                                    ),
                                    line=0,
                                    scope=(
                                        f"{engine_cls.__name__}"
                                        "._plan_spec"
                                    ),
                                    message=(
                                        f"speculation plan k={sk} "
                                        f"min_match={mm} on preset "
                                        f"'{name}' layout tp={tp} raised "
                                        f"{type(exc).__name__} instead of "
                                        f"a clean ValueError: {exc}"
                                    ),
                                )
                            )
                            splans.append({
                                "spec_tokens": sk, "min_match": mm,
                                "max_new_tokens": mnt,
                                "raised": type(exc).__name__,
                            })
                    # And the disaggregated role split (parallel/mesh.py
                    # plan_disagg_mesh): every role-split variant on this
                    # topology must return a plan (fallbacks noted) or
                    # reject with a clean ValueError — a split that only
                    # dies when the role engines build would be a raw
                    # startup crash on a disaggregated fleet.
                    cell["disagg"] = dplans = []
                    for pd, ptp, dtp in DISAGG_VARIANTS:
                        try:
                            plan = plan_disagg_mesh(
                                n_devices, prefill_devices=pd,
                                prefill_tp=ptp, decode_tp=dtp,
                            )
                            dplans.append({
                                "prefill_devices": pd, "prefill_tp": ptp,
                                "decode_tp": dtp,
                                "prefill": len(plan.prefill_device_ids),
                                "decode": len(plan.decode_device_ids),
                                "fell_back": plan.fell_back,
                                "notes": len(plan.notes),
                            })
                        except ValueError as exc:
                            dplans.append({
                                "prefill_devices": pd, "prefill_tp": ptp,
                                "decode_tp": dtp, "rejects": str(exc),
                            })
                        except Exception as exc:
                            findings.append(
                                Finding(
                                    check="SC002",
                                    path=(
                                        "distributed_tensorflow_tpu_torch/"
                                        "parallel/mesh.py"
                                    ),
                                    line=0,
                                    scope="plan_disagg_mesh",
                                    message=(
                                        f"disagg role split "
                                        f"prefill_devices={pd} "
                                        f"prefill_tp={ptp} decode_tp={dtp} "
                                        f"on {n_devices} devices raised "
                                        f"{type(exc).__name__} instead of "
                                        f"a plan or a clean ValueError: "
                                        f"{exc}"
                                    ),
                                )
                            )
                            dplans.append({
                                "prefill_devices": pd, "prefill_tp": ptp,
                                "decode_tp": dtp,
                                "raised": type(exc).__name__,
                            })
            except ValueError as exc:
                # Designed loud rejection (clean startup error, no XLA trace).
                cell["outcome"] = "rejects"
                cell["reason"] = str(exc)
            except Exception as exc:
                findings.append(
                    Finding(
                        check="SC002",
                        path="distributed_tensorflow_tpu_torch/serve/engine.py",
                        line=0,
                        scope=f"{engine_cls.__name__}._serve_config",
                        message=(
                            f"layout tp={tp} pp={pp} ep={ep} on preset '{name}' "
                            f"raised {type(exc).__name__} instead of a clean "
                            f"ValueError: {exc}"
                        ),
                    )
                )
                cell["outcome"] = f"raised:{type(exc).__name__}"
            matrix.append(cell)
    return findings, matrix
