"""Readiness-aware health: the liveness/readiness contract behind /healthz.

Lifecycle (explicit, operator/stack-driven)::

    starting ──► ready ──► draining ──► closed
        └──────────────────────┴──────────► closed

plus one *derived* overlay: a ``ready`` server reports **degraded** while
it is saturated (queue at bound, or backpressure sheds in the trailing
window) or while its SLO burn-rate verdict is ``page``.  Degraded is
computed at read time, never stored — the server recovers to ``ready``
the moment the pressure clears, with no transition to forget.

The HTTP mapping (the contract the fleet router polls — see
docs/DEPLOY.md): ``ready`` → 200; every other state → 503 with
``{"status": "<state>", "reason": ...}`` so a probe can distinguish
"warming up" from "drain me" from "dead".

The tracker owns NO thread: it reads a ``status_fn`` (the batcher's
live counters), the windowed ``rejected_w`` family, and the SLO verdict
on demand.  Explicit transitions are validated — ``mark_ready`` on a
draining server is a programming error, not a silent un-drain.
``mark_closed`` is idempotent (close paths race benignly).
"""

from __future__ import annotations

import threading
import time

STATES = ("starting", "ready", "degraded", "draining", "closed")

# Explicit-state machine; "degraded" is derived and never stored.
_ALLOWED = {
    "starting": {"ready", "draining", "closed"},
    "ready": {"draining", "closed"},
    "draining": {"closed"},
    "closed": set(),
}

#: states that answer 200 on /healthz
SERVING_STATES = ("ready",)


def http_status(state: str) -> int:
    return 200 if state in SERVING_STATES else 503


class HealthTracker:
    """Readiness state for one serving process.

    ``status_fn() -> dict`` supplies the live stack view (the batcher's
    ``status()``): ``closed`` (bool), ``queue_depth``, ``max_queue``,
    ``in_flight``.  ``metrics`` supplies ``rejected_w`` (windowed
    backpressure counter); ``slo`` supplies ``verdict()``.  All three are
    optional — a tracker with none is a plain explicit state machine.
    """

    def __init__(
        self,
        *,
        status_fn=None,
        metrics=None,
        slo=None,
        saturation_window_s: float = 10.0,
        clock=time.monotonic,
        warmup_fn=None,
        warmup_target: float = 1.0,
        recorder=None,
    ):
        self._lock = threading.Lock()
        self._state = "starting"
        self._status_fn = status_fn
        self._metrics = metrics
        self._slo = slo
        self._saturation_window_s = float(saturation_window_s)
        self._clock = clock
        # Warmup-gated readiness: ``warmup_fn() -> float`` reports the AOT
        # grid's warm fraction; while the tracker is ``starting`` a probe
        # auto-promotes to ready once the fraction reaches the target (the
        # docs/DEPLOY.md router contract: starting until grid warm).
        self._warmup_fn = warmup_fn
        self._warmup_target = float(warmup_target)
        self._recorder = recorder

    # ------------------------------------------------- explicit lifecycle

    def _transition(self, to: str) -> None:
        with self._lock:
            if to not in _ALLOWED[self._state]:
                raise ValueError(
                    f"invalid health transition {self._state} -> {to}"
                )
            was, self._state = self._state, to
        if self._recorder is not None:
            self._recorder.record("health_transition", state=to, was=was)

    def mark_ready(self) -> None:
        self._transition("ready")

    def mark_draining(self) -> None:
        self._transition("draining")

    def mark_closed(self) -> None:
        with self._lock:
            was, self._state = self._state, "closed"  # always legal,
        if was != "closed" and self._recorder is not None:  # idempotent
            self._recorder.record("health_transition", state="closed",
                                  was=was)

    @property
    def lifecycle(self) -> str:
        """The stored explicit state (no derived overlay)."""
        with self._lock:
            return self._state

    # --------------------------------------------------- derived readiness

    def _saturation(self, status: dict, now: float) -> str | None:
        depth, bound = status.get("queue_depth"), status.get("max_queue")
        if depth is not None and bound and depth >= bound:
            return f"queue full ({depth}/{bound})"
        if self._metrics is not None:
            shed = self._metrics.rejected_w.sum(
                self._saturation_window_s, now
            )
            if shed > 0:
                return (
                    f"shed {shed:g} requests in the last "
                    f"{self._saturation_window_s:g}s"
                )
        return None

    def state(self, now: float | None = None) -> tuple[str, dict]:
        """(state, detail).  Detail carries the reason plus the live stack
        numbers a router/operator wants in the probe body."""
        now = self._clock() if now is None else now
        with self._lock:
            base = self._state
        status = dict(self._status_fn()) if self._status_fn else {}
        detail: dict = {**status}
        if status.get("closed") and base not in ("closed",):
            base = "closed"  # stack closed underneath us (e.g. bare
            # batcher.close()) — report it even without mark_closed()
        if base == "starting" and self._warmup_fn is not None:
            frac = float(self._warmup_fn())
            detail["warm_fraction"] = frac
            if frac >= self._warmup_target:
                # Grid warm: auto-promote at probe time (guarded — a racing
                # probe or an explicit mark_ready may have beaten us).
                with self._lock:
                    promote = self._state == "starting"
                    if promote:
                        self._state = "ready"
                if promote and self._recorder is not None:
                    self._recorder.record("health_transition",
                                          state="ready", was="starting")
                base = "ready"
            else:
                detail["reason"] = (
                    f"warming: grid {frac:.0%} compiled "
                    f"(target {self._warmup_target:.0%})"
                )
                return base, detail
        if base in ("closed", "draining", "starting"):
            return base, detail
        reason = self._saturation(status, now)
        if reason is not None:
            detail["reason"] = f"saturated: {reason}"
            return "degraded", detail
        if self._slo is not None:
            verdict = self._slo.verdict(now)
            detail["slo_verdict"] = verdict
            if verdict == "page":
                detail["reason"] = "slo burn rate at page level"
                return "degraded", detail
        return base, detail

    def probe(self, now: float | None = None) -> tuple[int, dict]:
        """(http_code, body) for /healthz."""
        state, detail = self.state(now)
        return http_status(state), {"status": state, **detail}
