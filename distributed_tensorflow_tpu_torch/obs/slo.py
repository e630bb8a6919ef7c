"""Declared SLOs and multi-window error-budget burn rates.

An SLO here is a *declared* objective over the windowed families in
:class:`~distributed_tensorflow_tpu_torch.obs.metrics.ServeMetrics`:

- **latency**: ``target`` fraction of requests complete within
  ``threshold_ms`` (e.g. 99% under 50ms).  Good/bad fractions come from
  ``metrics.latency_w.attainment(threshold)`` — the windowed bucketed
  histogram, with the threshold inserted as an explicit bucket bound so
  attainment is exact, not interpolated.
- **availability**: ``target`` fraction of accepted requests produce a
  result (backpressure sheds, engine failures, and closed-server
  rejections are the bad events; ``validation`` errors are the client's
  fault and do not burn budget).

The alerting math is the standard error-budget burn rate
(Google SRE workbook ch.5): over a window,

    burn = bad_fraction / (1 - target)

so burn 1.0 means "exactly consuming budget at the sustainable rate" and
burn 10 means "10x too fast".  Verdicts are multi-window so a single
slow request can't page and a slow-motion leak still warns:

- ``page``  — burn >= ``page_burn`` in BOTH the short and mid windows
  (fast-burn confirmation: the short window reacts, the mid window
  proves it isn't one bad second);
- ``warn``  — burn >= ``warn_burn`` in the mid OR long window;
- ``ok``    — otherwise (including "no traffic in window").

Windows default to (10s, 60s, 300s) — scaled-down analogues of the
classic (5m, 1h, 6h) tuned to a serving process you watch live, and the
exact series :class:`WindowedCounter`/:class:`WindowedHistogram` retain.

:class:`SloTracker` is pull-based: verdicts are computed at read time
from the windowed series — no aggregator thread, nothing to join.
"""

from __future__ import annotations

import dataclasses
import time

VERDICTS = ("ok", "warn", "page")


@dataclasses.dataclass(frozen=True)
class SloSpec:
    """Declared objectives (0 disables a dimension).

    ``latency_threshold_ms``/``latency_target``: latency SLO — target
    fraction of requests under the threshold.  ``availability_target``:
    availability SLO.  ``windows_s`` must be ascending (short, mid, long).
    """

    latency_threshold_ms: float = 0.0
    latency_target: float = 0.99
    availability_target: float = 0.0
    windows_s: tuple = (10.0, 60.0, 300.0)
    warn_burn: float = 1.0
    page_burn: float = 10.0

    def __post_init__(self):
        if self.latency_threshold_ms < 0:
            raise ValueError("latency_threshold_ms must be >= 0")
        for t, nm in ((self.latency_target, "latency_target"),
                      (self.availability_target, "availability_target")):
            if t and not (0.0 < t < 1.0):
                raise ValueError(f"{nm} must be in (0, 1), got {t}")
        if len(self.windows_s) < 2:
            raise ValueError("need at least (short, mid) windows")
        if list(self.windows_s) != sorted(self.windows_s):
            raise ValueError("windows_s must be ascending")

    @property
    def enabled(self) -> bool:
        return bool(
            (self.latency_threshold_ms and self.latency_target)
            or self.availability_target
        )


def burn_rate(bad_fraction: float, target: float) -> float:
    """Error-budget burn multiple: 1.0 = consuming budget exactly at the
    sustainable rate."""
    budget = 1.0 - target
    if budget <= 0:
        return float("inf") if bad_fraction > 0 else 0.0
    return bad_fraction / budget


def _verdict(spec: SloSpec, burns: dict[float, float]) -> str:
    ws = spec.windows_s
    if burns[ws[0]] >= spec.page_burn and burns[ws[1]] >= spec.page_burn:
        return "page"
    if any(burns[w] >= spec.warn_burn for w in ws[1:]):
        return "warn"
    return "ok"


def worst(verdicts) -> str:
    vs = list(verdicts)
    return max(vs, key=VERDICTS.index) if vs else "ok"


class SloTracker:
    """Compute attainment/burn/verdicts from a ``ServeMetrics``'s windowed
    families at read time.

    ``metrics`` needs ``latency_w`` (WindowedHistogram, seconds),
    ``ok_w``/``bad_w`` (WindowedCounters) — the serving bundle wires them;
    anything else can duck-type the same three attributes.
    """

    def __init__(self, metrics, spec: SloSpec | None = None,
                 clock=time.monotonic, recorder=None):
        self.metrics = metrics
        self.spec = spec or SloSpec()
        self._clock = clock
        # Flight-recorder hookup: verdict() is pull-based (probes/exports
        # call it), so verdict CHANGES are detected here — each one logs an
        # slo_verdict event and a flip to "page" trips a rate-limited dump.
        self._recorder = recorder
        self._last_verdict = "ok"

    # ------------------------------------------------------------ queries

    def latency_attainment(
        self, window_s: float | None = None, now: float | None = None
    ) -> float:
        t_s = self.spec.latency_threshold_ms / 1e3
        return self.metrics.latency_w.attainment(t_s, window_s, now)

    def availability(
        self, window_s: float, now: float | None = None
    ) -> float:
        ok = self.metrics.ok_w.sum(window_s, now)
        bad = self.metrics.bad_w.sum(window_s, now)
        total = ok + bad
        return ok / total if total else 1.0

    def _latency_burns(self, now: float) -> dict[float, float]:
        return {
            w: burn_rate(
                1.0 - self.latency_attainment(w, now), self.spec.latency_target
            )
            for w in self.spec.windows_s
        }

    def _availability_burns(self, now: float) -> dict[float, float]:
        return {
            w: burn_rate(
                1.0 - self.availability(w, now), self.spec.availability_target
            )
            for w in self.spec.windows_s
        }

    # ------------------------------------------------------------- report

    def report(self, now: float | None = None) -> dict:
        """The ``/sloz`` body: per-SLO windowed attainment + burn +
        verdict, and the overall (worst) verdict."""
        now = self._clock() if now is None else now
        spec = self.spec
        slos = []
        if spec.latency_threshold_ms and spec.latency_target:
            burns = self._latency_burns(now)
            slos.append({
                "name": f"latency_p{round(spec.latency_target * 100):g}",
                "kind": "latency",
                "threshold_ms": spec.latency_threshold_ms,
                "target": spec.latency_target,
                "windows": {
                    f"{w:g}s": {
                        "attainment": self.latency_attainment(w, now),
                        "burn_rate": burns[w],
                        "count": self.metrics.latency_w.window_count(w, now),
                    }
                    for w in spec.windows_s
                },
                "verdict": _verdict(spec, burns),
            })
        if spec.availability_target:
            burns = self._availability_burns(now)
            slos.append({
                "name": "availability",
                "kind": "availability",
                "target": spec.availability_target,
                "windows": {
                    f"{w:g}s": {
                        "attainment": self.availability(w, now),
                        "burn_rate": burns[w],
                        "count": (
                            self.metrics.ok_w.sum(w, now)
                            + self.metrics.bad_w.sum(w, now)
                        ),
                    }
                    for w in spec.windows_s
                },
                "verdict": _verdict(spec, burns),
            })
        return {
            "spec": dataclasses.asdict(spec),
            "slos": slos,
            "verdict": worst(s["verdict"] for s in slos),
        }

    def verdict(self, now: float | None = None) -> str:
        """Overall verdict only (the health tracker's burn-rate input)."""
        now = self._clock() if now is None else now
        spec = self.spec
        vs = []
        if spec.latency_threshold_ms and spec.latency_target:
            vs.append(_verdict(spec, self._latency_burns(now)))
        if spec.availability_target:
            vs.append(_verdict(spec, self._availability_burns(now)))
        v = worst(vs)
        if self._recorder is not None and v != self._last_verdict:
            was, self._last_verdict = self._last_verdict, v
            self._recorder.record("slo_verdict", verdict=v, was=was)
            if v == "page":
                self._recorder.trigger("slo_page")
        return v
