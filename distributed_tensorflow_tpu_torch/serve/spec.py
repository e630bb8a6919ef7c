"""Host-side speculative-decoding support: n-gram drafting + per-slot
accept/reject bookkeeping (serve/batcher.py drives it).

Self-speculation, no second model: the drafter proposes up to ``k``
candidate tokens per slot by suffix-matching the slot's own prompt +
generated history (prompt-lookup decoding — the model-free variant of
Leviathan et al. 2023), and the engine verifies all of them in ONE
fixed-shape ``[slots, k+1]`` forward (``CausalLMEngine.verify``). The
accepted prefix is emitted as multiple tokens per step; the first
mismatch position already carries the VERIFIED model token, so a full
reject still emits exactly what a plain decode step would have — a
speculative step is never wasted, only its extra verify width is.

Acceptance here is EXACT MATCH against the model's (greedy or seeded-
categorical) choice at each position. That is stronger than
distribution-level acceptance: the emitted stream is bit-identical to
the non-speculative stream for ANY temperature, because sampling is
already deterministic per (seed, absolute position)
(models/causal_lm.sample_tokens — the determinism contract
tests/test_torch_serve_decode.py pins).

Adaptive backoff protects adversarial streams: each slot tracks an
acceptance EMA; when it falls below the threshold the slot drops to
k=0 — plain pipelined decode, paying nothing — and re-probes with one
speculative step every ``reprobe_period`` steps so a stream that turns
repetitive later is re-detected. Engage/disengage transitions surface
as flight-recorder ``spec_backoff`` events.
"""

from __future__ import annotations

import dataclasses
from typing import Protocol, Sequence


class Drafter(Protocol):
    """Pluggable draft source. ``history`` is the slot's prompt followed by
    every token generated so far; return AT MOST ``k`` candidate
    continuations (fewer, or none, when there is nothing worth proposing).
    Implementations must be pure functions of ``history`` — the batcher
    calls them under its scheduling lock. A draft-model backend slots in
    here later; :class:`NGramDrafter` is the model-free default."""

    def draft(self, history: Sequence[int], k: int) -> list[int]:
        ...


class NGramDrafter:
    """Prompt-lookup drafting: match the longest recent suffix of
    ``history`` (between ``min_match`` and ``max_match`` tokens) against an
    earlier occurrence in the same history, and propose the tokens that
    followed that occurrence.

    Longest-suffix-first keeps precision up — a 4-gram match is far more
    predictive than a 2-gram one — and the most RECENT earlier occurrence
    wins ties, since local repetition (code, quoted spans, structured
    output) is what this drafter exists to exploit.
    """

    def __init__(self, min_match: int = 2, max_match: int = 4):
        if min_match < 1:
            raise ValueError(f"min_match must be >= 1, got {min_match}")
        if max_match < min_match:
            raise ValueError(
                f"max_match {max_match} < min_match {min_match}"
            )
        self.min_match = min_match
        self.max_match = max_match

    def draft(self, history: Sequence[int], k: int) -> list[int]:
        h = list(history)
        n = len(h)
        if k <= 0 or n < self.min_match + 1:
            return []
        for width in range(min(self.max_match, n - 1), self.min_match - 1, -1):
            suffix = h[n - width:]
            # Scan right-to-left over candidate match ends (the position
            # just past the earlier occurrence), most recent first; the
            # occurrence must end before the suffix itself starts.
            for end in range(n - 1, width - 1, -1):
                if h[end - width:end] == suffix:
                    return h[end:end + k]
            # No occurrence at this width -> retry shorter.
        return []


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculation knobs (cli/serve.py ``--spec-*``; engine-validated by
    ``CausalLMEngine._plan_spec``).

    ``spec_tokens`` is the verify width k (0 disables speculation
    entirely); ``min_match`` the shortest n-gram the drafter may match.
    Backoff: a slot whose acceptance EMA (per drafted token, smoothed
    with ``ema_alpha``) drops below ``backoff_threshold`` after
    ``warmup_verifies`` speculative steps falls back to plain decode,
    re-probing one speculative step every ``reprobe_period`` plain steps;
    a probe that lifts the EMA back over the threshold re-engages."""

    spec_tokens: int = 0
    min_match: int = 2
    max_match: int = 4
    backoff_threshold: float = 0.25
    ema_alpha: float = 0.3
    warmup_verifies: int = 3
    reprobe_period: int = 16

    def make_drafter(self) -> Drafter:
        return NGramDrafter(self.min_match, self.max_match)


class SlotSpec:
    """Per-slot speculation state: the drafter, the acceptance EMA, and
    the backoff mode machine. One instance per slot OCCUPANCY (built at
    admission, dropped at free) — a new request always starts optimistic.

    Thread-safety: mutated only under the batcher's ``_cv`` (the same
    discipline as the slot fields themselves); the sanitizer soak in
    tests/test_torch_serve_spec.py runs concurrent submitters over it.
    """

    __slots__ = (
        "cfg", "drafter", "ema", "verifies", "backed_off", "plain_steps",
        "drafted", "accepted", "rejects",
    )

    def __init__(self, cfg: SpecConfig, drafter: Drafter | None = None):
        self.cfg = cfg
        self.drafter = drafter if drafter is not None else cfg.make_drafter()
        self.ema = 1.0          # optimistic start: speculate until proven bad
        self.verifies = 0
        self.backed_off = False
        self.plain_steps = 0    # plain decode steps since the last probe
        self.drafted = 0
        self.accepted = 0
        self.rejects = 0

    @property
    def speculating(self) -> bool:
        """True when the slot should take the verify path this step —
        either in full speculation mode, or backed off with a probe due."""
        if not self.backed_off:
            return True
        return self.plain_steps >= self.cfg.reprobe_period

    def note_plain_step(self) -> None:
        self.plain_steps += 1

    def propose(self, history: Sequence[int], max_k: int) -> list[int]:
        """Draft for the next verify step; ``max_k`` is the caller's cap
        (generation budget / cache headroom), further clamped to k."""
        k = min(self.cfg.spec_tokens, max_k)
        if k <= 0:
            return []
        return list(self.drafter.draft(history, k))[:k]

    def record(self, drafted: int, accepted: int) -> str | None:
        """Fold one speculation outcome into the EMA; returns "engage" /
        "disengage" when the backoff mode flips (the batcher turns these
        into flight-recorder ``spec_backoff`` events), else None.

        ``drafted == 0`` means the drafter found NO usable n-gram — the
        batcher ran a plain step instead of a verify. That counts as 0.0
        acceptance: a stream the drafter can't predict should back off to
        the fully-pipelined plain path just like one whose drafts get
        rejected (the verify cadence itself costs pipelining)."""
        self.verifies += 1
        self.drafted += drafted
        self.accepted += accepted
        if 0 < drafted and accepted < drafted:
            self.rejects += 1
        a = self.cfg.ema_alpha
        rate = (accepted / drafted) if drafted > 0 else 0.0
        self.ema = (1.0 - a) * self.ema + a * rate
        if self.backed_off:
            self.plain_steps = 0  # this WAS the probe; restart the clock
            if self.ema >= self.cfg.backoff_threshold:
                self.backed_off = False
                return "disengage"
            return None
        if (
            self.verifies >= self.cfg.warmup_verifies
            and self.ema < self.cfg.backoff_threshold
        ):
            self.backed_off = True
            self.plain_steps = 0
            return "engage"
        return None

    def digest(self) -> dict:
        return {
            "k": 0 if self.backed_off else self.cfg.spec_tokens,
            "backed_off": self.backed_off,
            "acceptance_ema": round(self.ema, 4),
            "drafted": self.drafted,
            "accepted": self.accepted,
            "rejects": self.rejects,
        }
