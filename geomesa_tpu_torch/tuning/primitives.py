"""Shared measured-cost controller primitives.

The port's copy of geomesa_tpu/tuning/primitives.py, whole. The gates
that learn a measured cost (the standing matcher's fused/host gate here;
the tile compose and join gates when their tiers are ported) reduce to
three moves: blend a measured per-unit cost into an EWMA, back off with
periodic re-probes after losing, and snap a continuous target onto a
power-of-two ladder. This module is those moves, extracted once.

Everything here is lock-free plain arithmetic: callers own the
synchronization (each gate keeps its own lock), so these primitives
never nest locks.
"""

from __future__ import annotations

from typing import Optional

# one smoothing constant store-wide (the arXiv 1802.09488 choice: heavy
# enough to react within ~4 observations, light enough to ride out one
# outlier)
DEFAULT_ALPHA = 0.25


def ewma_step(
    prev: Optional[float], sample: float, alpha: float = DEFAULT_ALPHA
) -> float:
    """One EWMA blend: the first sample seeds the average, later ones
    fold in at weight ``alpha``. The canonical ``(1-a)*prev + a*s``
    form (what join/_MatchGate always computed; the tile gate's
    algebraically-equal nudge form migrated onto it)."""
    if prev is None:
        return sample
    return (1.0 - alpha) * prev + alpha * sample


class CostEwma:
    """A measured per-unit cost average: seconds/unit blended at
    ``alpha``. ``value`` is None until the first accepted sample —
    callers distinguish "never measured" (probe!) from "measured
    cheap". Non-positive samples are dropped, not averaged: a clock
    that returned 0 or a batch of 0 units carries no cost signal
    (the exact guard every pre-migration gate applied)."""

    __slots__ = ("alpha", "value")

    def __init__(self, alpha: float = DEFAULT_ALPHA):
        self.alpha = alpha
        self.value: Optional[float] = None

    def update(self, sample: float) -> float:
        self.value = ewma_step(self.value, float(sample), self.alpha)
        return self.value

    def update_cost(self, seconds: float, units: float) -> Optional[float]:
        if units <= 0 or seconds <= 0:
            return self.value
        return self.update(seconds / units)

    def value_or(self, prior: float) -> float:
        """The measured average, or ``prior`` before any sample — how
        the gates fold a design-point cost constant into their first
        decisions."""
        return prior if self.value is None else self.value


class ProbeGate:
    """Explore-then-reprobe admission for a measured alternative: let
    the first ``explore_min`` trials through unconditionally (the
    EWMAs need samples before they mean anything), then, once the
    measurement says "losing", still let every ``reprobe_every``-th
    blocked attempt through so a workload shift can win the gate back.
    Exactly the tile gate's ``_compose_n``/``_gated`` counters,
    extracted."""

    __slots__ = ("explore_min", "reprobe_every", "trials", "blocked")

    def __init__(self, explore_min: int, reprobe_every: int):
        self.explore_min = explore_min
        self.reprobe_every = reprobe_every
        self.trials = 0   # measured attempts let through so far
        self.blocked = 0  # consecutive losses since the last re-probe

    @property
    def exploring(self) -> bool:
        return self.trials < self.explore_min

    def note_trial(self) -> None:
        """One measured attempt completed (its cost fed the EWMA)."""
        self.trials += 1

    def block(self) -> bool:
        """Record one losing decision. True = let this attempt through
        anyway (the periodic re-probe, resetting the streak); False =
        actually gate it."""
        self.blocked += 1
        if self.blocked >= self.reprobe_every:
            self.blocked = 0
            return True
        return False


def doubling_ladder(want: float, base: int, cap: int) -> int:
    """Snap a continuous target onto the power-of-two ladder from
    ``base`` up to ``cap``: the smallest rung >= ``want`` (``cap``
    when the target overshoots it). Bit-identical to the link probe's
    original slot loop — device-side buffer sizes must stay on the
    compiled bucket grid, so controllers never write an off-ladder
    value."""
    step = base
    while step < want and step < cap:
        step *= 2
    return step
