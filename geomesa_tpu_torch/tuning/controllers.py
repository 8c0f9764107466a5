"""Knob auto-tuning: bounded hill-climb controllers.

The port's copy of geomesa_tpu/tuning/controllers.py. Each auto-tuned knob
gets one :class:`ControllerSpec`: what is tuned (the ``conf`` knob), the
legal range (``lo``/``hi``: hard clamps the controller never writes
outside), the objective metric it optimizes and the step policy. The specs
below are the store's whole auto-tuned surface.

The hill-climb (:class:`KnobController`) is deliberately simple and
hysteretic: within the deadband nothing moves (a noisy but healthy
objective must not churn the knob), an improving move keeps its
direction, a worsening move reverses, and a collapsed objective (far below
the best this controller has seen, the drifted-workload signature) steps
in the spec's declared relax direction instead of guessing. Every
proposed move is clamped, integral knobs round, and a no-op proposal is
suppressed so the decision trail records only real changes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ControllerSpec:
    """One auto-tuned knob's declaration. ``objective_kind`` selects
    the reading: ``counter`` (per-pulse delta of a monotonic counter),
    ``quantile`` (live histogram p99), or ``gauge`` (last set value).
    ``policy`` is ``hill`` (bounded hill-climb on the objective) or
    ``derive`` (closed-form from the objective reading — the link
    probe's ladder). ``relax_dir`` is the direction (+1/-1) to step
    when the objective collapses below its best: the spec author knows
    which way "more permissive" lies; the controller must not guess."""

    name: str
    knob: str
    lo: float
    hi: float
    objective: str
    objective_kind: str
    higher_is_better: bool
    step: float
    policy: str
    integral: bool
    relax_dir: int
    doc: str


# the store's auto-tuned surface. Bounds are chosen
# so the WORST in-range value degrades, never breaks: slot counts stay
# on the compiled ladder, row counts stay within queue/memory budgets.
CONTROLLER_SPECS: "tuple[ControllerSpec, ...]" = (
    ControllerSpec(
        name="cache_min_cost",
        knob="geomesa.cache.min.cost",
        lo=0.0,
        hi=0.05,
        objective="geomesa.cache.hit",
        objective_kind="counter",
        higher_is_better=True,
        step=0.25,
        policy="hill",
        integral=False,
        relax_dir=-1,
        doc="result-cache admission cost threshold vs cache-hit rate: "
            "when hits collapse (the workload's scans got cheaper than "
            "the frozen threshold), relax the floor so repeats cache",
    ),
    ControllerSpec(
        name="fused_chunk_slots",
        knob="geomesa.scan.fused.slots",
        lo=256.0,
        hi=2048.0,
        objective="geomesa.tuning.link.rtt",
        objective_kind="gauge",
        higher_is_better=False,
        step=0.25,
        policy="derive",
        integral=True,
        relax_dir=1,
        doc="fused transfer chunk slots derived from the measured link "
            "RTT on the doubling ladder (scan/block_kernels.py): slower "
            "links amortize more rows per round trip",
    ),
    ControllerSpec(
        name="fold_slice_rows",
        knob="geomesa.stream.fold.slice.rows",
        lo=8192.0,
        hi=262144.0,
        objective="geomesa.stream.fold.slice",
        objective_kind="quantile",
        higher_is_better=False,
        step=0.25,
        policy="hill",
        integral=True,
        relax_dir=-1,
        doc="incremental fold slice size vs slice-pause p99: smaller "
            "slices yield to queued queries sooner at the price of a "
            "longer fold window",
    ),
    ControllerSpec(
        name="flush_chunk_rows",
        knob="geomesa.stream.chunk.rows",
        lo=8192.0,
        hi=262144.0,
        objective="geomesa.stream.rows",
        objective_kind="counter",
        higher_is_better=True,
        step=0.25,
        policy="hill",
        integral=True,
        relax_dir=1,
        doc="stream flush batch rows vs flushed-row throughput: bigger "
            "batches amortize per-flush overhead until memory pressure "
            "or queue latency pushes back",
    ),
)


class KnobController:
    """Bounded hysteretic hill-climb over one spec. Stateless about
    the knob itself (the manager reads/writes ``conf``); this class
    only turns an objective reading stream into clamped proposals."""

    # hold band: relative objective movement below this is noise, not
    # signal — no move (the anti-flap half of the hysteresis)
    DEADBAND = 0.10
    # collapse: reading this far below the best ever seen means the
    # workload drifted out from under the current value — relax
    COLLAPSE = 0.5
    _EPS = 1e-9

    def __init__(self, spec: ControllerSpec):
        self.spec = spec
        self._last: Optional[float] = None
        self._best: Optional[float] = None
        self._dir = spec.relax_dir

    def _better(self, a: float, b: float) -> bool:
        return a > b if self.spec.higher_is_better else a < b

    def propose(self, current: float, reading: float) -> Optional[float]:
        """One pulse: fold in ``reading``, return the clamped next
        knob value, or None to hold. The first reading only seeds the
        baseline — a controller never moves on a single sample."""
        spec = self.spec
        if self._best is None or self._better(reading, self._best):
            self._best = reading
        last, self._last = self._last, reading
        if last is None:
            return None
        scale = max(abs(last), abs(self._best), self._EPS)
        gain = (reading - last) if spec.higher_is_better else (last - reading)
        shortfall = (
            (self._best - reading) if spec.higher_is_better
            else (reading - self._best)
        )
        collapsed = shortfall > self.COLLAPSE * scale
        if abs(gain) <= self.DEADBAND * scale and not collapsed:
            return None  # healthy and steady: hold (hysteresis)
        if collapsed:
            self._dir = spec.relax_dir
        elif gain < 0:
            self._dir = -self._dir
        nxt = current + self._dir * spec.step * (spec.hi - spec.lo)
        nxt = min(spec.hi, max(spec.lo, nxt))
        if spec.integral:
            nxt = float(int(round(nxt)))
        if nxt == current:
            return None
        return nxt

    def snapshot(self) -> dict:
        return {"last": self._last, "best": self._best, "dir": self._dir}

    def restore(self, state: dict) -> None:
        """Rehydrate from :meth:`snapshot` — how controller learning
        survives DataStore.close()/reopen instead of starting over."""
        self._last = state.get("last")
        self._best = state.get("best")
        d = state.get("dir")
        if d in (-1, 1):
            self._dir = d
