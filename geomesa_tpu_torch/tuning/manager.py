"""The store's self-tuning loop.

The port's copy of geomesa_tpu/tuning/manager.py. One
:class:`TuningManager` per DataStore: the sensors the store already
carries (EstimateAccuracy windows, the live metric histograms and
counters, the SLO tracker's burn rates, the link constants) feed three
actuator legs, plan-feedback index reweighting (reweight.py), bounded
knob hill-climbs (controllers.py) and SLO-burn admission shedding
(burnshed.py). ``DataStore.attach_tuning()`` builds and wires one;
``geomesa.tuning.enabled`` arms it. A disarmed manager never pulses, the
planner and scheduler hooks stay ``None``, and the store behaves exactly
as one without the tier.

Pacing and concurrency: the loop piggybacks on the query path.
``DataStore.record_query`` calls :meth:`on_query`, and every
``geomesa.tuning.interval``-th query runs one :meth:`pulse` in that
caller's thread (no tuner thread; an idle store never tunes).
``TuningManager._lock`` is a strict leaf: it guards only the counters and
the decision ring, nothing else is acquired while it is held, all sensing
happens outside it, and a claim flag serializes concurrent pulses without
blocking them. Every adaptation lands in the bounded decision ring with
its reason, under a ``tuning.adjust`` span and ``geomesa.tuning.*``
counters, served by ``GET /debug/tuning`` and the CLI's ``tune``.
"""

from __future__ import annotations

import json
import os
import threading
from collections import deque
from typing import Optional

from geomesa_tpu_torch.obs.trace import span as _ospan
from geomesa_tpu_torch.tuning.burnshed import BurnShed
from geomesa_tpu_torch.tuning.controllers import CONTROLLER_SPECS, KnobController
from geomesa_tpu_torch.tuning.reweight import IndexReweighter


class TuningManager:
    """Controller tier for one DataStore: owns the reweighter, the
    knob controllers and the burn gate; paces pulses; keeps the
    decision audit ring; persists learned state across close/reopen."""

    def __init__(
        self,
        store,
        enabled: Optional[bool] = None,
        state_path: Optional[str] = None,
        interval: Optional[int] = None,
    ):
        from geomesa_tpu_torch import conf
        from geomesa_tpu_torch.lockwitness import witness

        self.store = store
        self.enabled = (
            bool(conf.TUNING_ENABLED.get()) if enabled is None
            else bool(enabled)
        )
        self.state_path = state_path
        self.interval = max(
            1, int(interval if interval is not None
                   else conf.TUNING_INTERVAL.get())
        )
        self._lock = witness(threading.Lock(), "TuningManager._lock")
        self._queries = 0   # guarded-by: _lock
        self._pulses = 0    # guarded-by: _lock
        self._pulsing = False  # guarded-by: _lock (pulse claim flag)
        keep = max(1, int(conf.TUNING_DECISIONS.get()))
        self._decisions: "deque[dict]" = deque(maxlen=keep)  # guarded-by: _lock
        # single-writer state (only the thread holding the pulse claim
        # touches these between claim and release): counter baselines
        # and the latest objective reading per controller
        self._last_raw: "dict[str, int]" = {}
        self._last_reading: "dict[str, float]" = {}
        self.reweighter = IndexReweighter(
            store.accuracy,
            max_adjust=float(conf.TUNING_PLAN_MAX_ADJUST.get()),
            deadband=float(conf.TUNING_PLAN_DEADBAND.get()),
            min_count=int(conf.TUNING_PLAN_MIN_COUNT.get()),
        )
        self.burnshed = BurnShed(
            store,
            objective=str(conf.TUNING_BURN_OBJECTIVE.get()),
            threshold=float(conf.TUNING_BURN_THRESHOLD.get()),
            release=float(conf.TUNING_BURN_RELEASE.get()),
        )
        self.controllers = {s.name: KnobController(s) for s in CONTROLLER_SPECS}
        if state_path:
            self.load()

    # -- pacing -----------------------------------------------------------
    def on_query(self) -> None:
        """Query-path hook (DataStore.record_query): count, and run one
        pulse every ``interval``-th query in this caller's thread."""
        if not self.enabled:
            return
        with self._lock:
            self._queries += 1
            due = self._queries % self.interval == 0
        if due:
            self.pulse()

    # -- the control step -------------------------------------------------
    def pulse(self, now=None) -> "list[dict]":
        """One adaptation step across all three legs. Concurrent calls
        collapse to one (claim flag); the loser returns immediately —
        a skipped pulse costs nothing, the next interval retries."""
        if not self.enabled:
            return []
        with self._lock:
            if self._pulsing:
                return []
            self._pulsing = True
        try:
            return self._pulse_locked_out(now)
        finally:
            with self._lock:
                self._pulsing = False

    def _pulse_locked_out(self, now) -> "list[dict]":
        metrics = self.store.metrics
        with _ospan("tuning.adjust"):
            if metrics is not None:
                metrics.counter("geomesa.tuning.pulse")
            decisions: "list[dict]" = []
            # leg (a): plan-feedback reweighting off the accuracy report
            plan_moves = self.reweighter.pulse()
            if plan_moves and metrics is not None:
                metrics.counter("geomesa.tuning.reweight", len(plan_moves))
            decisions.extend(plan_moves)
            # leg (b): bounded knob controllers off the telemetry rings
            for spec in CONTROLLER_SPECS:
                d = self._step_controller(spec, metrics)
                if d is not None:
                    decisions.append(d)
            # leg (c): refresh the burn gate's snapshot (the scheduler
            # reads it lock-free on every submit) + export the gauge
            self.burnshed.refresh(now)
            if metrics is not None:
                metrics.gauge(
                    "geomesa.tuning.burn", self.burnshed.report()["burn"]
                )
        with self._lock:
            self._pulses += 1
            self._decisions.extend(decisions)
        return decisions

    def _step_controller(self, spec, metrics) -> Optional[dict]:
        from geomesa_tpu_torch import conf

        prop = conf.REGISTRY.get(spec.knob)
        if prop is None:
            return None
        reading = self._reading(spec, metrics)
        if reading is None:
            return None
        self._last_reading[spec.name] = reading
        current = float(prop.get() or 0.0)
        if spec.policy == "derive":
            # closed-form: the link probe's ladder, re-derived from the
            # live RTT gauge (reading) instead of a one-shot probe
            from geomesa_tpu_torch.scan import block_kernels as bk

            derived = bk.derive_link_constants(reading)["fused_chunk_slots"]
            nxt = float(min(spec.hi, max(spec.lo, derived)))
            if current == nxt or (current == 0.0 and bk.fused_slot_cap() == int(nxt)):
                return None  # auto path already lands there: hold
            why = (
                f"link rtt {reading:.2f}ms -> {int(nxt)} slots on the "
                f"doubling ladder"
            )
        else:
            ctl = self.controllers[spec.name]
            proposed = ctl.propose(current, reading)
            if proposed is None:
                return None
            nxt = proposed
            why = (
                f"objective {spec.objective} read {reading:.6g} "
                f"({'higher' if spec.higher_is_better else 'lower'} is "
                f"better): step {current:.6g} -> {nxt:.6g} within "
                f"[{spec.lo:g}, {spec.hi:g}]"
            )
        return self._apply(spec, current, nxt, why, metrics)

    def _reading(self, spec, metrics) -> Optional[float]:
        """Resolve one objective reading; None = no signal this pulse
        (unseeded counter baseline, never-observed histogram, no link
        probe yet) — the controller holds rather than moves blind."""
        if spec.objective_kind == "gauge":
            # the link gauge is OURS to sense: exported from the scan
            # tier's probed constants so it exists as a real metric
            from geomesa_tpu_torch.scan import block_kernels as bk

            rtt = bk.link_constants().get("link_rtt_ms")
            if rtt is None:
                return None
            if metrics is not None:
                metrics.gauge("geomesa.tuning.link.rtt", float(rtt))
            return float(rtt)
        if metrics is None:
            return None
        if spec.objective_kind == "counter":
            raw = metrics.counter_value(spec.objective)
            last = self._last_raw.get(spec.name)
            self._last_raw[spec.name] = raw
            if last is None:
                return None  # first pulse seeds the delta baseline
            return float(raw - last)
        v = metrics.histogram_quantile(spec.objective, 0.99)
        return v if v > 0.0 else None

    def _apply(self, spec, old: float, new: float, why: str, metrics) -> dict:
        """Write one decision through ``conf`` plus the live objects
        that snapshot their config at construction — a knob nobody
        re-reads is not an actuation."""
        from geomesa_tpu_torch import conf

        value = int(new) if spec.integral else float(new)
        conf.REGISTRY[spec.knob].set(value)
        if spec.name == "cache_min_cost":
            cache = getattr(self.store, "cache", None)
            result = getattr(cache, "result", None)
            if result is not None:
                # ResultCacheConf is snapshot at attach time: write the
                # live threshold too, or the running cache keeps judging
                # admissions by the old floor
                result.conf.min_cost_s = float(new)
        if metrics is not None:
            metrics.counter("geomesa.tuning.adjust")
        return {
            "controller": spec.name,
            "knob": spec.knob,
            "from": old,
            "to": value,
            "reason": why,
        }

    # -- observability ----------------------------------------------------
    def report(self) -> dict:
        """The ``/debug/tuning`` + ``geomesa tune`` payload: every
        controller's current value/bounds/objective reading, the plan
        factor table, the burn gate state, and the decision ring."""
        from geomesa_tpu_torch import conf

        with self._lock:
            queries, pulses = self._queries, self._pulses
            decisions = list(self._decisions)
        readings = dict(self._last_reading)
        rows = []
        for spec in CONTROLLER_SPECS:
            prop = conf.REGISTRY.get(spec.knob)
            rows.append({
                "name": spec.name,
                "knob": spec.knob,
                "value": prop.get() if prop is not None else None,
                "lo": spec.lo,
                "hi": spec.hi,
                "objective": spec.objective,
                "objective_kind": spec.objective_kind,
                "policy": spec.policy,
                "reading": readings.get(spec.name),
                "doc": spec.doc,
            })
        return {
            "enabled": self.enabled,
            "interval": self.interval,
            "queries": queries,
            "pulses": pulses,
            "controllers": rows,
            "plan_factors": {
                f"{t}/{i}": round(f, 4)
                for (t, i), f in sorted(self.reweighter.factors().items())
            },
            "burn": self.burnshed.report(),
            "decisions": decisions,
        }

    # -- persistence (close/reopen without re-learning) -------------------
    def state(self) -> dict:
        from geomesa_tpu_torch import conf

        with self._lock:
            decisions = list(self._decisions)
        return {
            "factors": self.reweighter.snapshot(),
            "controllers": {
                name: ctl.snapshot() for name, ctl in self.controllers.items()
            },
            "knobs": {
                spec.knob: conf.REGISTRY[spec.knob].get()
                for spec in CONTROLLER_SPECS
                if spec.knob in conf.REGISTRY
            },
            "decisions": decisions[-16:],
        }

    def save(self) -> None:
        """Persist learned state next to the catalog (atomic rename);
        DataStore.close() calls this when a state path was given."""
        if not self.state_path:
            return
        tmp = self.state_path + ".tmp"
        try:
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump(self.state(), fh, indent=2, sort_keys=True)
            os.replace(tmp, self.state_path)
        except OSError:  # pragma: no cover - state file is best-effort
            pass

    def load(self) -> None:
        """Rehydrate from :meth:`save` output: factor table, controller
        baselines and the tuned knob values re-applied — a reopened
        store starts from what it learned, not from zero."""
        if not self.state_path or not os.path.exists(self.state_path):
            return
        try:
            with open(self.state_path, encoding="utf-8") as fh:
                state = json.load(fh)
        except (OSError, ValueError):  # pragma: no cover - corrupt state
            return  # a bad state file means re-learning, never failing
        from geomesa_tpu_torch import conf

        self.reweighter.restore(state.get("factors") or [])
        saved = state.get("controllers") or {}
        for name, ctl in self.controllers.items():
            if isinstance(saved.get(name), dict):
                ctl.restore(saved[name])
        for knob, value in (state.get("knobs") or {}).items():
            prop = conf.REGISTRY.get(knob)
            if prop is not None and value is not None:
                prop.set(value)
        with self._lock:
            self._decisions.extend(state.get("decisions") or [])
