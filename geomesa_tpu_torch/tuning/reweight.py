"""Plan-feedback index reweighting.

The port's copy of geomesa_tpu/tuning/reweight.py. The
:class:`~geomesa_tpu_torch.obs.accuracy.EstimateAccuracy` windows measure,
per (type, index), how honest each index's row estimates are; a
chronically over-selecting index reports a large p90 error factor. This
module closes that loop: the planner's static priority multiplier for a
lying index is inflated by a bounded factor, so ``QueryPlanner.cost``
shifts plans toward indexes whose estimates hold.

The factor table is hysteretic by construction, three bands and not a
threshold: p90 error >= ``deadband`` engages (the factor grows one step),
p90 back under the release point (halfway between honest and the
deadband) disengages (the factor decays one step toward 1.0), and the band
between holds. Growth is multiplicative and clamped at ``max_adjust``, so
a broken estimator can cost an index plans but never exile it; every step
emits a decision record that the manager's ring, the ``tuning.adjust``
span and plan explains surface.

Reads are lock-free: the factor table is an immutable dict swapped whole,
so ``factor()`` adds no locking to the plan path.
"""

from __future__ import annotations


class IndexReweighter:
    """Turns EstimateAccuracy report rows into bounded, hysteretic
    planner priority factors, keyed like the accuracy window:
    ``(type_name, index_name or "full")``."""

    def __init__(
        self,
        accuracy,
        max_adjust: float = 4.0,
        deadband: float = 2.0,
        step: float = 0.5,
        min_count: int = 8,
    ):
        self.accuracy = accuracy
        self.max_adjust = float(max_adjust)
        self.deadband = float(deadband)
        self.step = float(step)
        self.min_count = int(min_count)
        # engage at p90 >= deadband; release only once p90 falls to the
        # midpoint between honest (1.0) and the deadband — the gap IS
        # the no-flap guarantee
        self.release = 1.0 + (self.deadband - 1.0) * 0.5
        self._factors: "dict[tuple[str, str], float]" = {}  # swapped whole

    def factor(self, type_name: str, index_name) -> float:
        """The planner-path read: current multiplier inflation for one
        (type, index), 1.0 when its estimates hold. Lock-free."""
        return self._factors.get((type_name, index_name or "full"), 1.0)

    def factors(self) -> "dict[tuple[str, str], float]":
        return dict(self._factors)

    def pulse(self) -> "list[dict]":
        """One control step over the current accuracy report; returns
        the decision records for every factor that moved."""
        decisions: "list[dict]" = []
        cur = dict(self._factors)
        for row in self.accuracy.report()["indexes"]:
            if row["count"] < self.min_count:
                continue  # too few samples to indict an index
            key = (row["type"], row["index"])
            old = cur.get(key, 1.0)
            p90 = row["p90_error"]
            if p90 >= self.deadband:
                new = min(self.max_adjust, old * (1.0 + self.step))
                why = (
                    f"p90 estimate error {p90:.2f}x >= {self.deadband:.2f}x: "
                    f"demote (factor {old:.2f} -> {new:.2f})"
                )
            elif p90 <= self.release and old > 1.0:
                new = max(1.0, old / (1.0 + self.step))
                why = (
                    f"p90 estimate error {p90:.2f}x recovered past "
                    f"{self.release:.2f}x: decay (factor {old:.2f} -> {new:.2f})"
                )
            else:
                continue  # hold band: hysteresis, no flapping
            if new == old:
                continue  # already at a clamp
            if new == 1.0:
                cur.pop(key, None)
            else:
                cur[key] = new
            decisions.append({
                "controller": "plan_reweight",
                "key": f"{key[0]}/{key[1]}",
                "from": round(old, 4),
                "to": round(new, 4),
                "reason": why,
            })
        if decisions:
            self._factors = cur
        return decisions

    # -- persistence (manager state file) --------------------------------
    def snapshot(self) -> "list[list]":
        return [[t, i, f] for (t, i), f in sorted(self._factors.items())]

    def restore(self, rows) -> None:
        try:
            self._factors = {
                (str(t), str(i)): float(f) for t, i, f in rows
            }
        except (TypeError, ValueError):
            self._factors = {}
