"""Planning/execution errors and the deadline check.

The port's copy of geomesa_tpu/planning/errors.py: a leaf module so the
storage layer can enforce deadlines without importing the planner
(planner -> storage is the real dependency direction)."""

from __future__ import annotations

import time
from dataclasses import dataclass


class QueryGuardError(Exception):
    """A query guard rejected the plan (reference planning/guard/)."""


class QueryTimeout(Exception):
    """A query exceeded its deadline (reference per-plan timeouts +
    ThreadManagement.scala: scans are registered with a timeout and killed
    when overdue; here the single-controller design checks wall-clock at
    every stage boundary — before/after each device call and around host
    refinement — and aborts the query). Carries ``elapsed_s``/``budget_s``
    so callers and audit sinks can report how far over budget the scan
    ran (None when the deadline was a bare monotonic cutoff)."""

    def __init__(self, msg: str, elapsed_s: float | None = None,
                 budget_s: float | None = None):
        super().__init__(msg)
        self.elapsed_s = elapsed_s
        self.budget_s = budget_s


@dataclass(frozen=True)
class Deadline:
    """A query's wall-clock budget: monotonic start + cutoff. Floats
    (bare cutoffs) are still accepted by :func:`check_deadline` for
    back-compat; the object form lets QueryTimeout report elapsed vs
    budget."""

    start: float    # time.monotonic() at plan/execute entry
    budget_s: float
    cutoff: float   # start + budget_s

    def remaining(self) -> float:
        return self.cutoff - time.monotonic()


def check_deadline(deadline: "Deadline | float | None", stage: str) -> None:
    """Raise QueryTimeout when a monotonic deadline has passed."""
    if deadline is None:
        return
    now = time.monotonic()
    if isinstance(deadline, Deadline):
        if now > deadline.cutoff:
            elapsed = now - deadline.start
            raise QueryTimeout(
                f"query deadline exceeded during {stage} "
                f"(elapsed {elapsed:.3f}s > budget {deadline.budget_s:.3f}s)",
                elapsed_s=elapsed, budget_s=deadline.budget_s,
            )
    elif now > deadline:
        raise QueryTimeout(f"query deadline exceeded during {stage}")


def deadline_from(timeout: float | None) -> Deadline | None:
    """A Deadline for a timeout in seconds, or None."""
    if timeout is None:
        return None
    now = time.monotonic()
    return Deadline(start=now, budget_s=timeout, cutoff=now + timeout)
