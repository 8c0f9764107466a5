"""Unique-value enumeration over query results.

Reference: UniqueProcess (geomesa-process/src/main/scala/
org/locationtech/geomesa/process/analytic/UniqueProcess.scala) — distinct
values of one attribute, optionally with counts and sorting. Columnar
np.unique replaces the reference's per-feature visitor.

The port's copy of geomesa_tpu/process/unique.py,
held to it by the CPU parity tests.
"""

from __future__ import annotations

import numpy as np

from geomesa_tpu_torch.filter.predicates import Filter, Include


def unique_values(
    store,
    type_name: str,
    attribute: str,
    filter: "Filter | str" = Include(),
    sort_by_count: bool = False,
) -> list[tuple]:
    """[(value, count)] of distinct attribute values among matching rows."""
    out = store.query(type_name, filter)
    if len(out) == 0:
        return []
    vals, cnts = np.unique(np.asarray(out.columns[attribute]), return_counts=True)
    pairs = [
        (v.item() if hasattr(v, "item") else v, int(c)) for v, c in zip(vals, cnts)
    ]
    if sort_by_count:
        pairs.sort(key=lambda p: -p[1])
    return pairs
