"""Join process: correlate two feature types by attribute value.

Reference: JoinProcess (geomesa-process/src/main/scala/
org/locationtech/geomesa/process/query/JoinProcess.scala) — queries a
primary type, collects the join-attribute values of the hits, and returns
the features of a secondary type whose join attribute matches (each
distinct value queried through the secondary store's attribute index when
present). The columnar inversion: one vectorized membership test via
np.isin over the secondary candidates instead of per-value queries.

Strategy selection is measured, not assumed: past the
``max_values`` IN-push-down cap the fallback to a host membership mask is
COUNTED (``geomesa.join.in_cap_fallback``) and surfaced in the explain
trace instead of happening invisibly, and below the cap a sampled
secondary-side selectivity check (arXiv 1802.09488) skips the push-down
when most secondary rows would match anyway — the IN scan would return
nearly the whole table just to intersect it with itself.

The port's copy of geomesa_tpu/process/join.py,
held to it by the CPU parity tests.
"""

from __future__ import annotations

import numpy as np

from geomesa_tpu_torch.features import FeatureCollection
from geomesa_tpu_torch.filter.predicates import And, Filter, In, Include
from geomesa_tpu_torch.metrics import resolve as _resolve_metrics
from geomesa_tpu_torch.planning.explain import ExplainNull

# secondary rows sampled for the selectivity estimate (vectorized isin
# over a slice — cheap next to either join strategy)
_SELECTIVITY_SAMPLE = 8192


def join_search(
    store,
    primary_type: str,
    secondary_type: str,
    join_attribute: str,
    primary_filter: "Filter | str" = Include(),
    secondary_filter: "Filter | str | None" = None,
    max_values: int = 10_000,
    explain=None,
    metrics=None,
) -> FeatureCollection:
    """Features of ``secondary_type`` whose ``join_attribute`` value occurs
    among the ``primary_filter`` hits of ``primary_type``.

    ``max_values`` caps the number of distinct join values pushed into the
    secondary query's IN predicate (the planner routes it through the
    attribute index when one exists). The host membership mask replaces
    the push-down when (a) the cap is exceeded — counted by
    ``geomesa.join.in_cap_fallback`` — or (b) the sampled fraction of
    matching secondary rows exceeds ``geomesa.join.in.selectivity``
    (the scan would return most rows anyway). ``explain``: optional
    Explainer tracing the chosen strategy; ``metrics``: optional
    MetricsRegistry (the process-global registry by default).
    """
    exp = explain or ExplainNull()
    metrics = _resolve_metrics(metrics)
    kinds = []
    for t, name in ((primary_type, "primary"), (secondary_type, "secondary")):
        sft = store.get_schema(t)
        attr = next((a for a in sft.attributes if a.name == join_attribute), None)
        if attr is None:
            raise ValueError(
                f"{name} type {t!r} has no attribute {join_attribute!r}"
            )
        if attr.is_geometry:
            raise ValueError(
                f"cannot join on geometry attribute {join_attribute!r}; "
                "use the spatial join (geomesa_tpu_torch.sql.join)"
            )
        kinds.append(attr.type)
    if kinds[0] != kinds[1]:
        raise ValueError(
            f"join attribute {join_attribute!r} has mismatched types: "
            f"{kinds[0]} (primary) vs {kinds[1]} (secondary)"
        )
    hits = store.query(primary_type, primary_filter)
    if len(hits) == 0:
        # empty result in the SECONDARY type's shape
        return FeatureCollection.from_rows(store.get_schema(secondary_type), [])
    values = np.unique(np.asarray(hits.columns[join_attribute]))

    if len(values) > max_values:
        # the silent past-cap fallback, made visible: counted and traced
        metrics.counter("geomesa.join.in_cap_fallback")
        exp(
            f"Join strategy: host membership mask ({len(values)} distinct "
            f"values > max_values {max_values}; "
            "geomesa.join.in_cap_fallback)"
        )
        return _host_mask(store, secondary_type, secondary_filter,
                          join_attribute, values)

    # measured-selectivity gate: sample the secondary column; if most
    # rows match, the IN push-down scans ~everything for nothing. Only
    # consulted when the value set is big enough for low selectivity to
    # be plausible — tiny value sets are inherently selective, and the
    # probe itself materializes the secondary collection (features()
    # concatenates every chunk), a cost the push-down path must not pay
    # just to confirm it was right.
    if len(values) > max(64, max_values // 8):
        from geomesa_tpu_torch.conf import JOIN_IN_SELECTIVITY

        sec = store.features(secondary_type)
        if len(sec):
            col = np.asarray(sec.columns[join_attribute])
            step = max(len(col) // _SELECTIVITY_SAMPLE, 1)
            frac = float(np.isin(col[::step], values).mean())
            if frac >= float(JOIN_IN_SELECTIVITY.get()):
                metrics.counter("geomesa.join.in_skipped_selectivity")
                exp(
                    f"Join strategy: host membership mask (sampled "
                    f"secondary selectivity {frac:.2f} >= "
                    "geomesa.join.in.selectivity)"
                )
                return _host_mask(store, secondary_type, secondary_filter,
                                  join_attribute, values)

    metrics.counter("geomesa.join.in_pushdown")
    exp(f"Join strategy: IN push-down ({len(values)} distinct values)")
    pred: Filter = In(join_attribute, tuple(values.tolist()))
    if secondary_filter is not None and not isinstance(secondary_filter, Include):
        from geomesa_tpu_torch.filter import ecql

        sec_f = (
            ecql.parse(secondary_filter)
            if isinstance(secondary_filter, str)
            else secondary_filter
        )
        pred = And((pred, sec_f))
    return store.query(secondary_type, pred)


def _host_mask(store, secondary_type, secondary_filter, join_attribute, values):
    """The membership-mask strategy: run the secondary filter alone and
    apply the join values as one vectorized isin mask."""
    out = store.query(secondary_type, secondary_filter or Include())
    mask = np.isin(np.asarray(out.columns[join_attribute]), values)
    return out.mask(mask)
