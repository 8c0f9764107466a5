"""Federated read views over several stores.

The port's copy of geomesa_tpu/views.py (reference MergedDataStoreView
and RouteSelector): a read-only facade that fans a query out to N port
stores and concatenates the results, or routes each query to exactly one
store. The member stores run their own device paths; the view merges on
the host.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

from geomesa_tpu_torch.features import FeatureCollection
from geomesa_tpu_torch.filter.predicates import Filter, INCLUDE


class MergedView:
    """Read-only union over stores sharing a schema (MergedDataStoreView).
    Duplicate ids keep the first store's row (store order = precedence).

    With a ``limit``, each store is asked for at most ``limit`` rows (the
    reference pushes maxFeatures per store the same way); if a later
    store's first ``limit`` rows are mostly duplicates the merged result
    may come up short even though more matches exist — the same caveat the
    reference's merged view carries."""

    def __init__(self, stores: Sequence, type_name: str):
        if not stores:
            raise ValueError("need at least one store")
        self.stores = list(stores)
        self.type_name = type_name
        specs = {s.get_schema(type_name).to_spec() for s in stores}
        if len(specs) != 1:
            raise ValueError(f"stores disagree on schema: {specs}")

    def get_schema(self, type_name: str | None = None):
        return self.stores[0].get_schema(type_name or self.type_name)

    def query(self, f: "Filter | str" = INCLUDE, limit: Optional[int] = None) -> FeatureCollection:
        parts = []
        seen: set = set()
        kept = 0
        for s in self.stores:
            if limit is not None and kept >= limit:
                break
            # limit pushes down per store (dedup only removes rows, so each
            # store needs at most `limit` of them — reference maxFeatures)
            out = s.query(self.type_name, f, limit=limit)
            if len(out) == 0:
                continue
            keep = np.array([i not in seen for i in out.ids.tolist()])
            seen.update(out.ids.tolist())
            out = out.mask(keep)
            if len(out):
                parts.append(out)
                kept += len(out)
        if not parts:
            return self.stores[0].features(self.type_name).take(
                np.zeros(0, dtype=np.int64)
            )
        merged = parts[0] if len(parts) == 1 else FeatureCollection.concat(parts)
        if limit is not None and len(merged) > limit:
            merged = merged.take(np.arange(limit))
        return merged

    def count(self, f: "Filter | str" = INCLUDE) -> int:
        return len(self.query(f))

    def density(
        self, f, envelope: tuple, width: int = 256, height: int = 256
    ) -> np.ndarray:
        """Sum of the member stores' density grids (the reference merged
        view runs DensityScan per store and sums client-side).
        Duplicate-id rows present in several stores count once per store
        here — the aggregation trade-off the reference documents for
        merged views."""
        grid = None
        for s in self.stores:
            g = s.density(
                self.type_name, f, envelope=envelope, width=width, height=height
            )
            grid = g if grid is None else grid + g
        return grid

    def bounds(self, f: "Filter | str" = INCLUDE, estimate: bool = True):
        """Union envelope over member stores."""
        env = None
        for s in self.stores:
            b = s.bounds(self.type_name, f, estimate=estimate)
            if b is None:
                continue
            env = b if env is None else (
                min(env[0], b[0]), min(env[1], b[1]),
                max(env[2], b[2]), max(env[3], b[3]),
            )
        return env


class RoutedView:
    """Route each query to exactly one store by a router function over the
    filter (reference RouteSelectorByAttribute: e.g. coarse vs fine stores
    chosen by query attributes). ``router(filter) -> store index``; a None
    route falls back to ``default``."""

    def __init__(
        self,
        stores: Sequence,
        type_name: str,
        router: Callable[[Filter], Optional[int]],
        default: int = 0,
    ):
        self.stores = list(stores)
        self.type_name = type_name
        self.router = router
        self.default = default

    def query(self, f: "Filter | str" = INCLUDE, limit: Optional[int] = None) -> FeatureCollection:
        from geomesa_tpu_torch.filter import ecql

        if isinstance(f, str):
            f = ecql.parse(f)
        route = self.router(f)
        store = self.stores[self.default if route is None else route]
        return store.query(self.type_name, f, limit=limit)

    def count(self, f: "Filter | str" = INCLUDE) -> int:
        return len(self.query(f))
