"""In-memory bucket grid spatial index.

The port's copy of geomesa_tpu/utils/spatial_index.py (reference
BucketIndex.scala:30-75): a fixed grid of buckets over an envelope, backing
the streaming hot tier. O(1) insert and remove by (id, x, y); a bbox query
collects the covered buckets. Extents insert into every covered bucket.
"""

from __future__ import annotations

import math


class BucketIndex:
    """Grid-bucketed point/extent index keyed by feature id.

    Scalar cell math: a point's cell set is one integer, and a scalar
    floor and clamp is far cheaper than a numpy pass per insert at the
    single-feature granularity this index lives at."""

    def __init__(
        self,
        nx: int = 360,
        ny: int = 180,
        envelope: tuple = (-180.0, -90.0, 180.0, 90.0),
    ):
        self.nx, self.ny = nx, ny
        self.x0, self.y0, self.x1, self.y1 = (float(v) for v in envelope)
        self._fx = self.nx / (self.x1 - self.x0)
        self._fy = self.ny / (self.y1 - self.y0)
        self._buckets: dict[int, set] = {}
        self._entries: dict[object, tuple] = {}  # id -> (bbox, bucket ids)

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key) -> bool:
        return key in self._entries

    def _cells(self, bbox) -> list:
        x0, y0, x1, y1 = bbox
        i0 = min(max(math.floor((x0 - self.x0) * self._fx), 0), self.nx - 1)
        j0 = min(max(math.floor((y0 - self.y0) * self._fy), 0), self.ny - 1)
        if x1 == x0 and y1 == y0:  # points: one cell, no loop
            return [j0 * self.nx + i0]
        i1 = min(max(math.floor((x1 - self.x0) * self._fx), 0), self.nx - 1)
        j1 = min(max(math.floor((y1 - self.y0) * self._fy), 0), self.ny - 1)
        return [j * self.nx + i for j in range(j0, j1 + 1) for i in range(i0, i1 + 1)]

    def insert(self, key, bbox) -> None:
        """Insert or replace an entry; bbox = (xmin, ymin, xmax, ymax) (a
        point's bbox is degenerate)."""
        if key in self._entries:
            self.remove(key)
        cells = self._cells(bbox)
        for c in cells:
            self._buckets.setdefault(c, set()).add(key)
        self._entries[key] = (tuple(float(v) for v in bbox), cells)

    def bulk_insert_points(self, keys, xs, ys) -> None:
        """Vectorised insert or replace of many POINT entries: one numpy
        pass computes every entry's cell and the per-cell groups land in
        their bucket sets with ``set.update`` slices (WAL replay's bulk
        path). Later duplicates win, exactly like sequential
        :meth:`insert` calls."""
        import numpy as np

        entries, buckets = self._entries, self._buckets
        kset = set(keys)
        stale = kset & entries.keys() if entries else ()
        for k in stale:
            self.remove(k)
        if len(keys) != len(kset):
            # in-batch duplicate ids: keep only the LAST occurrence
            last: dict = {}
            for pos, k in enumerate(keys):
                last[k] = pos
            keep = sorted(last.values())
            keys = [keys[p] for p in keep]
            xs = np.asarray(xs, np.float64)[keep]
            ys = np.asarray(ys, np.float64)[keep]
        i = np.minimum(np.maximum(
            np.floor((np.asarray(xs, np.float64) - self.x0) * self._fx)
            .astype(np.int64), 0), self.nx - 1)
        j = np.minimum(np.maximum(
            np.floor((np.asarray(ys, np.float64) - self.y0) * self._fy)
            .astype(np.int64), 0), self.ny - 1)
        cells = j * self.nx + i
        cl = cells.tolist()
        xs_l = np.asarray(xs, np.float64).tolist()
        ys_l = np.asarray(ys, np.float64).tolist()
        entries.update((k, ((x, y, x, y), [c])) for k, c, x, y in zip(keys, cl, xs_l, ys_l))
        order = np.argsort(cells, kind="stable")
        sorted_keys = [keys[p] for p in order.tolist()]
        sc = cells[order]
        uniq, first = np.unique(sc, return_index=True)
        starts = np.append(first, len(sc)).tolist()
        for t, c in enumerate(uniq.tolist()):
            b = buckets.get(c)
            if b is None:
                b = buckets[c] = set()
            b.update(sorted_keys[starts[t] : starts[t + 1]])

    def remove(self, key) -> bool:
        entry = self._entries.pop(key, None)
        if entry is None:
            return False
        for c in entry[1]:
            b = self._buckets.get(c)
            if b is not None:
                b.discard(key)
                if not b:
                    del self._buckets[c]
        return True

    def query(self, bbox) -> list:
        """Keys whose bbox intersects the query bbox."""
        x0, y0, x1, y1 = bbox
        seen: set = set()
        out = []
        for c in self._cells(bbox):
            for key in self._buckets.get(c, ()):
                if key in seen:
                    continue
                seen.add(key)
                b = self._entries[key][0]
                if b[0] <= x1 and b[2] >= x0 and b[1] <= y1 and b[3] >= y0:
                    out.append(key)
        return out

    def keys(self):
        return self._entries.keys()
